"""Voxel-grid clustering for multiscale solvers.

Counterpart of :mod:`geomloss_tpu.ops.clustering`. Clustering runs on the
host in NumPy, as in the JAX package: the number of occupied voxels is
data-dependent and the tables are small bookkeeping. :func:`grid_cluster`
and :func:`cluster_ranges_centroids` return NumPy arrays;
:func:`clusterize` returns its measures and permutation as tensors.
"""

import numpy as np
import torch

from ..utils import profiling

__all__ = ["grid_cluster", "cluster_ranges_centroids", "clusterize"]


def _host(v):
    """``v`` as a NumPy array; a tensor is read to the host (counted as
    ``host.reads``)."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    profiling.count("host.reads")
    return v.detach().cpu().numpy()


def grid_cluster(x, scale) -> np.ndarray:
    """Voxel-grid labels: points in the same cube of side ``scale`` share a label.

    Args:
        x: ``(N, D)`` array or tensor.
        scale: voxel side length.

    Returns:
        ``(N,)`` int64 label array, compacted to ``0..K-1`` in the order of
        the sorted voxel indices.
    """
    x = _host(x)
    mins = x.min(axis=0)
    grid_idx = np.floor((x - mins) / scale).astype(np.int64)
    dims = grid_idx.max(axis=0) + 1
    raveled = np.ravel_multi_index(tuple(grid_idx.T), tuple(dims))
    _, labels = np.unique(raveled, return_inverse=True)
    return labels


def cluster_ranges_centroids(x, labels, weights=None):
    """Per-cluster ``[start, end)`` ranges, weighted centroids and total
    weights (NumPy). Assumes nothing about ``labels`` order; ranges refer to
    the *sorted* layout."""
    x = _host(x)
    labels = _host(labels)
    N, D = x.shape
    K = int(labels.max()) + 1 if N else 0
    w = np.ones((N,), dtype=x.dtype) if weights is None else _host(weights)

    tot_w = np.zeros((K,), dtype=np.float64)
    np.add.at(tot_w, labels, w.astype(np.float64))
    centroids = np.zeros((K, D), dtype=np.float64)
    np.add.at(centroids, labels, w[:, None].astype(np.float64) * x.astype(np.float64))
    centroids = centroids / np.maximum(tot_w[:, None], 1e-300)

    counts = np.bincount(labels, minlength=K)
    ends = np.cumsum(counts)
    starts = ends - counts
    ranges = np.stack([starts, ends], axis=1).astype(np.int64)

    return ranges, centroids.astype(x.dtype), tot_w.astype(x.dtype)


def clusterize(a, x, scale=None, labels=None, device=None):
    """Cluster a measure ``(a, x)`` on a voxel grid of side ``scale``.

    Returns:
        ``(a_coarse, a_sorted), (x_coarse, x_sorted), ranges, perm``: the
        measures and ``perm`` (the sorting permutation, which de-sorts dual
        potentials) as tensors, ``ranges`` as a NumPy array. The tensors lie
        on ``device``; by default on the device of ``x`` when it is a
        tensor, else on the card.
    """
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else torch.device("cuda")

    def dev(v):
        return torch.as_tensor(v).to(device)

    if labels is None and scale is None:
        return ([dev(_host(a))], [dev(_host(x))], [], None)

    a_np = _host(a)
    x_np = _host(x)
    lab = grid_cluster(x_np, scale) if labels is None else _host(labels)

    ranges, centroids, tot_w = cluster_ranges_centroids(x_np, lab, weights=a_np)

    perm = np.argsort(lab, kind="stable")
    return (
        (dev(tot_w), dev(a_np[perm])),
        (dev(centroids), dev(x_np[perm])),
        ranges,
        dev(perm),
    )
