"""State carried between the JAX package and the port, through numpy.

No model weights exist here: what a user carries from one solve to the
next is the input clouds and weights, and the raw warm-start potentials
``(f_ba, g_ab, f_aa, g_bb)`` returned by ``potentials="raw"``. Both
packages hand these out as arrays that ``np.asarray`` accepts, so a
tree of them crosses over as numpy. So do the multiscale truncation
tables (:func:`tile_mask_from_numpy`).
"""

import numpy as np
import torch

__all__ = ["from_numpy", "to_numpy", "tile_mask_from_numpy"]


def from_numpy(tree, device=None, dtype=None):
    """Map every array leaf of a (nested) tuple/list/dict to a tensor.

    Args:
        tree: arrays (anything ``np.asarray`` accepts), ``None`` leaves, or
            tuples / lists / dicts of them.
        device: target device of the tensors; ``None`` means the card
            (``torch.device("cuda")``), so a CPU caller passes ``"cpu"``.
        dtype: target floating dtype; ``None`` keeps the array's own.
    """
    if tree is None:
        return None
    if device is None:
        device = torch.device("cuda")
    if isinstance(tree, dict):
        return {k: from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(v, device, dtype) for v in tree)
    t = torch.from_numpy(np.array(tree, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy(tree):
    """Inverse of :func:`from_numpy`: tensors become detached host arrays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def tile_mask_from_numpy(mask, device=None):
    """A truncation table of either package (fields ``cols, counts, colsT,
    countsT, vals, valsT``, arrays or ``None``) as the port's
    :class:`~geomloss_tpu_torch.ops.block_sparse.TileMask`: integer tables
    keep their dtype, keep scores become float tensors of theirs. The
    device defaults to the card, as in :func:`from_numpy`."""
    from ..ops.block_sparse import TileMask

    return TileMask(*(from_numpy(getattr(mask, k), device) for k in TileMask._fields))
