"""geomloss_tpu_torch — the PyTorch and CUDA port of geomloss_tpu.

Same layout and module names as :mod:`geomloss_tpu`, PyTorch idiom
inside: ``SamplesLoss`` is an ``nn.Module``, everything else is plain
functions on tensors, gradients go through ``torch.autograd.Function``.
The pair-interaction kernels are hand-written CUDA for Hopper
(``csrc/online_kernels.cu``, ``csrc/block_sparse_kernels.cu``), built with
``nvcc`` at first use.

Ported so far: ``SamplesLoss`` on point clouds, every loss
(``sinkhorn``, ``gaussian``, ``laplacian``, ``energy``, ``hausdorff``) with
the ``tensorized``, ``online`` and ``multiscale`` backends, the
block-sparse operators of :mod:`.ops` (``softmin_sparse``,
``gibbs_apply_sparse``, ``lse_sparse``), and the grid path:
``sinkhorn_divergence``, ``ImagesLoss``, ``VolumesLoss`` and
``ImagesBarycenter``; and the ``ot`` API (:mod:`.ot`: ``solve``,
``solve_batch``, ``solve_sample``, ``solve_sample_batch``, ``solve_grid``,
the barycenters ``barycenter``, ``barycenter_sample`` and
``barycenter_grid``, and the ``OTResult`` family), whose streaming
``solve_sample`` runs kernels 1 and 4; and :mod:`.parallel` (the ring
Sinkhorn and kernel losses, and the multiscale solve with its fine phase
cut into row shards, over ``torch.distributed``). This package never
imports JAX.
"""

__version__ = "0.3.1"

from .models.samples_loss import SamplesLoss


def __getattr__(name):
    # Lazy imports keep the base import light:
    if name == "ImagesBarycenter":
        from .models.barycenter_images import ImagesBarycenter

        return ImagesBarycenter
    if name in ("sinkhorn_divergence", "ImagesLoss", "VolumesLoss"):
        from .models import sinkhorn_images

        return getattr(sinkhorn_images, name)
    if name in ("ot", "parallel"):
        import importlib

        return importlib.import_module(f"geomloss_tpu_torch.{name}")
    raise AttributeError(f"module 'geomloss_tpu_torch' has no attribute {name!r}")


__all__ = [
    "SamplesLoss",
    "ImagesBarycenter",
    "sinkhorn_divergence",
    "ImagesLoss",
    "VolumesLoss",
    "ot",
    "__version__",
]
