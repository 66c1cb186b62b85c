"""Front ends: point-cloud Sinkhorn backends, kernel (MMD) losses, grid
Sinkhorn divergences and grid barycenters."""

from .barycenter_images import ImagesBarycenter
from .kernel_samples import double_grad, kernel_multiscale, kernel_online, kernel_routines, kernel_tensorized
from .multiscale import sinkhorn_multiscale
from .samples_loss import SamplesLoss
from .sinkhorn_images import ImagesLoss, VolumesLoss, sinkhorn_divergence
from .sinkhorn_samples import sinkhorn_online, sinkhorn_tensorized

__all__ = [
    "SamplesLoss",
    "ImagesBarycenter",
    "ImagesLoss",
    "VolumesLoss",
    "sinkhorn_divergence",
    "double_grad",
    "kernel_multiscale",
    "kernel_online",
    "kernel_routines",
    "kernel_tensorized",
    "sinkhorn_multiscale",
    "sinkhorn_online",
    "sinkhorn_tensorized",
]
