"""Front end, point-cloud Sinkhorn backends and kernel (MMD) losses."""

from .kernel_samples import double_grad, kernel_multiscale, kernel_online, kernel_routines, kernel_tensorized
from .multiscale import sinkhorn_multiscale
from .samples_loss import SamplesLoss
from .sinkhorn_samples import sinkhorn_online, sinkhorn_tensorized

__all__ = [
    "SamplesLoss",
    "double_grad",
    "kernel_multiscale",
    "kernel_online",
    "kernel_routines",
    "kernel_tensorized",
    "sinkhorn_multiscale",
    "sinkhorn_online",
    "sinkhorn_tensorized",
]
