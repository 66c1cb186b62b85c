"""Front end and point-cloud Sinkhorn backends."""

from .multiscale import sinkhorn_multiscale
from .samples_loss import SamplesLoss
from .sinkhorn_samples import sinkhorn_online, sinkhorn_tensorized

__all__ = ["SamplesLoss", "sinkhorn_multiscale", "sinkhorn_online", "sinkhorn_tensorized"]
