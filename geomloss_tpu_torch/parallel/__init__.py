"""Scale-out over a group of ranks (``torch.distributed``): the ring
softmin, the ring Sinkhorn and kernel losses, and the multiscale solve with
its truncated fine phase cut into row shards. Counterpart of
:mod:`geomloss_tpu.parallel`."""

from .multiscale_sharded import sinkhorn_multiscale_sharded
from .ring import (
    kernel_ring,
    points_mesh,
    ring_lse,
    ring_matvec,
    ring_softmin,
    sinkhorn_ring,
)

__all__ = [
    "kernel_ring",
    "points_mesh",
    "ring_lse",
    "ring_matvec",
    "ring_softmin",
    "sinkhorn_ring",
    "sinkhorn_multiscale_sharded",
]
