r"""``SamplesLoss`` — the GeomLoss front end, as a ``torch.nn.Module``.

Counterpart of :class:`geomloss_tpu.models.samples_loss.SamplesLoss`: the
same constructor arguments, the same 2/4/6-argument call forms, the same
shape checks and error strings, and the same ``auto`` backend heuristic.

Every route of the JAX package is ported: ``sinkhorn`` with the
``tensorized``, ``online`` and ``multiscale`` backends (``auto`` included,
and the 6-argument form with cluster labels), and the kernel (MMD) losses
``gaussian``, ``laplacian`` and ``energy``, and ``hausdorff`` (an alias of
the kernel routines that needs ``kernel=``), with the same three backends.
"""

import warnings
from functools import partial

import torch

from ..utils import profiling
from .kernel_samples import kernel_multiscale, kernel_online, kernel_tensorized
from .multiscale import sinkhorn_multiscale
from .sinkhorn_samples import sinkhorn_online, sinkhorn_tensorized

routines = {
    "sinkhorn": {
        "tensorized": sinkhorn_tensorized,
        "online": sinkhorn_online,
        "multiscale": sinkhorn_multiscale,
    },
    "hausdorff": {
        # Aliased to the kernel routines, as in the JAX package.
        "tensorized": kernel_tensorized,
        "online": kernel_online,
        "multiscale": kernel_multiscale,
    },
    **{
        name: {
            "tensorized": partial(kernel_tensorized, name=name),
            "online": partial(kernel_online, name=name),
            "multiscale": partial(kernel_multiscale, name=name),
        }
        for name in ("energy", "gaussian", "laplacian")
    },
}


class SamplesLoss(torch.nn.Module):
    """Geometric loss between sampled measures.

    * ``loss``: "sinkhorn", "hausdorff", "energy", "gaussian", "laplacian".
    * ``backend``: "auto", "tensorized", "online", "multiscale".
    """

    def __init__(
        self,
        loss="sinkhorn",
        p=2,
        blur=0.05,
        reach=None,
        diameter=None,
        scaling=0.5,
        truncate=5,
        cost=None,
        kernel=None,
        cluster_scale=None,
        debias=True,
        potentials=False,
        verbose=False,
        backend="auto",
    ):
        super().__init__()
        self.loss = loss
        self.backend = backend
        self.p = p
        self.blur = blur
        self.reach = reach
        self.truncate = truncate
        self.diameter = diameter
        self.scaling = scaling
        self.cost = cost
        self.kernel = kernel
        self.cluster_scale = cluster_scale
        self.debias = debias
        self.potentials = potentials
        self.verbose = verbose

    @profiling.spanned("loss", new_call=True)
    def forward(self, *args):
        """Compute the loss between two sampled measures (the root span of a
        call, :mod:`..utils.profiling`)."""
        l_x, a, x, l_y, b, y = self.process_args(*args)
        B, N, M, D, l_x, a, l_y, b = self.check_shapes(l_x, a, x, l_y, b, y)

        backend = self.backend
        if l_x is not None or l_y is not None:
            if backend in ["auto", "multiscale"]:
                backend = "multiscale"
            else:
                raise ValueError(
                    "Explicit cluster labels are only supported with the "
                    '"auto" and "multiscale" backends.'
                )
        elif backend == "auto":
            if M * N <= 5000**2:
                backend = "tensorized"
            elif D <= 3 and self.loss == "sinkhorn" and M * N > 10000**2 and self.p == 2:
                backend = "multiscale"
            else:
                backend = "online"

        if backend == "multiscale":
            if B == 1:
                a, x, b, y = a.squeeze(0), x.squeeze(0), b.squeeze(0), y.squeeze(0)
            elif B > 1:
                warnings.warn(
                    "The 'multiscale' backend does not support batchsize > 1. "
                    "Using 'tensorized' instead: beware of memory overflows!"
                )
                backend = "tensorized"

        if B == 0 and backend in ["tensorized", "online"]:
            a, x, b, y = a[None], x[None], b[None], y[None]

        values = routines[self.loss][backend](
            a,
            x,
            b,
            y,
            p=self.p,
            blur=self.blur,
            reach=self.reach,
            diameter=self.diameter,
            scaling=self.scaling,
            truncate=self.truncate,
            cost=self.cost,
            kernel=self.kernel,
            cluster_scale=self.cluster_scale,
            debias=self.debias,
            potentials=self.potentials,
            labels_x=l_x,
            labels_y=l_y,
            verbose=self.verbose,
        )

        if self.potentials:
            F, G = values
            return F.reshape(a.shape), G.reshape(b.shape)
        if backend == "multiscale":
            return values if B == 0 else values.reshape(-1)
        # tensorized/online return a batch vector:
        return values[0] if B == 0 else values

    def process_args(self, *args):
        if len(args) == 6:
            return args
        if len(args) == 4:
            a, x, b, y = args
            return None, a, x, None, b, y
        if len(args) == 2:
            x, y = args
            return None, self.generate_weights(x), x, None, self.generate_weights(y), y
        raise ValueError(
            "A SamplesLoss accepts two (x, y), four (a, x, b, y) "
            "or six (l_x, a, x, l_y, b, y) arguments."
        )

    def generate_weights(self, x):
        if x.ndim == 2:
            N = x.shape[0]
            return torch.full((N,), 1.0 / N, dtype=x.dtype, device=x.device)
        if x.ndim == 3:
            B, N, _ = x.shape
            return torch.full((B, N), 1.0 / N, dtype=x.dtype, device=x.device)
        raise ValueError(
            "Input samples 'x' and 'y' should be encoded as "
            "(N,D) or (B,N,D) (batch) tensors."
        )

    def check_shapes(self, l_x, a, x, l_y, b, y):
        if a.ndim != b.ndim:
            raise ValueError(
                "Input weights 'a' and 'b' should have the same number of dimensions."
            )
        if x.ndim != y.ndim:
            raise ValueError(
                "Input samples 'x' and 'y' should have the same number of dimensions."
            )
        if x.shape[-1] != y.shape[-1]:
            raise ValueError(
                "Input samples 'x' and 'y' should have the same last dimension."
            )

        if x.ndim == 2:
            B = 0
            N, D = x.shape
            M, _ = y.shape
            if a.ndim not in (1, 2):
                raise ValueError(
                    "Without batches, input weights 'a' and 'b' should be "
                    "encoded as (N,) or (N,1) tensors."
                )
            if a.ndim == 2:
                if a.shape[1] > 1 or b.shape[1] > 1:
                    raise ValueError(
                        "Without batches, input weights should be (N,) or (N,1)."
                    )
                a, b = a.reshape(-1), b.reshape(-1)
            for lab, n, name in ((l_x, N, "l_x"), (l_y, M, "l_y")):
                if lab is not None and lab.reshape(-1).shape[0] != n:
                    raise ValueError(
                        f"The vector of labels '{name}' should have the same "
                        "length as the corresponding point cloud."
                    )
            if l_x is not None:
                l_x = l_x.reshape(-1)
            if l_y is not None:
                l_y = l_y.reshape(-1)
            N2, M2 = a.shape[0], b.shape[0]

        elif x.ndim == 3:
            B, N, D = x.shape
            B2, M, _ = y.shape
            if B != B2:
                raise ValueError("Samples 'x' and 'y' should have the same batchsize.")
            if a.ndim not in (2, 3):
                raise ValueError(
                    "With batches, input weights 'a' and 'b' should be "
                    "encoded as (B,N) or (B,N,1) tensors."
                )
            if a.ndim == 3:
                if a.shape[2] > 1 or b.shape[2] > 1:
                    raise ValueError(
                        "With batches, input weights should be (B,N) or (B,N,1)."
                    )
                a, b = a.squeeze(-1), b.squeeze(-1)
            if l_x is not None or l_y is not None:
                raise NotImplementedError(
                    'The "multiscale" backend has not been implemented with batches.'
                )
            if a.shape[0] != B or b.shape[0] != B:
                raise ValueError("Weights and samples should have the same batchsize.")
            N2, M2 = a.shape[1], b.shape[1]
        else:
            raise ValueError(
                "Input samples 'x' and 'y' should be encoded as "
                "(N,D) or (B,N,D) (batch) tensors."
            )

        if N != N2:
            raise ValueError("Weights 'a' and samples 'x' should have compatible shapes.")
        if M != M2:
            raise ValueError("Weights 'b' and samples 'y' should have compatible shapes.")

        return B, N, M, D, l_x, a, l_y, b
