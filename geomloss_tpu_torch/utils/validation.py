"""Argument validation and input conversion for the ``ot.solve*`` API.

Counterpart of :mod:`geomloss_tpu.utils.validation`. The user-facing
checks (shapes, non-negativity, balanced-mass feasibility, supported
regularizations) are the same, and so are their error strings, which are
copied character for character: scripts and tests match on them.
"""

from functools import wraps
from inspect import signature
from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = [
    "ArrayProperties",
    "check_regularization",
    "check_dtype",
    "check_library_dtype_device",
    "check_marginal",
    "check_marginal_masses",
    "convert_inputs",
]


class ArrayProperties(NamedTuple):
    B: int  # Batch dimension, 0 if not batch mode
    N: int  # Number of source samples
    M: int  # Number of target samples
    dtype: Any  # Numerical dtype
    device: Any  # Physical device
    library: str  # Always "torch" here


def check_regularization(*, reg, unbalanced, unbalanced_type, method, tol,
                         max_iter, allowed_methods=("auto",)):
    """``allowed_methods`` lists the methods of the calling front end
    (``ot.solve_sample`` also accepts ``method="multiscale"``)."""
    if reg < 0:
        raise ValueError(f"Parameter 'reg' should be >= 0. Received {reg}.")
    elif reg == 0:
        raise NotImplementedError("Currently, we require that reg > 0.")

    if unbalanced is not None and unbalanced <= 0:
        raise ValueError(
            "Parameter 'unbalanced' should be None (= +infty) "
            f"or > 0. Received {unbalanced}."
        )

    if unbalanced_type != "KL":
        raise NotImplementedError(
            "Currently, we only support unbalanced OT with "
            "a 'KL' penalty on the marginal constraints."
        )

    if method not in allowed_methods:
        raise NotImplementedError("Currently, we only support a single method.")

    if max_iter is None:
        raise ValueError("The 'max_iter' parameter should be a positive integer.")

    if tol is not None:
        raise NotImplementedError(
            "Currently, we do not support rigorous stopping criteria."
        )


def check_dtype(*args):
    dtypes = list(set(torch.as_tensor(a).dtype for a in args))
    if len(dtypes) > 1:
        raise ValueError(
            "The input arrays do not have the same numerical dtype: "
            f"received a collection of {dtypes}, which is ambiguous. "
            "To fix this error, please cast all arrays to the same numerical dtype."
        )
    return dtypes[0]


def check_library_dtype_device(*args):
    dtype = check_dtype(*args)
    devices = list(set(str(getattr(a, "device", "cpu")) for a in args))
    if len(devices) > 1:
        raise ValueError(
            "The input arrays are not stored on the same device: "
            f"received a collection of {devices}, which is ambiguous."
        )
    return "torch", dtype, devices[0]


def check_marginal(m, *, ones_like, marginal_size, name):
    """Default: uniform ``1 / marginal_size``."""
    if m is None:
        m = torch.ones_like(ones_like) / marginal_size

    if m.shape != ones_like.shape:
        raise ValueError(
            f"The marginal '{name}' should be of shape {tuple(ones_like.shape)}. "
            f"Instead, received an array of shape {tuple(m.shape)}."
        )

    if bool(torch.any(m < 0)):
        raise ValueError(
            f"The marginal '{name}' contains negative values. "
            f"We require that {name} >= 0."
        )
    return m


def check_marginal_masses(sums_a, sums_b, rtol=1e-3):
    """Balanced-OT feasibility check."""
    rel_diffs = torch.abs(sums_a - sums_b) / (sums_a + sums_b)
    if bool(torch.any(rel_diffs > rtol)):
        if sums_a.shape[0] == 1:
            s = "do not sum up to the same value. "
        else:
            s = "have rows that do not sum up to the same values. "
        raise ValueError(
            "The two arrays of marginal weights 'a' and 'b' "
            f"{s}"
            "As a consequence, the balanced OT problem is not feasible. "
            "To fix this error, you may either normalize the two marginals "
            "to make sure that their weights sum up to compatible values "
            "(= 1 for probability distributions), or use UNbalanced optimal "
            "transport with the 'unbalanced' keyword argument."
        )


def convert_inputs(*param_names):
    """Decorator: convert list / tuple / numpy arguments to tensors.

    They become tensors of ``torch.get_default_dtype()`` (as the JAX
    package's default configuration turns float64 numpy into float32), on
    the device of the call's tensor arguments, or on the card
    (``torch.device("cuda")``) where the call has none: like
    :func:`~geomloss_tpu_torch.utils.from_numpy`, nothing moves to the CPU
    unless the caller's tensors lie there.
    """

    def decorator(func):
        sig = signature(func)

        @wraps(func)
        def wrapper(*args, **kwargs):
            bound_args = sig.bind(*args, **kwargs)
            bound_args.apply_defaults()
            device = next(
                (v.device for v in bound_args.arguments.values() if isinstance(v, torch.Tensor)),
                torch.device("cuda"),
            )
            for param_name in param_names:
                value = bound_args.arguments.get(param_name)
                if isinstance(value, (list, tuple, np.ndarray)):
                    bound_args.arguments[param_name] = torch.tensor(
                        np.asarray(value, dtype=np.float64),
                        dtype=torch.get_default_dtype(),
                        device=device,
                    )
            return func(*bound_args.args, **bound_args.kwargs)

        return wrapper

    return decorator
