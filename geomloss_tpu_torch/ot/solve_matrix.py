r"""``ot.solve`` / ``ot.solve_batch``: OT with an explicit cost matrix.

Counterpart of :mod:`geomloss_tpu.ot.solve_matrix`: the dense batched
softmin (with the :math:`\varepsilon \in \{0, \infty\}` limit cases of the
initialization), validation, annealing driven by ``max_iter``, the biased
Sinkhorn loop (no debiasing for a fixed cost matrix), the
``OTResultMatrix`` result, and the fixed-support barycenter. No kernel of
the port is on this path: the log-sum-exps are ``torch.logsumexp``, as
the JAX package computes them in XLA.
"""

import math

import torch

from ..solvers.annealing import annealing_parameters
from ..solvers.barycenters import barycenter_iteration
from ..solvers.sinkhorn_ot import sinkhorn_loop
from ..utils.cache import lazy_properties
from ..utils.typing import CostMatrices
from ..utils.validation import (
    ArrayProperties,
    check_library_dtype_device,
    check_marginal,
    check_marginal_masses,
    check_regularization,
    convert_inputs,
)
from .result import LinearOperator, OTResult

__all__ = ["softmin_dense", "solve", "solve_batch", "OTResultMatrix", "barycenter"]


def softmin_dense(eps, log_weights, costs, potentials):
    r"""Batched dense softmin with explicit eps = 0 / +infinity limit cases.

    ``f_x[i] = -eps * log sum_j exp(log_b[j] + (g[j] - C[i,j]) / eps)``

    Shapes: log_weights ``(B, M)``, costs ``(B, N, M)``, potentials
    ``(B, M)`` -> ``(B, N)``.
    """
    log_b_y, C_xy, g_y = log_weights, costs, potentials
    assert len(C_xy.shape) == 3, "C_xy should be a (B,N,M) Tensor."
    B, N, M = C_xy.shape
    assert g_y.shape == (B, M)
    assert log_b_y.shape == (B, M)

    if isinstance(eps, float) and eps == float("inf"):
        # Weighted average of (C - g): the eps -> infinity limit.
        b_y = torch.exp(log_b_y)  # (B, M)
        sum_b = b_y.sum(dim=1, keepdim=True)  # (B, 1)
        f_i = ((C_xy - g_y[:, None, :]) * b_y[:, None, :]).sum(dim=2)  # (B, N)
        return f_i / sum_b
    elif isinstance(eps, float) and eps == 0:
        return torch.amin(C_xy - g_y[:, None, :], dim=2)  # hard C-transform
    else:
        scores_xy = (log_b_y + g_y / eps)[:, None, :] - C_xy / eps
        return -eps * torch.logsumexp(scores_xy, dim=2)


def stable_log(a):
    """log with values clamped to -100000 for zero weights (and a 1e-30
    floor inside the log, so that its gradient stays finite)."""
    return torch.where(a > 0, torch.log(torch.clamp(a, min=1e-30)), torch.full_like(a, -100000.0))


@lazy_properties
class OTResultMatrix(OTResult):
    """Result of an OT problem computed from an explicit cost matrix."""

    def __init__(
        self,
        *,
        a,
        b,
        C,
        potentials,
        array_properties,
        reg,
        reg_type,
        unbalanced,
        unbalanced_type,
    ):
        super().__init__(
            a=a,
            b=b,
            C=C,
            potentials=potentials,
            array_properties=array_properties,
            batchsize=array_properties.B,
            reg=reg,
            reg_type=reg_type,
            unbalanced=unbalanced,
            unbalanced_type=unbalanced_type,
            debias=False,
        )
        ap = self._array_properties
        self._shapes = {
            "a": (ap.B, ap.N),
            "b": (ap.B, ap.M),
            "C": (ap.B, ap.N, ap.M),
            "B": (ap.B,),
        }

    _cached_properties = (
        "potential_a",
        "potential_b",
        "density",
        "lazy_density",
        "density_operator",
        "plan",
        "lazy_plan",
        "plan_operator",
        "value",
        "value_linear",
        "marginal_a",
        "marginal_b",
        "citation",
    )

    def _squeeze_batchdim(self):
        """Removes the batch dimension, assuming that it is a dummy one."""
        ap = self._array_properties
        assert ap.B == 1
        assert self._batchsize == 1
        self._batchsize = 0
        self._shapes = {
            "a": (ap.N,),
            "b": (ap.M,),
            "C": (ap.N, ap.M),
            "B": (),
        }

    def _density(self):
        r"""Density $P_{ij} = \exp((f_i + g_j - C_{ij})/\varepsilon)$ of the
        transport plan w.r.t. $\alpha \otimes \beta$."""
        f = self._potentials.f_ba  # (B, N)
        g = self._potentials.g_ab  # (B, M)
        C = self._C  # (B, N, M)
        eps = self._reg
        assert eps > 0
        D_ij = torch.exp((f[:, :, None] + g[:, None, :] - C) / eps)
        return self.cast(D_ij, "C")

    def _density_operator(self):
        r"""Linear operator associated to :attr:`density`."""
        return LinearOperator.from_dense(
            self.density,
            input_shape=self._shapes["b"],
            output_shape=self._shapes["a"],
        )

    def _plan(self):
        r"""Optimal transport plan $\pi_{ij} = \alpha_i \beta_j P_{ij}$."""
        a, b = self._a, self._b
        dens = self.density
        ap = self._array_properties
        B, N, M = ap.B, ap.N, ap.M
        if self._batchsize == 0:
            dens = dens.reshape(B, N, M)
        if self._reg_type == "KL":
            plan = a[:, :, None] * b[:, None, :] * dens
        else:
            raise NotImplementedError(
                "Currently, we only support the computation "
                "of transport plans when `reg_type = 'KL'`."
            )
        return self.cast(plan, "C")


@convert_inputs("C", "a", "b")
def solve(
    C,
    *,
    reg,
    a=None,
    b=None,
    unbalanced=None,
    unbalanced_type="KL",
    method="auto",
    max_iter=None,
    tol=None,
) -> OTResultMatrix:
    r"""Solves an entropy-regularized OT problem with an explicit cost matrix.

    See :func:`solve_batch` for the batched version. Returns an
    :class:`OTResultMatrix` with lazily computed ``plan``, ``value``,
    ``potential_a/b`` and ``marginal_a/b`` attributes.

    Example:
        >>> import torch
        >>> from geomloss_tpu_torch import ot
        >>> sol = ot.solve(C=torch.tensor([[0., 1., 4.], [2., 1., 0.]]),
        ...                a=[2., 2.], b=[1., 1., 2.], reg=0.001, max_iter=100)
        >>> print(sol.plan.round(decimals=3))
        tensor([[1., 1., 0.],
                [0., 0., 2.]])
    """
    if len(C.shape) != 2:
        raise ValueError(
            "The 'cost' matrix should be an array with 2 dimensions. "
            f"Instead, ot.solve received an array of shape {tuple(C.shape)}."
        )
    N, M = C.shape
    a = check_marginal(a, ones_like=C[:, 0], marginal_size=N, name="a")
    b = check_marginal(b, ones_like=C[0, :], marginal_size=M, name="b")

    result = solve_batch(
        C[None, :, :],
        a=a[None, :],
        b=b[None, :],
        reg=reg,
        unbalanced=unbalanced,
        unbalanced_type=unbalanced_type,
        method=method,
        max_iter=max_iter,
        tol=tol,
    )
    result._squeeze_batchdim()
    return result


@convert_inputs("C", "a", "b")
def solve_batch(
    C,
    *,
    reg,
    a=None,
    b=None,
    unbalanced=None,
    unbalanced_type="KL",
    method="auto",
    max_iter=None,
    tol=None,
) -> OTResultMatrix:
    r"""Batched version of :func:`solve`: B problems in parallel."""
    check_regularization(
        reg=reg,
        unbalanced=unbalanced,
        unbalanced_type=unbalanced_type,
        method=method,
        tol=tol,
        max_iter=max_iter,
    )

    if len(C.shape) != 3:
        raise ValueError(
            "The 'cost' matrix should be an array with 3 dimensions (batch, N, M). "
            f"Instead, ot.solve received an array of shape {tuple(C.shape)}."
        )
    B, N, M = C.shape

    a = check_marginal(a, ones_like=C[:, :, 0], marginal_size=N, name="a")
    b = check_marginal(b, ones_like=C[:, 0, :], marginal_size=M, name="b")

    if unbalanced is None:
        check_marginal_masses(a.sum(dim=1), b.sum(dim=1))

    library, dtype, device = check_library_dtype_device(a, b, C)
    array_properties = ArrayProperties(
        B=B, N=N, M=M, dtype=dtype, device=device, library=library
    )

    descent = annealing_parameters(
        maxmin_cost=float((C.max() - C.min()).item()),
        eps=reg,
        rho=unbalanced,
        n_iter=max_iter,
    )

    # N.B.: With a fixed cost matrix, there is no debiasing.
    potentials = sinkhorn_loop(
        softmin=softmin_dense,
        log_a_list=[stable_log(a)],
        log_b_list=[stable_log(b)],
        C_list=[CostMatrices(xy=C, yx=C.transpose(1, 2))],
        descent=descent,
        debias=False,
        last_extrapolation=True,
    )

    return OTResultMatrix(
        a=a,
        b=b,
        C=C,
        potentials=potentials,
        array_properties=array_properties,
        reg=reg,
        reg_type="KL",
        unbalanced=unbalanced,
        unbalanced_type=unbalanced_type,
    )


class BarycenterResult:
    """Result of a Wasserstein barycenter problem: ``masses`` are the
    barycenter weights on its ``M``-point support, ``samples`` the support
    coordinates when the solver chooses them (free-support problems;
    ``None`` otherwise)."""

    def __init__(self, *, masses, samples=None, potentials=None, reg=None):
        self.masses = masses
        self.samples = samples
        self.potentials = potentials
        self.reg = reg

    def __repr__(self):
        shape = tuple(self.masses.shape)
        tail = "" if self.samples is None else f", samples{tuple(self.samples.shape)}"
        return f"BarycenterResult(masses{shape}{tail})"


def _softmin_bk(eps, C, h):
    """Softmin over the last axis of ``C`` with a (B, K) problem batch:
    h ``(B, K, X)``, C ``(B, K, Y, X)`` -> ``(B, K, Y)``."""
    return -eps * torch.logsumexp(h[:, :, None, :] - C / eps, dim=-1)


def _barycenter_C(cost, Ct, C_bb):
    """Cost descriptor of the shared barycenter iteration: ``xy`` maps the
    data supports to the barycenter (the transposed stack), ``xx`` is the
    barycenter self-cost of the debiasing update (``None`` turns debiasing
    off: the iteration then pins the mass to the simplex).

    Shapes: cost ``(B, K, N, M)``, Ct its transpose, C_bb ``(B, M, M)``.
    """
    xx = None if C_bb is None else C_bb[:, None, :, :]
    return CostMatrices(xy=Ct, yx=cost, xx=xx)


@convert_inputs("cost", "a", "weights", "cost_bar")
def barycenter(
    cost,
    a=None,
    weights=None,
    *,
    reg,
    max_iter,
    cost_bar=None,
    backward_iterations=5,
    maxmin_cost=None,
) -> BarycenterResult:
    r"""Entropic Wasserstein barycenter on a fixed support, from explicit
    cost matrices.

    Solves ``argmin_bar sum_k weights[k] * OT_reg(a_k, bar)`` over the
    masses of a fixed ``M``-point barycenter support, by symmetric
    log-domain iterative Bregman projections with epsilon-annealing.

    Args:
        cost: ``(N, M)``, ``(K, N, M)`` or ``(B, K, N, M)`` cost matrices
            from each input measure's ``N``-point support to the shared
            ``M``-point barycenter support.
        a: input masses, ``(N,)``, ``(K, N)`` or ``(B, K, N)``
            (default: uniform ``1/N``).
        weights: barycentric weights, ``(K,)`` or ``(B, K)``
            (default: uniform ``1/K``).
        reg: entropic regularization strength (the final temperature of
            the annealing schedule).
        max_iter: number of Sinkhorn iterations.
        cost_bar: optional ``(M, M)`` / ``(B, M, M)`` cost on the
            barycenter support itself. When given, the Janati-Cuturi-
            Gramfort debiasing density is tracked.
        backward_iterations: trailing iterations re-run with autograd on
            (the envelope shortcut; everything before is detached), so
            gradients flow to ``cost``, ``a``, ``weights``. ``0``
            differentiates through the whole annealed descent instead.
        maxmin_cost: optional bound on ``max(cost) - min(cost)`` (the
            annealing start temperature); read from ``cost`` by default.

    Returns:
        :class:`BarycenterResult` with ``masses`` of shape ``(M,)`` or
        ``(B, M)`` (matching the input batch form).
    """
    check_regularization(
        reg=reg,
        unbalanced=None,
        unbalanced_type="KL",
        method="auto",
        tol=None,
        max_iter=max_iter,
    )
    cost = torch.as_tensor(cost)
    if cost.ndim == 2:
        batched = False
        cost = cost[None, None]
    elif cost.ndim == 3:
        batched = False
        cost = cost[None]
    elif cost.ndim == 4:
        batched = True
    else:
        raise ValueError(
            "The 'cost' argument of ot.barycenter should be an array with "
            "2 (N, M), 3 (K, N, M) or 4 (B, K, N, M) dimensions. "
            f"Received shape {tuple(cost.shape)}."
        )
    B, K, N, M = cost.shape
    like = dict(dtype=cost.dtype, device=cost.device)

    if a is None:
        a = torch.full((B, K, N), 1.0 / N, **like)
    else:
        a = torch.as_tensor(a, **like)
        if tuple(a.shape) in ((N,), (K, N)):
            a = a.expand(B, K, N)
        elif tuple(a.shape) != (B, K, N):
            raise ValueError(
                "The masses 'a' should have shape (N,), (K, N) or (B, K, N) "
                f"matching the ({B}, {K}, {N}, {M}) cost matrices; received "
                f"{tuple(a.shape)}."
            )
        # Probability measures (the balanced-Sinkhorn derivation assumes
        # mass 1, like barycenter_sample):
        a = a / a.sum(dim=-1, keepdim=True)
    if weights is None:
        weights = torch.full((B, K), 1.0 / K, **like)
    else:
        weights = torch.as_tensor(weights, **like)
        weights = weights.reshape(-1, K).expand(B, K)
        weights = weights / weights.sum(dim=1, keepdim=True)

    if cost_bar is not None:
        cost_bar = torch.as_tensor(cost_bar, **like)
        if cost_bar.ndim == 2:
            cost_bar = cost_bar[None]
        if tuple(cost_bar.shape[-2:]) != (M, M):
            raise ValueError(
                f"cost_bar should be an (M, M) = ({M}, {M}) cost on the "
                f"barycenter support; received shape {tuple(cost_bar.shape)}."
            )
        cost_bar = cost_bar.expand(B, M, M)

    if maxmin_cost is None:
        maxmin_cost = float((cost.max() - cost.min()).item())
    descent = annealing_parameters(maxmin_cost=maxmin_cost, eps=reg, n_iter=max_iter)
    eps_list = [float(e) for e in descent.eps_list]

    Ct = cost.transpose(2, 3)  # (B, K, M, N)
    log_a = stable_log(a)

    # --- Annealed descent ----------------------------------------------------
    # backward_iterations > 0: run without autograd (envelope shortcut),
    # then a differentiable tail. backward_iterations == 0: gradients flow
    # through the whole descent instead.
    detach = backward_iterations > 0
    C_desc = _barycenter_C(cost, Ct, cost_bar)
    with torch.set_grad_enabled(torch.is_grad_enabled() and not detach):
        f_k = _softmin_bk(eps_list[0], Ct, log_a)  # (B, K, M)
        log_d = torch.full((B, 1, M), -math.log(M), **like)  # uniform reference
        g_k = _softmin_bk(eps_list[0], cost, log_d)  # (B, K, N)
        for eps in eps_list:
            f_k, g_k, log_d, _ = barycenter_iteration(
                softmin=_softmin_bk, f_k=f_k, g_k=g_k, log_d=log_d, eps=eps,
                C=C_desc, log_b_k=log_a, w_k=weights,
            )

    # --- Tail at the target temperature --------------------------------------
    eps = eps_list[-1]
    if detach:
        for _ in range(backward_iterations):
            f_k, g_k, log_d, log_bar = barycenter_iteration(
                softmin=_softmin_bk, f_k=f_k, g_k=g_k, log_d=log_d, eps=eps,
                C=C_desc, log_b_k=log_a, w_k=weights,
            )
    else:
        # Extract the barycenter from the (fully differentiable) final
        # state with one pseudo-step:
        ft_k = _softmin_bk(eps, Ct, log_a + g_k / eps)
        log_bar = log_d - (ft_k / eps * weights[:, :, None]).sum(1, keepdim=True)
        if cost_bar is None:
            log_bar = log_bar - torch.logsumexp(log_bar, dim=-1, keepdim=True)

    masses = torch.exp(log_bar[:, 0])
    if not batched:
        masses = masses[0]
        f_k, g_k = f_k[0], g_k[0]
    return BarycenterResult(masses=masses, potentials=(f_k, g_k), reg=reg)
