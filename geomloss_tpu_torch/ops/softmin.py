r"""Soft-C-transforms (softmin) and Gibbs-kernel applications.

Counterpart of :mod:`geomloss_tpu.ops.softmin`. The softmin

.. math::
    f_i \gets -\varepsilon \log \sum_j \exp\big[h_j - C(x_i, y_j)/\varepsilon\big]

is the hot operation of every Sinkhorn-like solver. Three interchangeable
implementations of the streaming operations, chosen by ``impl``:

* ``dense``: explicit ``(N, M)`` cost matrices (small problems);
* ``blocked``: the plain PyTorch twins of the kernels, over column blocks,
  ``O(N * BM)`` memory (see :mod:`.cuda_kernels`);
* ``cuda``: the hand-written Hopper kernels (plain twins for CPU tensors).

``auto`` takes ``cuda`` for CUDA tensors, and on the CPU ``dense`` up to
``4096^2`` pairs, ``blocked`` beyond.

The differentiable operations are ``torch.autograd.Function``\ s with the
analytic streaming backward passes of the JAX package: the derivative of a
log-sum-exp is a softmax-weighted reduction with the same structure as the
forward pass, so gradients also run in ``O(N + M)`` memory.
"""

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..utils import profiling
from . import cuda_kernels as ck
from .costs import SQDIST_FLOOR, cost_routines, squared_distances

__all__ = [
    "softmin_dense",
    "softmin_points",
    "sinkhorn_step_points",
    "softmin_extrapolation",
    "softmin_extrapolation_sym",
    "gibbs_apply",
    "gibbs_matvec",
    "lse_points",
    "lse_points_custom",
]


# ==============================================================================
#  Dense softmin on explicit cost matrices ("tensorized")
# ==============================================================================


def softmin_dense(eps, C, h):
    """Softmin on a dense ``(..., N, M)`` cost matrix; ``h`` is ``(..., M)``.

    Returns the ``(..., N)`` dual potential.
    """
    return -eps * torch.logsumexp(h[..., None, :] - C / eps, dim=-1)


# ==============================================================================
#  Streaming log-sum-exp over implicit point-cloud costs
# ==============================================================================


def _lse_dense(x, y, h, eps, p):
    C = cost_routines[p](x, y)
    return torch.logsumexp(h[None, :] - C / eps, dim=-1)


def _resolve_impl(impl, x, y):
    if impl == "auto":
        if x.is_cuda:
            return "cuda"
        return "dense" if x.shape[0] * y.shape[0] <= 4096 * 4096 else "blocked"
    if impl not in ("dense", "blocked", "cuda"):
        raise ValueError(f"Unknown softmin implementation: {impl!r}")
    return impl


def _lse_points_raw(x, y, h, eps, p, impl):
    impl = _resolve_impl(impl, x, y)
    if impl == "dense":
        return _lse_dense(x, y, h, eps, p)
    if impl == "blocked":
        # The blocked LSE is the plain twin of the LSE kernel.
        return ck.lse_blocked(x, y, h, eps, p)
    return ck.lse(x, y, h, eps, p)


# ------------------------------------------------------------------------------
#  Fused symmetric Sinkhorn step
# ------------------------------------------------------------------------------


def sinkhorn_step_points(eps, x, y, a_log, b_log, f, g, p=2, impl="auto", sym=False):
    r"""Both raw softmin values of one Jacobi-style Sinkhorn iteration:

    ``S_xy[i] = -eps*LSE_j(b_log_j + (g_j - C_ij)/eps)`` and
    ``S_yx[j] = -eps*LSE_i(a_log_i + (f_i - C_ij)/eps)``.

    ``blocked`` and ``cuda`` read both off one pass over the absorbed Gibbs
    matrix, with no max pass; ``dense`` takes two max-shifted LSEs. With
    ``sym=True`` the problem is symmetric (``y``, ``b_log``, ``g`` are
    ``x``, ``a_log``, ``f``): only ``S_xy`` is computed, over the upper
    triangle of tile pairs, and ``S_yx`` is ``None``.
    """
    impl = _resolve_impl(impl, x, y)
    if impl == "dense":
        S_xy = -eps * _lse_dense(x, y, b_log + g / eps, eps, p)
        if sym:
            return S_xy, None
        return S_xy, -eps * _lse_dense(y, x, a_log + f / eps, eps, p)
    if sym:
        step_sym = ck.sinkhorn_step_sym_blocked if impl == "blocked" else ck.sinkhorn_step_sym
        return step_sym(x, f, a_log, eps, p), None
    step = ck.sinkhorn_step_blocked if impl == "blocked" else ck.sinkhorn_step
    return step(x, y, f, g, a_log, b_log, eps, p)


# ------------------------------------------------------------------------------
#  Fused differentiable last extrapolation
# ------------------------------------------------------------------------------
#
# Gradient semantics: costs are built with a detached second argument, so
# ``S_xy`` only differentiates w.r.t. ``x`` and ``S_yx`` only w.r.t. ``y``;
# the potentials, weights and ``eps`` are constants.


def _extrap_dx(x, y, f, g, loga, logb, eps, S, u, p, impl):
    """d<u, S_xy>/dx for the absorbed softmin (row direction)."""
    # Row-normalized absorbed weights w~_ij = exp(S_i/eps + g_j/eps + logb_j
    # - C_ij/eps): phi = f/eps + loga - log(rowsum) = S/eps.
    phi = S / eps
    psi = g / eps + logb
    # dx = u * sum_j w~_ij (x_i - y_j), for p=2 as for p=1 (where w~ is
    # divided by the distance). The ones channel is kept even though the
    # p=2 weights sum to 1 in exact arithmetic: x sum w~ - sum w~ y turns a
    # float32 error in a row's normalization into a relative error of its
    # displacement x - T(x), where x - sum w~ y would scale it by |y| over
    # that (small) displacement. At N = M = 1e5 on the sphere this takes
    # the float32 gradient's relative L2 error against float64 from 2.2e-3
    # to 1.8e-4 (PERF.md).
    V = torch.cat([torch.ones_like(y[:, :1]), y], dim=-1)
    kind = "gibbs" if p == 2 else "gibbs_grad"
    R = gibbs_apply(x, y, phi, psi, V, eps, p, kind=kind, impl=impl)
    return u[:, None] * (x * R[:, :1] - R[:, 1:])


@profiling.autograd_spans
class _SoftminExtrapolation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, f, g, loga, logb, eps, p, impl):
        S_xy, S_yx = sinkhorn_step_points(eps, x, y, loga, logb, f, g, p=p, impl=impl)
        ctx.save_for_backward(x, y, f, g, loga, logb, S_xy, S_yx)
        ctx.eps, ctx.p, ctx.impl = eps, p, impl
        return S_xy, S_yx

    @staticmethod
    def backward(ctx, u_f, u_g):
        x, y, f, g, loga, logb, S_xy, S_yx = ctx.saved_tensors
        eps, p, impl = ctx.eps, ctx.p, ctx.impl
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = _extrap_dx(x, y, f, g, loga, logb, eps, S_xy, u_f, p, impl)
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dy = _extrap_dx(y, x, g, f, logb, loga, eps, S_yx, u_g, p, impl)
            dy = dy.to(y.dtype)
        return dx, dy, None, None, None, None, None, None, None


def softmin_extrapolation(x, y, f, g, loga, logb, eps, p, impl):
    r"""Raw softmin pair of the differentiable last extrapolation.

    Returns ``(S_xy, S_yx)`` (see :func:`sinkhorn_step_points`) with
    gradients flowing to ``x`` through ``S_xy`` and to ``y`` through
    ``S_yx`` only. ``f``, ``g``, ``loga``, ``logb`` and ``eps`` are
    treated as constants.
    """
    return _SoftminExtrapolation.apply(x, y, f, g, loga, logb, eps, p, impl)


@profiling.autograd_spans
class _SoftminExtrapolationSym(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, f, loga, eps, p, impl):
        S = sinkhorn_step_points(eps, x, x, loga, loga, f, f, p=p, impl=impl, sym=True)[0]
        ctx.save_for_backward(x, f, loga, S)
        ctx.eps, ctx.p, ctx.impl = eps, p, impl
        return S

    @staticmethod
    def backward(ctx, u):
        x, f, loga, S = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _extrap_dx(x, x, f, f, loga, loga, ctx.eps, S, u, ctx.p, ctx.impl)
            dx = dx.to(x.dtype)
        return dx, None, None, None, None, None


def softmin_extrapolation_sym(x, f, loga, eps, p, impl):
    """Symmetric-problem (debias) variant of :func:`softmin_extrapolation`:
    one direction, second cloud detached."""
    return _SoftminExtrapolationSym.apply(x, f, loga, eps, p, impl)


# ------------------------------------------------------------------------------
#  Gibbs kernel application (shared by VJPs and MMD matvecs)
# ------------------------------------------------------------------------------

#: Squared-distance cutoff below which distance-gradient weights are zeroed:
#: the expansion form's float32 noise makes the direction ``(x-y)/d`` pure
#: noise for pairs closer than ~1e-3.
GRAD_SQDIST_CUT = ck.GRAD_SQDIST_CUT


def _gibbs_weight_dense(x, y, phi, psi, eps, p, kind):
    """Dense ``(N, M)`` weight matrix for one of the supported kinds."""
    if kind == "energy":
        return -cost_routines[1](x, y)
    if kind == "inv_dist":
        sq = squared_distances(x, y)
        d = torch.sqrt(torch.clamp(sq, min=SQDIST_FLOOR))
        return torch.where(sq > GRAD_SQDIST_CUT, 1.0 / d, torch.zeros_like(d))
    if kind == "gibbs_grad" and p == 1:
        sq = squared_distances(x, y)
        d = torch.sqrt(torch.clamp(sq, min=SQDIST_FLOOR))
        w = torch.exp(phi[:, None] + psi[None, :] - d / eps)
        return torch.where(sq > GRAD_SQDIST_CUT, w / d, torch.zeros_like(w))
    C = cost_routines[p](x, y)
    return torch.exp(phi[:, None] + psi[None, :] - C / eps)


def _gibbs_apply_dense(x, y, phi, psi, V, eps, p, kind):
    return _gibbs_weight_dense(x, y, phi, psi, eps, p, kind) @ V


def gibbs_apply(x, y, phi, psi, V, eps, p, kind="gibbs", impl="auto"):
    r"""Streaming kernel-weighted reduction ``O_i = sum_j w_ij V_j`` with

    * ``kind='gibbs'``:      ``w_ij = exp(phi_i + psi_j - C_p(x_i,y_j)/eps)``
    * ``kind='gibbs_grad'``: same, divided by ``|x_i - y_j|`` when ``p == 1``,
    * ``kind='energy'``:     ``w_ij = -|x_i - y_j|``,
    * ``kind='inv_dist'``:   ``w_ij = 1 / |x_i - y_j|``,
    * ``kind='energy_grad'``: both of the last two from one pass, ``V``
      being the ``(M,)`` vector v: the energy kind's ``(N,)`` apply of v
      and the inv_dist kind's ``(N, 1 + D)`` apply of ``v [1, y]``.

    Args:
        x: ``(N, D)``; y: ``(M, D)``; phi: ``(N,)``; psi: ``(M,)``;
        V: ``(M, C)``; eps: scalar; p: 1 or 2; kind, impl: strings.

    Returns:
        ``(N, C)`` tensor (for ``energy_grad`` the pair of tensors).
    """
    impl = _resolve_impl(impl, x, y)
    if kind == ck.ENERGY_GRAD and impl != "cuda":
        return ck.energy_grad_plain(functools.partial(gibbs_apply, impl=impl), x, y, phi, psi, V, eps, p)
    if impl == "dense":
        return _gibbs_apply_dense(x, y, phi, psi, V, eps, p, kind)
    if impl == "blocked":
        return ck.gibbs_apply_blocked(x, y, phi, psi, V, eps, p, kind)
    return ck.gibbs_apply(x, y, phi, psi, V, eps, p, kind)


# ==============================================================================
#  Differentiable streaming softmin on point clouds
# ==============================================================================


@profiling.autograd_spans
class _LsePoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, h, eps, p, impl):
        out = _lse_points_raw(x, y, h, eps, p, impl)
        ctx.save_for_backward(x, y, h, out)
        ctx.eps, ctx.p, ctx.impl = eps, p, impl
        return out

    @staticmethod
    def backward(ctx, u):
        # out_i = log sum_j exp(h_j - C_ij/eps); w_ij = exp(h_j - C_ij/eps - out_i)
        # d/dh_j = sum_i u_i w_ij
        # d/dx_i = -(u_i/eps) sum_j w_ij dC_ij/dx_i
        # d/dy_j = -(1/eps)  sum_i u_i w_ij dC_ij/dy_j
        x, y, h, out = ctx.saved_tensors
        eps, p, impl = ctx.eps, ctx.p, ctx.impl
        need_x, need_y, need_h = ctx.needs_input_grad[:3]
        phi, psi = -out, h
        kind = "gibbs" if p == 2 else "gibbs_grad"
        dx = dy = dh = None
        if need_x:
            # Row side: R_i = sum_j w_ij [1, y_j]
            Vy = torch.cat([torch.ones_like(y[:, :1]), y], dim=-1)
            R = gibbs_apply(x, y, phi, psi, Vy, eps, p, kind=kind, impl=impl)
            dx = (-(u / eps)[:, None] * (x * R[:, :1] - R[:, 1:])).to(x.dtype)
        if need_y or (need_h and p == 2):
            # Column side: swap the roles of x and y, fold u into the channels.
            Vx = u[:, None] * torch.cat([torch.ones_like(x[:, :1]), x], dim=-1)
            Tq = gibbs_apply(y, x, psi, phi, Vx, eps, p, kind=kind, impl=impl)
            if need_y:
                dy = (-(1.0 / eps) * (y * Tq[:, :1] - Tq[:, 1:])).to(y.dtype)
            if need_h:
                dh = Tq[:, 0].to(h.dtype)
        if need_h and p == 1:
            # dh needs plain (non-grad) weights for p = 1:
            t = gibbs_apply(y, x, psi, phi, u[:, None], eps, p, kind="gibbs", impl=impl)
            dh = t[:, 0].to(h.dtype)
        return dx, dy, dh, None, None, None


def lse_points(x, y, h, eps, p, impl):
    r"""``lse_points(x,y,h,eps)[i] = log sum_j exp(h_j - C_p(x_i,y_j)/eps)``.

    Differentiable w.r.t. ``x``, ``y`` and ``h`` through an analytic,
    streaming backward pass; ``eps`` is a constant.
    """
    return _LsePoints.apply(x, y, h, eps, p, impl)


def lse_points_custom(x, y, h, eps, cost, block_m=2048):
    r"""Streaming LSE with a user-supplied cost callable
    ``cost((1,N,D), (1,BM,D)) -> (1,N,BM)``, evaluated block by block.

    Plain autograd with each block recomputed in the backward pass
    (activation checkpointing), so both passes run in ``O(N * BM)`` memory.
    This path has no kernel.
    """
    def block(y_blk, h_blk):
        C = cost(x[None], y_blk[None])[0]
        scores = h_blk[None, :] - C / eps
        blk_max = scores.max(dim=-1).values
        return blk_max, torch.exp(scores - blk_max[:, None]).sum(-1)

    m = s = None
    for j0 in range(0, y.shape[0], block_m):
        args = (y[j0 : j0 + block_m], h[j0 : j0 + block_m])
        if torch.is_grad_enabled():
            blk_max, blk_sum = checkpoint(block, *args, use_reentrant=False)
        else:
            blk_max, blk_sum = block(*args)
        if m is None:
            m, s = blk_max, blk_sum
        else:
            m_new = torch.maximum(m, blk_max)
            s = s * torch.exp(m - m_new) + blk_sum * torch.exp(blk_max - m_new)
            m = m_new
    return m + torch.log(s)


def softmin_points(eps, C_xy, h, p=2, impl="auto", cost=None):
    """Online softmin on point clouds.

    Args:
        eps: temperature.
        C_xy: pair ``(x, y)`` of ``(N, D)`` / ``(M, D)`` (or batched
            ``(B, N, D)`` / ``(B, M, D)``) point clouds. The caller decides
            which of the two carries gradients.
        h: ``(M,)`` or ``(B, M)`` dual vector.
        p: 1 or 2.
        impl: 'auto' | 'dense' | 'blocked' | 'cuda'.
        cost: optional callable ``(B,N,D),(B,M,D) -> (B,N,M)`` replacing
            the built-in ``|x-y|^p / p`` costs.

    Returns:
        ``(N,)`` or ``(B, N)`` potential.
    """
    x, y = C_xy
    if x.ndim == 3:
        return torch.stack(
            [softmin_points(eps, (x[b], y[b]), h[b], p, impl, cost) for b in range(x.shape[0])]
        )
    if cost is not None:
        return -eps * lse_points_custom(x, y, h, eps, cost)
    return -eps * lse_points(x, y, h, eps, p, impl)


# ==============================================================================
#  Differentiable streaming kernel matvec (MMD losses)
# ==============================================================================


@profiling.autograd_spans
class _GibbsMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, v, eps, p, kind, impl, fold):
        ctx.eps, ctx.p, ctx.kind, ctx.impl = eps, p, kind, impl
        z_n, z_m = x.new_zeros(x.shape[0]), y.new_zeros(y.shape[0])
        profiling.count("matvec.forwards")
        profiling.count("matvec.pairs", x.shape[0] * y.shape[0])
        if fold:
            # The energy value and the backward's dx apply from one pass; the
            # backward needs x R_0 - R_1: of it.
            profiling.count("matvec.grad_in_forward")
            out, R = gibbs_apply(x, y, z_n, z_m, v, eps, p, kind=ck.ENERGY_GRAD, impl=impl)
            ctx.save_for_backward(x, y, v, x * R[:, :1] - R[:, 1:])
            return out
        ctx.save_for_backward(x, y, v, None)
        return gibbs_apply(x, y, z_n, z_m, v[:, None], eps, p, kind=kind, impl=impl)[:, 0]

    @staticmethod
    def backward(ctx, u):
        # Only the applies whose gradients autograd asks for: the MMD self
        # terms detach y and v, so they take one apply, not three, and none
        # where the forward folded dx's in (G = x R_0 - R_1:).
        x, y, v, G = ctx.saved_tensors
        eps, p, kind, impl = ctx.eps, ctx.p, ctx.kind, ctx.impl
        need_x, need_y, need_v = ctx.needs_input_grad[:3]
        z_n, z_m = x.new_zeros(x.shape[0]), y.new_zeros(y.shape[0])
        if kind == "gibbs":
            # dO/dx_i = -(1/eps) sum_j w'_ij v_j (x_i - y_j), w' = w (p=2) or w/d (p=1).
            wk, pp, scale, dvk = ("gibbs" if p == 2 else "gibbs_grad"), p, 1.0 / eps, "gibbs"
        elif kind == "energy":
            # O = -sum_j d_ij v_j: dO/dx_i = -sum_j v_j (x_i - y_j)/d_ij.
            wk, pp, scale, dvk = "inv_dist", 1, 1.0, "energy"
        else:
            raise NotImplementedError(kind)

        def apply(rows, cols, phi, psi, V, weights):
            profiling.count("matvec.backward_applies")
            profiling.count("matvec.pairs", rows.shape[0] * cols.shape[0])
            return gibbs_apply(rows, cols, phi, psi, V, eps, pp, kind=weights, impl=impl)

        dx = dy = dv = None
        if need_x:
            if G is None:
                R = apply(x, y, z_n, z_m, ck.ones_points(y, v), wk)
                G = x * R[:, :1] - R[:, 1:]
            dx = (-(u * scale)[:, None] * G).to(x.dtype)
        # For p=2 Gibbs weights, dv is the ones channel of the column apply.
        dv_from_T = kind == "gibbs" and p == 2
        if need_y or (need_v and dv_from_T):
            T = apply(y, x, z_m, z_n, ck.ones_points(x, u), wk)
            if need_y:
                dy = (-(v * scale)[:, None] * (y * T[:, :1] - T[:, 1:])).to(y.dtype)
            if need_v and dv_from_T:
                dv = T[:, 0].to(v.dtype)
        if need_v and not dv_from_T:
            dv = apply(y, x, z_m, z_n, u[:, None], dvk)[:, 0].to(v.dtype)
        return dx, dy, dv, None, None, None, None, None


def gibbs_matvec(x, y, v, eps, p, kind, impl):
    r"""``O_i = sum_j k(x_i, y_j) v_j`` with an analytic streaming backward.

    ``kind='gibbs'``: :math:`k = \exp(-C_p/\varepsilon)`;
    ``kind='energy'``: :math:`k = -|x - y|`.

    The energy kind with grad enabled and ``x`` requiring grad folds the
    gradient in x into the forward: one pass over the pairs gives ``O``
    and the channels of ``dx`` (kernel 4's fused energy form, the
    ``energy_grad`` kind of :func:`gibbs_apply`), so the backward makes no
    apply for ``x``. A forward that no backward follows then pays that
    pass (about 1.2x the value's alone at D = 3) instead of the value's;
    under ``torch.no_grad()`` it pays nothing more. The gibbs kinds never
    fold.
    """
    fold = kind == "energy" and torch.is_grad_enabled() and x.requires_grad
    return _GibbsMatvec.apply(x, y, v, eps, p, kind, impl, fold)
