r"""``ot.solve_sample``: OT between point clouds, cost computed on the fly.

Counterpart of :mod:`geomloss_tpu.ot.sample_impl`: the ``sqeuclidean``
cost (no 1/p factor: ``reg = p * blur**p``), the unbatched softmin with
its eps limit cases, and the ``OTResultSample`` result, whose "lazy"
density and plan are streaming :class:`~.result.LinearOperator` objects.

Above :data:`STREAMING_THRESHOLD` cost entries the solver never builds a
cost matrix: every softmin is a streaming log-sum-exp
(:func:`geomloss_tpu_torch.ops.softmin.lse_points`, kernel 1 on the card)
and the result's density applies the Gibbs kernel
(:func:`~geomloss_tpu_torch.ops.softmin.gibbs_apply`, kernel 4), which
also carries the gradients of the last extrapolation.
"""

import math

import torch

from ..ops.softmin import gibbs_apply, lse_points
from ..solvers.annealing import annealing_parameters, max_diameter
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
from .solve_matrix import BarycenterResult, stable_log

__all__ = ["solve_sample", "solve_sample_batch", "OTResultSample", "barycenter_sample"]

#: Above this many cost-matrix entries, the solver and OTResultSample switch
#: to streaming (never materialized) softmins and operators.
STREAMING_THRESHOLD = 5000 * 5000

#: sqrt(2): points scaled by it turn the kernels' |u - v|^2 / 2 cost into
#: the |x - y|^2 of this API.
SQ2 = math.sqrt(2.0)


def squared_distances(x, y):
    """``|x_i - y_j|^2`` as a dense ``(N, M)`` matrix."""
    N, D = x.shape
    M, D_ = y.shape
    assert D == D_, "x and y should have the same number of coordinates per sample."
    D_xx = (x * x).sum(-1).reshape(N, 1)
    D_xy = x @ y.T
    D_yy = (y * y).sum(-1).reshape(1, M)
    return D_xx - 2 * D_xy + D_yy


def cost_matrix(x, y, cost="sqeuclidean"):
    if cost == "sqeuclidean":
        return squared_distances(x, y)
    raise NotImplementedError()


def softmin_sample(eps, log_weights, costs, potentials):
    r"""Unbatched softmin with eps = 0 / +infinity limit cases. ``costs``
    is either a dense ``(N, M)`` matrix or a pair of point clouds ``(x,
    y)`` for the streaming path."""
    log_b_y, g_y = log_weights, potentials

    if isinstance(costs, tuple):
        # Streaming path: the cost is computed on the fly, never stored.
        x, y = costs
        if isinstance(eps, float) and eps == float("inf"):
            # f_i = sum_j b_j (|x_i - y_j|^2 - g_j) / sum(b): expand the
            # square for a closed form in O(N + M), no pairwise matrix.
            b_y = torch.exp(log_b_y)
            sum_b = b_y.sum()
            sq_x = (x * x).sum(-1)  # (N,)
            wy = (b_y[:, None] * y).sum(0)  # (D,)
            cst = (b_y * (y * y).sum(-1)).sum() - torch.dot(b_y, g_y)
            f_i = sq_x * sum_b - 2.0 * (x @ wy) + cst
            return f_i / sum_b
        elif isinstance(eps, float) and eps == 0:
            raise NotImplementedError(
                "eps = 0 is not supported by the streaming softmin."
            )
        else:
            h = log_b_y + g_y / eps
            return -eps * lse_points(SQ2 * x, SQ2 * y, h, eps, 2, "auto")

    C_xy = costs
    assert len(C_xy.shape) == 2, "C_xy should be a (N,M) Tensor."
    N, M = C_xy.shape
    assert g_y.shape == (M,)
    assert log_b_y.shape == (M,)

    if isinstance(eps, float) and eps == float("inf"):
        b_y = torch.exp(log_b_y)
        sum_b = b_y.sum(dim=0, keepdim=True)
        f_i = ((C_xy - g_y[None, :]) * b_y[None, :]).sum(dim=1)
        return f_i / sum_b
    elif isinstance(eps, float) and eps == 0:
        return torch.amin(C_xy - g_y[None, :], dim=1)
    else:
        scores_xy = (log_b_y + g_y / eps)[None, :] - C_xy / eps
        return -eps * torch.logsumexp(scores_xy, dim=1)


@lazy_properties
class OTResultSample(OTResult):
    """Result of an OT problem computed from point positions."""

    def __init__(
        self,
        *,
        X_a,
        X_b,
        a,
        b,
        C,
        cost,
        reg,
        reg_type,
        unbalanced,
        unbalanced_type,
        debias,
        potentials,
        array_properties,
    ):
        super().__init__(
            a=a,
            b=b,
            potentials=potentials,
            array_properties=array_properties,
            batchsize=0,
            reg=reg,
            reg_type=reg_type,
            unbalanced=unbalanced,
            unbalanced_type=unbalanced_type,
            debias=debias,
        )
        self._X_a = X_a
        self._X_b = X_b
        self._cost = cost
        self._C_streaming = isinstance(C.xy, tuple) if C is not None else True
        self._C_dense = None if self._C_streaming else C

        ap = self._array_properties
        if ap.B == 0:
            self._shapes = {
                "a": (ap.N,),
                "b": (ap.M,),
                "C": (ap.N, ap.M),
                "B": (),
            }
        else:
            raise NotImplementedError()

    def _density(self):
        r"""Density $P_{ij} = \exp((f_i + g_j - C(x_i,y_j))/\varepsilon)$ as a
        dense array."""
        if self._C_dense is None:
            self._C_dense = CostMatrices(
                xy=cost_matrix(self._X_a, self._X_b, cost=self._cost),
                yx=None,
            )
        C = self._C_dense.xy
        f = self._potentials.f_ba
        g = self._potentials.g_ab
        eps = self._reg
        if self._reg_type != "KL":
            raise NotImplementedError(
                "Currently, we only support 'KL' as regularization for the OT problem."
            )
        assert eps > 0
        P_ij = torch.exp((f[:, None] + g[None, :] - C) / eps)
        return self.cast(P_ij, "C")

    def _lazy_density(self):
        """Density as a streaming LinearOperator: each application is one
        :func:`~geomloss_tpu_torch.ops.softmin.gibbs_apply` (kernel 4 on the
        card)."""
        f = self._potentials.f_ba
        g = self._potentials.g_ab
        eps = self._reg
        x, y = self._X_a, self._X_b

        def matmat(s):  # (M, V) -> (N, V)
            return gibbs_apply(SQ2 * x, SQ2 * y, f / eps, g / eps, s, eps, 2)

        def rmatmat(s):  # (N, V) -> (M, V)
            return gibbs_apply(SQ2 * y, SQ2 * x, g / eps, f / eps, s, eps, 2)

        return LinearOperator.from_streaming(
            matmat=matmat,
            rmatmat=rmatmat,
            input_shape=self._shapes["b"],
            output_shape=self._shapes["a"],
        )

    def _density_operator(self):
        """Density of the transport plan, as a :class:`LinearOperator`."""
        ap = self._array_properties
        if ap.N * ap.M > STREAMING_THRESHOLD:
            return self.lazy_density
        return LinearOperator.from_dense(
            self.density,
            input_shape=self._shapes["b"],
            output_shape=self._shapes["a"],
        )

    def _plan(self):
        """Transport plan, encoded as a dense array."""
        density = self.density
        P_ij = density * self._a[:, None] * self._b[None, :]
        return self.cast(P_ij, "C")

    def _lazy_plan(self):
        """Transport plan, as a streaming LinearOperator."""
        return self.lazy_density.rescale(
            input_scaling=self.cast(self._b, "b"),
            output_scaling=self.cast(self._a, "a"),
        )

    def _value_linear(self):
        r"""Linear transport cost $\langle \pi, C \rangle$ for the squared
        Euclidean cost, computed in O(N + M) memory from plan moments:
        $\sum_{ij} \pi_{ij} |x_i - y_j|^2 =
        \sum_i \mu_i |x_i|^2 + \sum_j \nu_j |y_j|^2
        - 2 \sum_i x_i \cdot (\pi y)_i$
        where $\mu, \nu$ are the plan's marginals.

        The JAX package tests ``cost is not None`` here, which holds for
        its default ``"sqeuclidean"`` too, so it always builds the dense
        plan; the port takes the moment form it documents for the squared
        Euclidean cost (the same value up to rounding), so that a
        streaming result never materializes its ``(N, M)`` plan."""
        if self._cost != "sqeuclidean":
            # Another cost: through the dense plan.
            plan = self.plan
            C = cost_matrix(self._X_a, self._X_b, cost=self._cost)
            return self.cast((plan * C).sum(), "B")
        x, y = self._X_a, self._X_b
        mu = self.marginal_a
        nu = self.marginal_b
        cross = (x * (self.plan_operator @ y)).sum()
        return self.cast(
            torch.dot(mu, (x**2).sum(-1)) + torch.dot(nu, (y**2).sum(-1)) - 2.0 * cross,
            "B",
        )

    # Barycentric mappings ===============================================================
    def _a_to_b(self):
        r"""Barycentric map: for each source point $x_i$, the plan-weighted
        average target position $\sum_j \pi_{ij} y_j / \sum_j \pi_{ij}$."""
        mass = self.density_operator @ self._b  # (N,)
        targets = self.density_operator @ (self._b[:, None] * self._X_b)  # (N, D)
        return targets / torch.clamp(mass, min=1e-30)[:, None]

    def _b_to_a(self):
        r"""Barycentric map from the target to the source points."""
        mass = self.density_operator.T @ self._a  # (M,)
        sources = self.density_operator.T @ (self._a[:, None] * self._X_a)  # (M, D)
        return sources / torch.clamp(mass, min=1e-30)[:, None]


def _geometric_shortcuts(cost, reg, blur, unbalanced, reach):
    """``(p, reg, unbalanced)`` from the ``blur`` / ``reach`` shortcuts:
    ``reg = p * blur**p`` and ``unbalanced = p * reach**p``."""
    p = 2 if cost == "sqeuclidean" else 1
    if blur is not None:
        if reg is not None:
            raise ValueError(
                "Parameters 'reg' and 'blur' are redundant. "
                "Please specify only one of them."
            )
        reg = p * (blur**p)
    if reach is not None:
        if unbalanced is not None:
            raise ValueError(
                "Parameters 'unbalanced' and 'reach' are redundant. "
                "Please specify only one of them."
            )
        unbalanced = p * (reach**p)
    return p, reg, unbalanced


def _costs(xa, xb, cost, debias, streaming):
    """The four costs of one problem: point pairs on the streaming path,
    dense matrices otherwise."""
    if streaming:
        return CostMatrices(
            xy=(xa, xb), yx=(xb, xa),
            xx=(xa, xa) if debias else None, yy=(xb, xb) if debias else None,
        )
    return CostMatrices(
        xy=cost_matrix(xa, xb, cost=cost),
        yx=cost_matrix(xb, xa, cost=cost),
        xx=cost_matrix(xa, xa, cost=cost) if debias else None,
        yy=cost_matrix(xb, xb, cost=cost) if debias else None,
    )


@convert_inputs("X_a", "X_b", "a", "b")
def solve_sample(
    X_a,
    X_b,
    a=None,
    b=None,
    cost="sqeuclidean",
    debias=False,
    reg=None,
    unbalanced=None,
    unbalanced_type="KL",
    method="auto",
    max_iter=None,
    tol=None,
    blur=None,
    reach=None,
) -> OTResultSample:
    r"""Solves an OT problem between point clouds.

    The cost is ``C(x, y) = |x - y|^2`` (``"sqeuclidean"``, no 1/p factor):
    the geometric shortcuts are ``reg = p * blur**p`` and
    ``unbalanced = p * reach**p``.

    Above 5000 x 5000 cost entries the solver switches to streaming
    softmins (kernel 1 on the card), so the cost matrix is never
    materialized, and the result's ``density_operator`` / ``lazy_plan``
    are streaming operators (kernel 4).

    Example:
        >>> import torch
        >>> from geomloss_tpu_torch import ot
        >>> sol = ot.solve_sample(X_a=torch.tensor([[0., 0.], [1., 1.]]),
        ...                       X_b=torch.tensor([[0., 1.], [1., 0.]]),
        ...                       reg=0.01, max_iter=200)
        >>> print(round(float(sol.value_linear), 3))
        1.0
    """
    p, reg, unbalanced = _geometric_shortcuts(cost, reg, blur, unbalanced, reach)

    check_regularization(
        reg=reg,
        unbalanced=unbalanced,
        unbalanced_type=unbalanced_type,
        method=method,
        tol=tol,
        max_iter=max_iter,
        allowed_methods=("auto", "multiscale"),
    )

    if len(X_a.shape) != 2:
        raise ValueError(f"Expected X_a to be a (N, D) array. Received {tuple(X_a.shape)}.")
    if len(X_b.shape) != 2:
        raise ValueError(f"Expected X_b to be a (M, D) array. Received {tuple(X_b.shape)}.")
    N, D = X_a.shape
    M, D_ = X_b.shape
    if D != D_:
        raise ValueError(
            "Expected X_a and X_b to have the same number of coordinates per sample. "
            f"Received D={D} for X_a and D={D_} for X_b."
        )

    a = check_marginal(a, ones_like=X_a[:, 0], marginal_size=N, name="a")
    b = check_marginal(b, ones_like=X_b[:, 0], marginal_size=M, name="b")

    if unbalanced is None:
        check_marginal_masses(a.sum(dim=0, keepdim=True), b.sum(dim=0, keepdim=True))

    library, dtype, device = check_library_dtype_device(X_a, X_b, a, b)
    array_properties = ArrayProperties(
        B=0, N=N, M=M, dtype=dtype, device=device, library=library
    )

    if method == "multiscale":
        return _solve_sample_multiscale(
            X_a, X_b, a, b, cost=cost, debias=debias, reg=reg,
            unbalanced=unbalanced, unbalanced_type=unbalanced_type,
            max_iter=max_iter, array_properties=array_properties,
        )

    descent = annealing_parameters(
        maxmin_cost=max_diameter(X_a, X_b) ** p,
        eps=reg,
        rho=unbalanced,
        n_iter=max_iter,
    )

    C = _costs(X_a, X_b, cost, debias, N * M > STREAMING_THRESHOLD)
    potentials = sinkhorn_loop(
        softmin=softmin_sample,
        log_a_list=[stable_log(a)],
        log_b_list=[stable_log(b)],
        C_list=[C],
        descent=descent,
        debias=debias,
        last_extrapolation=True,
    )

    return OTResultSample(
        X_a=X_a,
        X_b=X_b,
        a=a,
        b=b,
        C=C,
        cost=cost,
        reg=reg,
        reg_type="KL",
        unbalanced=unbalanced,
        unbalanced_type=unbalanced_type,
        debias=debias,
        potentials=potentials,
        array_properties=array_properties,
    )


def _cluster_measure(w, pts, block):
    """Hilbert-order labels and the pooled coarse measure (ceil(N / block)
    blocks, the last one ragged): the stable sort of the Hilbert keys gives
    the permutation of the JAX package's radix sort."""
    from ..ops.spatial import hilbert_key

    n = pts.shape[0]
    K = -(-n // block)
    perm = torch.argsort(hilbert_key(pts.float(), bits=8), stable=True)
    labels = torch.empty(n, dtype=torch.long, device=pts.device)
    labels[perm] = torch.arange(n, device=pts.device) // block
    wc = torch.zeros(K, dtype=w.dtype, device=w.device).index_add_(0, labels, w)
    cent = torch.zeros((K, pts.shape[1]), dtype=pts.dtype, device=pts.device)
    cent = cent.index_add_(0, labels, w[:, None] * pts)
    cent = cent / torch.clamp(wc, min=1e-30)[:, None]
    return wc, cent, labels


#: "Pruned" fine-cost value of the truncation (finite, so that the dense
#: logsumexp stays NaN-free).
_PRUNED_COST = 1.0e5


def _solve_sample_multiscale(
    X_a, X_b, a, b, *, cost, debias, reg, unbalanced, unbalanced_type,
    max_iter, array_properties,
):
    """Two-scale (clustered) descent through the loop's jump branch.

    Clusters are Hilbert-ordered blocks; the coarse iterations run on
    weighted centroids until the temperature resolves the cluster size,
    then ``kernel_truncation`` prunes the fine cost entries whose clusters
    fail the keep rule ``f + g > C - truncate * eps`` and ``extrapolate``
    carries the duals down (coupled extrapolation). Dense-matrix scale only
    (``SamplesLoss(backend="multiscale")`` streams large clouds).
    """
    N, D = X_a.shape
    M, _ = X_b.shape
    if N * M > STREAMING_THRESHOLD:
        raise NotImplementedError(
            "method='multiscale' on ot.solve_sample builds dense two-scale "
            "cost matrices; for larger clouds use the streaming "
            "SamplesLoss(..., backend='multiscale') solver."
        )
    if min(N, M) < 64:
        raise ValueError(
            "method='multiscale' needs at least 64 points per cloud "
            f"(received {N} x {M})."
        )

    # Cluster both clouds; force distinct coarse sizes so that the four
    # problems (xy, yx, xx, yy) are told apart by their shapes inside the
    # truncation and extrapolation callables:
    bx = max(4, 1 << max(0, (N // 64).bit_length() - 1))
    by = max(4, 1 << max(0, (M // 64).bit_length() - 1))
    while -(-N // bx) == -(-M // by):
        by *= 2
    aw_c, x_c, lab_a = _cluster_measure(a, X_a, bx)
    bw_c, y_c, lab_b = _cluster_measure(b, X_b, by)
    Kx, Ky = aw_c.shape[0], bw_c.shape[0]

    C_coarse = _costs(x_c, y_c, cost, debias, False)
    C_fine = _costs(X_a, X_b, cost, debias, False)

    # Jump temperature: the squared cluster size (squared Euclidean units).
    sigma2 = 4.0 * float(
        torch.maximum(
            ((X_a - x_c[lab_a]) ** 2).sum(-1).max(),
            ((X_b - y_c[lab_b]) ** 2).sum(-1).max(),
        ).item()
    )
    sigma2 = max(sigma2, 1.001 * reg)

    descent = annealing_parameters(
        maxmin_cost=max_diameter(X_a, X_b) ** 2,
        eps=reg,
        rho=unbalanced,
        n_iter=max_iter,
        eps_scales=[sigma2, reg],
    )

    # Keyed by the coarse costs' shapes (torch.Size hashes as a tuple):
    labels = {
        (Kx, Ky): (lab_a, lab_b),
        (Ky, Kx): (lab_b, lab_a),
        (Kx, Kx): (lab_a, lab_a),
        (Ky, Ky): (lab_b, lab_b),
    }
    rows_of = {Kx: X_a, Ky: X_b}
    cents_of = {Kx: x_c, Ky: y_c}
    mixed = {}

    def kernel_truncation(*, C, C_fine, f, eps, CT=None, CT_fine=None,
                          g=None, truncate=5.0):
        g_c = f if g is None else g
        keep = f[:, None] + g_c[None, :] > C - truncate * eps
        la, lb = labels[C.shape]
        keep_f = keep[la[:, None], lb[None, :]]
        Cf = torch.where(keep_f, C_fine, _PRUNED_COST)
        CfT = torch.where(keep_f.T, CT_fine, _PRUNED_COST) if CT_fine is not None else None
        return Cf, CfT

    def extrapolate(*, self, other, log_weights, C, C_fine, eps, dampen):
        key = (self.shape[0], log_weights.shape[0])
        if key not in mixed:
            mixed[key] = cost_matrix(rows_of[key[0]], cents_of[key[1]], cost=cost)
        return dampen(softmin_sample(eps, log_weights, mixed[key], other))

    potentials = sinkhorn_loop(
        softmin=softmin_sample,
        log_a_list=[stable_log(aw_c), stable_log(a)],
        log_b_list=[stable_log(bw_c), stable_log(b)],
        C_list=[C_coarse, C_fine],
        descent=descent,
        kernel_truncation=kernel_truncation,
        extrapolate=extrapolate,
        debias=debias,
        last_extrapolation=True,
    )

    return OTResultSample(
        X_a=X_a,
        X_b=X_b,
        a=a,
        b=b,
        C=C_fine,
        cost=cost,
        reg=reg,
        reg_type="KL",
        unbalanced=unbalanced,
        unbalanced_type=unbalanced_type,
        debias=debias,
        potentials=potentials,
        array_properties=array_properties,
    )


@convert_inputs("X_a", "X_b", "a", "b")
def solve_sample_batch(
    X_a,
    X_b,
    a=None,
    b=None,
    cost="sqeuclidean",
    debias=False,
    reg=None,
    unbalanced=None,
    unbalanced_type="KL",
    method="auto",
    max_iter=None,
    tol=None,
    blur=None,
    reach=None,
):
    r"""Batched :func:`solve_sample`: B point-cloud OT problems.

    The problems are solved one after the other, with one annealing
    schedule computed from the global diameter.

    Args:
        X_a: ``(B, N, D)``; X_b: ``(B, M, D)``;
        a: ``(B, N)``; b: ``(B, M)`` (default: uniform).

    Returns:
        list of B :class:`OTResultSample` objects (one per problem, with
        all lazy attributes available).
    """
    p, reg, unbalanced = _geometric_shortcuts(cost, reg, blur, unbalanced, reach)

    check_regularization(
        reg=reg,
        unbalanced=unbalanced,
        unbalanced_type=unbalanced_type,
        method=method,
        tol=tol,
        max_iter=max_iter,
    )

    if len(X_a.shape) != 3 or len(X_b.shape) != 3:
        raise ValueError(
            "Expected X_a, X_b to be (B, N, D) / (B, M, D) arrays. "
            f"Received {tuple(X_a.shape)} and {tuple(X_b.shape)}."
        )
    B, N, D = X_a.shape
    B2, M, D2 = X_b.shape
    if B != B2 or D != D2:
        raise ValueError(
            "X_a and X_b should share the batch size and feature dimension; "
            f"received {tuple(X_a.shape)} and {tuple(X_b.shape)}."
        )

    a = check_marginal(a, ones_like=X_a[:, :, 0], marginal_size=N, name="a")
    b = check_marginal(b, ones_like=X_b[:, :, 0], marginal_size=M, name="b")
    if unbalanced is None:
        check_marginal_masses(a.sum(dim=1), b.sum(dim=1))

    library, dtype, device = check_library_dtype_device(X_a, X_b, a, b)

    # One shared schedule from the global diameter:
    diam = max_diameter(X_a.reshape(-1, D), X_b.reshape(-1, D))
    descent = annealing_parameters(
        maxmin_cost=diam**p,
        eps=reg,
        rho=unbalanced,
        n_iter=max_iter,
    )

    use_streaming = N * M > STREAMING_THRESHOLD
    array_properties = ArrayProperties(
        B=0, N=N, M=M, dtype=dtype, device=device, library=library
    )
    results = []
    for k in range(B):
        C_k = _costs(X_a[k], X_b[k], cost, debias, use_streaming)
        pots_k = sinkhorn_loop(
            softmin=softmin_sample,
            log_a_list=[stable_log(a[k])],
            log_b_list=[stable_log(b[k])],
            C_list=[C_k],
            descent=descent,
            debias=debias,
            last_extrapolation=True,
        )
        results.append(
            OTResultSample(
                X_a=X_a[k],
                X_b=X_b[k],
                a=a[k],
                b=b[k],
                C=C_k,
                cost=cost,
                reg=reg,
                reg_type="KL",
                unbalanced=unbalanced,
                unbalanced_type=unbalanced_type,
                debias=debias,
                potentials=pots_k,
                array_properties=array_properties,
            )
        )
    return results


@convert_inputs("xa", "a", "weights", "init")
def barycenter_sample(
    xa,
    a=None,
    weights=None,
    *,
    blur=0.01,
    p=2,
    n_iter=8,
    scaling=0.5,
    diameter=None,
    init=None,
    step_size=1.0,
):
    r"""Free-support Wasserstein barycenter of K point clouds.

    Minimizes ``sum_k weights[k] * S_blur(bar, alpha_k)`` (debiased
    Sinkhorn divergences) over the *positions* of a uniform ``M``-point
    barycenter, with the mass-preconditioned fixed-point update

    .. math:: z \leftarrow z - \frac{1}{m}\nabla_z
              \sum_k w_k S_\varepsilon(\mathrm{unif}(z), \alpha_k)
            = \sum_k w_k T_k(z) - (T_{\mathrm{self}}(z) - z),

    where ``T_k`` is the debiased barycentric map onto measure ``k``. Each
    update runs :class:`~geomloss_tpu_torch.SamplesLoss` (``backend=
    "auto"``) on every measure and differentiates it with
    ``torch.autograd.grad``.

    Args:
        xa: ``(N, D)``, ``(K, N, D)`` or ``(B, K, N, D)`` point clouds.
        a: per-point masses, matching leading shape ``(..., N)``
            (default uniform; the barycenter support is always uniform).
        weights: ``(K,)`` or ``(B, K)`` barycentric weights
            (default uniform ``1/K``).
        blur: target blur scale of the debiased divergences.
        p: cost exponent (2 recommended; 1 runs a subgradient flow).
        n_iter: number of fixed-point updates.
        scaling: epsilon-annealing rate of each inner solve.
        diameter: optional bound on the point-cloud diameter (read from
            the clouds by default).
        init: optional ``(M, D)`` / ``(B, M, D)`` initial support
            (default: the index-wise ``weights``-mix of the input clouds).
        step_size: scale of the preconditioned update (1 = full step).

    Returns:
        :class:`BarycenterResult` with uniform ``masses`` ``(M,)`` or
        ``(B, M)`` and ``samples`` ``(M, D)`` or ``(B, M, D)``.
    """
    from ..models.samples_loss import SamplesLoss

    xa = torch.as_tensor(xa)
    if xa.ndim == 2:
        xa = xa[None, None]
        batched = False
    elif xa.ndim == 3:
        xa = xa[None]
        batched = False
    elif xa.ndim == 4:
        batched = True
    else:
        raise ValueError(
            "barycenter_sample expects (N, D), (K, N, D) or (B, K, N, D) "
            f"point clouds; received shape {tuple(xa.shape)}."
        )
    B, K, N, D = xa.shape
    like = dict(dtype=xa.dtype, device=xa.device)

    if a is None:
        a = torch.full((B, K, N), 1.0 / N, **like)
    else:
        a = torch.as_tensor(a, **like).reshape(B, K, N)
        a = a / a.sum(dim=-1, keepdim=True)
    if weights is None:
        weights = torch.full((B, K), 1.0 / K, **like)
    else:
        weights = torch.as_tensor(weights, **like)
        weights = weights.reshape(-1, K).expand(B, K)
        weights = weights / weights.sum(dim=1, keepdim=True)

    if init is None:
        # Index-wise mix: exact for degenerate weights, a reasonable seed
        # otherwise (the fixed point washes out the pairing).
        z = torch.einsum("bk,bknd->bnd", weights, xa)
    else:
        z = torch.as_tensor(init, **like)
        if z.ndim == 2:
            z = z[None].expand((B,) + tuple(z.shape))
    M = z.shape[1]
    m = torch.full((B, M), 1.0 / M, **like)

    if diameter is None:
        pts = xa.reshape(B * K * N, D)
        diameter = max_diameter(pts, pts)

    loss = SamplesLoss(
        "sinkhorn", p=p, blur=blur, scaling=scaling, diameter=diameter,
        debias=True, backend="auto",
    )

    for _ in range(n_iter):
        steps = []
        for zb, mb, ab, xab, wb in zip(z, m, a, xa, weights):
            zb = zb.detach().requires_grad_(True)
            tot = torch.zeros((), **like)
            for wk, ak, xk in zip(wb, ab, xab):
                tot = tot + wk * loss(mb, zb, ak, xk)
            (grad,) = torch.autograd.grad(tot, zb)
            steps.append(zb.detach() - step_size * grad / mb[:, None])
        z = torch.stack(steps)

    masses, samples = m, z
    if not batched:
        masses, samples = masses[0], samples[0]
    return BarycenterResult(masses=masses, samples=samples, reg=p * blur**p)
