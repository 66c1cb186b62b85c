r"""``OTResult`` and ``LinearOperator``: the result API of ``ot.solve*``.

Counterpart of :mod:`geomloss_tpu.ot.result`. Everything expensive (plan,
value, marginals...) is a lazily computed, cached property. The "lazy"
transport plans are :class:`LinearOperator` objects backed by the
streaming Gibbs kernel (:func:`geomloss_tpu_torch.ops.softmin.gibbs_apply`,
kernel 4 on the card), so plans of 1e10 entries and more are applied to
vectors without ever being materialized.
"""

import math

from ..solvers.unbalanced import sinkhorn_cost
from ..utils.cache import lazy_properties

__all__ = ["LinearOperator", "OTResult"]


class LinearOperator:
    r"""Matrix-free linear map ``y = diag(l) K diag(r) x``.

    The raw kernel ``K`` (a pair of forward / adjoint apply functions) is
    kept apart from the diagonal scalings ``l`` / ``r``, which are stored
    as data: rescaling composes by elementwise multiplication, and
    transposition swaps fields.

    Supports ``op @ x`` (with trailing channel dimensions broadcast),
    ``op.T`` / ``op.transpose()`` and a SciPy-style 2D ``shape``.
    """

    __slots__ = ("_fwd", "_adj", "_in_shape", "_out_shape", "_l", "_r")

    def __init__(self, fwd, adj, in_shape, out_shape, l=None, r=None):
        self._fwd = fwd  # (in_shape + (k,)) -> (out_shape + (k,))
        self._adj = adj  # (out_shape + (k,)) -> (in_shape + (k,))
        self._in_shape = tuple(in_shape)
        self._out_shape = tuple(out_shape)
        self._l = l  # optional diag over out_shape
        self._r = r  # optional diag over in_shape

    # -- application -------------------------------------------------------
    def __matmul__(self, x):
        nd = len(self._in_shape)
        if tuple(x.shape[:nd]) != self._in_shape:
            raise ValueError(
                f"This operator maps arrays of shape {self._in_shape} "
                f"(plus optional trailing channel axes) to arrays of shape "
                f"{self._out_shape}; it cannot be applied to an array of "
                f"shape {tuple(x.shape)}."
            )
        trailing = tuple(x.shape[nd:])
        v = x.reshape(self._in_shape + (-1,))
        if self._r is not None:
            v = self._r[..., None] * v
        y = self._fwd(v)
        if self._l is not None:
            y = self._l[..., None] * y
        return y.reshape(self._out_shape + trailing)

    # -- structure ---------------------------------------------------------
    @property
    def shape(self):
        """SciPy-compatible flattened (rows, cols)."""
        return (math.prod(self._out_shape), math.prod(self._in_shape))

    def transpose(self):
        """The adjoint operator (kernel and scalings swap sides)."""
        return LinearOperator(
            self._adj, self._fwd, self._out_shape, self._in_shape,
            l=self._r, r=self._l,
        )

    @property
    def T(self):
        """Alias for :meth:`transpose`."""
        return self.transpose()

    def rescale(self, *, input_scaling, output_scaling):
        """``diag(output_scaling) @ self @ diag(input_scaling)``, composed
        with the existing scalings by elementwise multiplication."""
        if tuple(output_scaling.shape) != self._out_shape:
            raise ValueError(
                f"output_scaling must have shape {self._out_shape}, "
                f"got {tuple(output_scaling.shape)}."
            )
        if tuple(input_scaling.shape) != self._in_shape:
            raise ValueError(
                f"input_scaling must have shape {self._in_shape}, "
                f"got {tuple(input_scaling.shape)}."
            )
        l = output_scaling if self._l is None else self._l * output_scaling
        r = input_scaling if self._r is None else self._r * input_scaling
        return LinearOperator(
            self._fwd, self._adj, self._in_shape, self._out_shape, l=l, r=r
        )

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_dense(cls, matrix, *, input_shape, output_shape):
        """Wrap a dense ``(N, M)`` or batched ``(B, N, M)`` matrix."""
        if matrix.ndim not in (2, 3):
            raise ValueError(
                f"from_dense expects an (N, M) or (B, N, M) array, "
                f"got shape {tuple(matrix.shape)}."
            )
        mT = matrix.transpose(-1, -2)
        return cls(
            lambda v: matrix @ v,
            lambda v: mT @ v,
            input_shape,
            output_shape,
        )

    @classmethod
    def from_streaming(cls, *, matmat, rmatmat, input_shape, output_shape):
        """Wrap a pair of streaming (never materialized) kernels."""
        return cls(matmat, rmatmat, input_shape, output_shape)


@lazy_properties
class OTResult:
    """Abstract base class for optimal transport results.

    Solvers return subclasses (``OTResultMatrix``, ``OTResultSample``...)
    whose attributes (``plan``, ``value``, ``marginal_a``...) are computed
    lazily and cached.
    """

    def __init__(
        self,
        *,
        a,
        b,
        potentials,
        array_properties,
        batchsize,
        reg,
        reg_type,
        unbalanced,
        unbalanced_type,
        debias,
        C=None,
        value=None,
        value_linear=None,
        plan=None,
        log=None,
        backend=None,
        sparse_plan=None,
        lazy_plan=None,
    ):
        self._a = a
        self._b = b
        self._C = C
        self._potentials = potentials
        self._array_properties = array_properties
        self._batchsize = batchsize

        self._reg = reg
        self._reg_type = reg_type
        self._unbalanced = unbalanced
        self._unbalanced_type = unbalanced_type
        self._debias = debias

        self._value = value
        self._value_linear = value_linear
        self._plan = plan
        self._log = log
        self._sparse_plan = sparse_plan
        self._lazy_plan = lazy_plan
        self._backend = backend

    _cached_properties = (
        "potential_a",
        "potential_b",
        "potential_aa",
        "potential_bb",
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
        "a_to_b",
        "b_to_a",
        "citation",
    )

    def cast(self, x, shape):
        return x.to(self._array_properties.dtype).reshape(self._shapes[shape])

    # Dual potentials ====================================================================
    def _potential_a(self):
        r"""First dual potential $f$, associated to the source measure $\alpha$."""
        return self.cast(self._potentials.f_ba, "a")

    def _potential_b(self):
        r"""Second dual potential $g$, associated to the target measure $\beta$."""
        return self.cast(self._potentials.g_ab, "b")

    def _potential_aa(self):
        r"""Dual potential of the self-interaction of the source measure $\alpha$."""
        if self._potentials.f_aa is None:
            raise ValueError(
                "The self-interaction potential `f_aa` is not defined. "
                "To fix this issue, run your OT solver with `debias = True`."
            )
        return self.cast(self._potentials.f_aa, "a")

    def _potential_bb(self):
        r"""Dual potential of the self-interaction of the target measure $\beta$."""
        if self._potentials.g_bb is None:
            raise ValueError(
                "The self-interaction potential `g_bb` is not defined. "
                "To fix this issue, run your OT solver with `debias = True`."
            )
        return self.cast(self._potentials.g_bb, "b")

    # Transport plan =====================================================================
    def _density(self):
        """Density of the transport plan w.r.t. the reference measure (dense)."""
        return None

    def _lazy_density(self):
        """Density of the transport plan, as a streaming LinearOperator."""
        return None

    def _density_operator(self):
        """Density of the transport plan, encoded as a linear operator."""
        return None

    def _plan(self):
        """Transport plan, encoded as a dense array."""
        return None

    def _lazy_plan(self):
        """Transport plan, as a streaming (never materialized) LinearOperator."""
        return None

    def _plan_operator(self):
        """Transport plan, encoded as a linear operator."""
        a = self.cast(self._a, "a")
        b = self.cast(self._b, "b")
        return self.density_operator.rescale(input_scaling=b, output_scaling=a)

    # Loss values ========================================================================
    def _value(self):
        """Full transport cost, including possible regularization terms."""
        if self._reg_type != "KL":
            raise NotImplementedError(
                "Currently, we only support 'KL' as regularization for the OT problem."
            )
        if self._unbalanced_type != "KL":
            raise NotImplementedError(
                "Currently, we only support 'KL' as regularization "
                "for the marginal constraints."
            )
        values = sinkhorn_cost(
            a=self._a,
            b=self._b,
            potentials=self._potentials,
            eps=self._reg,
            rho=self._unbalanced,
            debias=self._debias,
            batchsize=self._batchsize,
        )
        return self.cast(values, "B")

    def _value_linear(self):
        r"""Linear part of the transport cost, $\langle \pi, C \rangle$,
        without regularization or marginal-penalty terms. Computed from the
        plan operator, so streaming results never materialize the plan."""
        if self._C is not None:
            plan = self.plan
            C = self.cast(self._C, "C")
            return self.cast((plan * C).sum(dim=(-2, -1)), "B")
        return None

    # Marginal constraints ===============================================================
    def _marginal_a(self):
        r"""First marginal of the transport plan, with the shape of `a`."""
        a = self.cast(self._a, "a")
        b = self.cast(self._b, "b")
        density = self.density_operator @ b
        assert density.shape == a.shape
        return self.cast(a * density, "a")

    def _marginal_b(self):
        r"""Second marginal of the transport plan, with the shape of `b`."""
        a = self.cast(self._a, "a")
        b = self.cast(self._b, "b")
        density = self.density_operator.T @ a
        assert density.shape == b.shape
        return self.cast(b * density, "b")

    # Barycentric mappings ===============================================================
    def _a_to_b(self):
        """Displacement vectors from the first to the second measure."""
        return None

    def _b_to_a(self):
        """Displacement vectors from the second to the first measure."""
        return None

    # Miscellaneous ======================================================================
    def _citation(self):
        r"""Appropriate citation(s) for this result."""
        return r"""GeomLoss library:

            "Interpolating between optimal transport and MMD using Sinkhorn divergences."
            In The 22nd International Conference on Artificial Intelligence and Statistics, pp. 2681-2690. PMLR, 2019.
            Feydy, Jean, Thibault Séjourné, François-Xavier Vialard, Shun-ichi Amari, Alain Trouvé, and Gabriel Peyré.

            @inproceedings{feydy2019interpolating,
                title={Interpolating between Optimal Transport and MMD using Sinkhorn Divergences},
                author={Feydy, Jean and S{\'e}journ{\'e}, Thibault and Vialard, Fran{\c{c}}ois-Xavier and Amari, Shun-ichi and Trouve, Alain and Peyr{\'e}, Gabriel},
                booktitle={The 22nd International Conference on Artificial Intelligence and Statistics},
                pages={2681--2690},
                year={2019}
            }
        """
