"""The port's ``ot`` utilities against the JAX package's.

Validation (every ``ValueError`` / ``NotImplementedError``, same type and
message), the lazy result properties, profiling, the ``ot`` annealing
schedule, ``sinkhorn_cost`` in its four cases (1e-12, float64), the
loop's ``_detach`` (a ``CostMatrices`` stays one, and ``SamplesLoss``
gives bitwise the same floats as with the plain-tuple form it replaces),
and the input conversion, which never runs on the CPU unless the caller's
tensors lie there.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomloss_tpu.solvers import annealing as jax_annealing
from geomloss_tpu.solvers import unbalanced as jax_unbalanced
from geomloss_tpu.utils import cache as jax_cache
from geomloss_tpu.utils import typing as jax_typing
from geomloss_tpu.utils import validation as jax_validation
from geomloss_tpu import ot as jax_ot
from geomloss_tpu_torch import SamplesLoss, ot
from geomloss_tpu_torch.solvers import annealing, unbalanced
from geomloss_tpu_torch.utils import cache, profiling, validation
from geomloss_tpu_torch.utils.typing import CostMatrices, SinkhornPotentials
from torch_jax_parity import close

# The module (the package's ``sinkhorn_loop`` attribute is the function):
sinkhorn_loop = importlib.import_module("geomloss_tpu_torch.solvers.sinkhorn_loop")


def raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares what was raised
        return type(e), str(e)
    raise AssertionError("no exception raised")


def same_error(jax_fn, torch_fn):
    """Both calls raise the same exception type with the same message."""
    j, t = raised(jax_fn), raised(torch_fn)
    assert j[0] in (ValueError, NotImplementedError), j
    assert t == j, (t, j)


REG_CASES = [
    dict(reg=-1.0),
    dict(reg=0.0),
    dict(unbalanced=0.0),
    dict(unbalanced=-2.0),
    dict(unbalanced_type="TV"),
    dict(method="multiscale"),
    dict(max_iter=None),
    dict(tol=1e-3),
]


@pytest.mark.parametrize("case", REG_CASES)
def test_check_regularization_errors(case):
    kw = dict(reg=0.1, unbalanced=None, unbalanced_type="KL", method="auto", tol=None, max_iter=10)
    kw.update(case)
    same_error(lambda: jax_validation.check_regularization(**kw),
               lambda: validation.check_regularization(**kw))
    # The accepted methods of a front end:
    validation.check_regularization(**{**kw, **dict(reg=0.1, unbalanced=None, unbalanced_type="KL", tol=None,
                                                    max_iter=10, method="multiscale")},
                                    allowed_methods=("auto", "multiscale"))


def test_check_marginal_errors():
    like_j, like_t = jnp.ones(3), torch.ones(3, dtype=torch.float64)
    same_error(lambda: jax_validation.check_marginal(jnp.ones(4), ones_like=like_j, marginal_size=3, name="a"),
               lambda: validation.check_marginal(torch.ones(4), ones_like=like_t, marginal_size=3, name="a"))
    neg = np.array([0.5, -0.1, 0.6])
    same_error(lambda: jax_validation.check_marginal(jnp.asarray(neg), ones_like=like_j, marginal_size=3, name="b"),
               lambda: validation.check_marginal(torch.tensor(neg), ones_like=like_t, marginal_size=3, name="b"))
    m = validation.check_marginal(None, ones_like=like_t, marginal_size=3, name="a")
    assert m.dtype == torch.float64 and torch.allclose(m, torch.full((3,), 1 / 3, dtype=torch.float64))


@pytest.mark.parametrize("rows", [1, 3])
def test_check_marginal_masses_errors(rows):
    sa, sb = np.ones(rows), np.linspace(1.5, 2.0, rows)
    same_error(lambda: jax_validation.check_marginal_masses(jnp.asarray(sa), jnp.asarray(sb)),
               lambda: validation.check_marginal_masses(torch.tensor(sa), torch.tensor(sb)))
    validation.check_marginal_masses(torch.tensor(sa), torch.tensor(sa * (1 + 1e-4)))


def test_check_dtype_and_device_errors():
    """The same type and message text up to the names of dtypes and
    devices, which are each library's own."""
    j = raised(lambda: jax_validation.check_dtype(jnp.ones(2, jnp.float32), jnp.ones(2, jnp.float64)))
    t = raised(lambda: validation.check_dtype(torch.ones(2), torch.ones(2, dtype=torch.float64)))
    assert t[0] is j[0] is ValueError
    head = "The input arrays do not have the same numerical dtype: received a collection of "
    assert t[1].startswith(head) and j[1].startswith(head)
    tail = "which is ambiguous. To fix this error, please cast all arrays to the same numerical dtype."
    assert t[1].endswith(tail) and j[1].endswith(tail)

    t = raised(lambda: validation.check_library_dtype_device(torch.ones(2), torch.ones(2, device="meta")))
    assert t[0] is ValueError
    assert t[1].startswith("The input arrays are not stored on the same device: received a collection of ")
    assert validation.check_library_dtype_device(torch.ones(2), torch.ones(3)) == ("torch", torch.float32, "cpu")
    assert jax_validation.check_library_dtype_device(jnp.ones(2))[0] == "jax"


FRONT_END_CASES = {
    "solve 3d cost": lambda o, x: o.solve(x(np.ones((2, 3, 4))), reg=0.1, max_iter=5),
    "solve_batch 2d cost": lambda o, x: o.solve_batch(x(np.ones((3, 4))), reg=0.1, max_iter=5),
    "solve unbalanced masses": lambda o, x: o.solve(x(np.ones((3, 4))), a=x(np.ones(3)), reg=0.1, max_iter=5),
    "solve no max_iter": lambda o, x: o.solve(x(np.ones((3, 4))), reg=0.1),
    "solve_sample reg and blur": lambda o, x: o.solve_sample(x(np.ones((3, 2))), x(np.ones((4, 2))), reg=0.1,
                                                             blur=0.1, max_iter=5),
    "solve_sample unbalanced and reach": lambda o, x: o.solve_sample(x(np.ones((3, 2))), x(np.ones((4, 2))),
                                                                     reg=0.1, unbalanced=1.0, reach=1.0,
                                                                     max_iter=5),
    "solve_sample 3d X_a": lambda o, x: o.solve_sample(x(np.ones((2, 3, 2))), x(np.ones((4, 2))), reg=0.1,
                                                       max_iter=5),
    "solve_sample 1d X_b": lambda o, x: o.solve_sample(x(np.ones((3, 2))), x(np.ones(4)), reg=0.1, max_iter=5),
    "solve_sample D mismatch": lambda o, x: o.solve_sample(x(np.ones((3, 2))), x(np.ones((4, 3))), reg=0.1,
                                                           max_iter=5),
    "solve_sample negative b": lambda o, x: o.solve_sample(x(np.ones((3, 2))), x(np.ones((4, 2))),
                                                           b=x(-np.ones(4)), reg=0.1, max_iter=5),
    "solve_sample method": lambda o, x: o.solve_sample(x(np.ones((3, 2))), x(np.ones((4, 2))), reg=0.1,
                                                       max_iter=5, method="sparse"),
    "solve_sample multiscale small": lambda o, x: o.solve_sample(x(np.random.RandomState(0).rand(16, 2)),
                                                                 x(np.random.RandomState(1).rand(20, 2)),
                                                                 reg=0.1, max_iter=5, method="multiscale"),
    "solve_sample_batch shapes": lambda o, x: o.solve_sample_batch(x(np.ones((3, 2))), x(np.ones((4, 2))),
                                                                   reg=0.1, max_iter=5),
    "solve_sample_batch batch mismatch": lambda o, x: o.solve_sample_batch(x(np.ones((2, 3, 2))),
                                                                           x(np.ones((3, 4, 2))), reg=0.1,
                                                                           max_iter=5),
    "solve_sample_batch multiscale": lambda o, x: o.solve_sample_batch(x(np.ones((2, 3, 2))),
                                                                       x(np.ones((2, 4, 2))), reg=0.1,
                                                                       max_iter=5, method="multiscale"),
    "barycenter 5d cost": lambda o, x: o.barycenter(x(np.ones((1, 1, 2, 3, 4))), reg=0.1, max_iter=5),
    "barycenter a shape": lambda o, x: o.barycenter(x(np.ones((2, 3, 4))), a=x(np.ones((3, 3))), reg=0.1,
                                                    max_iter=5),
    "barycenter cost_bar shape": lambda o, x: o.barycenter(x(np.ones((2, 3, 4))), cost_bar=x(np.ones((3, 3))),
                                                           reg=0.1, max_iter=5),
    "barycenter reg": lambda o, x: o.barycenter(x(np.ones((2, 3, 4))), reg=0.0, max_iter=5),
    "barycenter_sample 1d": lambda o, x: o.barycenter_sample(x(np.ones(4))),
    "solve_grid no b": lambda o, x: o.solve_grid(x(np.ones((1, 4, 4)))),
    "solve_grid p": lambda o, x: o.solve_grid(x(np.ones((1, 4, 4))), x(np.ones((1, 4, 4))), cost="other", p=3),
    "solve_grid reg and blur": lambda o, x: o.solve_grid(x(np.ones((1, 4, 4))), x(np.ones((1, 4, 4))), reg=0.1,
                                                         blur=0.1),
    "solve_grid unbalanced and reach": lambda o, x: o.solve_grid(x(np.ones((1, 4, 4))), x(np.ones((1, 4, 4))),
                                                                 unbalanced=0.1, reach=0.1),
    "solve_grid 4d grid": lambda o, x: o.solve_grid(x(np.ones((1, 2, 2, 2, 2))), x(np.ones((1, 2, 2, 2, 2)))),
    "solve_grid shapes": lambda o, x: o.solve_grid(x(np.ones((1, 4, 4))), x(np.ones((1, 4, 8)))),
    "solve_grid axes": lambda o, x: o.solve_grid(x(np.ones((1, 4, 4))), x(np.ones((1, 4, 4))), axes=[(0, 1)]),
    "solve_grid periodic flags": lambda o, x: o.solve_grid(x(np.ones((1, 4, 4))), x(np.ones((1, 4, 4))),
                                                           periodic=(True,)),
    "solve_grid periodic coords": lambda o, x: o.solve_grid(x(np.ones((1, 4))), x(np.ones((1, 4))),
                                                            axes=[np.arange(4.0)], periodic=True),
    "solve_grid coords shape": lambda o, x: o.solve_grid(x(np.ones((1, 4))), x(np.ones((1, 4))),
                                                         axes=[np.arange(5.0)]),
    "solve_grid scaling": lambda o, x: o.solve_grid(x(np.ones((1, 4))), x(np.ones((1, 4))), axes=(0.0, 1.0),
                                                    scaling=0.3),
    "barycenter_grid no a": lambda o, x: o.barycenter_grid(),
    "barycenter_grid 2d": lambda o, x: o.barycenter_grid(x(np.ones((2, 4)))),
}


@pytest.mark.parametrize("name", sorted(FRONT_END_CASES))
def test_front_end_errors_match_jax(name):
    """Each front end rejects the same bad calls with the same message."""
    call = FRONT_END_CASES[name]
    same_error(lambda: call(jax_ot, jnp.asarray), lambda: call(ot, torch.tensor))


def test_convert_inputs_device_and_dtype():
    """Lists and numpy arrays become tensors of the default dtype on the
    device of the call's tensor arguments."""
    @validation.convert_inputs("u", "v")
    def f(u, v, w=None):
        return u, v

    u, v = f([1.0, 2.0], np.ones(3, dtype=np.float64), w=torch.zeros(1))
    assert u.dtype == v.dtype == torch.get_default_dtype()
    assert u.device == v.device == torch.device("cpu")
    t = torch.ones(2, dtype=torch.float64)
    assert f(t, [1.0])[0] is t


def test_lists_alone_never_run_on_the_cpu():
    """With no tensor argument, lists go to the card: without one the call
    raises instead of solving on the CPU."""
    call = lambda: ot.solve_sample([[0.0, 0.0], [1.0, 1.0]], [[0.0, 1.0], [1.0, 0.0]],  # noqa: E731
                                   reg=0.01, max_iter=5)
    if torch.cuda.is_available():
        assert call().potential_a.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call()


def test_lazy_properties_cache_and_clear():
    @cache.lazy_properties
    class R:
        _cached_properties = ("value",)

        def __init__(self):
            self.calls = 0
            self._value = "raw input"  # must not shadow the compute method

        def _value(self):
            """The value."""
            self.calls += 1
            return self.calls

    r = R()
    assert r.value == 1 and r.value == 1 and r.calls == 1
    r.cache_clear()
    assert r.value == 2
    assert R.value.fget.__doc__ == "The value."
    assert cache.add_cached_methods_to_sphinx is cache.lazy_properties
    assert jax_cache.add_cached_methods_to_sphinx is jax_cache.lazy_properties


def test_result_attributes_are_cached():
    x = torch.tensor(np.random.RandomState(0).rand(6, 2))
    res = ot.solve_sample(x, x + 0.1, reg=0.1, max_iter=5)
    assert res.value is res.value
    v = res.value
    res.cache_clear()
    assert res.value is not v and torch.equal(res.value, v)


def test_profiling_trace_and_timer(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir), create_perfetto_link=True):
        torch.logsumexp(torch.rand(64, 64), dim=1)
    path = os.path.join(log_dir, "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("logsumexp" in e.get("name", "") for e in events)

    t = profiling.Timer().start()
    out = {"a": (torch.ones(3), [torch.zeros(2)])}
    elapsed = t.stop(out)
    assert elapsed == t.elapsed and elapsed >= 0
    assert profiling.Timer().start().stop() >= 0


ANNEALING_CASES = [
    dict(maxmin_cost=4.0, eps=1e-3, n_iter=1),
    dict(maxmin_cost=4.0, eps=1e-3, n_iter=7),
    dict(maxmin_cost=4.0, eps=1e-3, n_iter=7, scaling=1),
    dict(maxmin_cost=4.0, eps=1e-3, n_iter=12, scaling=0.5),
    dict(maxmin_cost=4.0, eps=1e-3, scaling=0.7),
    dict(maxmin_cost=1e-4, eps=1e-3, n_iter=4),
    dict(maxmin_cost=2.0, eps=1e-2, rho=0.5, n_iter=9, eps_scales=[0.3, 1e-2]),
    dict(maxmin_cost=2.0, eps=1e-2, n_iter=9, eps_scales=[0.05, 0.02, 1e-2]),
    dict(maxmin_cost=2.0, eps=1e-2, scaling=0.6, eps_scales=[0.3]),
    dict(maxmin_cost=2.0, eps=1e-2, n_iter=3, eps_scales=[1e-5, 1e-2]),
]


@pytest.mark.parametrize("case", ANNEALING_CASES)
def test_annealing_parameters_match_jax(case):
    got = annealing.annealing_parameters(**case)
    ref = jax_annealing.annealing_parameters(**case)
    assert got.eps_list == ref.eps_list
    assert got.scale_list == ref.scale_list
    assert got.rho_list == ref.rho_list


@pytest.mark.parametrize("case", [dict(n_iter=0), dict(n_iter=3, scaling=1.5), dict(n_iter=3, scaling=0.0),
                                  dict(), dict(scaling=1)])
def test_annealing_parameters_errors(case):
    kw = dict(maxmin_cost=1.0, eps=0.1, **case)
    same_error(lambda: jax_annealing.annealing_parameters(**kw), lambda: annealing.annealing_parameters(**kw))


@pytest.mark.parametrize("batchsize", [0, 3])
@pytest.mark.parametrize("rho", [None, 0.7])
@pytest.mark.parametrize("debias", [True, False])
def test_sinkhorn_cost_matches_jax(batchsize, rho, debias):
    rng = np.random.RandomState(batchsize + 5 * debias)
    sa, sb = ((batchsize, 7), (batchsize, 5)) if batchsize else ((7,), (5,))
    a, b = rng.rand(*sa), rng.rand(*sb)
    f_ba, g_ab, f_aa, g_bb = rng.randn(*sa), rng.randn(*sb), rng.randn(*sa), rng.randn(*sb)
    pots = (f_aa if debias else None, g_bb if debias else None, g_ab, f_ba)

    def run(lib, typing, conv):
        P = typing.SinkhornPotentials(*(None if v is None else conv(v) for v in pots))
        return lib.sinkhorn_cost(a=conv(a), b=conv(b), batchsize=batchsize, potentials=P, eps=0.3, rho=rho,
                                 debias=debias)

    got = run(unbalanced, importlib.import_module("geomloss_tpu_torch.utils.typing"), torch.tensor)
    ref = run(jax_unbalanced, jax_typing, jnp.asarray)
    close(got, ref, 1e-12)


def test_dampening_and_dot_products_match_jax():
    f = np.random.RandomState(0).randn(4, 3)
    for rho in (None, 0.5):
        close(unbalanced.dampening(eps=0.1, rho=rho)(torch.tensor(f)),
              jax_unbalanced.dampening(eps=0.1, rho=rho)(jnp.asarray(f)), 1e-15)
    close(unbalanced.dot_products(torch.tensor(f), torch.tensor(f + 1)),
          jax_unbalanced.dot_products(jnp.asarray(f), jnp.asarray(f + 1)), 1e-15)


def test_detach_keeps_named_tuples():
    x = torch.ones(3, requires_grad=True)
    C = CostMatrices(xy=(x, 2 * x), yx=x * 3)
    d = sinkhorn_loop._detach(C)
    assert type(d) is CostMatrices and d.xx is None and d.yy is None
    assert isinstance(d.xy, tuple) and type(d.xy) is tuple
    assert not any(t.requires_grad for t in (*d.xy, d.yx))
    assert torch.equal(d.xy[1], 2 * x.detach())
    P = SinkhornPotentials(f_aa=None, g_bb=None, g_ab=x, f_ba=x)
    assert type(sinkhorn_loop._detach(P)) is SinkhornPotentials
    assert sinkhorn_loop._detach(None) is None and sinkhorn_loop._detach(2) == 2


def _plain_tuple_detach(C):
    """The form ``_detach`` had before it kept NamedTuples."""
    if isinstance(C, torch.Tensor):
        return C.detach()
    if isinstance(C, tuple):
        return tuple(_plain_tuple_detach(c) for c in C)
    return C


@pytest.mark.parametrize("route", ["tensorized", "online", "grid"])
def test_detach_repair_changes_no_float(route, monkeypatch):
    """SamplesLoss and the grid divergence (the callers of the loop) give
    bitwise the same value and gradient with the repaired ``_detach`` as
    with the plain-tuple form."""
    from geomloss_tpu_torch import sinkhorn_divergence

    rng = np.random.RandomState(3)
    if route == "grid":
        x, y = torch.tensor(rng.rand(2, 16, 16)), torch.tensor(rng.rand(2, 16, 16))
        fn = lambda x: sinkhorn_divergence(x, y, blur=0.1).sum()  # noqa: E731
    else:
        x, y = torch.tensor(rng.rand(300, 3)), torch.tensor(rng.rand(280, 3))
        fn = lambda x: SamplesLoss("sinkhorn", blur=0.05, backend=route)(x, y)  # noqa: E731

    def run():
        xx = x.clone().requires_grad_(True)
        v = fn(xx)
        return v.detach(), torch.autograd.grad(v, xx)[0]

    new = run()
    monkeypatch.setattr(sinkhorn_loop, "_detach", _plain_tuple_detach)
    old = run()
    assert all(torch.equal(a, b) for a, b in zip(new, old))
