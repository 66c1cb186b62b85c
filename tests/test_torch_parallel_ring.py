"""The port's ring Sinkhorn and ring MMD against the JAX package's.

``geomloss_tpu_torch.parallel.sinkhorn_ring`` and ``kernel_ring`` run on
R in {2, 3, 4} gloo ranks on the CPU (``tests/torch_dist_ranks.py``: one
spawn of four ranks, the groups of the first two and three ranks and the
whole world), float64, each rank calling ``backward`` on the replicated
loss; the JAX functions run in this process on ``points_mesh(4)`` of the
eight CPU devices, float64, under ``jax.jit``, once a case. Values agree to
rtol 1e-10 and the gradients in a, x, b and y to rtol 1e-8 (see
``torch_jax_parity.close``), on every rank: a gradient R times too large,
or one left on the rank that owns the shard, fails. ``ring_lse`` and
``ring_matvec`` are also held, differentiated in all their inputs, to the
port's single-device ops.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from geomloss_tpu import parallel as jpar
from torch_dist_ranks import Ranks
from torch_jax_parity import close

RANKS = (2, 3, 4)
SK = dict(blur=0.1, diameter=2.0)


def _clouds(N, M, seed, uniform=False):
    rng = np.random.RandomState(seed)
    x, y = rng.rand(N, 3), rng.rand(M, 3)
    a, b = (np.full(N, 1.0 / N), np.full(M, 1.0 / M)) if uniform else (rng.rand(N) + 0.5, rng.rand(M) + 0.5)
    return a / a.sum(), x, b / b.sum(), y


#: Case -> (function of geomloss_tpu.parallel, inputs, keywords, inputs
#: differentiated). N and M are uneven (61, 99: padded on every R).
CASES = {
    "sinkhorn": ("sinkhorn_ring", _clouds(61, 99, 0), SK, (0, 1, 2, 3)),
    "reach": ("sinkhorn_ring", _clouds(61, 99, 1), dict(blur=0.1, reach=0.4, diameter=1.9, scaling=0.7), (1, 3)),
    "no_debias": ("sinkhorn_ring", _clouds(61, 99, 2), dict(SK, debias=False), (1, 3)),
    "p1": ("sinkhorn_ring", _clouds(61, 99, 3), dict(SK, p=1), (0, 1, 2, 3)),
    "potentials": ("sinkhorn_ring", _clouds(61, 99, 4), dict(SK, potentials=True), ()),
    "gaussian": ("kernel_ring", _clouds(61, 80, 5), dict(name="gaussian", blur=0.2), (0, 1, 2, 3)),
    "laplacian": ("kernel_ring", _clouds(61, 80, 6), dict(name="laplacian", blur=0.2), (0, 1, 2, 3)),
    "energy": ("kernel_ring", _clouds(61, 80, 7), dict(name="energy", blur=0.2), (0, 1, 2, 3)),
    "kernel_potentials": ("kernel_ring", _clouds(61, 80, 8), dict(name="gaussian", blur=0.2, potentials=True), ()),
}
SGD = dict(inputs=_clouds(64, 64, 2, uniform=True), lr=0.5)


#: The ring ops on the row shards of (60, 84)-point clouds (both divide
#: R = 2, 3, 4), differentiated in every input: the cotangents of the
#: y, h and v shards travel back to their owners.
_x, _y = np.random.RandomState(9).rand(60, 3), np.random.RandomState(10).rand(84, 3)
_h = np.random.RandomState(11).randn(84)
OPS = {
    "lse_p2": ("ring_lse", dict(eps=0.05, p=2)),
    "lse_p1": ("ring_lse", dict(eps=0.1, p=1)),
    "matvec_gibbs_p2": ("ring_matvec", dict(eps=0.05, p=2, kind="gibbs")),
    "matvec_gibbs_p1": ("ring_matvec", dict(eps=0.1, p=1, kind="gibbs")),
    "matvec_energy": ("ring_matvec", dict(eps=1.0, p=1, kind="energy")),
}
OP_COT = np.random.RandomState(12).uniform(0.5, 1.5, 60)


def _single_op(fn, kw):
    """The port's single-device op (dense, float64;
    tests/test_torch_softmin.py holds it to the JAX package): the output
    and the gradients of ``<OP_COT, output>`` in x, y and h (or v)."""
    import torch

    from geomloss_tpu_torch.ops.softmin import gibbs_matvec, lse_points

    leaves = [torch.tensor(v, requires_grad=True) for v in (_x, _y, _h)]
    if fn == "ring_lse":
        out = lse_points(*leaves, kw["eps"], kw["p"], "dense")
    else:
        out = gibbs_matvec(*leaves, kw["eps"], kw["p"], kw["kind"], "dense")
    grads = torch.autograd.grad(out, leaves, grad_outputs=torch.tensor(OP_COT))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_case(fn_name, inputs, kw, argnums):
    """The JAX function on a 4-device mesh: outputs and the gradients of
    the output (cotangent 1) in ``argnums``."""
    mesh = jpar.points_mesh(4)
    fn = jax.jit(lambda *args: getattr(jpar, fn_name)(*args, mesh=mesh, **kw))
    args = [jnp.asarray(v) for v in inputs]
    if not argnums:
        return [np.asarray(o) for o in fn(*args)], []

    def of(*diff):
        full = list(args)
        for i, v in zip(argnums, diff):
            full[i] = v
        return fn(*full)

    out, vjp = jax.vjp(of, *(args[i] for i in argnums))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(1.0))]


def _jax_sgd():
    mesh = jpar.points_mesh(4)
    a, x, b, y = (jnp.asarray(v) for v in SGD["inputs"])
    step = jax.jit(jax.value_and_grad(lambda x: jpar.sinkhorn_ring(a, x, b, y, mesh=mesh, **SK)))
    losses = []
    for _ in range(3):
        v, g = step(x)
        losses.append(float(v))
        x = x - SGD["lr"] * g
    return np.array(losses), [np.asarray(x)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{case: (reference, {R: {rank: torch result}})}``: the torch ranks
    run while the references are computed."""
    cases = [dict(id=(name, R), R=R, fn=fn, inputs=inputs, kw=kw, argnums=argnums)
             for R in RANKS for name, (fn, inputs, kw, argnums) in CASES.items()]
    cases += [dict(id=("sgd", R), R=R, fn="sgd", kw=SK, **SGD) for R in RANKS]
    cases += [dict(id=(name, R), R=R, fn=fn, inputs=(_x, _y, _h), kw=kw, argnums=(0, 1, 2), cot=OP_COT)
              for R in RANKS for name, (fn, kw) in OPS.items()]
    ranks = Ranks(cases, max(RANKS), tmp_path_factory.mktemp("ring"))
    ref = {name: _jax_case(*spec) for name, spec in CASES.items()}
    ref["sgd"] = _jax_sgd()
    ref.update({name: _single_op(fn, kw) for name, (fn, kw) in OPS.items()})
    got = ranks.results()
    return {name: (ref[name], {R: {r: out[(name, R)] for r, out in got.items() if (name, R) in out} for R in RANKS})
            for name in ref}


def _check(ref, per_rank, rtol, grad_rtol):
    (jout, jgrads) = ref
    for rank, (out, grads) in per_rank.items():
        for t, j in zip(out if isinstance(out, list) else [out], jout if isinstance(jout, list) else [jout]):
            close(np.asarray(t), j, rtol)
        assert len(grads) == len(jgrads)
        for t, j in zip(grads, jgrads):
            close(t, j, grad_rtol)


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("case", list(CASES))
def test_ring_matches_jax(runs, case, R):
    ref, by_R = runs[case]
    assert sorted(by_R[R]) == list(range(R))
    _check(ref, by_R[R], rtol=1e-10, grad_rtol=1e-8)


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("op", list(OPS))
def test_ring_ops_match_single_device(runs, op, R):
    """ring_lse and ring_matvec on R ranks, value and the gradients in x,
    y and h (or v) of <cot, output>, against the single-device op: 1e-10
    and 1e-8."""
    ref, by_R = runs[op]
    assert sorted(by_R[R]) == list(range(R))
    _check(ref, by_R[R], rtol=1e-10, grad_rtol=1e-8)


@pytest.mark.parametrize("R", RANKS)
def test_ring_training_steps_match_jax(runs, R):
    """Three gradient steps on sinkhorn_ring, the counterpart of the JAX
    package's test_sinkhorn_ring_jits_with_training_step: the same losses
    and points as JAX's, and the loss decreases."""
    ref, by_R = runs["sgd"]
    _check(ref, by_R[R], rtol=1e-10, grad_rtol=1e-8)
    losses = by_R[R][0][0]
    assert losses[2] < losses[1] < losses[0]


def test_parallel_exports_without_jax():
    """The seven names of geomloss_tpu.parallel, and no JAX module (nor the
    JAX package) imported with them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, geomloss_tpu_torch; p = geomloss_tpu_torch.parallel; print(' '.join(p.__all__)); "
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'geomloss_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, check=True,
                         timeout=120)
    names, modules = out.stdout.strip().splitlines()
    assert names.split() == jpar.__all__
    assert modules == "[]"
