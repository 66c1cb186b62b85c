"""The port's row-sharded multiscale solve and the row offset of kernels 5
and 6.

``geomloss_tpu_torch.parallel.sinkhorn_multiscale_sharded`` runs on R in
{2, 4} gloo ranks on the CPU (``tests/torch_dist_ranks.py``, float64, the
plain twins of the kernels), each rank calling ``backward``, against:

* the port's single-device ``sinkhorn_multiscale`` on the same clouds,
  computed on the second rank after the first two ran: 1000 and 963 points
  pad to 1024 at tile 128 on one rank as on R ranks (``tile * R * 2^k``),
  so both visit the same pairs and agree to 1e-10 in value and gradient
  (uneven sizes and weights; p = 1, unbalanced, potentials, the mid path
  and a schedule that ends at the jump);
* JAX's single-device ``sinkhorn_multiscale`` (float32 kernels, interpret
  mode, under ``jax.jit``) on the clouds and settings of ``tests/test_torch_multiscale.py``'s
  p = 2 case, at its bounds: value 1e-5 relative, gradient 1e-4 relative
  L2, the port's coarse tables on the JAX package's keep rule as there
  (the port's default subtracts the cluster blocks' seam radii);
* JAX's ``sinkhorn_multiscale_sharded`` on two devices at its own tests'
  ``KW`` (1000 points in D = 2; value only: one interpret-mode solve),
  the port on the last two ranks while the first two run.

The row-offset tests hold the twins of kernels 5 and 6 on each shard of a
triangle table to the whole table's call.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomloss_tpu import parallel as jpar
from geomloss_tpu.models.multiscale import sinkhorn_multiscale as jax_multiscale
from geomloss_tpu_torch.ops import cuda_block_sparse as cbs
from geomloss_tpu_torch.parallel import sinkhorn_multiscale_sharded
from torch_dist_ranks import Ranks
from torch_jax_parity import close
from torch_parity_utils import kept_table

RANKS = (2, 4)
KW = dict(blur=0.05, diameter=2.0, scaling=0.5, tile=128, target_clusters=64)
#: tests/test_torch_multiscale.py's settings (its p = 2 case: 2048 points,
#: seed 2), where its bounds against the JAX package hold.
MS_KW = dict(blur=0.05, diameter=2.0, scaling=0.5, tile=128, target_clusters=128)
#: The JAX package's sharded tests' settings (tests/test_multiscale_sharded.py).
JAX_KW = dict(p=2, blur=0.02, diameter=1.5, scaling=0.7, target_clusters=256)


def _clouds(N, M, seed, D=3):
    rng = np.random.RandomState(seed)
    x, y = rng.rand(N, D), rng.rand(M, D) + 0.1
    a, b = rng.rand(N) + 0.5, rng.rand(M) + 0.5
    return a / a.sum(), x, b / b.sum(), y


CLOUDS = _clouds(1000, 963, 0)
#: Case -> (keywords, inputs differentiated, extra case fields).
CASES = {
    "p2": (dict(KW, p=2), (0, 1, 2, 3), {}),
    "p1": (dict(KW, p=1), (1, 3), {}),
    "unbalanced": (dict(KW, p=2, reach=0.5), (1, 3), {}),
    "potentials": (dict(KW, p=2, potentials=True), (), {}),
    "mid": (dict(KW, p=2), (1, 3), {"n_fine_ok": 256}),
    "jump": (dict(KW, p=2, blur=1.0), (1, 3), {}),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{case: (single-device result, {R: {rank: result}})}`` and the JAX
    references; the ranks run while JAX computes."""
    world = max(RANKS)

    def sharded(name, R):
        kw, argnums, extra = CASES[name]
        return dict(id=(name, R), R=R, fn="sinkhorn_multiscale_sharded", inputs=CLOUDS, kw=kw, argnums=argnums,
                    **extra)

    a, x, b, y = _clouds(1000, 1000, 0, D=2)
    cases = [sharded(name, 2) for name in CASES]
    cases.append(dict(id="jax_kw", R=2, ranks=(2, 3), fn="sinkhorn_multiscale_sharded", inputs=(a, x, b, y),
                      kw=JAX_KW))
    cases += [dict(id=(name, "single"), R=1, ranks=(1,), fn="single", inputs=CLOUDS, kw=dict(kw, impl="blocked"),
                   argnums=argnums, **extra) for name, (kw, argnums, extra) in CASES.items()]
    cases += [sharded(name, 4) for name in CASES]
    ms_clouds = _clouds(2048, 2048, 2)
    cases.append(dict(id="jax_single", R=4, fn="sinkhorn_multiscale_sharded", inputs=ms_clouds,
                      kw=dict(MS_KW, p=2), argnums=(1,), jax_coarse_rule=True))
    ranks = Ranks(cases, world, tmp_path_factory.mktemp("sharded"))

    # Under jax.jit: 2-3x faster than the interpret-mode kernels eagerly.
    ja, jx, jb, jy = map(jnp.asarray, ms_clouds)
    jv, jg = jax.jit(jax.value_and_grad(lambda x, a, b, y: jax_multiscale(a, x, b, y, p=2, **MS_KW)))(jx, ja, jb, jy)
    ref = {"jax_single": (float(jv), np.asarray(jg))}
    mesh = jpar.points_mesh(2)
    sharded = jax.jit(lambda *args: jpar.sinkhorn_multiscale_sharded(*args, mesh=mesh, **JAX_KW))
    ref["jax_sharded"] = float(sharded(*map(jnp.asarray, (a, x, b, y))))
    got = ranks.results()
    by_case = {
        name: (got[1][(name, "single")],
               {R: {r: out[(name, R)] for r, out in got.items() if (name, R) in out} for R in RANKS})
        for name in CASES
    }
    return by_case, ref, {key: {r: out[key] for r, out in got.items() if key in out}
                          for key in ("jax_kw", "jax_single")}


@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_single_device(runs, case, R):
    """Every rank's value (or potentials) and gradients equal the
    single-device solve's to 1e-10."""
    (single_out, single_grads), by_R = runs[0][case]
    assert sorted(by_R[R]) == list(range(R))
    for out, grads in by_R[R].values():
        for t, s in zip(out if isinstance(out, list) else [out], single_out if isinstance(out, list) else [single_out]):
            close(np.asarray(t), np.asarray(s), 1e-10)
        assert len(grads) == len(single_grads) == len(CASES[case][1])
        for t, s in zip(grads, single_grads):
            close(t, s, 1e-10)


def test_sharded_matches_jax_single_device(runs):
    """The sharded solve on four ranks against JAX's single-device solve
    (the bounds of tests/test_torch_multiscale.py: its kernels compute in
    float32), both on the JAX package's coarse keep rule."""
    jv, jg = runs[1]["jax_single"]
    assert sorted(runs[2]["jax_single"]) == [0, 1, 2, 3]
    for v, (g,) in runs[2]["jax_single"].values():
        assert abs(float(v) - jv) <= 1e-5 * abs(jv)
        assert np.linalg.norm(g - jg) <= 1e-4 * np.linalg.norm(jg)


def test_sharded_matches_jax_sharded(runs):
    """Two ranks against JAX's sharded solve on two devices at the JAX
    package's own sharded tests' settings (blur 0.02, scaling 0.7, 256
    clusters; 1000 points in D = 2): the JAX fine phase computes in
    float32, 1e-5 relative."""
    jv = runs[1]["jax_sharded"]
    assert sorted(runs[2]["jax_kw"]) == [2, 3]
    for v, _ in runs[2]["jax_kw"].values():
        assert abs(float(v) - jv) <= 1e-5 * abs(jv)


def test_truncate_none_raises():
    a, x, b, y = (torch.tensor(v) for v in CLOUDS)
    with pytest.raises(NotImplementedError, match="truncate=None"):
        sinkhorn_multiscale_sharded(a, x, b, y, truncate=None, **KW)


def _triangle(tile, n_tiles, p, seed):
    """A symmetric problem (float64) and its triangle table."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.rand(n_tiles * tile, 3))
    phi = torch.tensor(rng.randn(n_tiles * tile) - np.log(n_tiles * tile))  # f / eps + log a
    cols, cnt = (torch.tensor(v) for v in kept_table(n_tiles, n_tiles, n_tiles, seed=p, sym=True))
    return x, phi, cols, cnt


def _shard_calls(fn, x, phi, cols, cnt, tile, shards, extra, offsets):
    """``fn`` on each shard of rows, as each rank calls it (``offsets``:
    the row offsets the shards pass)."""
    n_l = cols.shape[0] // shards
    out = []
    for r in range(shards):
        rows, pts = slice(r * n_l, (r + 1) * n_l), slice(r * n_l * tile, (r + 1) * n_l * tile)
        out.append(fn(x[pts], x, phi[pts], phi, *extra(pts), 0.05, cols[rows], cnt[rows], tile=tile, tri=True,
                      row_offset=offsets[r]))
    return out


@pytest.mark.parametrize("p", [1, 2])
def test_triangle_shards_add_up_to_the_whole_table(p):
    """Kernel 5's and 6's twins on the 4 shards of a triangle table, each
    with its row offset: the rows laid end to end are the whole call's rows
    (the same pairs, the same order: bitwise), and the column partials
    added to them give the whole call's row + column sums. Without the
    offset (the diagonal at J == I, the rule of a whole table), shard 1
    visits other pairs and the sum is wrong."""
    tile, n_tiles, shards = 128, 8, 4
    x, phi, cols, cnt = _triangle(tile, n_tiles, p, seed=p)
    n_l = n_tiles // shards
    offsets = [r * n_l for r in range(shards)]
    whole_r, whole_c = cbs.absorbed_sum_tiles_blocked(x, x, phi, phi, 0.05, cols, cnt, p=p, tile=tile, tri=True)

    def sums(xr, xf, pr, pf, eps, c, n, **kw):
        return cbs.absorbed_sum_tiles_blocked(xr, xf, pr, pf, eps, c, n, p=p, **kw)

    parts = _shard_calls(sums, x, phi, cols, cnt, tile, shards, lambda pts: (), offsets)
    assert torch.equal(torch.cat([r for r, _ in parts]), whole_r)
    torch.testing.assert_close(torch.cat([r for r, _ in parts]) + sum(c for _, c in parts), whole_r + whole_c,
                               rtol=1e-13, atol=0)
    old = _shard_calls(sums, x, phi, cols, cnt, tile, shards, lambda pts: (), [0] * shards)
    assert not torch.allclose(old[1][0], whole_r[n_l * tile : 2 * n_l * tile], rtol=1e-3)
    assert not torch.allclose(torch.cat([r for r, _ in old]) + sum(c for _, c in old), whole_r + whole_c, rtol=1e-3)

    kind = "gibbs" if p == 2 else "gibbs_grad"
    V = torch.cat([torch.ones_like(x[:, :1]), x], 1)
    whole = cbs.gibbs_apply_tiles_blocked(x, x, phi, phi, V, V, 0.05, cols, cnt, p=p, kind=kind, tile=tile, tri=True)

    def apply(xr, xf, pr, pf, Vy, Vx, eps, c, n, **kw):
        return cbs.gibbs_apply_tiles_blocked(xr, xf, pr, pf, Vy, Vx, eps, c, n, p=p, kind=kind, **kw)

    parts = _shard_calls(apply, x, phi, cols, cnt, tile, shards, lambda pts: (V, V[pts]), offsets)
    assert torch.equal(torch.cat([r for r, _ in parts]), whole[0])
    torch.testing.assert_close(torch.cat([r for r, _ in parts]) + sum(c for _, c in parts), whole[0] + whole[1],
                               rtol=1e-13, atol=1e-300)


def test_row_offset_table_checks():
    """A triangle table's shard must lie within the column tiles, and the
    offset of a whole table is 0."""
    x, phi, cols, cnt = _triangle(128, 4, 2, seed=0)
    args = (x[:256], x, phi[:256], phi, 0.05, cols[:2], cnt[:2])
    with pytest.raises(ValueError, match="triangle table"):
        cbs.absorbed_sum_tiles(*args, p=2, tile=128, tri=True, row_offset=3)
    kept = cbs.kept_pairs(cols[2:], cnt[2:], tri=True, row_offset=2).view(2, -1)
    assert ((kept < 0) | (kept >= torch.tensor([[2], [3]], dtype=torch.int32))).all()
