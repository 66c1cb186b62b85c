r"""Hand-written Hopper kernels of the online path, and their plain twins.

Four CUDA kernels (``csrc/online_kernels.cu``) replace the four Pallas
kernels of :mod:`geomloss_tpu.ops.pallas_kernels`:

=====================  ==========================================
wrapper                TPU kernel it replaces
=====================  ==========================================
:func:`lse`            ``lse_pallas`` / ``_lse_kernel``
:func:`sinkhorn_step`  ``sinkhorn_step_pallas`` / ``_pair_step_kernel``
:func:`sinkhorn_step_sym`  ``sinkhorn_step_sym_pallas`` / ``_sym_step_kernel``
:func:`gibbs_apply`    ``gibbs_apply_pallas`` / ``_apply_kernel``
=====================  ==========================================

Each wrapper takes its plain PyTorch twin (``*_blocked``, same signature,
same math over column blocks) only for tensors that lie on the CPU. For
CUDA tensors it launches the kernel, or raises: nothing falls back. The
kernels compute in float32; the wrappers fold weights, potentials and
(p=2) squared norms into base-2 biases, as the JAX wrappers do, and return
results in the input dtype.

The library is compiled with ``nvcc`` at first use (a plain C interface,
loaded with ``ctypes``) into :func:`build_dir`, keyed by a hash of its
sources (the ``.cu`` file and the shared headers).

The kernels take any point dimension. All four are register-tiled pair
blocks over points as float4 vectors: kernels 2-4 over points packed by
:func:`_pair_vectors` (shared with the block-sparse kernels 5, 6 and 8),
kernel 1 over the raw points, which it packs as it loads them
(:func:`_lse_points`, shared with kernel 7): up to three vectors a point
are staged, wider ones read from global memory. Kernel 1 folds its biases
itself, so that one :func:`lse` call of float32 points launches no
PyTorch kernel, only its own and, where its columns are split
(:func:`lse_plan`), their merge.

Each wrapper adds one to its entry of :data:`launch_counts` where it
launches its kernel, and nowhere else, and counts the point pairs the
launch covers (``kernels.pairs``, :mod:`..utils.profiling`).

The two step kernels write per-block partial sums that the wrappers add
up in a fixed order (deterministic, no atomics), and so does the apply
kernel when it cuts the columns into slices; the LSE kernel's slices
write partial (max, sum) pairs that a second kernel merges in slice
order. Their scratch is bounded: row blocks are launched in chunks that
keep it under :data:`STEP_SCRATCH_BYTES` plus ``O(N + M)``
(:func:`step_plan`, :func:`sym_step_plan`, :func:`apply_plan`; the LSE's
slices shrink to fit, :func:`lse_plan`). One :func:`gibbs_apply` call
is one launch wherever its scratch fits the budget: its channel groups
are the grid's third axis. Its fused energy form (``kind="energy_grad"``,
``energy_grad_kernel``) gives the energy MMD's value and its gradient's
channels from one pass over the pairs.
"""

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..utils import profiling
from .costs import SQDIST_FLOOR

__all__ = [
    "lse",
    "lse_blocked",
    "sinkhorn_step",
    "sinkhorn_step_blocked",
    "sinkhorn_step_sym",
    "sinkhorn_step_sym_blocked",
    "gibbs_apply",
    "gibbs_apply_blocked",
    "build",
    "build_dir",
    "launch_counts",
    "reset_launch_counts",
    "lse_plan",
    "step_plan",
    "sym_step_plan",
    "sym_step_pairs",
    "apply_plan",
    "step_scratch_bytes",
    "sym_step_scratch_bytes",
]

LOG2E = math.log2(math.e)

#: Floor on the absorbed row/column sums: caps the per-iteration potential
#: change at ~85*eps nats instead of producing an inf.
SUM_FLOOR = 1e-37
#: Squared-distance cutoff below which distance-gradient weights are zeroed
#: (``geomloss_tpu.ops.softmin.GRAD_SQDIST_CUT``).
GRAD_SQDIST_CUT = 1e-6
#: Column block of the plain twins.
BLOCK_M = 2048

#: Rows per CUDA block and columns per shared-memory tile; must match
#: ``kThreads`` / ``kTile`` in the source.
_CUDA_BLOCK = 256
#: Columns per pass of the register-tiled pair blocks (``kStepPass``), and
#: the most float4 vectors of a point they stage (``kStepStaged``).
_PASS = 64
_STAGED = 3
#: Channels of a group of the apply kernels (4, 6 and 8) when V has more
#: than one.
_CHANNELS = 4

#: Scratch budget of one step call: the per-block partial sums of a launch
#: stay under it (plus O(N + M) when a single row block needs more).
STEP_SCRATCH_BYTES = 128 << 20
#: Blocks per launch the step and apply kernels aim for, so that a chunk of
#: few row blocks still fills the card (132 SMs, several blocks each); the
#: symmetric step's blocks walk parts of a triangle, so it takes smaller
#: slices to keep their work even.
_STEP_BLOCKS = 1024
_SYM_STEP_BLOCKS = 8192
#: Blocks per launch the LSE kernel aims for with its column slices: about
#: two waves of its two blocks an SM (132 SMs). More add merged partials
#: and per-block set-up at the coarse sweeps' 4,096 points; fewer leave a
#: short last wave.
_LSE_BLOCKS = 512
#: Largest gridDim.y of a launch.
_MAX_GRID_Y = 65535

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = _PKG_DIR / "csrc"
#: Build directory of a checkout: ``build/kernels`` beside the package.
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"
#: Environment variable that names the build directory.
BUILD_DIR_ENV = "GEOMLOSS_TPU_TORCH_BUILD_DIR"

#: Prefix of the launch counters in :data:`..utils.profiling.totals`.
LAUNCHES = "kernels.launches."

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`
#: (a view of the counters ``kernels.launches.<wrapper>``).
launch_counts = profiling.TotalsView(LAUNCHES, ("lse", "sinkhorn_step", "sinkhorn_step_sym", "gibbs_apply"))


def reset_launch_counts():
    launch_counts.reset()


# ==============================================================================
#  Build and launch
# ==============================================================================


def _writable(path):
    """Whether ``path`` can be created and written (it is created)."""
    try:
        path.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=path):
            return True
    except OSError:
        return False


def build_dir():
    """Directory the kernels are compiled into: ``$GEOMLOSS_TPU_TORCH_BUILD_DIR``
    if it is set; else :data:`BUILD_DIR` (a checkout's ``build/kernels``)
    where it can be written; else, as for an installed package,
    ``geomloss_tpu_torch/kernels`` under the user cache directory
    (``$XDG_CACHE_HOME``, or ``~/.cache``)."""
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env)
    if _writable(BUILD_DIR):
        return BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "geomloss_tpu_torch" / "kernels"


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built.")
    return path


class KernelLibrary:
    """One ``csrc/<stem>.cu`` compiled into a shared library at first use.

    The library is keyed by a hash of every source that goes into it (the
    ``.cu`` file and the ``.cuh`` headers of ``csrc/``). The compiler's
    output, register and shared-memory counts included (``-Xptxas -v``),
    is kept beside the library as ``*.log``.
    """

    def __init__(self, stem, signatures):
        self.source = CSRC / f"{stem}.cu"
        self.stem = stem
        self.signatures = signatures
        self.path = None  # the built library, once loaded
        self._lib = None

    def build(self):
        """Compile (once per source version) and load the library."""
        if self._lib is not None:
            return self._lib
        h = hashlib.sha256()
        for src in [self.source, *sorted(CSRC.glob("*.cuh"))]:
            h.update(src.read_bytes())
        out = build_dir()
        so = out / f"lib{self.stem}_{h.hexdigest()[:16]}.so"
        if not so.exists():
            out.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [
                _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
                "-o", str(tmp), str(self.source),
            ]
            res = subprocess.run(cmd, capture_output=True, text=True)
            so.with_suffix(".log").write_text(res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
            os.replace(tmp, so)
        self.path = so
        lib = ctypes.CDLL(str(so))
        for name, argtypes in self.signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self._lib = lib
        return lib

    def launch(self, name, *args, count=None):
        """Launch ``gl_<name>`` on the current stream; raise on a CUDA error.

        ``count`` names the launch counter to add one to
        (``kernels.launches.<count>``).
        """
        fn = getattr(self.build(), "gl_" + name)
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {name!r} failed: cudaError {err}")
        if count is not None:
            profiling.count(LAUNCHES + count)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = KernelLibrary(
    "online_kernels",
    {
        # x, y, h, out, part, N, M, width, n_slices, ld, D, kv, p, c2, stream
        "gl_lse": [_P] * 5 + [_I] * 8 + [_F, _P],
        # xv, yv, rb, cb, rowpart, colpart, N, M, row_blk0, n_blk, n_slices,
        # width, kv, p, c2, stream
        "gl_sinkhorn_step": [_P] * 6 + [_I] * 8 + [_F, _P],
        # xv, yv, rb, cb, rowpart, colpart, N, tile0, n_rows, n_slices, nb,
        # kv, p, c2, stream
        "gl_sinkhorn_step_sym": [_P] * 6 + [_I] * 7 + [_F, _P],
        # xv, yv, rb, cb, v, out, N, M, row_blk0, n_blk, n_slices, width,
        # n_groups, out_rows, kv, ch, mode, c2, stream
        "gl_gibbs_apply": [_P] * 6 + [_I] * 11 + [_F, _P],
        # xv, yv, rb, v, out, val, N, M, row_blk0, n_blk, n_slices, width,
        # n_groups, out_rows, kv, D, stream
        "gl_energy_grad_apply": [_P] * 6 + [_I] * 10 + [_P],
    },
)


def build():
    """Compile (once per source version) and load the online kernels."""
    return _LIB.build()


def _launch(name, *args):
    _LIB.launch(name, *args, count=name)


def _cdiv(a, b):
    return -(-a // b)


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must lie on one CUDA device.")


def _points(name, *clouds):
    """The clouds as float32, contiguous, and their point dimension."""
    D = clouds[0].shape[-1]
    for c in clouds:
        if c.ndim != 2 or c.shape[-1] != D or c.shape[0] == 0 or D == 0:
            raise ValueError(f"{name}: point clouds must be non-empty (N, D), D >= 1.")
    return [_f32(c) for c in clouds], D


def _lse_points(name, *clouds, p=2):
    """Points as the LSE kernels (1 and 7) read them: ``(clouds, ld,
    kv)``, each float32 and contiguous with rows ``ld`` floats apart, ``kv
    = ceil((D + 1) / 4)`` float4 vectors a point for p = 2 (a staged row
    carries minus its running max in the last slot, a staged column a 1)
    and ``ceil(D / 4)`` for p = 1. Up to :data:`_STAGED` vectors the
    kernels stage the raw points (``ld = D``: no copy of float32 points);
    wider ones they read as float4 vectors from global memory, so these are
    zero-padded to ``ld = 4 kv`` unless they are already so laid out."""
    out, D = _points(name, *clouds)
    kv = _cdiv(D + (p == 2), 4)
    if kv <= _STAGED or (D == 4 * kv and all(c.data_ptr() % 16 == 0 for c in out)):
        return out, D, kv
    return [torch.nn.functional.pad(c, (0, 4 * kv - D)).contiguous() for c in out], 4 * kv, kv


def _pair_vectors(x, y, phi, psi, eps, p, cols_to=1):
    """Packed points of the register-tiled pair blocks (kernels 2-6 and 8;
    ``csrc/pair_common.cuh``), ``kv`` float4 vectors per point:

    - p = 2: rows ``[c2 x, 0..., 1]``, columns ``[y, 0..., psi2]`` (the
      one and the column bias in the last of ``4 kv`` floats), so that a
      score is the row bias plus one dot product;
    - p = 1: rows ``x`` and columns ``y``, zero-padded.

    The columns are padded to a multiple of ``cols_to`` with points that
    weigh 0: coordinates 0 and bias ``-inf``.

    Returns ``(xv, yv, rb, cb, kv)``: the vectors, and the row and column
    biases in base 2 (:func:`_bias2`; the kernels read ``cb`` for p = 1
    only).
    """
    (xf, yf), D = _points("pair_vectors", x, y)
    rb, cb = _bias2(xf, phi, eps, p), _bias2(yf, psi, eps, p)
    kv = _cdiv(D + 1 if p == 2 else D, 4)
    f = torch.nn.functional.pad
    pad_m = _cdiv(yf.shape[0], cols_to) * cols_to - yf.shape[0]
    yf, cb = f(yf, (0, 0, 0, pad_m)), f(cb, (0, pad_m), value=-math.inf)
    if p == 2:
        pad = (0, 4 * kv - 1 - D)
        xv = torch.cat([f(xf * (LOG2E / eps), pad), torch.ones_like(xf[:, :1])], 1)
        yv = torch.cat([f(yf, pad), cb[:, None]], 1)
    else:
        xv, yv = f(xf, (0, 4 * kv - D)), f(yf, (0, 4 * kv - D))
    return xv.contiguous(), yv.contiguous(), rb, cb.contiguous(), kv


# ==============================================================================
#  Scratch plans of the step kernels
# ==============================================================================


def _even_chunks(n, most):
    """Chunk size of at most ``max(most, 1)`` that cuts ``n`` into chunks
    of equal size up to one."""
    return _cdiv(n, _cdiv(n, max(1, min(n, most))))


def lse_plan(N, M):
    """Column slices of :func:`lse`: ``(S, width)``.

    The launch takes every row block of 256 rows against ``S`` slices of
    ``width`` columns (a multiple of a 64-column pass), so that it holds
    about :data:`_LSE_BLOCKS` blocks where M allows: at N = M = 4,096 (16
    row blocks) 32 slices of two passes. With more than one slice, each
    writes its rows' (max, sum) pairs, ``8 S N`` bytes of scratch, at most
    :data:`STEP_SCRATCH_BYTES` (one slice, no scratch, where the budget
    holds none).
    """
    nb = _cdiv(N, _CUDA_BLOCK)
    passes = _cdiv(M, _PASS)
    S = max(1, min(passes, _cdiv(_LSE_BLOCKS, nb), _MAX_GRID_Y, STEP_SCRATCH_BYTES // (8 * N)))
    width = _cdiv(passes, S) * _PASS
    return _cdiv(M, width), width


def step_plan(N, M):
    """Chunking of :func:`sinkhorn_step`: ``(R, S, width)``.

    Each launch takes ``R`` row blocks of 256 rows against all columns, cut
    into ``S`` slices of ``width`` columns. Its scratch is ``R * M``
    column partials and ``S * R * 256`` row partials (float32):
    ``R * M * 4 <= STEP_SCRATCH_BYTES`` unless ``R = 1``, and
    ``S * R <= _STEP_BLOCKS + R``.
    """
    nb = _cdiv(N, _CUDA_BLOCK)
    R = _even_chunks(nb, STEP_SCRATCH_BYTES // (4 * M))
    S = max(1, min(_cdiv(M, _CUDA_BLOCK), _cdiv(_STEP_BLOCKS, R), _MAX_GRID_Y))
    width = _cdiv(_cdiv(M, S), _CUDA_BLOCK) * _CUDA_BLOCK
    return R, _cdiv(M, width), width


def sym_step_plan(N):
    """Chunking of :func:`sinkhorn_step_sym`: ``(R, S)``.

    Each launch takes ``R`` row tiles of 256 points against the column
    tiles from the first of them on, cut into ``S`` slices. Its scratch is
    ``R * nb * 256`` column partials, at most :data:`STEP_SCRATCH_BYTES`
    unless ``R = 1``, and ``S * R * 256`` row partials, with
    ``S * R <= _SYM_STEP_BLOCKS + R``.
    """
    nb = _cdiv(N, _CUDA_BLOCK)
    R = _even_chunks(nb, STEP_SCRATCH_BYTES // (4 * _CUDA_BLOCK * nb))
    return R, max(1, min(nb, _cdiv(_SYM_STEP_BLOCKS, R), _MAX_GRID_Y))


def _channel_groups(C):
    """Channels per group of an apply kernel (4 and 8) and the padded
    channel count: one channel goes alone, any other count in groups of
    four (zero-padded)."""
    G = 1 if C == 1 else _CHANNELS
    return G, _cdiv(C, G) * G


def _group_channels(V):
    """V ``(M, C)`` as the apply kernel reads it: float32 ``(groups, M,
    ch)``, the groups of :func:`_channel_groups` one after another, the
    last zero-padded."""
    ch, Cp = _channel_groups(V.shape[1])
    Vp = torch.nn.functional.pad(_f32(V), (0, Cp - V.shape[1]))
    return Vp.view(V.shape[0], Cp // ch, ch).transpose(0, 1).contiguous()


def _ungroup_channels(out, C):
    """The ``(N, C)`` result from the kernel's ``(groups, N, ch)`` one."""
    ng, N, ch = out.shape
    return out.transpose(0, 1).reshape(N, ng * ch)[:, :C]


def apply_plan(N, M, C=1):
    """Chunking of :func:`gibbs_apply` with ``C`` channels: ``(R, S, width)``.

    Each launch takes ``R`` row blocks of 256 rows against all columns, cut
    into ``S`` slices of ``width`` columns (a multiple of 256), so that a
    launch holds at least ``_STEP_BLOCKS`` blocks where M allows. With one
    slice the kernel writes the output and ``R`` takes every row block;
    with more, each slice writes its row partials, ``S * Cp * R * 256``
    floats (``Cp`` the padded channels), at most :data:`STEP_SCRATCH_BYTES`
    unless ``R = 1``.
    """
    nb = _cdiv(N, _CUDA_BLOCK)
    tiles = _cdiv(M, _CUDA_BLOCK)
    want = max(1, min(tiles, _cdiv(_STEP_BLOCKS, nb), _MAX_GRID_Y))
    width = (tiles // want) * _CUDA_BLOCK
    S = _cdiv(M, width)
    if S == 1:
        return nb, 1, width
    _, Cp = _channel_groups(C)
    return _even_chunks(nb, STEP_SCRATCH_BYTES // (4 * S * Cp * _CUDA_BLOCK)), S, width


def sym_step_pairs(N, t0, n):
    """Point pairs a launch of :func:`sinkhorn_step_sym` covers: the row
    tiles ``t0 .. t0 + n - 1`` of 256 points, each against the points from
    its own first one on (whole diagonal tiles included)."""
    B = _CUDA_BLOCK
    pairs = B * (n * N - B * (n * t0 + n * (n - 1) // 2))
    last = N - B * (t0 + n - 1)  # the points from the last row tile's first on
    return pairs - (B - last) * last if last < B else pairs


def step_scratch_bytes(N, M):
    """Largest scratch of one :func:`sinkhorn_step` call, from the plan."""
    R, S, _ = step_plan(N, M)
    return 4 * (R * M + S * R * _CUDA_BLOCK)


def sym_step_scratch_bytes(N):
    """Largest scratch of one :func:`sinkhorn_step_sym` call, from the plan."""
    R, S = sym_step_plan(N)
    return 4 * _CUDA_BLOCK * R * (_cdiv(N, _CUDA_BLOCK) + S)


def _f32(t):
    return t.detach().float().contiguous()


# ==============================================================================
#  Plain twins: the same math over column blocks, in the input dtype
# ==============================================================================
#
# For p=1 (and the distance kinds of the apply) the squared distance comes
# from coordinate differences, as in the kernels: a near pair then carries
# no cancellation noise, so the Pallas kernels' noise floor (d := 0 below
# 2e-6 (|x|^2 + |y|^2), a workaround for the expansion form's float32
# error) has no counterpart. p=2 keeps the expansion form, with the squared
# norms folded into the biases.


def _acc(*ts):
    dt = torch.float32
    for t in ts:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def _sqdist(x, y):
    """``|x_i - y_j|^2`` from coordinate differences, ``(N, BM)``."""
    return ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)


def _log_weights_blk(x, phi, y, psi, eps, p):
    """Natural-log absorbed weights ``phi_i + psi_j - C_ij/eps`` of one block;
    for p=2 the caller has folded ``-|.|^2/(2 eps)`` into the biases."""
    if p == 2:
        return phi[:, None] + (psi[None, :] + (x @ y.T) / eps)
    d = torch.sqrt(torch.clamp(_sqdist(x, y), min=SQDIST_FLOOR))
    return phi[:, None] + (psi[None, :] - d / eps)


def _fold_norms(x, bias, eps, p):
    """Fold ``-|x|^2 / (2 eps)`` into a bias for p=2."""
    return bias - 0.5 * (x * x).sum(-1) / eps if p == 2 else bias


def lse_blocked(x, y, h, eps, p=2, block_m=BLOCK_M):
    """Plain twin of :func:`lse`: streaming two-pass LSE over column blocks,
    ``out_i = log sum_j exp(h_j - C_p(x_i, y_j)/eps)``."""
    dt = _acc(x, y, h)
    x, y = x.to(dt), y.to(dt)
    h = _fold_norms(y, h.to(dt), eps, p)
    zero = torch.zeros(x.shape[0], dtype=dt, device=x.device)
    m = torch.full_like(zero, -math.inf)
    s = torch.zeros_like(zero)
    for j0 in range(0, y.shape[0], block_m):
        sl = slice(j0, j0 + block_m)
        arg = _log_weights_blk(x, zero, y[sl], h[sl], eps, p)
        m_new = torch.maximum(m, arg.max(dim=1).values)
        # A row whose weights are all 0 so far (bias -inf: zero-weight
        # points) keeps m = -inf and s = 0, without an inf - inf.
        base = torch.where(torch.isneginf(m_new), 0.0, m_new)
        s = s * torch.exp(m - base) + torch.exp(arg - base[:, None]).sum(1)
        m = m_new
    # p=2: the row term -|x|^2/(2 eps) comes out of the LSE.
    out = _fold_norms(x, m + torch.log(s), eps, p)
    return out.to(x.dtype)


def _absorbed_sums(x, phi, y, psi, eps, p, with_cols, block_m):
    """Row sums (and column sums) of ``W_ij = exp(phi_i + psi_j - C_ij/eps)``
    without a max pass (the bound is in ``pallas_kernels.py``)."""
    r = torch.zeros_like(phi)
    cols = []
    for j0 in range(0, y.shape[0], block_m):
        sl = slice(j0, j0 + block_m)
        W = torch.exp(_log_weights_blk(x, phi, y[sl], psi[sl], eps, p))
        r = r + W.sum(1)
        if with_cols:
            cols.append(W.sum(0))
    return r, (torch.cat(cols) if with_cols else None)


def _absorbed_update(f, loga, eps, sums):
    """``f + eps (loga - log sums)``, sums floored at :data:`SUM_FLOOR`."""
    return f + eps * (loga - torch.log(torch.clamp(sums, min=SUM_FLOOR)))


def _step_sums_blocked(x, y, f, g, loga, logb, eps, p=2, block_m=BLOCK_M):
    """Plain twin of :func:`_step_sums`: the raw row and column sums of the
    absorbed Gibbs matrix, in the promoted input dtype."""
    dt = _acc(x, y, f, g)
    x, y, fa, ga, la, lb = (t.to(dt) for t in (x, y, f, g, loga, logb))
    phi = _fold_norms(x, la + fa / eps, eps, p)
    psi = _fold_norms(y, lb + ga / eps, eps, p)
    return _absorbed_sums(x, phi, y, psi, eps, p, True, block_m)


def sinkhorn_step_blocked(x, y, f, g, loga, logb, eps, p=2, block_m=BLOCK_M):
    """Plain twin of :func:`sinkhorn_step`: both raw softmin values of one
    Jacobi Sinkhorn iteration, from the row and column sums of the absorbed
    Gibbs matrix."""
    r, c = _step_sums_blocked(x, y, f, g, loga, logb, eps, p, block_m)
    dt = r.dtype
    S_xy = _absorbed_update(f.to(dt), loga.to(dt), eps, r)
    S_yx = _absorbed_update(g.to(dt), logb.to(dt), eps, c)
    return S_xy.to(f.dtype), S_yx.to(g.dtype)


def sinkhorn_step_sym_blocked(x, f, loga, eps, p=2, block_m=BLOCK_M):
    """Plain twin of :func:`sinkhorn_step_sym`: the symmetric (debias) step
    ``S_i = -eps LSE_j(loga_j + (f_j - C_ij)/eps)``, from absorbed row sums
    over all column blocks."""
    dt = _acc(x, f)
    x, fa, la = x.to(dt), f.to(dt), loga.to(dt)
    phi = _fold_norms(x, la + fa / eps, eps, p)
    r, _ = _absorbed_sums(x, phi, x, phi, eps, p, False, block_m)
    return _absorbed_update(fa, la, eps, r).to(f.dtype)


def _apply_weights_blk(x, phi, y, psi, eps, p, kind):
    """(N, BM) weights of one column block; see :func:`gibbs_apply`."""
    if p == 2 and kind in ("gibbs", "gibbs_grad"):
        return torch.exp(_log_weights_blk(x, phi, y, psi, eps, 2))
    sq = _sqdist(x, y)
    d = torch.sqrt(torch.clamp(sq, min=SQDIST_FLOOR))
    if kind == "energy":
        return -d
    if kind == "inv_dist":
        return torch.where(sq > GRAD_SQDIST_CUT, 1.0 / d, torch.zeros_like(d))
    w = torch.exp(phi[:, None] + (psi[None, :] - d / eps))
    if kind == "gibbs_grad":
        w = torch.where(sq > GRAD_SQDIST_CUT, w / d, torch.zeros_like(w))
    return w


def _check_kind(kind):
    if kind not in ("gibbs", "gibbs_grad", "energy", "inv_dist"):
        raise ValueError(f"Unknown gibbs_apply kind: {kind!r}")


#: The fused energy kind of :func:`gibbs_apply` (kernel 4 only): the energy
#: value and the x-gradient's channels from one pass.
ENERGY_GRAD = "energy_grad"


def ones_points(y, v):
    """``v [1, y]``: the points with a ones column in front, each row times
    v; the channels whose apply gives a gradient in the other points
    (:data:`ENERGY_GRAD`'s ``V``)."""
    return v[:, None] * torch.cat([torch.ones_like(y[:, :1]), y], -1)


def energy_grad_plain(apply, x, y, phi, psi, v, eps, p):
    """:data:`ENERGY_GRAD` from two plain applies ``apply(x, y, phi, psi,
    V, eps, p, kind)``: the energy kind's of v and the inv_dist kind's of
    ``v [1, y]``."""
    value = apply(x, y, phi, psi, v[:, None], eps, p, "energy")[:, 0]
    return value, apply(x, y, phi, psi, ones_points(y, v), eps, p, "inv_dist")


def gibbs_apply_blocked(x, y, phi, psi, V, eps, p=2, kind="gibbs", block_m=BLOCK_M):
    """Plain twin of :func:`gibbs_apply`: ``O_i = sum_j w_ij V_j`` over
    column blocks; :data:`ENERGY_GRAD` by :func:`energy_grad_plain`."""
    if kind == ENERGY_GRAD:
        return energy_grad_plain(functools.partial(gibbs_apply_blocked, block_m=block_m), x, y, phi, psi, V, eps, p)
    _check_kind(kind)
    dt = _acc(x, y, phi, psi, V)
    x, y, phi, psi, Va = (t.to(dt) for t in (x, y, phi, psi, V))
    if p == 2 and kind in ("gibbs", "gibbs_grad"):
        phi, psi = _fold_norms(x, phi, eps, 2), _fold_norms(y, psi, eps, 2)
    out = torch.zeros((x.shape[0], V.shape[1]), dtype=dt, device=x.device)
    for j0 in range(0, y.shape[0], block_m):
        sl = slice(j0, j0 + block_m)
        out = out + _apply_weights_blk(x, phi, y[sl], psi[sl], eps, p, kind) @ Va[sl]
    return out.to(V.dtype)


# ==============================================================================
#  Kernel wrappers
# ==============================================================================


def _bias2(x, bias, eps, p):
    """Base-2 bias ``bias log2(e)``, minus ``|x|^2 log2(e) / (2 eps)`` for
    p=2 (x float32, padded)."""
    b = _f32(bias) * LOG2E
    if p == 2:
        b = b - (0.5 * LOG2E / eps) * (x * x).sum(-1)
    return b.contiguous()


def lse(x, y, h, eps, p=2):
    """``out_i = log sum_j exp(h_j - C_p(x_i, y_j)/eps)``.

    Args: x ``(N, D)``, y ``(M, D)``, h ``(M,)``, eps scalar, p 1 or 2.
    Returns ``(N,)`` in x's dtype. One launch of kernel 1 over the column
    slices of :func:`lse_plan`, which merges the slices itself where there
    are several.
    """
    if not x.is_cuda:
        return lse_blocked(x, y, h, eps, p)
    _check_cuda("lse", x, y, h)
    if tuple(h.shape) != (y.shape[0],):
        raise ValueError("lse: h must be (M,).")
    eps = float(eps)
    (xf, yf), ld, kv = _lse_points("lse", x, y, p=p)
    hf = _f32(h)
    N, M = xf.shape[0], yf.shape[0]
    S, width = lse_plan(N, M)
    out = torch.empty(N, dtype=torch.float32, device=x.device)
    part = torch.empty((S, N, 2), dtype=torch.float32, device=x.device) if S > 1 else out
    with torch.cuda.device(x.device):
        _launch(
            "lse", xf.data_ptr(), yf.data_ptr(), hf.data_ptr(), out.data_ptr(), part.data_ptr(),
            N, M, width, S, ld, x.shape[1], kv, p, LOG2E / eps,
        )
    profiling.count("kernels.pairs", N * M)
    return out.to(x.dtype)


def _step_sums(x, y, f, g, loga, logb, eps, p=2):
    """Kernel 2: the raw row and column sums of the absorbed Gibbs matrix
    ``W_ij = exp(loga_i + logb_j + (f_i + g_j - C_ij)/eps)``, float32
    ``(N,)`` and ``(M,)`` on the card (no floor). The kernel's
    ``ex2.approx`` flushes a weight below 2^-126 to 0."""
    if not x.is_cuda:
        return _step_sums_blocked(x, y, f, g, loga, logb, eps, p)
    _check_cuda("sinkhorn_step", x, y, f, g, loga, logb)
    eps = float(eps)
    xv, yv, rb, cb, kv = _pair_vectors(
        x, y, _f32(loga) + _f32(f) / eps, _f32(logb) + _f32(g) / eps, eps, p, cols_to=_CUDA_BLOCK
    )
    N, M = x.shape[0], y.shape[0]
    nb = _cdiv(N, _CUDA_BLOCK)
    R, S, width = step_plan(N, M)
    f32 = dict(dtype=torch.float32, device=x.device)
    rows = torch.empty(nb * _CUDA_BLOCK, **f32)
    cols = torch.zeros(M, **f32)
    # Per-block partials of one chunk of row blocks, summed in a fixed
    # order before the next chunk (deterministic, bounded):
    colpart = torch.empty(R * M, **f32)
    rowpart = torch.empty(S * R * _CUDA_BLOCK, **f32)
    with torch.cuda.device(x.device):
        for b0 in range(0, nb, R):
            n = min(R, nb - b0)
            _launch(
                "sinkhorn_step", xv.data_ptr(), yv.data_ptr(), rb.data_ptr(),
                cb.data_ptr(), rowpart.data_ptr(), colpart.data_ptr(), N, M, b0,
                n, S, width, kv, p, LOG2E / eps,
            )
            profiling.count("kernels.pairs", (min(N, (b0 + n) * _CUDA_BLOCK) - b0 * _CUDA_BLOCK) * M)
            rows[b0 * _CUDA_BLOCK : (b0 + n) * _CUDA_BLOCK] = (
                rowpart[: S * n * _CUDA_BLOCK].view(S, -1).sum(0)
            )
            cols += colpart[: n * M].view(n, M).sum(0)
    return rows[:N], cols


def sinkhorn_step(x, y, f, g, loga, logb, eps, p=2):
    """Both raw softmin values of one Jacobi Sinkhorn iteration, from one
    pass over the absorbed Gibbs matrix ``W_ij = exp(loga_i + logb_j +
    (f_i + g_j - C_ij)/eps)``:

    ``S_xy = f + eps (loga - log rowsum W)``, ``S_yx = g + eps (logb -
    log colsum W)``, sums floored at :data:`SUM_FLOOR`.
    """
    if not x.is_cuda:
        return sinkhorn_step_blocked(x, y, f, g, loga, logb, eps, p)
    r, c = _step_sums(x, y, f, g, loga, logb, eps, p)
    S_xy = _absorbed_update(_f32(f), _f32(loga), eps, r)
    S_yx = _absorbed_update(_f32(g), _f32(logb), eps, c)
    return S_xy.to(f.dtype), S_yx.to(g.dtype)


def sinkhorn_step_sym(x, f, loga, eps, p=2):
    """Symmetric-problem step ``S_i = -eps LSE_j(loga_j + (f_j - C_ij)/eps)``
    over the upper triangle of tile pairs only: each off-diagonal tile's
    column sums are the mirror tile's row sums."""
    if not x.is_cuda:
        return sinkhorn_step_sym_blocked(x, f, loga, eps, p)
    _check_cuda("sinkhorn_step_sym", x, f, loga)
    eps = float(eps)
    phi = _f32(loga) + _f32(f) / eps
    # The points twice: as rows, and as columns carrying the bias, padded to
    # whole tiles with bias -inf.
    xv, yv, rb, cb, kv = _pair_vectors(x, x, phi, phi, eps, p, cols_to=_CUDA_BLOCK)
    N = x.shape[0]
    nb = _cdiv(N, _CUDA_BLOCK)
    R, S = sym_step_plan(N)
    f32 = dict(dtype=torch.float32, device=x.device)
    r = torch.zeros((nb, _CUDA_BLOCK), **f32)
    # Row sums of the pairs (I, J >= I) and their mirrored column sums, for
    # one chunk of row tiles; summed in a fixed order before the next one.
    rowpart = torch.empty(S * R * _CUDA_BLOCK, **f32)
    colpart = torch.empty(R * nb * _CUDA_BLOCK, **f32)
    with torch.cuda.device(x.device):
        for t0 in range(0, nb, R):
            n = min(R, nb - t0)
            _launch(
                "sinkhorn_step_sym", xv.data_ptr(), yv.data_ptr(), rb.data_ptr(), cb.data_ptr(),
                rowpart.data_ptr(), colpart.data_ptr(), N, t0, n, S, nb, kv, p, LOG2E / eps,
            )
            profiling.count("kernels.pairs", sym_step_pairs(N, t0, n))
            r[t0 : t0 + n] += rowpart[: S * n * _CUDA_BLOCK].view(S, n, _CUDA_BLOCK).sum(0)
            r[t0:] += colpart[: n * (nb - t0) * _CUDA_BLOCK].view(n, nb - t0, _CUDA_BLOCK).sum(0)
    return _absorbed_update(_f32(f), _f32(loga), eps, r.view(-1)[:N]).to(f.dtype)


_APPLY_MODES = {
    ("gibbs", 2): 0,
    ("gibbs_grad", 2): 0,
    ("gibbs", 1): 1,
    ("gibbs_grad", 1): 2,
    ("energy", 1): 3,
    ("energy", 2): 3,
    ("inv_dist", 1): 4,
    ("inv_dist", 2): 4,
}


def gibbs_apply(x, y, phi, psi, V, eps, p=2, kind="gibbs"):
    """``O_i = sum_j w_ij V_j``, with the weight kinds of
    :func:`geomloss_tpu_torch.ops.softmin.gibbs_apply`.

    Shapes: x ``(N, D)``, y ``(M, D)``, phi ``(N,)``, psi ``(M,)``,
    V ``(M, C)`` -> ``(N, C)`` in V's dtype. One channel goes through the
    kernel alone, more in groups of four, all groups in one launch
    (:func:`_channel_groups`, :func:`apply_plan`).

    ``kind=ENERGY_GRAD`` takes ``V`` the ``(M,)`` vector v and returns the
    energy kind's ``(N,)`` value of v and the inv_dist kind's ``(N, 1 +
    D)`` apply of ``v [1, y]``, from one pass over the pairs
    (:func:`_energy_grad_apply`).
    """
    if kind == ENERGY_GRAD:
        if not x.is_cuda:
            return gibbs_apply_blocked(x, y, phi, psi, V, eps, p, kind)
        return _energy_grad_apply(x, y, phi, V)
    _check_kind(kind)
    if not x.is_cuda:
        return gibbs_apply_blocked(x, y, phi, psi, V, eps, p, kind)
    _check_cuda("gibbs_apply", x, y, phi, psi, V)
    mode = _APPLY_MODES[(kind, p)]
    eps = float(eps)
    xv, yv, rb, cb, kv = _pair_vectors(x, y, phi, psi, eps, 2 if mode == 0 else 1)
    N, M, C = x.shape[0], y.shape[0], V.shape[1]
    v = _group_channels(V)
    ng, _, ch = v.shape
    c2 = LOG2E / eps if mode <= 2 else 0.0

    def launch(b0, n, S, width, dst, vdst, out_rows):
        _launch(
            "gibbs_apply", xv.data_ptr(), yv.data_ptr(), rb.data_ptr(), cb.data_ptr(), v.data_ptr(),
            dst, N, M, b0, n, S, width, ng, out_rows, kv, ch, mode, c2,
        )

    out, _ = _apply_launches(x.device, N, M, C, ng, ch, launch)
    return _ungroup_channels(out, C).to(V.dtype)


def _apply_launches(device, N, M, C, ng, ch, launch, value=False):
    """Kernel 4's launches over the rows of one apply, for both of its
    entries: ``out (ng, N, ch)`` and, with ``value``, the fused energy
    form's ``(N,)`` value. Row blocks go in chunks of :func:`apply_plan`'s
    ``R`` (``C`` the channels it plans for), one ``launch(b0, n, S, width,
    dst, vdst, out_rows)`` a chunk. With one column slice the kernel writes
    ``out`` (and the value) in place; with several, each slice's row
    partials of the chunk, summed in a fixed order before the next chunk."""
    nb = _cdiv(N, _CUDA_BLOCK)
    R, S, width = apply_plan(N, M, C)
    f32 = dict(dtype=torch.float32, device=device)
    out = torch.empty((ng, N, ch), **f32)
    val = torch.empty(N, **f32) if value else None
    if S > 1:
        part = torch.empty((S, ng, R * _CUDA_BLOCK, ch), **f32)
        vpart = torch.empty((S, R * _CUDA_BLOCK), **f32) if value else None
    with torch.cuda.device(device):
        for b0 in range(0, nb, R):
            n = min(R, nb - b0)
            i0, i1 = b0 * _CUDA_BLOCK, min(N, (b0 + n) * _CUDA_BLOCK)
            if S == 1:
                vdst = val.data_ptr() + 4 * i0 if value else 0
                launch(b0, n, S, width, out.data_ptr() + 4 * ch * i0, vdst, N)
            else:
                launch(b0, n, S, width, part.data_ptr(), vpart.data_ptr() if value else 0, R * _CUDA_BLOCK)
            profiling.count("kernels.pairs", (i1 - i0) * M)
            if S > 1:
                out[:, i0:i1] = part[:, :, : i1 - i0].sum(0)
                if value:
                    val[i0:i1] = vpart[:, : i1 - i0].sum(0)
    return out, val


def _energy_grad_apply(x, y, phi, v):
    """Kernel 4's fused energy form: ``(O, R)`` with ``O_i = -sum_j d_ij
    v_j`` and ``R_i = sum_j V_j / d_ij``, ``V = v [1, y]`` (zero where
    ``d_ij^2 <= GRAD_SQDIST_CUT``), in v's dtype. One launch a chunk of row
    blocks: the groups of four channels of ``V`` are the grid's third axis,
    each built in the kernel from v and the packed columns, and group 0
    also sums the value. R is the inv_dist kind's apply of ``V`` to the
    bit, O the energy kind's up to the order of its sums."""
    _check_cuda("gibbs_apply", x, y, phi, v)
    if tuple(v.shape) != (y.shape[0],):
        raise ValueError("gibbs_apply: energy_grad takes v (M,).")
    xv, yv, rb, _, kv = _pair_vectors(x, y, phi, torch.zeros_like(v), 1.0, 1)
    vf = _f32(v)
    N, M, C = x.shape[0], y.shape[0], 1 + x.shape[1]
    ng = _channel_groups(C)[1] // _CHANNELS

    def launch(b0, n, S, width, dst, vdst, out_rows):
        _LIB.launch(
            "energy_grad_apply", xv.data_ptr(), yv.data_ptr(), rb.data_ptr(), vf.data_ptr(), dst, vdst,
            N, M, b0, n, S, width, ng, out_rows, kv, x.shape[1], count="gibbs_apply",
        )

    # The value's partials take one channel more than V's:
    out, val = _apply_launches(x.device, N, M, C + 1, ng, _CHANNELS, launch, value=True)
    return val.to(v.dtype), _ungroup_channels(out, C).to(v.dtype)
