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
loaded with ``ctypes``) into ``build/kernels/`` at the repository root,
keyed by a hash of the source. Each wrapper adds one to its entry of
:data:`launch_counts` where it launches its kernel, and nowhere else.
"""

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import torch

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
    "launch_counts",
    "reset_launch_counts",
]

LOG2E = math.log2(math.e)
LN2 = math.log(2.0)

#: Floor on the absorbed row/column sums: caps the per-iteration potential
#: change at ~85*eps nats instead of producing an inf.
SUM_FLOOR = 1e-37
#: Squared-distance cutoff below which distance-gradient weights are zeroed
#: (``geomloss_tpu.ops.softmin.GRAD_SQDIST_CUT``).
GRAD_SQDIST_CUT = 1e-6
#: Column block of the plain twins.
BLOCK_M = 2048

#: Rows per CUDA block (one thread per row) and columns per shared-memory
#: tile; must match ``kThreads`` / ``kTile`` in the source.
_CUDA_BLOCK = 256
#: Point dimensions the kernels are compiled for; smaller D is zero-padded.
_KERNEL_DIMS = (1, 2, 3, 4, 8, 16)
#: Channels per launch of the apply kernel; wider V loops over groups.
_CHANNELS = 4

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = _PKG_DIR / "csrc" / "online_kernels.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"

#: Kernel launches per wrapper since the last :func:`reset_launch_counts`.
launch_counts = {
    "lse": 0,
    "sinkhorn_step": 0,
    "sinkhorn_step_sym": 0,
    "gibbs_apply": 0,
}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


# ==============================================================================
#  Build and launch
# ==============================================================================

_lib = None


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built.")
    return path


def build():
    """Compile (once per source version) and load the kernel library.

    The compiler's output, register and shared-memory counts included
    (``-Xptxas -v``), is kept beside the library as ``*.log``.
    """
    global _lib
    if _lib is not None:
        return _lib
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libonline_kernels_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
            "-o", str(tmp), str(SOURCE),
        ]
        res = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        # x, y, h2, out, N, M, D, p, c2, stream
        "gl_lse": [P, P, P, P, I, I, I, I, F, P],
        # x, y, phi, psi, rows, colpart, N, M, D, p, c2, stream
        "gl_sinkhorn_step": [P, P, P, P, P, P, I, I, I, I, F, P],
        # x, phi, it, jt, part, N, T, nb, D, p, c2, stream
        "gl_sinkhorn_step_sym": [P, P, P, P, P, I, I, I, I, I, F, P],
        # x, y, phi, psi, vt, out, N, M, D, mode, c2, stream
        "gl_gibbs_apply": [P, P, P, P, P, P, I, I, I, I, F, P],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _launch(name, *args):
    """Launch ``gl_<name>`` on the current stream; raise on a CUDA error."""
    fn = getattr(build(), "gl_" + name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed: cudaError {err}")
    launch_counts[name] += 1


def _cdiv(a, b):
    return -(-a // b)


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must lie on one CUDA device.")


def _points(name, *clouds):
    """float32, contiguous, zero-padded to a compiled point dimension."""
    D = clouds[0].shape[-1]
    for c in clouds:
        if c.ndim != 2 or c.shape[-1] != D or c.shape[0] == 0:
            raise ValueError(f"{name}: point clouds must be non-empty (N, D).")
    Dk = next((k for k in _KERNEL_DIMS if D <= k), None)
    if Dk is None:
        raise NotImplementedError(
            f"{name}: the CUDA kernels are compiled for D <= {_KERNEL_DIMS[-1]}"
            f" (got D={D})."
        )
    out = [
        torch.nn.functional.pad(c.detach().float(), (0, Dk - D)).contiguous()
        for c in clouds
    ]
    return out, Dk


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
    m = s = None
    for j0 in range(0, y.shape[0], block_m):
        sl = slice(j0, j0 + block_m)
        arg = _log_weights_blk(x, zero, y[sl], h[sl], eps, p)
        blk_max = arg.max(dim=1).values
        if m is None:
            m, s = blk_max, torch.zeros_like(blk_max)
        else:
            m_new = torch.maximum(m, blk_max)
            s = s * torch.exp(m - m_new)
            m = m_new
        s = s + torch.exp(arg - m[:, None]).sum(1)
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


def sinkhorn_step_blocked(x, y, f, g, loga, logb, eps, p=2, block_m=BLOCK_M):
    """Plain twin of :func:`sinkhorn_step`: both raw softmin values of one
    Jacobi Sinkhorn iteration, from the row and column sums of the absorbed
    Gibbs matrix."""
    dt = _acc(x, y, f, g)
    x, y, fa, ga, la, lb = (t.to(dt) for t in (x, y, f, g, loga, logb))
    phi = _fold_norms(x, la + fa / eps, eps, p)
    psi = _fold_norms(y, lb + ga / eps, eps, p)
    r, c = _absorbed_sums(x, phi, y, psi, eps, p, True, block_m)
    S_xy = _absorbed_update(fa, la, eps, r)
    S_yx = _absorbed_update(ga, lb, eps, c)
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


def gibbs_apply_blocked(x, y, phi, psi, V, eps, p=2, kind="gibbs", block_m=BLOCK_M):
    """Plain twin of :func:`gibbs_apply`: ``O_i = sum_j w_ij V_j`` over
    column blocks."""
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
    Returns ``(N,)`` in x's dtype.
    """
    if not x.is_cuda:
        return lse_blocked(x, y, h, eps, p)
    _check_cuda("lse", x, y, h)
    eps = float(eps)
    (xf, yf), Dk = _points("lse", x, y)
    N, M = xf.shape[0], yf.shape[0]
    h2 = _bias2(yf, h, eps, p)
    out = torch.empty(N, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch(
            "lse", xf.data_ptr(), yf.data_ptr(), h2.data_ptr(), out.data_ptr(),
            N, M, Dk, p, LOG2E / eps,
        )
    out = out * LN2
    if p == 2:
        out = out - 0.5 * (xf * xf).sum(-1) / eps
    return out.to(x.dtype)


def sinkhorn_step(x, y, f, g, loga, logb, eps, p=2):
    """Both raw softmin values of one Jacobi Sinkhorn iteration, from one
    pass over the absorbed Gibbs matrix ``W_ij = exp(loga_i + logb_j +
    (f_i + g_j - C_ij)/eps)``:

    ``S_xy = f + eps (loga - log rowsum W)``, ``S_yx = g + eps (logb -
    log colsum W)``, sums floored at :data:`SUM_FLOOR`.
    """
    if not x.is_cuda:
        return sinkhorn_step_blocked(x, y, f, g, loga, logb, eps, p)
    _check_cuda("sinkhorn_step", x, y, f, g, loga, logb)
    eps = float(eps)
    (xf, yf), Dk = _points("sinkhorn_step", x, y)
    N, M = xf.shape[0], yf.shape[0]
    phi = _bias2(xf, _f32(loga) + _f32(f) / eps, eps, p)
    psi = _bias2(yf, _f32(logb) + _f32(g) / eps, eps, p)
    rows = torch.empty(N, dtype=torch.float32, device=x.device)
    # Per-row-block column partials, summed below (deterministic):
    colpart = torch.empty((_cdiv(N, _CUDA_BLOCK), M), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch(
            "sinkhorn_step", xf.data_ptr(), yf.data_ptr(), phi.data_ptr(),
            psi.data_ptr(), rows.data_ptr(), colpart.data_ptr(), N, M, Dk, p,
            LOG2E / eps,
        )
    S_xy = _absorbed_update(_f32(f), _f32(loga), eps, rows)
    S_yx = _absorbed_update(_f32(g), _f32(logb), eps, colpart.sum(0))
    return S_xy.to(f.dtype), S_yx.to(g.dtype)


def sinkhorn_step_sym(x, f, loga, eps, p=2):
    """Symmetric-problem step ``S_i = -eps LSE_j(loga_j + (f_j - C_ij)/eps)``
    over the upper triangle of tile pairs only: each off-diagonal tile's
    column sums are the mirror tile's row sums."""
    if not x.is_cuda:
        return sinkhorn_step_sym_blocked(x, f, loga, eps, p)
    _check_cuda("sinkhorn_step_sym", x, f, loga)
    eps = float(eps)
    (xf,), Dk = _points("sinkhorn_step_sym", x)
    N = xf.shape[0]
    phi = _bias2(xf, _f32(loga) + _f32(f) / eps, eps, p)
    nb = _cdiv(N, _CUDA_BLOCK)
    it, jt = torch.triu_indices(nb, nb, device=x.device).to(torch.int32)
    it, jt = it.contiguous(), jt.contiguous()
    # part[I, J] holds the sums of tile pair (I, J) over the rows of tile I:
    # row sums for J >= I, the mirrored column sums of (J, I) for J < I.
    part = torch.empty((nb, nb, _CUDA_BLOCK), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _launch(
            "sinkhorn_step_sym", xf.data_ptr(), phi.data_ptr(), it.data_ptr(),
            jt.data_ptr(), part.data_ptr(), N, it.shape[0], nb, Dk, p,
            LOG2E / eps,
        )
    r = part.sum(1).reshape(-1)[:N]
    return _absorbed_update(_f32(f), _f32(loga), eps, r).to(f.dtype)


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
    V ``(M, C)`` -> ``(N, C)`` in V's dtype. Channels go through the kernel
    in groups of four.
    """
    _check_kind(kind)
    if not x.is_cuda:
        return gibbs_apply_blocked(x, y, phi, psi, V, eps, p, kind)
    _check_cuda("gibbs_apply", x, y, phi, psi, V)
    mode = _APPLY_MODES[(kind, p)]
    eps = float(eps)
    (xf, yf), Dk = _points("gibbs_apply", x, y)
    N, M = xf.shape[0], yf.shape[0]
    p_bias = 2 if mode == 0 else 1
    phi2, psi2 = _bias2(xf, phi, eps, p_bias), _bias2(yf, psi, eps, p_bias)
    C = V.shape[1]
    Cp = _cdiv(C, _CHANNELS) * _CHANNELS
    Vt = torch.nn.functional.pad(_f32(V).T, (0, 0, 0, Cp - C)).contiguous()
    c2 = LOG2E / eps if mode <= 2 else 0.0
    outs = []
    with torch.cuda.device(x.device):
        for c0 in range(0, Cp, _CHANNELS):
            out = torch.empty((N, _CHANNELS), dtype=torch.float32, device=x.device)
            _launch(
                "gibbs_apply", xf.data_ptr(), yf.data_ptr(), phi2.data_ptr(),
                psi2.data_ptr(), Vt[c0 : c0 + _CHANNELS].data_ptr(),
                out.data_ptr(), N, M, Dk, mode, c2,
            )
            outs.append(out)
    return torch.cat(outs, dim=1)[:, :C].to(V.dtype)
