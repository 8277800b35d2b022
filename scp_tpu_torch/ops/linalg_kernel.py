"""Batched Cholesky, Cholesky solve and the two G matvecs: the Hopper kernels'
wrappers (``csrc/linalg.cu``), counterparts of ``scp_tpu/ops/pallas_linalg.py``
``cholesky_lane`` / ``cholesky`` (under ``vmap``), ``cho_solve_lane`` /
``cho_solve``, ``gmv_lane`` and ``gtmv_lane``.

Tensors are instance-major with a leading batch axis; there is no lane
layout, so each TPU pair (lane API and ``vmap`` front) is ONE kernel here.

* :func:`cholesky` ``K (B, n, n) -> L (B, n, n)``: lower factor. The kernel
  writes zeros above the diagonal (the TPU kernel leaves garbage there;
  consumers read the lower triangle only). An instance that is not positive
  definite comes back all NaN; the others are untouched.
* :func:`cho_solve` ``L (B, n, n), b (B, n) -> x (B, n)``: ``(L L^T) x = b``.
* :func:`gmv` ``G (B, m, n), x (B, n) -> (B, m)``; :func:`gtmv`
  ``G (B, m, n), v (B, m) -> (B, n)``.

Launch geometry is decided here and checked by the launchers
(:func:`chol_geometry`, :func:`solve_geometry`, :func:`gmv_geometry`): the
factor and the solve run one CTA per instance on panels / blocks of
:data:`CHOL_PANEL` columns (``csrc/chol_blocked.cuh``); the G product
stages row tiles of at most :data:`GMV_STAGE_BYTES` in shared memory, one
CTA each (a row wider than that in runs of columns).

Type rule: float32 CUDA tensors (contiguous) always go to the hand-written
kernel; a failing build, load or launch raises. float64 CUDA tensors are
refused with ``TypeError`` (the kernels are float32 only) and never routed
to the plain version quietly. CPU tensors, of either type, take the plain
versions of ``ops/linalg.py``. Each wrapper counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from scp_tpu_torch.ops import _cuda_build, linalg
from scp_tpu_torch.ops._cuda_build import SMEM_LIMIT_BYTES

# The factor (csrc/chol_blocked.cuh): one CTA per instance, CHOL_PANEL = 16
# columns per panel (the kernel's kPanel), CHOL_FEW_THREADS threads for at
# most CHOL_FEW_INSTANCES instances (two CTAs per SM of an H100: one
# instance's latency), else 128 (eight CTAs of n = 81 share an SM).
CHOL_PANEL = 16
CHOL_FEW_INSTANCES = 264
CHOL_FEW_THREADS = 256
# The solve (the same header's blocked solve): one CTA per instance,
# SOLVE_FEW_THREADS threads for at most SOLVE_FEW_INSTANCES instances, else
# 128 (eight CTAs of n = 81 share an SM).
SOLVE_FEW_INSTANCES = 264
SOLVE_FEW_THREADS = 256
# The G product (gmv_staged_kernel): a row tile's stage holds at most
# GMV_STAGE_BYTES (a row wider than that is staged in runs of columns that
# fill it), and tiles are cut smaller until the grid has
# GMV_MIN_CTAS CTAs (eight per SM of an H100; a tile keeps at least 4 rows,
# one warp's share).
GMV_STAGE_BYTES = 32 * 1024
GMV_MIN_CTAS = 1056

# Launches of each CUDA kernel since the last reset (incremented where the
# kernel is launched and nowhere else).
launch_counts = {"cholesky": 0, "cho_solve": 0, "gmv": 0, "gtmv": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_ARGTYPES = {
    "chol_batched_launch": [_P, _P, _I, _I, _I, _L, _P],
    "cho_solve_batched_launch": [_P, _P, _P, _I, _I, _I, _L, _P],
    "gmv_batched_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _L, _P],
    "gtmv_batched_launch": [_P, _P, _P, _I, _I, _I, _P],
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def chol_smem_bytes(n: int) -> int:
    """Dynamic shared memory of the factor kernel: the matrix with an odd
    leading dimension, ``1 / diag`` and a flag."""
    return 4 * (n * (n | 1) + n + 1)


def solve_smem_bytes(n: int) -> int:
    """Dynamic shared memory of the solve kernel: the factor, ``1 / diag``
    and the right-hand side."""
    return 4 * (n * (n | 1) + 2 * n)


def chol_geometry(B: int, n: int) -> tuple[int, int]:
    """``(threads, shared-memory bytes per CTA)`` of the factor kernel, which
    runs one CTA per instance."""
    threads = CHOL_FEW_THREADS if B <= CHOL_FEW_INSTANCES else 128
    return threads, chol_smem_bytes(n)


def solve_geometry(B: int, n: int) -> tuple[int, int]:
    """``(threads, shared-memory bytes per CTA)`` of the solve kernel,
    which runs one CTA per instance."""
    threads = SOLVE_FEW_THREADS if B <= SOLVE_FEW_INSTANCES else 128
    return threads, solve_smem_bytes(n)


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def gmv_smem_bytes(cols: int, rows_per_tile: int) -> int:
    """Shared memory of the staged G product: the mbarrier, a stage of
    ``rows_per_tile`` x ``cols`` with up to three floats of alignment, x's
    ``cols`` and the tile's results."""
    return 16 + 4 * (_round4(rows_per_tile * cols + 3) + cols
                     + rows_per_tile)


def gmv_geometry(B: int, m: int, n: int) -> tuple[int, int, int]:
    """``(rows per tile, columns per stage, shared-memory bytes per CTA)``
    of the G product: one CTA per tile, ``ceil(m / rows)`` tiles per
    instance, each staged ``cols`` columns at a time (``cols = n`` unless a
    row is wider than a stage, and then one row per tile)."""
    stage = GMV_STAGE_BYTES // 4 - 3
    cols = min(n, stage)
    rows = max(1, stage // n)
    tiles_wanted = -(-GMV_MIN_CTAS // B)
    rows = min(m, rows, max(4, -(-m // tiles_wanted)))
    rows = -(-m // -(-m // rows))            # tiles of (nearly) equal rows
    return rows, cols, gmv_smem_bytes(cols, rows)


def fits_chol_smem(n: int) -> bool:
    """Whether one instance's n x n matrix fits the factor and solve
    kernels' shared memory (n < 240)."""
    return max(chol_smem_bytes(n), solve_smem_bytes(n)) <= SMEM_LIMIT_BYTES


def check_chol_smem_gate(n: int) -> int:
    """The dense factor / solve kernels hold one instance's matrix in a
    block's shared memory; a matrix beyond it (n >= 240, e.g. hp = 64 with 4
    vehicles, n = 257) is refused: ``kkt="auto"`` with a banded stage
    statement takes the banded KKT path there."""
    need = max(chol_smem_bytes(n), solve_smem_bytes(n))
    if need > SMEM_LIMIT_BYTES:
        raise NotImplementedError(
            f"the dense Cholesky kernels need {need} bytes of shared memory "
            f"per instance at n={n} (limit {SMEM_LIMIT_BYTES}): a dense "
            f"alternative to the banded KKT path not ported yet at this "
            f"size (kkt='auto' with a stage statement takes the banded "
            f"path)")
    return need


def _launch(name, symbol, first, *args):
    _cuda_build.launch(symbol, _ARGTYPES[symbol], first, *args)
    launch_counts[name] += 1


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of a batch of SPD matrices."""
    B, n = K.shape[0], K.shape[-1]
    if not _cuda_build.check_operands("cholesky", [(K, (B, n, n))]):
        return linalg.cholesky_plain(K)
    check_chol_smem_gate(n)
    L = torch.empty_like(K)
    _launch("cholesky", "chol_batched_launch", K, K.data_ptr(), L.data_ptr(),
            B, n, *chol_geometry(B, n))
    return L


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``(L L^T) x = b`` against :func:`cholesky`'s factors."""
    B, n = b.shape
    if not _cuda_build.check_operands("cho_solve",
                                      [(L, (B, n, n)), (b, (B, n))]):
        return linalg.cho_solve_plain(L, b)
    check_chol_smem_gate(n)
    x = torch.empty_like(b)
    _launch("cho_solve", "cho_solve_batched_launch", L, L.data_ptr(),
            b.data_ptr(), x.data_ptr(), B, n, *solve_geometry(B, n))
    return x


def gmv(G: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[b] = G_b @ x_b``."""
    B, m, n = G.shape
    if not _cuda_build.check_operands("gmv",
                                      [(G, (B, m, n)), (x, (B, n))]):
        return linalg.gmv_plain(G, x)
    out = torch.empty((B, m), dtype=G.dtype, device=G.device)
    _launch("gmv", "gmv_batched_launch", G, G.data_ptr(), x.data_ptr(),
            out.data_ptr(), B, m, n, *gmv_geometry(B, m, n))
    return out


def gtmv(G: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``out[b] = G_b^T @ v_b``."""
    B, m, n = G.shape
    if not _cuda_build.check_operands("gtmv",
                                      [(G, (B, m, n)), (v, (B, m))]):
        return linalg.gtmv_plain(G, v)
    out = torch.empty((B, n), dtype=G.dtype, device=G.device)
    _launch("gtmv", "gtmv_batched_launch", G, G.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, m, n)
    return out
