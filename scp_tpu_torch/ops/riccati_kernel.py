"""The banded (Riccati) sweeps' Hopper kernels: wrappers of
``csrc/riccati.cu``, counterparts of ``scp_tpu/ops/pallas_riccati.py``
``riccati_factor_lane`` and ``riccati_solve_lane``.

* :func:`riccati_factor` ``a_blk (B, V, NX, NX), b_blk (B, V, NX), hy (B, K,
  2V, 2V), hu (B, K, V) -> (f (B, K, V, V, NX), lh (B, K, V, V), kg (B, K,
  V, V, NX))``: the backward sweep (one warp per instance).
* :func:`riccati_solve` ``f, lh, kg, a_blk, b_blk, r -> du`` of ``r``'s
  shape: ``r (B, K, V)`` is one right-hand side, ``r (2, B, K, V)`` two
  against the same factor in one launch (one warp per instance, the two
  chains interleaved).

:func:`factor_geometry` / :func:`solve_geometry` give the launch (instances
per CTA, threads, shared-memory bytes per CTA) that the launchers check.

Type rule: float32 CUDA tensors (contiguous) always go to the hand-written
kernel; a failing build, load or launch raises. float64 CUDA tensors are
refused with ``TypeError`` and never routed to the plain version quietly. CPU
tensors, of either type, take the plain versions of ``ops/riccati.py``. Each
wrapper counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from scp_tpu_torch.config import NX
from scp_tpu_torch.ops import _cuda_build, riccati
from scp_tpu_torch.ops._cuda_build import SMEM_LIMIT_BYTES

# Launches of each CUDA kernel since the last reset (incremented where the
# kernel is launched and nowhere else).
launch_counts = {"riccati_factor": 0, "riccati_solve": 0}

# csrc/riccati.cu: instances (warps) per CTA at most, the widest V of the
# register kernels, the widest V of the generic ones, the solve's ring depths
MAX_WARPS = 4
REG_MAX_V = 5
MAX_V = 24
RING_REG, RING_GEN = 8, 4
# instances per CTA: enough CTAs to reach every SM first
NUM_SMS = 132

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_ARGTYPES = {
    "riccati_factor_launch": [_P] * 7 + [_I, _I, _I, _I, _L, _P],
    "riccati_solve_launch": [_P] * 7 + [_I, _I, _I, _I, _I, _L, _P],
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _row_ld(w: int) -> int:
    return _round4(w) + 4 if _round4(w) % 8 == 0 else _round4(w)


def factor_smem_bytes(V: int) -> int:
    """Dynamic shared memory of one factor instance (warp) for V vehicles.
    V <= REG_MAX_V (rows of Pt in registers): the exchanges of T^T and Hm
    (rows padded to 4), of Kg's rows (padded to 4), of Pt and Y (rows of
    ``_row_ld(W)``), A and B.
    Above: hy / hu staged, Pt and X (W x W), T, F, Kg (W x V), all with odd
    row strides, Hm, Lh, the pivots' reciprocals, hu, A and B."""
    W = V * NX
    if V <= REG_MAX_V:
        VP = _round4(V)
        words = _round4(W * VP + V * _round4(W) + V * VP
                        + 2 * W * _row_ld(W) + 42 * V)
    else:
        words = (_round4(4 * V * V + V) + 2 * W * (W | 1) + 3 * W * (V | 1)
                 + 2 * V * V + 2 * V + 42 * V)
    return 4 * words


def solve_smem_bytes(V: int, K: int, n_rhs: int = 1) -> int:
    """Dynamic shared memory of one solve instance (warp): A and B, the lam
    / x exchange of each right-hand side, the kg ring, the ring of (f, lh,
    r) stage slots and kff / du of each right-hand side (K x V)."""
    W = V * NX
    S = RING_REG if V <= REG_MAX_V else RING_GEN
    return 4 * _round4(42 * V + n_rhs * W + S * V * W
                       + S * (V * W + V * V + n_rhs * V) + n_rhs * K * V)


def _instances_per_cta(B: int, per_instance: int) -> int:
    ipc = min(MAX_WARPS, max(1, -(-B // NUM_SMS)))
    while ipc > 1 and ipc * per_instance > SMEM_LIMIT_BYTES:
        ipc -= 1
    return ipc


def factor_geometry(B: int, V: int) -> tuple[int, int, int]:
    """``(instances per CTA, threads, shared-memory bytes per CTA)`` of the
    factor kernel: one warp per instance."""
    per = factor_smem_bytes(V)
    ipc = _instances_per_cta(B, per)
    return ipc, 32 * ipc, ipc * per


def solve_geometry(B: int, V: int, K: int,
                   n_rhs: int = 1) -> tuple[int, int, int]:
    """The same for the solve kernel with ``n_rhs`` right-hand sides."""
    per = solve_smem_bytes(V, K, n_rhs)
    ipc = _instances_per_cta(B, per)
    return ipc, 32 * ipc, ipc * per


def check_factor_smem_gate(V: int) -> int:
    """The factor holds one instance's matrices in shared memory (W x W ones
    above REG_MAX_V) and V <= MAX_V in registers; a vehicle count beyond
    either is refused. Returns the bytes per instance."""
    need = factor_smem_bytes(V)
    if V > MAX_V or need > SMEM_LIMIT_BYTES:
        raise NotImplementedError(
            f"the Riccati factor kernel takes V <= {MAX_V} and needs {need} "
            f"bytes of shared memory per instance at V={V} (limit "
            f"{SMEM_LIMIT_BYTES})")
    return need


def check_solve_smem_gate(V: int, K: int, n_rhs: int = 1) -> int:
    """The solve's gate: its register arrays hold V <= MAX_V, and one
    instance's rings and kff must fit a block's shared memory."""
    need = solve_smem_bytes(V, K, n_rhs)
    if V > MAX_V or need > SMEM_LIMIT_BYTES:
        raise NotImplementedError(
            f"the Riccati solve kernel takes V <= {MAX_V} and needs "
            f"{need} bytes of shared memory per instance at V={V}, K={K}, "
            f"{n_rhs} right-hand side(s) (limit {SMEM_LIMIT_BYTES})")
    return need


def _launch(name, symbol, first, *args):
    _cuda_build.launch(symbol, _ARGTYPES[symbol], first, *args)
    launch_counts[name] += 1


def riccati_factor(a_blk, b_blk, hy, hu):
    """Backward Riccati sweep; returns ``(f, lh, kg)``."""
    B, V = a_blk.shape[:2]
    K = hy.shape[1]
    if not _cuda_build.check_operands("riccati_factor", [
            (a_blk, (B, V, NX, NX)), (b_blk, (B, V, NX)),
            (hy, (B, K, 2 * V, 2 * V)), (hu, (B, K, V))]):
        return tuple(riccati.riccati_factor_plain(a_blk, b_blk, hy, hu))
    check_factor_smem_gate(V)
    ipc, _, smem = factor_geometry(B, V)
    f = torch.empty((B, K, V, V, NX), dtype=hy.dtype, device=hy.device)
    lh = torch.empty((B, K, V, V), dtype=hy.dtype, device=hy.device)
    kg = torch.empty_like(f)
    _launch("riccati_factor", "riccati_factor_launch", hy,
            a_blk.data_ptr(), b_blk.data_ptr(), hy.data_ptr(), hu.data_ptr(),
            f.data_ptr(), lh.data_ptr(), kg.data_ptr(), B, V, K, ipc, smem)
    return f, lh, kg


def riccati_solve(f, lh, kg, a_blk, b_blk, r):
    """Banded solve for ``r (B, K, V)`` or two right-hand sides ``r (2, B,
    K, V)`` against one factor; returns ``du`` of ``r``'s shape."""
    if r.ndim not in (3, 4) or (r.ndim == 4 and r.shape[0] not in (1, 2)):
        raise ValueError(f"riccati_solve: r of shape {tuple(r.shape)}, want "
                         f"(B, K, V) or (n_rhs <= 2, B, K, V)")
    B, K, V = r.shape[-3:]
    n_rhs = r.shape[0] if r.ndim == 4 else 1
    if not _cuda_build.check_operands("riccati_solve", [
            (r, r.shape[:-3] + (B, K, V)), (f, (B, K, V, V, NX)),
            (lh, (B, K, V, V)), (kg, (B, K, V, V, NX)),
            (a_blk, (B, V, NX, NX)), (b_blk, (B, V, NX))]):
        return riccati.riccati_solve_plain(f, lh, kg, a_blk, b_blk, r)
    check_solve_smem_gate(V, K, n_rhs)
    ipc, _, smem = solve_geometry(B, V, K, n_rhs)
    du = torch.empty_like(r)
    _launch("riccati_solve", "riccati_solve_launch", r,
            f.data_ptr(), lh.data_ptr(), kg.data_ptr(), a_blk.data_ptr(),
            b_blk.data_ptr(), r.data_ptr(), du.data_ptr(), B, V, K, n_rhs,
            ipc, smem)
    return du
