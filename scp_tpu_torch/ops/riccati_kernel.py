"""The banded (Riccati) sweeps' Hopper kernels: wrappers of
``csrc/riccati.cu``, counterparts of ``scp_tpu/ops/pallas_riccati.py``
``riccati_factor_lane`` and ``riccati_solve_lane``.

* :func:`riccati_factor` ``a_blk (B, V, NX, NX), b_blk (B, V, NX), hy (B, K,
  2V, 2V), hu (B, K, V) -> (f (B, K, V, V, NX), lh (B, K, V, V), kg (B, K,
  V, V, NX))``: the backward sweep (one CTA per instance).
* :func:`riccati_solve` ``f, lh, kg, a_blk, b_blk, r (B, K, V) -> du (B, K,
  V)``: one right-hand side, backward sweep then forward rollout (one warp
  per instance).

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

# instances per CTA of the solve kernel (csrc/riccati.cu::kSolveWarps)
SOLVE_WARPS = 4

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_ARGTYPES = {
    "riccati_factor_launch": [_P] * 7 + [_I, _I, _I, _L, _P],
    "riccati_solve_launch": [_P] * 7 + [_I, _I, _I, _L, _P],
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def factor_smem_bytes(V: int) -> int:
    """Dynamic shared memory of the factor kernel for V vehicles: the
    cost-to-go and two W x W scratch matrices (odd leading dimension), T, F,
    Kg, Hm, Lh, A and B."""
    W = V * NX
    return 4 * (3 * W * (W | 1) + 3 * V * W + 2 * V * V + V * NX * NX
                + V * NX)


def solve_smem_bytes(V: int) -> int:
    """Dynamic shared memory of the solve kernel (one CTA of SOLVE_WARPS
    instances)."""
    W = V * NX
    return 4 * SOLVE_WARPS * (3 * W + 2 * V + V * V + V * NX * NX + V * NX)


def check_factor_smem_gate(V: int) -> int:
    """The factor holds one instance's W x W matrices (W = 6V) in a block's
    shared memory; a vehicle count beyond it is refused."""
    need = factor_smem_bytes(V)
    if need > SMEM_LIMIT_BYTES:
        raise NotImplementedError(
            f"the Riccati factor kernel needs {need} bytes of shared memory "
            f"per instance at V={V} (limit {SMEM_LIMIT_BYTES})")
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
    need = check_factor_smem_gate(V)
    f = torch.empty((B, K, V, V, NX), dtype=hy.dtype, device=hy.device)
    lh = torch.empty((B, K, V, V), dtype=hy.dtype, device=hy.device)
    kg = torch.empty_like(f)
    _launch("riccati_factor", "riccati_factor_launch", hy,
            a_blk.data_ptr(), b_blk.data_ptr(), hy.data_ptr(), hu.data_ptr(),
            f.data_ptr(), lh.data_ptr(), kg.data_ptr(), B, V, K, need)
    return f, lh, kg


def riccati_solve(f, lh, kg, a_blk, b_blk, r):
    """Banded solve for one right-hand side ``r (B, K, V)``; returns
    ``du (B, K, V)``."""
    B, K, V = r.shape
    if not _cuda_build.check_operands("riccati_solve", [
            (r, (B, K, V)), (f, (B, K, V, V, NX)), (lh, (B, K, V, V)),
            (kg, (B, K, V, V, NX)), (a_blk, (B, V, NX, NX)),
            (b_blk, (B, V, NX))]):
        return riccati.riccati_solve_plain(f, lh, kg, a_blk, b_blk, r)
    need = solve_smem_bytes(V)
    if need > SMEM_LIMIT_BYTES:
        raise NotImplementedError(
            f"the Riccati solve kernel needs {need} bytes of shared memory "
            f"at V={V} (limit {SMEM_LIMIT_BYTES})")
    du = torch.empty_like(r)
    _launch("riccati_solve", "riccati_solve_launch", r,
            f.data_ptr(), lh.data_ptr(), kg.data_ptr(), a_blk.data_ptr(),
            b_blk.data_ptr(), r.data_ptr(), du.data_ptr(), B, V, K, need)
    return du
