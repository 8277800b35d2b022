"""The banded (Riccati) sweeps' Hopper kernels: wrappers of
``csrc/riccati.cu``, counterparts of ``scp_tpu/ops/pallas_riccati.py``
``riccati_factor_lane`` and ``riccati_solve_lane``.

* :func:`riccati_factor` ``a_blk (B, V, NX, NX), b_blk (B, V, NX), hy (B, K,
  2V, 2V), hu (B, K, V) -> (f (B, K, V, V, NX), lh (B, K, V, V), kg (B, K,
  V, V, NX))``: the backward sweep.
* :func:`riccati_solve` ``f, lh, kg, a_blk, b_blk, r -> du`` of ``r``'s
  shape: ``r (B, K, V)`` is one right-hand side, ``r (2, B, K, V)`` two
  against the same factor in one launch (the two chains interleaved).

Each sweep has two tiers, chosen from the shape alone (:func:`factor_tier`,
:func:`solve_tier`; ``tier=`` forces one):

* ``"shared"``: one warp per instance, up to four instances a CTA, the
  instance's matrices (factor) or its rings of stage slots (solve) in
  shared memory, the solve's substitutions in registers: V <= 24 while the
  carve fits a block (:func:`factor_geometry` / :func:`solve_geometry`
  give the launch, instances per CTA, threads and shared-memory bytes per
  CTA, that the launchers check);
* ``"device"``: one CTA of :data:`DEVICE_THREADS` threads per instance and
  any V: the factor's two W x W cost-to-go buffers in a device-memory
  workspace the wrapper allocates, the rest in shared memory while it fits
  (:func:`factor_device_geometry` / :func:`solve_device_geometry`).

Type rule: float32 CUDA tensors (contiguous) always go to a hand-written
kernel; a failing build, load or launch raises. float64 CUDA tensors are
refused with ``TypeError`` and never routed to the plain version quietly. CPU
tensors, of either type, take the plain versions of ``ops/riccati.py``
whatever the tier. Each wrapper counts its launches by tier.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from scp_tpu_torch.config import NX
from scp_tpu_torch.ops import _cuda_build, riccati
from scp_tpu_torch.ops._cuda_build import SMEM_LIMIT_BYTES

# Launches of each CUDA kernel since the last reset (incremented where the
# kernel is launched and nowhere else).
launch_counts = {"riccati_factor": 0, "riccati_solve": 0,
                 "riccati_factor_device": 0, "riccati_solve_device": 0}

# csrc/riccati.cu's shared tier: instances (warps) per CTA at most, the
# widest V of the register kernels, the widest V of the generic ones (the
# solve's register arrays), the solve's ring depths
MAX_WARPS = 4
REG_MAX_V = 5
MAX_V = 24
RING_REG, RING_GEN = 8, 4
# instances per CTA: enough CTAs to reach every SM first
NUM_SMS = 132
# the device tier: threads of the CTA that owns an instance, and the shared
# memory its small part may take before it moves into the workspace (a
# check may lower it to run the workspace instantiations at a small V)
DEVICE_THREADS = 256
DEVICE_SMEM_BYTES = SMEM_LIMIT_BYTES
TIERS = ("shared", "device")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
# each launcher's parameters, as its ``extern "C"`` definition in
# csrc/riccati.cu lists them (pointers, ints, the shared-memory bytes as a
# long, the stream last)
_ARGTYPES = {
    "riccati_factor_launch": [_P] * 7 + [_I, _I, _I, _I, _L, _P],
    "riccati_solve_launch": [_P] * 7 + [_I, _I, _I, _I, _I, _L, _P],
    # a, b, hy, hu, f, lh, kg, ws; B, V, K, smem_small; smem_bytes; stream
    "riccati_factor_device_launch": [_P] * 8 + [_I] * 4 + [_L, _P],
    # f, lh, kg, a, b, r, du, ws; B, V, K, n_rhs, smem_small; smem_bytes;
    # stream
    "riccati_solve_device_launch": [_P] * 8 + [_I] * 5 + [_L, _P],
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
    """The shared tier's gate: the factor holds one instance's matrices in
    shared memory (W x W ones above REG_MAX_V) and V <= MAX_V; a vehicle
    count beyond either is refused there (the device tier takes it).
    Returns the bytes per instance."""
    need = factor_smem_bytes(V)
    if V > MAX_V or need > SMEM_LIMIT_BYTES:
        raise NotImplementedError(
            f"the Riccati factor kernel's shared tier takes V <= {MAX_V} and "
            f"needs {need} bytes of shared memory per instance at V={V} "
            f"(limit {SMEM_LIMIT_BYTES}); its device tier (tier='device' or "
            f"none) takes any V")
    return need


def check_solve_smem_gate(V: int, K: int, n_rhs: int = 1) -> int:
    """The solve's shared-tier gate: its register arrays hold V <= MAX_V,
    and one instance's rings and kff must fit a block's shared memory."""
    need = solve_smem_bytes(V, K, n_rhs)
    if V > MAX_V or need > SMEM_LIMIT_BYTES:
        raise NotImplementedError(
            f"the Riccati solve kernel's shared tier takes V <= {MAX_V} and "
            f"needs {need} bytes of shared memory per instance at V={V}, "
            f"K={K}, {n_rhs} right-hand side(s) (limit {SMEM_LIMIT_BYTES}); "
            f"its device tier (tier='device' or none) takes any shape")
    return need


class DeviceGeometry(NamedTuple):
    """The device tier's launch for one instance (one CTA of
    DEVICE_THREADS): ``smem_bytes`` of dynamic shared memory (0 when the
    small part lives in the workspace), ``workspace_floats`` of device
    memory and ``smem_small``: whether the small part (the factor's A, B,
    Hm, L, 1 / diag(L) and Kg; the solve's vectors) is in shared memory."""
    smem_bytes: int
    workspace_floats: int
    smem_small: bool


def factor_device_geometry(V: int) -> DeviceGeometry:
    """K6's device tier at V (mirrors ``csrc/riccati.cu``'s
    ``factor_dev_small_words`` / ``factor_dev_ws_words``): two W x W
    cost-to-go buffers an instance in the workspace; A and B (42 V), Hm and
    L (V x V each), 1 / diag(L) (V) and Kg (V x W) in shared memory while
    they fit :data:`DEVICE_SMEM_BYTES` (a block: V <= 82), else after the
    buffers in the workspace."""
    W = V * NX
    small = (_round4(42 * V) + _round4(2 * V * V + V)
             + _round4(6 * V * V))
    fits = 4 * small <= DEVICE_SMEM_BYTES
    return DeviceGeometry(4 * small if fits else 0,
                          2 * W * W + (0 if fits else small), fits)


def solve_device_geometry(V: int, n_rhs: int = 1) -> DeviceGeometry:
    """K7's device tier at V with ``n_rhs`` right-hand sides (mirrors
    ``solve_dev_words``): lam / x of each right-hand side twice, the
    running sums, kff and u of each, 1 / diag(L); in shared memory while
    they fit (V <= 1,874 with two right-hand sides), else in the
    workspace. The factor is read from device memory, whatever K."""
    words = _round4(2 * n_rhs * V * NX + 3 * n_rhs * V + V)
    fits = 4 * words <= DEVICE_SMEM_BYTES
    return DeviceGeometry(4 * words if fits else 0, 0 if fits else words,
                          fits)


def _check_tier(tier):
    if tier not in (None,) + TIERS:
        raise ValueError(f"unknown tier {tier!r}; one of {TIERS}")


def factor_tier(V: int, tier: str | None = None) -> str:
    """The factor's tier at V: ``"shared"`` where the warp kernels hold it
    (V <= 24), else ``"device"``; a forced ``tier`` is checked, and the
    shared tier past its gate raises ``NotImplementedError``."""
    _check_tier(tier)
    if tier == "shared":
        check_factor_smem_gate(V)
    if tier is not None:
        return tier
    return ("shared" if V <= MAX_V and factor_smem_bytes(V) <= SMEM_LIMIT_BYTES
            else "device")


def solve_tier(V: int, K: int, n_rhs: int = 1,
               tier: str | None = None) -> str:
    """The solve's tier: ``"shared"`` where a warp's rings and kff fit a
    block and its registers hold V (V <= 24), else ``"device"``; a forced
    ``tier`` as in :func:`factor_tier`."""
    _check_tier(tier)
    if tier == "shared":
        check_solve_smem_gate(V, K, n_rhs)
    if tier is not None:
        return tier
    return ("shared" if V <= MAX_V
            and solve_smem_bytes(V, K, n_rhs) <= SMEM_LIMIT_BYTES
            else "device")


def _launch(name, symbol, first, *args):
    _cuda_build.launch(symbol, _ARGTYPES[symbol], first, *args)
    launch_counts[name] += 1


def riccati_factor(a_blk, b_blk, hy, hu, tier: str | None = None):
    """Backward Riccati sweep; returns ``(f, lh, kg)``. ``tier`` forces
    ``"shared"`` or ``"device"`` on the card (:func:`factor_tier`)."""
    B, V = a_blk.shape[:2]
    K = hy.shape[1]
    _check_tier(tier)
    if not _cuda_build.check_operands("riccati_factor", [
            (a_blk, (B, V, NX, NX)), (b_blk, (B, V, NX)),
            (hy, (B, K, 2 * V, 2 * V)), (hu, (B, K, V))]):
        return tuple(riccati.riccati_factor_plain(a_blk, b_blk, hy, hu))
    t = factor_tier(V, tier)
    f = torch.empty((B, K, V, V, NX), dtype=hy.dtype, device=hy.device)
    lh = torch.empty((B, K, V, V), dtype=hy.dtype, device=hy.device)
    kg = torch.empty_like(f)
    if t == "shared":
        ipc, _, smem = factor_geometry(B, V)
        _launch("riccati_factor", "riccati_factor_launch", hy,
                a_blk.data_ptr(), b_blk.data_ptr(), hy.data_ptr(),
                hu.data_ptr(), f.data_ptr(), lh.data_ptr(), kg.data_ptr(), B,
                V, K, ipc, smem)
        return f, lh, kg
    g = factor_device_geometry(V)
    ws = torch.empty((B, g.workspace_floats), dtype=hy.dtype,
                     device=hy.device)
    _launch("riccati_factor_device", "riccati_factor_device_launch", hy,
            a_blk.data_ptr(), b_blk.data_ptr(), hy.data_ptr(), hu.data_ptr(),
            f.data_ptr(), lh.data_ptr(), kg.data_ptr(), ws.data_ptr(), B, V,
            K, int(g.smem_small), g.smem_bytes)
    return f, lh, kg


def riccati_solve(f, lh, kg, a_blk, b_blk, r, tier: str | None = None):
    """Banded solve for ``r (B, K, V)`` or two right-hand sides ``r (2, B,
    K, V)`` against one factor; returns ``du`` of ``r``'s shape. ``tier``
    forces ``"shared"`` or ``"device"`` on the card (:func:`solve_tier`)."""
    if r.ndim not in (3, 4) or (r.ndim == 4 and r.shape[0] not in (1, 2)):
        raise ValueError(f"riccati_solve: r of shape {tuple(r.shape)}, want "
                         f"(B, K, V) or (n_rhs <= 2, B, K, V)")
    _check_tier(tier)
    B, K, V = r.shape[-3:]
    n_rhs = r.shape[0] if r.ndim == 4 else 1
    if not _cuda_build.check_operands("riccati_solve", [
            (r, r.shape[:-3] + (B, K, V)), (f, (B, K, V, V, NX)),
            (lh, (B, K, V, V)), (kg, (B, K, V, V, NX)),
            (a_blk, (B, V, NX, NX)), (b_blk, (B, V, NX))]):
        return riccati.riccati_solve_plain(f, lh, kg, a_blk, b_blk, r)
    t = solve_tier(V, K, n_rhs, tier)
    du = torch.empty_like(r)
    if t == "shared":
        ipc, _, smem = solve_geometry(B, V, K, n_rhs)
        _launch("riccati_solve", "riccati_solve_launch", r,
                f.data_ptr(), lh.data_ptr(), kg.data_ptr(), a_blk.data_ptr(),
                b_blk.data_ptr(), r.data_ptr(), du.data_ptr(), B, V, K, n_rhs,
                ipc, smem)
        return du
    g = solve_device_geometry(V, n_rhs)
    ws = None if g.smem_small else torch.empty(
        (B, g.workspace_floats), dtype=r.dtype, device=r.device)
    _launch("riccati_solve_device", "riccati_solve_device_launch", r,
            f.data_ptr(), lh.data_ptr(), kg.data_ptr(), a_blk.data_ptr(),
            b_blk.data_ptr(), r.data_ptr(), du.data_ptr(),
            None if ws is None else ws.data_ptr(), B, V, K, n_rhs,
            int(g.smem_small), g.smem_bytes)
    return du
