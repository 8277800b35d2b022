"""Fused IPM iterations: the Hopper kernels' wrappers and their plain PyTorch
versions (counterparts of ``scp_tpu/ops/pallas_linalg.py::
ipm_iterate_lane_struct`` and ``ipm_iterate_lane``).

:func:`ipm_iterate_struct` (K1, ``csrc/ipm_struct.cu``) is described first;
:func:`ipm_iterate_dense` (K2, ``csrc/ipm_dense.cu``) runs the same
iterations on a dense G, forming ``G^T W G`` itself (see its docstring).
Both kernels share their step algebra (``csrc/ipm_common.cuh``), and so do
the plain versions (:func:`_plain_step`).

All ``n_iters`` Mehrotra predictor-corrector iterations of every QP of a
batch run in one call: slab matvecs, the analytic KKT diagonal, the
Jacobi-scaled KKT matrix formed from the pair / obstacle row slabs + the
block-diagonal P + the box diagonal, a rank-1 Schur elimination of the slack
variable, a Cholesky on ``nu = n - 1`` columns, predictor + corrector
(+ ``n_cor`` Gondzio correctors), step lengths, ``sigma = (mu_aff/mu)^3``,
the exact ``(1 - alpha)`` primal-residual recurrence and per-instance
freeze on stall / convergence / non-finite steps.

Tensors are instance-major (``(B, ...)`` contiguous per instance); none of
the TPU tiling (lane layout, ``hu8`` / ``mg_pad`` / ``n_pad`` padding, row
masks) exists here. Argument layout, with ``n = V*hu + 1`` (the slack is the
last variable), ``mg = (P + S) * hp``:

* ``gi, gj (B, P, hp, hu)`` — pair rows restricted to the pair's two vehicle
  blocks; ``gob (B, S, hp, hu)`` or ``None`` — single-block (obstacle)
  slabs; ``gsl (B, mg)`` — the equilibrated slack column (0 = hard row);
* ``pb (B, V, hu, hu)`` — block-diagonal P; ``q, pdiag (B, n)``;
* state ``x, su, sl, zu, zl, rpu, rpl (B, n)``, ``sg, zg, rpg (B, mg)``,
  ``scal (B, 2) = [mu of the previous iteration, frozen flag]``;
* ``pairs`` — sequence of ``(i, j)`` vehicle pairs (i < j), ``obst_veh`` —
  the vehicle of each single-block slab.

:func:`ipm_iterate_struct` launches the CUDA kernel for CUDA tensors and
raises if it cannot; for CPU tensors it takes :func:`ipm_iterate_struct_plain`.
The kernel library is built with ``nvcc`` from ``scp_tpu_torch/csrc`` at first
use (``ops/_cuda_build.py``).

Both kernels have storage tiers, chosen by the shape alone
(:func:`struct_tier`, :func:`dense_tier`): the whole per-instance working
set in one block's shared memory (``"shared"``), or, past it, the KKT matrix
and its factor in a per-instance workspace in device memory that the
wrapper allocates (``"device"``; K1 then reads its slabs in place from the
inputs, K2 its G). Both have a third between the two (``"cluster"``):
one instance per thread block cluster of ``C`` CTAs, the KKT matrix and its
factor in the cluster's shared memory (16-row stripes dealt over the ranks,
``csrc/chol_cluster.cuh``), rank 0 holding the step's vectors and running
the step. The arithmetic is the same in every tier, but for the order in
which K2's cluster tier sums each entry of its product (it streams G
through shared memory by rows; :func:`dense_cluster_geometry`). Both have
a fourth past their device tier's own shared memory (``"global"``,
:func:`global_geometry`, :func:`dense_global_geometry`): the step's vectors
in the device-memory workspace too, before the KKT matrix. Each raises
``NotImplementedError`` only where a tier is forced at a shape it cannot
hold.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from scp_tpu_torch.ops import _cuda_build, linalg_kernel
from scp_tpu_torch.ops._cuda_build import SMEM_LIMIT_BYTES
from scp_tpu_torch.utils import timing

# Launches of the structured kernel (K1) and of the dense-G kernel (K2) in
# their shared-memory tier, of each in its device, its cluster and its
# global tier, since the last reset (incremented where each kernel is
# launched and nowhere else).
launch_count = 0
dense_launch_count = 0
device_launch_count = 0
dense_device_launch_count = 0
cluster_launch_count = 0
dense_cluster_launch_count = 0
global_launch_count = 0
dense_global_launch_count = 0

# K1's and K2's cluster tiers: the cluster sizes tried, smallest first (the
# first whose ranks each hold their carve is taken). A cluster holds one
# instance on C SMs, so at a batch that fills the card the smallest wins.
STRUCT_CLUSTER_SIZES = (2, 4, 8)
DENSE_CLUSTER_SIZES = (2, 4, 8)
TIERS = ("shared", "cluster", "device", "global")
DENSE_TIERS = ("shared", "cluster", "device", "global")
# G rows a stage of K2's cluster tier streams (csrc/ipm_dense.cu::
# kGStageRows)
DENSE_STAGE_ROWS = 16
# The preferred carve-out of the SM's unified L1 / shared memory for K2's
# global tier, in percent of it as shared memory (-1: the CUDA
# default): the largest L1, since its CTAs take 132 bytes of shared memory
# and read G, the factor and the vectors through L1 (chip_smoke.py path
# (o2) times both ends; PERF.md). It changes no result.
DENSE_GLOBAL_CARVEOUT = 0

_tables: dict = {}


def reset_launch_count() -> None:
    global launch_count, dense_launch_count, cluster_launch_count
    global device_launch_count, dense_device_launch_count
    global dense_cluster_launch_count, global_launch_count
    global dense_global_launch_count
    launch_count = 0
    dense_launch_count = 0
    device_launch_count = 0
    dense_device_launch_count = 0
    cluster_launch_count = 0
    dense_cluster_launch_count = 0
    global_launch_count = 0
    dense_global_launch_count = 0


class Tier(NamedTuple):
    """Where a fused kernel keeps an instance's working set: ``tier`` is
    ``"shared"`` (all of it in the block's shared memory), ``"cluster"``
    (the KKT matrix in the stripes of a thread block cluster,
    :func:`cluster_geometry`, :func:`dense_cluster_geometry`),
    ``"device"`` (the KKT matrix and its factor in a device-memory
    workspace of ``workspace_floats`` floats per instance, 0 in the shared
    and cluster tiers) or ``"global"`` (the step's vectors and the KKT
    matrix after them in a device-memory workspace of ``workspace_floats``
    floats per instance: :func:`global_geometry` / :func:`global_layout`,
    :func:`dense_global_geometry` / :func:`dense_global_layout`);
    ``smem_bytes``: the
    launch's dynamic shared memory per CTA; ``g_smem``: K2's G in shared
    memory (False for K1)."""
    tier: str
    smem_bytes: int
    workspace_floats: int
    g_smem: bool = False



def kkt_ld(nk: int, device: bool) -> int:
    """Leading dimension of the factored KKT matrix (``nk`` columns): odd in
    shared memory, a multiple of 32 floats (128-byte rows) in the device
    tier's workspace (``csrc/ipm_struct.cu::kkt_ld``,
    ``ipm_dense.cuh::dense_kkt_ld``)."""
    return (nk + 31) // 32 * 32 if device else nk | 1


# Floats of the fused kernels' block-reduction scratch
# (``csrc/ipm_common.cuh::kRedWords``).
_RED_WORDS = 32


def slab_words(hp: int, hu: int, lower_tri: bool) -> int:
    """Floats of one slab in the structured kernel's shared memory: whole
    rows of ``hu``, or with ``lower_tri`` row ``k`` packed to its
    ``min(k + 1, hu)`` leading entries (``csrc/ipm_struct.cu::
    slab_words``)."""
    if not lower_tri:
        return hp * hu
    return sum(min(k + 1, hu) for k in range(hp))


def smem_bytes(P: int, S: int, hp: int, hu: int, V: int,
               lower_tri: bool = False, device: bool = False) -> int:
    """Dynamic shared memory of the kernel for a shape in a tier (mirrors
    the carve in ``csrc/ipm_struct.cu::smem_words``): in the shared tier the
    factor, the slabs and the rest; in the device tier (``device``) the rest
    alone — the vectors, the P blocks, the slack column and the index
    tables. Lower-triangular slabs are stored packed in shared memory, so
    ``lower_tri`` only ever takes bytes off."""
    nu = V * hu
    n = nu + 1
    mg = (P + S) * hp
    m = mg + 2 * n
    words = (V * hu * hu + mg + 9 * m + 9 * n + _RED_WORDS
             + V * V + 2 * P + S + 1)
    if not device:
        words += nu * kkt_ld(nu, False) \
            + (2 * P + S) * slab_words(hp, hu, lower_tri)
    return 4 * words


def fits_smem(P: int, S: int, hp: int, hu: int, V: int,
              lower_tri: bool = False) -> bool:
    """Whether the structured kernel's whole per-instance working set fits
    a block's shared memory (its shared tier) with the slabs as the launch
    stores them (packed with ``lower_tri``); the ``kkt="auto"`` route takes
    the banded KKT path past it when a stage statement is given."""
    return smem_bytes(P, S, hp, hu, V, lower_tri) <= SMEM_LIMIT_BYTES


def cluster_smem_bytes(P: int, S: int, hp: int, hu: int, V: int, C: int,
                       area_words: int) -> int:
    """Dynamic shared memory of a rank of the cluster tier (mirrors
    ``csrc/ipm_struct.cu::cluster_smem_words``): the device tier's carve,
    from the next 16-byte boundary the cluster factor's buffers
    (``linalg_kernel.stripe_buffer_words``), the deal (two ints a stripe)
    and, at an even word, the factor's row pointers (8 bytes a row)."""
    nu = V * hu
    ns = -(-nu // linalg_kernel.CHOL_STRIPE)
    base = -(-smem_bytes(P, S, hp, hu, V, device=True) // 16) * 4
    words = base + linalg_kernel.stripe_buffer_words(nu, C, area_words) \
        + 2 * ns
    return 4 * ((words + 1) // 2 * 2 + 2 * nu)


def cluster_geometry(P: int, S: int, hp: int, hu: int,
                     V: int) -> tuple[int, int, int] | None:
    """``(C, area words, shared-memory bytes per CTA)`` of K1's cluster
    tier at a shape: the first of :data:`STRUCT_CLUSTER_SIZES` whose ranks
    each hold the device tier's carve and their share of the stripes of
    the ``nu x nu`` KKT matrix (``linalg_kernel.stripe_deal``), or
    None."""
    nu = V * hu
    for C in STRUCT_CLUSTER_SIZES:
        area = linalg_kernel.stripe_deal(nu, C)[2]
        need = cluster_smem_bytes(P, S, hp, hu, V, C, area)
        if need <= SMEM_LIMIT_BYTES:
            return C, area, need
    return None


def global_smem_bytes(P: int, S: int, hp: int, hu: int, V: int) -> int:
    """Dynamic shared memory of a CTA of K1's global tier (mirrors
    ``csrc/ipm_struct.cu::global_smem_words``): the reduction scratch, the
    index tables and the failure flag."""
    return 4 * (_RED_WORDS + V * V + 2 * P + S + 1)


def global_layout(P: int, S: int, hp: int, hu: int,
                  V: int) -> dict[str, tuple[int, int]]:
    """``name -> (offset, floats)`` of one instance's slot of K1's global
    workspace (mirrors ``csrc/ipm_struct.cu::carve_global``): the nine
    m-vectors, the seven n-vectors, and the ``nu x ldk`` KKT matrix ``K``
    from the vectors' end rounded up to 32 floats. The P blocks, the slack
    column, ``q`` and ``pdiag`` are read in place from the inputs."""
    nu = V * hu
    n = nu + 1
    m = (P + S) * hp + 2 * n
    names = [(k, m) for k in ("s", "z", "rp", "w", "a1", "a2", "a3", "dz",
                              "ds")]
    names += [(k, n) for k in ("x", "px", "dsc", "kb", "rhs", "dx", "dinv")]
    out, at = {}, 0
    for k, size in names:
        out[k] = (at, size)
        at += size
    out["K"] = (-(-at // 32) * 32, nu * kkt_ld(nu, True))
    return out


class GlobalGeometry(NamedTuple):
    """K1's or K2's global tier at a shape: ``smem_bytes`` a CTA (one an
    instance); ``vec_floats`` (the vectors, rounded up to 32) and
    ``workspace_floats`` (the vectors and the KKT matrix) an instance."""
    smem_bytes: int
    vec_floats: int
    workspace_floats: int


def global_geometry(P: int, S: int, hp: int, hu: int,
                    V: int) -> GlobalGeometry:
    """K1's global tier at a shape (:func:`global_smem_bytes`,
    :func:`global_layout`)."""
    off, size = global_layout(P, S, hp, hu, V)["K"]
    return GlobalGeometry(global_smem_bytes(P, S, hp, hu, V), off,
                          off + size)


def _global_tier(P, S, hp, hu, V) -> Tier:
    g = global_geometry(P, S, hp, hu, V)
    if g.smem_bytes > SMEM_LIMIT_BYTES:
        raise NotImplementedError(
            f"the fused structured IPM kernel's global tier needs "
            f"{g.smem_bytes} bytes of shared memory a CTA (its index "
            f"tables) at P={P}, S={S}, V={V}; limit {SMEM_LIMIT_BYTES}")
    return Tier("global", g.smem_bytes, g.workspace_floats)


def struct_tier(P: int, S: int, hp: int, hu: int, V: int,
                lower_tri: bool = False, tier: str | None = None) -> Tier:
    """The structured kernel's storage tier at a shape: the shared tier
    where :func:`fits_smem` holds, else the cluster tier where a cluster
    holds the KKT matrix (:func:`cluster_geometry`), else the device tier
    (the ``nu x ldk`` KKT matrix in a device-memory workspace, the slabs
    read in place) where its shared memory holds the vectors, else the
    global tier (the vectors in device memory too,
    :func:`global_geometry`); ``tier`` forces one of :data:`TIERS` at any
    shape it holds. Raises ``NotImplementedError``, naming the bytes, only
    where a forced tier's own shared memory exceeds a block's."""
    if tier not in (None,) + TIERS:
        raise ValueError(f"unknown tier {tier!r}")
    if tier == "global":
        return _global_tier(P, S, hp, hu, V)
    fits = fits_smem(P, S, hp, hu, V, lower_tri)
    if tier == "cluster" or (tier is None and not fits):
        cl = cluster_geometry(P, S, hp, hu, V)
        if cl is not None:
            return Tier("cluster", cl[2], 0)
        if tier == "cluster":
            raise NotImplementedError(
                f"the fused structured IPM kernel's cluster tier needs more "
                f"than {SMEM_LIMIT_BYTES} bytes of shared memory a CTA at "
                f"P={P}, S={S}, hp={hp}, hu={hu}, V={V} with "
                f"{STRUCT_CLUSTER_SIZES[-1]} CTAs")
    dev = tier == "device" or (tier is None and not fits)
    need = smem_bytes(P, S, hp, hu, V, lower_tri, dev)
    if need > SMEM_LIMIT_BYTES and tier is None:
        return _global_tier(P, S, hp, hu, V)
    if need > SMEM_LIMIT_BYTES:
        full = smem_bytes(P, S, hp, hu, V, lower_tri)
        raise NotImplementedError(
            f"the fused structured IPM kernel needs {need} bytes of shared "
            f"memory per instance in its {'device' if dev else 'shared'} "
            f"tier at P={P}, S={S}, hp={hp}, hu={hu}, V={V} ({full} with "
            f"the factor and the slabs; limit {SMEM_LIMIT_BYTES}); the "
            f"global tier (tier='global' or none) keeps the vectors in "
            f"device memory there")
    nu = V * hu
    return Tier("device" if dev else "shared", need,
                nu * kkt_ld(nu, True) if dev else 0)


def resident_ctas_per_sm(P: int, S: int, hp: int, hu: int, V: int,
                         lower_tri: bool, tier: str | None = None) -> int:
    """CTAs of the structured kernel that one SM of the current CUDA device
    holds at a shape in its tier (:func:`struct_tier`; the CUDA occupancy
    calculator, with the launch's shared memory). Needs the card: it builds
    and loads the library."""
    t = struct_tier(P, S, hp, hu, V, lower_tri, tier)
    if t.tier == "cluster":
        return cluster_occupancy(P, S, hp, hu, V, lower_tri)[0]
    if t.tier == "global":
        return global_occupancy(P, S, hp, hu, V, lower_tri)
    dev = t.tier == "device"
    fn = _cuda_build.load_library().ipm_struct_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    ctas = ctypes.c_int(0)
    err = fn(P, S, hp, hu, V, int(lower_tri), int(dev), ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(f"ipm_struct_occupancy failed with CUDA error "
                           f"{err}")
    return ctas.value


def cluster_occupancy(P: int, S: int, hp: int, hu: int, V: int,
                      lower_tri: bool) -> tuple[int, int]:
    """``(CTAs one SM holds, clusters the device holds at once)`` of K1's
    cluster tier at a shape (:func:`cluster_geometry`; the CUDA occupancy
    calculator). Needs the card."""
    C, area, _ = cluster_geometry(P, S, hp, hu, V)
    fn = _cuda_build.load_library().ipm_struct_cluster_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    ctas, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(P, S, hp, hu, V, int(lower_tri), C, area, ctypes.byref(ctas),
             ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"ipm_struct_cluster_occupancy failed with CUDA "
                           f"error {err}")
    return ctas.value, clusters.value


def global_occupancy(P: int, S: int, hp: int, hu: int, V: int,
                     lower_tri: bool) -> int:
    """CTAs of K1's global tier one SM holds at a shape (the CUDA
    occupancy calculator). Needs the card."""
    fn = _cuda_build.load_library().ipm_struct_global_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    ctas = ctypes.c_int(0)
    err = fn(P, S, hp, hu, V, int(lower_tri), ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(f"ipm_struct_global_occupancy failed with CUDA "
                           f"error {err}")
    return ctas.value


def _global_launcher():
    """The library's ``ipm_struct_global_launch`` with its argument types
    set."""
    fn = _cuda_build.load_library().ipm_struct_global_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p] * 18 + [p, p] + [p] * 11 + [p] + [i] * 9
                       + [f] * 3 + [ctypes.c_long] * 2 + [p])
        fn.restype = ctypes.c_int
    return fn


def _launcher(cluster: bool = False):
    """The library's ``ipm_struct_launch`` (``ipm_struct_cluster_launch``)
    with its argument types set."""
    lib = _cuda_build.load_library()
    fn = lib.ipm_struct_cluster_launch if cluster else lib.ipm_struct_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p] * 18 + [p, p] + [p] * 12 + [i] * (11 if cluster
                                                          else 10)
                       + [f] * 3 + [ctypes.c_long]
                       + ([] if cluster else [ctypes.c_long]) + [p])
        fn.restype = ctypes.c_int
    return fn


def _index_tables(pairs, obst_veh, device):
    key = (tuple(pairs), tuple(obst_veh), str(device))
    if key not in _tables:
        pt = torch.tensor([list(p) for p in pairs], dtype=torch.int32,
                          device=device).reshape(-1, 2).contiguous()
        ot = torch.tensor(list(obst_veh), dtype=torch.int32, device=device)
        _tables[key] = (pt, ot)
    return _tables[key]


def _check_shapes(gi, gj, gob, gsl, pb, q, pdiag, state, pairs, obst_veh):
    B, P, hp, hu = gi.shape
    V = pb.shape[1]
    S = 0 if gob is None else gob.shape[1]
    n = V * hu + 1
    mg = (P + S) * hp
    x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal = state
    want = {
        "gj": (gj, (B, P, hp, hu)), "gsl": (gsl, (B, mg)),
        "pb": (pb, (B, V, hu, hu)), "q": (q, (B, n)),
        "pdiag": (pdiag, (B, n)), "x": (x, (B, n)), "sg": (sg, (B, mg)),
        "su": (su, (B, n)), "sl": (sl, (B, n)), "zg": (zg, (B, mg)),
        "zu": (zu, (B, n)), "zl": (zl, (B, n)), "rpg": (rpg, (B, mg)),
        "rpu": (rpu, (B, n)), "rpl": (rpl, (B, n)), "scal": (scal, (B, 2)),
    }
    if gob is not None:
        want["gob"] = (gob, (B, S, hp, hu))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if t.dtype != gi.dtype or t.device != gi.device:
            raise ValueError(f"{name}: dtype/device differ from gi's")
    if len(pairs) != P or len(obst_veh) != S:
        raise ValueError("pairs / obst_veh do not match the slab counts")
    if P == 0:
        raise ValueError("the structured kernel needs at least one pair slab")
    for i, j in pairs:
        if not 0 <= i < j < V:
            raise ValueError(f"pair {(i, j)} is not i < j < V={V}")
    if any(not 0 <= v < V for v in obst_veh):
        raise ValueError("obst_veh names a vehicle outside [0, V)")
    return B, P, S, hp, hu, V, n, mg


def ipm_iterate_struct(gi, gj, gob, gsl, pb, q, pdiag,
                       x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal,
                       *, pairs, obst_veh, tol: float, reg_rel: float,
                       n_cor: int = 0, n_iters: int = 1,
                       lower_tri: bool = False, tier: str | None = None):
    """Run ``n_iters`` fused Mehrotra iterations; returns the updated
    ``(x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal)``.

    CUDA tensors (float32, contiguous) go to the hand-written kernel in the
    storage tier :func:`struct_tier` picks for the shape (``tier`` forces
    one, for checking the tiers against each other) — there is no
    fallback: a failing build, load or launch raises, and so does a
    cluster that cannot be resident. CPU tensors go to
    :func:`ipm_iterate_struct_plain`. Each call is a ``k1`` span
    (``utils.timing``) with its tier (``plain`` on the CPU) and shape.
    """
    global launch_count, device_launch_count, cluster_launch_count
    global global_launch_count
    state = (x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal)
    with timing.span("k1") as sp:
        B, P, S, hp, hu, V, n, mg = _check_shapes(
            gi, gj, gob, gsl, pb, q, pdiag, state, pairs, obst_veh)
        sp.set(B=B, P=P, S=S, hp=hp, hu=hu, V=V, n_iters=int(n_iters),
               n_cor=int(n_cor), lower_tri=bool(lower_tri))
        if gi.device.type != "cuda":
            sp.set(tier="plain")
            return ipm_iterate_struct_plain(
                gi, gj, gob, gsl, pb, q, pdiag, *state, pairs=pairs,
                obst_veh=obst_veh, tol=tol, reg_rel=reg_rel, n_cor=n_cor,
                n_iters=n_iters, lower_tri=lower_tri)
        if gi.dtype != torch.float32:
            raise TypeError(
                f"the CUDA IPM kernel is float32 only, got {gi.dtype}")
        ins = [gi, gj, gob, gsl, pb, q, pdiag, *state]
        for t in ins:
            if t is not None and not t.is_contiguous():
                raise ValueError(
                    "the CUDA IPM kernel needs contiguous tensors")
        tr = struct_tier(P, S, hp, hu, V, lower_tri, tier)
        sp.set(tier=tr.tier)
        dev = tr.tier == "device"
        pt, ot = _index_tables(pairs, obst_veh, gi.device)
        outs = [torch.empty_like(o) for o in state]
        ptr = [0 if a is None else a.data_ptr() for a in ins]
        if tr.tier == "global":
            g = global_geometry(P, S, hp, hu, V)
            ws = torch.empty((B, g.workspace_floats), dtype=torch.float32,
                             device=gi.device)
            with torch.cuda.device(gi.device):
                stream = torch.cuda.current_stream().cuda_stream
                err = _global_launcher()(
                    *ptr, pt.data_ptr(), ot.data_ptr() if S else 0,
                    *[o.data_ptr() for o in outs], ws.data_ptr(),
                    B, P, S, hp, hu, V, int(n_iters), int(n_cor),
                    int(lower_tri), float(tol), float(tol * 1e3),
                    float(reg_rel), g.smem_bytes,
                    B * g.workspace_floats, stream)
            if err != 0:
                raise RuntimeError(
                    f"ipm_struct_global_launch failed with CUDA error {err} "
                    f"(B={B}, P={P}, S={S}, hp={hp}, hu={hu}, V={V}, "
                    f"{g.smem_bytes} bytes of shared memory a CTA)")
            global_launch_count += 1
            return tuple(outs)
        if tr.tier == "cluster":
            C, area, _ = cluster_geometry(P, S, hp, hu, V)
            table = linalg_kernel.deal_tensor(
                V * hu, C, linalg_kernel.stripe_deal(V * hu, C), gi.device)
            with torch.cuda.device(gi.device):
                stream = torch.cuda.current_stream().cuda_stream
                err = _launcher(cluster=True)(
                    *ptr, pt.data_ptr(), ot.data_ptr() if S else 0,
                    *[o.data_ptr() for o in outs], table.data_ptr(),
                    B, P, S, hp, hu, V, int(n_iters), int(n_cor),
                    int(lower_tri), C, area, float(tol), float(tol * 1e3),
                    float(reg_rel), tr.smem_bytes, stream)
            if err != 0:
                why = ("no cluster can be resident" if err == -2
                       else f"CUDA error {err}")
                raise RuntimeError(
                    f"ipm_struct_cluster_launch failed: {why} (B={B}, P={P}, "
                    f"S={S}, hp={hp}, hu={hu}, V={V}, cluster of {C} CTAs, "
                    f"{tr.smem_bytes} bytes of shared memory each)")
            cluster_launch_count += 1
            return tuple(outs)
        launch = _launcher()
        ws = torch.empty((B, tr.workspace_floats), dtype=torch.float32,
                         device=gi.device) if dev else None
        with torch.cuda.device(gi.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(
                *ptr, pt.data_ptr(), ot.data_ptr() if S else 0,
                *[o.data_ptr() for o in outs], ws.data_ptr() if dev else 0,
                B, P, S, hp, hu, V, int(n_iters), int(n_cor), int(lower_tri),
                int(dev), float(tol), float(tol * 1e3), float(reg_rel),
                tr.smem_bytes, B * tr.workspace_floats, stream)
        if err != 0:
            raise RuntimeError(
                f"ipm_struct_launch failed with CUDA error {err} "
                f"(B={B}, P={P}, S={S}, hp={hp}, hu={hu}, V={V}, "
                f"tier={tr.tier}, smem={tr.smem_bytes})")
        if dev:
            device_launch_count += 1
        else:
            launch_count += 1
        return tuple(outs)


def _scatter_dense(gi, gj, gob, pairs, obst_veh, V):
    """Dense (B, mg, nu) constraint block from the slabs."""
    B, P, hp, hu = gi.shape
    S = 0 if gob is None else gob.shape[1]
    G = gi.new_zeros((B, P + S, hp, V, hu))
    for p, (i, j) in enumerate(pairs):
        G[:, p, :, i] = gi[:, p]
        G[:, p, :, j] = gj[:, p]
    for o, v in enumerate(obst_veh):
        G[:, P + o, :, v] = gob[:, o]
    return G.reshape(B, (P + S) * hp, V * hu)


def _steplen(v, dv):
    neg = dv < 0
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        inf)
    return torch.clamp(0.99 * ratio.amin(dim=1), max=1.0)


def _steplen3(vs, dvs):
    out = _steplen(vs[0], dvs[0])
    for v, dv in zip(vs[1:], dvs[1:]):
        out = torch.minimum(out, _steplen(v, dv))
    return out


def _plain_factor(K):
    """Cholesky of the scaled KKT matrices; a failed factorization poisons
    the instance (NaN), which the step's finite check turns into a freeze —
    as a NaN pivot does in a kernel."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[:, None, None],
                       torch.full_like(L, float("nan")), L)


def _plain_solver(L, dsc, kb, inv_kappa):
    """``dx = K^-1 rhs`` through the Jacobi scaling and, with a border
    ``kb`` (the eliminated slack, the last variable), the bordered
    back-substitution; ``kb=None`` factors every variable."""
    if kb is None:
        def solve_kkt(rhs):
            rt = (dsc * rhs)[:, :, None]
            return dsc * torch.cholesky_solve(rt, L)[:, :, 0]
        return solve_kkt
    nu = kb.shape[1]

    def solve_kkt(rhs):
        rt = dsc * rhs
        rw = rt[:, nu:]
        ru = rt[:, :nu] - kb * (inv_kappa * rw)
        y = torch.cholesky_solve(ru[:, :, None], L)[:, :, 0]
        xw = (rw - torch.sum(kb * y, 1, keepdim=True)) * inv_kappa
        return dsc * torch.cat([y, xw], dim=1)
    return solve_kkt


def _plain_step(state, frozen, mu_prev, *, px, q, mu, m, gmv, gtmv,
                solve_kkt, tol, n_cor):
    """One Mehrotra predictor-corrector step on a factored KKT matrix — the
    step algebra both fused kernels share (``csrc/ipm_common.cuh``): predictor,
    corrector, ``n_cor`` Gondzio correctors with per-instance acceptance,
    step lengths, ``sigma = (mu_aff / mu)^3``, the ``(1 - alpha)`` residual
    recurrence and freeze on stall / convergence / a non-finite step.
    Returns the updated state and frozen flags."""
    x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl = state
    wg, wu, wl = zg / sg, zu / su, zl / sl

    def newton(tg, tu, tl):
        rhs = -(px + q + gtmv(zg + tg) + (zu + tu) - (zl + tl))
        dx = solve_kkt(rhs)
        return dx, gmv(dx)

    # predictor
    dx_a, gdx_a = newton(wg * rpg - zg, wu * rpu - zu, wl * rpl - zl)
    dzg_a = wg * (gdx_a + rpg) - zg
    dzu_a = wu * (dx_a + rpu) - zu
    dzl_a = wl * (-dx_a + rpl) - zl
    dsg_a = -sg - sg * dzg_a / zg
    dsu_a = -su - su * dzu_a / zu
    dsl_a = -sl - sl * dzl_a / zl
    a_p = _steplen3((sg, su, sl), (dsg_a, dsu_a, dsl_a))[:, None]
    a_d = _steplen3((zg, zu, zl), (dzg_a, dzu_a, dzl_a))[:, None]
    mu_aff = (torch.sum((sg + a_p * dsg_a) * (zg + a_d * dzg_a), 1)
              + torch.sum((su + a_p * dsu_a) * (zu + a_d * dzu_a)
                          + (sl + a_p * dsl_a) * (zl + a_d * dzl_a), 1)
              ) / m
    sigma = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3
    smu = (sigma * mu)[:, None]

    # corrector
    rcg = sg * zg + dsg_a * dzg_a - smu
    rcu = su * zu + dsu_a * dzu_a - smu
    rcl = sl * zl + dsl_a * dzl_a - smu
    dx, gdx = newton(wg * rpg - rcg / sg, wu * rpu - rcu / su,
                     wl * rpl - rcl / sl)
    dzg = wg * (gdx + rpg) - rcg / sg
    dzu = wu * (dx + rpu) - rcu / su
    dzl = wl * (-dx + rpl) - rcl / sl
    dsg = -(rcg + sg * dzg) / zg
    dsu = -(rcu + su * dzu) / zu
    dsl = -(rcl + sl * dzl) / zl
    alpha = torch.minimum(
        _steplen3((sg, su, sl), (dsg, dsu, dsl)),
        _steplen3((zg, zu, zl), (dzg, dzu, dzl)))[:, None]

    # Gondzio centrality correctors with per-instance acceptance
    for _ in range(n_cor):
        at = torch.clamp(alpha + 0.1, max=1.0)
        lo, hi = 0.1 * smu, 10.0 * smu

        def drc(v):
            return v - torch.minimum(torch.maximum(v, lo), hi)

        drg_c = drc((sg + at * dsg) * (zg + at * dzg))
        dru_c = drc((su + at * dsu) * (zu + at * dzu))
        drl_c = drc((sl + at * dsl) * (zl + at * dzl))
        tg, tu, tl = -drg_c / sg, -dru_c / su, -drl_c / sl
        dxc = solve_kkt(-(gtmv(tg) + tu - tl))
        gdxc = gmv(dxc)
        dzg_c, dzu_c, dzl_c = wg * gdxc + tg, wu * dxc + tu, -wl * dxc + tl
        dsg_c = -(drg_c + sg * dzg_c) / zg
        dsu_c = -(dru_c + su * dzu_c) / zu
        dsl_c = -(drl_c + sl * dzl_c) / zl
        dx2 = dx + dxc
        dzg2, dzu2, dzl2 = dzg + dzg_c, dzu + dzu_c, dzl + dzl_c
        dsg2, dsu2, dsl2 = dsg + dsg_c, dsu + dsu_c, dsl + dsl_c
        alpha2 = torch.minimum(
            _steplen3((sg, su, sl), (dsg2, dsu2, dsl2)),
            _steplen3((zg, zu, zl), (dzg2, dzu2, dzl2)))[:, None]
        acc = alpha2 >= alpha + 0.01
        dx = torch.where(acc, dx2, dx)
        dzg, dzu, dzl = (torch.where(acc, a, b) for a, b in
                         ((dzg2, dzg), (dzu2, dzu), (dzl2, dzl)))
        dsg, dsu, dsl = (torch.where(acc, a, b) for a, b in
                         ((dsg2, dsg), (dsu2, dsu), (dsl2, dsl)))
        alpha = torch.where(acc, alpha2, alpha)

    new = [x + alpha * dx, sg + alpha * dsg, su + alpha * dsu,
           sl + alpha * dsl, zg + alpha * dzg, zu + alpha * dzu,
           zl + alpha * dzl]
    ok = torch.ones_like(frozen)
    for t in new:
        ok = ok & torch.isfinite(t).all(dim=1)

    stalled = (mu > 0.7 * mu_prev) & (mu < tol * 1e3)
    converged = mu < tol
    frozen = frozen | stalled | converged | ~ok
    keep = ~frozen[:, None]
    x, sg, su, sl, zg, zu, zl = (
        torch.where(keep, a, b)
        for a, b in zip(new, (x, sg, su, sl, zg, zu, zl)))
    shrink = 1.0 - alpha
    rpg = torch.where(keep, shrink * rpg, rpg)
    rpu = torch.where(keep, shrink * rpu, rpu)
    rpl = torch.where(keep, shrink * rpl, rpl)
    return (x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl), frozen


def _mu_of(sg, zg, su, zu, sl, zl, m):
    return (torch.sum(sg * zg, 1) + torch.sum(su * zu + sl * zl, 1)) / m


def ipm_iterate_struct_plain(gi, gj, gob, gsl, pb, q, pdiag,
                             x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal,
                             *, pairs, obst_veh, tol: float, reg_rel: float,
                             n_cor: int = 0, n_iters: int = 1,
                             lower_tri: bool = False,
                             tier: str | None = None):
    """Plain PyTorch version of :func:`ipm_iterate_struct` (float32 or
    float64, any device), of every storage tier: the same function
    through dense batched algebra and ``torch.linalg`` — an oracle, not a
    fast path. ``lower_tri`` only lets the kernel skip exact zeros and
    ``tier`` only says where it keeps its working set, so both are ignored
    here."""
    del lower_tri, tier
    B, P, hp, hu = gi.shape
    V = pb.shape[1]
    nu = V * hu
    n = nu + 1
    mg = gsl.shape[1]
    m = mg + 2 * n

    Gu = _scatter_dense(gi, gj, gob, pairs, obst_veh, V)     # (B, mg, nu)
    Pd = torch.block_diag(*[torch.ones(hu, hu)] * V).to(gi.device) > 0
    Pfull = gi.new_zeros((B, nu, nu))
    Pfull[:, Pd] = pb.reshape(B, -1)
    eye = torch.eye(nu, dtype=torch.bool, device=gi.device)

    def gmv(v):                                   # (B, n) -> (B, mg)
        return torch.einsum("bmn,bn->bm", Gu, v[:, :nu]) + gsl * v[:, nu:]

    def gtmv(w):                                  # (B, mg) -> (B, n)
        return torch.cat([torch.einsum("bmn,bm->bn", Gu, w),
                          torch.sum(gsl * w, dim=1, keepdim=True)], dim=1)

    inv_kappa = 1.0 / (1.0 + reg_rel)
    mu_prev = scal[:, 0].clone()
    frozen = scal[:, 1] > 0.5
    mu = mu_prev
    state = (x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl)
    for _ in range(n_iters):
        x, sg, su, sl, zg, zu, zl = state[:7]
        px = torch.cat([torch.einsum("bij,bj->bi", Pfull, x[:, :nu]),
                        pdiag[:, nu:] * x[:, nu:]], dim=1)
        wg, wu, wl = zg / sg, zu / su, zl / sl
        mu = _mu_of(sg, zg, su, zu, sl, zl, m)

        # analytic diagonal, Jacobi scale
        gsq = torch.cat([torch.einsum("bm,bmn->bn", wg, Gu * Gu),
                         torch.sum(wg * gsl * gsl, 1, keepdim=True)], dim=1)
        dk = pdiag + gsq + (wu + wl)
        dsc = torch.rsqrt(torch.clamp(dk, min=1e-30))
        # scaled border of the eliminated slack
        kuw = gtmv(wg * gsl)
        kb = (dsc * kuw * dsc[:, nu:])[:, :nu]
        # scaled, bordered KKT matrix; its diagonal is analytic
        K = Pfull + torch.einsum("bmi,bm,bmj->bij", Gu, wg, Gu)
        K = K * (dsc[:, :nu, None] * dsc[:, None, :nu]) \
            - inv_kappa * kb[:, :, None] * kb[:, None, :]
        dval = (1.0 + reg_rel) - inv_kappa * kb * kb
        K = torch.where(eye, torch.diag_embed(dval), K)
        solve_kkt = _plain_solver(_plain_factor(K), dsc, kb, inv_kappa)
        state, frozen = _plain_step(
            state, frozen, mu_prev, px=px, q=q, mu=mu, m=m, gmv=gmv,
            gtmv=gtmv, solve_kkt=solve_kkt, tol=tol, n_cor=n_cor)
        mu_prev = mu
    scal_out = torch.stack([mu, frozen.to(gi.dtype)], dim=1)
    return state + (scal_out,)


# ---------------------------------------------------------------------------
# the dense-G fused iterations (K2)
# ---------------------------------------------------------------------------

def dense_smem_bytes(mg: int, n: int, nb: int, d: int, schur: bool,
                     g_smem: bool, n_cor: int = 1,
                     device: bool = False) -> int:
    """Dynamic shared memory of the dense-G kernel (mirrors the carve in
    ``csrc/ipm_dense.cuh::dense_smem_words``): the factor (none in the
    device tier, ``device``), the P blocks (``nb = 0``: a dense P, which
    stays in device memory and takes none), the step's vectors (one
    m-vector fewer without Gondzio correctors: ``n_cor = 0``) and, with
    ``g_smem``, G itself (with an odd leading dimension and four padding
    words)."""
    nk = n - 1 if schur else n
    m = mg + 2 * n
    words = (nb * d * d + (8 + (n_cor > 0)) * m + 9 * n + _RED_WORDS + 1)
    if not device:
        words += nk * kkt_ld(nk, False)
    if g_smem:
        words += mg * (n | 1) + 4      # G and four zeroed words past it
    return 4 * words


def fits_dense_smem(mg: int, n: int, nb: int, d: int, schur: bool) -> bool:
    """Whether the dense-G kernel's working set (without G, which it then
    reads from device memory; with correctors, the larger carve) fits a
    block's shared memory."""
    return dense_smem_bytes(mg, n, nb, d, schur, False) <= SMEM_LIMIT_BYTES


def dense_cluster_smem_bytes(mg: int, n: int, schur: bool, n_cor: int,
                             C: int, area_words: int) -> int:
    """Dynamic shared memory of a rank of K2's cluster tier (mirrors
    ``csrc/ipm_dense.cu::DenseClusterCarve``): the step's vectors (the
    device tier's carve without the P blocks, which it reads from device
    memory), from the next 16-byte boundary the cluster factor's buffers
    (``linalg_kernel.stripe_buffer_words``), the deal (two ints a stripe),
    at an even word the factor's row pointers (8 bytes a row), from a
    16-byte boundary the G ring's two mbarriers (16 bytes) and two stages
    of :data:`DENSE_STAGE_ROWS` rows of G (and three floats of alignment,
    rounded up to 16 bytes each), the staged panel twice (its rows scaled
    by w and not, leading dimension a multiple of 4 covering n and the
    warp tiles' columns) and the border's nk + 1 sums."""
    nk = n - 1 if schur else n
    ns = -(-nk // linalg_kernel.CHOL_STRIPE)
    vec = dense_smem_bytes(mg, n, 0, 0, schur, False, n_cor, True) // 4
    deal = -(-vec // 4) * 4 + linalg_kernel.stripe_buffer_words(
        nk, C, area_words)
    krow = -(-(deal + 2 * ns) // 2) * 2
    raw = -(-(krow + 2 * nk) // 4) * 4 + 4
    stage = (DENSE_STAGE_ROWS * n + 6) // 4 * 4
    lda = max(-(-n // 4) * 4, -(-(linalg_kernel.CHOL_STRIPE * ns) // 32) * 32)
    return 4 * (raw + 2 * stage + 2 * DENSE_STAGE_ROWS * lda + nk + 1)


def dense_cluster_geometry(mg: int, n: int, schur: bool,
                           n_cor: int = 1) -> tuple[int, int, int] | None:
    """``(C, area words, shared-memory bytes per CTA)`` of K2's cluster
    tier at a shape: the first of :data:`DENSE_CLUSTER_SIZES` whose ranks
    each hold the carve with their share of the stripes of the ``nk x nk``
    KKT matrix (``linalg_kernel.stripe_deal``), or None. At (l3)'s QP
    (circle-4, hp = 64: mg = 384, n = 257) C = 2, one CTA an SM."""
    nk = n - 1 if schur else n
    for C in DENSE_CLUSTER_SIZES:
        area = linalg_kernel.stripe_deal(nk, C)[2]
        need = dense_cluster_smem_bytes(mg, n, schur, n_cor, C, area)
        if need <= SMEM_LIMIT_BYTES:
            return C, area, need
    return None


def dense_global_smem_bytes() -> int:
    """Dynamic shared memory of a CTA of K2's global tier (mirrors
    ``csrc/ipm_dense.cuh::kGlobalSmemWords``): the reduction scratch and the
    failure flag, at every shape."""
    return 4 * (_RED_WORDS + 1)


def dense_global_layout(mg: int, n: int, schur: bool,
                        n_cor: int) -> dict[str, tuple[int, int]]:
    """``name -> (offset, floats)`` of one instance's slot of K2's global
    workspace (mirrors ``csrc/ipm_dense.cuh::carve_dense_global``): the
    eight m-vectors (and ``dz`` with Gondzio correctors; without, the
    final dz shares the predictor's ``a2``), the seven n-vectors, and the
    ``nk x ldk`` factor ``K`` from the vectors' end rounded up to 32
    floats. The P blocks (or the dense P), ``q`` and ``pdiag`` are read in
    place from the inputs, G from device memory."""
    nk = n - 1 if schur else n
    m = mg + 2 * n
    vecs = ["s", "z", "rp", "w", "a1", "a2", "a3", "ds"]
    vecs += ["dz"] if n_cor > 0 else []
    names = [(k, m) for k in vecs]
    names += [(k, n) for k in ("x", "px", "dsc", "kb", "rhs", "dx", "dinv")]
    out, at = {}, 0
    for k, size in names:
        out[k] = (at, size)
        at += size
    out["K"] = (-(-at // 32) * 32, nk * kkt_ld(nk, True))
    return out


def dense_global_geometry(mg: int, n: int, schur: bool,
                          n_cor: int) -> GlobalGeometry:
    """K2's global tier at a shape (:func:`dense_global_smem_bytes`,
    :func:`dense_global_layout`). At frog's side-selection QP at hp = 180
    (mg = 4,320, n = 181, no corrector) 73,312 floats an instance."""
    off, size = dense_global_layout(mg, n, schur, n_cor)["K"]
    return GlobalGeometry(dense_global_smem_bytes(), off, off + size)


def dense_tier(mg: int, n: int, nb: int, d: int, schur: bool,
               n_cor: int = 1, tier: str | None = None) -> Tier:
    """The dense-G kernel's storage tier at a shape: the shared tier where
    :func:`fits_dense_smem` holds (G in shared memory too when that fits),
    else the cluster tier where a cluster holds the KKT matrix
    (:func:`dense_cluster_geometry`), else the device tier (the ``nk x
    ldk`` factor in a device-memory workspace, G in device memory) where
    its shared memory holds the vectors and the P blocks, else the global
    tier (the vectors in device memory too, :func:`dense_global_geometry`);
    ``tier`` forces one of :data:`DENSE_TIERS` at any shape it holds.
    Raises ``NotImplementedError``, naming the bytes, only where a forced
    tier's own shared memory exceeds a block's (never the global
    tier's)."""
    if tier not in (None,) + DENSE_TIERS:
        raise ValueError(f"unknown tier {tier!r}")
    if tier == "global":
        return _dense_global_tier(mg, n, schur, n_cor)
    fits = fits_dense_smem(mg, n, nb, d, schur)
    if tier == "cluster" or (tier is None and not fits):
        cl = dense_cluster_geometry(mg, n, schur, n_cor)
        if cl is not None:
            return Tier("cluster", cl[2], 0, False)
        if tier == "cluster":
            raise NotImplementedError(
                f"the dense-G fused IPM kernel's cluster tier needs more "
                f"than {SMEM_LIMIT_BYTES} bytes of shared memory a CTA at "
                f"mg={mg}, n={n} with {DENSE_CLUSTER_SIZES[-1]} CTAs")
    dev = tier == "device" or (tier is None and not fits)
    need = dense_smem_bytes(mg, n, nb, d, schur, False, n_cor, dev)
    if need > SMEM_LIMIT_BYTES and tier is None:
        return _dense_global_tier(mg, n, schur, n_cor)
    if need > SMEM_LIMIT_BYTES:
        full = dense_smem_bytes(mg, n, nb, d, schur, False, n_cor)
        raise NotImplementedError(
            f"the dense-G fused IPM kernel needs {need} bytes of shared "
            f"memory per instance in its {'device' if dev else 'shared'} "
            f"tier at mg={mg}, n={n} ({full} with the factor; limit "
            f"{SMEM_LIMIT_BYTES}); the global tier (tier='global' or none) "
            f"keeps the vectors in device memory there")
    nk = n - 1 if schur else n
    if dev:
        return Tier("device", need, nk * kkt_ld(nk, True), False)
    with_g = dense_smem_bytes(mg, n, nb, d, schur, True, n_cor)
    if with_g <= SMEM_LIMIT_BYTES:
        return Tier("shared", with_g, 0, True)
    return Tier("shared", need, 0, False)


def _dense_global_tier(mg, n, schur, n_cor) -> Tier:
    g = dense_global_geometry(mg, n, schur, n_cor)
    return Tier("global", g.smem_bytes, g.workspace_floats, False)


def dense_min_ctas(B: int, sm_count: int) -> int:
    """The launch bound the dense-G kernel is run at for ``B`` instances on
    a card of ``sm_count`` SMs: 2 CTAs an SM (128 registers a thread) while
    the batch is one wave at two, else 4 (64 registers). Two ran a frog QP
    ~8% faster at B = 256 and 64 on an H100 (132 SMs), four ~35% faster at
    B = 512 and 1024, where two take two and four waves (``PERF.md`` §6)."""
    return 2 if B <= 2 * sm_count else 4


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def dense_resident_ctas_per_sm(mg: int, n: int, nb: int, d: int,
                               schur: bool, n_cor: int,
                               min_ctas: int = 4,
                               tier: str | None = None) -> int:
    """CTAs of the dense-G kernel built for ``min_ctas`` CTAs an SM that
    one SM of the current CUDA device holds at a shape in its tier
    (:func:`dense_tier`; the CUDA occupancy calculator, with the launch's
    shared memory). Needs the card: it builds and loads the library."""
    t = dense_tier(mg, n, nb, d, schur, n_cor, tier)
    if t.tier == "cluster":
        return dense_cluster_occupancy(mg, n, nb, d, schur, n_cor)[0]
    if t.tier == "global":
        return dense_global_occupancy(min_ctas)
    fn = _cuda_build.load_library().ipm_dense_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    ctas = ctypes.c_int(0)
    err = fn(mg, n, nb, d, int(schur), int(t.g_smem),
             int(t.tier == "device"), n_cor, min_ctas, ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(f"ipm_dense_occupancy failed with CUDA error "
                           f"{err}")
    return ctas.value


def dense_cluster_occupancy(mg: int, n: int, nb: int, d: int, schur: bool,
                            n_cor: int) -> tuple[int, int]:
    """``(CTAs one SM holds, clusters the device holds at once)`` of K2's
    cluster tier at a shape (:func:`dense_cluster_geometry`; the CUDA
    occupancy calculator). Needs the card."""
    C, area, _ = dense_cluster_geometry(mg, n, schur, n_cor)
    fn = _cuda_build.load_library().ipm_dense_cluster_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    ctas, clusters = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(mg, n, nb, d, int(schur), n_cor, C, area, ctypes.byref(ctas),
             ctypes.byref(clusters))
    if err != 0:
        raise RuntimeError(f"ipm_dense_cluster_occupancy failed with CUDA "
                           f"error {err}")
    return ctas.value, clusters.value


def dense_global_occupancy(min_ctas: int,
                           carveout: int | None = None) -> int:
    """CTAs of K2's global tier built for ``min_ctas`` CTAs an SM that one
    SM holds (the CUDA occupancy calculator, with the tier's 132 bytes of
    shared memory and the carve-out ``carveout``, by default
    :data:`DENSE_GLOBAL_CARVEOUT`). Needs the card."""
    fn = _cuda_build.load_library().ipm_dense_global_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    ctas = ctypes.c_int(0)
    err = fn(min_ctas, DENSE_GLOBAL_CARVEOUT if carveout is None
             else carveout, ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(f"ipm_dense_global_occupancy failed with CUDA "
                           f"error {err}")
    return ctas.value


_STATE = ("x", "sg", "su", "sl", "zg", "zu", "zl", "rpg", "rpu", "rpl",
          "scal")
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
# ``csrc/ipm_dense_global.cu::ipm_dense_global_launch``'s arguments by name,
# in the order of its prototype.
DENSE_GLOBAL_LAUNCH_ARGS = (
    *[(k, _P) for k in ("G", "P", "pb", "q", "pdiag", *_STATE)],
    *[(k + "o", _P) for k in _STATE], ("ws", _P),
    *[(k, _I) for k in ("B", "mg", "n", "nb", "d", "schur", "n_iters",
                        "n_cor", "min_ctas", "carveout")],
    ("tol", _F), ("tol_stall", _F), ("reg_rel", _F),
    ("smem_bytes", _L), ("ws_floats", _L), ("stream", _P))


def _dense_global_launch(**args) -> int:
    """``ipm_dense_global_launch`` called with ``args`` by name
    (:data:`DENSE_GLOBAL_LAUNCH_ARGS`)."""
    fn = _cuda_build.load_library().ipm_dense_global_launch
    if fn.argtypes is None:
        fn.argtypes = [t for _, t in DENSE_GLOBAL_LAUNCH_ARGS]
        fn.restype = ctypes.c_int
    return fn(*[args[k] for k, _ in DENSE_GLOBAL_LAUNCH_ARGS])


def _dense_launcher(cluster: bool = False):
    """The library's ``ipm_dense_launch`` (``ipm_dense_cluster_launch``)
    with its argument types set."""
    lib = _cuda_build.load_library()
    fn = lib.ipm_dense_cluster_launch if cluster else lib.ipm_dense_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p] * 16 + [p] * 12 + [i] * (10 if cluster else 11)
                       + [f] * 3 + [ctypes.c_long]
                       + ([] if cluster else [ctypes.c_long]) + [p])
        fn.restype = ctypes.c_int
    return fn


def _check_dense(G, P, pb, q, pdiag, state):
    """Shapes, dtypes and devices of the dense-G operands; returns
    ``(B, mg, n, nb, d)`` (``nb = d = 0`` with a dense P)."""
    B, mg, n = G.shape
    if (P is None) == (pb is None):
        raise ValueError("pass exactly one of P (dense) and pb (blocks)")
    x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal = state
    want = {"q": (q, (B, n)), "pdiag": (pdiag, (B, n)),
            "x": (x, (B, n)), "sg": (sg, (B, mg)), "su": (su, (B, n)),
            "sl": (sl, (B, n)), "zg": (zg, (B, mg)), "zu": (zu, (B, n)),
            "zl": (zl, (B, n)), "rpg": (rpg, (B, mg)), "rpu": (rpu, (B, n)),
            "rpl": (rpl, (B, n)), "scal": (scal, (B, 2))}
    if pb is None:
        nb, d = 0, 0
        want["P"] = (P, (B, n, n))
    else:
        if pb.ndim != 4:
            raise ValueError(f"pb: shape {tuple(pb.shape)}, want "
                             f"(B, nb, d, d)")
        nb, d = pb.shape[1], pb.shape[2]
        if nb == 0 or nb * d > n:
            raise ValueError(f"P blocks {tuple(pb.shape)} do not fit n={n}")
        want["pb"] = (pb, (B, nb, d, d))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if t.dtype != G.dtype or t.device != G.device:
            raise ValueError(f"{name}: dtype/device differ from G's")
    return B, mg, n, nb, d


def _check_launchable(ins):
    """What the dense-G kernel takes beyond the operands' shapes: float32,
    contiguous (``None`` entries are absent operands)."""
    if ins[0].dtype != torch.float32:
        raise TypeError(
            f"the CUDA IPM kernel is float32 only, got {ins[0].dtype}")
    for t in ins:
        if t is not None and not t.is_contiguous():
            raise ValueError("the CUDA IPM kernel needs contiguous tensors")


def ipm_iterate_dense(G, P, pb, q, pdiag,
                      x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal,
                      *, n_iters: int = 1, tol: float, reg_rel: float,
                      n_cor: int = 0, schur_slack: bool = False,
                      tier: str | None = None):
    """Run ``n_iters`` fused Mehrotra iterations of the dense-G QP; returns
    the updated ``(x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal)``.

    ``G (B, mg, n)``: the equilibrated dense rows, slack column included;
    each iteration forms ``G_k^T diag(zg / sg) G_k`` over the factored
    columns (``nk = n - 1`` with ``schur_slack``, else ``n``) from it.
    Exactly one of ``P (B, n, n)`` (dense; its lower triangle enters the
    KKT matrix and the kernel computes ``P x``) and ``pb (B, nb, d, d)``
    (P blocks, with a diagonal tail in ``pdiag``) is given. ``pdiag (B, n)``:
    P's diagonal. ``schur_slack``: the last variable is a slack with a zero
    P row, eliminated by a rank-1 border. State as
    :func:`ipm_iterate_struct`'s; ``scal``'s mu / frozen carry the freeze
    from one call to the next.

    CUDA tensors (float32, contiguous) go to the hand-written kernel in
    the storage tier :func:`dense_tier` picks for the shape (``tier``
    forces one, for checking the tiers against each other), in the shared,
    device and global tiers at the launch bound :func:`dense_min_ctas`
    picks for ``B``; there is no fallback: a failing build, load or launch
    raises, and so does a cluster that cannot be resident. CPU tensors go
    to :func:`ipm_iterate_dense_plain`. Each call is a ``k2`` span
    (``utils.timing``) with its tier (``plain`` on the CPU) and shape.
    """
    global dense_launch_count, dense_device_launch_count
    global dense_cluster_launch_count, dense_global_launch_count
    state = (x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal)
    with timing.span("k2") as sp:
        B, mg, n, nb, d = _check_dense(G, P, pb, q, pdiag, state)
        sp.set(B=B, mg=mg, n=n, n_iters=int(n_iters), n_cor=int(n_cor))
        if G.device.type != "cuda":
            sp.set(tier="plain")
            return ipm_iterate_dense_plain(
                G, P, pb, q, pdiag, *state, n_iters=n_iters, tol=tol,
                reg_rel=reg_rel, n_cor=n_cor, schur_slack=schur_slack)
        ins = [G, P, pb, q, pdiag, *state]
        _check_launchable(ins)
        t = dense_tier(mg, n, nb, d, schur_slack, n_cor, tier)
        sp.set(tier=t.tier)
        outs = [torch.empty_like(o) for o in state]
        ptr = [0 if a is None else a.data_ptr() for a in ins]
        if t.tier == "global":
            min_ctas = dense_min_ctas(B, _sm_count(G.device))
            ws = torch.empty((B, t.workspace_floats), dtype=torch.float32,
                             device=G.device)
            with torch.cuda.device(G.device):
                err = _dense_global_launch(
                    **dict(zip(("G", "P", "pb", "q", "pdiag", *_STATE), ptr)),
                    **{k + "o": o.data_ptr() for k, o in zip(_STATE, outs)},
                    ws=ws.data_ptr(), B=B, mg=mg, n=n, nb=nb, d=d,
                    schur=int(schur_slack), n_iters=int(n_iters),
                    n_cor=int(n_cor), min_ctas=min_ctas,
                    carveout=DENSE_GLOBAL_CARVEOUT, tol=float(tol),
                    tol_stall=float(tol * 1e3), reg_rel=float(reg_rel),
                    smem_bytes=t.smem_bytes, ws_floats=B * t.workspace_floats,
                    stream=torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(
                    f"ipm_dense_global_launch failed with CUDA error {err} "
                    f"(B={B}, mg={mg}, n={n}, nb={nb}, d={d}, "
                    f"min_ctas={min_ctas}, {B * t.workspace_floats} workspace "
                    f"floats)")
            dense_global_launch_count += 1
            return tuple(outs)
        if t.tier == "cluster":
            nk = n - 1 if schur_slack else n
            C, area, _ = dense_cluster_geometry(mg, n, schur_slack, n_cor)
            table = linalg_kernel.deal_tensor(
                nk, C, linalg_kernel.stripe_deal(nk, C), G.device)
            with torch.cuda.device(G.device):
                stream = torch.cuda.current_stream().cuda_stream
                err = _dense_launcher(cluster=True)(
                    *ptr, *[o.data_ptr() for o in outs], table.data_ptr(),
                    B, mg, n, nb, d, int(schur_slack), int(n_iters),
                    int(n_cor), C, area, float(tol), float(tol * 1e3),
                    float(reg_rel), t.smem_bytes, stream)
            if err != 0:
                why = ("no cluster can be resident" if err == -2
                       else f"CUDA error {err}")
                raise RuntimeError(
                    f"ipm_dense_cluster_launch failed: {why} (B={B}, mg={mg}, "
                    f"n={n}, nb={nb}, d={d}, cluster of {C} CTAs, "
                    f"{t.smem_bytes} bytes of shared memory each)")
            dense_cluster_launch_count += 1
            return tuple(outs)
        dev = t.tier == "device"
        min_ctas = dense_min_ctas(B, _sm_count(G.device))
        launch = _dense_launcher()
        ws = torch.empty((B, t.workspace_floats), dtype=torch.float32,
                         device=G.device) if dev else None
        with torch.cuda.device(G.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(
                *ptr, *[o.data_ptr() for o in outs],
                ws.data_ptr() if dev else 0,
                B, mg, n, nb, d, int(schur_slack), int(t.g_smem), int(dev),
                int(n_iters), int(n_cor), min_ctas, float(tol),
                float(tol * 1e3), float(reg_rel), t.smem_bytes,
                B * t.workspace_floats, stream)
        if err != 0:
            raise RuntimeError(
                f"ipm_dense_launch failed with CUDA error {err} "
                f"(B={B}, mg={mg}, n={n}, nb={nb}, d={d}, tier={t.tier}, "
                f"smem={t.smem_bytes}, min_ctas={min_ctas})")
        if dev:
            dense_device_launch_count += 1
        else:
            dense_launch_count += 1
        return tuple(outs)


def ipm_iterate_dense_plain(G, P, pb, q, pdiag,
                            x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal,
                            *, n_iters: int = 1, tol: float, reg_rel: float,
                            n_cor: int = 0, schur_slack: bool = False,
                            tier: str | None = None):
    """Plain PyTorch version of :func:`ipm_iterate_dense` (float32 or
    float64, any device), of every storage tier (``tier`` is ignored):
    per iteration the product ``G^T diag(zg / sg) G`` and ``P x`` in
    batched algebra, then the same step through ``torch.linalg``."""
    del tier
    B, mg, n = G.shape
    m = mg + 2 * n
    nk = n - 1 if schur_slack else n
    inv_kappa = 1.0 / (1.0 + reg_rel)
    if pb is not None:
        nb, d = pb.shape[1], pb.shape[2]
        nbd = nb * d
        P = G.new_zeros((B, n, n))
        for v in range(nb):
            P[:, v * d:(v + 1) * d, v * d:(v + 1) * d] = pb[:, v]
        P[:, range(nbd, n), range(nbd, n)] = pdiag[:, nbd:]
    eye = torch.eye(nk, dtype=torch.bool, device=G.device)

    def gmv(v):
        return torch.einsum("bmn,bn->bm", G, v)

    def gtmv(w):
        return torch.einsum("bmn,bm->bn", G, w)

    mu_prev = scal[:, 0].clone()
    frozen = scal[:, 1] > 0.5
    mu = mu_prev
    state = (x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl)
    for _ in range(n_iters):
        x, sg, su, sl, zg, zu, zl = state[:7]
        wg, wu, wl = zg / sg, zu / su, zl / sl
        mu = _mu_of(sg, zg, su, zu, sl, zl, m)
        px = torch.einsum("bij,bj->bi", P, x)
        # the product over every column: its diagonal is the analytic
        # diagonal's G^T W G, its last column the slack border
        prod = torch.einsum("bmi,bm,bmj->bij", G, wg, G)
        gsq = torch.diagonal(prod, dim1=1, dim2=2)
        dk = pdiag + gsq + (wu + wl)
        dsc = torch.rsqrt(torch.clamp(dk, min=1e-30))
        Kt = (prod[:, :nk, :nk] + P[:, :nk, :nk]) \
            * (dsc[:, :nk, None] * dsc[:, None, :nk])
        kb = None
        dval = torch.full_like(dsc[:, :nk], 1.0 + reg_rel)
        if schur_slack:
            # scaled border of the eliminated slack (the last variable)
            kb = dsc[:, :nk] * prod[:, :nk, nk] * dsc[:, nk:]
            Kt = Kt - inv_kappa * kb[:, :, None] * kb[:, None, :]
            dval = dval - inv_kappa * kb * kb
        Kt = torch.where(eye, torch.diag_embed(dval), Kt)
        solve_kkt = _plain_solver(_plain_factor(Kt), dsc, kb, inv_kappa)
        state, frozen = _plain_step(
            state, frozen, mu_prev, px=px, q=q, mu=mu, m=m, gmv=gmv,
            gtmv=gtmv, solve_kkt=solve_kkt, tol=tol, n_cor=n_cor)
        mu_prev = mu
    return state + (torch.stack([mu, frozen.to(G.dtype)], dim=1),)
