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
(:func:`chol_geometry`, :func:`chol_cluster_geometry`,
:func:`solve_geometry`, :func:`gmv_geometry`, :func:`gtmv_geometry`). The
factor and the solve work on panels / blocks of :data:`CHOL_PANEL` columns
(``csrc/chol_blocked.cuh``): while one instance's matrix fits a block's
shared memory (:func:`fits_chol_smem`, n < 240) one CTA holds it there;
from n = 240 (hp = 64 with 4 vehicles is n = 257) the factor spreads it over
the shared memory of a thread block cluster of up to 8 CTAs
(``csrc/chol_cluster.cuh``, :func:`chol_route`) while that holds it (n <=
716), and past that works in place in its output in device memory on one
CTA; the solve reads the factor from device memory, with only the vectors
in shared memory, so every n a 32-bit index reaches within one instance is
taken (n <= 46,340 for the factor; n <= 29,056 for the solve, whose two
vectors must fit shared memory). From n = 240 the solve stages the
factor's lower triangle into one block's shared memory once, by bulk
copies of its rows, while it fits (n <= 331) and the batch is one wave of
instances (:func:`solve_route`), and reads it from device memory past
that. The G product stages row tiles
of at most :data:`GMV_STAGE_BYTES` in shared memory, one CTA each (a row
wider than that in runs of columns); G^T v stages an instance's rows the
same way over a thread block cluster of at most :data:`GTMV_MAX_CLUSTER`
CTAs, whose partial column sums are added in a fixed order.

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
# G^T v (gtmv_cluster_kernel, GTMV_THREADS threads a CTA): an instance's
# rows are cut into at most GTMV_MAX_CLUSTER row ranges (the portable
# cluster size), one CTA each, until the grid has GTMV_CTAS_PER_SM CTAs for
# each SM of the card; a CTA stages its rows through a ring of two stages
# of at most GTMV_STAGE_BYTES each (a row wider than that in runs of
# columns), in as few chunks as keep the whole grid resident at once on
# the card's SMs (their count, threads and shared memory read from the
# device, 1 KB of the latter reserved per CTA). Measured (PERF.md): a
# second wave of CTAs, or more chunks than that, each cost about a copy's
# latency.
GTMV_STAGE_BYTES = 32 * 1024
GTMV_CTAS_PER_SM = 2
GTMV_MAX_CLUSTER = 8
GTMV_THREADS = 256
CTA_RESERVED_SMEM = 1024
# The factor and the solve from n = 240 (chol_large_kernel,
# cho_solve_large_kernel): one CTA of LARGE_THREADS threads per instance.
LARGE_THREADS = 256
# The factor from n = 240 while a thread block cluster holds the matrix
# (chol_cluster_kernel, csrc/chol_cluster.cuh): the lower triangle in
# CHOL_STRIPE-row stripes dealt over C CTAs of one cluster (stripe_deal), C
# the smallest of CHOL_CLUSTER_SIZES whose ranks each hold their stripes,
# the panel buffer and the vectors, raised while B x C is below
# CHOL_CLUSTER_SMS (the SMs of an H100) so that a small batch spreads over
# the card. Past the largest cluster, chol_large_kernel takes the factor.
CHOL_STRIPE = 16
CHOL_CLUSTER_SIZES = (1, 2, 4, 8)
CHOL_CLUSTER_SMS = 132
# The large-n factor's variants (``cholesky(..., variant=)``): the cluster
# kernel, and the one-CTA kernel with the matrix in device memory.
CHOL_LARGE_VARIANTS = ("cluster", "device")
# The large-n solve's variants (``cho_solve(..., variant=)``): the triangle
# staged into shared memory (cho_solve_staged_kernel), and the factor read
# from device memory (cho_solve_large_kernel). The staged kernel holds one
# instance an SM; past SOLVE_STAGED_MAX_BATCH instances (one wave on an
# H100's 132 SMs) the one-CTA kernel, several instances an SM hiding each
# other's block chains, is faster (PERF.md, measured at n = 240 / 257 /
# 330 by scripts/torch_kernel_check.py --times k3k4large).
SOLVE_LARGE_VARIANTS = ("staged", "device")
SOLVE_STAGED_MAX_BATCH = 132
# Within one instance the kernels index with 32-bit integers.
MAX_INDEX = 2 ** 31 - 1

# Launches of each CUDA kernel since the last reset (incremented where the
# kernel is launched and nowhere else).
launch_counts = {"cholesky": 0, "cho_solve": 0, "gmv": 0, "gtmv": 0,
                 "cholesky_cluster": 0, "cho_solve_staged": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_ARGTYPES = {
    "chol_batched_launch": [_P, _P, _I, _I, _I, _L, _P],
    "cho_solve_batched_launch": [_P, _P, _P, _I, _I, _I, _L, _P],
    "gmv_batched_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _L, _P],
    "gtmv_batched_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L,
                            _P],
    "chol_large_launch": [_P, _P, _I, _I, _I, _L, _P],
    "cho_solve_large_launch": [_P, _P, _P, _I, _I, _I, _L, _P],
    "cho_solve_staged_launch": [_P, _P, _P, _I, _I, _I, _L, _P],
    "chol_cluster_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _L, _P],
}
_deals: dict = {}


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


def chol_large_smem_bytes(n: int) -> int:
    """Dynamic shared memory of the factor from n = 240: ``1 / diag`` and a
    flag (the matrix stays in device memory)."""
    return 4 * (n + 1)


def solve_large_smem_bytes(n: int) -> int:
    """Dynamic shared memory of the solve from n = 240: ``1 / diag`` and
    the right-hand side (the factor is read from device memory)."""
    return 4 * 2 * n


def staged_row_slot(r: int) -> int:
    """Offset (floats) of row ``r``'s slot in the staged solve's packed
    triangle: every row before it in a 16-byte-aligned slot of ``(i + 7)
    & ~3`` floats, its ``i + 1`` entries after at most three floats of
    alignment (``csrc/linalg.cu::staged_row_slot``, in closed form there);
    ``staged_row_slot(n)`` is the triangle's floats."""
    return sum((i + 7) & ~3 for i in range(r))


def solve_staged_smem_bytes(n: int) -> int:
    """Dynamic shared memory of the staged large-n solve
    (``csrc/linalg.cu::staged_solve_words``): an 8-byte mbarrier a 16-row
    stripe, ``1 / diag``, the right-hand side, a count and an offset a row
    (n each), each part rounded up to 16 bytes, then the staged
    triangle."""
    ns = -(-n // CHOL_STRIPE)
    return 4 * (-(-2 * ns // 4) * 4 + -(-4 * n // 4) * 4
                + staged_row_slot(n))


def solve_route(B: int, n: int, variant: str | None = None) -> str:
    """The solve kernel for ``B`` n x n factors: ``"shared"``
    (cho_solve_batched_kernel) while :func:`fits_chol_smem`, else
    ``"staged"`` (cho_solve_staged_kernel) while the lower triangle fits a
    block's shared memory (:func:`solve_staged_smem_bytes`; n <= 331) and
    B <= :data:`SOLVE_STAGED_MAX_BATCH`, else ``"device"``
    (cho_solve_large_kernel, the factor read from device memory).
    ``variant`` forces ``"staged"`` or ``"device"`` at any n and B
    (``ValueError`` where the triangle does not fit)."""
    if variant not in (None,) + SOLVE_LARGE_VARIANTS:
        raise ValueError(f"unknown solve variant {variant!r}")
    if variant is None and fits_chol_smem(n):
        return "shared"
    staged = solve_staged_smem_bytes(n) <= SMEM_LIMIT_BYTES
    if variant == "staged" and not staged:
        raise ValueError(f"n={n}: the staged solve needs "
                         f"{solve_staged_smem_bytes(n)} bytes of shared "
                         f"memory (limit {SMEM_LIMIT_BYTES})")
    if variant == "device" or not staged or (
            variant is None and B > SOLVE_STAGED_MAX_BATCH):
        return "device"
    return "staged"


def _check_large(n: int, smem: int) -> None:
    if n * n > MAX_INDEX:
        raise ValueError(f"n={n}: one instance's {n * n} entries need "
                         f"64-bit indices")
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"n={n}: the vectors need {smem} bytes of shared "
                         f"memory (limit {SMEM_LIMIT_BYTES})")


def stripe_words(n: int, s: int) -> int:
    """Floats of stripe ``s`` of an n x n lower triangle: rows ``16 s ..``
    (fewer in the last), columns ``0 .. 16 s + 15``, leading dimension
    ``16 (s + 1) + 1`` (``csrc/chol_cluster.cuh``)."""
    return min(CHOL_STRIPE, n - CHOL_STRIPE * s) * (CHOL_STRIPE * (s + 1) + 1)


def stripe_deal(n: int, C: int) -> tuple[list[int], list[int], int]:
    """The stripes of an n x n factor dealt over ``C`` ranks, largest
    first, each to the rank with the fewest floats so far (the lowest rank
    on a tie), which evens the ranks' areas, rows and trailing tiles (a
    cyclic deal left the last rank the largest stripes: measured slower at
    n = 330 / 400, PERF.md): ``(owner, offset, area words)`` — each
    stripe's rank, its offset in that rank's stripe area, and the largest
    area a rank needs."""
    ns = -(-n // CHOL_STRIPE)
    owner, load = [0] * ns, [0] * C
    for s in sorted(range(ns), key=lambda s: -stripe_words(n, s)):
        owner[s] = min(range(C), key=lambda q: (load[q], q))
        load[owner[s]] += stripe_words(n, s)
    offset, used = [], [0] * C
    for s in range(ns):
        offset.append(used[owner[s]])
        used[owner[s]] += stripe_words(n, s)
    return owner, offset, max(used)


def stripe_buffer_words(n: int, C: int, area_words: int) -> int:
    """Floats of a rank's buffers of the cluster factor
    (``csrc/chol_cluster.cuh::stripe_buffer_words``): two diagonal-block
    buffers (16 x 16 and 16 reciprocals each), four mbarriers (8 words),
    the stripe area (rounded up to 16 bytes) and the panel buffers (two of
    16 columns of the rows rounded up to a stripe, plus one stripe; one
    when C = 1)."""
    panel_rows = CHOL_STRIPE * (-(-n // CHOL_STRIPE) + 1)
    return (2 * (CHOL_STRIPE * CHOL_STRIPE + CHOL_STRIPE) + 8
            + -(-area_words // 4) * 4
            + (2 if C > 1 else 1) * CHOL_STRIPE * panel_rows)


def chol_cluster_smem_bytes(n: int, C: int, area_words: int) -> int:
    """Dynamic shared memory of a rank of the cluster factor: its buffers
    (:func:`stripe_buffer_words`), ``1 / diag``, the deal (two ints a
    stripe) and the flag."""
    ns = -(-n // CHOL_STRIPE)
    return 4 * (stripe_buffer_words(n, C, area_words) + n + 2 * ns + 1)


def chol_cluster_geometry(B: int, n: int, sms: int = CHOL_CLUSTER_SMS):
    """``(C, threads, shared-memory bytes per CTA, (owner, offset, area
    words))`` of the cluster factor — ``C`` CTAs, one cluster, per
    instance: the smallest of :data:`CHOL_CLUSTER_SIZES` whose ranks each
    fit a block's shared memory, raised while ``B * C < sms`` — or None
    when even the largest cluster cannot hold the matrix."""
    _check_large(n, 0)
    fits = [C for C in CHOL_CLUSTER_SIZES
            if chol_cluster_smem_bytes(n, C, stripe_deal(n, C)[2])
            <= SMEM_LIMIT_BYTES]
    if not fits:
        return None
    C = next((c for c in fits if B * c >= sms), fits[-1])
    deal = stripe_deal(n, C)
    return C, LARGE_THREADS, chol_cluster_smem_bytes(n, C, deal[2]), deal


def chol_route(B: int, n: int, variant: str | None = None) -> str:
    """The factor kernel for ``B`` instances of n x n: ``"shared"``
    (chol_blocked_kernel) while :func:`fits_chol_smem`, else ``"cluster"``
    (chol_cluster_kernel) while a cluster holds the matrix, else
    ``"device"`` (chol_large_kernel). ``variant`` forces ``"cluster"`` or
    ``"device"`` at any n (``ValueError`` where the cluster cannot hold
    it)."""
    if variant not in (None,) + CHOL_LARGE_VARIANTS:
        raise ValueError(f"unknown factor variant {variant!r}")
    if variant is None and fits_chol_smem(n):
        return "shared"
    has_cluster = chol_cluster_geometry(B, n) is not None
    if variant == "cluster" and not has_cluster:
        raise ValueError(f"n={n}: the matrix does not fit a cluster of "
                         f"{CHOL_CLUSTER_SIZES[-1]} CTAs")
    if variant == "device" or not has_cluster:
        return "device"
    return "cluster"


def chol_geometry(B: int, n: int) -> tuple[int, int]:
    """``(threads, shared-memory bytes per CTA)`` of the one-CTA factors:
    the matrix in shared memory while :func:`fits_chol_smem`, else in
    device memory (the cluster factor: :func:`chol_cluster_geometry`)."""
    if not fits_chol_smem(n):
        smem = chol_large_smem_bytes(n)
        _check_large(n, smem)
        return LARGE_THREADS, smem
    threads = CHOL_FEW_THREADS if B <= CHOL_FEW_INSTANCES else 128
    return threads, chol_smem_bytes(n)


def solve_geometry(B: int, n: int) -> tuple[int, int]:
    """``(threads, shared-memory bytes per CTA)`` of the solve, which runs
    one CTA per instance: the factor in shared memory while
    :func:`fits_chol_smem`, else read from device memory."""
    if not fits_chol_smem(n):
        smem = solve_large_smem_bytes(n)
        _check_large(n, smem)
        return LARGE_THREADS, smem
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


def gtmv_smem_bytes(chunk: int, cols: int) -> int:
    """Shared memory of G^T v: two mbarriers, two stages of ``chunk`` x
    ``cols`` with up to three floats of alignment, two chunks of v entries
    and the row groups' partial sums (``GTMV_THREADS // cols`` groups, or
    one)."""
    groups = max(1, GTMV_THREADS // cols)
    return 16 + 4 * (2 * _round4(chunk * cols + 3) + 2 * chunk
                     + groups * cols)


def sm_resources(device) -> tuple[int, int, int]:
    """``(SMs, threads per SM, shared-memory bytes per SM)`` of a CUDA
    device, as :func:`gtmv_geometry` takes them."""
    p = torch.cuda.get_device_properties(device)
    return (p.multi_processor_count, p.max_threads_per_multi_processor,
            p.shared_memory_per_multiprocessor)


def gtmv_geometry(B: int, m: int, n: int, sms: int, sm_threads: int,
                  sm_smem: int) -> tuple[int, int, int, int, int]:
    """``(tiles, rows, chunk, cols, shared-memory bytes per CTA)`` of G^T v
    on a card of ``sms`` SMs of ``sm_threads`` threads and ``sm_smem``
    bytes of shared memory each (:func:`sm_resources`): ``tiles`` CTAs per
    instance (one cluster), each taking ``rows`` consecutive rows (the last
    fewer), staged ``chunk`` whole rows at a time (``cols = n``), or, for a
    row wider than a stage, one row at a time in runs of ``cols``
    columns."""
    stage = GTMV_STAGE_BYTES // 4 - 3
    cols = min(n, stage)
    tiles = max(1, min(GTMV_MAX_CLUSTER, -(-GTMV_CTAS_PER_SM * sms // B), m))
    rows = -(-m // tiles)
    tiles = -(-m // rows)                    # no CTA without rows
    if cols < n:
        return tiles, rows, 1, cols, gtmv_smem_bytes(1, cols)
    # CTAs each SM must hold for one wave (at most what its threads allow)
    per_sm = min(sm_threads // GTMV_THREADS, -(-B * tiles // sms))
    k = -(-rows // min(rows, max(1, stage // n)))
    while True:                              # chunks of (nearly) equal rows
        chunk = -(-rows // k)
        smem = gtmv_smem_bytes(chunk, cols)
        if chunk == 1 or sm_smem // (smem + CTA_RESERVED_SMEM) >= per_sm:
            return tiles, rows, chunk, cols, smem
        k += 1


def fits_chol_smem(n: int) -> bool:
    """Whether one instance's n x n matrix fits the shared-memory factor
    and solve kernels (n < 240). Past it the factor and the solve keep the
    matrix in device memory; ``solve_qp_batched(kkt="auto")`` routes on
    this predicate (to the banded KKT past it, where a stage statement is
    given)."""
    return max(chol_smem_bytes(n), solve_smem_bytes(n)) <= SMEM_LIMIT_BYTES


def _launch(name, symbol, first, *args):
    _cuda_build.launch(symbol, _ARGTYPES[symbol], first, *args)
    launch_counts[name] += 1


def deal_tensor(n: int, C: int, deal, device) -> torch.Tensor:
    key = (n, C, str(device))
    if key not in _deals:
        _deals[key] = torch.tensor(deal[0] + deal[1], dtype=torch.int32,
                                   device=device)
    return _deals[key]


def cholesky(K: torch.Tensor, variant: str | None = None) -> torch.Tensor:
    """Lower Cholesky factors of a batch of SPD matrices, by the kernel
    :func:`chol_route` picks (``variant`` forces a large-n kernel)."""
    B, n = K.shape[0], K.shape[-1]
    if not _cuda_build.check_operands("cholesky", [(K, (B, n, n))]):
        return linalg.cholesky_plain(K)
    route = chol_route(B, n, variant)
    L = torch.empty_like(K)
    if route == "cluster":
        C, threads, smem, deal = chol_cluster_geometry(B, n)
        fn = getattr(_cuda_build.load_library(), "chol_cluster_launch")
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES["chol_cluster_launch"]
            fn.restype = ctypes.c_int
        table = deal_tensor(n, C, deal, K.device)
        with torch.cuda.device(K.device):
            err = fn(K.data_ptr(), L.data_ptr(), table.data_ptr(), B, n, C,
                     threads, deal[2], smem,
                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            why = ("no cluster can be resident" if err == -2
                   else f"CUDA error {err}")
            raise RuntimeError(
                f"chol_cluster_launch failed: {why} (B={B}, n={n}, "
                f"cluster of {C} CTAs, {smem} bytes of shared memory each)")
        launch_counts["cholesky_cluster"] += 1
        return L
    symbol = "chol_batched_launch" if route == "shared" else \
        "chol_large_launch"
    _launch("cholesky", symbol, K, K.data_ptr(), L.data_ptr(), B, n,
            *chol_geometry(B, n))
    return L


def cho_solve(L: torch.Tensor, b: torch.Tensor,
              variant: str | None = None) -> torch.Tensor:
    """Solve ``(L L^T) x = b`` against :func:`cholesky`'s factors, by the
    kernel :func:`solve_route` picks (``variant`` forces a large-n
    kernel)."""
    B, n = b.shape
    if not _cuda_build.check_operands("cho_solve",
                                      [(L, (B, n, n)), (b, (B, n))]):
        return linalg.cho_solve_plain(L, b)
    route = solve_route(B, n, variant)
    x = torch.empty_like(b)
    if route == "staged":
        _check_large(n, 0)
        _launch("cho_solve_staged", "cho_solve_staged_launch", L,
                L.data_ptr(), b.data_ptr(), x.data_ptr(), B, n,
                LARGE_THREADS, solve_staged_smem_bytes(n))
        return x
    symbol = ("cho_solve_batched_launch" if route == "shared"
              else "cho_solve_large_launch")
    _launch("cho_solve", symbol, L, L.data_ptr(), b.data_ptr(), x.data_ptr(),
            B, n, *solve_geometry(B, n))
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
            out.data_ptr(), B, m, n,
            *gtmv_geometry(B, m, n, *sm_resources(G.device)))
    return out
