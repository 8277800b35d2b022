#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``scp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``scp_tpu_torch/csrc`` (the
fused structured IPM iteration K1, the dense-G IPM iteration K2, the
batched Cholesky and the Cholesky solve — in shared memory below n = 240,
with the matrix in device memory from there — the two G matvecs, and the
Riccati factor and solve sweeps K6 / K7), holds each against its plain
PyTorch version on the card, and drives the paths of the port below at
full width, every kernel's launch count set to 0 just before a path and
read just after:

* the calibrated batched step — ``mpc_step_batch`` on the randomized
  4-vehicle circle batch, B = 1024, hp = hu = 20, float32, ``tuned_f32`` with
  ``TUNED_F32_PHASES`` (the fused IPM kernel) — for 6 chained steps and 5
  timed ones (12 and 10 before the other two paths joined the script; the
  depth was cut to keep the run short, every check is unchanged);
* the adaptive path — the same batch with the DEFAULT configuration
  (adaptive IPM: Cholesky, solve and both matvec kernels), 4 chained steps;
* the per-instance path — ``simulate`` of ONE nominal scenario for the full
  50 steps through ``mpc_step`` (B = 1 through the Cholesky and solve
  kernels) with the latency of each step, its step 0 repeated through the
  plain versions and in float64, then ``simulate`` against
  ``simulate_batch`` at B = 64;
* the long-horizon path — ``mpc_step_batch``, circle, 4 vehicles,
  hp = hu = 64, B = 256, ``tuned_f32`` (``qp_kkt="auto"`` routes past K1's
  shared-memory gate to the banded KKT: K6 / K7, and K1 must not launch;
  exactly two K7 launches per K6 launch, the first of them with two
  right-hand sides), 4 chained steps, the first repeated through the plain
  sweeps;
* the one-scenario banded step — ``mpc_step`` of one circle-4 scenario at
  hp = 64 with ``qp_kkt="banded"`` (B = 1 through K6 / K7, two K7 launches
  per K6 launch), 6 steps of latency, step 0 repeated through the plain
  sweeps and in float64;
* the dense-fused path — ``mpc_step_batch``, frog (one vehicle), hp = hu =
  20, B = 1024, ``tuned_f32`` (K2: one launch per QP, every fixed iteration
  in it, checked against the QP count), 4 chained steps, also through the
  plain version, every K2 launch of the first step shadowed; K2 against
  its plain version on the first QP's inputs for one iteration and for all
  of them at widths on both sides of its launch-bound switch, each launch
  of all iterations also against as many chained launches of one, and on
  odd shapes (a dense P, no slack elimination, G past shared memory);
* (g) the calibrated one-scenario controller at the long horizon —
  ``mpc_step`` of one circle-4 scenario at hp = 64 under ``tuned_f32`` as
  it stands (``qp_kkt="auto"``: per instance the dense KKT, so the factor
  and the solve at n = 257, B = 1, past the shared-memory kernels: the
  factor over a thread block cluster of 8 CTAs; no Riccati sweep, no K1),
  6 steps of latency, step 0 through the plain
  versions and in float64, and against the banded one-scenario step's
  step 0 (the same QPs through the banded KKT);
* (h) one QP of the adaptive dense branch at hp = 64, B = 256 — the
  long-horizon path's first QP through ``solve_qp_batched(fixed_iters=None,
  kkt="dense")`` with the DEFAULT adaptive settings (the factor, the solve
  and both G products at n = 257, mg = 384), against the plain versions
  and float64;
* (i) the side-selection controller (``controller="side_selection"``,
  ``tuned_f32`` updated by ``TUNED_F32_SIDE_SELECTION``) through
  ``mpc_step_batch`` on the randomized frog batch, B = 1024, hp = hu = 10:
  exactly two K2 launches a step (the 5,120-wide first-round candidates at
  8 iterations, the 1,024-wide reselection round at 12) and two of the G
  product (each QP's cold-start G x0), 4 chained steps
  and 3 timed ones, also through the plain version, then 2 steps in
  rotated-rectangle mode;
* (ii) the same on the randomized 11-vehicle parallel batch, B = 256: two
  K1 launches a step (1,280 and 256 wide, lower-triangular slabs with the
  hard steering-rate rows), the dense rows never scattered;
* (iii) ONE nominal frog scenario under the same controller through
  ``mpc_step`` for the full closed loop: step latency, two K2 and two
  G-product launches a step (5 and 1 wide);
* (l) the shapes past one block's shared memory, where K1 and K2 keep the
  KKT matrix and its factor in the shared memory of a thread block
  cluster (their cluster tiers): (l1) side
  selection at parallel-11, hp = hu = 20, B = 256 (two K1 launches a step
  in the cluster tier, 1280 and 256 wide, each first launch bit for bit
  K1's device tier forced and timed beside it), (l2) circle-4 at hp = 64,
  B = 256, ``tuned_f32`` with ``qp_kkt="dense"`` (K1's cluster tier at
  nu = 256, the full width against the device tier likewise; step 0 also
  against the long-horizon path's banded step), (l3) that path's first QP
  on its dense rows through K2's cluster tier (n = 257; against the device
  tier forced on the same inputs under the yardstick, both timed), (l4)
  each kernel forced into its device and its cluster tier against its
  shared tier on identical inputs at the bench and frog shapes (bit for
  bit expected, but K2's cluster tier, whose product sums in another order:
  the yardstick), (l5) circle-16 at hp = 10, B = 256
  (``TUNED_F32_V16``: K1's shared tier with its slabs packed) and (l6) the
  DEFAULT (adaptive) side-selection settings on frog, B = 64 (the factor,
  the solve and both G products);
* (m) K1's global tier, past its device tier's own carve (the step's
  vectors in device memory too): (m1) forced on path (l)'s inputs, bit
  for bit the cluster tier on (l1)'s launches and the device tier on
  (l1)'s wide launch, (l2)'s and at the bench shape, timed beside them;
  (m2) the calibrated side-selection step at parallel-11, hp = hu = 64,
  B = 64 (two K1 launches a step in the global tier, 320 and 64 wide; 3
  chained steps, the first also through the plain versions and float64,
  the feasible share against the plain versions'); (m3) one circle-16
  hp = 64 QP under ``qp_kkt="dense"`` (B = 4) against its plain version;
  (m4) ``cli run --controller side_selection --scenario parallel --hp 64
  --steps 1``;
* (n) the banded KKT past 24 vehicles, K6 / K7 in their device tier (a CTA
  per instance, the cost-to-go in a device-memory workspace): (n1) both
  sweeps against their plain versions, float64 and 2^-23-perturbed inputs
  at V = 25 / 32 / 48, V = 4 forced into the device tier beside its shared
  tier, the workspace instantiations at V = 25; (n2) the calibrated
  circle-32 step at hp = hu = 20, B = 64 (every K6 / K7 launch in the
  device tier, two K7 a K6, no K1; two chained steps, also through the
  plain versions, whose feasible share floors the kernels'); (n3) ``cli
  run --scenario circle --n-veh 25 --steps 2``, one scenario and
  ``--mc 8``;
* (o) K2's global tier, past its device tier's own carve (the step's
  vectors in device memory too): (o1) forced beside its twins on identical
  inputs, bit for bit the device tier at frog hp = 20 (B = 1,024), at
  (l3)'s first QP and on frog side selection's first launch at hp = 155
  (B = 64), and against the cluster tier at hp = 168 under the yardstick,
  each timed beside its twin; (o2) the calibrated side-selection step at
  frog, hp = hu = 180, B = 64 (two K2 launches a step in the global tier,
  320 and 64 wide, mg = 4,320, n = 181; 2 chained steps, the first also
  through the plain versions and float64, the feasible share against the
  plain versions'; the first launch under the max-shared and the max-L1
  carve-out); (o3) ``cli run --controller side_selection --scenario frog
  --hp 180 --steps 2`` and ``cli run --scenario frog --hp 180 --kkt dense
  --mc 8 --steps 2``;
* (j) the entry points a user calls: ``scp_tpu_torch.bench.worker()`` at
  its own settings (K1 on its throughput steps, K3 / K4 on its latency
  steps; its solves/s and latency printed beside paths (a) and (c)), and
  ``scp_tpu_torch.cli.main`` — ``run`` with its defaults (circle-8,
  hp = 10, 50 steps; ``--out`` and ``--export-json`` read back: K3 / K4),
  ``run --mc 64 --noise`` (K1), frog under ``--controller side_selection``
  (K2, K5a) and circle-4 at ``--hp 64 --kkt banded`` (K6, K7) — each
  call's launches counted; frog side selection again with ``--kkt
  banded``, which has no effect there (the same launches and summary);
  ``--f64`` on the card refused before any launch; a checkpoint saved and
  resumed mid-run at B = 64 with plant noise, bit for bit the straight
  run; and
  ``utils.debug.determinism_check`` of one calibrated step;
* (k) scale-out (``scp_tpu_torch.parallel``), last: (k1) the data-parallel
  ``sweep`` under a one-rank NCCL process group at the bench shape
  (``--batched``, B = 1024, K1), checkpointed every 3 of 6 steps, a run
  killed after 3 and resumed bit for bit the uninterrupted one, its
  solves/s beside path (a)'s, and ``python -m scp_tpu_torch.cli sweep`` of
  the same flags in its own process with the same summary; (k2) two ranks
  on this one card under gloo with CUDA tensors (this script re-run with
  ``--scale-out-worker``): the batched sweep, each rank's 512-instance
  block bit for bit a one-rank sweep of that block, and three chained
  horizon-sharded steps at hp = 64, B = 16 (32 horizon steps a rank: the
  factor and the solve at n = 257 on both ranks) against the unsharded
  steps under the yardstick of 2^-23-perturbed inputs.

On (i) to (iii) every launch of the first step is held against its plain
version (the G product also on the same G with a random x), and step 0 is
repeated through the plain versions, in float64 and on inputs perturbed by
2^-23 (the yardstick of the controller's discrete flags); on (iii), whose
step 0 drives straight, so is the first step that steers.

The fused IPM kernel is also held against its plain version on an
instance whose KKT matrix is not positive definite (it must freeze, its
state kept, as there). The Cholesky, solve and G-product kernels are also
held at their edges: the factor and the solve at n = 1, 15, 16, 17, 32, 33,
81, 239 and B = 1, 3, 1023 (across their 16-column panels and blocks) with
an indefinite instance (a NaN factor) among good ones, and past the
shared-memory kernels at n = 240, 257, 330, 400 and B = 1, 256, 1024 (the
factor over a thread block cluster, each case also bit for bit the one-CTA
kernel with the matrix in device memory) with an indefinite instance among
good ones at n = 257 (again over 8 CTAs, its failing pivot on rank 6, alone
and among good ones); both
G products on the dense P shape (1024, 81, 81) with unaligned instance
bases, views that start 4 bytes past a 16-byte boundary, a tile larger than
one stage (900 x 65), B = 1, the hp = 64 shape (256, 384, 257) and rows
wider than a stage (one column past it, and 60,000 columns); G^T v also
twice on the same inputs, bit for bit (its cluster's partial sums are added
in a fixed order), and with one instance's v NaN among good ones. The
Riccati factor and solve are held against their plain versions and a
float64 oracle on the long-horizon path's inputs at
B = 256 / 64 / 16 with one and two right-hand sides (a two-right-hand-side
launch against two launches of one), and at V = 1, 3, 6 (more rows than a
warp has lanes) and 16.

It times every kernel beside its plain version, the PyTorch library call
that computes the same function (where there is one) and the card's bound
(the fused IPM kernel by CUDA-graph replay at each width, with the CTAs an
SM holds; the factor also at B = 1, the G product also on the P shape; the
Riccati sweeps by graph replay also at B = 1 and the solve also with two
right-hand sides; the
factor, the solve and the G products at the widest B also with a cold L2;
the factor and the solve at n = 257, B = 256 and 1, warm and cold),
prints each kernel's time over the library call's, and prints one JSON
object per phase. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failing phase ends the run with a non-zero exit code; without a GPU the
script exits non-zero at once and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import torch

BATCH = 1024
N_VEH = 4
HP = 20
SEED = 42
MAIN_STEPS = 6
TIMED_STEPS = 5
FEASIBLE_FLOOR = 0.95      # share of feasible instances over the main steps

# Kernel-vs-plain limits (float32, same inputs, n_iters = 7). The two
# versions sum in different orders and factor with different algorithms, and
# the late IPM iterations amplify that through barrier weights z/s of up to
# 1e10, so single instances drift apart: after ONE iteration they agree to
# round-off (limit 1e-4 on every variable), after seven the limit is on the
# controls (radians, box +-0.052) — max and median over the batch — and the
# kernel must be no further from the float64 oracle (the plain version in
# float64) than twice what the plain float32 version is. The slack variable
# (last entry of x) lives on a scale of its own and is reported, not limited.
U_ABS_LIMIT = 5e-3
U_MEDIAN_LIMIT = 5e-5
ONE_ITER_LIMIT = 1e-4
# End-to-end: first step's clamped control prediction, per instance (max over
# horizon and vehicles), the step through the kernel against the step through
# the plain version. Every launch of that step is limited on every instance
# on identical inputs (above); over the SCP iterations the non-convex outer
# loop amplifies the two float32 solvers' round-off differently, so single
# instances end well apart although no launch disagreed. The step check
# therefore limits the median and the 99th percentile of the difference, and
# holds EVERY instance against the same step in float64: the kernel's step
# may be no further from it than twice the plain float32 step is, plus the
# limit (an instance where float32 itself does not fix the answer is allowed
# that much, and no more).
UPRED_ABS_LIMIT = 5e-3
UPRED_MEDIAN_LIMIT = 1e-4

# ---- the batched Cholesky, the Cholesky solve and the two G matvecs ----
ADAPTIVE_STEPS = 4
ADAPTIVE_FEASIBLE_FLOOR = 0.95
SIM_FEASIBLE_FLOOR = 0.90   # share of feasible steps of the one-scenario run
LATENCY_REPS = 3            # repeats of the same step per latency sample
PAIR_BATCH, PAIR_STEPS = 64, 5
# Kernel-vs-plain limits (float32, identical inputs). A factor or a solve is
# backward stable, not forward stable: two correct float32 algorithms differ
# by (condition number) x (round-off), and the late IPM iterations factor
# matrices conditioned up to ~1e6. So every case limits what IS independent
# of conditioning — the factor's residual max|L L^T - K| against the
# unit-diagonal K (n * eps = 5e-6 at n = 81; limit 2e-5), and the kernel's
# distance from a float64 oracle on the same float32 inputs, which may be no
# more than twice the plain float32 version's plus 1e-5 of the result's
# scale — and the FIRST IPM iteration's inputs (well conditioned: mu = 1)
# also limit the plain difference itself: 1e-4 of max|L| or max|x|. The
# matvecs sum 81 or 120 products in another order than the library: 2e-5 of
# the result's scale. On the tenth iteration's inputs the float64 limit is
# four times wider (two factorization orders on a worse-conditioned matrix).
FACTOR_RESIDUAL_LIMIT = 2e-5
LATER_ITER_SLACK = 4.0      # the float64 limit is this much wider there
FIRST_ITER_REL_LIMIT = 1e-4
MATVEC_REL_LIMIT = 2e-5
FLAGS_AGREE_FLOOR = 0.99
# n past the shared-memory factor and solve (from 240 the matrix stays in
# device memory): the hp = 64 shape's 257, and two more above it
LARGE_NS = (240, 257, 330, 400)
LARGE_WIDTHS = (1, 256, 1024)   # the batch widths of every large-n case
SOLVE_WIDTHS = (1, 16, 256, 1024)   # ... of the staged solve's bit check

# Published peaks of one H100 SXM (dense, no sparsity).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


# device_ms: profiler sessions that came back incomplete and were repeated
INCOMPLETE_PROFILER_SESSIONS = 0


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def k1_work(P, S, hp, hu, V, B, n_iters, n_cor, lower_tri):
    """Bytes the fused IPM call must move (each input read once, each output
    written once) and the f32 operations the function needs, for B QPs.

    With ``lower_tri`` slab row k is zero beyond column k, and only the
    non-zero entries are counted. A multiply-add counts as two operations.
    """
    nu = V * hu
    n = nu + 1
    mg = (P + S) * hp
    m = mg + 2 * n
    sides = 2 * P + S                      # slabs (a pair has two)
    state = 7 * n + 3 * mg + 2
    words_in = sides * hp * hu + V * hu * hu + mg + 2 * n + state
    words_out = state
    # per slab: non-zeros, and the (row, entry) terms a slab adds to the
    # lower triangle of a diagonal block and to a full cross block of K
    nz = [min(k + 1, hu) if lower_tri else hu for k in range(hp)]
    row_nz = sum(nz)
    tri_terms = sum(c * (c + 1) // 2 for c in nz)
    sq_terms = sum(c * c for c in nz)
    # per iteration
    k_form = (sides * row_nz                            # t = w * g, per row
              + 2 * (sides * tri_terms + P * sq_terms)  # one FMA per term
              + V * hu * (hu + 1) // 2                  # + P blocks
              + 4 * (nu * (nu + 1) // 2))               # Jacobi scale, border
    chol = nu ** 3 / 3
    solves = (2 + n_cor) * 2 * nu * nu
    slab_mv = 2 * sides * row_nz + 2 * mg   # one G or G^T product, slack incl.
    matvecs = (5 + 2 * n_cor) * slab_mv + 2 * V * hu * hu
    vec = (40 + 25 * n_cor) * m
    flops = n_iters * (k_form + chol + solves + matvecs + vec)
    return 4 * (words_in + words_out) * B, flops * B


def bound_of(nbytes, flops):
    """Least time the card could take: the bytes over the memory rate
    against the operations over the float32 peak; and which of the two."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def k1_bound_ms(shape, B, n_iters, n_cor, lower_tri):
    return bound_of(*k1_work(*shape, B, n_iters, n_cor, lower_tri))


def time_cuda(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernels_per_call: int | None = None) -> float:
    """Milliseconds of DEVICE time per call: the kernels' own durations as
    ``torch.profiler`` records them, summed over ``reps`` calls. A call of
    tens of microseconds is otherwise timed by the host that enqueues it
    (``time_cuda`` measures that: what a caller pays per call).

    Every call launches the same kernels, so a complete session records
    each kernel a multiple of ``reps`` times, and exactly ``reps x
    kernels_per_call`` kernel events where the caller knows that number (a
    wrapper: one). A session that records no device time or a count that
    breaks this is incomplete: it is repeated (``INCOMPLETE_PROFILER_
    SESSIONS`` counts those), and five incomplete sessions in a row fail
    the run — a host time never stands in for a device time."""
    global INCOMPLETE_PROFILER_SESSIONS
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if getattr(e, "device_time_total", 0) > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.device_time_total for e in kern)
        counts = [e.count for e in kern]
        complete = us > 0 and all(c % reps == 0 for c in counts) and (
            kernels_per_call is None
            or sum(counts) == reps * kernels_per_call)
        if complete:
            return us / 1e3 / reps
        INCOMPLETE_PROFILER_SESSIONS += 1
        print(f"chip_smoke: incomplete profiler session ({reps} calls, "
              f"kernel events {counts}), repeated", file=sys.stderr,
              flush=True)
    fail("torch.profiler recorded no complete session in five")


# Bytes of other inputs read between two reads of one input in a cold-L2
# timing: five times an H100's 50 MB L2.
L2_ROTATE_BYTES = 256 << 20


def rotating_copies(args) -> list[tuple]:
    """Copies of the tensors ``args`` such that, used in turn, at least
    ``L2_ROTATE_BYTES`` of the others are read between two uses of one."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    count = 1 + -(-L2_ROTATE_BYTES // nbytes)
    return [tuple(a.clone() for a in args) for _ in range(count)]


def rotate(fn, copies):
    """A call of ``fn`` on the next of ``copies`` (cyclically) per call."""
    state = {"i": 0}

    def call():
        args = copies[state["i"] % len(copies)]
        state["i"] += 1
        return fn(*args)
    return call


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Milliseconds of device time per call of a kernel wrapper: ``reps``
    calls captured in a CUDA graph, and CUDA events around ``replays``
    replays of it, so no host time lies between the launches. Late in this
    script ``torch.profiler`` drops kernel records (sessions of 20 launches
    recorded 3 to 15), which ``device_ms`` detects; graph replay and a
    complete profiler session agree to 1% on these kernels
    (``scripts/torch_kernel_check.py --times``)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def compare(args, kw, out_k, plain) -> dict:
    """Errors of the kernel's controls against the plain float32 version and
    the float64 oracle (the plain version in float64) on the same inputs."""
    nu = args[7].shape[1] - 1

    def err(a, b):
        return (a - b).abs().amax(dim=1).double()

    finite = all(bool(torch.isfinite(t).all()) for t in out_k)
    out_p = plain(*args, **kw)
    args64 = [None if a is None else a.double() for a in args]
    out_d = plain(*args64, **{**kw, "reg_rel": 1e-12})
    uk, up, ud = out_k[0][:, :nu], out_p[0][:, :nu], out_d[0][:, :nu].float()
    e_kp, e_kd, e_pd = err(uk, up), err(uk, ud), err(up, ud)
    return {"B": args[0].shape[0], "finite": finite,
            "u_kernel_vs_plain_max": float(e_kp.max()),
            "u_kernel_vs_plain_median": float(e_kp.median()),
            "u_kernel_vs_f64_max": float(e_kd.max()),
            "u_plain_vs_f64_max": float(e_pd.max()),
            "slack_kernel_vs_plain_max": float(
                (out_k[0][:, nu] - out_p[0][:, nu]).abs().max()),
            "frozen_kernel": float(out_k[10][:, 1].mean()),
            "frozen_plain": float(out_p[10][:, 1].mean())}


def off_limits(rep: dict, u_abs: float, u_median: float) -> bool:
    return (not rep["finite"]
            or rep["u_kernel_vs_plain_max"] > u_abs
            or rep["u_kernel_vs_plain_median"] > u_median
            or rep["u_kernel_vs_f64_max"]
            > 2 * rep["u_plain_vs_f64_max"] + 1e-4)


def check_kernel(case, args, kw, kernel, plain, u_abs=U_ABS_LIMIT,
                 u_median=U_MEDIAN_LIMIT) -> dict:
    """Run the kernel, its plain float32 version and the float64 oracle on
    the same inputs; fail if the kernel is off; return the report."""
    out_k = kernel(*args, **kw)
    torch.cuda.synchronize()
    one_k = kernel(*args, **{**kw, "n_iters": 1})
    one_p = plain(*args, **{**kw, "n_iters": 1})
    # x, the duals, the residuals and mu (the slack's own entries, the last
    # column, are on a 1e8 scale and left out, as are the primal slacks)
    one = max(float((a - b)[:, :-1].abs().max())
              for a, b in zip(one_k[:1] + one_k[4:], one_p[:1] + one_p[4:]))
    rep = {"phase": "kernel_vs_plain", "case": case,
           "n_iters": kw["n_iters"], "n_cor": kw["n_cor"],
           **compare(args, kw, out_k, plain),
           "one_iter_max_abs_err": one,
           "limits": {"u_abs": u_abs, "u_median": u_median,
                      "one_iter": ONE_ITER_LIMIT,
                      "vs_f64": "2 x plain float32's + 1e-4"}}
    emit(rep)
    if off_limits(rep, u_abs, u_median) or one > ONE_ITER_LIMIT:
        fail(f"{case}: the kernel disagrees with its plain version: {rep}")
    return rep


def linalg_bound_ms(kind: str, B: int, n: int, m: int = 0):
    """Least time the card could take for one call: the bytes the function
    needs (each input read once, each output written once) over the memory
    rate against operations (two per multiply-add) over the float32 peak.
    K is symmetric and only the lower triangle of L is a result or read by
    the solve, so a factor needs n(n+1)/2 floats in and as many out and
    n^3/6 multiply-adds, and a solve n(n+1)/2 floats of L, b and x and n^2
    multiply-adds (two triangular solves of n^2/2 each)."""
    tri = n * (n + 1) // 2
    if kind == "cholesky":
        nbytes, flops = 4 * 2 * tri, n ** 3 / 3
    elif kind == "cho_solve":
        nbytes, flops = 4 * (tri + 2 * n), 2 * n * n
    else:                                   # gmv / gtmv
        nbytes, flops = 4 * (m * n + m + n), 2 * m * n
    return bound_of(B * nbytes, B * flops)


def _scale(t):
    return float(t.abs().max())


def check_factor(case, K, kernel, plain, first_iter: bool) -> dict:
    """Cholesky kernel against the plain version and a float64 factor of the
    same float32 matrix; lower triangles only."""
    L_k, L_p = kernel(K), plain(K)
    torch.cuda.synchronize()
    L_d = plain(K.double())
    ok_rows = torch.isfinite(L_p).all(dim=(1, 2)) \
        & torch.isfinite(L_d).all(dim=(1, 2))
    same_nan = bool((torch.isfinite(L_k).all(dim=(1, 2)) == ok_rows).all())
    Lk, Lp, Ld, Kk = (torch.tril(t[ok_rows]) for t in (L_k, L_p, L_d, K))
    resid = _scale(torch.tril(Lk.double() @ Lk.double().transpose(1, 2)
                              - Kk.double()))
    slack = 1.0 if first_iter else LATER_ITER_SLACK
    e_kp = _scale(Lk - Lp)
    e_kd, e_pd = _scale(Lk.double() - Ld), _scale(Lp.double() - Ld)
    rep = {"phase": "kernel_vs_plain", "kernel": "cholesky", "case": case,
           "B": K.shape[0], "n": K.shape[1],
           "upper_triangle_zero": float(torch.triu(
               L_k[ok_rows], diagonal=1).abs().max()) == 0.0,
           "nan_instances_equal": same_nan,
           "residual_max_abs": resid, "kernel_vs_plain_max_abs": e_kp,
           "kernel_vs_f64_max_abs": e_kd, "plain_vs_f64_max_abs": e_pd,
           "scale_L": _scale(Ld),
           "limits": {"residual": FACTOR_RESIDUAL_LIMIT,
                      "vs_f64": "2 x plain float32's + 1e-5 x max|L|",
                      "first_iter_rel": FIRST_ITER_REL_LIMIT}}
    emit(rep)
    if (not same_nan or not rep["upper_triangle_zero"]
            or resid > FACTOR_RESIDUAL_LIMIT * max(1.0, _scale(Kk))
            or e_kd > slack * (2 * e_pd + 1e-5 * _scale(Ld))
            or (first_iter and e_kp > FIRST_ITER_REL_LIMIT * _scale(Ld))):
        fail(f"{case}: the Cholesky kernel disagrees: {rep}")
    return rep


def check_vector(name, case, kernel, plain, args, rel_limit, first_iter=True):
    """A kernel with a vector result (solve, matvecs) against its plain
    version and the plain version in float64 on the same float32 inputs."""
    out_k, out_p = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    out_d = plain(*[a.double() for a in args])
    ok_rows = torch.isfinite(out_d).all(dim=1) & torch.isfinite(out_p).all(1)
    same_nan = bool((torch.isfinite(out_k).all(dim=1) == ok_rows).all())
    k, p_, d = out_k[ok_rows], out_p[ok_rows], out_d[ok_rows]
    scale = _scale(d)
    e_kp = _scale(k - p_)
    e_kd, e_pd = _scale(k.double() - d), _scale(p_.double() - d)
    rep = {"phase": "kernel_vs_plain", "kernel": name, "case": case,
           "B": args[0].shape[0], "shape": list(args[0].shape[1:]),
           "nan_instances_equal": same_nan,
           "kernel_vs_plain_max_abs": e_kp, "kernel_vs_f64_max_abs": e_kd,
           "plain_vs_f64_max_abs": e_pd, "scale": scale,
           "limits": {"vs_f64": "2 x plain float32's + 1e-5 x scale",
                      "first_iter_rel": rel_limit}}
    emit(rep)
    slack = 1.0 if first_iter else LATER_ITER_SLACK
    if (not same_nan or e_kd > slack * (2 * e_pd + 1e-5 * scale)
            or (first_iter and e_kp > rel_limit * scale)):
        fail(f"{case}: the {name} kernel disagrees: {rep}")
    return rep


def check_repeatable(name, case, kernel, args) -> None:
    """Two launches on the same inputs must agree bit for bit: the kernel
    sums in a fixed order (G^T v: the cluster's partials in rank order)."""
    a, b = kernel(*args), kernel(*args)
    torch.cuda.synchronize()
    same = torch.equal(a, b)
    emit({"phase": "kernel_repeatable", "kernel": name, "case": case,
          "B": args[0].shape[0], "shape": list(args[0].shape[1:]),
          "bit_identical": same})
    if not same:
        fail(f"{case}: two {name} launches on the same inputs differ")


def finite_outputs(outs, what: str) -> None:
    for name, val in outs._asdict().items():
        if val.is_floating_point() and not torch.isfinite(val).all():
            fail(f"{what}: output {name} is not finite")


def u_pred_diff(a, b):
    return (a.u_pred.double() - b.u_pred.double()).abs().amax(dim=(-2, -1))


def linalg_boundary_cases(dev, real, plain) -> None:
    """The redesigned factor (a CTA per instance, 16-column panels), solve
    (16-entry blocks) and G product (row tiles staged in shared memory by a
    bulk copy whose aligned span is decided per launch; a row wider than a
    stage in runs of columns) at their edges, against the plain versions
    and a float64 oracle with ``check_factor`` / ``check_vector``'s
    limits."""
    from scp_tpu_torch.ops import linalg_kernel as lk
    gen = torch.Generator(device=dev).manual_seed(17)

    def spd(b, n):
        a = torch.randn((b, n, n), generator=gen, device=dev,
                        dtype=torch.float64)
        return (a @ a.transpose(1, 2) / n
                + torch.eye(n, device=dev, dtype=torch.float64)).float()

    nb = lk.CHOL_PANEL
    # n across the panel edges, one panel and several
    for n in (1, nb - 1, nb, nb + 1, 32, 33, 81, 239):
        for b in (1, 3, 1023):
            check_factor(f"boundary_n{n}_B{b}", spd(b, n), real["cholesky"],
                         plain["cholesky"], True)
    # one indefinite instance among good ones: NaN there only
    for n in (nb + 1, 33):
        K = spd(6, n)
        L_good = real["cholesky"](K)
        K[2, n // 2, n // 2] = -1.0
        L = real["cholesky"](K)
        torch.cuda.synchronize()
        others = [0, 1, 3, 4, 5]
        nan_ok = (bool(torch.isnan(L[2]).all())
                  and torch.equal(L[others], L_good[others]))
        emit({"phase": "kernel_vs_plain", "kernel": "cholesky",
              "case": f"boundary_one_indefinite_among_good_n{n}",
              "nan_there_only": nan_ok})
        if not nan_ok:
            fail(f"n = {n}: an indefinite instance must be NaN and leave the "
                 f"other instances alone")
        check_factor(f"boundary_one_indefinite_among_good_n{n}_vs_plain", K,
                     real["cholesky"], plain["cholesky"], True)

    # the blocked solve at the same edges (16-entry blocks), on float32
    # factors of SPD matrices, and a NaN factor (the factor's output for an
    # indefinite instance) among good ones: NaN there only
    for n in (1, nb - 1, nb, nb + 1, 32, 33, 81, 239):
        for b in (1, 3, 1023):
            L = plain["cholesky"](spd(b, n)).contiguous()
            rhs = torch.randn((b, n), generator=gen, device=dev)
            check_vector("cho_solve", f"boundary_n{n}_B{b}", real["cho_solve"],
                         plain["cho_solve"], (L, rhs), FIRST_ITER_REL_LIMIT)
    for n in (nb + 1, 81):
        L = plain["cholesky"](spd(6, n)).contiguous()
        rhs = torch.randn((6, n), generator=gen, device=dev)
        x_good = real["cho_solve"](L, rhs)
        L[2] = float("nan")
        x = real["cho_solve"](L, rhs)
        torch.cuda.synchronize()
        others = [0, 1, 3, 4, 5]
        nan_ok = (bool(torch.isnan(x[2]).all())
                  and torch.equal(x[others], x_good[others]))
        emit({"phase": "kernel_vs_plain", "kernel": "cho_solve",
              "case": f"boundary_nan_factor_among_good_n{n}",
              "nan_there_only": nan_ok})
        if not nan_ok:
            fail(f"n = {n}: a NaN factor must give a NaN solution and leave "
                 f"the other instances alone")
        check_vector("cho_solve", f"boundary_nan_factor_among_good_n{n}"
                     "_vs_plain", real["cho_solve"], plain["cho_solve"],
                     (L, rhs), FIRST_ITER_REL_LIMIT)

    # past the shared-memory kernels (n >= 240), B = 1 / 256 / 1024: the
    # factor over a thread block cluster (chol_cluster_kernel) against the
    # plain version, and bit for bit the one-CTA large-n kernel
    # (chol_large_kernel, the matrix in device memory, forced with
    # variant="device") on the same inputs: every entry takes the same
    # operations in the same order in both
    for n in LARGE_NS:
        for b in LARGE_WIDTHS:
            K = spd(b, n)
            if lk.chol_route(b, n) != "cluster":
                fail(f"n = {n}, B = {b}: the factor is routed to "
                     f"{lk.chol_route(b, n)}, the cluster kernel wanted")
            check_factor(f"large_n{n}_B{b}", K, real["cholesky"],
                         plain["cholesky"], True)
            same = torch.equal(real["cholesky"](K),
                               lk.cholesky(K, variant="device"))
            emit({"phase": "kernel_vs_plain", "kernel": "cholesky_cluster",
                  "case": f"large_n{n}_B{b}_vs_chol_large_kernel",
                  "cluster_ctas": lk.chol_cluster_geometry(b, n)[0],
                  "bit_identical": same})
            if not same:
                fail(f"n = {n}, B = {b}: the cluster factor differs from "
                     f"chol_large_kernel's on the same inputs")
            del K
            L = plain["cholesky"](spd(b, n)).contiguous()
            rhs = torch.randn((b, n), generator=gen, device=dev)
            check_vector("cho_solve", f"large_n{n}_B{b}", real["cho_solve"],
                         plain["cho_solve"], (L, rhs), FIRST_ITER_REL_LIMIT)
    # the large-n solve on its staged triangle (cho_solve_staged_kernel,
    # n <= 331, forced past the batch the route gives it) bit for bit the
    # parent's one-CTA solve (cho_solve_large_kernel, forced with
    # variant="device") on the same inputs at every LARGE_NS x B = 1 / 16 /
    # 256 / 1,024 — the same operations in the same order (n = 400, past
    # one block, takes that kernel itself); garbage above L's diagonal,
    # which neither may read
    for n in LARGE_NS:
        for b in SOLVE_WIDTHS:
            L = plain["cholesky"](spd(b, n)).contiguous()
            L += torch.triu(torch.full_like(L, 7.0), 1)
            rhs = torch.randn((b, n), generator=gen, device=dev)
            fits = lk.solve_staged_smem_bytes(n) <= lk.SMEM_LIMIT_BYTES
            before = lk.launch_counts["cho_solve_staged"]
            x_s = lk.cho_solve(L, rhs, variant="staged" if fits else None)
            staged = lk.launch_counts["cho_solve_staged"] - before
            same = torch.equal(x_s, lk.cho_solve(L, rhs, variant="device"))
            emit({"phase": "kernel_vs_plain", "kernel": "cho_solve_staged",
                  "case": f"large_n{n}_B{b}_vs_cho_solve_large_kernel",
                  "route": lk.solve_route(b, n), "staged_launches": staged,
                  "bit_identical": same})
            if not same or staged != fits:
                fail(f"n = {n}, B = {b}: the large-n solve ({staged} staged "
                     f"launches) differs from cho_solve_large_kernel's on "
                     f"the same inputs")
            del L
    n = 257
    K = spd(6, n)
    L_good = real["cholesky"](K)
    K[2, n // 2, n // 2] = -1.0
    L = real["cholesky"](K)
    rhs = torch.randn((6, n), generator=gen, device=dev)
    x_good = real["cho_solve"](L_good, rhs)
    L_nan = L_good.clone()
    L_nan[2] = float("nan")
    x = real["cho_solve"](L_nan, rhs)
    torch.cuda.synchronize()
    others = [0, 1, 3, 4, 5]
    nan_ok = (bool(torch.isnan(L[2]).all()) and bool(torch.isnan(x[2]).all())
              and torch.equal(L[others], L_good[others])
              and torch.equal(x[others], x_good[others]))
    emit({"phase": "kernel_vs_plain", "kernel": "cholesky / cho_solve",
          "case": f"large_n{n}_one_indefinite_among_good",
          "nan_there_only": nan_ok})
    if not nan_ok:
        fail(f"n = {n}: an indefinite instance (a NaN factor) must be NaN "
             f"and leave the other instances alone")
    check_factor(f"large_n{n}_one_indefinite_among_good_vs_plain", K,
                 real["cholesky"], plain["cholesky"], True)
    # ... again over a cluster of 8 CTAs, the failing pivot (row 100,
    # stripe 6) on rank 6: alone (B = 1) and among good instances (B = 3)
    for b in (1, 3):
        K = spd(b, n)
        L_good = real["cholesky"](K)
        bad = b // 2
        K[bad, 100, 100] = -1.0
        L = real["cholesky"](K)
        torch.cuda.synchronize()
        geo = lk.chol_cluster_geometry(b, n)
        owner = lk.stripe_deal(n, geo[0])[0][100 // lk.CHOL_STRIPE]
        others = [i for i in range(b) if i != bad]
        nan_ok = (bool(torch.isnan(L[bad]).all())
                  and torch.equal(L[others], L_good[others])
                  and geo[0] == 8 and owner != 0)
        emit({"phase": "kernel_vs_plain", "kernel": "cholesky_cluster",
              "case": f"large_n{n}_B{b}_indefinite_pivot_on_rank_{owner}",
              "cluster_ctas": geo[0], "nan_there_only": nan_ok})
        if not nan_ok:
            fail(f"n = {n}, B = {b}, a cluster of {geo[0]}: a pivot that "
                 f"fails on rank {owner} must make that instance NaN and "
                 f"leave the others alone")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # the dense P product's shape: 26,244-byte instances, so every base but
    # one in four is not 16-byte aligned; P[1:] starts 4 bytes past 16
    P = randn(1024, 81, 81)
    x = randn(1024, 81)
    flat = randn(64 * 120 * 81 + 1)
    stage = lk.GMV_STAGE_BYTES // 4 - 3     # floats of one stage
    cases = {
        "boundary_P_shape_B1024": (P, x),
        "boundary_P_view_from_1": (P[1:], x[1:]),
        "boundary_view_base_4_bytes_past_16":
            (flat[1:].view(64, 120, 81), randn(64, 81)),
        "boundary_m900_n65_above_one_stage": (randn(3, 900, 65),
                                              randn(3, 65)),
        "boundary_B1": (randn(1, 120, 81), randn(1, 81)),
        "boundary_row_one_column_past_a_stage": (randn(2, 3, stage + 1),
                                                 randn(2, stage + 1)),
        "boundary_row_of_60000": (randn(2, 3, 60000), randn(2, 60000)),
        "boundary_hp64_B256_m384_n257": (randn(256, 384, 257),
                                         randn(256, 257))}
    for case, args in cases.items():
        B, m, n = args[0].shape
        emit({"phase": "gmv_geometry", "case": case,
              "base_mod_16": args[0].data_ptr() % 16,
              "rows_cols_smem": list(lk.gmv_geometry(B, m, n)),
              "gtmv_threads_tiles_rows_chunk_cols_smem":
                  list(lk.gtmv_geometry(B, m, n, *lk.sm_resources(dev)))})
        check_vector("gmv", case, real["gmv"], plain["gmv"], args,
                     MATVEC_REL_LIMIT)
        # G^T v on the same G, twice: bit for bit
        t_args = (args[0], randn(B, m))
        check_vector("gtmv", case, real["gtmv"], plain["gtmv"], t_args,
                     MATVEC_REL_LIMIT)
        check_repeatable("gtmv", case, real["gtmv"], t_args)


def linalg_phases(dev, card, B, n_veh, hp, seed, widths=(1024, 256, 64),
                  pair_batch=PAIR_BATCH, pair_steps=PAIR_STEPS,
                  adaptive_steps=ADAPTIVE_STEPS, sim_steps=None,
                  timing_reps=50) -> list[dict]:
    """Everything about the Cholesky, solve and matvec kernels: against
    their plain versions, the adaptive path, the per-instance path, times.
    Returns their entries of the ``kernels`` line."""
    import numpy as np

    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.ops import ipm_kernel, linalg, linalg_kernel as lk
    from scp_tpu_torch.scenarios import batch as batch_lib, builders
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.solvers import qp, scp

    names = ("cholesky", "cho_solve", "gmv", "gtmv")
    real = {k: getattr(lk, k) for k in names}
    plain = {"cholesky": linalg.cholesky_plain,
             "cho_solve": linalg.cho_solve_plain,
             "gmv": linalg.gmv_plain, "gtmv": linalg.gtmv_plain}
    reports = {
        "cholesky": {"name": "cholesky", "replaces":
                     "scp_tpu/ops/pallas_linalg.py:220",
                     "also_replaces": "scp_tpu/ops/pallas_linalg.py:305"},
        "cho_solve": {"name": "cho_solve", "replaces":
                      "scp_tpu/ops/pallas_linalg.py:241",
                      "also_replaces": "scp_tpu/ops/pallas_linalg.py:340"},
        "gmv": {"name": "gmv", "replaces":
                "scp_tpu/ops/pallas_linalg.py:261"},
        "gtmv": {"name": "gtmv", "replaces":
                 "scp_tpu/ops/pallas_linalg.py:282"}}
    for r in reports.values():
        r.update(route="cuda", source="scp_tpu_torch/csrc/linalg.cu")

    # ---- the adaptive path's configuration: the DEFAULT solver settings ----
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg, data = batch_lib.make_batch("circle", B, generator=gen,
                                     dtype=torch.float32, device=dev,
                                     n_veh=n_veh)
    cfg = cfg.replace(hp=hp, hu=hp)
    if cfg.qp_fixed_iters or cfg.qp_kkt != "dense":
        fail("the default configuration is not the adaptive dense one")
    carry0 = engine.init_carry(cfg, data)

    # A first step with a shadow around each wrapper: the first full-width
    # call of each kernel (the first IPM iteration of the first QP: mu = 1,
    # well conditioned) and the factor / solve inputs of the tenth iteration
    # (barrier weights grown, worse conditioned) are kept.
    # (the G product's first two calls are initial residuals at x = u_warm = 0:
    # its third, the predictor's G dx, is kept instead)
    FIRST = {"gmv": 2}
    # (the tenth IPM iteration: one factor, two solves and three G^T v per
    # iteration — its residual, then the predictor's and the corrector's
    # right-hand sides)
    LATER = {"cholesky": 9, "cho_solve": 19, "gtmv": 27}
    n_calls = {k: 0 for k in names}
    captured: dict[str, dict] = {k: {} for k in names}

    def shadow(name):
        def call(*args):
            if args[0].shape[0] == B:
                if n_calls[name] in (FIRST.get(name, 0), LATER.get(name)):
                    captured[name][n_calls[name]] = args
                n_calls[name] += 1
            return real[name](*args)
        return call

    for k in names:
        setattr(lk, k, shadow(k))
    try:
        torch.cuda.reset_peak_memory_stats()
        carry1, out1 = engine.mpc_step_batch(cfg, data, carry0)
        torch.cuda.synchronize()
    finally:
        for k in names:
            setattr(lk, k, real[k])
    for k in names:
        if FIRST.get(k, 0) not in captured[k]:
            fail(f"no full-width call of {k} was captured")
    first = {k: captured[k][FIRST.get(k, 0)] for k in names}
    n = first["cholesky"][0].shape[1]
    mg = first["gmv"][0].shape[1]
    if first["gmv"][0].shape[2] != n:
        fail("the first matvec captured is not the G product")

    # ---- kernel against its plain version ----
    for w in widths:
        if w > B:
            continue
        cut = {k: tuple(a[:w].contiguous() for a in first[k]) for k in names}
        rep = check_factor(f"first_ipm_iteration_B{w}", cut["cholesky"][0],
                           real["cholesky"], plain["cholesky"], True)
        if w == widths[0]:
            reports["cholesky"]["max_abs_err"] = \
                rep["kernel_vs_plain_max_abs"]
        for k, lim in (("cho_solve", FIRST_ITER_REL_LIMIT),
                       ("gmv", MATVEC_REL_LIMIT), ("gtmv", MATVEC_REL_LIMIT)):
            rep = check_vector(k, f"first_ipm_iteration_B{w}", real[k],
                               plain[k], cut[k], lim)
            if w == widths[0]:
                reports[k]["max_abs_err"] = rep["kernel_vs_plain_max_abs"]
        check_repeatable("gtmv", f"first_ipm_iteration_B{w}", real["gtmv"],
                         cut["gtmv"])
    for k, idx in LATER.items():
        if idx not in captured[k]:
            fail(f"the first step made fewer than {idx + 1} calls of {k}")
    check_factor("tenth_ipm_iteration", captured["cholesky"][9][0],
                 real["cholesky"], plain["cholesky"], False)
    check_vector("cho_solve", "tenth_ipm_iteration", real["cho_solve"],
                 plain["cho_solve"], captured["cho_solve"][19],
                 FIRST_ITER_REL_LIMIT, first_iter=False)
    check_vector("gtmv", "tenth_ipm_iteration", real["gtmv"], plain["gtmv"],
                 captured["gtmv"][27], MATVEC_REL_LIMIT)
    check_repeatable("gtmv", "tenth_ipm_iteration", real["gtmv"],
                     captured["gtmv"][27])
    # G^T v with one instance's v NaN (an instance whose factor failed):
    # NaN there only, the cluster's other instances bit-identical
    G8, v8 = (a[:8].contiguous() for a in first["gtmv"])
    good = real["gtmv"](G8, v8)
    v8 = v8.clone()
    v8[5, 7] = float("nan")
    out8 = real["gtmv"](G8, v8)
    torch.cuda.synchronize()
    others8 = [i for i in range(8) if i != 5]
    nan_ok = (bool(torch.isnan(out8[5]).all())
              and torch.equal(out8[others8], good[others8]))
    emit({"phase": "kernel_vs_plain", "kernel": "gtmv",
          "case": "one_nan_instance_among_good", "nan_there_only": nan_ok})
    if not nan_ok:
        fail("G^T v: a NaN in one instance's v must give NaN there only")
    # odd sizes (n = 31, m = 45: no multiple of 8, 16 or 32), B = 3
    rng = np.random.default_rng(11)
    a = rng.normal(size=(3, 31, 31))
    K_o = torch.as_tensor(a @ a.transpose(0, 2, 1) / 31 + np.eye(31),
                          dtype=torch.float32, device=dev)
    G_o = torch.as_tensor(rng.normal(size=(3, 45, 31)), dtype=torch.float32,
                          device=dev)
    x_o = torch.as_tensor(rng.normal(size=(3, 31)), dtype=torch.float32,
                          device=dev)
    v_o = torch.as_tensor(rng.normal(size=(3, 45)), dtype=torch.float32,
                          device=dev)
    check_factor("odd_sizes", K_o, real["cholesky"], plain["cholesky"], True)
    L_o = real["cholesky"](K_o)
    check_vector("cho_solve", "odd_sizes", real["cho_solve"],
                 plain["cho_solve"], (L_o, x_o), FIRST_ITER_REL_LIMIT)
    check_vector("gmv", "odd_sizes", real["gmv"], plain["gmv"], (G_o, x_o),
                 MATVEC_REL_LIMIT)
    check_vector("gtmv", "odd_sizes", real["gtmv"], plain["gtmv"],
                 (G_o, v_o), MATVEC_REL_LIMIT)
    # n = 129: 66,696 bytes of shared memory per CTA, above the 48 KB a
    # kernel gets without asking for more
    a = rng.normal(size=(2, 129, 129))
    K_l = torch.as_tensor(a @ a.transpose(0, 2, 1) / 129 + np.eye(129),
                          dtype=torch.float32, device=dev)
    b_l = torch.as_tensor(rng.normal(size=(2, 129)), dtype=torch.float32,
                          device=dev)
    check_factor("above_48k_shared_memory", K_l, real["cholesky"],
                 plain["cholesky"], True)
    check_vector("cho_solve", "above_48k_shared_memory", real["cho_solve"],
                 plain["cho_solve"], (real["cholesky"](K_l), b_l),
                 FIRST_ITER_REL_LIMIT)
    # one deliberately indefinite instance: NaN there, the others untouched
    a = rng.normal(size=(8, 31, 31))
    K_i = torch.as_tensor(a @ a.transpose(0, 2, 1) / 31 + np.eye(31),
                          dtype=torch.float32, device=dev)
    L_good = real["cholesky"](K_i)
    K_i[5, 17, 17] = -1.0
    L_i = real["cholesky"](K_i)
    x_i = real["cho_solve"](L_i, torch.ones((8, 31), device=dev))
    torch.cuda.synchronize()
    others = [i for i in range(8) if i != 5]
    nan_ok = (bool(torch.isnan(L_i[5]).all()) and bool(torch.isnan(x_i[5]).all())
              and torch.equal(L_i[others], L_good[others])
              and bool(torch.isfinite(x_i[others]).all()))
    emit({"phase": "kernel_vs_plain", "kernel": "cholesky",
          "case": "one_indefinite_instance", "nan_there_only": nan_ok})
    if not nan_ok:
        fail("an indefinite instance must be NaN and leave the others alone")
    check_factor("one_indefinite_instance_vs_plain", K_i, real["cholesky"],
                 plain["cholesky"], True)
    linalg_boundary_cases(dev, real, plain)
    # float64 CUDA tensors must be refused, not routed to the plain versions
    for k, args in (("cholesky", (K_o,)), ("cho_solve", (L_o, x_o)),
                    ("gmv", (G_o, x_o)), ("gtmv", (G_o, v_o))):
        try:
            real[k](*[t.double() for t in args])
        except TypeError:
            continue
        fail(f"the {k} wrapper accepted float64 CUDA tensors")

    # ---- the adaptive path at full width ----
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    carry, outs = carry0, []
    t0 = time.time()
    for _ in range(adaptive_steps):
        carry, out = engine.mpc_step_batch(cfg, data, carry)
        outs.append(out)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(lk.launch_counts)
    scp_reads, qp_reads = scp.host_sync_count, qp.host_sync_count
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for i, out in enumerate(outs):
        finite_outputs(out, f"adaptive step {i}")
        if out.u_pred.shape != (B, hp, n_veh):
            fail(f"adaptive step {i}: unexpected output shapes")
    feas = float(torch.stack([o.feasible.float().mean() for o in outs]).mean())
    qp_it = sum(float(o.qp_iters.sum()) for o in outs)
    scp_it = sum(float(o.scp_iters.sum()) for o in outs)
    for k in names:
        reports[k]["launches"] = counts[k]
        if counts[k] == 0:
            fail(f"the adaptive path never launched the {k} kernel")
    if ipm_kernel.launch_count != 0:
        fail("the adaptive path launched the fused fixed-iteration kernel")
    # the first step again through the plain versions
    for k in names:
        setattr(lk, k, plain[k])
    try:
        _, out_plain = engine.mpc_step_batch(cfg, data, carry0)
        torch.cuda.synchronize()
    finally:
        for k in names:
            setattr(lk, k, real[k])
    du = u_pred_diff(outs[0], out_plain)
    du_med, du_p99 = float(du.median()), float(du.quantile(0.99))
    agree = float((outs[0].feasible == out_plain.feasible).float().mean())
    emit({"phase": "adaptive_path", "B": B, "n_veh": n_veh, "hp": hp,
          "n": n, "mg": mg, "steps": adaptive_steps,
          "config": "default (adaptive IPM, qp_tol %g, qp_max_iter %d)"
          % (cfg.qp_tol, cfg.qp_max_iter),
          "feasible_share": feas, "feasible_floor": ADAPTIVE_FEASIBLE_FLOOR,
          "launches_per_step": {k: counts[k] / adaptive_steps
                                for k in names},
          "host_reads_per_step": (scp_reads + qp_reads) / adaptive_steps,
          "host_reads_per_step_scp_loop": scp_reads / adaptive_steps,
          "ipm_loop_iterations_per_qp_round":
              counts["cholesky"] / max(qp_reads - counts["cholesky"], 1),
          "mean_scp_iters": scp_it / (B * adaptive_steps),
          "mean_ipm_iters_per_qp": qp_it / max(scp_it, 1.0),
          "step_ms_incl_first_calls": wall / adaptive_steps * 1e3,
          "peak_device_memory_mib": peak_mb,
          "step_vs_plain_u_pred_median": du_med,
          "step_vs_plain_u_pred_p99": du_p99,
          "step_vs_plain_u_pred_max_abs": float(du.max()),
          "step_vs_plain_feasible_agree": agree,
          "step_vs_plain_same_scp_iters": int(
              (outs[0].scp_iters == out_plain.scp_iters).sum()),
          "u_pred_median_limit": UPRED_MEDIAN_LIMIT,
          "u_pred_p99_limit": UPRED_ABS_LIMIT})
    if feas < ADAPTIVE_FEASIBLE_FLOOR:
        fail(f"adaptive path: feasible share {feas} below "
             f"{ADAPTIVE_FEASIBLE_FLOOR}")
    if du_med > UPRED_MEDIAN_LIMIT or du_p99 > UPRED_ABS_LIMIT:
        fail(f"adaptive first step, kernels vs plain: u_pred median {du_med} "
             f"(limit {UPRED_MEDIAN_LIMIT}), 99th percentile {du_p99} "
             f"(limit {UPRED_ABS_LIMIT})")
    # timed: two more warm steps, then the clock
    reset_counts()
    t0 = time.time()
    for _ in range(2):
        carry, _ = engine.mpc_step_batch(cfg, data, carry)
    torch.cuda.synchronize()
    adaptive_step_ms = (time.time() - t0) / 2 * 1e3

    # ---- the per-instance path: ONE scenario, the full closed loop ----
    cfg1, data1 = builders.circle(n_veh, dtype=torch.float32, device=dev)
    cfg1 = config_lib.tuned_f32(cfg1.replace(hp=hp, hu=hp))
    n_sim = cfg1.n_sim if sim_steps is None else sim_steps
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    _, sim = engine.simulate(cfg1, data1, n_steps=n_sim)
    torch.cuda.synchronize()
    sim_counts = dict(lk.launch_counts)
    sim_reads = scp.host_sync_count + qp.host_sync_count
    finite_outputs(sim, "simulate")
    if sim.u_pred.shape != (n_sim, 1, hp, n_veh):
        fail("simulate: unexpected output shapes")
    sim_feas = float(sim.feasible.float().mean())
    for k in ("cholesky", "cho_solve"):
        reports[k]["launches_per_instance_path"] = sim_counts[k]
        if sim_counts[k] == 0:
            fail(f"the per-instance path never launched the {k} kernel")
    # Step 0 of the one-scenario loop again: with the first B = 1 call of
    # the factor and of the solve kept and held against their plain
    # versions, then through the plain versions, then in float64 (plain
    # versions: the kernels refuse float64). One nominal scenario has no
    # batch to take percentiles over, so the maximum itself is limited, and
    # the kernels' step may be no further from the float64 step than twice
    # the plain float32 step is, plus the limit.
    first_one: dict[str, tuple] = {}

    def keep(name):
        def call(*args):
            first_one.setdefault(name, args)
            return real[name](*args)
        return call

    for k in ("cholesky", "cho_solve"):
        setattr(lk, k, keep(k))
    try:
        _, one_k = engine.mpc_step(cfg1, data1,
                                   engine.init_carry(cfg1, data1))
        torch.cuda.synchronize()
    finally:
        for k in names:
            setattr(lk, k, real[k])
    if first_one["cholesky"][0].shape != (1, n, n):
        fail("the one-scenario step did not factor one n x n matrix")
    check_factor("one_scenario_step_B1", first_one["cholesky"][0],
                 real["cholesky"], plain["cholesky"], True)
    check_vector("cho_solve", "one_scenario_step_B1", real["cho_solve"],
                 plain["cho_solve"], first_one["cho_solve"],
                 FIRST_ITER_REL_LIMIT)
    cfg64, data64 = builders.circle(n_veh, dtype=torch.float64, device=dev)
    cfg64 = config_lib.tuned_f32(cfg64.replace(hp=hp, hu=hp))
    for k in names:
        setattr(lk, k, plain[k])
    try:
        _, one_p = engine.mpc_step(cfg1, data1,
                                   engine.init_carry(cfg1, data1))
        _, one_d = engine.mpc_step(cfg64, data64,
                                   engine.init_carry(cfg64, data64))
        torch.cuda.synchronize()
    finally:
        for k in names:
            setattr(lk, k, real[k])
    one_kp = float(u_pred_diff(one_k, one_p).max())
    one_kd = float(u_pred_diff(one_k, one_d).max())
    one_pd = float(u_pred_diff(one_p, one_d).max())
    one_step0 = float((one_k.u_pred - sim.u_pred[0]).abs().max())
    one_step = {"step0_vs_plain_u_pred_max_abs": one_kp,
                "step0_vs_f64_u_pred_max_abs": one_kd,
                "step0_plain_vs_f64_u_pred_max_abs": one_pd,
                "step0_repeats_simulate_max_abs": one_step0,
                "step0_same_scp_iters": bool(
                    (one_k.scp_iters == one_p.scp_iters).all()),
                "step0_u_pred_limit": UPRED_ABS_LIMIT}
    # the timed closed loop gives the same run, and the controller's share
    _, timed, step_s, ctrl_s = engine.simulate_timed(cfg1, data1, n_steps=3)
    timed_diff = float((timed.u_pred - sim.u_pred[:3]).abs().max())
    if timed_diff > 1e-6 or len(step_s) != 3 \
            or not all(0 < c <= t for c, t in zip(ctrl_s, step_s)):
        fail(f"simulate_timed disagrees with simulate by {timed_diff} or "
             f"its times are inconsistent: {step_s}, {ctrl_s}")
    # step latency: step i repeated LATENCY_REPS times from the same carry,
    # a synchronise, the host clock; then the carry is advanced
    lats = []
    c_i = engine.init_carry(cfg1, data1)
    engine.mpc_step(cfg1, data1, c_i)                      # warm
    for _ in range(n_sim):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LATENCY_REPS):
            engine.mpc_step(cfg1, data1, c_i)
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t0) / LATENCY_REPS * 1e3)
        c_i, _ = engine.mpc_step(cfg1, data1, c_i)
    lats.sort()
    PATH_NUMBERS["c_latency"] = [
        lats[len(lats) // 2], lats[min(len(lats) - 1, int(0.90 * len(lats)))],
        lats[-1]]
    emit({"phase": "per_instance_path", "card": card, "scenario": "circle",
          "n_veh": n_veh, "hp": hp, "steps": n_sim, "config": "tuned_f32",
          "feasible_share": sim_feas, "feasible_floor": SIM_FEASIBLE_FLOOR,
          "launches_per_step": {k: sim_counts[k] / n_sim for k in names},
          "host_reads_per_step": sim_reads / n_sim,
          "mean_scp_iters": float(sim.scp_iters.float().mean()),
          "peak_device_memory_mib":
              torch.cuda.max_memory_allocated() / 2 ** 20,
          **one_step,
          "simulate_timed_vs_simulate_u_pred_max_abs": timed_diff,
          "controller_share_of_step": sum(ctrl_s) / sum(step_s),
          "latency_reps": LATENCY_REPS,
          "step_latency_ms_p50": lats[len(lats) // 2],
          "step_latency_ms_p90": lats[min(len(lats) - 1,
                                          int(0.90 * len(lats)))],
          "step_latency_ms_max": lats[-1],
          "step_latency_ms_min": lats[0]})
    if sim_feas < SIM_FEASIBLE_FLOOR:
        fail(f"simulate: feasible share {sim_feas} below "
             f"{SIM_FEASIBLE_FLOOR}")
    if one_step0 > 1e-6:
        fail(f"step 0 of the one-scenario loop does not repeat: {one_step0}")
    if one_kp > UPRED_ABS_LIMIT \
            or one_kd > 2 * one_pd + UPRED_ABS_LIMIT \
            or bool((one_k.feasible != one_p.feasible).any()):
        fail(f"one-scenario step 0, kernels vs plain: {one_step}")

    # simulate (per-instance SCP on the batch axis) against simulate_batch
    # (stacked SCP through the fused kernel) on the same batch: step 0 runs
    # on identical inputs, the later steps on each loop's own carry. Both get
    # the same iteration budget — one full-width phase of max_scp_iter: under
    # a straggler schedule an instance beyond a phase's capacity keeps its
    # earlier iterate, which the per-instance loop never does.
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    cfg_p, data_p = batch_lib.make_batch("circle", pair_batch, generator=gen,
                                         dtype=torch.float32, device=dev,
                                         n_veh=n_veh)
    cfg_p = config_lib.tuned_f32(cfg_p.replace(hp=hp, hu=hp))
    reset_counts()
    _, out_i = engine.simulate(cfg_p, data_p, n_steps=pair_steps)
    pair_counts = dict(lk.launch_counts)
    _, out_b = engine.simulate_batch(cfg_p, data_p, n_steps=pair_steps,
                                     phases=((cfg_p.max_scp_iter, 1),))
    torch.cuda.synchronize()
    finite_outputs(out_i, "simulate at the pair batch")
    finite_outputs(out_b, "simulate_batch at the pair batch")
    flags = float((out_i.feasible == out_b.feasible).float().mean())
    du = u_pred_diff(out_i, out_b)[0]
    # (64 instances: the 99th percentile is the maximum in all but name, and
    # a bare maximum of two float32 seven-iteration solvers is not limited —
    # single instances drift by 1e-2; the 90th percentile takes its place)
    du_med, du_p90 = float(du.median()), float(du.quantile(0.90))
    emit({"phase": "per_instance_vs_stacked", "B": pair_batch,
          "steps": pair_steps, "feasible_flags_agree": flags,
          "flags_floor": FLAGS_AGREE_FLOOR,
          "feasible_share_per_instance": float(out_i.feasible.float().mean()),
          "feasible_share_stacked": float(out_b.feasible.float().mean()),
          "step0_u_pred_median": du_med, "step0_u_pred_p90": du_p90,
          "step0_u_pred_p99": float(du.quantile(0.99)),
          "step0_u_pred_max_abs": float(du.max()),
          "launches_per_instance_loop": pair_counts,
          "k1_launches_stacked_loop": ipm_kernel.launch_count,
          "u_pred_median_limit": UPRED_MEDIAN_LIMIT,
          "u_pred_p90_limit": UPRED_ABS_LIMIT})
    if pair_counts["cholesky"] == 0 or ipm_kernel.launch_count == 0:
        fail("the pair comparison did not run both kernels' paths")
    if flags < FLAGS_AGREE_FLOOR:
        fail(f"simulate vs simulate_batch: feasibility flags agree on "
             f"{flags}, floor {FLAGS_AGREE_FLOOR}")
    if du_med > UPRED_MEDIAN_LIMIT or du_p90 > UPRED_ABS_LIMIT:
        fail(f"simulate vs simulate_batch, step 0: u_pred median {du_med} "
             f"(limit {UPRED_MEDIAN_LIMIT}), 90th percentile {du_p90} "
             f"(limit {UPRED_ABS_LIMIT})")

    # ---- times ----
    library = {
        "cholesky": lambda K: torch.linalg.cholesky(K),
        "cho_solve": lambda L, b: torch.cholesky_solve(b[:, :, None], L),
        "gmv": lambda G, x: torch.bmm(G, x[:, :, None]),
        "gtmv": lambda G, v: torch.bmm(v[:, None, :], G)}
    times = {"phase": "linalg_times", "card": card, "n": n, "mg": mg,
             "adaptive_step_ms": adaptive_step_ms,
             "adaptive_solves_per_s": B / adaptive_step_ms * 1e3,
             "kernels": {k: {} for k in names}}
    def time_cell(k, args, m_rows):
        # ms / plain_ms / library_ms: device time per call (profiler);
        # *_call_ms: CUDA events around back-to-back calls, which for
        # kernels this short is the host's time to enqueue one;
        # ms_over_library_ms: comparable across calls (cards differ)
        w = args[0].shape[0]
        cell = {"ms": device_ms(lambda: real[k](*args), timing_reps, 1),
                "plain_ms": device_ms(lambda: plain[k](*args), timing_reps),
                "library_ms": device_ms(lambda: library[k](*args),
                                        timing_reps)}
        cell["ms_over_library_ms"] = cell["ms"] / cell["library_ms"]
        cell["bound_ms"], cell["bound_by"] = linalg_bound_ms(k, w, n, m_rows)
        cell["call_ms"] = time_cuda(lambda: real[k](*args), reps=timing_reps)
        cell["plain_call_ms"] = time_cuda(lambda: plain[k](*args),
                                          reps=timing_reps)
        cell["library_call_ms"] = time_cuda(lambda: library[k](*args),
                                            reps=timing_reps)
        return cell

    def cold_cell(k, args):
        # the same calls with a cold L2: each call takes the next of enough
        # copies of its inputs that the others move L2_ROTATE_BYTES
        # through L2 before a copy is read again
        copies = rotating_copies(args)
        cell = {"cold_ms": device_ms(rotate(real[k], copies), timing_reps, 1),
                "library_cold_ms": device_ms(rotate(library[k], copies),
                                             timing_reps),
                "input_copies": len(copies)}
        cell["cold_over_library_cold_ms"] = (cell["cold_ms"]
                                             / cell["library_cold_ms"])
        del copies
        return cell

    for w in widths:
        if w > B:
            continue
        for k in names:
            args = tuple(a[:w].contiguous() for a in first[k])
            cell = time_cell(k, args, mg)
            if w == widths[0]:
                cell.update(cold_cell(k, args))
            times["kernels"][k][str(w)] = cell
            if w == widths[0]:
                reports[k].update(cell)
    # the one-scenario path's factor (B = 1), and the dense P product's
    # shape (B, n, n) for the G product (seeded data)
    times["kernels"]["cholesky"]["1"] = time_cell(
        "cholesky", (first["cholesky"][0][:1].contiguous(),), mg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p_args = (torch.randn((B, n, n), generator=gen, device=dev),
              torch.randn((B, n), generator=gen, device=dev))
    times["kernels"]["gmv"][f"P_shape_{B}"] = {
        **time_cell("gmv", p_args, n), **cold_cell("gmv", p_args)}
    times["ms_over_library_ms"] = {
        k: {w: c["ms_over_library_ms"] for w, c in times["kernels"][k].items()}
        for k in names}
    emit(times)
    emit({"phase": "linalg_ms_over_library_ms", "card": card,
          **times["ms_over_library_ms"]})
    reset_counts()
    return [reports[k] for k in names]


# ---- the banded (Riccati) sweeps and the dense-G iteration ----
LONG_B, LONG_HP, LONG_STEPS = 256, 64, 4
# (10 before the side-selection paths joined the script: cut to keep the
# whole run near 5.5 min; every check is unchanged, p90 is the largest of 6)
LATENCY64_STEPS = 6
FROG_B, FROG_HP, FROG_STEPS = 1024, 20, 4
RICCATI_WIDTHS = (256, 64, 16)
RICCATI_TIME_WIDTHS = RICCATI_WIDTHS + (1,)   # and the one-scenario width
DENSE_WIDTHS = (1024, 256, 64)
# Riccati kernel vs plain (float32, identical inputs). The sweeps are K = 64
# sequential stages, each consuming the cost-to-go the previous one rounded:
# two float32 orders of summation drift apart stage by stage, more where the
# dynamics grow the cost-to-go. So every case limits the kernel's distance
# from a float64 oracle (the plain version in float64 on the same float32
# inputs) to twice the plain float32 version's plus 1e-5 of the result's
# scale, and the first IPM iteration's inputs (barrier weights ~1, well
# conditioned) also limit the plain difference itself to 1e-3 of the
# result's scale (max |f|, |lh|, |kg|, |du|).
# K2 runs all of a QP's fixed iterations in one launch from its cold start
# (its first IPM iteration: mu = 1, well conditioned); its later iterations
# reach barrier weights z/s up to 1e10 and matrices conditioned up to ~1e6.
# A launch is checked three ways:
#  * each of its iterations as a launch of one on identical inputs (the
#    plain version's iterate): from the cold start every state entry but
#    the slack's within ONE_ITER_LIMIT of its array's scale (at least 1: the
#    residuals and duals run to ~10 there, where float32 keeps ~1e-6
#    absolute), or within twice the plain version's own distance from
#    float64 on those entries where that is larger (at long horizons the
#    condensed P is itself ill-conditioned: at frog hp = 180 the plain
#    float32 iterate lies ~7e-5 from float64 on the controls, the
#    kernel's ~3e-5), the kernel no further from float64 on them than
#    twice the plain version + ONE_ITER_LIMIT, and the controls within
#    twice the plain version's distance from float64 + 1e-4; from every
#    later iterate, where two float32
#    factorizations differ by (condition) x (round-off) on single
#    instances, what conditioning does not move: finite outputs, the same
#    freeze flags as the plain version and the batch median of the
#    controls' difference (U_MEDIAN_LIMIT);
#  * what the launch carries from one iteration to the next (the state,
#    mu_prev and the freeze flags in shared memory) exactly: the launch of
#    n iterations must equal, bit for bit, n chained launches of one
#    iteration of the same kernel (each reads back what the last wrote);
#  * the whole launch against the plain version's whole run, which
#    compounds the two float32 solvers' round-off over the iterations. Its
#    yardstick is measured in the same run: the plain version on the same
#    inputs perturbed by one part in 2^23 (PERTURB_DRAWS draws of a random
#    sign per entry; mu_prev and the flags unperturbed). The freeze flags
#    that differ may be no more than the most of a draw, or one in
#    FLAG_SHARE_DENOM instances (at least one); the controls' median
#    difference no more than WHOLE_MEDIAN_FACTOR x the draws' largest
#    median + 1e-6 (up to 3.2x one draw's was read on the frog step,
#    where the kernel's differences and the draws' both come from
#    round-off); and the controls' distance from float64 at the 99th
#    percentile and at most no more than twice the largest of the plain
#    version's and the draws' + 1e-4. The kernel-vs-plain 99th percentile
#    is reported, not limited: at B = 64 it is one instance, and it was
#    read at up to 31x the draw's where the kernel was nearer float64 than
#    the plain version (0.0199 against 0.053; PERF.md §6).
PERTURB_DRAWS = 2
FLAG_SHARE_DENOM = 200
WHOLE_MEDIAN_FACTOR = 4.0
RICCATI_REL_LIMIT = 1e-3
FROG_FEASIBLE_SLACK = 0.01   # floor: the plain versions' share minus this
# The frog step's kernel-vs-plain 99th percentile is limited to the larger of
# UPRED_ABS_LIMIT and the plain float32 step's own 99th-percentile distance
# from the float64 step: one vehicle among 22 moving obstacles sits against
# many near-active rows, and the non-convex SCP loop carries two float32
# solvers' round-off further apart there than on the circle (both float32
# steps are ~2e-2 from the float64 step at the 99th percentile, 6e-2 at
# most). Two float32 steps closer together than either is to the exact
# (float64) step differ by round-off, not by a fault. The distance from
# float64 is held as a distribution: the kernel step's 99th percentile and
# maximum may be no more than twice the plain step's plus UPRED_ABS_LIMIT.
# Instance by instance (as on the circle) a single one of 1,024 can end on
# another SCP path; those are reported with both distances, not limited.
# Every K2 launch on identical inputs is limited above.


def riccati_work(kind: str, B: int, V: int, K: int, n_rhs: int = 1):
    """Bytes the sweep must move (each input read once, each output written
    once: a solve reads the factor once and r / writes du once per
    right-hand side) and its float32 operations (two per multiply-add), for
    B instances."""
    W = 6 * V
    dyn = V * 36 + V * 6
    if kind == "riccati_factor":
        words = dyn + K * (4 * V * V + V) + K * (2 * V * W + V * V)
        macs = K * (2 * 6 * V * W + 6 * V * V + 2 * 6 * W * W + V * W * W
                    + V * V * W + V ** 3 / 6)
    else:
        words = dyn + K * (2 * V * W + V * V) + 2 * n_rhs * K * V
        macs = n_rhs * K * (6 * V + V * V + 6 * W + 2 * V * W + 6 * W + W)
    return 4 * words * B, 2 * macs * B


def solve_args_at(s_args, w, rhs=None):
    """The solve's arguments cut to the first ``w`` instances; ``rhs``
    keeps that right-hand side of a two-right-hand-side ``r`` only."""
    *fac, r = s_args
    r = r[:, :w] if r.ndim == 4 else r[:w]
    if rhs is not None:
        r = r[rhs]
    return tuple(a[:w].contiguous() for a in fac) + (r.contiguous(),)


def dense_work(B, mg, n, nb, d, schur, n_cor, n_iters):
    """The same for one dense-G launch (K2) of ``n_iters`` iterations: G,
    the symmetric P blocks (or a dense P's lower triangle), q, the P
    diagonal and the state in once, the state out once. Multiply-adds per
    iteration: the product's lower triangle over the factored columns, the
    slack border, the factor, the substitutions, every G / G^T pass (two
    per Newton system), P x and the vector algebra."""
    nk = n - 1 if schur else n
    m = mg + 2 * n
    state = 7 * n + 3 * mg + 2
    p_words = nb * d * (d + 1) // 2 if nb else n * (n + 1) // 2
    words = mg * n + p_words + 2 * n + 2 * state
    solves = 2 + n_cor
    macs = (nk * (nk + 1) // 2 * mg + (mg * n if schur else 0)
            + nk ** 3 / 6 + solves * nk * nk + solves * 2 * mg * n
            + (nb * d * d if nb else n * n) + (40 + 25 * n_cor) * m / 2)
    return 4 * words * B, 2 * macs * n_iters * B


def check_outputs(kernel, case, outs_k, outs_p, outs_d, names,
                  first_iter: bool) -> tuple:
    """Each output of a kernel against its plain float32 version and the
    float64 oracle on the same inputs; fails beyond the limits above.
    Returns the largest kernel-vs-plain difference, absolute and relative to
    its output's scale."""
    rep = {"phase": "kernel_vs_plain", "kernel": kernel, "case": case,
           "B": outs_k[0].shape[-3 if kernel == "riccati_solve" else 0],
           "first_ipm_iteration": first_iter,
           "limits": {"vs_f64": "2 x plain float32's + 1e-5 x scale",
                      "first_iter_rel": RICCATI_REL_LIMIT}}
    worst, worst_abs, bad = 0.0, 0.0, []
    for name, k, p_, d in zip(names, outs_k, outs_p, outs_d):
        scale = max(_scale(d), 1e-30)
        e_kp = _scale(k - p_)
        e_kd, e_pd = _scale(k.double() - d), _scale(p_.double() - d)
        rep[name] = {"kernel_vs_plain_max_abs": e_kp, "kernel_vs_f64": e_kd,
                     "plain_vs_f64": e_pd, "scale": scale,
                     "finite": bool(torch.isfinite(k).all())}
        worst = max(worst, e_kp / scale)
        worst_abs = max(worst_abs, e_kp)
        if (not rep[name]["finite"] or e_kd > 2 * e_pd + 1e-5 * scale
                or (first_iter and e_kp > RICCATI_REL_LIMIT * scale)):
            bad.append(name)
    emit(rep)
    if bad:
        fail(f"{case}: the {kernel} kernel disagrees on {bad}: {rep}")
    return worst_abs, worst


def check_riccati(case, f_args, s_args, first_iter=True) -> tuple:
    """K6 on the factor's inputs and K7 on the solve's, each against its
    plain version and the plain version in float64. A two-right-hand-side
    ``r`` is also solved one right-hand side per launch, and each of those
    is checked too; the largest difference between the two ways is
    reported. Returns the factor's and the solve's (absolute, relative)
    errors, the solve's with one right-hand side."""
    from scp_tpu_torch.ops import riccati, riccati_kernel as rk
    f_k = rk.riccati_factor(*f_args)
    f_p = riccati.riccati_factor_plain(*f_args)
    torch.cuda.synchronize()
    f_d = riccati.riccati_factor_plain(*[a.double() for a in f_args])
    e_f = check_outputs("riccati_factor", case, f_k, f_p, f_d,
                        ("f", "lh", "kg"), first_iter)
    *fac, r = s_args
    rhs_list = [r] if r.ndim == 3 else [r[i].contiguous()
                                         for i in range(r.shape[0])]
    outs = []
    for i, ri in enumerate(rhs_list):
        args = (*fac, ri)
        du_k = rk.riccati_solve(*args)
        du_p = riccati.riccati_solve_plain(*args)
        torch.cuda.synchronize()
        du_d = riccati.riccati_solve_plain(*[a.double() for a in args])
        e = check_outputs("riccati_solve", f"{case}_rhs{i}", (du_k,),
                          (du_p,), (du_d,), ("du",), first_iter)
        outs.append(du_k)
        e_s = e if i == 0 else e_s
    if r.ndim == 4:
        du_k = rk.riccati_solve(*s_args)
        du_p = riccati.riccati_solve_plain(*s_args)
        torch.cuda.synchronize()
        du_d = riccati.riccati_solve_plain(*[a.double() for a in s_args])
        check_outputs("riccati_solve", f"{case}_two_rhs", (du_k,), (du_p,),
                      (du_d,), ("du",), first_iter)
        emit({"phase": "riccati_two_rhs_vs_two_launches", "case": case,
              "B": r.shape[1], "max_abs_diff": float(
                  (du_k - torch.stack(outs)).abs().max())})
    return e_f, e_s


# positions in ``ipm_iterate_dense``'s arguments (testing.DENSE_ARG_ORDER):
# G, the P blocks, the first state entry, scal
DENSE_G, DENSE_PB, DENSE_STATE, DENSE_SCAL = 0, 2, 5, 15


def _perturb(a, gen):
    """``a`` times 1 +- 2^-23, the sign drawn per entry from ``gen``; what
    is not a float tensor (None, a tuple, integers) comes back as it is."""
    if not (torch.is_tensor(a) and a.is_floating_point()):
        return a
    sign = torch.randint(0, 2, a.shape, generator=gen, device=a.device)
    return a * (1.0 + (2.0 * sign - 1.0) * 2.0 ** -23)


def _q99(t) -> float:
    return float(t.quantile(0.99))


def run_yardstick(run_perturbed, controls, flags, out_p, out_d,
                  flag: str) -> dict:
    """The yardstick of a float32 run of many iterations (K2's whole
    launch, path (h)'s QP), measured in this run: the plain version on the
    same inputs perturbed by one part in 2^23 (``run_perturbed(gen)``,
    PERTURB_DRAWS draws, the signs of :func:`_perturb` from ``gen``)
    against the plain version's outputs ``out_p`` and float64's ``out_d``;
    ``controls`` and ``flags`` pick a run's controls and its flags (named
    ``flag`` in the keys). The largest reading over the draws, and the
    allowances :func:`run_off_limits` holds the kernel's run to."""
    up, ud, fp = controls(out_p), controls(out_d), flags(out_p)
    e_pd = (up.double() - ud).abs().amax(dim=1)
    y = {"u_perturbed_vs_plain_median": 0.0, "u_perturbed_vs_plain_p99": 0.0,
         "u_perturbed_vs_plain_max": 0.0, f"{flag}_differ_perturbed": 0,
         "u_f32_vs_f64_p99": _q99(e_pd), "u_f32_vs_f64_max": float(e_pd.max())}
    gen = torch.Generator(device=up.device).manual_seed(23)
    for _ in range(PERTURB_DRAWS):
        out_q = run_perturbed(gen)
        uq = controls(out_q)
        e_qp = (uq - up).abs().amax(dim=1)
        e_qd = (uq.double() - ud).abs().amax(dim=1)
        for k, v in (("u_perturbed_vs_plain_median", float(e_qp.median())),
                     ("u_perturbed_vs_plain_p99", _q99(e_qp)),
                     ("u_perturbed_vs_plain_max", float(e_qp.max())),
                     ("u_f32_vs_f64_p99", _q99(e_qd)),
                     ("u_f32_vs_f64_max", float(e_qd.max())),
                     (f"{flag}_differ_perturbed",
                      int((flags(out_q) != fp).sum()))):
            y[k] = max(y[k], v)
    y[f"{flag}_differ_allowed"] = max(y[f"{flag}_differ_perturbed"],
                                      -(-up.shape[0] // FLAG_SHARE_DENOM))
    y["u_median_allowed"] = (WHOLE_MEDIAN_FACTOR
                             * y["u_perturbed_vs_plain_median"] + 1e-6)
    return y


def run_off_limits(e, flag: str) -> bool:
    """A whole run against its plain version and float64 under
    :func:`run_yardstick`'s allowances (RUN_LIMITS)."""
    return (not e["finite"]
            or e[f"{flag}_differ"] > e[f"{flag}_differ_allowed"]
            or e["u_kernel_vs_plain_median"] > e["u_median_allowed"]
            or e["u_kernel_vs_f64_p99"] > 2 * e["u_f32_vs_f64_p99"] + 1e-4
            or e["u_kernel_vs_f64_max"] > 2 * e["u_f32_vs_f64_max"] + 1e-4)


def dense_errors(args, kw, out_k, yardstick: bool = False) -> dict:
    """One K2 launch's outputs against its plain version and the float64
    oracle on the same inputs: every state entry but the slack's, relative
    to its array's scale (``one_iter``), and the controls. With
    ``yardstick``, also :func:`run_yardstick` (every float operand but
    scal perturbed)."""
    from scp_tpu_torch.ops import ipm_kernel as ik
    out_p = ik.ipm_iterate_dense_plain(*args, **kw)
    out_d = ik.ipm_iterate_dense_plain(
        *[None if a is None else a.double() for a in args],
        **{**kw, "reg_rel": 1e-12})
    nu = args[DENSE_G].shape[2] - 1
    scal = args[DENSE_SCAL]
    # x, the duals, the residuals and mu (the slack's own entries, the last
    # column, and the primal slacks are left out, as for K1)
    pairs = list(zip(out_k[:1] + out_k[4:], out_p[:1] + out_p[4:]))
    one_abs = [float((a - b)[:, :-1].abs().max()) for a, b in pairs]
    scales = [max(1.0, _scale(b[:, :-1])) for _, b in pairs]
    one_rel = [e / sc for e, sc in zip(one_abs, scales)]
    # ... and each of the two against float64, on the plain version's scales
    vs64 = [max(float((t.double() - d)[:, :-1].abs().max()) / sc
                for t, d, sc in zip(out[:1] + out[4:], out_d[:1] + out_d[4:],
                                    scales))
            for out in (out_k, out_p)]
    uk, up, ud = out_k[0][:, :nu], out_p[0][:, :nu], out_d[0][:, :nu]
    e_kp = (uk - up).abs().amax(dim=1)
    e_kd = (uk.double() - ud).abs().amax(dim=1)
    e_pd = (up.double() - ud).abs().amax(dim=1)
    B = args[DENSE_G].shape[0]
    rep = {"B": B, "n_iters": kw.get("n_iters", 1),
           "first_iteration": bool(
               (scal[:, 0] >= torch.finfo(scal.dtype).max).all()),
           "finite": all(bool(torch.isfinite(t).all()) for t in out_k),
           "one_iter_max_abs_err": max(one_abs),
           "one_iter_max_rel_err": max(one_rel),
           "one_iter_kernel_vs_f64_rel": vs64[0],
           "one_iter_plain_vs_f64_rel": vs64[1],
           "u_kernel_vs_plain_max": float(e_kp.max()),
           "u_kernel_vs_plain_median": float(e_kp.median()),
           "u_kernel_vs_plain_p99": _q99(e_kp),
           "u_kernel_vs_f64_max": float(e_kd.max()),
           "u_plain_vs_f64_max": float(e_pd.max()),
           "u_kernel_vs_f64_p99": _q99(e_kd),
           "u_plain_vs_f64_p99": _q99(e_pd),
           "frozen_differ": int((out_k[10][:, 1] != out_p[10][:, 1]).sum()),
           "frozen_equal": bool(torch.equal(out_k[10][:, 1],
                                            out_p[10][:, 1]))}
    if not yardstick:
        return rep
    # (and how far the draws move the state entries of one_iter_max_abs_err)
    state_moved = []

    def perturbed(gen):
        out_q = ik.ipm_iterate_dense_plain(
            *[_perturb(a, gen) for a in args[:-1]], args[-1], **kw)
        state_moved.append(max(
            float((a - b)[:, :-1].abs().max())
            for a, b in zip(out_q[:1] + out_q[4:], out_p[:1] + out_p[4:])))
        return out_q
    y = run_yardstick(perturbed, lambda out: out[0][:, :nu],
                      lambda out: out[10][:, 1], out_p, out_d, "frozen")
    return {**rep, **y,
            "state_perturbed_vs_plain_max_abs": max(state_moved)}


def dense_launch_errors(kernel, args, kw, out_k) -> list[dict]:
    """A K2 launch of ``n_iters`` iterations (``kernel``: the wrapper):
    the whole launch against the plain version's with its yardstick
    (:func:`dense_errors`) and against ``n_iters`` chained launches of one
    iteration of the kernel (``chain_bit_identical``), then each of its
    iterations as a launch of one on the plain version's iterate (identical
    inputs), the entries of the latter tagged with ``iteration``."""
    from scp_tpu_torch.ops import ipm_kernel as ik
    if kw.get("n_iters", 1) == 1:
        return [dense_errors(args, kw, out_k)]
    whole = dense_errors(args, kw, out_k, yardstick=True)
    reps = []
    one = {**kw, "n_iters": 1}
    cur, chain = list(args), list(args)
    for i in range(kw["n_iters"]):
        reps.append({**dense_errors(cur, one, kernel(*cur, **one)),
                     "iteration": i})
        cur = cur[:DENSE_STATE] + list(ik.ipm_iterate_dense_plain(*cur, **one))
        chain = chain[:DENSE_STATE] + list(kernel(*chain, **one))
    chained = chain[DENSE_STATE:]
    whole["chain_bit_identical"] = all(
        torch.equal(a, b) for a, b in zip(out_k, chained))
    whole["chain_max_abs_diff"] = max(
        float((a - b).abs().max()) for a, b in zip(out_k, chained))
    return [whole] + reps


# run_off_limits: a whole run (K2's launch, path (h)'s QP) against its
# plain version, with run_yardstick's allowances
RUN_LIMITS = {
    "flags_differ": f"<= max(perturbed draws', B / {FLAG_SHARE_DENOM} "
                    f"rounded up)",
    "u_median": f"{WHOLE_MEDIAN_FACTOR} x perturbed draws' + 1e-6",
    "vs_f64_p99_and_max": "2 x max(plain float32's, perturbed draws') + 1e-4",
    "finite": True}
DENSE_LIMITS = {
    "one_iteration": {
        "cold_start": {"one_iter_rel": f"max({ONE_ITER_LIMIT}, 2 x plain "
                                       f"float32's distance from float64)",
                       "one_iter_vs_f64": f"2 x plain float32's + "
                                          f"{ONE_ITER_LIMIT}",
                       "vs_f64": "2 x plain float32's + 1e-4"},
        "every_iterate": {"u_median": U_MEDIAN_LIMIT,
                          "freeze_flags": "equal", "finite": True}},
    "whole_launch": {"vs_chained_launches_of_one": "bit-identical",
                     **RUN_LIMITS}}


def dense_off_limits(e) -> bool:
    if not e["finite"]:
        return True
    if e["n_iters"] > 1:
        return (not e["chain_bit_identical"]
                or run_off_limits(e, "frozen"))
    if (not e["frozen_equal"]
            or e["u_kernel_vs_plain_median"] > U_MEDIAN_LIMIT):
        return True
    p64 = e["one_iter_plain_vs_f64_rel"]
    return e["first_iteration"] and (
        e["one_iter_max_rel_err"] > max(ONE_ITER_LIMIT, 2 * p64)
        or e["one_iter_kernel_vs_f64_rel"] > 2 * p64 + ONE_ITER_LIMIT
        or e["u_kernel_vs_f64_max"] > 2 * e["u_plain_vs_f64_max"] + 1e-4)


def _sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def check_dense(case, args, kw) -> dict:
    """K2 against its plain version from a QP's cold start: the launch and
    each of its iterations (:func:`dense_launch_errors`). Returns the
    whole launch's entry (``one_iter_max_abs_err``: its largest difference
    on a state entry; ``u_kernel_vs_plain_max``: on the controls)."""
    from scp_tpu_torch.ops import ipm_kernel as ik
    out_k = ik.ipm_iterate_dense(*args, **kw)
    torch.cuda.synchronize()
    reps = dense_launch_errors(ik.ipm_iterate_dense, args, kw, out_k)
    B = args[DENSE_G].shape[0]
    rep = {"phase": "kernel_vs_plain", "kernel": "ipm_iterate_dense",
           "case": case, "mg": args[DENSE_G].shape[1],
           "n": args[DENSE_G].shape[2], "schur_slack": kw["schur_slack"],
           "p_blocks": args[DENSE_PB] is not None, "n_cor": kw["n_cor"],
           "min_ctas": ik.dense_min_ctas(B, _sm_count()),
           **reps[0], "iterations": reps[1:], "limits": DENSE_LIMITS}
    emit(rep)
    if not rep["first_iteration"] or any(map(dense_off_limits, reps)):
        fail(f"{case}: the dense-G kernel disagrees: {rep}")
    return reps[0]


def large_n_times(k, args, kernel, plain, library, n, reps=10) -> dict:
    """Device times of the factor or the solve past the shared-memory
    kernels on ``args``, by CUDA-graph replay: the kernel warm and cold
    (each call on the next of rotating input copies), the plain version,
    and the library call — but ``torch.cholesky_solve``, which a graph
    cannot capture, by CUDA events around back-to-back calls (device-bound
    at B = 256: ~0.5 ms a call against ~0.03 ms of host time); the bound of
    ``linalg_bound_ms``."""
    w = args[0].shape[0]
    cell = {"B": w, "n": n,
            "ms": graph_ms(lambda: kernel(*args), reps=reps),
            "plain_ms": graph_ms(lambda: plain(*args), reps=reps)}
    if k == "cholesky":
        cell["library_ms"] = graph_ms(lambda: library(*args), reps=reps)
    else:
        cell["library_ms"] = time_cuda(lambda: library(*args), reps=reps)
        cell["library_timed_by"] = "cuda events, back-to-back calls"
    # a cold L2 where each call's inputs outgrow it (B = 256: 67 MB)
    nbytes = sum(a.numel() * a.element_size() for a in args)
    if nbytes * 2 > L2_ROTATE_BYTES // 5:
        copies = rotating_copies(args)
        cell["cold_ms"] = graph_ms(rotate(kernel, copies), reps=reps)
        cell["library_cold_ms"] = (
            graph_ms if k == "cholesky" else time_cuda)(
                rotate(library, copies), reps=reps)
        cell["input_copies"] = len(copies)
        del copies
    cell["bound_ms"], cell["bound_by"] = linalg_bound_ms(k, w, n)
    cell["ms_over_library_ms"] = cell["ms"] / cell["library_ms"]
    return cell


# ---- the kernel wrappers, routed and counted (shared by the paths below) ----
_WRAPPERS: dict = {}


def wrappers() -> dict:
    """``name -> (module, wrapper, plain version)`` for every kernel wrapper
    the paths route, read on the first call (main() makes it before any
    wrapper is replaced)."""
    if not _WRAPPERS:
        from scp_tpu_torch.ops import ipm_kernel, linalg, riccati
        from scp_tpu_torch.ops import linalg_kernel as lk
        from scp_tpu_torch.ops import riccati_kernel as rk
        plain = {"ipm_iterate_struct": ipm_kernel.ipm_iterate_struct_plain,
                 "ipm_iterate_dense": ipm_kernel.ipm_iterate_dense_plain,
                 "cholesky": linalg.cholesky_plain,
                 "cho_solve": linalg.cho_solve_plain,
                 "gmv": linalg.gmv_plain, "gtmv": linalg.gtmv_plain,
                 "riccati_factor":
                     lambda *a: tuple(riccati.riccati_factor_plain(*a)),
                 "riccati_solve": riccati.riccati_solve_plain}
        owner = {"ipm_iterate_struct": ipm_kernel,
                 "ipm_iterate_dense": ipm_kernel, "riccati_factor": rk,
                 "riccati_solve": rk}
        for k, f in plain.items():
            mod = owner.get(k, lk)
            _WRAPPERS[k] = (mod, getattr(mod, k), f)
    return _WRAPPERS


def real_of(*names) -> dict:
    return {k: wrappers()[k][1] for k in names}


def plain_of(*names) -> dict:
    return {k: wrappers()[k][2] for k in names}


def routed(fns: dict, fn, *args, **kw):
    """Run ``fn`` (and synchronize) with the wrappers named in ``fns``
    replaced by them; every one is put back after."""
    table = wrappers()
    for k, f in fns.items():
        setattr(table[k][0], k, f)
    try:
        out = fn(*args, **kw)
        torch.cuda.synchronize()
    finally:
        for k in fns:
            setattr(table[k][0], k, table[k][1])
    return out


def reset_counts() -> None:
    """Every kernel's launch count and the host-read counts set to 0."""
    from scp_tpu_torch.ops import ipm_kernel, linalg_kernel as lk
    from scp_tpu_torch.ops import riccati_kernel as rk
    from scp_tpu_torch.solvers import qp, scp
    ipm_kernel.reset_launch_count()
    lk.reset_launch_counts()
    rk.reset_launch_counts()
    scp.reset_host_sync_count()
    qp.reset_host_sync_count()


def launch_counts() -> dict:
    """Every kernel's launches since :func:`reset_counts` (K1 and K2 in
    their shared-memory tier under the wrappers' names, in their device
    tier with ``_device``, in their cluster tier with ``_cluster``, in
    their global tier with ``_global``; the
    large-n factor over a cluster as ``cholesky_cluster``, the large-n
    solve on its staged triangle as ``cho_solve_staged``)."""
    from scp_tpu_torch.ops import ipm_kernel, linalg_kernel as lk
    from scp_tpu_torch.ops import riccati_kernel as rk
    return {"ipm_iterate_struct": ipm_kernel.launch_count,
            "ipm_iterate_dense": ipm_kernel.dense_launch_count,
            "ipm_iterate_struct_device": ipm_kernel.device_launch_count,
            "ipm_iterate_struct_cluster": ipm_kernel.cluster_launch_count,
            "ipm_iterate_dense_device": ipm_kernel.dense_device_launch_count,
            "ipm_iterate_dense_cluster":
                ipm_kernel.dense_cluster_launch_count,
            "ipm_iterate_struct_global": ipm_kernel.global_launch_count,
            "ipm_iterate_dense_global": ipm_kernel.dense_global_launch_count,
            **lk.launch_counts, **rk.launch_counts}


def host_reads() -> int:
    """The solvers' reads of device values since :func:`reset_counts`."""
    from scp_tpu_torch.solvers import qp, scp
    return scp.host_sync_count + qp.host_sync_count


def as_f64(tree):
    """The float tensors of a tuple tree (data, carry) in float64."""
    from scp_tpu_torch.config import tree_map
    return tree_map(
        lambda t: t.double() if t.is_floating_point() else t, tree)


@contextlib.contextmanager
def counted_calls(module, name):
    """Count the calls of ``module.name`` while the block runs; yields a
    list whose one entry is the count."""
    fn, n = getattr(module, name), [0]

    def counted(*a, **k):
        n[0] += 1
        return fn(*a, **k)
    setattr(module, name, counted)
    try:
        yield n
    finally:
        setattr(module, name, fn)


def feasible_share(outs) -> float:
    return float(torch.stack([o.feasible.float().mean()
                              for o in outs]).mean())


def chain_vs_plain(step, carry0, n_steps, kernels, spy=None) -> dict:
    """``n_steps`` chained steps from ``carry0`` through the kernels, timed,
    every count set to 0 just before and read just after (with the calls
    of ``spy = (module, name)``, if given); then the same chain with the
    wrappers named in ``kernels`` routed to their plain versions, whose
    feasible share floors the kernels' (less FROG_FEASIBLE_SLACK)."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    c, outs = carry0, []
    with (counted_calls(*spy) if spy else contextlib.nullcontext([0])) \
            as calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            c, out = step(c)
            outs.append(out)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_steps * 1e3
    counts, reads = launch_counts(), host_reads()
    peak = torch.cuda.max_memory_allocated()
    c_p, outs_p = carry0, []
    for _ in range(n_steps):
        c_p, out = routed(plain_of(*kernels), step, c_p)
        outs_p.append(out)
    feas, feas_p = feasible_share(outs), feasible_share(outs_p)
    return {"outs": outs, "outs_plain": outs_p, "carry": c,
            "chained_step_ms": ms, "counts": counts, "host_reads": reads,
            "spy_calls": calls[0], "peak_mib": peak / 2 ** 20,
            # (what a step adds to what was allocated before the chain)
            "step_peak_above_resident_mib": (peak - resident) / 2 ** 20,
            "feasible_share": feas, "feasible_share_plain": feas_p,
            "feasible_floor": feas_p - FROG_FEASIBLE_SLACK}


def dense_hp64_phases(dev, card, qp_call, adaptive_qp, banded_one
                      ) -> list[dict]:
    """The dense KKT at the long horizon (circle-4, hp = hu = 64, n = 257),
    past the shared-memory factor and solve:

    (g) ONE scenario under ``tuned_f32`` as it stands (``qp_kkt="auto"``,
        7 fixed IPM iterations) through ``mpc_step``: per instance "auto"
        is the dense factorization, so the factor and the solve run at
        n = 257, B = 1. Step 0 against the plain versions and float64 under
        the one-scenario banded phase's limits, and against that phase's
        step 0 (path (e): the same QPs through the banded KKT); latency;
        feasible share.
    (h) ONE QP of the adaptive dense branch at B = 256: the long-horizon
        path's first full-width QP (``qp_call``) through
        ``solve_qp_batched(fixed_iters=None, kkt="dense")`` with the
        DEFAULT adaptive settings (``adaptive_qp``): the factor, the solve
        and both G products at the long-horizon shape, against the plain
        versions and float64.

    Returns the ``kernels`` line's entries of the large-n factor and
    solve."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.ops import constraints as con, ipm_kernel
    from scp_tpu_torch.ops import linalg_kernel as lk, riccati_kernel as rk
    from scp_tpu_torch.scenarios import builders
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.solvers import qp

    names = ("cholesky", "cho_solve", "gmv", "gtmv")
    real, plain = real_of(*names), plain_of(*names)

    def large_kernel(K):
        return lk.cholesky(K, variant="device")

    def large_solve(L, b):
        return lk.cho_solve(L, b, variant="device")

    def staged_solve(L, b):
        return lk.cho_solve(L, b, variant="staged")

    library = {
        "cholesky": lambda K: torch.linalg.cholesky_ex(K)[0],
        "cho_solve": lambda L, b: torch.cholesky_solve(b[:, :, None], L)}

    first: dict[str, tuple] = {}
    n_calls: dict[str, int] = {}
    # (the G product's first two calls are the initial residuals, at the
    # warm start: its third, the predictor's G dx, is kept instead)
    keep_call = {"gmv": 2}

    def keep(name, width):
        def call(*args):
            if args[0].shape[0] == width:
                if n_calls.get(name, 0) == keep_call.get(name, 0):
                    first[name] = args
                n_calls[name] = n_calls.get(name, 0) + 1
            return real[name](*args)
        return call

    reports = {
        "cholesky": {"name": "cholesky_large_n", "replaces":
                     "scp_tpu/ops/pallas_linalg.py:220",
                     "also_replaces": "scp_tpu/ops/pallas_linalg.py:305",
                     "kernel": "chol_large_kernel (variant='device'): off "
                               "the main path since the cluster factor, "
                               "which takes every n up to its capacity"},
        "cholesky_cluster": {"name": "cholesky_cluster", "replaces":
                             "scp_tpu/ops/pallas_linalg.py:220",
                             "also_replaces":
                                 "scp_tpu/ops/pallas_linalg.py:305",
                             "kernel": "chol_cluster_kernel "
                                       "(csrc/chol_cluster.cuh)"},
        "cho_solve": {"name": "cho_solve_large_n", "replaces":
                      "scp_tpu/ops/pallas_linalg.py:241",
                      "also_replaces": "scp_tpu/ops/pallas_linalg.py:340",
                      "kernel": "cho_solve_large_kernel: past one wave of "
                                "instances (B > 132: path (h)) and past "
                                "n = 331; forced with variant='device'"},
        "cho_solve_staged": {"name": "cho_solve_staged", "replaces":
                             "scp_tpu/ops/pallas_linalg.py:241",
                             "also_replaces":
                                 "scp_tpu/ops/pallas_linalg.py:340",
                             "kernel": "cho_solve_staged_kernel: L's lower "
                                       "triangle staged into shared memory "
                                       "once"}}
    for r in reports.values():
        r.update(route="cuda", source="scp_tpu_torch/csrc/linalg.cu")

    # ---- (g) the calibrated one-scenario controller at hp = 64 ----
    cfg1, data1 = builders.circle(4, dtype=torch.float32, device=dev)
    cfg1 = config_lib.tuned_f32(cfg1.replace(hp=LONG_HP, hu=LONG_HP))
    n = 4 * LONG_HP + 1
    if cfg1.qp_kkt != "auto" or lk.fits_chol_smem(n):
        fail("path (g) must be tuned_f32 as it stands, past the "
             "shared-memory factor")
    reset_counts()
    _, g_k = routed({k: keep(k, 1) for k in ("cholesky", "cho_solve")},
                    engine.mpc_step, cfg1, data1,
                    engine.init_carry(cfg1, data1))
    step0_counts = dict(lk.launch_counts)
    others0 = (sum(rk.launch_counts.values()), ipm_kernel.launch_count)
    for k in ("cholesky", "cho_solve"):
        if k not in first or first[k][0].shape[-1] != n:
            fail(f"path (g) made no n = {n} call of {k}")
    rep_f = check_factor("one_scenario_dense_hp64_step0_B1",
                         first["cholesky"][0], real["cholesky"],
                         plain["cholesky"], True)
    rep_s = check_vector("cho_solve", "one_scenario_dense_hp64_step0_B1",
                         real["cho_solve"], plain["cho_solve"],
                         first["cho_solve"], FIRST_ITER_REL_LIMIT)
    g_args = {k: first[k] for k in ("cholesky", "cho_solve")}
    _, g_p = routed(plain, engine.mpc_step, cfg1, data1,
                    engine.init_carry(cfg1, data1))
    cfg64, data64 = builders.circle(4, dtype=torch.float64, device=dev)
    cfg64 = config_lib.tuned_f32(cfg64.replace(hp=LONG_HP, hu=LONG_HP))
    _, g_d = routed(plain, engine.mpc_step, cfg64, data64,
                    engine.init_carry(cfg64, data64))
    kp = float(u_pred_diff(g_k, g_p).max())
    kd = float(u_pred_diff(g_k, g_d).max())
    pd = float(u_pred_diff(g_p, g_d).max())
    # path (e) solved the same step's QPs through the banded KKT
    e_k, e_p, e_d = banded_one
    ge = float(u_pred_diff(g_k, e_k).max())
    ge_d = float(u_pred_diff(g_d, e_d).max())
    e_pd = float(u_pred_diff(e_p, e_d).max())
    # latency: step i repeated LATENCY_REPS times from the same carry
    reset_counts()
    lats, feas = [], []
    c_i = engine.init_carry(cfg1, data1)
    for _ in range(LATENCY64_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LATENCY_REPS):
            engine.mpc_step(cfg1, data1, c_i)
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t0) / LATENCY_REPS * 1e3)
        c_i, out = engine.mpc_step(cfg1, data1, c_i)
        finite_outputs(out, "one-scenario dense step at hp = 64")
        feas.append(float(out.feasible.float().mean()))
    counts = dict(lk.launch_counts)
    calls = LATENCY64_STEPS * (LATENCY_REPS + 1)
    others = (sum(rk.launch_counts.values()), ipm_kernel.launch_count)
    lats.sort()
    g_feas = sum(feas) / len(feas)
    g_rep = {"phase": "one_scenario_dense_hp64", "card": card, "n_veh": 4,
             "hp": LONG_HP, "n": n, "steps": LATENCY64_STEPS,
             "config": "tuned_f32 as it stands (qp_kkt=auto: solve_scp -> "
                       "solve_qp with the dense KKT), 7 fixed IPM iterations",
             "feasible_share": g_feas, "feasible_floor": SIM_FEASIBLE_FLOOR,
             "launches_per_step": {k: counts[k] / calls for k in
                                   names + ("cholesky_cluster",)},
             "step0_launches": step0_counts,
             "riccati_and_k1_launches": [others0, others],
             "latency_reps": LATENCY_REPS,
             "step_latency_ms_p50": lats[len(lats) // 2],
             "step_latency_ms_p90": lats[min(len(lats) - 1,
                                             int(0.90 * len(lats)))],
             "step_latency_ms_max": lats[-1],
             "step_latency_ms_min": lats[0],
             "step0_vs_plain_u_pred_max_abs": kp,
             "step0_vs_f64_u_pred_max_abs": kd,
             "step0_plain_vs_f64_u_pred_max_abs": pd,
             "step0_same_scp_iters": bool((g_k.scp_iters
                                           == g_p.scp_iters).all()),
             "step0_u_pred_limit": UPRED_ABS_LIMIT,
             "step0_vs_banded_path_e_u_pred_max_abs": ge,
             "step0_f64_vs_banded_f64_u_pred_max_abs": ge_d,
             "step0_banded_plain_vs_f64_u_pred_max_abs": e_pd,
             "vs_banded_limit": "2 x (dense + banded plain float32 "
                                "distances from float64) + u_pred limit"}
    emit(g_rep)
    if min(step0_counts["cholesky_cluster"],
           step0_counts["cho_solve_staged"], counts["cholesky_cluster"],
           counts["cho_solve_staged"]) == 0 \
            or step0_counts["cholesky"] or counts["cholesky"] \
            or step0_counts["cho_solve"] or counts["cho_solve"]:
        fail(f"path (g) did not launch the cluster factor and the staged "
             f"solve, or launched another factor or solve: {step0_counts}, "
             f"{counts}")
    if max(others0 + others) != 0:
        fail(f"path (g) launched the Riccati sweeps or K1: {others0}, "
             f"{others}")
    if g_feas < SIM_FEASIBLE_FLOOR:
        fail(f"path (g): feasible share {g_feas} below {SIM_FEASIBLE_FLOOR}")
    if kp > UPRED_ABS_LIMIT or kd > 2 * pd + UPRED_ABS_LIMIT \
            or bool((g_k.feasible != g_p.feasible).any()):
        fail(f"path (g) step 0, kernels vs plain: {g_rep}")
    if ge > 2 * (pd + e_pd) + UPRED_ABS_LIMIT:
        fail(f"path (g) step 0 against the banded path (e): {ge}, limit "
             f"{2 * (pd + e_pd) + UPRED_ABS_LIMIT}")
    for k in ("cholesky", "cholesky_cluster", "cho_solve",
              "cho_solve_staged"):
        reports[k]["launches"] = counts[k]
        reports[k]["launches_per_step_path_g"] = counts[k] / calls
    reports["cholesky_cluster"]["max_abs_err"] = \
        rep_f["kernel_vs_plain_max_abs"]
    # chol_large_kernel forced on the same step-0 inputs
    reports["cholesky"]["max_abs_err"] = check_factor(
        "one_scenario_dense_hp64_step0_B1_chol_large_kernel",
        first["cholesky"][0], large_kernel, plain["cholesky"],
        True)["kernel_vs_plain_max_abs"]
    reports["cho_solve_staged"]["max_abs_err"] = \
        rep_s["kernel_vs_plain_max_abs"]
    # cho_solve_large_kernel forced on the same step-0 inputs
    reports["cho_solve"]["max_abs_err"] = check_vector(
        "cho_solve", "one_scenario_dense_hp64_step0_B1_cho_solve_large_"
        "kernel", large_solve, plain["cho_solve"], first["cho_solve"],
        FIRST_ITER_REL_LIMIT)["kernel_vs_plain_max_abs"]

    # ---- (h) one QP of the adaptive dense branch, hp = 64, B = 256 ----
    args, kw = qp_call
    gi, gj, gob = kw["g_slabs"]
    pb = kw["p_blocks"]
    V, B, dtype = pb.shape[1], pb.shape[0], pb.dtype
    rows = con.scatter_slabs(V, gi, gj, gob, dtype)
    G = torch.cat([rows, torch.full((B, rows.shape[1], 1), -1.0,
                                    dtype=dtype, device=dev)], 2)
    h_kw = {**kw, "fixed_iters": None, "kkt": "dense", "banded": None,
            **adaptive_qp}
    h_args = (args[0], args[1], G.contiguous(), *args[3:])

    def one_qp(*a, **k):
        return qp.solve_qp_batched(*a, **k)

    first.clear()
    n_calls.clear()
    reset_counts()
    sol_k = routed({k: keep(k, B) for k in names}, one_qp, *h_args, **h_kw)
    h_counts = dict(lk.launch_counts)
    for k in names:
        if k not in first:
            fail(f"path (h) made no full-width call of {k}")
    if first["cholesky"][0].shape[-1] != n or G.shape[1:] != (
            first["gtmv"][0].shape[1], n):
        fail("path (h) is not at the long-horizon shape")
    sol_p = routed(plain, one_qp, *h_args, **h_kw)

    def f64(t):
        return t.double() if torch.is_tensor(t) and t.is_floating_point() \
            else t
    sol_d = routed(plain, one_qp, *[f64(a) for a in h_args],
                   **{k: (tuple(f64(t) for t in v) if k == "g_slabs"
                          else f64(v)) for k, v in h_kw.items()})
    nu = n - 1

    def du(a, b):
        return (a.x[:, :nu].double() - b.x[:, :nu].double()).abs().amax(1)

    h_kp, h_kd, h_pd = du(sol_k, sol_p), du(sol_k, sol_d), du(sol_p, sol_d)
    # At n = 257 float32 does not solve these QPs to within UPRED_ABS_LIMIT
    # of float64, and a perturbation of the inputs in their last bit moves
    # the plain solution by as much as the kernel does, so the QP is held as
    # K2's whole launches are (run_yardstick, RUN_LIMITS):
    # converged flags, the controls' median against the draws', and the
    # float64 distance at the 99th percentile and at most.
    y = run_yardstick(
        lambda gen: routed(plain, one_qp, *[_perturb(a, gen) for a in h_args],
                           **{k: _perturb(v, gen) for k, v in h_kw.items()}),
        lambda sol: sol.x[:, :nu], lambda sol: sol.converged, sol_p, sol_d,
        "converged")
    h_rep = {"phase": "adaptive_dense_qp_hp64", "card": card, "B": B,
             "n": n, "mg": G.shape[1],
             "config": "the long-horizon path's first QP, solve_qp_batched("
                       "fixed_iters=None, kkt='dense'), qp_max_iter %d, "
                       "qp_tol %g" % (adaptive_qp["max_iter"],
                                      adaptive_qp["tol"]),
             "launches_per_qp": h_counts,
             "ipm_iterations_max": int(sol_k.iters.max()),
             "ipm_iterations_mean": float(sol_k.iters.float().mean()),
             "converged_share": float(sol_k.converged.float().mean()),
             "converged_share_plain": float(sol_p.converged.float().mean()),
             "converged_share_f64": float(sol_d.converged.float().mean()),
             "converged_differ": int(
                 (sol_k.converged != sol_p.converged).sum()),
             "finite": all(bool(torch.isfinite(t).all())
                           for t in (sol_k.x, sol_k.z)),
             "u_kernel_vs_plain_median": float(h_kp.median()),
             "u_kernel_vs_plain_p99": _q99(h_kp),
             "u_kernel_vs_plain_max": float(h_kp.max()),
             "u_kernel_vs_f64_p99": _q99(h_kd),
             "u_kernel_vs_f64_max": float(h_kd.max()),
             "u_plain_vs_f64_p99": _q99(h_pd),
             "u_plain_vs_f64_max": float(h_pd.max()), **y,
             "limits": RUN_LIMITS}
    emit(h_rep)
    h_solve = ("cho_solve_staged" if lk.solve_route(B, n) == "staged"
               else "cho_solve")
    if min(h_counts[k] for k in ("cholesky_cluster", h_solve, "gmv",
                                 "gtmv")) == 0 or h_counts["cholesky"]:
        fail(f"path (h) did not launch every kernel (the factor: the "
             f"cluster kernel, the solve: {h_solve}): {h_counts}")
    for k in ("cho_solve", "cho_solve_staged"):   # the route is the batch's
        reports[k]["launches"] += h_counts[k]
        reports[k]["launches_per_qp_path_h"] = h_counts[k]
    if run_off_limits(h_rep, "converged"):
        fail(f"path (h), kernels vs plain: {h_rep}")
    # the kernels on the path's own first-iteration inputs at B = 256
    check_factor("adaptive_dense_hp64_first_iteration_B256",
                 first["cholesky"][0], real["cholesky"], plain["cholesky"],
                 True)
    check_vector("cho_solve", "adaptive_dense_hp64_first_iteration_B256",
                 real["cho_solve"], plain["cho_solve"], first["cho_solve"],
                 FIRST_ITER_REL_LIMIT)
    for k in ("gmv", "gtmv"):
        check_vector(k, "adaptive_dense_hp64_first_iteration_B256", real[k],
                     plain[k], first[k], MATVEC_REL_LIMIT)
    check_repeatable("gtmv", "adaptive_dense_hp64_first_iteration_B256",
                     real["gtmv"], first["gtmv"])

    # ---- times (n = 257: path (h)'s B = 256, path (g)'s B = 1) ----
    times = {"phase": "large_n_times", "card": card, "cells": {}}
    for k, kernel in (("cholesky_cluster", real["cholesky"]),
                      ("cholesky", large_kernel),
                      ("cho_solve_staged", staged_solve),
                      ("cho_solve", large_solve)):
        kk = "cholesky" if k.startswith("cholesky") else "cho_solve"
        cells = {w: large_n_times(kk, a, kernel, plain[kk], library[kk], n)
                 for w, a in (("256", first[kk]), ("1", g_args[kk]))}
        times["cells"][k] = cells
        # the line's numbers at the batch the route gives the kernel on the
        # paths: the staged solve at B = 1 (path (g)), the rest at B = 256
        # (path (h)); the other width beside them
        main, other = (("1", "256") if k == "cho_solve_staged"
                       else ("256", "1"))
        reports[k].update({key: cells[main].get(key) for key in (
            "ms", "cold_ms", "plain_ms", "library_ms", "library_cold_ms",
            "bound_ms", "bound_by")})
        reports[k]["B"], reports[k]["n"] = int(main), n
        reports[k][f"ms_B{other}"] = cells[other]["ms"]
        reports[k][f"library_ms_B{other}"] = cells[other]["library_ms"]
    # the cluster factor, chol_large_kernel and cholesky_ex in the same
    # call at every LARGE_NS x B (seeded SPD inputs; device time by graph
    # replay), with the cluster's size
    gen = torch.Generator(device=dev).manual_seed(LONG_HP)
    grid = {}
    for nn in LARGE_NS:
        for w in LARGE_WIDTHS:
            a = torch.randn((w, nn, nn), generator=gen, device=dev)
            K = a @ a.transpose(1, 2) / nn + torch.eye(nn, device=dev)
            del a
            grid[f"n{nn}_B{w}"] = {
                "cluster_ctas": lk.chol_cluster_geometry(w, nn)[0],
                "cluster_ms": graph_ms(lambda: real["cholesky"](K), 5),
                "chol_large_kernel_ms": graph_ms(lambda: large_kernel(K), 5),
                "cholesky_ex_ms": graph_ms(lambda: library["cholesky"](K),
                                           5),
                "bound_ms": linalg_bound_ms("cholesky", w, nn)[0]}
            del K
    times["factor_grid"] = grid
    slow = [k for k, c in grid.items()
            if c["cluster_ms"] > c["chol_large_kernel_ms"]
            or (k.endswith("_B1") and c["cluster_ms"] > c["cholesky_ex_ms"])]
    times["factor_grid_cluster_slower"] = slow
    reports["cholesky_cluster"]["factor_grid"] = grid
    # the staged solve, cho_solve_large_kernel and torch.cholesky_solve
    # (which a graph cannot capture: CUDA events around back-to-back calls)
    # in the same call at every LARGE_NS x B
    sgrid = {}
    for nn in LARGE_NS:
        for w in LARGE_WIDTHS:
            a = torch.randn((w, nn, nn), generator=gen, device=dev)
            L = torch.linalg.cholesky(a @ a.transpose(1, 2) / nn
                                      + torch.eye(nn, device=dev)
                                      ).contiguous()
            del a
            rhs = torch.randn((w, nn), generator=gen, device=dev)
            fits = lk.solve_staged_smem_bytes(nn) <= lk.SMEM_LIMIT_BYTES
            sgrid[f"n{nn}_B{w}"] = {
                "route": lk.solve_route(w, nn),
                "staged_ms": graph_ms(lambda: staged_solve(L, rhs), 10)
                if fits else None,
                "cho_solve_large_kernel_ms": graph_ms(
                    lambda: large_solve(L, rhs), 10),
                "cholesky_solve_ms": time_cuda(
                    lambda: library["cho_solve"](L, rhs), 10),
                "bound_ms": linalg_bound_ms("cho_solve", w, nn)[0]}
            del L
    times["solve_grid"] = sgrid
    times["solve_grid_staged_slower"] = [
        k for k, c in sgrid.items() if c["staged_ms"] is not None
        and c["staged_ms"] > c["cho_solve_large_kernel_ms"]]
    reports["cho_solve_staged"]["solve_grid"] = sgrid
    # the bounds of every large-n case timed by scripts/torch_kernel_check.py
    # --times k3k4large (n = 240 / 257 / 330 / 400 at B = 1024 / 256 / 1)
    times["bounds_ms"] = {f"{k}_n{nn}_B{w}": linalg_bound_ms(k, w, nn)
                          for k in ("cholesky", "cho_solve")
                          for nn in LARGE_NS for w in (1024, 256, 1)}
    times["bounds_ms"]["gtmv_m384_n257_B256"] = linalg_bound_ms(
        "gtmv", B, n, G.shape[1])
    emit(times)
    reset_counts()
    return [reports["cholesky"], reports["cholesky_cluster"],
            reports["cho_solve"], reports["cho_solve_staged"]]


def long_horizon_and_dense_phases(dev, card, seed) -> list[dict]:
    """Everything about the Riccati sweeps (K6, K7) and the dense-G iteration
    (K2): the long-horizon path (circle-4, hp = 64, B = 256, K6 / K7 with no
    K1 launch), the one-scenario banded step at hp = 64, the dense-fused
    path (frog, B = 1024, K2), the kernels against their plain versions on
    inputs captured there and on odd shapes, and their times. Returns their
    entries of the ``kernels`` line."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.ops import ipm_kernel, riccati_kernel as rk
    from scp_tpu_torch.scenarios import batch as batch_lib, builders
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.solvers import qp, scp
    from scp_tpu_torch.testing import (DENSE_ARG_ORDER, dense_kernel_inputs,
                                       riccati_inputs)

    phases = config_lib.TUNED_F32_PHASES
    reports = {
        "riccati_factor": {"name": "riccati_factor",
                           "replaces": "scp_tpu/ops/pallas_riccati.py:247"},
        "riccati_solve": {"name": "riccati_solve",
                          "replaces": "scp_tpu/ops/pallas_riccati.py:307"},
        "ipm_iterate_dense": {"name": "ipm_iterate_dense",
                              "replaces": "scp_tpu/ops/pallas_linalg.py:1107",
                              "source": "scp_tpu_torch/csrc/ipm_dense.cu"}}
    for k in ("riccati_factor", "riccati_solve"):
        reports[k]["source"] = "scp_tpu_torch/csrc/riccati.cu"
    for r in reports.values():
        # no single PyTorch call computes any of the three functions
        r.update(route="cuda", library_ms=None)
    names = ("riccati_factor", "riccati_solve", "ipm_iterate_dense", "gmv",
             "gtmv")
    real, plain = real_of(*names), plain_of(*names)
    captured: dict[str, tuple] = {}

    def capture(name, width):
        def call(*args, **kw):
            if name not in captured and args[0].shape[0] == width:
                captured[name] = (args, kw)
            return real[name](*args, **kw)
        return call

    ric = ("riccati_factor", "riccati_solve")

    # ---- the long-horizon path: circle-4, hp = hu = 64, B = 256 ----
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg, data = batch_lib.make_batch("circle", LONG_B, generator=gen,
                                     dtype=torch.float32, device=dev,
                                     n_veh=4)
    # (the DEFAULT adaptive IPM's settings, for path (h) below)
    adaptive_qp = dict(max_iter=cfg.qp_max_iter, tol=cfg.qp_tol)
    cfg = config_lib.tuned_f32(cfg.replace(hp=LONG_HP, hu=LONG_HP))
    carry0 = engine.init_carry(cfg, data)

    def step(c):
        return engine.mpc_step_batch(cfg, data, c, phases=phases)

    # a first step with the first full-width factor / solve kept (the first
    # IPM iteration of the first QP) and the first full-width QP's operands
    # (path (h) below); it doubles as the warm-up
    qp_first: list = []
    real_qp = qp.solve_qp_batched

    def qp_spy(*args, **kw):
        if not qp_first and args[1].shape[0] == LONG_B:
            qp_first.append((args, kw))
        return real_qp(*args, **kw)

    qp.solve_qp_batched = qp_spy
    try:
        _, out_first = routed({k: capture(k, LONG_B) for k in ric},
                              step, carry0)
    finally:
        qp.solve_qp_batched = real_qp
    if not qp_first:
        fail("the long-horizon path made no full-width QP call")
    for k in ric:
        if k not in captured:
            fail(f"the long-horizon path made no full-width call of {k}")
    f_args = captured["riccati_factor"][0]
    s_args = captured["riccati_solve"][0]
    V, K = f_args[0].shape[1], f_args[2].shape[1]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    carry, outs = carry0, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LONG_STEPS):
        carry, out = step(carry)
        outs.append(out)
    torch.cuda.synchronize()
    long_step_ms = (time.perf_counter() - t0) / LONG_STEPS * 1e3
    counts = dict(rk.launch_counts)
    k1_launches = ipm_kernel.launch_count
    reads = scp.host_sync_count + qp.host_sync_count
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    for i, out in enumerate(outs):
        finite_outputs(out, f"long-horizon step {i}")
        if out.u_pred.shape != (LONG_B, LONG_HP, 4):
            fail(f"long-horizon step {i}: unexpected output shapes")
    feas = float(torch.stack([o.feasible.float().mean() for o in outs]).mean())
    out_plain = routed(plain_of(*ric), step, carry0)[1]
    du = u_pred_diff(outs[0], out_plain)
    du_med, du_p99 = float(du.median()), float(du.quantile(0.99))
    for k in ric:
        reports[k]["launches"] = counts[k]
        reports[k]["launches_per_step"] = counts[k] / LONG_STEPS
    emit({"phase": "long_horizon_path", "card": card, "B": LONG_B,
          "n_veh": 4, "hp": LONG_HP, "n": 4 * LONG_HP + 1,
          "mg": 6 * LONG_HP, "steps": LONG_STEPS,
          "config": "tuned_f32 (qp_kkt=auto, 7 fixed IPM iterations), "
                    "TUNED_F32_PHASES",
          "feasible_share": feas, "feasible_floor": FEASIBLE_FLOOR,
          "launches_per_step": {k: counts[k] / LONG_STEPS for k in ric},
          "k1_launches": k1_launches,
          "host_reads_per_step": reads / LONG_STEPS,
          "step_ms": long_step_ms,
          "solves_per_s": LONG_B / long_step_ms * 1e3,
          "mean_scp_iters": float(torch.stack(
              [o.scp_iters.float().mean() for o in outs]).mean()),
          "peak_device_memory_mib": peak_mib,
          "first_step_repeats": float(
              (out_first.u_pred - outs[0].u_pred).abs().max()),
          "step_vs_plain_u_pred_median": du_med,
          "step_vs_plain_u_pred_p99": du_p99,
          "step_vs_plain_u_pred_max_abs": float(du.max()),
          "step_vs_plain_feasible_agree": float(
              (outs[0].feasible == out_plain.feasible).float().mean()),
          "u_pred_median_limit": UPRED_MEDIAN_LIMIT,
          "u_pred_p99_limit": UPRED_ABS_LIMIT})
    if k1_launches != 0:
        fail(f"the long-horizon path launched K1 {k1_launches} times")
    if min(counts[k] for k in ric) == 0:
        fail(f"the long-horizon path did not run the Riccati kernels: "
             f"{counts}")
    if counts["riccati_factor_device"] or counts["riccati_solve_device"]:
        fail(f"the long-horizon path (V = 4) left the shared tier: {counts}")
    if counts["riccati_solve"] != 2 * counts["riccati_factor"]:
        fail(f"the long-horizon path made {counts['riccati_solve']} K7 "
             f"launches for {counts['riccati_factor']} K6 launches (two per "
             f"factor wanted)")
    if s_args[-1].ndim != 4:
        fail("the long-horizon path's first solve after a factor had one "
             "right-hand side (two wanted)")
    if feas < FEASIBLE_FLOOR:
        fail(f"long-horizon path: feasible share {feas} below "
             f"{FEASIBLE_FLOOR}")
    if du_med > UPRED_MEDIAN_LIMIT or du_p99 > UPRED_ABS_LIMIT:
        fail(f"long-horizon first step, kernels vs plain: u_pred median "
             f"{du_med} (limit {UPRED_MEDIAN_LIMIT}), 99th percentile "
             f"{du_p99} (limit {UPRED_ABS_LIMIT})")

    # ---- the one-scenario banded step: circle-4, hp = 64, B = 1 ----
    cfg1, data1 = builders.circle(4, dtype=torch.float32, device=dev)
    cfg1 = config_lib.tuned_f32(cfg1.replace(hp=LONG_HP, hu=LONG_HP),
                                qp_kkt="banded")
    one_first: dict[str, tuple] = {}
    captured.clear()
    _, one_k = routed({k: capture(k, 1) for k in ric}, engine.mpc_step,
                      cfg1, data1, engine.init_carry(cfg1, data1))
    one_first.update(captured)
    check_riccati("one_scenario_step_B1", one_first["riccati_factor"][0],
                  one_first["riccati_solve"][0])
    _, one_p = routed(plain_of(*ric), engine.mpc_step, cfg1, data1,
                      engine.init_carry(cfg1, data1))
    cfg64, data64 = builders.circle(4, dtype=torch.float64, device=dev)
    cfg64 = config_lib.tuned_f32(cfg64.replace(hp=LONG_HP, hu=LONG_HP),
                                 qp_kkt="banded")
    _, one_d = routed(plain_of(*ric), engine.mpc_step, cfg64, data64,
                      engine.init_carry(cfg64, data64))
    one_kp = float(u_pred_diff(one_k, one_p).max())
    one_kd = float(u_pred_diff(one_k, one_d).max())
    one_pd = float(u_pred_diff(one_p, one_d).max())
    reset_counts()
    lats, feas1 = [], []
    c_i = engine.init_carry(cfg1, data1)
    for _ in range(LATENCY64_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LATENCY_REPS):
            engine.mpc_step(cfg1, data1, c_i)
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t0) / LATENCY_REPS * 1e3)
        c_i, out = engine.mpc_step(cfg1, data1, c_i)
        finite_outputs(out, "one-scenario banded step")
        feas1.append(float(out.feasible.float().mean()))
    one_counts = dict(rk.launch_counts)
    lats.sort()
    one_rep = {"step0_vs_plain_u_pred_max_abs": one_kp,
               "step0_vs_f64_u_pred_max_abs": one_kd,
               "step0_plain_vs_f64_u_pred_max_abs": one_pd,
               "step0_same_scp_iters": bool(
                   (one_k.scp_iters == one_p.scp_iters).all()),
               "step0_u_pred_limit": UPRED_ABS_LIMIT}
    emit({"phase": "one_scenario_banded", "card": card, "n_veh": 4,
          "hp": LONG_HP, "steps": LATENCY64_STEPS,
          "config": "tuned_f32, qp_kkt=banded (solve_scp -> solve_qp banded)",
          "feasible_share": sum(feas1) / len(feas1),
          "launches_per_step": {
              k: one_counts[k] / (LATENCY64_STEPS * (LATENCY_REPS + 1))
              for k in ric},
          "latency_reps": LATENCY_REPS,
          "step_latency_ms_p50": lats[len(lats) // 2],
          "step_latency_ms_p90": lats[min(len(lats) - 1,
                                          int(0.90 * len(lats)))],
          "step_latency_ms_max": lats[-1],
          "step_latency_ms_min": lats[0], **one_rep})
    if min(one_counts[k] for k in ric) == 0:
        fail(f"the one-scenario banded step did not run K6 / K7: "
             f"{one_counts}")
    if one_counts["riccati_factor_device"] \
            or one_counts["riccati_solve_device"]:
        fail(f"the one-scenario banded step (V = 4) left the shared tier: "
             f"{one_counts}")
    if one_counts["riccati_solve"] != 2 * one_counts["riccati_factor"]:
        fail(f"the one-scenario banded step made "
             f"{one_counts['riccati_solve']} K7 launches for "
             f"{one_counts['riccati_factor']} K6 launches (two per factor "
             f"wanted)")
    if one_kp > UPRED_ABS_LIMIT or one_kd > 2 * one_pd + UPRED_ABS_LIMIT \
            or bool((one_k.feasible != one_p.feasible).any()):
        fail(f"one-scenario banded step 0, kernels vs plain: {one_rep}")

    # ---- paths (g) and (h): the dense KKT at hp = 64 (n = 257) ----
    dense64_reports = dense_hp64_phases(dev, card, qp_first[0], adaptive_qp,
                                        (one_k, one_p, one_d))

    # ---- the Riccati kernels against their plain versions ----
    ric_err = {}
    for w in RICCATI_WIDTHS:
        e_f, e_s = check_riccati(
            f"long_horizon_first_ipm_iteration_B{w}",
            tuple(a[:w].contiguous() for a in f_args),
            solve_args_at(s_args, w))
        if w == RICCATI_WIDTHS[0]:
            ric_err = {"riccati_factor": e_f, "riccati_solve": e_s}
    # odd widths: V = 6 is the first with more rows than a warp has lanes
    # (W = 36), V = 16 the generic kernels at a calibrated fleet's width
    for case, (B_o, V_o, K_o) in (("odd_V3_B3", (3, 3, 16)),
                                  ("single_vehicle_V1_B3", (3, 1, 20)),
                                  ("rows_past_a_warp_V6_B9", (9, 6, 12)),
                                  ("wide_V16_B4", (4, 16, 8))):
        r = riccati_inputs(B_o, V_o, K_o, seed=V_o)
        t = {k: torch.as_tensor(v, device=dev) for k, v in r.items()}
        t["a_blk"] = (0.9 * t["a_blk"]).contiguous()   # stable dynamics
        fac = rk.riccati_factor(t["a_blk"], t["b_blk"], t["hy"], t["hu"])
        r2 = torch.stack([t["r"], t["r"].flip(1)])
        check_riccati(case, (t["a_blk"], t["b_blk"], t["hy"], t["hu"]),
                      (*fac, t["a_blk"], t["b_blk"], r2))
    s_args2 = s_args                                  # two right-hand sides
    s_args = solve_args_at(s_args, LONG_B, rhs=0)   # one right-hand side
    for k, args in (("riccati_factor", f_args), ("riccati_solve", s_args)):
        reports[k]["max_abs_err"], reports[k]["max_err_rel_to_scale"] = \
            ric_err[k]
        try:
            real[k](*[a.double() for a in args])
        except TypeError:
            continue
        fail(f"the {k} wrapper accepted float64 CUDA tensors")

    # ---- the dense-fused path: frog (one vehicle), hp = 20, B = 1024 ----
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg_f, data_f = batch_lib.make_batch("frog", FROG_B, generator=gen,
                                         dtype=torch.float32, device=dev)
    cfg_f = config_lib.tuned_f32(cfg_f.replace(hp=FROG_HP, hu=FROG_HP))
    carry_f = engine.init_carry(cfg_f, data_f)

    def step_f(c):
        return engine.mpc_step_batch(cfg_f, data_f, c, phases=phases)

    # A first step with EVERY K2 launch (one per QP) held against the plain
    # version and the float64 oracle on its own inputs; the first
    # full-width launch is kept for the phases below. It doubles as the
    # warm-up.
    captured.clear()
    shadowed: list[dict] = []
    captured_launches: list[int] = []

    def shadow(*args, **kw):
        captured.setdefault("ipm_iterate_dense", (args, kw))
        out_k = real["ipm_iterate_dense"](*args, **kw)
        shadowed.extend({**r, "launch": len(captured_launches)}
                        for r in dense_launch_errors(
                            real["ipm_iterate_dense"], args, kw, out_k))
        captured_launches.append(args[DENSE_G].shape[0])
        return out_k

    _, out_first_f = routed({"ipm_iterate_dense": shadow}, step_f, carry_f)
    if captured["ipm_iterate_dense"][0][DENSE_G].shape[0] != FROG_B:
        fail("the dense-fused path's first K2 call is not full-width")
    d_args, d_kw = captured["ipm_iterate_dense"]
    if d_kw["n_iters"] != cfg_f.qp_fixed_iters:
        fail(f"the dense-fused path ran {d_kw['n_iters']} iterations per K2 "
             f"launch, not the QP's {cfg_f.qp_fixed_iters}")
    keys = ("launch", "iteration", "B", "n_iters", "first_iteration",
            "u_kernel_vs_plain_max", "u_kernel_vs_plain_median",
            "u_kernel_vs_f64_max", "u_plain_vs_f64_max",
            "u_kernel_vs_f64_p99", "u_plain_vs_f64_p99", "frozen_differ",
            "chain_bit_identical", "u_perturbed_vs_plain_median",
            "u_median_allowed", "u_f32_vs_f64_p99", "u_f32_vs_f64_max",
            "frozen_differ_perturbed", "frozen_differ_allowed")
    whole = [r for r in shadowed if "iteration" not in r]
    emit({"phase": "frog_first_step_every_launch_vs_plain",
          "launches": len(captured_launches), "widths": captured_launches,
          "launch_bounds": sorted({ipm_kernel.dense_min_ctas(w, _sm_count())
                                   for w in captured_launches}),
          "whole_launch_u_median_max": max(
              r["u_kernel_vs_plain_median"] for r in whole),
          "whole_launch_u_median_over_perturbed_max": max(
              r["u_kernel_vs_plain_median"]
              / max(r["u_perturbed_vs_plain_median"], 1e-30) for r in whole),
          "whole_launch_chain_bit_identical": all(
              r["chain_bit_identical"] for r in whole),
          "whole_launch_frozen_differ": sum(r["frozen_differ"]
                                            for r in whole),
          "whole_launch_frozen_differ_perturbed": sum(
              r["frozen_differ_perturbed"] for r in whole),
          "one_iteration_u_median_max": max(
              r["u_kernel_vs_plain_median"] for r in shadowed
              if "iteration" in r),
          "one_iteration_frozen_flags_equal": all(
              r["frozen_equal"] for r in shadowed if "iteration" in r),
          "limits": DENSE_LIMITS,
          "per_launch": [[r.get(k) for k in keys] for r in shadowed],
          "per_launch_keys": keys})
    for r in shadowed:
        if dense_off_limits(r):
            fail(f"frog first step, K2 launch {r['launch']} (iteration "
                 f"{r.get('iteration', 'all')}): the kernel disagrees with "
                 f"its plain version on the same inputs: {r}")
    # the chained steps, with the QPs of the dense-G branch counted beside
    # K2's launches, and again through the plain version
    ch = chain_vs_plain(step_f, carry_f, FROG_STEPS, ("ipm_iterate_dense",),
                        spy=(qp, "_solve_qp_batched_dense"))
    outs_f, outs_p = ch["outs"], ch["outs_plain"]
    k2 = ch["counts"]["ipm_iterate_dense"]
    k1_f = ch["counts"]["ipm_iterate_struct"]
    n_qp, frog_step_ms = ch["spy_calls"], ch["chained_step_ms"]
    feas_f, feas_p = ch["feasible_share"], ch["feasible_share_plain"]
    for i, out in enumerate(outs_f):
        finite_outputs(out, f"frog step {i}")
        if out.u_pred.shape != (FROG_B, FROG_HP, 1):
            fail(f"frog step {i}: unexpected output shapes")
    data_f64 = as_f64(data_f)
    # (the dense-fused branch also multiplies by G through K5a / K5b,
    # which are float32 only: the oracle routes them to their plain versions)
    out_f64 = routed(plain_of("ipm_iterate_dense", "gmv", "gtmv"),
                     engine.mpc_step_batch, cfg_f, data_f64,
                     engine.init_carry(cfg_f, data_f64), phases=phases)[1]
    du = u_pred_diff(outs_f[0], outs_p[0])
    du_k64, du_p64 = u_pred_diff(outs_f[0], out_f64), u_pred_diff(outs_p[0],
                                                                  out_f64)
    du_med, du_p99 = float(du.median()), float(du.quantile(0.99))
    excess = du_k64 - (2 * du_p64 + UPRED_ABS_LIMIT)
    n_beyond = int((excess > 0).sum())
    p99_limit = max(UPRED_ABS_LIMIT, float(du_p64.quantile(0.99)))
    k64_p99, p64_p99 = (float(d.quantile(0.99)) for d in (du_k64, du_p64))
    k64_max, p64_max = float(du_k64.max()), float(du_p64.max())
    f64_off = (k64_p99 > 2 * p64_p99 + UPRED_ABS_LIMIT
               or k64_max > 2 * p64_max + UPRED_ABS_LIMIT)
    worst = torch.argsort(excess, descending=True)[:8].tolist()
    reports["ipm_iterate_dense"]["launches"] = k2
    reports["ipm_iterate_dense"]["launches_per_step"] = k2 / FROG_STEPS
    emit({"phase": "dense_fused_path", "card": card, "scenario": "frog",
          "B": FROG_B, "n_veh": 1, "hp": FROG_HP,
          "n": d_args[DENSE_G].shape[2], "mg": d_args[DENSE_G].shape[1],
          "steps": FROG_STEPS,
          "config": "tuned_f32 (qp_kkt=auto, 7 fixed IPM iterations), "
                    "TUNED_F32_PHASES",
          "k2_launches_per_step": k2 / FROG_STEPS,
          "dense_qps_per_step": n_qp / FROG_STEPS, "k1_launches": k1_f,
          "host_reads_per_step": ch["host_reads"] / FROG_STEPS,
          "step_ms": frog_step_ms,
          "solves_per_s": FROG_B / frog_step_ms * 1e3,
          "peak_device_memory_mib": ch["peak_mib"],
          "feasible_share": feas_f, "feasible_share_plain": feas_p,
          "feasible_floor": ch["feasible_floor"],
          "mean_scp_iters": float(torch.stack(
              [o.scp_iters.float().mean() for o in outs_f]).mean()),
          "step_vs_plain_u_pred_median": du_med,
          "step_vs_plain_u_pred_p99": du_p99,
          "step_vs_plain_u_pred_max_abs": float(du.max()),
          "step_vs_f64_u_pred_p99": k64_p99,
          "step_vs_f64_u_pred_max_abs": k64_max,
          "plain_step_vs_f64_u_pred_p99": p64_p99,
          "plain_step_vs_f64_u_pred_max_abs": p64_max,
          "instances_beyond_2x_plain_vs_f64_plus_limit": n_beyond,
          # [kernel vs plain, kernel vs f64, plain vs f64, SCP iterations of
          #  the kernel step, of the plain step, of the float64 step]
          "step_vs_f64_worst": [
              [float(du[i]), float(du_k64[i]), float(du_p64[i]),
               int(outs_f[0].scp_iters[i]), int(outs_p[0].scp_iters[i]),
               int(out_f64.scp_iters[i])] for i in worst],
          "first_step_repeats": float(
              (out_first_f.u_pred - outs_f[0].u_pred).abs().max()),
          "u_pred_median_limit": UPRED_MEDIAN_LIMIT,
          "u_pred_p99_limit": p99_limit})
    if k2 == 0 or k2 != n_qp or k1_f != 0:
        fail(f"the dense-fused path launched K2 {k2} times for {n_qp} QPs "
             f"and K1 {k1_f} times")
    if feas_f < ch["feasible_floor"]:
        fail(f"dense-fused path: feasible share {feas_f}, the plain "
             f"versions' {feas_p}")
    if du_med > UPRED_MEDIAN_LIMIT or du_p99 > p99_limit or f64_off:
        fail(f"dense-fused first step, kernel vs plain: u_pred median "
             f"{du_med} (limit {UPRED_MEDIAN_LIMIT}), 99th percentile "
             f"{du_p99} (limit {p99_limit}); distance from the float64 "
             f"step p99 {k64_p99} / max {k64_max} against the plain "
             f"step's {p64_p99} / {p64_max} (limit 2 x + "
             f"{UPRED_ABS_LIMIT})")

    # ---- K2 against its plain version: one iteration and a whole QP ----
    # (DENSE_WIDTHS lie on both sides of dense_min_ctas's switch: each
    # launch bound is checked)
    bounds = {ipm_kernel.dense_min_ctas(w, _sm_count()) for w in DENSE_WIDTHS}
    if bounds != {2, 4}:
        fail(f"the K2 checks reach the launch bounds {sorted(bounds)}, not "
             f"both 2 and 4 CTAs an SM")
    for w in DENSE_WIDTHS:
        args_w = [None if a is None else a[:w].contiguous() for a in d_args]
        one = check_dense(f"frog_first_ipm_iteration_B{w}", args_w,
                          {**d_kw, "n_iters": 1})["one_iter_max_abs_err"]
        check_dense(f"frog_first_qp_B{w}", args_w, d_kw)
        if w == DENSE_WIDTHS[0]:
            reports["ipm_iterate_dense"]["max_abs_err"] = one
    for case, (B_o, mg_o, nb_o, d_o, schur, blocks, n_cor) in (
            ("odd_n15_dense_P_B3", (3, 45, 2, 7, True, False, 1)),
            ("odd_n15_no_schur_B3", (3, 45, 2, 7, False, True, 2)),
            ("g_in_device_memory_n65_B8", (8, 900, 4, 16, True, True, 1))):
        a = dense_kernel_inputs(B_o, mg_o, nb_o, d_o, seed=mg_o + n_cor,
                                blocks=blocks)
        args_o = [None if a[k] is None else torch.as_tensor(a[k], device=dev)
                  for k in DENSE_ARG_ORDER]
        for n_iters in (1, cfg_f.qp_fixed_iters):
            check_dense(f"{case}_iters{n_iters}", args_o,
                        dict(tol=1e-6, reg_rel=3e-6, n_cor=n_cor,
                             schur_slack=schur, n_iters=n_iters))
    try:
        real["ipm_iterate_dense"](*[None if t is None else t.double()
                                    for t in d_args], **d_kw)
    except TypeError:
        pass
    else:
        fail("the dense-G wrapper accepted float64 CUDA tensors")

    # ---- times ----
    times = {"phase": "riccati_dense_times", "card": card,
             "long_horizon_step_ms": long_step_ms,
             "frog_step_ms": frog_step_ms, "kernels": {}}
    B_d, mg_d, n_d = d_args[DENSE_G].shape
    pb_d = d_args[DENSE_PB]
    nb_d, dd = (0, 0) if pb_d is None else tuple(pb_d.shape[1:3])
    times["k2_resident_ctas_per_sm"] = {
        str(b): ipm_kernel.dense_resident_ctas_per_sm(
            mg_d, n_d, nb_d, dd, d_kw["schur_slack"], d_kw["n_cor"], b)
        for b in (2, 4)}
    times["k2_launch_bound_by_width"] = {
        str(w): ipm_kernel.dense_min_ctas(w, _sm_count())
        for w in DENSE_WIDTHS}
    for k, args_all, widths in (
            ("riccati_factor", f_args, RICCATI_TIME_WIDTHS),
            ("riccati_solve", s_args, RICCATI_TIME_WIDTHS),
            ("ipm_iterate_dense", d_args, DENSE_WIDTHS)):
        kw = d_kw if k == "ipm_iterate_dense" else {}
        times["kernels"][k] = {}
        for w in widths:
            args = tuple(None if a is None else a[:w].contiguous()
                         for a in args_all)
            # device time by CUDA-graph replay (see graph_ms), the plain
            # version by CUDA events around its calls (host-bound), as K1's
            cell = {"ms": graph_ms(lambda: real[k](*args, **kw), 20),
                    "plain_ms": time_cuda(lambda: plain[k](*args, **kw), 3,
                                          warmup=1)}
            if k == "ipm_iterate_dense":
                work = dense_work(w, mg_d, n_d, nb_d, dd, kw["schur_slack"],
                                  kw["n_cor"], kw["n_iters"])
            else:
                work = riccati_work(k, w, V, K)
            cell["bound_ms"], cell["bound_by"] = bound_of(*work)
            cell["call_ms"] = time_cuda(lambda: real[k](*args, **kw), 20)
            if k == "riccati_solve":
                # two right-hand sides in one launch: the factor's bytes
                # once, r and du twice
                a2 = solve_args_at(s_args2, w)
                two = {"ms": graph_ms(lambda: real[k](*a2), 20)}
                two["bound_ms"], two["bound_by"] = bound_of(
                    *riccati_work(k, w, V, K, n_rhs=2))
                two["bound_per_rhs_ms"] = two["bound_ms"] / 2
                two["ms_per_rhs"] = two["ms"] / 2
                two["over_two_one_rhs_launches"] = two["ms"] / (
                    2 * cell["ms"])
                cell["two_rhs"] = two
            times["kernels"][k][str(w)] = cell
            if w == widths[0]:
                reports[k].update(cell)
    emit(times)
    reset_counts()
    return [reports[k] for k in ("riccati_factor", "riccati_solve",
                                 "ipm_iterate_dense")] + dense64_reports


# ---- the side-selection controller: paths (i), (ii), (iii) ----
SS_HP = 10
SS_FROG_B, SS_PAR_B, SS_PAR_VEH = 1024, 256, 11
SS_STEPS, SS_TIMED_STEPS, SS_RECT_STEPS = 4, 3, 2
SS_CANDIDATES = 5          # first-round side assignments per instance
# (iii)'s step 0 drives straight (every control within 1e-7 rad of 0, where
# the kernels, the plain versions and float64 agree whatever K2 does), so
# its first step with at least SS_STEER_SHARE of its controls steering (at
# least SS_STEER_MIN rad) and further than SS_BOUND_TOL rad from their
# bounds is held as step 0 is
SS_STEER_SHARE, SS_STEER_MIN, SS_BOUND_TOL = 0.5, 1e-3, 1e-4
# Step 0 of each side-selection path is held to the limits the SCP paths
# already use: the batch paths to the dense-fused path's (the median and
# the 99th percentile of the controls' difference from the plain versions'
# step, the distance from the float64 step as a distribution), the
# one-scenario path to the one-scenario paths' (the maximum itself). The
# controller's discrete outputs (the candidate it keeps, the reselected
# sides: seen as the feasible and sides_stable flags) can flip on an
# instance where the two float32 solvers round differently, so the flags
# that differ are held to the yardstick of run_yardstick, measured in the
# same run (the plain versions' step on inputs perturbed by 2^-23).


def ss_config(cfg, hp: int = SS_HP):
    """The calibrated float32 side-selection controller, composed as the
    reference CLI composes it (``TUNED_F32_OVERRIDES`` updated by
    ``TUNED_F32_SIDE_SELECTION``), at hp = hu = ``hp``."""
    from scp_tpu_torch import config as config_lib
    return config_lib.tuned_f32(
        cfg.replace(controller="side_selection", hp=hp, hu=hp),
        **config_lib.TUNED_F32_SIDE_SELECTION)


def steering_share(cfg, data, carry, out) -> float:
    """Share of a step's controls that steer (at least SS_STEER_MIN rad)
    off their bounds: further than SS_BOUND_TOL from the magnitude bound
    (the steering limit at the carry's state) and from the QP's rate bound
    (``u_lim`` from the control before)."""
    from scp_tpu_torch.sim import engine
    u_max = engine.dynamic_steering_limit(cfg, data, carry.state)
    U = out.u_pred
    dU = torch.diff(U, dim=1, prepend=carry.u_prev1[:, None, :])
    at = ((U.abs() >= u_max[:, None, :] - SS_BOUND_TOL)
          | (dU.abs() >= cfg.u_lim - SS_BOUND_TOL))
    return float(((U.abs() >= SS_STEER_MIN) & ~at).float().mean())


def ss_flags(out):
    """The controller's discrete outputs of a step, (B, 2)."""
    return torch.stack([out.feasible, out.sides_stable], dim=1)


def ss_step0_errors(out_k, out_p, out_d, run_perturbed, one_scenario):
    """Step 0 through the kernels (``out_k``), the plain versions
    (``out_p``) and in float64 (``out_d``): the controls under the SCP
    paths' limits (see SS_* above), the flags under run_yardstick's
    allowance. Returns the report and whether it is within its limits."""
    du = u_pred_diff(out_k, out_p)
    du_k64, du_p64 = u_pred_diff(out_k, out_d), u_pred_diff(out_p, out_d)
    y = run_yardstick(run_perturbed, lambda o: o.u_pred.flatten(1),
                      ss_flags, out_p, out_d, "flags")
    rep = {"flags_differ": int((ss_flags(out_k) != ss_flags(out_p)).sum()),
           "finite": all(bool(torch.isfinite(t).all()) for t in out_k
                         if t.is_floating_point()),
           "u_pred_vs_plain_max": float(du.max()),
           "u_pred_vs_plain_median": float(du.median()),
           "u_pred_vs_plain_p99": _q99(du),
           "u_pred_vs_f64_max": float(du_k64.max()),
           "u_pred_vs_f64_p99": _q99(du_k64),
           "plain_u_pred_vs_f64_max": float(du_p64.max()),
           "plain_u_pred_vs_f64_p99": _q99(du_p64),
           "same_qp_iters": bool((out_k.qp_iters == out_p.qp_iters).all()),
           # (whether a low share is float32's or the controller's own)
           "feasible_share": {k: float(o.feasible.float().mean())
                              for k, o in (("kernels", out_k),
                                           ("plain", out_p),
                                           ("float64", out_d))},
           **{f"yardstick_{k}": v for k, v in y.items()}}
    if one_scenario:
        rep["limits"] = {"u_pred_vs_plain_max": UPRED_ABS_LIMIT,
                         "u_pred_vs_f64_max": "2 x plain's + "
                                              f"{UPRED_ABS_LIMIT}",
                         "flags_differ": "yardstick"}
        u_ok = (rep["u_pred_vs_plain_max"] <= UPRED_ABS_LIMIT
                and rep["u_pred_vs_f64_max"]
                <= 2 * rep["plain_u_pred_vs_f64_max"] + UPRED_ABS_LIMIT)
    else:
        p99_limit = max(UPRED_ABS_LIMIT, rep["plain_u_pred_vs_f64_p99"])
        rep["limits"] = {"u_pred_vs_plain_median": UPRED_MEDIAN_LIMIT,
                         "u_pred_vs_plain_p99": p99_limit,
                         "u_pred_vs_f64_p99_and_max":
                             f"2 x plain's + {UPRED_ABS_LIMIT}",
                         "flags_differ": "yardstick"}
        u_ok = (rep["u_pred_vs_plain_median"] <= UPRED_MEDIAN_LIMIT
                and rep["u_pred_vs_plain_p99"] <= p99_limit
                and rep["u_pred_vs_f64_p99"]
                <= 2 * rep["plain_u_pred_vs_f64_p99"] + UPRED_ABS_LIMIT
                and rep["u_pred_vs_f64_max"]
                <= 2 * rep["plain_u_pred_vs_f64_max"] + UPRED_ABS_LIMIT)
    ok = (u_ok and rep["finite"]
          and rep["flags_differ"] <= rep["yardstick_flags_differ_allowed"])
    return rep, ok


class SideSelectionChecks:
    """What the side-selection paths ((i)-(iii), and (l1) past K1's shared
    tier) check on a step of the controller: the kernel wrappers they route
    (K1, K2 and the G products), every first-step launch held against its
    plain version (``launch_rows`` collects them), step 0 three ways, the
    launch counts, the times."""
    NAMES = ("ipm_iterate_struct", "ipm_iterate_dense", "gmv", "gtmv")

    def __init__(self, dev, card, seed):
        self.dev, self.card, self.seed = dev, card, seed
        self.real, self.plain = real_of(*self.NAMES), plain_of(*self.NAMES)
        self.launch_rows = []     # every first-step launch's agreement

    def first_step_launches(self, kept_names, step, carry):
        """The step with every launch of ``kept_names`` kept (it doubles
        as the warm-up): ``(output, {name: [(args, kw), ...]})``."""
        kept = {k: [] for k in kept_names}

        def keeper(name):
            def keep(*a, **k):
                kept[name].append((a, k))
                return self.real[name](*a, **k)
            return keep
        return routed({k: keeper(k) for k in kept_names}, step, carry), kept

    def step_three_ways(self, cfg, data, carry, entry, one_scenario,
                        names=None):
        """One step from ``(data, carry)`` through the kernels, the plain
        versions (of ``names``, the side-selection QPs' kernels by default),
        float64 and the perturbed draws, under ss_step0_errors."""
        from scp_tpu_torch.config import tree_map
        plain_all = plain_of(*(names or self.NAMES))

        def run(d, c):
            return entry(cfg, d, c)[1]
        out_k = run(data, carry)
        torch.cuda.synchronize()
        out_p = routed(plain_all, run, data, carry)
        out_d = routed(plain_all, run, as_f64(data), as_f64(carry))
        return ss_step0_errors(
            out_k, out_p, out_d,
            lambda gen: routed(plain_all, run,
                               *(tree_map(lambda t: _perturb(t, gen), x)
                                 for x in (data, carry))),
            one_scenario)

    @staticmethod
    def expect_launches(path, got, n_steps, kernel):
        """Exactly two launches of ``kernel`` (a key of ``launch_counts``:
        a wrapper's name, or with ``_device`` its device tier's) a step
        and no other kernel but K5a, which the dense-G branch launches
        once per QP (its cold start's G x0)."""
        want = {k: 0 for k in got}
        want[kernel] = 2 * n_steps
        if kernel.startswith("ipm_iterate_dense"):
            want["gmv"] = 2 * n_steps
        if got != want:
            fail(f"side-selection path {path}: launches {got}, wanted "
                 f"{want} ({n_steps} steps)")

    def kernel_checks(self, path, kernel, kept):
        """Each launch of the first step against its plain version on its
        own inputs; returns the largest difference on the controls."""
        real, plain, dev = self.real, self.plain, self.dev
        errs = []
        for i, (a, k) in enumerate(kept[kernel]):
            case = f"side_selection_{path}_launch{i}_B{a[0].shape[0]}"
            row = {"path": path, "kernel": kernel, "B": a[0].shape[0],
                   "n_iters": k["n_iters"]}
            if kernel == "ipm_iterate_dense":
                e = check_dense(case, a, k)
                row.update({key: e[key] for key in (
                    "u_kernel_vs_plain_max", "u_kernel_vs_plain_median",
                    "u_kernel_vs_f64_max", "u_plain_vs_f64_max",
                    "u_perturbed_vs_plain_max", "u_median_allowed",
                    "frozen_differ", "frozen_differ_allowed",
                    "one_iter_max_abs_err", "one_iter_max_rel_err",
                    "state_perturbed_vs_plain_max_abs")})
            else:
                nu = a[4].shape[1] * a[4].shape[2]
                gsl = a[3]
                if not (k["lower_tri"] and bool((gsl[:, -2 * nu:] == 0).all())
                        and bool((gsl[:, :-2 * nu] < 0).all())):
                    fail(f"{case}: not the lower-triangular slabs with the "
                         f"hard rate rows last")
                e = check_kernel(case, a, k, real[kernel], plain[kernel])
                row.update({key: e[key] for key in (
                    "u_kernel_vs_plain_max", "u_kernel_vs_plain_median",
                    "u_kernel_vs_f64_max", "u_plain_vs_f64_max",
                    "one_iter_max_abs_err", "limits")})
            self.launch_rows.append(row)
            errs.append(e["u_kernel_vs_plain_max"])
        # K5a's G x0 on its own inputs, and on the same G with a random x
        # (x0 is the warm start, zero at a closed loop's first step)
        gen = torch.Generator(device=dev).manual_seed(self.seed)
        for i, (a, k) in enumerate(kept.get("gmv", ())):
            if k:
                fail(f"side-selection path {path}: K5a called with {k}")
            G, x = a
            xr = torch.randn(x.shape, generator=gen, device=dev,
                             dtype=x.dtype)
            for tag, args in (("", a), ("_random_x", (G, xr))):
                e = check_vector("gmv", f"side_selection_{path}_gmv{i}_"
                                 f"B{G.shape[0]}{tag}", real["gmv"],
                                 plain["gmv"], args, MATVEC_REL_LIMIT)
                self.launch_rows.append({
                    "path": path, "kernel": "gmv" + tag, "B": G.shape[0],
                    "shape": list(G.shape[1:]),
                    **{key: e[key] for key in (
                        "kernel_vs_plain_max_abs", "kernel_vs_f64_max_abs",
                        "plain_vs_f64_max_abs", "scale")}})
        return max(errs)

    def times(self, path, kernel, kept, reps=10):
        """Device time of each first-step launch by CUDA-graph replay
        (``reps`` calls a graph), the plain version by CUDA events, the
        bound; K5a's cold-start G x0 by graph replay, with ``torch.bmm`` on
        the same inputs."""
        real, plain = self.real, self.plain
        cells = {}
        for a, k in kept[kernel]:
            w = a[0].shape[0]
            cell = {"n_iters": k["n_iters"],
                    "ms": graph_ms(lambda: real[kernel](*a, **k), reps),
                    "plain_ms": time_cuda(lambda: plain[kernel](*a, **k), 3,
                                          warmup=1)}
            if kernel == "ipm_iterate_dense":
                B_, mg, n = a[0].shape
                nb, d = a[2].shape[1:3]
                work = dense_work(B_, mg, n, nb, d, k["schur_slack"],
                                  k["n_cor"], k["n_iters"])
                cell["mg"], cell["n"] = mg, n
            else:
                P, S = a[0].shape[1], a[2].shape[1]
                hp, hu = a[0].shape[2:]
                V = a[4].shape[1]
                work = k1_work(P, S, hp, hu, V, w, k["n_iters"], k["n_cor"],
                               k["lower_tri"])
                cell["shape"] = {"P": P, "S": S, "hp": hp, "hu": hu, "V": V}
            cell["bound_ms"], cell["bound_by"] = bound_of(*work)
            cells[f"{path}_B{w}"] = cell
        gmv_cells = {}
        for a, _ in kept.get("gmv", ()):
            (w, m, n), (G, x) = a[0].shape, a
            cell = {"m": m, "n": n,
                    "ms": graph_ms(lambda: real["gmv"](G, x), 10),
                    "plain_ms": graph_ms(lambda: plain["gmv"](G, x), 10),
                    "library_ms": graph_ms(
                        lambda: torch.bmm(G, x[:, :, None]), 10)}
            cell["bound_ms"], cell["bound_by"] = linalg_bound_ms(
                "gmv", w, n, m)
            gmv_cells[f"{path}_B{w}"] = cell
        return cells, gmv_cells

    def batch_path(self, path, kind, B, kernel, hp=SS_HP, count_key=None,
                   steps=SS_STEPS, timed_steps=SS_TIMED_STEPS, **kw):
        """Path ``path``: the controller at hp = hu = ``hp`` on the
        randomized ``kind`` batch of ``B`` through ``mpc_step_batch``, every
        first-step launch of ``kernel`` checked, ``steps`` chained steps
        counted (``count_key``: the count the two launches a step go to,
        the wrapper's own by default) and then through the plain version,
        ``timed_steps`` timed, step 0 three ways. Returns ``(cfg, carry0,
        step, kept, report, step 0 within its limits)``."""
        from scp_tpu_torch.ops import constraints as con
        from scp_tpu_torch.scenarios import batch as batch_lib
        from scp_tpu_torch.sim import engine
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        cfg, data = batch_lib.make_batch(kind, B, generator=gen,
                                         dtype=torch.float32,
                                         device=self.dev, **kw)
        cfg = ss_config(cfg, hp)
        carry0 = engine.init_carry(cfg, data)

        def step(c, cf=cfg):
            return engine.mpc_step_batch(cf, data, c)

        kept_names = (kernel, "gmv") if kernel == "ipm_iterate_dense" \
            else (kernel,)
        (_, out_first), kept = self.first_step_launches(kept_names, step,
                                                        carry0)
        widths = [a[0].shape[0] for a, _ in kept[kernel]]
        iters = [k["n_iters"] for _, k in kept[kernel]]
        if widths != [SS_CANDIDATES * B, B] or iters != [
                cfg.side_selection_cand_iters, cfg.qp_fixed_iters]:
            fail(f"side-selection path {path}: first-step launches "
                 f"{list(zip(widths, iters))}")
        max_err = self.kernel_checks(path, kernel, kept)
        # the chained steps, counted (with the scatters of dense rows) and
        # timed, then through the plain version
        ch = chain_vs_plain(step, carry0, steps, (kernel,),
                            spy=(con, "scatter_slabs"))
        outs, got = ch["outs"], ch["counts"]
        self.expect_launches(path, got, steps, count_key or kernel)
        c = ch["carry"]
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            c, _ = step(c)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / timed_steps * 1e3
        for i, out in enumerate(outs):
            finite_outputs(out, f"side-selection path {path} step {i}")
            if out.u_pred.shape != (B, hp, cfg.n_veh):
                fail(f"side-selection path {path} step {i}: unexpected "
                     f"output shapes")
        err0, ok0 = self.step_three_ways(cfg, data, carry0,
                                         engine.mpc_step_batch, False)
        rep = {"phase": f"side_selection_path_{path}", "card": self.card,
               "scenario": kind, "B": B, "n_veh": cfg.n_veh, "hp": hp,
               "n": cfg.n_veh * hp + 1,
               "config": "tuned_f32 + TUNED_F32_SIDE_SELECTION "
                         "(8 IPM iterations per candidate, 12 per round)",
               "steps": steps, "timed_steps": timed_steps,
               "launches_per_step": {k: v / steps for k, v in got.items()},
               "dense_row_scatters_per_step": ch["spy_calls"] / steps,
               "first_step_launch_widths": widths,
               "host_reads_per_step": ch["host_reads"] / steps,
               "step_ms": step_ms, "chained_step_ms": ch["chained_step_ms"],
               "solves_per_s": B / step_ms * 1e3,
               "peak_device_memory_mib": ch["peak_mib"],
               "step_peak_above_resident_mib":
                   ch["step_peak_above_resident_mib"],
               **{k: ch[k] for k in ("feasible_share", "feasible_share_plain",
                                     "feasible_floor")},
               "sides_stable_share": float(torch.stack(
                   [o.sides_stable.float().mean() for o in outs]).mean()),
               "mean_qp_iters": float(torch.stack(
                   [o.qp_iters.float().mean() for o in outs]).mean()),
               "first_step_repeats": float(
                   (out_first.u_pred - outs[0].u_pred).abs().max()),
               "kernel_vs_plain_max_abs_err": max_err,
               "step0": err0}
        return cfg, carry0, step, kept, rep, ok0

    @staticmethod
    def path_failures(path, rep, ok0):
        if not ok0:
            fail(f"side-selection path {path}, step 0 off its limits: "
                 f"{rep['step0']}")
        if rep["feasible_share"] < rep["feasible_floor"]:
            fail(f"side-selection path {path}: feasible share "
                 f"{rep['feasible_share']}, floor {rep['feasible_floor']}")


def side_selection_phases(dev, card, seed) -> dict:
    """The side-selection controller on the card (``controller=
    "side_selection"``, ``ss_config``), float32, each path's launch counts
    set to 0 just before it and read just after:

    (i)   frog, B = SS_FROG_B, through ``mpc_step_batch``: exactly two K2
          launches a step (the 5B-wide first-round candidates at 8
          iterations, then the B-wide reselection round at 12), no K1,
          K3, K4, K5b, K6, K7; K5a once per K2 launch (the cold start's
          G x0 of the dense-G branch); then SS_RECT_STEPS steps in
          rotated-rectangle mode (obstAsQCQP=0), the same launches;
    (ii)  parallel-11, B = SS_PAR_B: exactly two K1 launches a step (the
          same widths and counts, lower-triangular slabs with the hard
          rate rows), nothing else; the dense rows are never scattered
          (their size, had they been built, is reported beside the peak
          device memory);
    (iii) ONE nominal frog scenario through ``mpc_step`` for the full
          closed loop, each step repeated LATENCY_REPS times: two K2 and
          two K5a launches a step, 5 and 1 wide.

    Every K1, K2 and K5a launch of each path's first step is held against
    its plain version on its own inputs (``check_kernel``, ``check_dense``,
    ``check_vector``) and timed; step 0 is repeated through the plain
    versions, in float64 and on perturbed inputs (``ss_step0_errors``), and
    so is (iii)'s first step with at least SS_STEER_SHARE of its controls
    off their bounds (step 0 is saturated there); the feasible share of
    (i) / (ii) is held to the plain versions' on the same chained inputs
    less FROG_FEASIBLE_SLACK, (iii)'s to SIM_FEASIBLE_FLOOR. Returns, per
    kernel of these paths, the entries added to the ``kernels`` line."""
    from scp_tpu_torch.ops import ipm_kernel
    from scp_tpu_torch.scenarios import builders
    from scp_tpu_torch.sim import engine

    h = SideSelectionChecks(dev, card, seed)

    entries = {}
    # ---- (i) frog, B = 1024, K2 ----
    t_path = time.perf_counter()
    cfg_f, carry_f, step_f, kept_f, rep_f, ok_f = h.batch_path(
        "i", "frog", SS_FROG_B, "ipm_iterate_dense")
    # two steps in rotated-rectangle mode: the same launches
    cfg_r = cfg_f.replace(obst_as_qcqp=False)
    step_f(carry_f, cfg_r)                                   # warm
    reset_counts()
    c = carry_f
    for i in range(SS_RECT_STEPS):
        c, out = step_f(c, cfg_r)
        finite_outputs(out, f"side-selection path i, rectangle step {i}")
    torch.cuda.synchronize()
    rect_counts = launch_counts()
    rep_f["rectangle_mode"] = {
        "steps": SS_RECT_STEPS,
        "launches_per_step": {k: v / SS_RECT_STEPS
                              for k, v in rect_counts.items()},
        "feasible_share_last": float(out.feasible.float().mean())}
    h.expect_launches("i (rectangle mode)", rect_counts, SS_RECT_STEPS,
                    "ipm_iterate_dense")
    rep_f["times"], rep_f["gmv_times"] = h.times("i", "ipm_iterate_dense",
                                               kept_f)
    rep_f["wall_s"] = time.perf_counter() - t_path
    emit(rep_f)
    h.path_failures("i", rep_f, ok_f)

    # ---- (ii) parallel-11, B = 256, K1 with the hard rate rows ----
    t_path = time.perf_counter()
    _, _, _, kept_p, rep_p, ok_p = h.batch_path(
        "ii", "parallel", SS_PAR_B, "ipm_iterate_struct", n_veh=SS_PAR_VEH)
    a0 = kept_p["ipm_iterate_struct"][0][0]
    P_s, S_s = a0[0].shape[1], a0[2].shape[1]
    ctas = ipm_kernel.resident_ctas_per_sm(P_s, S_s, SS_HP, SS_HP,
                                           SS_PAR_VEH, True)
    # the dense rows [G | slack column] the struct route never builds
    mg = (P_s + S_s) * SS_HP
    dense_bytes = SS_CANDIDATES * SS_PAR_B * mg * (SS_PAR_VEH * SS_HP + 1) * 4
    rep_p.update(k1_resident_ctas_per_sm=ctas,
                 k1_smem_bytes=ipm_kernel.smem_bytes(
                     P_s, S_s, SS_HP, SS_HP, SS_PAR_VEH, True),
                 dense_rows_mib_if_built=dense_bytes / 2 ** 20,
                 times=h.times("ii", "ipm_iterate_struct", kept_p)[0],
                 wall_s=time.perf_counter() - t_path)
    emit(rep_p)
    if ctas < 1:
        fail(f"side-selection path ii: K1 holds {ctas} CTAs an SM")
    if rep_p["dense_row_scatters_per_step"] != 0 \
            or rep_f["dense_row_scatters_per_step"] != 2:
        fail(f"side-selection paths: dense rows scattered "
             f"{rep_p['dense_row_scatters_per_step']} times a step on the "
             f"structured route (none wanted), "
             f"{rep_f['dense_row_scatters_per_step']} on the dense-G route "
             f"(one per QP wanted)")
    h.path_failures("ii", rep_p, ok_p)

    # ---- (iii) one frog scenario, the full closed loop ----
    t_path = time.perf_counter()
    cfg1, data1 = builders.frog(dtype=torch.float32, device=dev)
    cfg1 = ss_config(cfg1)
    n_sim = cfg1.n_sim

    def step1(c):
        return engine.mpc_step(cfg1, data1, c)

    carry1 = engine.init_carry(cfg1, data1)
    _, kept1 = h.first_step_launches(("ipm_iterate_dense", "gmv"), step1,
                                   carry1)
    widths1 = [a[0].shape[0] for a, _ in kept1["ipm_iterate_dense"]]
    if widths1 != [SS_CANDIDATES, 1]:
        fail(f"side-selection path iii: first-step launch widths {widths1}")
    max_err1 = h.kernel_checks("iii", "ipm_iterate_dense", kept1)
    err1, ok1 = h.step_three_ways(cfg1, data1, carry1, engine.mpc_step, True)
    reset_counts()
    lats, feas1, stable1, steer1 = [], [], [], []
    c_i, steer_step = carry1, None
    for i in range(n_sim):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LATENCY_REPS):
            step1(c_i)
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t0) / LATENCY_REPS * 1e3)
        c_next, out = step1(c_i)
        finite_outputs(out, "side-selection path iii")
        feas1.append(float(out.feasible.float().mean()))
        stable1.append(float(out.sides_stable.float().mean()))
        steer1.append(steering_share(cfg1, data1, c_i, out))
        if steer_step is None and steer1[-1] >= SS_STEER_SHARE:
            steer_step = (i, c_i)
        c_i = c_next
    got1 = launch_counts()
    n_calls = n_sim * (LATENCY_REPS + 1)
    if steer_step is None:
        fail(f"side-selection path iii: no step has {SS_STEER_SHARE} of its "
             f"controls steering off their bounds")
    err_steer, ok_steer = h.step_three_ways(cfg1, data1, steer_step[1],
                                        engine.mpc_step, True)
    lats.sort()
    rep1 = {"phase": "side_selection_path_iii", "card": card,
            "scenario": "frog (nominal)", "n_veh": 1, "hp": SS_HP,
            "steps": n_sim,
            "config": "tuned_f32 + TUNED_F32_SIDE_SELECTION",
            "launches_per_step": {k: v / n_calls for k, v in got1.items()},
            "feasible_share": sum(feas1) / n_sim,
            "feasible_floor": SIM_FEASIBLE_FLOOR,
            "sides_stable_share": sum(stable1) / n_sim,
            "latency_reps": LATENCY_REPS,
            "step_latency_ms_p50": lats[len(lats) // 2],
            "step_latency_ms_p90": lats[min(len(lats) - 1,
                                            int(0.90 * len(lats)))],
            "step_latency_ms_max": lats[-1],
            "step_latency_ms_min": lats[0],
            "kernel_vs_plain_max_abs_err": max_err1, "step0": err1,
            "steering_share_step0": steer1[0],
            "steering_share_mean": sum(steer1) / n_sim,
            "steer_step": steer_step[0],
            "steer_step_steering_share": steer1[steer_step[0]],
            "steer_step_errors": err_steer}
    rep1["times"], rep1["gmv_times"] = h.times("iii", "ipm_iterate_dense",
                                             kept1)
    rep1["wall_s"] = time.perf_counter() - t_path
    emit(rep1)
    h.expect_launches("iii", got1, n_calls, "ipm_iterate_dense")
    if not ok1:
        fail(f"side-selection path iii, step 0 off its limits: {err1}")
    if not ok_steer:
        fail(f"side-selection path iii, step {steer_step[0]} (steering, off "
             f"its bounds) off its limits: {err_steer}")
    if rep1["feasible_share"] < SIM_FEASIBLE_FLOOR:
        fail(f"side-selection path iii: feasible share "
             f"{rep1['feasible_share']} below {SIM_FEASIBLE_FLOOR}")
    emit({"phase": "side_selection_first_step_launches", "card": card,
          "launches": h.launch_rows,
          "limits": {"ipm_iterate_dense": DENSE_LIMITS,
                     "ipm_iterate_struct": "the row's own",
                     "gmv": {"vs_f64": "2 x plain float32's + 1e-5 x scale",
                             "first_iter_rel": MATVEC_REL_LIMIT}}})
    reset_counts()

    for k in ("ipm_iterate_struct", "ipm_iterate_dense", "gmv"):
        entries[k] = {"side_selection_launches_per_step": {
            p: r["launches_per_step"][k]
            for p, r in (("i", rep_f), ("ii", rep_p), ("iii", rep1))}}
    entries["ipm_iterate_dense"].update({
        "side_selection_times": {**rep_f["times"], **rep1["times"]},
        "side_selection_max_abs_err": max(rep_f["kernel_vs_plain_max_abs_err"],
                                          max_err1)})
    entries["ipm_iterate_struct"].update({
        "side_selection_times": rep_p["times"],
        "side_selection_max_abs_err": rep_p["kernel_vs_plain_max_abs_err"],
        "side_selection_resident_ctas_per_sm": ctas})
    entries["gmv"].update({
        "side_selection_times": {**rep_f["gmv_times"], **rep1["gmv_times"]},
        "side_selection_max_abs_err": max(
            r["kernel_vs_plain_max_abs"] for r in h.launch_rows
            if r["kernel"].startswith("gmv"))})
    return entries


# ---- path (l): K1 and K2 past one block's shared memory ----
# K1's launches of (l1) and (l2)'s full width and (l4)'s bench-shape inputs,
# which path (m) holds K1's global tier against its twins on; K2's launches
# of (l3) and (l4), which path (o) holds K2's global tier against
M_INPUTS: dict = {}
O_INPUTS: dict = {}
L_HP = 20                  # (l1) side selection at parallel-11, hp = hu = 20
L_STEPS, L_TIMED_STEPS = 3, 1
L_TIME_REPS = 3            # (l1) launches a graph when timing K1
L_LONG_B, L_LONG_HP, L_LONG_STEPS = 256, 64, 2   # (l2), (l3): circle-4
L_DENSE_ITERS = 7          # (l3) K2's fixed iterations
L_V16_B, L_V16_VEH, L_V16_HP, L_V16_STEPS = 256, 16, 10, 2   # (l5)
L_ADAPT_B, L_ADAPT_STEPS = 64, 3                 # (l6): frog, DEFAULT
LINALG_NAMES = ("cholesky", "cho_solve", "gmv", "gtmv")


def tier_of_launch(kernel, a, k):
    """The storage tier (``ipm_kernel.Tier``) a launch of ``kernel`` with
    arguments ``(a, k)`` runs in."""
    from scp_tpu_torch.ops import ipm_kernel as ik
    if kernel == "ipm_iterate_dense":
        B_, mg, n = a[DENSE_G].shape
        pb = a[DENSE_PB]
        nb, d = (0, 0) if pb is None else tuple(pb.shape[1:3])
        return ik.dense_tier(mg, n, nb, d, k["schur_slack"], k["n_cor"],
                             k.get("tier"))
    P, hp, hu = a[0].shape[1:]
    S = 0 if a[2] is None else a[2].shape[1]
    return ik.struct_tier(P, S, hp, hu, a[4].shape[1], k["lower_tri"],
                          k.get("tier"))


def tiers_agree(kernel, args, kw, other="device", reps=10) -> dict:
    """``kernel``'s wrapper in the tier its shape takes and forced into
    tier ``other`` (the device tier, or K1's cluster tier) on identical
    inputs: bit for bit (the same sums in the same order), or else within
    check_kernel's limits on the controls and the one-iteration state; both
    tiers' device times by graph replay (``ms``, ``other_ms``; the device
    tier's also as ``device_tier_ms``)."""
    from scp_tpu_torch.ops import ipm_kernel as ik
    fn = getattr(ik, kernel)
    dev_kw = {**kw, "tier": other}
    a, b = fn(*args, **kw), fn(*args, **dev_kw)
    a1 = fn(*args, **{**kw, "n_iters": 1})
    b1 = fn(*args, **{**dev_kw, "n_iters": 1})
    torch.cuda.synchronize()
    nu = args[DENSE_STATE if kernel == "ipm_iterate_dense" else 7].shape[1] - 1
    du = (a[0][:, :nu] - b[0][:, :nu]).abs().amax(dim=1)
    one = max(float((x - y)[:, :-1].abs().max())
              for x, y in zip(a1[:1] + a1[4:], b1[:1] + b1[4:]))
    rep = {"B": args[0].shape[0], "n_iters": kw["n_iters"],
           "tier": tier_of_launch(kernel, args, kw).tier,
           "bit_identical": all(torch.equal(x, y) for x, y in zip(a, b)),
           "max_abs_diff": max(float((x - y).abs().max())
                               for x, y in zip(a, b)),
           "u_max": float(du.max()), "u_median": float(du.median()),
           "one_iter_max_abs_err": one,
           "other": other,
           "ms": graph_ms(lambda: fn(*args, **kw), reps),
           "other_ms": graph_ms(lambda: fn(*args, **dev_kw), reps)}
    if other == "device":
        rep["device_tier_ms"] = rep["other_ms"]
    rep["within_limits"] = rep["bit_identical"] or (
        rep["u_max"] <= U_ABS_LIMIT and rep["u_median"] <= U_MEDIAN_LIMIT
        and one <= ONE_ITER_LIMIT)
    return rep


def dense_tier_against(case, args, kw, other, e_taken, reps=10) -> dict:
    """K2 in the tier its shape takes against the tier ``other`` forced on
    identical inputs. The forced tier is held to its plain version first
    (``check_dense``: every iteration, the whole launch under the
    yardstick); then the two tiers' whole launches against each other:
    bit for bit, or else the controls' median distance and the freeze
    flags that differ within twice the larger of the two runs'
    allowances against plain (``e_taken``: the taken tier's check_dense
    entry), since each tier may part from plain that far on its own side
    (the cluster tier sums its product in another order). Both tiers'
    device times by graph replay (``ms``, ``other_ms``)."""
    from scp_tpu_torch.ops import ipm_kernel as ik
    fkw = {**kw, "tier": other}
    e_other = check_dense(f"{case}_{other}_tier_forced", args, fkw)
    a, b = ik.ipm_iterate_dense(*args, **kw), ik.ipm_iterate_dense(*args,
                                                                    **fkw)
    torch.cuda.synchronize()
    nu = args[DENSE_G].shape[2] - 1
    du = (a[0][:, :nu] - b[0][:, :nu]).abs().amax(dim=1)
    rep = {"B": args[DENSE_G].shape[0], "n_iters": kw["n_iters"],
           "tier": tier_of_launch("ipm_iterate_dense", args, kw).tier,
           "other": other,
           "bit_identical": all(torch.equal(x, y) for x, y in zip(a, b)),
           "u_max": float(du.max()), "u_median": float(du.median()),
           "frozen_differ": int((a[10][:, 1] != b[10][:, 1]).sum()),
           "u_median_allowed": 2 * max(e_taken["u_median_allowed"],
                                       e_other["u_median_allowed"]),
           "frozen_differ_allowed": 2 * max(
               e_taken["frozen_differ_allowed"],
               e_other["frozen_differ_allowed"]),
           "other_vs_plain_u_max": e_other["u_kernel_vs_plain_max"],
           "ms": graph_ms(lambda: ik.ipm_iterate_dense(*args, **kw), reps),
           "other_ms": graph_ms(lambda: ik.ipm_iterate_dense(*args, **fkw),
                                reps)}
    rep["within_limits"] = rep["bit_identical"] or (
        rep["u_median"] <= rep["u_median_allowed"]
        and rep["frozen_differ"] <= rep["frozen_differ_allowed"])
    return rep


def device_tier_phases(dev, card, seed) -> dict:
    """Path (l): the shapes past one block's shared memory, where K1 and K2
    run in their device tier (the KKT matrix and its factor in device
    memory), each path's launch counts set to 0 just before it and read
    just after:

    (l1) side selection at parallel-11, hp = hu = L_HP, B = SS_PAR_B, the
         calibrated settings (``ss_config``) through ``mpc_step_batch``
         (``SideSelectionChecks.batch_path``): exactly two K1 launches a
         step, both in the device tier (5B wide at 8 iterations, B wide at
         12), every first-step launch against its plain version, step 0
         three ways, the feasible share against the plain versions' less
         FROG_FEASIBLE_SLACK; the workspace and the peak device memory;
    (l2) circle-4, hp = hu = L_LONG_HP, B = L_LONG_B, ``tuned_f32`` with
         ``qp_kkt="dense"`` (TUNED_F32_PHASES): K1 in the device tier at
         nu = 256 on every launch, the first launch of each width against
         its plain version, L_LONG_STEPS chained steps and then through the
         plain version; step 0 against the plain version and float64 under
         run_yardstick, and against path (d)'s banded step (K6 / K7, the
         same batch and carry) under the same yardstick;
    (l3) (l2)'s first full-width QP with its dense rows scattered, through
         ``solve_qp_batched(fixed_iters=L_DENSE_ITERS, kkt="dense")``
         without the pair statement: one K2 launch in the cluster tier (n =
         257), held by check_dense, and against the device tier forced on
         the same inputs (``dense_tier_against``), both timed;
    (l4) each kernel in its shape's tier and forced into the device tier
         on identical inputs (``tiers_agree``): K1 at the bench shape (B =
         BATCH) and K2 at frog's (B = 1024, mg = 440, n = 21); each forced
         into its cluster tier too (K2 under ``dense_tier_against``);
    (l5) circle-16, hp = hu = L_V16_HP, B = L_V16_B, ``tuned_f32`` with
         ``TUNED_F32_V16`` and TUNED_F32_PHASES: K1's shared tier (one CTA
         an SM, its slabs packed; ``kkt="auto"`` took the banded KKT here
         before the route read the packed carve), the first launch of each
         width against its plain version, L_V16_STEPS chained steps and
         their feasible share against the plain version's;
    (l6) the DEFAULT (adaptive) side-selection settings, frog, B =
         L_ADAPT_B: L_ADAPT_STEPS chained steps through the adaptive branch
         (the factor, the solve and both G products), their launches and
         feasible share against the plain versions', step 0 three ways.

    Returns the ``kernels`` line's entries of the two device tiers and the
    additions to K1's, keyed by name."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.config import tree_map
    from scp_tpu_torch.ops import constraints as con, ipm_kernel
    from scp_tpu_torch.scenarios import batch as batch_lib
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.solvers import qp
    from scp_tpu_torch.testing import (DENSE_ARG_ORDER, dense_kernel_inputs,
                                       kernel_inputs, torch_kernel_args)

    h = SideSelectionChecks(dev, card, seed)
    real, plain = h.real, h.plain
    phases = config_lib.TUNED_F32_PHASES

    def require_tier(path, kernel, kept, want):
        tiers = [tier_of_launch(kernel, a, k) for a, k in kept[kernel]]
        if any(t.tier != want for t in tiers):
            fail(f"path {path}: {kernel} launched in tiers "
                 f"{[t.tier for t in tiers]}, {want} wanted")
        return tiers

    def width_checks(path, kernel, kept):
        """The first launch at each width against its plain version
        (check_kernel); returns the largest control difference and the
        launches checked."""
        seen, errs = {}, []
        for a, k in kept[kernel]:
            seen.setdefault(a[0].shape[0], (a, k))
        for w, (a, k) in sorted(seen.items(), reverse=True):
            errs.append(check_kernel(f"{path}_B{w}", a, k, real[kernel],
                                     plain[kernel])["u_kernel_vs_plain_max"])
        return max(errs), seen

    def k1_cell(a, k, reps=10):
        P, hp, hu = a[0].shape[1:]
        S = 0 if a[2] is None else a[2].shape[1]
        V, w = a[4].shape[1], a[0].shape[0]
        cell = {"B": w, "n_iters": k["n_iters"],
                "shape": {"P": P, "S": S, "hp": hp, "hu": hu, "V": V},
                "tier": tier_of_launch("ipm_iterate_struct", a, k)._asdict(),
                "resident_ctas_per_sm": ipm_kernel.resident_ctas_per_sm(
                    P, S, hp, hu, V, k["lower_tri"], k.get("tier")),
                "ms": graph_ms(lambda: real["ipm_iterate_struct"](*a, **k),
                               reps),
                "plain_ms": time_cuda(
                    lambda: plain["ipm_iterate_struct"](*a, **k), 3,
                    warmup=1)}
        cell["bound_ms"], cell["bound_by"] = k1_bound_ms(
            (P, S, hp, hu, V), w, k["n_iters"], k["n_cor"], k["lower_tri"])
        return cell

    # ---- (l1) side selection at parallel-11, hp = 20 ----
    t_path = time.perf_counter()
    _, _, _, kept1, rep1, ok1 = h.batch_path(
        "l1", "parallel", SS_PAR_B, "ipm_iterate_struct", hp=L_HP,
        count_key="ipm_iterate_struct_cluster", steps=L_STEPS,
        timed_steps=L_TIMED_STEPS, n_veh=SS_PAR_VEH)
    tiers1 = require_tier("l1", "ipm_iterate_struct", kept1, "cluster")
    times1 = h.times("l1", "ipm_iterate_struct", kept1, reps=L_TIME_REPS)[0]
    a0 = kept1["ipm_iterate_struct"][0][0]
    P1, S1 = a0[0].shape[1], a0[2].shape[1]
    ctas1, clusters1 = ipm_kernel.cluster_occupancy(P1, S1, L_HP, L_HP,
                                                    SS_PAR_VEH, True)
    # the cluster tier against the device tier forced on the first launch
    # of each width: bit for bit, and both timed in this call
    agree1 = {f"B{a[0].shape[0]}": tiers_agree("ipm_iterate_struct", a, k,
                                               reps=L_TIME_REPS)
              for a, k in kept1["ipm_iterate_struct"]}
    M_INPUTS["l1"] = kept1["ipm_iterate_struct"]
    for w, r in agree1.items():
        times1[f"l1_{w}"]["device_tier_ms"] = r["other_ms"]
    rep1.update(
        phase="device_tier_path_l1", k1_tiers=[t._asdict() for t in tiers1],
        k1_cluster_geometry=ipm_kernel.cluster_geometry(P1, S1, L_HP, L_HP,
                                                        SS_PAR_VEH),
        k1_smem_bytes_whole_carve=ipm_kernel.smem_bytes(
            P1, S1, L_HP, L_HP, SS_PAR_VEH, True),
        k1_resident_ctas_per_sm=ctas1, k1_resident_clusters=clusters1,
        times=times1, cluster_vs_device_tier=agree1,
        wall_s=time.perf_counter() - t_path)
    emit(rep1)
    h.path_failures("l1", rep1, ok1)
    for w, r in agree1.items():
        if not r["bit_identical"]:
            fail(f"path l1, {w}: the cluster tier differs from the device "
                 f"tier on identical inputs: {r}")

    # ---- (l2) circle-4, hp = 64, the dense KKT forced: K1's device tier --
    t_path = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg, data = batch_lib.make_batch("circle", L_LONG_B, generator=gen,
                                     dtype=torch.float32, device=dev,
                                     n_veh=4)
    cfg_b = config_lib.tuned_f32(cfg.replace(hp=L_LONG_HP, hu=L_LONG_HP))
    cfg_d = cfg_b.replace(qp_kkt="dense")
    carry0 = engine.init_carry(cfg_d, data)

    def step2(c, cf=cfg_d, d=data):
        return engine.mpc_step_batch(cf, d, c, phases=phases)

    qp_first: list = []
    real_qp = qp.solve_qp_batched

    def qp_spy(*args, **kw):
        if not qp_first and args[1].shape[0] == L_LONG_B:
            qp_first.append((args, kw))
        return real_qp(*args, **kw)

    qp.solve_qp_batched = qp_spy
    try:
        (_, out_first2), kept2 = h.first_step_launches(
            ("ipm_iterate_struct",), step2, carry0)
    finally:
        qp.solve_qp_batched = real_qp
    if not qp_first:
        fail("path l2 made no full-width QP call")
    tiers2 = require_tier("l2", "ipm_iterate_struct", kept2, "cluster")
    err2, seen2 = width_checks("l2_circle4_hp64_dense", "ipm_iterate_struct",
                               kept2)
    ch2 = chain_vs_plain(step2, carry0, L_LONG_STEPS, ("ipm_iterate_struct",))
    got2 = ch2["counts"]
    outs2 = ch2["outs"]
    for i, out in enumerate(outs2):
        finite_outputs(out, f"path l2 step {i}")
        if out.u_pred.shape != (L_LONG_B, L_LONG_HP, 4):
            fail(f"path l2 step {i}: unexpected output shapes")
    # step 0: the kernels' (outs2[0]) against the plain version's, float64's
    # and, under the same yardstick, path (d)'s banded step (K6 / K7)
    k1_plain = plain_of("ipm_iterate_struct")
    out_p2 = ch2["outs_plain"][0]
    out_d2 = routed(k1_plain, step2, as_f64(carry0), cfg_d, as_f64(data))
    out_b2 = step2(carry0, cfg_b)[1]
    torch.cuda.synchronize()

    def perturbed2(g):
        return routed(k1_plain, step2,
                      tree_map(lambda t: _perturb(t, g), carry0), cfg_d,
                      tree_map(lambda t: _perturb(t, g), data))[1]

    def controls(o):
        return o.u_pred.flatten(1)

    def feasible(o):
        return o.feasible

    y2 = run_yardstick(perturbed2, controls, feasible, out_p2, out_d2[1],
                       "feasible")

    def against(other):
        uk, uo = controls(outs2[0]), controls(other)
        ud = controls(out_d2[1])
        e_ko = (uk - uo).abs().amax(dim=1)
        e_kd = (uk.double() - ud).abs().amax(dim=1)
        return {**y2, "finite": bool(torch.isfinite(uk).all()),
                "feasible_differ": int(
                    (feasible(outs2[0]) != feasible(other)).sum()),
                "u_kernel_vs_plain_median": float(e_ko.median()),
                "u_kernel_vs_plain_p99": _q99(e_ko),
                "u_kernel_vs_plain_max": float(e_ko.max()),
                "u_kernel_vs_f64_p99": _q99(e_kd),
                "u_kernel_vs_f64_max": float(e_kd.max())}
    e_p2, e_b2 = against(out_p2), against(out_b2)
    rep2 = {"phase": "device_tier_path_l2", "card": card, "B": L_LONG_B,
            "n_veh": 4, "hp": L_LONG_HP, "n": 4 * L_LONG_HP + 1,
            "config": "tuned_f32, qp_kkt=dense, TUNED_F32_PHASES",
            "steps": L_LONG_STEPS,
            "launches_per_step": {k: v / L_LONG_STEPS
                                  for k, v in got2.items()},
            "first_step_k1_widths": sorted(seen2, reverse=True),
            "k1_tiers": sorted({tuple(t) for t in tiers2}),
            "chained_step_ms": ch2["chained_step_ms"],
            "peak_device_memory_mib": ch2["peak_mib"],
            **{k: ch2[k] for k in ("feasible_share", "feasible_share_plain",
                                   "feasible_floor")},
            "first_step_repeats": float(
                (out_first2.u_pred - outs2[0].u_pred).abs().max()),
            "kernel_vs_plain_max_abs_err": err2,
            "k1_full_width": k1_cell(*seen2[L_LONG_B], reps=5),
            "cluster_vs_device_tier_full_width": tiers_agree(
                "ipm_iterate_struct", *seen2[L_LONG_B], reps=5),
            "step0_vs_plain": e_p2, "step0_vs_banded_path_d": e_b2,
            "limits": RUN_LIMITS, "wall_s": time.perf_counter() - t_path}
    emit(rep2)
    if got2["ipm_iterate_struct_cluster"] == 0 or any(
            v for k, v in got2.items() if k != "ipm_iterate_struct_cluster"):
        fail(f"path l2: launches {got2}; K1's cluster tier only wanted")
    M_INPUTS["l2"] = seen2[L_LONG_B]
    if not rep2["cluster_vs_device_tier_full_width"]["bit_identical"]:
        fail(f"path l2: the cluster tier differs from the device tier on "
             f"identical inputs: {rep2['cluster_vs_device_tier_full_width']}")
    if run_off_limits(e_p2, "feasible") or run_off_limits(e_b2, "feasible"):
        fail(f"path l2 step 0 off the yardstick: against plain {e_p2}, "
             f"against the banded step {e_b2}")
    if rep2["feasible_share"] < rep2["feasible_floor"]:
        fail(f"path l2: feasible share {rep2['feasible_share']}, floor "
             f"{rep2['feasible_floor']}")

    # ---- (l3) (l2)'s first QP on its dense rows: K2's cluster tier ----
    t_path = time.perf_counter()
    args, kw = qp_first[0]
    gi, gj, gob = kw["g_slabs"]
    pb = kw["p_blocks"]
    rows = con.scatter_slabs(pb.shape[1], gi, gj, gob, pb.dtype)
    G = torch.cat([rows, torch.full((L_LONG_B, rows.shape[1], 1), -1.0,
                                    dtype=pb.dtype, device=dev)], 2)
    h_kw = {**kw, "fixed_iters": L_DENSE_ITERS, "kkt": "dense",
            "banded": None, "g_struct": None, "g_slabs": None,
            "g_slack_mask": None}
    h_args = (args[0], args[1], G.contiguous(), *args[3:])
    reset_counts()
    sol3, kept3 = h.first_step_launches(
        ("ipm_iterate_dense",),
        lambda _: qp.solve_qp_batched(*h_args, **h_kw), None)
    got3 = launch_counts()
    if got3["ipm_iterate_dense_cluster"] != 1 or got3["ipm_iterate_dense"] \
            or got3["ipm_iterate_dense_device"] \
            or len(kept3["ipm_iterate_dense"]) != 1:
        fail(f"path l3: launches {got3}; one K2 launch in the cluster tier "
             f"wanted")
    a3, k3 = kept3["ipm_iterate_dense"][0]
    O_INPUTS["l3"] = (a3, k3)
    tier3 = require_tier("l3", "ipm_iterate_dense", kept3, "cluster")[0]
    e3 = check_dense("l3_hp64_dense_cluster_tier_B256", a3, k3)
    vs3 = dense_tier_against("l3_hp64_dense_B256", a3, k3, "device", e3,
                             reps=5)
    B3, mg3, n3 = a3[DENSE_G].shape
    nb3, d3 = a3[DENSE_PB].shape[1:3]
    occ3 = ipm_kernel.dense_cluster_occupancy(
        mg3, n3, nb3, d3, k3["schur_slack"], k3["n_cor"])
    cell3 = {"B": B3, "mg": mg3, "n": n3, "n_iters": k3["n_iters"],
             "tier": tier3._asdict(),
             "cluster_ctas": ipm_kernel.dense_cluster_geometry(
                 mg3, n3, k3["schur_slack"], k3["n_cor"])[0],
             "resident_ctas_per_sm": occ3[0], "clusters_resident": occ3[1],
             "device_tier_resident_ctas_per_sm":
                 ipm_kernel.dense_resident_ctas_per_sm(
                     mg3, n3, nb3, d3, k3["schur_slack"], k3["n_cor"],
                     ipm_kernel.dense_min_ctas(B3, _sm_count()), "device"),
             "ms": vs3["ms"], "device_tier_ms": vs3["other_ms"],
             "plain_ms": time_cuda(
                 lambda: plain["ipm_iterate_dense"](*a3, **k3), 3, warmup=1)}
    cell3["bound_ms"], cell3["bound_by"] = bound_of(*dense_work(
        B3, mg3, n3, nb3, d3, k3["schur_slack"], k3["n_cor"], k3["n_iters"]))
    cell3["faster_than_device_tier_and_plain"] = \
        cell3["ms"] < min(cell3["device_tier_ms"], cell3["plain_ms"])
    emit({"phase": "device_tier_path_l3", "card": card,
          "launches": got3, "finite": bool(torch.isfinite(sol3.x).all()),
          "converged_share": float(sol3.converged.float().mean()),
          "k2": cell3, "kernel_vs_plain": e3, "vs_device_tier": vs3,
          "wall_s": time.perf_counter() - t_path})
    if not vs3["within_limits"]:
        fail(f"path l3: the cluster tier against the device tier forced on "
             f"the same inputs: {vs3}")

    # ---- (l4) the device tier against the shared one, identical inputs --
    t_path = time.perf_counter()
    arrs, pairs, ov = kernel_inputs(B=BATCH, V=N_VEH, hp=HP, hu=HP, n_obst=0,
                                    seed=seed)
    kw4 = dict(pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6, n_cor=0,
               n_iters=7, lower_tri=True)
    args4 = torch_kernel_args(arrs, device=dev)
    M_INPUTS["bench"] = (args4, kw4)
    t4 = {"k1_bench_shape": tiers_agree("ipm_iterate_struct", args4, kw4),
          "k1_bench_shape_cluster": tiers_agree("ipm_iterate_struct", args4,
                                                kw4, "cluster")}
    t4["k1_bench_shape"]["device_tier_resident_ctas_per_sm"] = \
        ipm_kernel.resident_ctas_per_sm(len(pairs), 0, HP, HP, N_VEH, True,
                                        tier="device")
    darr = dense_kernel_inputs(FROG_B, 440, 1, FROG_HP, seed=seed)
    dargs = [None if darr[k] is None else torch.as_tensor(darr[k],
                                                          device=dev)
             for k in DENSE_ARG_ORDER]
    kw4d = dict(tol=1e-6, reg_rel=3e-6, n_cor=0, n_iters=7, schur_slack=True)
    O_INPUTS["l4"] = (dargs, kw4d)
    t4["k2_frog_shape"] = tiers_agree("ipm_iterate_dense", dargs, kw4d)
    t4["k2_frog_shape_cluster"] = dense_tier_against(
        "l4_k2_frog_shape", dargs, kw4d, "cluster",
        check_dense("l4_k2_frog_shape_shared_tier", dargs, kw4d))
    emit({"phase": "device_tier_path_l4", "card": card, **t4,
          "limits": {"bit_identical": "expected",
                     "else": {"u_abs": U_ABS_LIMIT, "u_median":
                              U_MEDIAN_LIMIT, "one_iter": ONE_ITER_LIMIT}},
          "wall_s": time.perf_counter() - t_path})
    for k, r in t4.items():
        if r["tier"] != "shared" or not r["within_limits"]:
            fail(f"path l4, {k}: the {r['other']} tier against the shared "
                 f"one on identical inputs: {r}")

    # ---- (l5) circle-16, hp = 10: K1's shared tier, slabs packed ----
    t_path = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg5, data5 = batch_lib.make_batch("circle", L_V16_B, generator=gen,
                                       dtype=torch.float32, device=dev,
                                       n_veh=L_V16_VEH)
    cfg5 = config_lib.tuned_f32(cfg5.replace(hp=L_V16_HP, hu=L_V16_HP),
                                **config_lib.TUNED_F32_V16)
    carry5 = engine.init_carry(cfg5, data5)

    def step5(c):
        return engine.mpc_step_batch(cfg5, data5, c, phases=phases)

    (_, out_first5), kept5 = h.first_step_launches(("ipm_iterate_struct",),
                                                   step5, carry5)
    if not kept5["ipm_iterate_struct"]:
        fail("path l5 made no K1 launch (kkt='auto' took another route)")
    require_tier("l5", "ipm_iterate_struct", kept5, "shared")
    err5, seen5 = width_checks("l5_circle16_hp10", "ipm_iterate_struct",
                               kept5)
    ch5 = chain_vs_plain(step5, carry5, L_V16_STEPS, ("ipm_iterate_struct",))
    got5 = ch5["counts"]
    for i, out in enumerate(ch5["outs"]):
        finite_outputs(out, f"path l5 step {i}")
    a5, k5 = kept5["ipm_iterate_struct"][0]
    cell5 = k1_cell(a5, k5)
    rep5 = {"phase": "device_tier_path_l5", "card": card, "B": L_V16_B,
            "n_veh": L_V16_VEH, "hp": L_V16_HP, "n": L_V16_VEH * L_V16_HP + 1,
            "config": "tuned_f32 + TUNED_F32_V16, TUNED_F32_PHASES "
                      "(qp_kkt=auto)",
            "steps": L_V16_STEPS,
            "launches_per_step": {k: v / L_V16_STEPS
                                  for k, v in got5.items()},
            "first_step_k1_widths": sorted(seen5, reverse=True),
            "chained_step_ms": ch5["chained_step_ms"],
            "solves_per_s": L_V16_B / ch5["chained_step_ms"] * 1e3,
            **{k: ch5[k] for k in ("feasible_share", "feasible_share_plain",
                                   "feasible_floor")},
            "first_step_repeats": float(
                (out_first5.u_pred - ch5["outs"][0].u_pred).abs().max()),
            "kernel_vs_plain_max_abs_err": err5, "k1": cell5,
            "wall_s": time.perf_counter() - t_path}
    emit(rep5)
    if got5["ipm_iterate_struct"] == 0 or any(
            v for k, v in got5.items() if k != "ipm_iterate_struct"):
        fail(f"path l5: launches {got5}; K1's shared tier only wanted")
    if cell5["resident_ctas_per_sm"] < 1:
        fail(f"path l5: K1 holds {cell5['resident_ctas_per_sm']} CTAs an SM")
    if rep5["feasible_share"] < rep5["feasible_floor"]:
        fail(f"path l5: feasible share {rep5['feasible_share']}, floor "
             f"{rep5['feasible_floor']}")

    # ---- (l6) the DEFAULT (adaptive) side-selection settings, frog ----
    t_path = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg6, data6 = batch_lib.make_batch("frog", L_ADAPT_B, generator=gen,
                                       dtype=torch.float32, device=dev)
    cfg6 = cfg6.replace(controller="side_selection")
    carry6 = engine.init_carry(cfg6, data6)

    def step6(c):
        return engine.mpc_step_batch(cfg6, data6, c)

    step6(carry6)                                          # warm
    ch6 = chain_vs_plain(step6, carry6, L_ADAPT_STEPS, LINALG_NAMES)
    got6 = ch6["counts"]
    for i, out in enumerate(ch6["outs"]):
        finite_outputs(out, f"path l6 step {i}")
    err6, ok6 = h.step_three_ways(cfg6, data6, carry6, engine.mpc_step_batch,
                                  False, names=LINALG_NAMES)
    rep6 = {"phase": "device_tier_path_l6", "card": card, "B": L_ADAPT_B,
            "scenario": "frog", "hp": cfg6.hp,
            "config": "DEFAULT SCPConfig, controller=side_selection "
                      "(adaptive IPM)",
            "steps": L_ADAPT_STEPS,
            "launches_per_step": {k: v / L_ADAPT_STEPS
                                  for k, v in got6.items()},
            "host_reads_per_step": ch6["host_reads"] / L_ADAPT_STEPS,
            "chained_step_ms": ch6["chained_step_ms"],
            **{k: ch6[k] for k in ("feasible_share", "feasible_share_plain",
                                   "feasible_floor")},
            "sides_stable_share": float(torch.stack(
                [o.sides_stable.float().mean() for o in ch6["outs"]]).mean()),
            "mean_qp_iters": float(torch.stack(
                [o.qp_iters.float().mean() for o in ch6["outs"]]).mean()),
            "step0": err6, "wall_s": time.perf_counter() - t_path}
    emit(rep6)
    if min(got6[k] for k in LINALG_NAMES) == 0 or any(
            v for k, v in got6.items() if k not in LINALG_NAMES):
        fail(f"path l6: launches {got6}; the factor, the solve and both G "
             f"products only wanted")
    h.path_failures("l6", rep6, ok6)
    emit({"phase": "device_tier_first_step_launches", "card": card,
          "launches": h.launch_rows, "limits": "the row's own"})
    reset_counts()

    w1 = f"l1_B{SS_CANDIDATES * SS_PAR_B}"
    per1, per2 = rep1["launches_per_step"], rep2["launches_per_step"]
    k1_cl = {"name": "ipm_iterate_struct_cluster", "route": "cuda",
             "source": "scp_tpu_torch/csrc/ipm_struct.cu",
             "also_source": "scp_tpu_torch/csrc/chol_cluster.cuh",
             "replaces": "scp_tpu/ops/pallas_linalg.py:1195",
             "tier": "cluster",
             "launches": per1["ipm_iterate_struct_cluster"] * L_STEPS
             + per2["ipm_iterate_struct_cluster"] * L_LONG_STEPS,
             "launches_per_step_l1": per1["ipm_iterate_struct_cluster"],
             "launches_per_step_l2": per2["ipm_iterate_struct_cluster"],
             "max_abs_err": max(rep1["kernel_vs_plain_max_abs_err"], err2),
             **{k: times1[w1][k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by")},
             "library_ms": None, "times": times1,
             "times_l2": rep2["k1_full_width"],
             "vs_device_tier_l1": agree1,
             "vs_device_tier_l2": rep2["cluster_vs_device_tier_full_width"],
             "bench_shape_forced": t4["k1_bench_shape_cluster"]}
    # the device tier: off paths (l1) / (l2) since the cluster tier, timed
    # forced on their inputs in this call
    k1_dev = {"name": "ipm_iterate_struct_device", "route": "cuda",
              "source": "scp_tpu_torch/csrc/ipm_struct.cu",
              "replaces": "scp_tpu/ops/pallas_linalg.py:1195",
              "tier": "device", "launches": per1[
                  "ipm_iterate_struct_device"] * L_STEPS
              + per2["ipm_iterate_struct_device"] * L_LONG_STEPS,
              "on_paths": "none since the cluster tier: forced "
                          "(tier='device') on the inputs of (l1) / (l2)",
              "max_abs_err": max(r["max_abs_diff"] for r in agree1.values()),
              "ms": times1[w1]["device_tier_ms"],
              **{k: times1[w1][k] for k in ("plain_ms", "bound_ms",
                                            "bound_by")},
              "library_ms": None,
              "ms_l2": rep2["cluster_vs_device_tier_full_width"]["other_ms"],
              "bench_shape_forced": t4["k1_bench_shape"]}
    k2_cl = {"name": "ipm_iterate_dense_cluster", "route": "cuda",
             "source": "scp_tpu_torch/csrc/ipm_dense.cu",
             "also_source": "scp_tpu_torch/csrc/chol_cluster.cuh, "
                            "scp_tpu_torch/csrc/bulk_copy.cuh",
             "replaces": "scp_tpu/ops/pallas_linalg.py:1107",
             "tier": "cluster",
             "launches": got3["ipm_iterate_dense_cluster"],
             "max_abs_err": e3["u_kernel_vs_plain_max"],
             **{k: cell3[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by")},
             "library_ms": None, "times_l3": cell3,
             "vs_device_tier_l3": vs3,
             "frog_shape_forced": t4["k2_frog_shape_cluster"]}
    # the device tier: off path (l3) since the cluster tier, timed forced
    # on its inputs in this call
    k2_dev = {"name": "ipm_iterate_dense_device", "route": "cuda",
              "source": "scp_tpu_torch/csrc/ipm_dense.cu",
              "replaces": "scp_tpu/ops/pallas_linalg.py:1107",
              "tier": "device",
              "launches": got3["ipm_iterate_dense_device"],
              "on_paths": "none since the cluster tier: forced "
                          "(tier='device') on the inputs of (l3)",
              "max_abs_err": vs3["other_vs_plain_u_max"],
              "ms": cell3["device_tier_ms"],
              **{k: cell3[k] for k in ("plain_ms", "bound_ms", "bound_by")},
              "library_ms": None,
              "frog_shape_forced": t4["k2_frog_shape"]}
    torch.cuda.empty_cache()
    return {"ipm_iterate_struct_cluster": k1_cl,
            "ipm_iterate_struct_device": k1_dev,
            "ipm_iterate_dense_cluster": k2_cl,
            "ipm_iterate_dense_device": k2_dev,
            "ipm_iterate_struct": {"circle16_hp10_l5": cell5,
                                   "launches_per_step_l5": rep5[
                                       "launches_per_step"][
                                           "ipm_iterate_struct"]}}


# ---- path (m): K1's global tier (the step's vectors in device memory) ----
M_HP = 64                  # (m2) side selection at parallel-11, hp = hu = 64
M_B = 64
M_STEPS, M_TIMED_STEPS = 3, 1
M_TIME_REPS = 1            # (m2) launches a graph when timing K1
M_TWIN_REPS = 3            # (m1) ... and when timing the twins
M_V16_B, M_V16_VEH = 4, 16     # (m3) circle-16 at hp = M_HP, the dense KKT


class _FirstLaunch(Exception):
    """Raised by the capture of a step's first K1 launch (path (m3))."""


def global_tier_phases(dev, card, seed) -> dict:
    """Path (m): K1's global tier, past its device tier's own carve (the
    step's vectors and the KKT matrix in a device-memory workspace), each
    path's launch counts set to 0 just before it and read just after:

    (m1) the global tier forced on path (l)'s inputs against its twins on
         the same inputs, bit for bit, both timed: the cluster tier on
         (l1)'s two launches (parallel-11, hp = 20) and the device tier on
         the wide one, the device tier on (l2)'s full width (circle-4,
         hp = 64), and both at the bench shape (path (l4)'s inputs);
    (m2) the calibrated side-selection step at parallel-11, hp = hu =
         M_HP, B = M_B through ``mpc_step_batch``
         (``SideSelectionChecks.batch_path``): exactly two K1 launches a
         step, both in the global tier (5B wide at 8 iterations, B wide at
         12), every first-step launch against its plain version and
         float64, M_STEPS chained steps and then through the plain
         version (the feasible share no worse than its less
         FROG_FEASIBLE_SLACK), step 0 three ways (the flags under the
         yardstick); the peak device memory;
    (m3) circle-16 at hp = hu = M_HP, ``qp_kkt="dense"``, B = M_V16_B: the
         step's first K1 launch (one QP) captured, then against its plain
         version and float64, timed;
    (m4) ``cli run --controller side_selection --scenario parallel --hp
         M_HP --steps 1``: exit 0, K1's global tier launched and no other
         tier of K1 or K2.

    Returns the ``kernels`` line's entry of the global tier."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.ops import ipm_kernel
    from scp_tpu_torch.scenarios import batch as batch_lib
    from scp_tpu_torch.sim import engine

    h = SideSelectionChecks(dev, card, seed)
    real, plain = h.real, h.plain
    k1 = "ipm_iterate_struct"

    def geometry(a):
        P, hp, hu = a[0].shape[1:]
        S = 0 if a[2] is None else a[2].shape[1]
        return ipm_kernel.global_geometry(P, S, hp, hu, a[4].shape[1])

    # ---- (m1) bit for bit against the twins, path (l)'s inputs ----
    t_path = time.perf_counter()
    (a_l1, k_l1), (a_l1n, k_l1n) = M_INPUTS["l1"]
    a_l2, k_l2 = M_INPUTS["l2"]
    a_b, k_b = M_INPUTS["bench"]
    w_l1, w_l1n = a_l1[0].shape[0], a_l1n[0].shape[0]
    cases = {f"l1_B{w_l1}_vs_cluster": (a_l1, k_l1, "cluster"),
             f"l1_B{w_l1n}_vs_cluster": (a_l1n, k_l1n, "cluster"),
             f"l1_B{w_l1}_vs_device": (a_l1, k_l1, "device"),
             f"l2_B{a_l2[0].shape[0]}_vs_device": (a_l2, k_l2, "device"),
             "bench_vs_cluster": (a_b, k_b, "cluster"),
             "bench_vs_device": (a_b, k_b, "device")}
    m1 = {}
    for name, (a, k, other) in cases.items():
        r = tiers_agree(k1, a, {**k, "tier": "global"}, other,
                        reps=M_TWIN_REPS)
        r["global_geometry"] = geometry(a)._asdict()
        m1[name] = r
    M_INPUTS.clear()
    emit({"phase": "global_tier_path_m1", "card": card, **m1,
          "limits": {"bit_identical": "required"},
          "wall_s": time.perf_counter() - t_path})
    for name, r in m1.items():
        if not r["bit_identical"]:
            fail(f"path m1, {name}: the global tier differs from the "
                 f"{r['other']} tier on identical inputs: {r}")
    torch.cuda.empty_cache()

    # ---- (m2) side selection at parallel-11, hp = 64 ----
    t_path = time.perf_counter()
    _, _, _, kept_m, rep_m, ok_m = h.batch_path(
        "m", "parallel", M_B, k1, hp=M_HP,
        count_key="ipm_iterate_struct_global", steps=M_STEPS,
        timed_steps=M_TIMED_STEPS, n_veh=SS_PAR_VEH)
    tiers_m = [tier_of_launch(k1, a, k) for a, k in kept_m[k1]]
    if any(t.tier != "global" for t in tiers_m):
        fail(f"path m: K1 launched in tiers {[t.tier for t in tiers_m]}, "
             f"global wanted")
    times_m = h.times("m", k1, kept_m, reps=M_TIME_REPS)[0]
    a0 = kept_m[k1][0][0]
    P_m, S_m = a0[0].shape[1], a0[2].shape[1]
    shape_m = (P_m, S_m, M_HP, M_HP, SS_PAR_VEH)
    rep_m.update(
        phase="global_tier_path_m2", k1_tiers=[t._asdict() for t in tiers_m],
        k1_global_geometry=ipm_kernel.global_geometry(*shape_m)._asdict(),
        k1_device_tier_carve_bytes=ipm_kernel.smem_bytes(*shape_m, True,
                                                         True),
        k1_resident_ctas_per_sm=ipm_kernel.global_occupancy(*shape_m,
                                                              True),
        k1_slabs_mib_per_candidate_launch=sum(
            t.numel() * 4 for t in a0[:3] if t is not None) / 2 ** 20,
        times=times_m, wall_s=time.perf_counter() - t_path)
    emit(rep_m)
    h.path_failures("m", rep_m, ok_m)
    del kept_m
    torch.cuda.empty_cache()

    # ---- (m3) circle-16, hp = 64, the dense KKT ----
    t_path = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg3, data3 = batch_lib.make_batch("circle", M_V16_B, generator=gen,
                                       dtype=torch.float32, device=dev,
                                       n_veh=M_V16_VEH)
    cfg3 = config_lib.tuned_f32(cfg3.replace(hp=M_HP, hu=M_HP),
                                **config_lib.TUNED_F32_V16
                                ).replace(qp_kkt="dense")
    first: list = []

    def capture(*a, **k):
        first.append((a, k))
        raise _FirstLaunch

    try:
        routed({k1: capture}, engine.mpc_step_batch, cfg3, data3,
               engine.init_carry(cfg3, data3),
               phases=config_lib.TUNED_F32_PHASES)
    except _FirstLaunch:
        pass
    if not first:
        fail("path m3 made no K1 launch")
    a3, k3 = first[0]
    tier3, geo3 = tier_of_launch(k1, a3, k3), geometry(a3)
    if tier3.tier != "global":
        fail(f"path m3: K1 in {tier3}, the global tier wanted")
    reset_counts()
    e3 = check_kernel(f"m3_circle16_hp{M_HP}_dense_B{M_V16_B}", a3, k3,
                      real[k1], plain[k1])
    got3 = launch_counts()
    if not got3["ipm_iterate_struct_global"] or any(
            v for k, v in got3.items() if k != "ipm_iterate_struct_global"):
        fail(f"path m3: launches {got3}; K1's global tier only wanted")
    P3, S3 = a3[0].shape[1], 0 if a3[2] is None else a3[2].shape[1]
    cell3 = {"B": M_V16_B, "n_iters": k3["n_iters"],
             "shape": {"P": P3, "S": S3, "hp": M_HP, "hu": M_HP,
                       "V": M_V16_VEH},
             "tier": tier3._asdict(), "global_geometry": geo3._asdict(),
             "launches_check": got3["ipm_iterate_struct_global"],
             "resident_ctas_per_sm": ipm_kernel.global_occupancy(
                 P3, S3, M_HP, M_HP, M_V16_VEH, k3["lower_tri"]),
             "ms": graph_ms(lambda: real[k1](*a3, **k3), M_TIME_REPS),
             "plain_ms": time_cuda(lambda: plain[k1](*a3, **k3), 2,
                                   warmup=1)}
    cell3["bound_ms"], cell3["bound_by"] = k1_bound_ms(
        (P3, S3, M_HP, M_HP, M_V16_VEH), M_V16_B, k3["n_iters"], k3["n_cor"],
        k3["lower_tri"])
    emit({"phase": "global_tier_path_m3", "card": card, "k1": cell3,
          "kernel_vs_plain": e3, "wall_s": time.perf_counter() - t_path})
    del first, a3
    torch.cuda.empty_cache()

    # ---- (m4) the CLI at hp = 64 ----
    t_path = time.perf_counter()
    argv = ["run", "--controller", "side_selection", "--scenario",
            "parallel", "--hp", str(M_HP), "--steps", "1"]
    r4 = run_cli(argv + (["--cpu"] if dev.type == "cpu" else []))
    got4 = r4["launches"]
    emit({"phase": "global_tier_path_m4", "card": card, **r4,
          "wall_s": time.perf_counter() - t_path})
    others = [k for k, v in got4.items() if v and k.startswith("ipm_")
              and k != "ipm_iterate_struct_global"]
    if r4["exit_code"] or not got4["ipm_iterate_struct_global"] or others:
        fail(f"path m4: cli {' '.join(argv)}: exit {r4['exit_code']}, "
             f"launches {got4}; K1's global tier only wanted")

    per = rep_m["launches_per_step"]
    emit({"phase": "global_tier_summary", "card": card,
          "launches_per_step_m2": per,
          "launches_m3_check": got3["ipm_iterate_struct_global"],
          "launches_m4_cli": got4,
          "peak_device_memory_mib_m2": rep_m["peak_device_memory_mib"],
          "step_peak_above_resident_mib_m2":
              rep_m["step_peak_above_resident_mib"],
          "chained_step_ms_m2": rep_m["chained_step_ms"],
          "feasible_share_m2": rep_m["feasible_share"],
          "feasible_share_plain_m2": rep_m["feasible_share_plain"]})
    w_m = f"m_B{SS_CANDIDATES * M_B}"
    k1_gl = {"name": "ipm_iterate_struct_global", "route": "cuda",
             "source": "scp_tpu_torch/csrc/ipm_struct.cu",
             "also_source": "scp_tpu_torch/csrc/chol_blocked.cuh",
             "replaces": "scp_tpu/ops/pallas_linalg.py:1195",
             "tier": "global",
             "launches": per["ipm_iterate_struct_global"] * M_STEPS,
             "launches_per_step_m2": per["ipm_iterate_struct_global"],
             "max_abs_err": max(rep_m["kernel_vs_plain_max_abs_err"],
                                e3["u_kernel_vs_plain_max"]),
             **{k: times_m[w_m][k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by")},
             "library_ms": None, "times_m2": times_m, "times_m3": cell3,
             "vs_twins_m1": {k: {key: r[key] for key in (
                 "B", "n_iters", "other", "bit_identical", "ms", "other_ms")}
                 for k, r in m1.items()},
             "cli_launches_m4": got4["ipm_iterate_struct_global"]}
    return {"ipm_iterate_struct_global": k1_gl}


# ---- path (n): the banded KKT past 24 vehicles (K6 / K7's device tier) ----
WIDE_CHECKS = ((25, 9, 10), (32, 4, 20), (48, 3, 8))   # (n1) (V, B, K)
WIDE_VEH, WIDE_HP, WIDE_B = 32, 20, 64   # (n2) circle-32 at hp = hu = 20
WIDE_STEPS = 2             # (n2) chained steps after the warm-up
WIDE_TIME_REPS = 3         # (n2) launches a graph when timing K6 / K7
WIDE_CLI_VEH, WIDE_CLI_STEPS, WIDE_CLI_MC = 25, 2, 8   # (n3) cli run


def riccati_yardstick(f_args, s_args, outs_k) -> dict:
    """The plain versions against themselves on inputs perturbed by one
    part in 2^23 (PERTURB_DRAWS draws): for each output of the factor and
    of the solve on its factor (``s_args``' right-hand side), the largest
    distance of a draw (every input perturbed) from the plain version on
    the exact inputs, beside the kernel's (``outs_k``: f, lh, kg and du
    solved on the kernel's factor) and the limit: the kernel within
    WHOLE_MEDIAN_FACTOR x the draws' + 1e-5 of the output's scale."""
    from scp_tpu_torch.ops import riccati
    gen = torch.Generator(device=f_args[0].device).manual_seed(23)
    fp = riccati.riccati_factor_plain(*f_args)
    r = s_args[-1]
    dp = riccati.riccati_solve_plain(*fp, f_args[0], f_args[1], r)
    draws = []
    for _ in range(PERTURB_DRAWS):
        fa = [_perturb(t, gen) for t in f_args]
        fq = riccati.riccati_factor_plain(*fa)
        dq = riccati.riccati_solve_plain(*fq, fa[0], fa[1], _perturb(r, gen))
        draws.append([float((x - y).abs().max()) for x, y in
                      zip((*fq, dq), (*fp, dp))])
    rep = {}
    for i, (name, p_, k) in enumerate(zip(("f", "lh", "kg", "du"),
                                          (*fp, dp), outs_k)):
        yard = max(d[i] for d in draws)
        scale = max(float(p_.abs().max()), 1e-30)
        e = float((k - p_).abs().max())
        rep[name] = {"kernel_vs_plain": e, "perturbed_plain_vs_plain": yard,
                     "ratio": e / max(yard, 1e-30),
                     "limit": WHOLE_MEDIAN_FACTOR * yard + 1e-5 * scale,
                     "within": e <= WHOLE_MEDIAN_FACTOR * yard + 1e-5 * scale}
    return rep


def wide_banded_phases(dev, card, seed) -> dict:
    """Path (n): the banded KKT past 24 vehicles, where K6 / K7 run in their
    device tier (a CTA per instance, the cost-to-go in a device-memory
    workspace), each path's counts set to 0 just before it and read just
    after:

    (n1) the device tier on seeded inputs at V = 25 (B = 9, K = 10), V = 32
         (B = 4, K = 20) and V = 48 (B = 3, K = 8), one and two right-hand
         sides, against the plain versions and the float64 oracle
         (``check_riccati``) and the yardstick of 2^-23-perturbed inputs
         (``riccati_yardstick``); V = 4 forced into the device tier beside
         its shared tier; both workspace instantiations (the small part
         out of shared memory, ``DEVICE_SMEM_BYTES = 0``) at V = 25;
    (n2) the calibrated step at circle-WIDE_VEH, hp = hu = WIDE_HP, B = WIDE_B
         (``tuned_f32``, ``TUNED_F32_PHASES``; ``qp_kkt="auto"`` routes to
         the banded branch): a warm-up step whose first full-width K6 / K7
         launches (the first IPM iteration) and its seventh factor are kept
         and checked against plain and float64, WIDE_STEPS chained steps
         timed, then through the plain versions (the first step against
         the kernels' first, the feasible share the floor less
         FROG_FEASIBLE_SLACK); launches a step by tier (the device tier
         only, two K7 launches a K6 launch, no K1), peak memory, K6 / K7
         timed on the kept inputs beside ``riccati_work``'s bound;
    (n3) ``cli run --scenario circle --n-veh WIDE_CLI_VEH --steps
         WIDE_CLI_STEPS``
         (one scenario: ``"auto"`` is the dense KKT per instance, as in
         ``scp_tpu``; exit 0) and the same with ``--mc WIDE_CLI_MC`` (the
         batched step: exit 0, the device tier launched).

    Returns the ``kernels`` line's entries of the device tier."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.ops import ipm_kernel, riccati_kernel as rk
    from scp_tpu_torch.scenarios import batch as batch_lib
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.testing import riccati_inputs

    ric = ("riccati_factor", "riccati_solve")
    dev_keys = ("riccati_factor_device", "riccati_solve_device")
    real = real_of(*ric)

    # ---- (n1) seeded inputs ----
    t_path = time.perf_counter()
    n1, n1_err = {}, {k: (0.0, 0.0) for k in ric}

    def seeded(B_c, V_c, K_c):
        t = {k: torch.as_tensor(v, device=dev)
             for k, v in riccati_inputs(B_c, V_c, K_c, seed=V_c).items()}
        t["a_blk"] = (0.9 * t["a_blk"]).contiguous()   # stable dynamics
        return t

    for V_c, B_c, K_c in WIDE_CHECKS:
        t = seeded(B_c, V_c, K_c)
        f_args = (t["a_blk"], t["b_blk"], t["hy"], t["hu"])
        reset_counts()
        fac = real["riccati_factor"](*f_args)
        r2 = torch.stack([t["r"], t["r"].flip(1)]).contiguous()
        case = f"n1_V{V_c}_B{B_c}_K{K_c}"
        e_f, e_s = check_riccati(case, f_args, (*fac, t["a_blk"],
                                                t["b_blk"], r2))
        counts = launch_counts()
        du1 = real["riccati_solve"](*fac, t["a_blk"], t["b_blk"], t["r"])
        torch.cuda.synchronize()
        yard = riccati_yardstick(f_args, (*fac, t["a_blk"], t["b_blk"],
                                          t["r"]), (*fac, du1))
        n1[case] = {"launches": {k: counts[k] for k in ric + dev_keys},
                    "factor_err": e_f, "solve_err": e_s, "yardstick": yard,
                    "factor_geometry": rk.factor_device_geometry(
                        V_c)._asdict(),
                    "solve_geometry_two_rhs": rk.solve_device_geometry(
                        V_c, 2)._asdict()}
        for k, e in (("riccati_factor", e_f), ("riccati_solve", e_s)):
            n1_err[k] = max(n1_err[k], e)
        if any(counts[k] for k in ric) or not all(counts[k] for k in
                                                    dev_keys):
            fail(f"path n1, {case}: launches {counts}; the device tier "
                 f"only wanted")
        off = [k for k, v in yard.items() if not v["within"]]
        if off:
            fail(f"path n1, {case}: the device tier is off the perturbation "
                 f"yardstick on {off}: {yard}")
    # V = 4 forced into the device tier, beside its shared tier
    t = seeded(16, 4, 64)
    f_args = (t["a_blk"], t["b_blk"], t["hy"], t["hu"])
    r2 = torch.stack([t["r"], t["r"].flip(1)]).contiguous()
    fac_d = real["riccati_factor"](*f_args, tier="device")
    fac_s = real["riccati_factor"](*f_args)
    du_d = real["riccati_solve"](*fac_s, t["a_blk"], t["b_blk"], r2,
                                 tier="device")
    du_s = real["riccati_solve"](*fac_s, t["a_blk"], t["b_blk"], r2)
    torch.cuda.synchronize()
    scale = {k: _scale(x) for k, x in zip(("f", "lh", "kg", "du"),
                                          (*fac_s, du_s))}
    forced = {k: _scale(x - y) / scale[k] for k, x, y in
              zip(("f", "lh", "kg", "du"), (*fac_d, du_d), (*fac_s, du_s))}
    n1["V4_forced_device_vs_shared_rel"] = forced
    if max(forced.values()) > RICCATI_REL_LIMIT:
        fail(f"path n1: V = 4 in the device tier differs from the shared "
             f"tier by {forced} of scale (limit {RICCATI_REL_LIMIT})")
    # both workspace instantiations (the small part in device memory)
    cap = rk.DEVICE_SMEM_BYTES
    rk.DEVICE_SMEM_BYTES = 0
    try:
        t = seeded(2, 25, 6)
        reset_counts()
        f_args = (t["a_blk"], t["b_blk"], t["hy"], t["hu"])
        fac = real["riccati_factor"](*f_args)
        check_riccati("n1_V25_workspace_instantiations", f_args,
                      (*fac, t["a_blk"], t["b_blk"],
                       torch.stack([t["r"], t["r"].flip(1)]).contiguous()))
        n1["workspace_instantiations"] = {
            "launches": {k: launch_counts()[k] for k in dev_keys},
            "factor_geometry": rk.factor_device_geometry(25)._asdict(),
            "solve_geometry": rk.solve_device_geometry(25, 2)._asdict()}
    finally:
        rk.DEVICE_SMEM_BYTES = cap
    emit({"phase": "wide_banded_path_n1", "card": card, **n1,
          "limits": {"vs_f64": "2 x plain float32's + 1e-5 x scale",
                     "first_iter_rel": RICCATI_REL_LIMIT,
                     "yardstick": f"{WHOLE_MEDIAN_FACTOR} x the perturbed "
                                  f"draws' + 1e-5 x scale"},
          "wall_s": time.perf_counter() - t_path})

    # ---- (n2) the calibrated circle-32 step at hp = 20 ----
    t_path = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg, data = batch_lib.make_batch("circle", WIDE_B, generator=gen,
                                     dtype=torch.float32, device=dev,
                                     n_veh=WIDE_VEH)
    cfg = config_lib.tuned_f32(cfg.replace(hp=WIDE_HP, hu=WIDE_HP))
    carry0 = engine.init_carry(cfg, data)

    def step(c):
        return engine.mpc_step_batch(cfg, data, c,
                                     phases=config_lib.TUNED_F32_PHASES)

    kept: dict[str, list] = {k: [] for k in ric}

    def keep(name):
        def call(*args, **kw):
            if args[0].shape[0] == WIDE_B and len(kept[name]) < 7:
                kept[name].append(args)
            return real[name](*args, **kw)
        return call

    t0 = time.perf_counter()
    routed({k: keep(k) for k in ric}, step, carry0)
    warm_s = time.perf_counter() - t0
    if len(kept["riccati_factor"]) < 7 or not kept["riccati_solve"]:
        fail(f"path n2 made {len(kept['riccati_factor'])} full-width K6 "
             f"calls in its first QP (seven wanted)")
    f_first, s_first = kept["riccati_factor"][0], kept["riccati_solve"][0]
    case = f"n2_circle{WIDE_VEH}_hp{WIDE_HP}"
    e_f, e_s = check_riccati(f"{case}_first_iteration", f_first, s_first)
    e_f7, _ = check_riccati(f"{case}_seventh_factor",
                            kept["riccati_factor"][6], s_first,
                            first_iter=False)
    err = {"riccati_factor": max(e_f, e_f7, n1_err["riccati_factor"]),
           "riccati_solve": max(e_s, n1_err["riccati_solve"])}
    r = chain_vs_plain(step, carry0, WIDE_STEPS, ric)
    counts = r["counts"]
    per = {k: v / WIDE_STEPS for k, v in counts.items() if v}
    for i, out in enumerate(r["outs"]):
        finite_outputs(out, f"path n2 step {i}")
        if out.u_pred.shape != (WIDE_B, WIDE_HP, WIDE_VEH):
            fail(f"path n2 step {i}: u_pred {tuple(out.u_pred.shape)}")
    du = u_pred_diff(r["outs"][0], r["outs_plain"][0])
    V_n, K_n = f_first[0].shape[1], f_first[2].shape[1]
    times = {}
    for k, args, n_rhs in (("riccati_factor", f_first, 1),
                           ("riccati_solve", s_first, 2),
                           ("riccati_solve_one_rhs",
                            solve_args_at(s_first, WIDE_B, rhs=0), 1)):
        fn = real["riccati_factor" if k == "riccati_factor"
                  else "riccati_solve"]
        plain = plain_of(*ric)["riccati_factor" if k == "riccati_factor"
                               else "riccati_solve"]
        bound, by = bound_of(*riccati_work(
            "riccati_factor" if k == "riccati_factor" else "riccati_solve",
            WIDE_B, V_n, K_n, n_rhs))
        times[k] = {"ms": graph_ms(lambda: fn(*args), WIDE_TIME_REPS),
                    "plain_ms": time_cuda(lambda: plain(*args), 2, warmup=1),
                    "bound_ms": bound, "bound_by": by}
    rep = {"phase": "wide_banded_path_n2", "card": card, "B": WIDE_B,
           "n_veh": WIDE_VEH, "hp": WIDE_HP,
           "pairs": WIDE_VEH * (WIDE_VEH - 1) // 2,
           "W": 6 * WIDE_VEH, "K": K_n, "steps": WIDE_STEPS,
           "config": "tuned_f32 (qp_kkt=auto, 7 fixed IPM iterations), "
                     "TUNED_F32_PHASES",
           "warm_up_step_s": warm_s,
           "chained_step_ms": r["chained_step_ms"],
           "solves_per_s": WIDE_B / r["chained_step_ms"] * 1e3,
           "launches_per_step": per, "host_reads_per_step":
               r["host_reads"] / WIDE_STEPS,
           "feasible_share": r["feasible_share"],
           "feasible_share_plain": r["feasible_share_plain"],
           "feasible_floor": r["feasible_floor"],
           "mean_scp_iters": float(torch.stack(
               [o.scp_iters.float().mean() for o in r["outs"]]).mean()),
           "step0_vs_plain_u_pred_median": float(du.median()),
           "step0_vs_plain_u_pred_p99": float(du.quantile(0.99)),
           "step0_vs_plain_u_pred_max_abs": float(du.max()),
           "step0_vs_plain_feasible_agree": float(
               (r["outs"][0].feasible == r["outs_plain"][0].feasible)
               .float().mean()),
           "peak_device_memory_mib": r["peak_mib"],
           "step_peak_above_resident_mib":
               r["step_peak_above_resident_mib"],
           "factor_geometry": rk.factor_device_geometry(V_n)._asdict(),
           "solve_geometry_two_rhs": rk.solve_device_geometry(
               V_n, 2)._asdict(),
           "times": times, "wall_s": time.perf_counter() - t_path}
    emit(rep)
    if any(counts[k] for k in ric) or counts["ipm_iterate_struct"] \
            or any(counts[k] for k in ("ipm_iterate_struct_device",
                                       "ipm_iterate_struct_cluster",
                                       "ipm_iterate_struct_global")):
        fail(f"path n2: launches {counts}; K6 / K7 in the device tier "
             f"only wanted (no K1, no shared-tier sweep)")
    if not counts["riccati_factor_device"] or counts[
            "riccati_solve_device"] != 2 * counts["riccati_factor_device"]:
        fail(f"path n2: {counts['riccati_solve_device']} K7 launches for "
             f"{counts['riccati_factor_device']} K6 launches (two a factor "
             f"wanted)")
    if r["feasible_share"] < r["feasible_floor"]:
        fail(f"path n2: feasible share {r['feasible_share']} below the "
             f"plain versions' less {FROG_FEASIBLE_SLACK} "
             f"({r['feasible_floor']})")
    del kept, r
    torch.cuda.empty_cache()

    # ---- (n3) the CLI past 24 vehicles ----
    t_path = time.perf_counter()
    on_cpu = ["--cpu"] if dev.type == "cpu" else []
    base = ["run", "--scenario", "circle", "--n-veh", str(WIDE_CLI_VEH),
            "--steps", str(WIDE_CLI_STEPS)]
    r_one = run_cli(base + on_cpu)
    r_mc = run_cli(base + ["--mc", str(WIDE_CLI_MC)] + on_cpu)
    emit({"phase": "wide_banded_path_n3", "card": card, "one": r_one,
          "mc": r_mc, "wall_s": time.perf_counter() - t_path})
    if r_one["exit_code"] or r_mc["exit_code"]:
        fail(f"path n3: cli run exit codes {r_one['exit_code']} / "
             f"{r_mc['exit_code']}")
    require_launches(" ".join(r_mc["argv"]), r_mc["launches"],
                     list(dev_keys))
    if any(r_mc["launches"][k] for k in ric):
        fail(f"path n3: cli run --mc launched the shared-tier sweeps: "
             f"{r_mc['launches']}")

    entries = {}
    for k, key, tk in (("riccati_factor", "riccati_factor_device",
                        "riccati_factor"),
                       ("riccati_solve", "riccati_solve_device",
                        "riccati_solve")):
        entries[key] = {
            "name": key, "route": "cuda", "tier": "device",
            "source": "scp_tpu_torch/csrc/riccati.cu",
            "replaces": "scp_tpu/ops/pallas_riccati.py:"
                        + ("247" if k == "riccati_factor" else "307"),
            "launches": counts[key], "launches_per_step_n2": per.get(key, 0),
            "max_abs_err": err[k][0], "max_err_rel_to_scale": err[k][1],
            **{x: times[tk][x] for x in ("ms", "plain_ms", "bound_ms",
                                         "bound_by")},
            "library_ms": None,      # no single PyTorch call computes it
            "times_n2": times if k == "riccati_solve" else times[tk],
            "cli_launches_n3": r_mc["launches"][key]}
    return entries


# ---- path (o): K2's global tier (the step's vectors in device memory) ----
O_HP = 180                 # single-vehicle frog at hp = hu = O_HP
O_B = 64                   # (o2) scenarios: the first round 5 x O_B wide
O_STEPS, O_TIMED_STEPS = 2, 1
O_TIME_REPS = 1            # (o2) launches a graph when timing K2
O_TWIN_REPS = 3            # (o1) ... and when timing the twins
O_TWIN_B = 64              # (o1) side-selection launches cut to this width
# (o1) frog side selection: the device tier's largest horizon and the
# cluster tier's (no Gondzio corrector)
O_DEVICE_HP, O_CLUSTER_HP = 155, 168
O_CLI_MC, O_CLI_STEPS = 8, 2   # (o3)
# the preferred shared-memory carve-outs (percent) the global tier's first
# (o2) launch is timed under
O_CARVEOUTS = {"max_shared": 100, "max_l1": 0}


def dense_global_phases(dev, card, seed) -> dict:
    """Path (o): K2's global tier, past its device tier's own carve (the
    step's vectors and the factor in a device-memory workspace), each
    path's launch counts set to 0 just before it and read just after:

    (o1) the global tier forced beside its twins on identical inputs, both
         timed: bit for bit the device tier at frog hp = 20, B = 1,024
         (path (l4)'s inputs), at (l3)'s first QP (n = 257, B = 256) and on
         the first side-selection launch of a calibrated frog step at
         hp = O_DEVICE_HP (its first O_TWIN_B instances); at hp =
         O_CLUSTER_HP, held to its plain version (``check_dense``) and
         against the cluster tier (the shape's own, which sums its product
         in another order) under ``dense_tier_against``;
    (o2) the calibrated side-selection step at frog, hp = hu = O_HP, B =
         O_B through ``mpc_step_batch`` (``SideSelectionChecks.batch_path``):
         exactly two K2 launches a step, both in the global tier (5B wide
         at 8 iterations, B wide at 12), every first-step launch against
         its plain version and float64, O_STEPS chained steps and then
         through the plain version (the feasible share no worse than its
         less FROG_FEASIBLE_SLACK), step 0 three ways (the flags under the
         yardstick); the first launch timed under each of O_CARVEOUTS;
    (o3) ``cli run --controller side_selection --scenario frog --hp O_HP``
         and ``cli run --scenario frog --hp O_HP --kkt dense --mc
         O_CLI_MC`` (the SCP controller's QP, mg = 3,960), O_CLI_STEPS
         steps each: exit 0, K2's global tier launched and no other tier
         of K1 or K2.

    Returns the ``kernels`` line's entry of the global tier."""
    from scp_tpu_torch.ops import ipm_kernel
    from scp_tpu_torch.scenarios import batch as batch_lib
    from scp_tpu_torch.sim import engine

    h = SideSelectionChecks(dev, card, seed)
    real = h.real
    k2, gl = "ipm_iterate_dense", "ipm_iterate_dense_global"

    def first_ss_launch(hp):
        """The first K2 launch (the candidates) of a calibrated frog
        side-selection step at hp = hu = ``hp``, cut to its first O_TWIN_B
        instances."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        cfg, data = batch_lib.make_batch(
            "frog", -(-O_TWIN_B // SS_CANDIDATES), generator=gen,
            dtype=torch.float32, device=dev)
        cfg = ss_config(cfg, hp)
        first: list = []

        def capture(*a, **k):
            first.append((a, k))
            raise _FirstLaunch

        try:
            routed({k2: capture}, engine.mpc_step_batch, cfg, data,
                   engine.init_carry(cfg, data))
        except _FirstLaunch:
            pass
        if not first:
            fail(f"path o1: no K2 launch at frog hp = {hp}")
        a, k = first[0]
        return [None if t is None else t[:O_TWIN_B].contiguous()
                for t in a], k

    # ---- (o1) the global tier beside its twins, identical inputs ----
    t_path = time.perf_counter()
    a4, k4 = O_INPUTS["l4"]
    a3, k3 = O_INPUTS["l3"]
    a155, k155 = first_ss_launch(O_DEVICE_HP)
    o1 = {}
    for name, (a, k) in {
            f"l4_frog_hp20_B{a4[DENSE_G].shape[0]}": (a4, k4),
            f"l3_n257_B{a3[DENSE_G].shape[0]}": (a3, k3),
            f"frog_side_selection_hp{O_DEVICE_HP}_B{O_TWIN_B}":
                (a155, k155)}.items():
        r = tiers_agree(k2, a, {**k, "tier": "global"}, "device",
                        reps=O_TWIN_REPS)
        r["mg"], r["n"] = a[DENSE_G].shape[1:]
        o1[f"{name}_vs_device"] = r
    O_INPUTS.clear()
    del a155
    a168, k168 = first_ss_launch(O_CLUSTER_HP)
    kg = {**k168, "tier": "global"}
    e168 = check_dense(f"o1_frog_side_selection_hp{O_CLUSTER_HP}_global",
                       a168, kg)
    r = dense_tier_against(f"o1_frog_side_selection_hp{O_CLUSTER_HP}", a168,
                           kg, "cluster", e168, reps=O_TWIN_REPS)
    r["mg"], r["n"] = a168[DENSE_G].shape[1:]
    o1[f"frog_side_selection_hp{O_CLUSTER_HP}_B{O_TWIN_B}_vs_cluster"] = r
    del a168
    emit({"phase": "dense_global_path_o1", "card": card, **o1,
          "limits": {"vs_device": "bit-identical",
                     "vs_cluster": "dense_tier_against's yardstick"},
          "wall_s": time.perf_counter() - t_path})
    for name, r in o1.items():
        if r["tier"] != "global" or not (
                r["bit_identical"] if r["other"] == "device"
                else r["within_limits"]):
            fail(f"path o1, {name}: the global tier against the "
                 f"{r['other']} tier on identical inputs: {r}")
    torch.cuda.empty_cache()

    # ---- (o2) side selection at frog, hp = 180 ----
    t_path = time.perf_counter()
    _, _, _, kept, rep, ok = h.batch_path(
        "o", "frog", O_B, k2, hp=O_HP, count_key=gl, steps=O_STEPS,
        timed_steps=O_TIMED_STEPS)
    tiers = [tier_of_launch(k2, a, k) for a, k in kept[k2]]
    if any(t.tier != "global" for t in tiers):
        fail(f"path o2: K2 launched in tiers {[t.tier for t in tiers]}, "
             f"global wanted")
    times, gmv_times = h.times("o", k2, kept, reps=O_TIME_REPS)
    a0, k0 = kept[k2][0]
    B0, mg0, n0 = a0[DENSE_G].shape
    min_ctas = ipm_kernel.dense_min_ctas(B0, _sm_count())
    chosen = ipm_kernel.DENSE_GLOBAL_CARVEOUT
    carve = {}
    try:
        for name, pct in O_CARVEOUTS.items():
            ipm_kernel.DENSE_GLOBAL_CARVEOUT = pct
            carve[name] = {
                "percent_shared": pct,
                "ms": graph_ms(lambda: real[k2](*a0, **k0), O_TIME_REPS),
                "resident_ctas_per_sm": ipm_kernel.dense_global_occupancy(
                    min_ctas, pct)}
    finally:
        ipm_kernel.DENSE_GLOBAL_CARVEOUT = chosen
    faster = min(carve, key=lambda c: carve[c]["ms"])
    rep.update(
        phase="dense_global_path_o2", k2_tiers=[t._asdict() for t in tiers],
        k2_global_geometry=ipm_kernel.dense_global_geometry(
            mg0, n0, k0["schur_slack"], k0["n_cor"])._asdict(),
        k2_device_tier_carve_bytes=ipm_kernel.dense_smem_bytes(
            mg0, n0, 1, O_HP, k0["schur_slack"], False, k0["n_cor"],
            device=True),
        k2_min_ctas=min_ctas,
        k2_g_mib_first_launch=a0[DENSE_G].numel() * 4 / 2 ** 20,
        k2_workspace_mib_first_launch=B0 * tiers[0].workspace_floats * 4
        / 2 ** 20,
        carveout_first_launch=carve, carveout_chosen_percent=chosen,
        carveout_chosen_is_faster=O_CARVEOUTS[faster] == chosen,
        times=times, gmv_times=gmv_times,
        wall_s=time.perf_counter() - t_path)
    emit(rep)
    h.path_failures("o", rep, ok)
    del kept, a0
    torch.cuda.empty_cache()

    # ---- (o3) the CLI at hp = 180 ----
    t_path = time.perf_counter()
    on_cpu = ["--cpu"] if dev.type == "cpu" else []
    cli = {}
    for name, argv in (
            ("side_selection", ["run", "--controller", "side_selection",
                                "--scenario", "frog", "--hp", str(O_HP),
                                "--steps", str(O_CLI_STEPS)]),
            ("scp_dense_mc", ["run", "--scenario", "frog", "--hp",
                              str(O_HP), "--kkt", "dense", "--mc",
                              str(O_CLI_MC), "--steps", str(O_CLI_STEPS)])):
        r = run_cli(argv + on_cpu)
        cli[name] = r
        others = [k for k, v in r["launches"].items()
                  if v and k.startswith("ipm_") and k != gl]
        if r["exit_code"] or not r["launches"][gl] or others:
            fail(f"path o3: cli {' '.join(argv)}: exit {r['exit_code']}, "
                 f"launches {r['launches']}; K2's global tier only wanted")
    emit({"phase": "dense_global_path_o3", "card": card, **cli,
          "wall_s": time.perf_counter() - t_path})

    per = rep["launches_per_step"]
    w = f"o_B{SS_CANDIDATES * O_B}"
    emit({"phase": "dense_global_summary", "card": card,
          "launches_per_step_o2": per,
          "chained_step_ms_o2": rep["chained_step_ms"],
          "step_ms_o2": rep["step_ms"],
          "peak_device_memory_mib_o2": rep["peak_device_memory_mib"],
          "step_peak_above_resident_mib_o2":
              rep["step_peak_above_resident_mib"],
          "feasible_share_o2": rep["feasible_share"],
          "feasible_share_plain_o2": rep["feasible_share_plain"],
          "carveout_first_launch_ms": {k: v["ms"] for k, v in carve.items()},
          "launches_o3_cli": {k: r["launches"][gl] for k, r in cli.items()}})
    return {gl: {
        "name": gl, "route": "cuda", "tier": "global",
        "source": "scp_tpu_torch/csrc/ipm_dense_global.cu",
        "also_source": "scp_tpu_torch/csrc/ipm_dense.cuh",
        "replaces": "scp_tpu/ops/pallas_linalg.py:1107",
        "launches": per[gl] * O_STEPS, "launches_per_step_o2": per[gl],
        "max_abs_err": rep["kernel_vs_plain_max_abs_err"],
        **{k: times[w][k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by")},
        "library_ms": None,      # no single PyTorch call computes it
        "times_o2": times, "carveout_ms_o2": carve,
        "vs_twins_o1": {k: {key: r[key] for key in (
            "B", "mg", "n", "n_iters", "other", "bit_identical", "ms",
            "other_ms")} for k, r in o1.items()},
        "cli_launches_o3": {k: r["launches"][gl] for k, r in cli.items()}}}


# ---- path (j): the entry points (cli / bench) ----
# Numbers other paths measured in this run, for path (j) to print beside
# its own: path (a)'s solves/s, path (c)'s step latency.
PATH_NUMBERS: dict = {}

J_MC = 64                  # --mc of the Monte-Carlo run (K1)
J_MC_STEPS = 5
J_SS_STEPS = 5             # frog side selection (K2, K5a)
J_BANDED_STEPS = 3         # circle-4, hp = 64, --kkt banded (K6, K7)
J_RUN_STEPS = 0            # the default run: 0 = cfg.n_sim (50)
J_CKPT_B = 64              # checkpoint resume: circle-4, plant noise
J_CKPT_STEPS = (2, 2)      # steps before and after the checkpoint
J_EXPORT_INSTANCE = 3


def run_cli(argv: list[str]) -> dict:
    """``scp_tpu_torch.cli.main(argv)`` with its output captured, every
    count set to 0 just before and read just after; a ``SystemExit`` (the
    parser's refusals) is caught and its code kept."""
    import io

    from scp_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    code, summary = 0, None
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            summary = cli.main(argv)
        except SystemExit as e:
            code = e.code
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"argv": argv, "exit_code": code, "summary": summary,
            "launches": launch_counts(),
            "seconds": round(time.perf_counter() - t0, 3),
            "stderr": err.getvalue()[-400:]}


def require_launches(what: str, counts: dict, kernels) -> None:
    zero = [k for k in kernels if not counts.get(k)]
    if zero:
        fail(f"{what}: no launch of {zero} (counts {counts})")


REFERENCE_JSON_KEYS = (
    "vehiclePathFullRes", "obstaclePathFullRes", "controlPathFullRes",
    "controlPredictions", "trajectoryPredictions", "initial_pos",
    "ReferenceTrajectory", "MPC_delay_compensation_trajectory",
    "evaluations_obj_value", "stepTime", "controllerRuntime")


def check_reference_json(path: str, cfg, n_steps: int, arrays=None) -> dict:
    """The 11 keys of the reference-format export, each of the shape
    ``utils/results.py`` gives it (the transposes of
    ``scp_tpu/utils/results.py:119-135``); with ``arrays`` (the run's
    npz), the predictions equal to them."""
    import numpy as np

    with open(path) as f:
        payload = json.load(f)
    if tuple(sorted(payload)) != tuple(sorted(REFERENCE_JSON_KEYS)):
        fail(f"{path}: keys {sorted(payload)}")
    v, hp, tps = cfg.n_veh, cfg.hp, cfg.ticks_per_sim
    ticks = n_steps * tps
    want = {"vehiclePathFullRes": (6, v, ticks + 1),
            "controlPathFullRes": (v, ticks + 1),
            "controlPredictions": (hp, v, n_steps),
            "trajectoryPredictions": (hp, 2, v, n_steps),
            "initial_pos": (2, v, n_steps),
            "ReferenceTrajectory": (hp, 2, v, n_steps),
            "MPC_delay_compensation_trajectory": (10, 6, v, n_steps),
            "evaluations_obj_value": (n_steps,),
            "stepTime": (n_steps,), "controllerRuntime": (n_steps,)}
    shapes = {k: np.asarray(payload[k]).shape for k in want}
    bad = {k: (shapes[k], w) for k, w in want.items() if shapes[k] != w}
    obst = np.asarray(payload["obstaclePathFullRes"])
    if cfg.n_obst and obst.shape != (cfg.n_obst, 6, cfg.ticks_total + 1):
        bad["obstaclePathFullRes"] = obst.shape
    if not cfg.n_obst and obst.size:
        bad["obstaclePathFullRes"] = obst.shape
    if bad:
        fail(f"{path}: shapes (got, expected) {bad}")
    for k in want:
        if not np.all(np.isfinite(np.asarray(payload[k]))):
            fail(f"{path}: {k} is not finite")
    if arrays is not None and not np.array_equal(
            np.asarray(payload["controlPredictions"]),
            arrays["u_pred"].transpose(1, 2, 0)):
        fail(f"{path}: controlPredictions differ from the npz's u_pred")
    return {"step_time_s_sum": float(np.sum(payload["stepTime"])),
            "step_time_min_s": float(np.min(payload["stepTime"])),
            "controller_runtime_s_sum":
                float(np.sum(payload["controllerRuntime"]))}


def entry_point_phases(dev, card, seed, calibrated) -> dict:
    """Path (j): every kernel reached through the entry points a user
    calls — ``scp_tpu_torch.bench.worker()`` at its own settings and
    ``scp_tpu_torch.cli.main([...])`` — each call's launches counted; the
    CLI's refusals; a checkpoint resume, bit for bit; the determinism of
    one calibrated step. ``calibrated = (cfg, data, carry, phases)`` of
    path (a). Returns ``{kernel name: launches through the entry points}``
    for the ``kernels`` line."""
    import io
    import math
    import shutil
    import tempfile

    import numpy as np

    from scp_tpu_torch import bench
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.scenarios import batch as batch_lib, builders
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.utils import checkpoint, debug, results

    on_cpu = ["--cpu"] if dev.type == "cpu" else []   # CPU rehearsal only
    totals: dict = {}

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    tmp = tempfile.mkdtemp(prefix="chip_smoke_j_")
    try:
        # ---- bench.worker() at its own settings ----
        split: dict = {}
        latency_fn = bench.latency

        def latency_counted(device):
            split["throughput"] = launch_counts()
            reset_counts()
            lats = latency_fn(device)
            split["latency"] = launch_counts()
            return lats

        out, err = io.StringIO(), io.StringIO()
        bench.latency = latency_counted
        reset_counts()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                res = bench.worker(device=dev)
        finally:
            bench.latency = latency_fn
        bench_s = time.perf_counter() - t0
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("{")]
        if len(lines) != 1:
            fail(f"bench.worker printed {len(lines)} JSON lines: "
                 f"{out.getvalue()!r}")
        line = json.loads(lines[0])
        lat_line = [ln for ln in err.getvalue().splitlines()
                    if ln.startswith("# step_latency_ms")]
        add(split["throughput"])
        add(split["latency"])
        emit({"phase": "entry_bench", "card": card,
              "json_line": line, "stderr": err.getvalue().splitlines(),
              "settings": {"BATCH": bench.BATCH, "HP": bench.HP,
                           "ITERS": bench.ITERS, "LSTEPS": bench.LSTEPS,
                           "REPS": bench.REPS},
              "build_s": res["build_s"], "step_ms": res["step_s"] * 1e3,
              "feasible_frac": res["feasible_frac"],
              "latency_ms_p50_p90_max": [res["latency_p50_ms"],
                                         res["latency_p90_ms"],
                                         res["latency_max_ms"]],
              "path_a_solves_per_s": PATH_NUMBERS.get("a_solves_per_s"),
              "path_c_latency_ms_p50_p90_max": PATH_NUMBERS.get("c_latency"),
              "throughput_launches": split["throughput"],
              "latency_launches": split["latency"],
              "seconds": round(bench_s, 2)})
        if line.get("metric") != "scp_solves_per_sec_chip" \
                or line.get("unit") != "solves/s" \
                or not math.isfinite(line.get("value", float("nan"))) \
                or not line["value"] > 0:
            fail(f"bench: bad JSON line {line}")
        if not lat_line:
            fail("bench: no latency line on stderr")
        require_launches("bench throughput", split["throughput"],
                         ["ipm_iterate_struct"])
        require_launches("bench latency", split["latency"],
                         ["cholesky", "cho_solve"])

        # ---- cli run, defaults (circle-8, hp = 10), --out, --export-json
        npz, js = f"{tmp}/run.npz", f"{tmp}/run.json"
        argv = ["run", "--out", npz, "--export-json", js]
        if J_RUN_STEPS:
            argv += ["--steps", str(J_RUN_STEPS)]
        r = run_cli(argv + on_cpu)
        add(r["launches"])
        require_launches("cli run", r["launches"], ["cholesky", "cho_solve"])
        cfg8, _ = builders.circle(8, device="cpu")
        cfg8 = config_lib.tuned_f32(cfg8)
        n8 = J_RUN_STEPS or cfg8.n_sim
        arrays = results.load_npz(npz)
        if arrays["states"].shape != (n8, cfg8.ticks_per_sim, 8, 6) \
                or arrays["u_pred"].shape != (n8, cfg8.hp, 8):
            fail(f"cli run --out: shapes {arrays['states'].shape}, "
                 f"{arrays['u_pred'].shape}")
        j_run = check_reference_json(js, cfg8, n8, arrays)
        if not j_run["step_time_min_s"] > 0:
            fail(f"cli run --export-json: a stepTime is not positive {j_run}")
        feas = r["summary"]["feasible_frac"]
        emit({"phase": "entry_cli_run", **r, "export": j_run,
              "feasible_floor": SIM_FEASIBLE_FLOOR})
        if feas < SIM_FEASIBLE_FLOOR:
            fail(f"cli run: feasible share {feas} below {SIM_FEASIBLE_FLOOR}")

        # ---- --mc 64 --noise, export of one instance (K1) ----
        js_mc = f"{tmp}/mc.json"
        r = run_cli(["run", "--mc", str(J_MC), "--steps", str(J_MC_STEPS),
                     "--noise", "--export-json", js_mc, "--export-instance",
                     str(J_EXPORT_INSTANCE)] + on_cpu)
        add(r["launches"])
        check_reference_json(js_mc, cfg8, J_MC_STEPS)
        emit({"phase": "entry_cli_mc", **r})
        require_launches("cli run --mc", r["launches"], ["ipm_iterate_struct"])

        # ---- frog side selection (K2, K5a) ----
        r = run_cli(["run", "--scenario", "frog", "--controller",
                     "side_selection", "--steps", str(J_SS_STEPS)] + on_cpu)
        add(r["launches"])
        emit({"phase": "entry_cli_side_selection", **r})
        require_launches("cli run --controller side_selection",
                         r["launches"], ["ipm_iterate_dense", "gmv"])

        # ---- --kkt with side selection: the same run as without it ----
        r_k = run_cli(["run", "--scenario", "frog", "--controller",
                       "side_selection", "--kkt", "banded", "--steps",
                       str(J_SS_STEPS)] + on_cpu)
        add(r_k["launches"])
        timeless = ("wall_s", "steps_per_sec")
        same = r_k["launches"] == r["launches"] and all(
            r_k["summary"][k] == v for k, v in r["summary"].items()
            if k not in timeless)
        emit({"phase": "entry_cli_side_selection_kkt", **r_k,
              "same_launches_and_summary_as_without": same})
        if r_k["exit_code"] or not same:
            fail(f"cli run --controller side_selection --kkt banded must run "
                 f"as without --kkt: {r_k} against {r}")

        # ---- circle-4, hp = 64, banded (K6, K7) ----
        r = run_cli(["run", "--n-veh", "4", "--hp", "64", "--kkt", "banded",
                     "--steps", str(J_BANDED_STEPS)] + on_cpu)
        add(r["launches"])
        emit({"phase": "entry_cli_banded", **r})
        require_launches("cli run --hp 64 --kkt banded", r["launches"],
                         ["riccati_factor", "riccati_solve"])

        # ---- the refusal: before any work, no launch ----
        refusals = []
        for argv in (["run", "--f64"],):
            r = run_cli(argv)
            refusals.append(r)
            if r["exit_code"] != 2 or any(r["launches"].values()) \
                    or r["summary"] is not None:
                fail(f"cli {argv} must be refused before any launch: {r}")
        emit({"phase": "entry_cli_refusals", "refusals": refusals})

        # ---- checkpoint resume, bit for bit (plant noise on) ----
        gen = torch.Generator(device=dev).manual_seed(seed + 7)
        cfg_c, data_c = batch_lib.make_batch(
            "circle", J_CKPT_B, generator=gen, dtype=torch.float32,
            device=dev, n_veh=4)
        cfg_c = config_lib.tuned_f32(cfg_c).replace(
            noise_std=config_lib.reference_noise_std(cfg_c))
        phases = config_lib.TUNED_F32_PHASES

        def steps(carry, n):
            for _ in range(n):
                carry, _ = engine.mpc_step_batch(cfg_c, data_c, carry,
                                                 phases=phases)
            return carry

        def fresh(s):
            return engine.init_carry(
                cfg_c, data_c, torch.Generator(device=dev).manual_seed(s))

        n0, n1 = J_CKPT_STEPS
        straight = steps(fresh(seed), n0 + n1)
        first = steps(fresh(seed), n0)
        ck = f"{tmp}/carry.npz"
        checkpoint.save(ck, first, first.step)
        resumed, at = checkpoint.load(ck, fresh(seed + 1000))
        resumed = steps(resumed, n1)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        same = {f: (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b if not isinstance(a, torch.Generator)
                    else torch.equal(a.get_state(), b.get_state()))
                for f, a, b in zip(straight._fields, straight, resumed)}
        ck_rep = {"phase": "entry_checkpoint_resume", "B": J_CKPT_B,
                  "steps": [n0, n1], "saved_at_step": at,
                  "noise_std": cfg_c.noise_std, "bitwise_equal": same,
                  "state_max_abs_diff": float(
                      (straight.state - resumed.state).abs().max()),
                  "tmp_files_left": sorted(
                      p for p in os.listdir(tmp) if ".tmp" in p)}
        emit(ck_rep)
        if not all(same.values()) or ck_rep["tmp_files_left"]:
            fail(f"checkpoint resume is not bitwise the straight run: "
                 f"{ck_rep}")

        # ---- determinism of one calibrated step (B = 1024) ----
        cfg_a, data_a, carry_a, phases_a = calibrated
        dev_j = debug.determinism_check(
            lambda: engine.mpc_step_batch(cfg_a, data_a, carry_a,
                                          phases=phases_a))
        emit({"phase": "entry_determinism", "B": data_a.x0.shape[0],
              "max_abs_deviation": dev_j})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    need = ("ipm_iterate_struct", "ipm_iterate_dense", "cholesky",
            "cho_solve", "gmv", "riccati_factor", "riccati_solve")
    require_launches("path (j)", totals, need)
    emit({"phase": "entry_points", "launches": totals})
    return totals


# ---- path (k): scale-out (the data-parallel sweep, horizon sharding) ----
K_B = 1024                 # (k1), (k2 alpha): the bench shape's batch
K_STEPS = 6                # (k1) sweep steps, checkpoint every K_EVERY
K_EVERY = 3
K_ALPHA_STEPS = 3          # (k2 alpha): 2 ranks, K_B / 2 instances each
K_H_B = 16                 # (k2 beta): circle-4 at hp = hu = K_H_HP
K_H_HP = 64
K_H_STEPS = 3
K_RANKS = 2
K_TIMEOUT_S = 900          # the 2-rank job, killed past this
K_GROUP_TIMEOUT_S = 300.0  # a collective's wait for the other rank
# the shapes the parent hands its (k2) ranks (``<dir>/shapes.json``)
K_SHAPES = ("K_B", "K_ALPHA_STEPS", "K_H_B", "K_H_HP", "K_H_STEPS",
            "K_RANKS", "N_VEH", "HP", "SEED")


def k_sweep_args(dev, steps: int, checkpoint: str = "", every: int = 0):
    """``cli sweep``'s arguments at the bench shape: circle-4, hp = hu = 20,
    ``--batched`` (float32: ``TUNED_F32_PHASES``), the script's seed; and
    the same as an argv."""
    import argparse
    args = argparse.Namespace(
        scenario="circle", batch=K_B, n_veh=N_VEH, steps=steps, hp=HP,
        controller="scp", rect_obstacles=False, n_model=1, batched=True,
        kkt="", checkpoint=checkpoint, checkpoint_every=every, seed=SEED,
        f64=False, cpu=dev.type == "cpu")
    argv = ["sweep", "--batched", "--batch", str(K_B), "--n-veh",
            str(N_VEH), "--hp", str(HP), "--seed", str(SEED), "--steps",
            str(steps)]
    if checkpoint:
        argv += ["--checkpoint", checkpoint, "--checkpoint-every",
                 str(every)]
    return args, argv + (["--cpu"] if dev.type == "cpu" else [])


def k_horizon_inputs(dev):
    """(k2 beta)'s batch: circle-4, hp = hu = K_H_HP, B = K_H_B, float32,
    ``tuned_f32`` (per instance the dense KKT at n = 257)."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.scenarios import batch as batch_lib
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    cfg, data = batch_lib.make_batch("circle", K_H_B, generator=gen,
                                     dtype=torch.float32, device=dev,
                                     n_veh=N_VEH)
    return config_lib.tuned_f32(cfg.replace(hp=K_H_HP, hu=K_H_HP)), data


def k_chain(step, cfg, data, n_steps):
    """``n_steps`` chained steps from a fresh carry: the controls
    (B, steps * hp * V) and the SCP iterations (B, steps)."""
    from scp_tpu_torch.sim import engine
    c, us, its = engine.init_carry(cfg, data), [], []
    for _ in range(n_steps):
        c, out = step(cfg, data, c)
        us.append(out.u_pred.flatten(1))
        its.append(out.scp_iters)
    return torch.cat(us, 1), torch.stack(its, 1)


def carry_fields_equal(a, b) -> dict:
    """Field by field, bit for bit: tensors, generator states, ints."""
    return {f: (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else torch.equal(x.get_state(), y.get_state())
                if isinstance(x, torch.Generator) else x == y)
            for f, x, y in zip(a._fields, a, b)}


def scale_out_worker(out_dir: str, device: str) -> None:
    """One rank of (k2): both ranks on the one card under gloo with CUDA
    tensors (an explicit ``backend="gloo"``: NCCL refuses two ranks on one
    device). (alpha) the ``--batched`` sweep of K_B instances, K_B / 2 a
    rank; (beta) K_H_STEPS chained ``mpc_step_horizon`` steps at hp =
    K_H_HP over a (1, 2) mesh, 32 horizon steps a rank, at the shapes the
    parent wrote to ``<out_dir>/shapes.json``. Writes its blocks,
    summaries and launch counts to ``<out_dir>/rank<r>.pt``."""
    import torch.distributed as dist

    from scp_tpu_torch import cli
    from scp_tpu_torch.ops import _cuda_build
    from scp_tpu_torch.parallel import distributed, mesh as mesh_lib
    from scp_tpu_torch.sim import engine

    with open(os.path.join(out_dir, "shapes.json")) as f:
        globals().update(json.load(f))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        _cuda_build.load_library()
    else:
        torch.set_num_threads(1)
    distributed.initialize(backend="gloo", timeout=K_GROUP_TIMEOUT_S)
    try:
        rank = dist.get_rank()
        res = {}
        args, _ = k_sweep_args(dev, K_ALPHA_STEPS)
        cfg, data, phases = cli.sweep_inputs(args, dev)
        mesh = mesh_lib.make_mesh()
        reset_counts()
        t0 = time.perf_counter()
        carry, summ = distributed.sweep(cfg, data, mesh,
                                        n_steps=K_ALPHA_STEPS, phases=phases)
        sync(dev)
        res["alpha"] = {
            "carry": {k: v.cpu() for k, v in carry._asdict().items()
                      if isinstance(v, torch.Tensor)},
            "offset": carry.noise_offset, "summary": [s.cpu() for s in summ],
            "launches": launch_counts(),
            "seconds": time.perf_counter() - t0}

        mesh_m = mesh_lib.make_mesh(1, K_RANKS)
        cfg_h, data_h = k_horizon_inputs(dev)
        reset_counts()
        t0 = time.perf_counter()
        u, iters = k_chain(
            lambda c, d, k: engine.mpc_step_horizon(
                c, d, k, axis_name=mesh_m.groups["model"], n_shards=K_RANKS),
            cfg_h, data_h, K_H_STEPS)
        sync(dev)
        res["beta"] = {"u": u.cpu(), "scp_iters": iters.cpu(),
                       "launches": launch_counts(),
                       "seconds": time.perf_counter() - t0}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def scale_out_phases(dev, card, backend: str = "nccl") -> dict:
    """Path (k), scale-out, last in the script:

    (k1) the data-parallel sweep under a one-rank process group of
    ``backend`` (NCCL on the card, so the sweep's collectives go through
    it) at the bench shape, ``--batched``: K_STEPS steps checkpointed every
    K_EVERY; a run killed after K_EVERY steps and resumed to K_STEPS, bit
    for bit the uninterrupted one; K1's launches and solves/s beside path
    (a)'s; ``python -m scp_tpu_torch.cli sweep`` of the same flags as a
    subprocess, whose summary must equal the in-process sweep's.

    (k2) K_RANKS ranks on this card under gloo (``scale_out_worker``):
    (alpha) each rank's block bit for bit a one-rank sweep of that block
    (straggler capacity is sized by the block), the reduced summary the
    sum of the blocks'; (beta) the horizon-sharded steps at hp = 64 (the
    large-n factor and solve on both ranks) against the unsharded steps,
    held to the yardstick of 2^-23-perturbed inputs.

    Returns ``{kernel: launches}`` over (k). The process group is
    destroyed before it returns."""
    import datetime
    import shutil
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from scp_tpu_torch import cli
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.config import tree_map
    from scp_tpu_torch.parallel import distributed, mesh as mesh_lib
    from scp_tpu_torch.sim import engine

    totals: dict = {}

    def add(counts):
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n

    tmp = tempfile.mkdtemp(prefix="chip_smoke_k_")
    t_start = time.perf_counter()
    try:
        # ---- (k1): one rank under `backend`, the bench shape ----
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{distributed._free_port()}",
            world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=K_GROUP_TIMEOUT_S))
        try:
            mesh = mesh_lib.make_mesh()
            args, _ = k_sweep_args(dev, K_STEPS)
            cfg, data, phases = cli.sweep_inputs(args, dev)
            if phases != config_lib.TUNED_F32_PHASES:
                fail(f"(k1): --batched gave phases {phases}")
            straight_ck = f"{tmp}/straight.npz"
            reset_counts()
            sync(dev)
            t0 = time.perf_counter()
            straight, summ = distributed.sweep(
                cfg, data, mesh, n_steps=K_STEPS, phases=phases,
                checkpoint_path=straight_ck, checkpoint_every=K_EVERY)
            sync(dev)
            wall = time.perf_counter() - t0
            k1_counts = launch_counts()
            add(k1_counts)
            killed_ck = f"{tmp}/killed.npz"
            distributed.sweep(cfg, data, mesh, n_steps=K_EVERY,
                              phases=phases, checkpoint_path=killed_ck,
                              checkpoint_every=K_EVERY)
            with np.load(killed_ck) as f:
                killed_at = int(f["step"])
            resumed, summ_r = distributed.sweep(
                cfg, data, mesh, n_steps=K_STEPS, phases=phases,
                checkpoint_path=killed_ck, checkpoint_every=K_EVERY)
            sync(dev)
            same = carry_fields_equal(straight, resumed)
            same_summary = all(torch.equal(a[K_EVERY:], b[K_EVERY:])
                               for a, b in zip(summ, summ_r))
            backend_used = dist.get_backend()
            # the same steps again: the sweep without checkpoints (the
            # group's communicators made by now), and the engine's loop
            # alone, so the sweep's own cost is read in this process
            again = {}
            for name, run in (
                    ("sweep_no_checkpoint", lambda: distributed.sweep(
                        cfg, data, mesh, n_steps=K_STEPS, phases=phases)),
                    ("engine_loop", lambda: k_chain(
                        lambda c, d, k: engine.mpc_step_batch(
                            c, d, k, phases=phases), cfg, data, K_STEPS))):
                sync(dev)
                t0 = time.perf_counter()
                run()
                sync(dev)
                again[name] = K_B * K_STEPS / (time.perf_counter() - t0)
        finally:
            dist.destroy_process_group()
        total = K_B * K_STEPS
        in_proc = {"feasible_frac": float(summ[1].double().sum()) / total,
                   "mean_obj": float(summ[0].double().sum()) / total,
                   "mean_scp_iters": float(summ[2].double().sum()) / total}
        # the same sweep through the command line, in its own process
        _, argv = k_sweep_args(dev, K_STEPS, f"{tmp}/cli.npz", K_EVERY)
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "scp_tpu_torch.cli"]
                           + argv, capture_output=True, text=True,
                           timeout=K_TIMEOUT_S,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        cli_s = time.perf_counter() - t0
        if p.returncode != 0:
            fail(f"(k1) cli sweep exited {p.returncode}: {p.stderr[-2000:]}")
        cli_summary = json.loads(p.stdout)
        k1 = {"phase": "scale_out_k1", "card": card, "backend": backend_used,
              "B": K_B, "n_veh": N_VEH, "hp": HP, "steps": K_STEPS,
              "checkpoint_every": K_EVERY, "killed_at_step": killed_at,
              "resume_bitwise": same, "resume_summary_bitwise": same_summary,
              "launches": k1_counts,
              "k1_launches_per_step": k1_counts["ipm_iterate_struct"]
              / K_STEPS,
              "sweep_wall_s": wall, "solves_per_s": total / wall,
              "solves_per_s_again": again,
              "path_a_solves_per_s": PATH_NUMBERS.get("a_solves_per_s"),
              "summary": in_proc, "cli_argv": argv,
              "cli_summary": cli_summary, "cli_seconds": round(cli_s, 2)}
        emit(k1)
        if killed_at != K_EVERY or not all(same.values()) \
                or not same_summary:
            fail(f"(k1) the resumed sweep is not bitwise the uninterrupted "
                 f"one: {k1}")
        require_launches("(k1) sweep", k1_counts, ["ipm_iterate_struct"])
        off = {k: (cli_summary.get(k), v) for k, v in in_proc.items()
               if cli_summary.get(k) != v}
        if off or cli_summary["mesh"] != {"data": 1, "model": 1}:
            fail(f"(k1) cli sweep's summary differs from the in-process "
                 f"sweep's (cli, in-process): {off}, mesh "
                 f"{cli_summary['mesh']}")

        # ---- (k2): K_RANKS ranks on this card under gloo ----
        with open(f"{tmp}/shapes.json", "w") as f:
            json.dump({k: globals()[k] for k in K_SHAPES}, f)
        t0 = time.perf_counter()
        ranks = distributed.launch_local(
            [os.path.abspath(__file__), "--scale-out-worker", tmp,
             str(dev)], K_RANKS, timeout=K_TIMEOUT_S)
        job_s = time.perf_counter() - t0
        for r in ranks:
            if r["returncode"] != 0:
                fail(f"(k2) rank {r['rank']} exited {r['returncode']}: "
                     f"{r['stderr'][-3000:]}")
        res = [torch.load(f"{tmp}/rank{r}.pt") for r in range(K_RANKS)]

        # (alpha) each block against a one-rank sweep of that block
        args, _ = k_sweep_args(dev, K_ALPHA_STEPS)
        cfg, data, phases = cli.sweep_inputs(args, dev)
        alpha_same, block_sums = [], None
        for r, rr in enumerate(res):
            blk = mesh_lib.shard_batch(data, mesh_lib.Mesh(
                {"data": K_RANKS, "model": 1}, data_index=r))
            c, s = distributed.sweep(cfg, blk, mesh_lib.make_mesh(),
                                     n_steps=K_ALPHA_STEPS, phases=phases)
            alpha_same.append({k: torch.equal(v, getattr(c, k).cpu())
                               for k, v in rr["alpha"]["carry"].items()})
            # each field in its own dtype, as the all_reduce adds them
            s = [x.cpu() for x in s]
            block_sums = s if block_sums is None else [
                a + b for a, b in zip(block_sums, s)]
            add(rr["alpha"]["launches"])
        k2a = {"phase": "scale_out_k2_alpha", "card": card,
               "backend": "gloo (CUDA tensors)", "ranks": K_RANKS,
               "B": K_B, "B_per_rank": K_B // K_RANKS,
               "steps": K_ALPHA_STEPS,
               "blocks_bitwise_one_rank_runs": alpha_same,
               "summary_equals_sum_of_blocks": all(
                   torch.equal(x, y) for rr in res
                   for x, y in zip(rr["alpha"]["summary"], block_sums)),
               "launches_per_rank": [rr["alpha"]["launches"] for rr in res],
               "seconds_per_rank": [round(rr["alpha"]["seconds"], 2)
                                    for rr in res]}
        emit(k2a)
        if not all(all(d.values()) for d in alpha_same) \
                or not k2a["summary_equals_sum_of_blocks"]:
            fail(f"(k2 alpha) a rank's block differs from its one-rank run, "
                 f"or the summary from the blocks' sum: {k2a}")
        for r, rr in enumerate(res):
            require_launches(f"(k2 alpha) rank {r}", rr["alpha"]["launches"],
                             ["ipm_iterate_struct"])

        # (beta) horizon-sharded against unsharded, in this run
        cfg_h, data_h = k_horizon_inputs(dev)
        plain = plain_of("cholesky", "cho_solve", "gmv", "gtmv")
        u_s, it_s = res[0]["beta"]["u"].to(dev), res[0]["beta"]["scp_iters"]
        t0 = time.perf_counter()
        u_1, it_1 = k_chain(engine.mpc_step, cfg_h, data_h, K_H_STEPS)
        sync(dev)
        unsharded_s = time.perf_counter() - t0
        u_d, _ = routed(plain, k_chain, engine.mpc_step, cfg_h,
                        as_f64(data_h), K_H_STEPS)
        y = run_yardstick(
            lambda gen: k_chain(engine.mpc_step, cfg_h, tree_map(
                lambda t: _perturb(t, gen), data_h), K_H_STEPS),
            lambda o: o[0], lambda o: o[1].to(dev), (u_1, it_1), (u_d, None),
            "scp_iters")
        e_s1 = (u_s - u_1).abs().amax(dim=1)
        e_sd = (u_s.double() - u_d).abs().amax(dim=1)
        k2b = {"phase": "scale_out_k2_beta", "card": card,
               "backend": "gloo (CUDA tensors)", "mesh": {"data": 1,
                                                          "model": K_RANKS},
               "B": K_H_B, "hp": K_H_HP, "n": N_VEH * K_H_HP + 1,
               "horizon_steps_per_rank": K_H_HP // K_RANKS,
               "steps": K_H_STEPS,
               "ranks_bitwise_equal": all(
                   torch.equal(res[0]["beta"][k], rr["beta"][k])
                   for rr in res[1:] for k in ("u", "scp_iters")),
               "finite": bool(torch.isfinite(u_s).all()),
               "scp_iters_differ": int((it_s.to(dev) != it_1).sum()),
               "u_kernel_vs_plain_median": float(e_s1.median()),
               "u_kernel_vs_plain_p99": _q99(e_s1),
               "u_kernel_vs_plain_max": float(e_s1.max()),
               "u_kernel_vs_f64_p99": _q99(e_sd),
               "u_kernel_vs_f64_max": float(e_sd.max()), **y,
               "note": "kernel = the 2-rank horizon-sharded steps, plain = "
                       "the unsharded steps through the same kernels, f64 "
                       "= the unsharded steps in float64 through the plain "
                       "versions",
               "launches_per_rank": [rr["beta"]["launches"] for rr in res],
               "seconds_per_rank": [round(rr["beta"]["seconds"], 2)
                                    for rr in res],
               "unsharded_seconds": round(unsharded_s, 2),
               "limits": RUN_LIMITS}
        emit(k2b)
        for r, rr in enumerate(res):
            require_launches(f"(k2 beta) rank {r}", rr["beta"]["launches"],
                             ["cholesky_cluster", "cho_solve_staged"])
            # at n = 257 every factor is the cluster kernel's, every solve
            # the staged kernel's
            add({f"{k}_large_n" if k in ("cholesky", "cho_solve") else k: v
                 for k, v in rr["beta"]["launches"].items()})
        if not k2b["ranks_bitwise_equal"] \
                or run_off_limits(k2b, "scp_iters"):
            fail(f"(k2 beta) the sharded steps against the unsharded: {k2b}")
        emit({"phase": "scale_out", "launches": totals,
              "job_seconds": round(job_s, 2),
              "wall_seconds": round(time.perf_counter() - t_start, 2)})
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return totals


def main() -> None:
    B = BATCH

    # ---- phase 1: device ----
    phase_end = {"start": time.perf_counter()}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import scp_tpu_torch
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.config import tree_map
    from scp_tpu_torch.ops import _cuda_build, ipm_kernel
    from scp_tpu_torch.scenarios import batch as batch_lib
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.solvers import scp
    from scp_tpu_torch.testing import kernel_inputs, torch_kernel_args

    dev = torch.device("cuda", 0)
    card = smi_line()
    scp_tpu_torch.assert_full_f32()
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    # ---- phase 2: build ----
    t0 = time.time()
    lib_path = _cuda_build.build_library(verbose=True)
    _cuda_build.load_library()
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "library": lib_path.name,
          "sources": [p.name for p in _cuda_build.sources()]})
    wrappers()                  # read before any wrapper is replaced
    phase_end["device_and_build"] = time.perf_counter()

    # ---- the main path's configuration ----
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg, data = batch_lib.make_batch("circle", B, generator=gen,
                                     dtype=torch.float32, device=dev,
                                     n_veh=N_VEH)
    cfg = config_lib.tuned_f32(cfg.replace(hp=HP, hu=HP))
    PHASES = config_lib.TUNED_F32_PHASES
    carry0 = engine.init_carry(cfg, data)

    def step(carry):
        return engine.mpc_step_batch(cfg, data, carry, phases=PHASES)

    # A first step with a shadow around the wrapper: EVERY launch of the
    # step (every batch width of the phase schedule, every SCP iterate) is
    # held against the plain version and the float64 oracle on its own
    # inputs, and the first launch at each width is kept for the phases
    # below. The step doubles as the warm-up.
    captured: dict[int, tuple] = {}
    shadowed: list[dict] = []
    real_wrapper = ipm_kernel.ipm_iterate_struct
    plain = ipm_kernel.ipm_iterate_struct_plain

    def shadow(*args, **kw):
        captured.setdefault(args[0].shape[0], (args, kw))
        out_k = real_wrapper(*args, **kw)
        shadowed.append(compare(args, kw, out_k, plain))
        return out_k

    ipm_kernel.ipm_iterate_struct = shadow
    try:
        carry1, out1 = step(carry0)
        torch.cuda.synchronize()
    finally:
        ipm_kernel.ipm_iterate_struct = real_wrapper
    widths = sorted(captured, reverse=True)
    if widths[0] != B:
        fail(f"the full-width launch was not captured: {widths}")
    keys = ("B", "u_kernel_vs_plain_max", "u_kernel_vs_plain_median",
            "u_kernel_vs_f64_max", "u_plain_vs_f64_max")
    emit({"phase": "first_step_every_launch_vs_plain", "widths": widths,
          "launches": len(shadowed),
          "u_kernel_vs_plain_max": max(
              r["u_kernel_vs_plain_max"] for r in shadowed),
          "frozen_flags_equal": all(
              r["frozen_kernel"] == r["frozen_plain"] for r in shadowed),
          "limits": {"u_abs": U_ABS_LIMIT, "u_median": U_MEDIAN_LIMIT,
                     "vs_f64": "2 x plain float32's + 1e-4"},
          "per_launch": [[r[k] for k in keys] for r in shadowed],
          "per_launch_keys": keys})
    for i, r in enumerate(shadowed):
        if off_limits(r, U_ABS_LIMIT, U_MEDIAN_LIMIT):
            fail(f"first step, launch {i}: the kernel disagrees with its "
                 f"plain version on the same inputs: {r}")
    args_b, kw_b = captured[B]
    P, hp, hu = args_b[0].shape[1:]
    V = args_b[4].shape[1]
    shape_b = (P, 0, hp, hu, V)

    kernel_report = {
        "name": "ipm_iterate_struct", "route": "cuda",
        "source": "scp_tpu_torch/csrc/ipm_struct.cu",
        "replaces": "scp_tpu/ops/pallas_linalg.py:1195",
        # no single PyTorch call computes this function
        "library_ms": None}

    # ---- phase 3: kernel against its plain version ----
    # (a) the bench shape at every width the main path launches: the inputs
    # of the first SCP iteration at the full width, and those of the first
    # straggler launches at the narrower ones (later, near-active iterates)
    for w in widths:
        check_kernel(f"bench_shape_B{w}", *captured[w], real_wrapper, plain)
    # the largest error of the controls over every launch of the first step
    kernel_report["max_abs_err"] = max(
        r["u_kernel_vs_plain_max"] for r in shadowed)
    # (b) obstacle slabs + hard rows + one Gondzio corrector
    arrs_s, pairs_s, ov_s = kernel_inputs(
        B=256, V=3, hp=6, hu=8, n_obst=2, seed=7, hard_rows=True)
    args_s = torch_kernel_args(arrs_s, device=dev)
    kw_s = dict(pairs=pairs_s, obst_veh=ov_s, tol=1e-6, reg_rel=3e-6,
                n_cor=1, n_iters=7, lower_tri=True)
    # (box +-1 here against +-0.052 at the bench shape: limits scaled)
    check_kernel("obstacles_hard_rows_cor1", args_s, kw_s, real_wrapper,
                 plain, u_abs=20 * U_ABS_LIMIT, u_median=20 * U_MEDIAN_LIMIT)
    # (c) odd sizes: nu = 30 (no multiple of 8 or 32), hp != hu, a
    # missing pair, two correctors, dense slabs (lower_tri flag off)
    arrs_o, pairs_o, ov_o = kernel_inputs(
        B=192, V=3, hp=7, hu=10, n_obst=1, seed=9,
        pairs=((0, 1), (1, 2)))
    kw_o = dict(pairs=pairs_o, obst_veh=ov_o, tol=1e-6, reg_rel=3e-6,
                n_cor=2, n_iters=7, lower_tri=False)
    check_kernel("odd_sizes_missing_pair_cor2",
                 torch_kernel_args(arrs_o, device=dev), kw_o,
                 real_wrapper, plain, u_abs=20 * U_ABS_LIMIT,
                 u_median=20 * U_MEDIAN_LIMIT)
    # (d) an instance whose KKT matrix is not positive definite freezes
    # (state kept, frozen flag set) as in the plain version, and the others
    # go on as there (tests/test_torch_ipm_kernel.py's CPU case, on the card)
    arrs_n, pairs_n, ov_n = kernel_inputs(B=8, V=2, hp=4, hu=4, n_obst=0,
                                          seed=6)
    arrs_n["pb"][3] = 50.0          # off-diagonals far above the diagonal
    arrs_n["pdiag"][3, :-1] = 1.0
    args_n = torch_kernel_args(arrs_n, device=dev)
    kw_n = dict(pairs=pairs_n, obst_veh=ov_n, tol=1e-6, reg_rel=3e-6,
                n_iters=2)
    out_n = real_wrapper(*args_n, **kw_n)
    plain_n = plain(*args_n, **kw_n)
    torch.cuda.synchronize()
    others = [i for i in range(8) if i != 3]
    rep_n = {"phase": "kernel_vs_plain", "case": "not_spd_instance_freezes",
             "finite": all(bool(torch.isfinite(t).all()) for t in out_n),
             "frozen_kernel": float(out_n[10][3, 1]),
             "frozen_plain": float(plain_n[10][3, 1]),
             "state_kept": all(torch.equal(o[3], a[3]) for o, a in
                               zip(out_n[:10], args_n[7:17])),
             "others_u_kernel_vs_plain_max": float(
                 (out_n[0][others] - plain_n[0][others]).abs().max()),
             "others_frozen_equal": torch.equal(out_n[10][others, 1],
                                                plain_n[10][others, 1]),
             "limits": {"others_u": ONE_ITER_LIMIT}}
    emit(rep_n)
    if not (rep_n["finite"] and rep_n["state_kept"]
            and rep_n["frozen_kernel"] == 1.0 == rep_n["frozen_plain"]
            and rep_n["others_frozen_equal"]
            and rep_n["others_u_kernel_vs_plain_max"] <= ONE_ITER_LIMIT):
        fail(f"a KKT matrix that is not positive definite must freeze its "
             f"instance as the plain version does: {rep_n}")
    # a float64 CUDA tensor must be refused, not routed to the plain one
    try:
        real_wrapper(*[a.double() for a in args_s], **kw_s)
    except TypeError:
        pass
    else:
        fail("the wrapper accepted float64 CUDA tensors")

    # ---- phase 4: the main path at full width ----
    ipm_kernel.reset_launch_count()
    scp.reset_host_sync_count()
    carry = carry0
    feas, outs = [], []
    t0 = time.time()
    for _ in range(MAIN_STEPS):
        carry, out = step(carry)
        outs.append(out)
        feas.append(out.feasible.float().mean())
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ipm_kernel.launch_count
    syncs = scp.host_sync_count
    kernel_report["launches"] = launches
    kernel_report["launches_per_step"] = launches / MAIN_STEPS
    for i, out in enumerate(outs):
        for name, val in out._asdict().items():
            if val.is_floating_point() and not torch.isfinite(val).all():
                fail(f"step {i}: output {name} is not finite")
        if out.u_pred.shape != (B, HP, N_VEH) \
                or out.states.shape != (B, cfg.ticks_per_sim, N_VEH, 6):
            fail(f"step {i}: unexpected output shapes")
    feas_share = float(torch.stack(feas).mean())
    if launches < MAIN_STEPS * len(PHASES):
        fail(f"K1 was launched {launches} times in {MAIN_STEPS} steps; "
             f"expected at least one per SCP phase per step")
    if feas_share < FEASIBLE_FLOOR:
        fail(f"feasible share {feas_share} below {FEASIBLE_FLOOR}")

    # the first step again with the wrapper pointed at the plain version
    ipm_kernel.ipm_iterate_struct = ipm_kernel.ipm_iterate_struct_plain
    try:
        _, out_plain = step(carry0)
        torch.cuda.synchronize()
    finally:
        ipm_kernel.ipm_iterate_struct = real_wrapper
    # ... and in float64 (the plain version; the oracle of the whole step)
    data64 = tree_map(
        lambda t: t.double() if t.is_floating_point() else t, data)
    ipm_kernel.ipm_iterate_struct = ipm_kernel.ipm_iterate_struct_plain
    try:
        _, out_f64 = engine.mpc_step_batch(
            cfg, data64, engine.init_carry(cfg, data64), phases=PHASES)
        torch.cuda.synchronize()
    finally:
        ipm_kernel.ipm_iterate_struct = real_wrapper

    def u_diff(a, b):
        return (a.u_pred.double() - b.u_pred.double()).abs().amax(dim=(1, 2))

    du = u_diff(outs[0], out_plain)
    du_k64, du_p64 = u_diff(outs[0], out_f64), u_diff(out_plain, out_f64)
    du_max, du_med = float(du.max()), float(du.median())
    du_p99 = float(du.quantile(0.99))
    excess = du_k64 - (2 * du_p64 + UPRED_ABS_LIMIT)
    n_beyond = int((excess > 0).sum())
    same = outs[0].scp_iters == out_plain.scp_iters
    agree = float((outs[0].feasible == out_plain.feasible).float().mean())
    worst = torch.argsort(du, descending=True)[:8]
    emit({"phase": "main_path", "B": B, "n_veh": N_VEH, "hp": HP,
          "steps": MAIN_STEPS, "feasible_share": feas_share,
          "feasible_floor": FEASIBLE_FLOOR,
          "k1_launches": launches,
          "k1_launches_per_step": launches / MAIN_STEPS,
          "host_syncs_per_step": syncs / MAIN_STEPS,
          "mean_scp_iters": float(torch.stack(
              [o.scp_iters.float().mean() for o in outs]).mean()),
          "step_vs_plain_u_pred_max_abs": du_max,
          "step_vs_plain_u_pred_p99": du_p99,
          "step_vs_plain_u_pred_median": du_med,
          "step_vs_plain_same_scp_iters": int(same.sum()),
          "step_vs_f64_u_pred_max_abs": float(du_k64.max()),
          "step_vs_f64_u_pred_p99": float(du_k64.quantile(0.99)),
          "plain_step_vs_f64_u_pred_max_abs": float(du_p64.max()),
          "plain_step_vs_f64_u_pred_p99": float(du_p64.quantile(0.99)),
          "instances_beyond_2x_plain_vs_f64_plus_limit": n_beyond,
          "largest_excess_over_that_limit": float(excess.max()),
          # [kernel vs plain, kernel vs f64, plain vs f64, SCP iterations of
          #  the kernel step and of the plain step]
          "step_vs_plain_worst": [
              [float(du[i]), float(du_k64[i]), float(du_p64[i]),
               int(outs[0].scp_iters[i]), int(out_plain.scp_iters[i])]
              for i in worst.tolist()],
          "step_vs_plain_feasible_agree": agree,
          "u_pred_limit": UPRED_ABS_LIMIT,
          "u_pred_median_limit": UPRED_MEDIAN_LIMIT,
          "wall_s_incl_first_calls": round(wall, 3)})
    if du_med > UPRED_MEDIAN_LIMIT or du_p99 > UPRED_ABS_LIMIT or n_beyond:
        fail(f"first step, kernel vs plain: u_pred median {du_med} (limit "
             f"{UPRED_MEDIAN_LIMIT}), 99th percentile {du_p99} (limit "
             f"{UPRED_ABS_LIMIT}), {n_beyond} instances further from the "
             f"float64 step than 2 x the plain step + {UPRED_ABS_LIMIT}")

    # ---- phase 5: times ----
    carry = carry1
    for _ in range(2):
        carry, _ = step(carry)
    torch.cuda.synchronize()
    n_timed = TIMED_STEPS
    ipm_kernel.reset_launch_count()
    scp.reset_host_sync_count()
    t0 = time.time()
    for _ in range(n_timed):
        carry, _ = step(carry)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / n_timed * 1e3
    times = {"phase": "times", "card": card, "B": B,
             "step_ms": step_ms, "solves_per_s": B / step_ms * 1e3,
             "k1_launches_per_step": ipm_kernel.launch_count / n_timed,
             "host_syncs_per_step": scp.host_sync_count / n_timed,
             "k1": {}}
    # ms: device time per call by CUDA-graph replay; call_ms: CUDA events
    # around back-to-back wrapper calls (what a caller pays per call)
    ctas = ipm_kernel.resident_ctas_per_sm(*shape_b, kw_b["lower_tri"])
    times["k1_resident_ctas_per_sm"] = ctas
    for w in widths:
        args_w, kw_w = captured[w]
        ms = graph_ms(lambda: real_wrapper(*args_w, **kw_w), reps=10)
        call_ms = time_cuda(lambda: real_wrapper(*args_w, **kw_w), reps=20)
        plain_ms = time_cuda(lambda: plain(*args_w, **kw_w), reps=3, warmup=1)
        bound, by = k1_bound_ms(shape_b, w, kw_w["n_iters"], kw_w["n_cor"],
                                kw_w["lower_tri"])
        times["k1"][str(w)] = {"ms": ms, "ms_per_iteration":
                               ms / kw_w["n_iters"], "call_ms": call_ms,
                               "plain_ms": plain_ms, "bound_ms": bound,
                               "bound_by": by, "resident_ctas_per_sm": ctas}
        if w == B:
            kernel_report.update(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                                 bound_ms=bound, bound_by=by,
                                 resident_ctas_per_sm=ctas)
    ipm_kernel.reset_launch_count()
    PATH_NUMBERS["a_solves_per_s"] = times["solves_per_s"]
    emit(times)

    phase_end["main_path"] = time.perf_counter()

    # ---- phases 6-10: the Cholesky, solve and matvec kernels ----
    linalg_reports = linalg_phases(dev, card, B, N_VEH, HP, SEED)
    phase_end["linalg_adaptive_per_instance"] = time.perf_counter()

    # ---- phases 11-15: the Riccati sweeps and the dense-G iteration ----
    new_reports = long_horizon_and_dense_phases(dev, card, SEED)
    phase_end["riccati_dense_fused_hp64"] = time.perf_counter()

    # ---- paths (i)-(iii): the side-selection controller ----
    ss_entries = side_selection_phases(dev, card, SEED)
    phase_end["side_selection"] = time.perf_counter()

    # ---- path (l): K1 and K2 past one block's shared memory ----
    tier_entries = device_tier_phases(dev, card, SEED)
    phase_end["device_tiers"] = time.perf_counter()

    # ---- path (m): K1's global tier, parallel-11 side selection at hp = 64
    global_entries = global_tier_phases(dev, card, SEED)
    phase_end["global_tier"] = time.perf_counter()

    # ---- path (n): K6 / K7's device tier, circle-32 at hp = 20 ----
    wide_entries = wide_banded_phases(dev, card, SEED)
    phase_end["wide_banded"] = time.perf_counter()

    # ---- path (o): K2's global tier, frog at hp = 180 ----
    dense_global_entries = dense_global_phases(dev, card, SEED)
    phase_end["dense_global_tier"] = time.perf_counter()

    # ---- path (j): the entry points, cli and bench ----
    entry_counts = entry_point_phases(dev, card, SEED,
                                      (cfg, data, carry0, PHASES))
    phase_end["entry_points"] = time.perf_counter()

    # ---- path (k): scale-out, the sweep under NCCL and 2 ranks on gloo ----
    scale_counts = scale_out_phases(dev, card)
    phase_end["scale_out"] = time.perf_counter()
    marks = list(phase_end.items())
    emit({"phase": "wall_seconds", **{
        k: round(t - marks[i][1], 2) for i, (k, t) in enumerate(marks[1:])},
        "total": round(marks[-1][1] - marks[0][1], 2)})

    reports = [kernel_report] + linalg_reports + new_reports + [
        tier_entries.pop(k) for k in ("ipm_iterate_struct_cluster",
                                      "ipm_iterate_struct_device",
                                      "ipm_iterate_dense_cluster",
                                      "ipm_iterate_dense_device")] + [
        global_entries["ipm_iterate_struct_global"],
        dense_global_entries["ipm_iterate_dense_global"],
        wide_entries["riccati_factor_device"],
        wide_entries["riccati_solve_device"]]
    for r in reports:
        r.update(ss_entries.get(r["name"], {}))
        r.update(tier_entries.get(r["name"], {}))
        if r["name"] in entry_counts:
            r["entry_points_launches"] = entry_counts[r["name"]]
        if r["name"] in scale_counts:
            r["scale_out_launches"] = scale_counts[r["name"]]
    emit({"kernels": reports})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--scale-out-worker"]:
        scale_out_worker(*sys.argv[2:4])
    else:
        main()
