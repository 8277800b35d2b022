#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``scp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``scp_tpu_torch/csrc`` (the
fused structured IPM iteration K1, the dense-G IPM iteration K2, the
batched Cholesky and the Cholesky solve — in shared memory below n = 240,
with the matrix in device memory from there — the two G matvecs, and the
Riccati factor and solve sweeps K6 / K7), holds each against its plain
PyTorch version on the card, and drives eight paths of the port at full
width, every kernel's launch count set to 0 just before a path and read
just after:

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
  per K6 launch), 10 steps of latency, step 0 repeated through the plain
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
  and the solve at n = 257, B = 1, past the shared-memory kernels; no
  Riccati sweep, no K1), 10 steps of latency, step 0 through the plain
  versions and in float64, and against the banded one-scenario step's
  step 0 (the same QPs through the banded KKT);
* (h) one QP of the adaptive dense branch at hp = 64, B = 256 — the
  long-horizon path's first QP through ``solve_qp_batched(fixed_iters=None,
  kkt="dense")`` with the DEFAULT adaptive settings (the factor, the solve
  and both G products at n = 257, mg = 384), against the plain versions
  and float64.

The fused IPM kernel is also held against its plain version on an
instance whose KKT matrix is not positive definite (it must freeze, its
state kept, as there). The Cholesky, solve and G-product kernels are also
held at their edges: the factor and the solve at n = 1, 15, 16, 17, 32, 33,
81, 239 and B = 1, 3, 1023 (across their 16-column panels and blocks) with
an indefinite instance (a NaN factor) among good ones, and past the
shared-memory kernels at n = 240, 257, 330, 400 and B = 1, 256, 1024 (1024
up to n = 257) with an indefinite instance among good ones at n = 257; both
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

import json
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

    # past the shared-memory kernels (n >= 240: the matrix in device
    # memory), B = 1 / 256 / 1024 (1024 up to the hp = 64 shape's n = 257)
    for n in LARGE_NS:
        for b in (1, 256, 1024):
            if b == 1024 and n > 257:
                continue
            check_factor(f"large_n{n}_B{b}", spd(b, n), real["cholesky"],
                         plain["cholesky"], True)
            L = plain["cholesky"](spd(b, n)).contiguous()
            rhs = torch.randn((b, n), generator=gen, device=dev)
            check_vector("cho_solve", f"large_n{n}_B{b}", real["cho_solve"],
                         plain["cho_solve"], (L, rhs), FIRST_ITER_REL_LIMIT)
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

    def reset_counts():
        ipm_kernel.reset_launch_count()
        lk.reset_launch_counts()
        scp.reset_host_sync_count()
        qp.reset_host_sync_count()

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
LATENCY64_STEPS = 10
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
#    absolute) and the controls within twice the plain version's distance
#    from float64 + 1e-4; from every later iterate, where two float32
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
    one_rel = [e / max(1.0, _scale(b[:, :-1])) for e, (_, b) in
               zip(one_abs, pairs)]
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
    return {**rep, **run_yardstick(
        lambda gen: ik.ipm_iterate_dense_plain(
            *[_perturb(a, gen) for a in args[:-1]], args[-1], **kw),
        lambda out: out[0][:, :nu], lambda out: out[10][:, 1], out_p, out_d,
        "frozen")}


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
        "cold_start": {"one_iter_rel": ONE_ITER_LIMIT,
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
    return e["first_iteration"] and (
        e["one_iter_max_rel_err"] > ONE_ITER_LIMIT
        or e["u_kernel_vs_f64_max"] > 2 * e["u_plain_vs_f64_max"] + 1e-4)


def _sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def check_dense(case, args, kw) -> float:
    """K2 against its plain version from a QP's cold start: the launch and
    each of its iterations (:func:`dense_launch_errors`). Returns the
    launch's largest difference on a state entry."""
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
    return reps[0]["one_iter_max_abs_err"]


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
    from scp_tpu_torch.ops import constraints as con, ipm_kernel, linalg
    from scp_tpu_torch.ops import linalg_kernel as lk, riccati_kernel as rk
    from scp_tpu_torch.scenarios import builders
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.solvers import qp

    names = ("cholesky", "cho_solve", "gmv", "gtmv")
    real = {k: getattr(lk, k) for k in names}
    plain = {"cholesky": linalg.cholesky_plain,
             "cho_solve": linalg.cho_solve_plain,
             "gmv": linalg.gmv_plain, "gtmv": linalg.gtmv_plain}
    library = {
        "cholesky": lambda K: torch.linalg.cholesky_ex(K)[0],
        "cho_solve": lambda L, b: torch.cholesky_solve(b[:, :, None], L)}

    def routed(fns, fn, *args, **kw):
        """Run ``fn`` with the four wrappers pointed at ``fns``."""
        for k in names:
            setattr(lk, k, fns.get(k, real[k]))
        try:
            out = fn(*args, **kw)
            torch.cuda.synchronize()
        finally:
            for k in names:
                setattr(lk, k, real[k])
        return out

    def reset_counts():
        lk.reset_launch_counts()
        rk.reset_launch_counts()
        ipm_kernel.reset_launch_count()

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
                     "also_replaces": "scp_tpu/ops/pallas_linalg.py:305"},
        "cho_solve": {"name": "cho_solve_large_n", "replaces":
                      "scp_tpu/ops/pallas_linalg.py:241",
                      "also_replaces": "scp_tpu/ops/pallas_linalg.py:340"}}
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
             "launches_per_step": {k: counts[k] / calls for k in names},
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
    if min(step0_counts["cholesky"], step0_counts["cho_solve"],
           counts["cholesky"], counts["cho_solve"]) == 0:
        fail(f"path (g) did not launch the factor and the solve: "
             f"{step0_counts}, {counts}")
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
    for k in ("cholesky", "cho_solve"):
        reports[k]["launches"] = counts[k]
        reports[k]["launches_per_step_path_g"] = counts[k] / calls
    reports["cholesky"]["max_abs_err"] = rep_f["kernel_vs_plain_max_abs"]
    reports["cho_solve"]["max_abs_err"] = rep_s["kernel_vs_plain_max_abs"]

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
    if min(h_counts.values()) == 0:
        fail(f"path (h) did not launch every kernel: {h_counts}")
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
    for k in ("cholesky", "cho_solve"):
        cells = {w: large_n_times(k, a, real[k], plain[k], library[k], n)
                 for w, a in (("256", first[k]), ("1", g_args[k]))}
        times["cells"][k] = cells
        reports[k].update({key: cells["256"].get(key) for key in (
            "ms", "cold_ms", "plain_ms", "library_ms", "library_cold_ms",
            "bound_ms", "bound_by")})
        reports[k]["B"], reports[k]["n"] = B, n
        reports[k]["ms_B1"] = cells["1"]["ms"]
    # the bounds of every large-n case timed by scripts/torch_kernel_check.py
    # --times k3k4large (n = 240 / 257 / 400 at B = 1024 / 256 / 1)
    times["bounds_ms"] = {f"{k}_n{nn}_B{w}": linalg_bound_ms(k, w, nn)
                          for k in ("cholesky", "cho_solve")
                          for nn in (240, 257, 400) for w in (1024, 256, 1)}
    times["bounds_ms"]["gtmv_m384_n257_B256"] = linalg_bound_ms(
        "gtmv", B, n, G.shape[1])
    emit(times)
    reset_counts()
    return [reports["cholesky"], reports["cho_solve"]]


def long_horizon_and_dense_phases(dev, card, seed) -> list[dict]:
    """Everything about the Riccati sweeps (K6, K7) and the dense-G iteration
    (K2): the long-horizon path (circle-4, hp = 64, B = 256, K6 / K7 with no
    K1 launch), the one-scenario banded step at hp = 64, the dense-fused
    path (frog, B = 1024, K2), the kernels against their plain versions on
    inputs captured there and on odd shapes, and their times. Returns their
    entries of the ``kernels`` line."""
    import numpy as np

    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.config import tree_map
    from scp_tpu_torch.ops import ipm_kernel, linalg, riccati
    from scp_tpu_torch.ops import linalg_kernel as lk, riccati_kernel as rk
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
    real = {"riccati_factor": rk.riccati_factor,
            "riccati_solve": rk.riccati_solve,
            "ipm_iterate_dense": ipm_kernel.ipm_iterate_dense,
            "gmv": lk.gmv, "gtmv": lk.gtmv}
    plain = {"riccati_factor":
             lambda *a: tuple(riccati.riccati_factor_plain(*a)),
             "riccati_solve": riccati.riccati_solve_plain,
             "ipm_iterate_dense": ipm_kernel.ipm_iterate_dense_plain,
             "gmv": linalg.gmv_plain, "gtmv": linalg.gtmv_plain}
    owner = {"riccati_factor": rk, "riccati_solve": rk,
             "ipm_iterate_dense": ipm_kernel, "gmv": lk, "gtmv": lk}

    def reset_counts():
        ipm_kernel.reset_launch_count()
        lk.reset_launch_counts()
        rk.reset_launch_counts()
        scp.reset_host_sync_count()
        qp.reset_host_sync_count()

    def routed(which, fns, fn, *args, **kw):
        """Run ``fn`` with the wrappers in ``which`` pointed at ``fns``."""
        for k in which:
            setattr(owner[k], k, fns[k])
        try:
            out = fn(*args, **kw)
            torch.cuda.synchronize()
        finally:
            for k in which:
                setattr(owner[k], k, real[k])
        return out

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
        _, out_first = routed(ric, {k: capture(k, LONG_B) for k in ric},
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
    out_plain = routed(ric, plain, step, carry0)[1]
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
    if min(counts.values()) == 0:
        fail(f"the long-horizon path did not run the Riccati kernels: "
             f"{counts}")
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
    _, one_k = routed(ric, {k: capture(k, 1) for k in ric}, engine.mpc_step,
                      cfg1, data1, engine.init_carry(cfg1, data1))
    one_first.update(captured)
    check_riccati("one_scenario_step_B1", one_first["riccati_factor"][0],
                  one_first["riccati_solve"][0])
    _, one_p = routed(ric, plain, engine.mpc_step, cfg1, data1,
                      engine.init_carry(cfg1, data1))
    cfg64, data64 = builders.circle(4, dtype=torch.float64, device=dev)
    cfg64 = config_lib.tuned_f32(cfg64.replace(hp=LONG_HP, hu=LONG_HP),
                                 qp_kkt="banded")
    _, one_d = routed(ric, plain, engine.mpc_step, cfg64, data64,
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
    if min(one_counts.values()) == 0:
        fail(f"the one-scenario banded step did not run K6 / K7: "
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

    _, out_first_f = routed(("ipm_iterate_dense",),
                            {"ipm_iterate_dense": shadow}, step_f, carry_f)
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
    # the QPs of the dense-G branch, counted beside K2's launches
    n_qp = 0
    dense_branch = qp._solve_qp_batched_dense

    def counted(*args, **kw):
        nonlocal n_qp
        n_qp += 1
        return dense_branch(*args, **kw)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    c, outs_f = carry_f, []
    qp._solve_qp_batched_dense = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FROG_STEPS):
            c, out = step_f(c)
            outs_f.append(out)
        torch.cuda.synchronize()
        frog_step_ms = (time.perf_counter() - t0) / FROG_STEPS * 1e3
    finally:
        qp._solve_qp_batched_dense = dense_branch
    k2 = ipm_kernel.dense_launch_count
    k1_f = ipm_kernel.launch_count
    reads_f = scp.host_sync_count + qp.host_sync_count
    peak_f = torch.cuda.max_memory_allocated() / 2 ** 20
    # the same chained steps through the plain version
    c, outs_p = carry_f, []
    for _ in range(FROG_STEPS):
        c, out = routed(("ipm_iterate_dense",), plain, step_f, c)
        outs_p.append(out)
    for i, out in enumerate(outs_f):
        finite_outputs(out, f"frog step {i}")
        if out.u_pred.shape != (FROG_B, FROG_HP, 1):
            fail(f"frog step {i}: unexpected output shapes")
    feas_f = float(torch.stack([o.feasible.float().mean()
                                for o in outs_f]).mean())
    feas_p = float(torch.stack([o.feasible.float().mean()
                                for o in outs_p]).mean())
    data_f64 = tree_map(
        lambda t: t.double() if t.is_floating_point() else t, data_f)
    # (the dense-fused branch also multiplies by G through K5a / K5b,
    # which are float32 only: the oracle routes them to their plain versions)
    out_f64 = routed(("ipm_iterate_dense", "gmv", "gtmv"), plain,
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
          "host_reads_per_step": reads_f / FROG_STEPS,
          "step_ms": frog_step_ms,
          "solves_per_s": FROG_B / frog_step_ms * 1e3,
          "peak_device_memory_mib": peak_f,
          "feasible_share": feas_f, "feasible_share_plain": feas_p,
          "feasible_floor": feas_p - FROG_FEASIBLE_SLACK,
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
    if feas_f < feas_p - FROG_FEASIBLE_SLACK:
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
                          {**d_kw, "n_iters": 1})
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


def main() -> None:
    B = BATCH

    # ---- phase 1: device ----
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
    emit(times)

    # ---- phases 6-10: the Cholesky, solve and matvec kernels ----
    linalg_reports = linalg_phases(dev, card, B, N_VEH, HP, SEED)

    # ---- phases 11-15: the Riccati sweeps and the dense-G iteration ----
    new_reports = long_horizon_and_dense_phases(dev, card, SEED)

    emit({"kernels": [kernel_report] + linalg_reports + new_reports})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
