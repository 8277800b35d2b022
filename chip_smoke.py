#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``scp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``scp_tpu_torch/csrc`` (the fused
structured IPM iteration, the batched Cholesky, the Cholesky solve and the
two G matvecs), holds each against its plain PyTorch version on the card,
and drives three paths of the port at full width, every kernel's launch
count set to 0 just before a path and read just after:

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
  ``simulate_batch`` at B = 64.

It times every kernel beside its plain version, the PyTorch library call
that computes the same function (where there is one) and the card's bound,
and prints one JSON object per phase. The last line of standard output is
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

# Published peaks of one H100 SXM (dense, no sparsity).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


# device_ms: profiler sessions that came back empty and were repeated
EMPTY_PROFILER_SESSIONS = 0


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


def k1_bound_ms(shape, B, n_iters, n_cor, lower_tri):
    nbytes, flops = k1_work(*shape, B, n_iters, n_cor, lower_tri)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


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


def device_ms(fn, reps: int) -> float:
    """Milliseconds of DEVICE time per call: the kernels' own durations as
    ``torch.profiler`` records them, summed over ``reps`` calls. A call of
    tens of microseconds is otherwise timed by the host that enqueues it
    (``time_cuda`` measures that: what a caller pays per call). A profiler
    session now and then comes back without device records; it is repeated
    (``EMPTY_PROFILER_SESSIONS`` counts those), and five empty sessions in
    a row fail the run: a host time never stands in for a device time."""
    global EMPTY_PROFILER_SESSIONS
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if getattr(e, "device_time_total", 0) > 0
                 and e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
        EMPTY_PROFILER_SESSIONS += 1
    fail("torch.profiler recorded no device time in five sessions")


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
    the solve, so a factor needs n(n+1)/2 floats in and as many out, and a
    solve n(n+1)/2 floats of L, b and x."""
    tri = n * (n + 1) // 2
    if kind == "cholesky":
        nbytes, flops = 4 * 2 * tri, 2 * n ** 3 / 3
    elif kind == "cho_solve":
        nbytes, flops = 4 * (tri + 2 * n), 2 * 2 * n * n
    else:                                   # gmv / gtmv
        nbytes, flops = 4 * (m * n + m + n), 2 * m * n
    t_bytes = B * nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = B * flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


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


def finite_outputs(outs, what: str) -> None:
    for name, val in outs._asdict().items():
        if val.is_floating_point() and not torch.isfinite(val).all():
            fail(f"{what}: output {name} is not finite")


def u_pred_diff(a, b):
    return (a.u_pred.double() - b.u_pred.double()).abs().amax(dim=(-2, -1))


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
    LATER = {"cholesky": 9, "cho_solve": 19}
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
    for k, idx in LATER.items():
        if idx not in captured[k]:
            fail(f"the first step made fewer than {idx + 1} calls of {k}")
    check_factor("tenth_ipm_iteration", captured["cholesky"][9][0],
                 real["cholesky"], plain["cholesky"], False)
    check_vector("cho_solve", "tenth_ipm_iteration", real["cho_solve"],
                 plain["cho_solve"], captured["cho_solve"][19],
                 FIRST_ITER_REL_LIMIT, first_iter=False)
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
    for w in widths:
        if w > B:
            continue
        for k in names:
            args = tuple(a[:w].contiguous() for a in first[k])
            # ms / plain_ms / library_ms: device time per call (profiler);
            # *_call_ms: CUDA events around back-to-back calls, which for
            # kernels this short is the host's time to enqueue one
            cell = {"ms": device_ms(lambda: real[k](*args), timing_reps),
                    "plain_ms": device_ms(lambda: plain[k](*args),
                                          timing_reps),
                    "library_ms": device_ms(lambda: library[k](*args),
                                            timing_reps)}
            cell["bound_ms"], cell["bound_by"] = linalg_bound_ms(k, w, n, mg)
            cell["call_ms"] = time_cuda(lambda: real[k](*args),
                                        reps=timing_reps)
            cell["plain_call_ms"] = time_cuda(lambda: plain[k](*args),
                                              reps=timing_reps)
            cell["library_call_ms"] = time_cuda(lambda: library[k](*args),
                                                reps=timing_reps)
            times["kernels"][k][str(w)] = cell
            if w == widths[0]:
                reports[k].update(cell)
    times["empty_profiler_sessions_repeated"] = EMPTY_PROFILER_SESSIONS
    emit(times)
    reset_counts()
    return [reports[k] for k in names]


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
    for w in widths:
        args_w, kw_w = captured[w]
        ms = time_cuda(lambda: real_wrapper(*args_w, **kw_w), reps=20)
        plain_ms = time_cuda(lambda: plain(*args_w, **kw_w), reps=3, warmup=1)
        bound, by = k1_bound_ms(shape_b, w, kw_w["n_iters"], kw_w["n_cor"],
                                kw_w["lower_tri"])
        times["k1"][str(w)] = {"ms": ms, "plain_ms": plain_ms,
                               "bound_ms": bound, "bound_by": by}
        if w == B:
            kernel_report.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=by)
    ipm_kernel.reset_launch_count()
    emit(times)

    # ---- phases 6-10: the Cholesky, solve and matvec kernels ----
    linalg_reports = linalg_phases(dev, card, B, N_VEH, HP, SEED)

    emit({"kernels": [kernel_report] + linalg_reports})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
