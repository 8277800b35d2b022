#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``scp_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

It builds the hand-written CUDA kernel from ``scp_tpu_torch/csrc``, holds it
against its plain PyTorch version on the card, drives the port's main path
(``mpc_step_batch`` on the randomized 4-vehicle circle batch, B = 1024,
hp = hu = 20, float32, ``tuned_f32`` with ``TUNED_F32_PHASES``) for a dozen
chained steps, times the step and the kernel, and prints one JSON object per
phase. The last line of standard output is
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
MAIN_STEPS = 12
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

# Published peaks of one H100 SXM (dense, no sparsity).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


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


def main() -> None:
    B = BATCH

    # ---- phase 1: device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import scp_tpu_torch
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.config import tree_map
    from scp_tpu_torch.ops import ipm_kernel
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
    lib_path = ipm_kernel.build_library(verbose=True)
    ipm_kernel.load_library()
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "library": lib_path.name})

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
    n_timed = 10
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

    emit({"kernels": [kernel_report]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
