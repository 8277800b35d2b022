"""Where one MPC step of the PyTorch/CUDA port spends its time.

Run on a machine with an NVIDIA GPU, from the repository root::

    python3 scripts/torch_step_profile.py [--path tuned|adaptive|instance|
                                                  long_horizon|instance64|
                                                  instance64_dense|frog]
                                          [--batch B] [--steps 3]

Drives one path of ``scp_tpu_torch.sim.engine`` on the 4-vehicle circle
(float32), warm, under ``torch.profiler``:

* ``tuned`` — ``mpc_step_batch`` on the randomized batch (hp = hu = 20,
  B = 1024 unless ``--batch``) with ``tuned_f32`` and ``TUNED_F32_PHASES``
  (the fused IPM kernel);
* ``adaptive`` — ``mpc_step_batch`` on the same batch with the DEFAULT
  configuration (adaptive IPM: Cholesky, solve and matvec kernels);
* ``instance`` — ``mpc_step`` on ONE nominal scenario with ``tuned_f32``
  (``--batch`` is ignored);
* ``long_horizon`` — ``mpc_step_batch`` at hp = hu = 64, B = 256 unless
  ``--batch``, ``tuned_f32`` and ``TUNED_F32_PHASES`` (``qp_kkt="auto"``
  routes to the banded KKT: the Riccati factor and solve kernels);
* ``instance64`` — ``mpc_step`` on ONE nominal scenario at hp = hu = 64
  with ``tuned_f32`` and ``qp_kkt="banded"`` (the Riccati kernels at B = 1);
* ``instance64_dense`` — the same scenario with ``tuned_f32`` as it stands
  (``qp_kkt="auto"``: per instance the dense KKT, so the factor and the
  solve at n = 257, B = 1, with the matrix in device memory);
* ``frog`` — ``mpc_step_batch`` on the randomized single-vehicle frog batch
  (22 moving obstacles, hp = hu = 20, B = 1024 unless ``--batch``) with
  ``tuned_f32`` and ``TUNED_F32_PHASES`` (no vehicle pair: the dense-G
  IPM kernel).

It prints JSON lines: the wall time per step, the device-busy share (sum of
kernel time over wall time), the number of kernel launches per step, the
device time and launches of each hand-written kernel (with its device time
per launch and its share of the step's device time), and the ten kernels
with the most device time. A second pass times the step's three parts
(controller_pre, the SCP solve, step_post) with a synchronise after each.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("tuned", "adaptive", "instance",
                                       "long_horizon", "instance64",
                                       "instance64_dense", "frog"),
                    default="tuned")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.scenarios import batch as batch_lib, builders
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.solvers import scp

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(42)
    one = opts.path in ("instance", "instance64", "instance64_dense")
    hp = 64 if opts.path in ("long_horizon", "instance64",
                             "instance64_dense") else 20
    if one:
        cfg, data = builders.circle(4, dtype=torch.float32, device=dev)
    elif opts.path == "frog":
        cfg, data = batch_lib.make_batch("frog", opts.batch or 1024,
                                         generator=gen, dtype=torch.float32,
                                         device=dev)
    else:
        width = opts.batch or (256 if opts.path == "long_horizon" else 1024)
        cfg, data = batch_lib.make_batch("circle", width, generator=gen,
                                         dtype=torch.float32, device=dev,
                                         n_veh=4)
    cfg = cfg.replace(hp=hp, hu=hp)
    phases = None
    if opts.path == "instance64":
        cfg = config_lib.tuned_f32(cfg, qp_kkt="banded")
    elif opts.path != "adaptive":
        cfg = config_lib.tuned_f32(cfg)
    if opts.path in ("tuned", "long_horizon", "frog"):
        phases = config_lib.TUNED_F32_PHASES
    batch = data.x0.shape[0]
    scp_kw = dict(max_scp_iter=cfg.max_scp_iter, **engine._scp_kwargs(cfg))

    def step(c):
        if one:
            return engine.mpc_step(cfg, data, c)
        return engine.mpc_step_batch(cfg, data, c, phases=phases)

    def solve(problem, c):
        if one:
            return scp.solve_scp(problem, c.u_warm, **scp_kw)
        return scp.solve_scp_batch(problem, c.u_warm, phases=phases, **scp_kw)

    carry = engine.init_carry(cfg, data)
    for _ in range(3):                                  # warm up
        carry, _ = step(carry)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.time()
        for _ in range(opts.steps):
            carry, _ = step(carry)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / opts.steps
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    own = {}
    # (substrings of the kernels' names: riccati_factor matches the factor
    # kernels of every design, gtmv_ the G^T v kernel of every design)
    for name in ("ipm_struct_kernel", "ipm_dense_kernel", "chol_blocked_kernel",
                 "chol_large_kernel", "cho_solve_batched_kernel",
                 "cho_solve_large_kernel", "gmv_staged_kernel", "gtmv_",
                 "riccati_factor", "riccati_solve"):
        hit = [e for e in rows if name in e.key]
        n_launch = sum(e.count for e in hit)
        us = sum(e.device_time_total for e in hit)
        own[name] = {"ms_per_step": us / 1e3 / opts.steps,
                     "launches_per_step": n_launch / opts.steps,
                     "device_us_per_launch": us / n_launch if n_launch else None,
                     "share_of_device_time": us / dev_us if dev_us else None}
    top = sorted(rows, key=lambda e: -e.device_time_total)[:10]
    print(json.dumps({
        "card": card, "path": opts.path, "B": batch, "steps": opts.steps,
        "step_wall_ms_under_profiler": wall_ms,
        "device_busy_ms_per_step": dev_us / 1e3 / opts.steps,
        "device_busy_share": dev_us / 1e3 / opts.steps / wall_ms,
        "kernel_launches_per_step": launches / opts.steps,
        "hand_written_kernels": own,
        "top_kernels": [{"name": e.key[:80], "ms_per_step":
                         e.device_time_total / 1e3 / opts.steps,
                         "launches_per_step": e.count / opts.steps}
                        for e in top]}), flush=True)

    # the step's three parts, a synchronise after each (no profiler)
    parts = {"controller_pre": 0.0, "scp_solve": 0.0, "step_post": 0.0}
    n = 5
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.time()
        problem, aux = engine.controller_pre(cfg, data, carry)
        torch.cuda.synchronize()
        t1 = time.time()
        res = solve(problem, carry)
        torch.cuda.synchronize()
        t2 = time.time()
        carry, _ = engine.step_post(cfg, data, carry, res, aux)
        torch.cuda.synchronize()
        t3 = time.time()
        parts["controller_pre"] += (t1 - t0) * 1e3 / n
        parts["scp_solve"] += (t2 - t1) * 1e3 / n
        parts["step_post"] += (t3 - t2) * 1e3 / n
    print(json.dumps({"card": card, "path": opts.path, "B": batch,
                      "part_ms_per_step": parts}), flush=True)


if __name__ == "__main__":
    main()
