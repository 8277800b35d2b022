"""Where one batched MPC step of the PyTorch/CUDA port spends its time.

Run on a machine with an NVIDIA GPU, from the repository root::

    python3 scripts/torch_step_profile.py [--batch 1024] [--steps 3]

Drives ``scp_tpu_torch.sim.engine.mpc_step_batch`` on the randomized
4-vehicle circle batch (hp = hu = 20, float32, tuned_f32, TUNED_F32_PHASES),
warm, under ``torch.profiler``, and prints JSON lines: the wall time per step,
the device-busy share (sum of kernel time over wall time), the number of
kernel launches per step, the time in the hand-written IPM kernel, and the
ten kernels with the most device time. A second pass times the step's three
parts (controller_pre, solve_scp_batch, step_post) with a synchronise after
each.
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
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=3)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.scenarios import batch as batch_lib
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.solvers import scp

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(42)
    cfg, data = batch_lib.make_batch("circle", opts.batch, generator=gen,
                                     dtype=torch.float32, device=dev, n_veh=4)
    cfg = config_lib.tuned_f32(cfg.replace(hp=20, hu=20))
    phases = config_lib.TUNED_F32_PHASES
    carry = engine.init_carry(cfg, data)
    for _ in range(3):                                  # warm up
        carry, _ = engine.mpc_step_batch(cfg, data, carry, phases=phases)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.time()
        for _ in range(opts.steps):
            carry, _ = engine.mpc_step_batch(cfg, data, carry, phases=phases)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / opts.steps
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    k1_us = sum(e.device_time_total for e in rows if "ipm_struct" in e.key)
    top = sorted(rows, key=lambda e: -e.device_time_total)[:10]
    print(json.dumps({
        "card": card, "B": opts.batch, "steps": opts.steps,
        "step_wall_ms_under_profiler": wall_ms,
        "device_busy_ms_per_step": dev_us / 1e3 / opts.steps,
        "device_busy_share": dev_us / 1e3 / opts.steps / wall_ms,
        "kernel_launches_per_step": launches / opts.steps,
        "k1_ms_per_step": k1_us / 1e3 / opts.steps,
        "top_kernels": [{"name": e.key[:80], "ms_per_step":
                         e.device_time_total / 1e3 / opts.steps,
                         "launches_per_step": e.count / opts.steps}
                        for e in top]}), flush=True)

    # the step's three parts, a synchronise after each (no profiler)
    parts = {"controller_pre": 0.0, "solve_scp_batch": 0.0, "step_post": 0.0}
    n = 5
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.time()
        problem, aux = engine.controller_pre(cfg, data, carry)
        torch.cuda.synchronize()
        t1 = time.time()
        res = scp.solve_scp_batch(problem, carry.u_warm,
                                  max_scp_iter=cfg.max_scp_iter,
                                  phases=phases, **engine._scp_kwargs(cfg))
        torch.cuda.synchronize()
        t2 = time.time()
        carry, _ = engine.step_post(cfg, data, carry, res, aux)
        torch.cuda.synchronize()
        t3 = time.time()
        parts["controller_pre"] += (t1 - t0) * 1e3 / n
        parts["solve_scp_batch"] += (t2 - t1) * 1e3 / n
        parts["step_post"] += (t3 - t2) * 1e3 / n
    print(json.dumps({"card": card, "B": opts.batch,
                      "part_ms_per_step": parts}), flush=True)


if __name__ == "__main__":
    main()
