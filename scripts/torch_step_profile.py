"""Where one MPC step of the PyTorch/CUDA port spends its time.

Run on a machine with an NVIDIA GPU, from the repository root::

    python3 scripts/torch_step_profile.py [--path tuned|adaptive|instance|
                                                  long_horizon|instance64|
                                                  instance64_dense|frog|
                                                  ss_frog|ss_parallel]
                                          [--cell NAME [--seed N]]
                                          [--batch B] [--steps 3] [--hp HP]
                                          [--warmup 3]

Drives one path of ``scp_tpu_torch.sim.engine`` (float32, warm) under
``torch.profiler``; the first six on the 4-vehicle circle:

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
  IPM kernel);
* ``ss_frog`` — ``mpc_step_batch`` under ``controller="side_selection"``
  on the randomized frog batch (hp = hu = 10, B = 1024 unless ``--batch``)
  with ``tuned_f32`` updated by ``TUNED_F32_SIDE_SELECTION`` (the dense-G
  IPM kernel: the 5B-wide candidates, then the reselection round);
* ``ss_parallel`` — the same on the randomized 11-vehicle parallel batch
  (B = 256 unless ``--batch``): the structured IPM kernel with the hard
  rate rows (from ``--hp 32`` in its global tier: ``--hp 64 --steps 1
  --warmup 1`` profiles one step at hp = 64).

``--cell NAME`` profiles a cell of the benchmark instead (``benchmark/
workloads/NAME.json``: its configuration, its batch from the traffic mix
and ``--seed``, its step), ``--batch`` overriding the mix's width. The
warm-up steps are the first of an episode from the set-up's carry and the
profiled steps follow them: with the default ``--warmup 1`` the steps 1,
2, ... that the cell's traced run profiles, with ``--warmup 20`` steps
from the middle of an episode (keep warm-up and steps within the
episode's 50).

``--hp`` overrides the path's horizon (hp = hu), ``--warmup`` the steps
run before the profiled ones (3 on a path).

It prints JSON lines: the wall time per step, the device-busy share (the
union of the device's intervals over the profiled window), the number of
kernel launches per step, the device time and launches of each
hand-written kernel (with its device time per launch and its share of the
step's device time), the ten kernels with the most device time and the
peak device memory; then the program's spans (``utils/timing.py``) of the
profiled steps: each span name's self time a step (its time less its
children's), the host's wait in the device reads (``sync`` spans) and its
own issue time (``step`` less ``sync``), both a step, the SCP phases'
lane use (useful lane-iterations over those run; the arithmetic of the
benchmark's readers, ``benchmark/harness/program_spans.py``); the spans a
step by name and attrs (``calls``: each QP's route and shape, each K1 /
K2 launch's tier and shape, ...); for each profiled step its SCP phases
(width, cap, stragglers entering, iterations run, useful lanes) and the
active instances found at each SCP read (``scp``); and the ten longest
gaps in the device's work, each put down to the innermost ``scp.*`` range
open on the host at the gap's middle.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmark"))
from harness import program_spans, yardstick  # noqa: E402
KERNELS = ("ipm_struct_kernel", "ipm_struct_cluster_kernel",
           "ipm_dense_kernel", "chol_blocked_kernel", "chol_large_kernel",
           "cho_solve_batched_kernel", "cho_solve_large_kernel",
           "gmv_staged_kernel", "gtmv_", "riccati_factor", "riccati_solve")


def span_table(recs, steps):
    """Self time a step by span name [ms] (a span's time less its
    children's) and the number of such spans a step."""
    dur = [program_spans.ms(r) for r in recs]
    own = list(dur)
    for i, r in enumerate(recs):
        if r["parent"] is not None:
            own[r["parent"]] -= dur[i]
    by_name = {}
    for r, ms in zip(recs, own):
        n, t = by_name.get(r["name"], (0, 0.0))
        by_name[r["name"]] = (n + 1, t + ms)
    return {name: {"self_ms_per_step": t / steps, "per_step": n / steps}
            for name, (n, t) in sorted(by_name.items(),
                                       key=lambda kv: -kv[1][1])}


def calls_by_attrs(recs, steps):
    """Spans a step by name and attrs (``k1 tier=shared B=16384 ...``),
    each attr as recorded: the step's batch and controller, each QP's
    route and shape, each K1 / K2 launch's tier and shape, each SCP
    iteration's and side-selection part's width."""
    out = {}
    for r in recs:
        if r["name"] in ("scp.phase", "sync"):
            continue                     # per step, in scp_detail
        key = " ".join([r["name"]] + [f"{k}={v}" for k, v in
                                      sorted(r["attrs"].items())])
        out[key] = out.get(key, 0) + 1
    return {k: n / steps for k, n in sorted(out.items())}


def scp_detail(recs):
    """Each profiled step's SCP phases (``k``, ``width``, the cap
    ``iters``, the ``stragglers`` entering, the iterations run,
    ``lanes_useful``) and the active count found at each of its SCP
    reads (``sync`` at ``site=scp``); the IPM reads counted."""
    iters = program_spans.phase_iterations(recs)
    by_step = {}
    for i, r in enumerate(recs):
        one = by_step.setdefault(r["step"], {"phases": [], "scp_active": [],
                                             "ipm_reads": 0})
        a = r["attrs"]
        if r["name"] == "scp.phase":
            one["phases"].append({
                "k": a["k"], "width": a["width"], "iters": a["iters"],
                "stragglers": a.get("stragglers"), "ran": iters[i],
                "lanes_useful": a.get("lanes_useful")})
        elif r["name"] == "sync" and a["site"] == "scp":
            one["scp_active"].append(a["active"])
        elif r["name"] == "sync":
            one["ipm_reads"] += 1
    return [by_step[k] for k in sorted(by_step, key=lambda k: (k is None, k))]


def idle_gaps(prof, n=10):
    """The ``n`` longest gaps between the device's intervals inside the
    profiled steps, each with the innermost ``scp.*`` range open on the
    host at its middle, and the device's busy share of that window."""
    from torch.autograd import DeviceType

    from scp_tpu_torch.utils import timing

    device, ranges = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if t > s and not e.name.startswith(timing.PREFIX):
                device.append((s, t))
        elif e.name.startswith(timing.PREFIX):
            ranges.append((s, t, e.name))
    steps = [(s, t) for s, t, name in ranges
             if name == timing.PREFIX + "step"]
    lo, hi = min(s for s, _ in steps), max(t for _, t in steps + device)
    inside = [(max(s, lo), min(t, hi)) for s, t in device
              if t > lo and s < hi]
    gaps = yardstick.gaps(inside, lo, hi)

    def label(mid):
        inner = None
        for s, t, name in ranges:
            if s <= mid <= t and (inner is None or s >= inner[0]):
                inner = (s, name)
        return inner[1] if inner else "outside the spans"

    gaps.sort(key=lambda g: g[0] - g[1])
    share = yardstick.union_seconds(inside) / (hi - lo)
    return share, [{"span": label(0.5 * (s + t)), "ms": (t - s) * 1e-3}
                   for s, t in gaps[:n]]


def _cell_step(name, seed, batch, dev):
    """The benchmark's cell ``name``: (step, carry, B) of its program."""
    from harness import cells
    from harness.program import Program
    from traffic.generate import generate

    cell = cells.load(name)
    prog = Program(cell.config,
                   generate(cell.config, cell.mix, seed, dev, batch))
    return prog.step, prog.carry0, prog.batch


def _path_step(opts, dev):
    """The path ``opts.path``: (step, carry, B)."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.scenarios import batch as batch_lib, builders
    from scp_tpu_torch.sim import engine

    gen = torch.Generator(device=dev).manual_seed(42)
    one = opts.path in ("instance", "instance64", "instance64_dense")
    side = opts.path.startswith("ss_")
    hp = 64 if opts.path in ("long_horizon", "instance64",
                             "instance64_dense") else 10 if side else 20
    hp = opts.hp or hp
    if one:
        cfg, data = builders.circle(4, dtype=torch.float32, device=dev)
    elif opts.path in ("frog", "ss_frog"):
        cfg, data = batch_lib.make_batch("frog", opts.batch or 1024,
                                         generator=gen, dtype=torch.float32,
                                         device=dev)
    elif opts.path == "ss_parallel":
        cfg, data = batch_lib.make_batch("parallel", opts.batch or 256,
                                         generator=gen, dtype=torch.float32,
                                         device=dev, n_veh=11)
    else:
        width = opts.batch or (256 if opts.path == "long_horizon" else 1024)
        cfg, data = batch_lib.make_batch("circle", width, generator=gen,
                                         dtype=torch.float32, device=dev,
                                         n_veh=4)
    cfg = cfg.replace(hp=hp, hu=hp)
    phases = None
    if opts.path == "instance64":
        cfg = config_lib.tuned_f32(cfg, qp_kkt="banded")
    elif side:
        cfg = config_lib.tuned_f32(cfg.replace(controller="side_selection"),
                                   **config_lib.TUNED_F32_SIDE_SELECTION)
    elif opts.path != "adaptive":
        cfg = config_lib.tuned_f32(cfg)
    if opts.path in ("tuned", "long_horizon", "frog"):
        phases = config_lib.TUNED_F32_PHASES

    def step(c):
        if one:
            return engine.mpc_step(cfg, data, c)
        return engine.mpc_step_batch(cfg, data, c, phases=phases)
    return step, engine.init_carry(cfg, data), data.x0.shape[0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("tuned", "adaptive", "instance",
                                       "long_horizon", "instance64",
                                       "instance64_dense", "frog",
                                       "ss_frog", "ss_parallel"),
                    default="tuned")
    ap.add_argument("--cell", default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--hp", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from scp_tpu_torch.utils import timing

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    if opts.cell:
        step, carry, batch = _cell_step(opts.cell, opts.seed, opts.batch, dev)
    else:
        step, carry, batch = _path_step(opts, dev)
    what = {"card": card, "path": opts.cell or opts.path, "B": batch,
            "steps": opts.steps}
    warmup = opts.warmup if opts.warmup is not None else (
        1 if opts.cell else 3)
    for _ in range(warmup):                             # warm up
        carry, _ = step(carry)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    timing.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.time()
        for _ in range(opts.steps):
            carry, _ = step(carry)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / opts.steps
    recs = timing.recorded()
    timing.clear()
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(timing.PREFIX)]
    dev_us = sum(e.device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    own = {}
    # (substrings of the kernels' names: riccati_factor matches the factor
    # kernels of every design, gtmv_ the G^T v kernel of every design)
    for name in KERNELS:
        hit = [e for e in rows if name in e.key]
        n_launch = sum(e.count for e in hit)
        us = sum(e.device_time_total for e in hit)
        own[name] = {"ms_per_step": us / 1e3 / opts.steps,
                     "launches_per_step": n_launch / opts.steps,
                     "device_us_per_launch": us / n_launch if n_launch else None,
                     "share_of_device_time": us / dev_us if dev_us else None}
    top = sorted(rows, key=lambda e: -e.device_time_total)[:10]
    busy, gaps = idle_gaps(prof)
    print(json.dumps({
        **what,
        "step_wall_ms_under_profiler": wall_ms,
        "device_ms_per_step": dev_us / 1e3 / opts.steps,
        "device_busy_share": busy,
        "kernel_launches_per_step": launches / opts.steps,
        "peak_device_memory_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
        "hand_written_kernels": own,
        "top_kernels": [{"name": e.key[:80], "ms_per_step":
                         e.device_time_total / 1e3 / opts.steps,
                         "launches_per_step": e.count / opts.steps}
                        for e in top]}), flush=True)

    wait_ms = program_spans.host_wait_ms(recs)
    print(json.dumps({
        **what, "first_step": warmup,
        "host_wait_ms_per_step": (None if wait_ms is None
                                  else wait_ms / opts.steps),
        "host_issue_ms_per_step": (program_spans.host_issue_ms(recs)
                                   / opts.steps),
        "scp_lane_use": program_spans.lane_use(recs),
        "spans": span_table(recs, opts.steps),
        "calls": calls_by_attrs(recs, opts.steps),
        "scp": scp_detail(recs), "idle_gaps": gaps}), flush=True)


if __name__ == "__main__":
    main()
