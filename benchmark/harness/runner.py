"""One run of one cell: set-up (inputs from the seed, the port's kernels
loaded and every shape warmed), the measured window of ``seconds``
(a closed loop of ``engine.mpc_step_batch``, episodes of ``episode_steps``
steps, each started again from the set-up's carry), the output check, and
the result's line."""
from __future__ import annotations

import contextlib
import subprocess
import sys
import time

import torch

from harness import cells, check, trace as trace_lib, yardstick


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, bench: dict, batch: int | None = None,
        fault=None) -> dict:
    """Run ``cell`` once and return the result's line as a dict.
    ``batch`` overrides the mix's batch and ``fault(prog)`` may break the
    port's step before the window (both for the tests on the CPU)."""
    from harness.program import (Program, capture, capture_out, ranges,
                                 spans)
    from traffic.generate import generate

    dev = torch.device(device)
    on_cuda = dev.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    mix, config = cell.mix, cell.config
    tensors = generate(config, mix, seed, dev, batch)
    prog = Program(config, tensors)
    if fault is not None:
        fault(prog)
    b = prog.batch
    sample = check.plan(seed, mix, b)
    sample_idx = {k: torch.as_tensor(v, device=dev)
                  for k, v in sample.items()}
    card = _power_limit() if on_cuda else None

    carry = prog.carry0
    for _ in range(mix["warmup_steps"]):
        carry, out = prog.step(carry)
        prog.bad_rows(out)
    # the sampled steps' copies take the same calls from the first step on
    with capture(prog, prog.carry0, sample_idx[min(sample_idx)], {}):
        _, out = prog.step(prog.carry0)
    capture_out(out)
    del carry, out
    sync()
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.time() - t_start
    log(f"set-up {setup_s:.3f} s: {cell.name}, B = {b}, seed {seed}"
        + (f", {card}" if card else ""))

    tick = mix["loop"] == "tick"
    episode = mix["episode_steps"]
    # traced run: steps [1, 1 + T) profiled (layers marked, nothing
    # synchronised), then steps [1 + T, 1 + 2T) timed layer by layer
    n_tr = mix["trace_steps"]
    trace_at = (1, 1 + n_tr, 1 + 2 * n_tr) if trace else (-1, -1, -1)
    record = {"steps": n_tr if trace else 0}
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    iters_sum = torch.zeros((), dtype=torch.float64, device=dev)
    captured, step_times = {}, []
    last_sampled = max(sample)
    failed = 0
    prof = window = nxt = out = None
    carry, ep, k = prog.carry0, 0, 0
    t0 = time.perf_counter()
    while True:
        if ep == episode:
            carry, ep = prog.carry0, 0
        if k == trace_at[0]:
            sync()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA] if on_cuda else [
                torch.profiler.ProfilerActivity.CPU])
            prof.__enter__()
            window = torch.profiler.record_function(trace_lib.WINDOW)
            window.__enter__()
            layers = ranges(record)
            layers.__enter__()
            prog.reset_counters()
        if k == trace_at[1]:
            sync()
            timed = spans(record, sync)
            timed.__enter__()
        cap = {} if k in sample_idx else None
        ctx = (capture(prog, carry, sample_idx[k], cap) if cap is not None
               else contextlib.nullcontext())
        ts = time.perf_counter()
        try:
            with ctx:
                nxt, out = prog.step(carry)
        except RuntimeError as err:       # a step that raised: B failures
            log(f"step {k} raised: {err}")
            failed += b
            carry, ep, k = prog.carry0, 0, k + 1
            continue
        bad += prog.bad_rows(out)
        if trace:
            iters_sum += out.scp_iters.sum(dtype=torch.float64)
        if cap is not None:
            cap["out"] = capture_out(out)
            captured[k] = cap
        if tick:
            sync()
            step_times.append(time.perf_counter() - ts)
        carry, ep, k = nxt, ep + 1, k + 1
        if k == trace_at[1]:
            sync()
            record["host_reads"] = prog.host_reads()
            layers.__exit__(None, None, None)
            window.__exit__(None, None, None)
            prof.__exit__(None, None, None)
        if k == trace_at[2]:
            timed.__exit__(None, None, None)
        if (time.perf_counter() - t0 >= seconds and k >= trace_at[2]
                and k > last_sampled):
            break
    sync()
    elapsed = time.perf_counter() - t0
    failed += int(bad)
    attempted = k * b
    peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    if trace:
        trace_lib.reduce(prof, record)
        record["scp_iters_mean"] = float(iters_sum) / attempted
    del prog, carry, nxt, out
    if on_cuda:
        torch.cuda.empty_cache()

    # the check, after the window: the reference at the sampled steps
    per = {}
    for k_s, cap in sorted(captured.items()):
        ref = check.reference(config, tensors, cap)
        for n, g in check.step_gaps(config, mix, cap, ref, seed,
                                    k_s).items():
            per.setdefault(n, []).append(g)
        del ref
    numbers = check.reduce(per) if captured else {}
    lims = check.limits(config)
    correct = bool(captured) and failed == 0 and check.verdict(numbers, lims)

    metrics = {}
    if trace:
        for m in cells.per_layer_for(cell.name, bench):
            value = cells.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = {"setup_s": setup_s}
        if tick:
            ms = [t * 1e3 for t in step_times]
            measured["step_p50_ms"] = yardstick.percentile(ms, 50)
            measured["step_p95_ms"] = yardstick.percentile(ms, 95)
        else:
            measured["solves_per_s"] = yardstick.solves_per_s(
                attempted - failed, elapsed)
        for m in cells.end_to_end_for(cell.name, bench):
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_cuda else dev.type,
                "kind": (torch.cuda.get_device_name(dev) if on_cuda
                         else dev.type),
                "count": cell.chips if on_cuda else 1,
                "memory_peak_bytes": int(peak)}
    if card:
        dev_info["card"] = card
    if trace:
        dev_info["busy_s"] = record["busy_s"]
        dev_info["window_s"] = record["window_s"]
    log(f"window {elapsed:.3f} s, {k} steps, {attempted} instance-steps, "
        f"{failed} failed, {len(captured)} sampled steps checked")
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        result["breakdown"] = trace_lib.breakdown(record)
    result["check"] = {n: {"value": numbers.get(n), "limit": lims[n]}
                       for n in lims}
    result["check"]["failed"] = {"value": failed, "limit": 0}
    return result
