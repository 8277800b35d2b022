"""Benchmark: SCP controller solves/s on one GPU (counterpart of the
repository's ``bench.py``).

Throughput: the full warm-started MPC controller step (delay compensation,
reference sampling, linearize / discretize / condense, the SCP solve with
the batched IPM QP, the plant rollout) through
``engine.mpc_step_batch`` on a randomized 4-vehicle circle batch of
``BATCH`` instances at the hp = hu = ``HP`` horizon, float32, ``tuned_f32``
with ``TUNED_F32_PHASES``. One warm-up step (kernel build and load,
allocator growth; ``build_s``), then ``ITERS`` chained steps closed by
``torch.cuda.synchronize``.

Latency: each of the ``LSTEPS`` closed-loop steps of one nominal circle-4
scenario under ``tuned_f32`` through ``engine.mpc_step``, timed ``REPS``
times from the same carry (the noise generator's state restored before each
repeat), the mean of the repeats; the repeats' objectives must be bitwise
equal.

Run as ``python -m scp_tpu_torch.bench`` (on ``cuda``; ``worker(device=)``
takes another device). Prints ONE JSON line on stdout,
``{"metric": "scp_solves_per_sec_chip", "value": ..., "unit": "solves/s"}``,
and on stderr the step time and ``# step_latency_ms p50= p90= max=`` with
the device's name.
"""
from __future__ import annotations

import json
import sys
import time

import torch

BATCH = 1024
N_VEH = 4
HP = 20
SEED = 42
ITERS = 30
LSTEPS = 50     # the full closed loop (cfg.n_sim at dt = 0.4)
REPS = 3


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def throughput(device: torch.device) -> dict:
    """Solves/s of the calibrated batched step (see the module docstring)."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.scenarios import batch as batch_lib
    from scp_tpu_torch.sim import engine

    gen = torch.Generator(device=device).manual_seed(SEED)
    cfg, data = batch_lib.make_batch(
        "circle", BATCH, generator=gen, dtype=torch.float32, device=device,
        n_veh=N_VEH)
    cfg = config_lib.tuned_f32(cfg.replace(hp=HP, hu=HP))
    phases = config_lib.TUNED_F32_PHASES
    carry = engine.init_carry(cfg, data)

    t0 = time.perf_counter()
    carry, out = engine.mpc_step_batch(cfg, data, carry, phases=phases)
    _sync(device)
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(ITERS):
        carry, out = engine.mpc_step_batch(cfg, data, carry, phases=phases)
    _sync(device)
    dt = (time.perf_counter() - t0) / ITERS
    return {"step_s": dt, "build_s": build_s,
            "solves_per_sec": BATCH / dt,
            "feasible_frac": float(out.feasible.float().mean())}


def latency(device: torch.device) -> list[float]:
    """Per-step latency [s] of the one-scenario closed loop, each step the
    mean of ``REPS`` repeats from the same carry; the repeats must give
    bitwise equal objectives."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.scenarios import builders
    from scp_tpu_torch.sim import engine

    cfg1, data1 = builders.circle(N_VEH, dtype=torch.float32, device=device)
    cfg1 = config_lib.tuned_f32(cfg1.replace(hp=HP, hu=HP))
    carry = engine.init_carry(cfg1, data1)
    engine.mpc_step(cfg1, data1, carry)          # first calls, not timed
    _sync(device)

    lats = []
    for i in range(LSTEPS):
        gen_state = carry.generator.get_state()
        objs, total = [], 0.0
        for _ in range(REPS):
            carry.generator.set_state(gen_state)
            _sync(device)
            t0 = time.perf_counter()
            nxt, out = engine.mpc_step(cfg1, data1, carry)
            _sync(device)
            total += time.perf_counter() - t0
            objs.append(out.obj.clone())
        if not all(torch.equal(objs[0], o) for o in objs[1:]):
            raise AssertionError(
                f"step {i}: the repeats of one step from the same carry "
                f"gave different objectives {[o.tolist() for o in objs]}; "
                f"the latency would time different steps")
        lats.append(total / REPS)
        carry = nxt           # the last repeat is the step itself
    return lats


def worker(device="cuda") -> dict:
    """Measure throughput and latency on ``device`` and print the results
    (see the module docstring). Returns them as a dict as well."""
    from scp_tpu_torch import assert_full_f32, require_device

    device = require_device(device)
    assert_full_f32()
    thr = throughput(device)
    result = {"metric": "scp_solves_per_sec_chip",
              "value": round(thr["solves_per_sec"], 1),
              "unit": "solves/s"}
    print(json.dumps(result), flush=True)
    print(f"# batch={BATCH} n_veh={N_VEH} hp={HP} "
          f"step_ms={thr['step_s'] * 1e3:.1f} "
          f"build_s={thr['build_s']:.1f} "
          f"feasible_frac={thr['feasible_frac']:.4f}", file=sys.stderr)

    lats = sorted(latency(device))
    p50 = lats[len(lats) // 2]
    p90 = lats[min(len(lats) - 1, int(0.90 * len(lats)))]
    lat_max = lats[-1]
    # with LSTEPS samples the top order statistic is the max, not a p99
    print(f"# step_latency_ms p50={p50 * 1e3:.2f} p90={p90 * 1e3:.2f} "
          f"max={lat_max * 1e3:.2f} (1 scenario, hp={HP}, {LSTEPS} steps x "
          f"{REPS} reps, {_device_name(device)})", file=sys.stderr,
          flush=True)
    return {**result, **thr, "latency_p50_ms": p50 * 1e3,
            "latency_p90_ms": p90 * 1e3, "latency_max_ms": lat_max * 1e3}


def main() -> int:
    worker()
    return 0


if __name__ == "__main__":
    sys.exit(main())
