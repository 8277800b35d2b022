"""Command-line interface for closed-loop simulations and the benchmark
(counterpart of ``scp_tpu/cli.py``):

    python -m scp_tpu_torch.cli run --scenario circle --n-veh 8 --steps 50
    python -m scp_tpu_torch.cli run --scenario frog --noise --mc 256
    python -m scp_tpu_torch.cli sweep --batch 1024 --n-veh 4 --hp 20 --batched
    torchrun --nproc-per-node 4 -m scp_tpu_torch.cli sweep --cpu --batch 64
    python -m scp_tpu_torch.cli bench --batch 512 --hp 20

Runs go on ``cuda`` unless ``--cpu`` is given; without a GPU they raise.
``--f64`` is the float64 parity dtype of the CPU: the hand-written kernels
are float32 only, so ``--f64`` without ``--cpu`` is refused before any
work. ``--seed`` seeds a ``torch.Generator`` on the run's device (its
numbers are not ``jax.random``'s). ``sweep`` joins the job ``torchrun``
describes in the environment (one rank per process: NCCL on the card that
``LOCAL_RANK`` names, gloo with ``--cpu``), or runs alone without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _build(args, dtype, device="cuda"):
    from scp_tpu_torch.scenarios import builders

    kw = {}
    if args.scenario != "frog" and args.n_veh:
        kw["n_veh"] = args.n_veh
    cfg, data = builders.BUILDERS[args.scenario](dtype=dtype, device=device,
                                                 **kw)
    return _configure(args, cfg, dtype), data


def _configure(args, cfg, dtype):
    """``cfg`` with the flags' overrides: controller, rectangle obstacles,
    ``--kkt``, ``--hp``, ``--noise`` where the command has it, and in
    float32 the calibrated settings (``config.TUNED_F32_*``) under them."""
    from scp_tpu_torch import config as config_lib

    overrides = {}
    if getattr(args, "controller", "scp") != "scp":
        overrides["controller"] = args.controller
    if getattr(args, "rect_obstacles", False):
        overrides["obst_as_qcqp"] = False
    if getattr(args, "kkt", ""):
        overrides["qp_kkt"] = args.kkt
        if getattr(args, "controller", "scp") == "side_selection":
            print("--kkt has no effect with --controller side_selection "
                  "(its QPs always take the dense KKT)", file=sys.stderr)
    if args.hp:
        overrides.update(hp=args.hp, hu=args.hp)
    if getattr(args, "noise", False):
        # per-tick std matching the original controller's measured
        # carried-state dispersion (config.reference_noise_std)
        overrides["noise_std"] = config_lib.reference_noise_std(cfg)
    if dtype == torch.float32:
        # the calibrated settings, from one source (config.TUNED_F32_*;
        # the side-selection controller composes its deeper QP calibration
        # over them)
        tuned = dict(config_lib.TUNED_F32_OVERRIDES)
        if overrides.get("controller") == "side_selection":
            tuned.update(config_lib.TUNED_F32_SIDE_SELECTION)
        for k, v in tuned.items():
            overrides.setdefault(k, v)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def _summary(args, cfg, out, n_steps: int, wall: float) -> dict:
    """The run's summary: what ``scp_tpu.cli`` prints, by its formulas."""
    def host(t):
        return t.detach().cpu().numpy()

    summary = {
        "scenario": args.scenario,
        "n_veh": cfg.n_veh,
        "steps": n_steps,
        "mc": args.mc,
        "wall_s": round(wall, 3),
        "steps_per_sec": round(n_steps * max(args.mc, 1) / wall, 2),
        "feasible_frac": float(np.mean(host(out.feasible))),
        "mean_scp_iters": float(host(out.scp_iters).mean()),
        "mean_obj": float(host(out.obj).mean()),
        "final_max_violation": float(host(out.max_violation).max()),
        "clamp_mag_events": int(host(out.clamp_mag_events).sum()),
        "clamp_rate_events": int(host(out.clamp_rate_events).sum()),
        # the original controller's feasibility-disagreement warning, counted
        "feas_disagree_steps": int(host(out.feas_disagree).sum()),
        "mean_qp_iters": float(host(out.qp_iters).mean()),
    }
    if cfg.controller == "side_selection":
        summary["sides_stable_frac"] = float(host(out.sides_stable).mean())
    return summary


def cmd_run(args) -> dict:
    from scp_tpu_torch import require_device
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.utils import results

    device = require_device("cpu" if args.cpu else "cuda")
    dtype = torch.float64 if args.f64 else torch.float32
    cfg, data = _build(args, dtype, device)
    n_steps = args.steps or cfg.n_sim
    gen = torch.Generator(device=device).manual_seed(args.seed)

    t0 = time.time()
    step_times = controller_runtimes = None
    if getattr(args, "plot", False) and args.mc == 1:
        # live per-step rendering (the original online plot)
        from scp_tpu_torch.viz import plot as plot_lib

        step_times = []
        carry, out = plot_lib.run_live(
            cfg, data, n_steps=n_steps, generator=gen,
            save_dir=args.frames or None, scenario=args.scenario,
            step_times=step_times)
    elif args.mc == 1 and args.export_json:
        # host-driven stepping, so the export carries measured per-step
        # stepTime / controllerRuntime
        carry, out, step_times, controller_runtimes = engine.simulate_timed(
            cfg, data, generator=gen, n_steps=n_steps)
    elif args.mc > 1:
        # Monte-Carlo batch over the generator's plant noise: the
        # straggler-repacked batched step with the calibrated phases (the
        # bench's path). float64, the parity dtype, gets one full-width
        # phase (every instance runs the full-batch step); the
        # side-selection controller runs fixed rounds, no phases.
        from scp_tpu_torch import config as config_lib
        from scp_tpu_torch.scenarios import batch as batch_lib

        data_b = batch_lib.tile_scenario(data, args.mc)
        phases = (None if cfg.controller != "scp"
                  else config_lib.TUNED_F32_PHASES
                  if dtype == torch.float32 else ((cfg.max_scp_iter, 1),))
        carry, out = engine.simulate_batch(cfg, data_b, generator=gen,
                                           n_steps=n_steps, phases=phases)
    else:
        carry, out = engine.simulate(cfg, data, generator=gen,
                                     n_steps=n_steps)
    # the read-back waits for the device: the wall time is the run's
    float(out.feasible.float().mean())
    wall = time.time() - t0

    summary = _summary(args, cfg, out, n_steps, wall)
    print(json.dumps(summary, indent=2))

    if args.out:
        # one run's layout for one scenario, (n_steps, mc, ...) for --mc
        arrays = results.sim_outputs_to_arrays(
            cfg, out, instance=0 if args.mc == 1 else None)
        results.save_npz(args.out, arrays)
        print(f"saved results to {args.out}", file=sys.stderr)
    inst = getattr(args, "export_instance", 0) if args.mc > 1 else None
    if args.export_json:
        results.export_reference_json(
            args.export_json, cfg, data, out,
            step_times=step_times, controller_runtimes=controller_runtimes,
            instance=inst)
        note = (f" (instance {inst} of the {args.mc}-wide batch)"
                if inst is not None else "")
        print(f"exported reference-format JSON to {args.export_json}{note}",
              file=sys.stderr)
    if args.frames and not (getattr(args, "plot", False) and args.mc == 1):
        # (run_live already saved per-step frames on the --plot path)
        from scp_tpu_torch.viz import plot

        arrays = results.sim_outputs_to_arrays(cfg, out, instance=inst or 0)
        paths = plot.render_video_frames(cfg, data, arrays, args.frames,
                                         scenario=args.scenario)
        print(f"wrote {len(paths)} frames to {args.frames}", file=sys.stderr)
    return summary


def sweep_inputs(args, device):
    """``(cfg, data, phases)`` of a ``sweep``: the randomized batch of
    ``--batch`` instances from a generator seeded with ``--seed`` on
    ``device`` (every rank builds the same one), the flags' config, and
    with ``--batched`` the straggler phases (``TUNED_F32_PHASES`` in
    float32, one full-width phase in float64; none for side selection,
    which runs fixed rounds)."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.scenarios import batch as batch_lib

    dtype = torch.float64 if args.f64 else torch.float32
    gen = torch.Generator(device=device).manual_seed(args.seed)
    cfg, data = batch_lib.make_batch(
        args.scenario, args.batch, generator=gen, dtype=dtype,
        device=device, **({"n_veh": args.n_veh} if args.n_veh
                          and args.scenario != "frog" else {}))
    cfg = _configure(args, cfg, dtype)
    phases = None
    if args.batched and cfg.controller == "scp":
        phases = (config_lib.TUNED_F32_PHASES if dtype == torch.float32
                  else ((cfg.max_scp_iter, 1),))
    return cfg, data, phases


def cmd_sweep(args) -> dict:
    """The sharded scenario-batch sweep with periodic checkpoints
    (``parallel.distributed.sweep``). Every rank prints the same summary,
    the sums of ``scp_tpu.cli``'s keys over the whole batch."""
    from scp_tpu_torch import require_device
    from scp_tpu_torch.parallel import distributed

    started = not torch.distributed.is_initialized()
    distributed.initialize(backend="gloo" if args.cpu else "nccl")
    try:
        device = require_device(distributed.local_device(args.cpu))
        cfg, data, phases = sweep_inputs(args, device)
        n_steps = args.steps or cfg.n_sim
        mesh = distributed.global_mesh(n_model=args.n_model)
        t0 = time.time()
        _, (objs, feas, iters) = distributed.sweep(
            cfg, data, mesh, n_steps=n_steps, phases=phases,
            checkpoint_path=args.checkpoint or None,
            checkpoint_every=args.checkpoint_every)
        total = args.batch * n_steps
        summary = {
            "scenario": args.scenario, "batch": args.batch,
            "steps": n_steps, "mesh": dict(mesh.shape),
            "wall_s": round(time.time() - t0, 3),
            "feasible_frac": float(feas.double().sum()) / total,
            "mean_obj": float(objs.double().sum()) / total,
            "mean_scp_iters": float(iters.double().sum()) / total,
        }
    finally:
        if started and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(json.dumps(summary, indent=2))
    return summary


def cmd_bench(args):
    from scp_tpu_torch import bench

    bench.BATCH = args.batch
    bench.HP = args.hp or 20
    return bench.worker()


def main(argv=None):
    p = argparse.ArgumentParser(prog="scp_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="closed-loop simulation")
    pr.add_argument("--scenario", choices=["circle", "frog", "parallel"],
                    default="circle")
    pr.add_argument("--n-veh", type=int, default=0,
                    help="vehicle count (0 = scenario default: circle 8, "
                         "parallel 11)")
    pr.add_argument("--steps", type=int, default=0)
    pr.add_argument("--hp", type=int, default=0)
    pr.add_argument("--mc", type=int, default=1,
                    help="Monte-Carlo batch size over the plant noise")
    pr.add_argument("--noise", action="store_true")
    pr.add_argument("--controller", choices=["scp", "side_selection"],
                    default="scp")
    pr.add_argument("--rect-obstacles", action="store_true",
                    help="obstAsQCQP=0: rotated-rectangle obstacle faces "
                         "(side_selection controller)")
    pr.add_argument("--kkt", choices=["dense", "banded", "auto"],
                    default="",
                    help="inner-QP KKT formulation override (default: "
                         "the tuned-config choice; 'banded' forces the "
                         "Riccati path; SCP controller only: no effect "
                         "with --controller side_selection)")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--f64", action="store_true",
                    help="float64 (with --cpu only: the kernels are "
                         "float32)")
    pr.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device)")
    pr.add_argument("--out", default="")
    pr.add_argument("--export-json", default="")
    pr.add_argument("--export-instance", type=int, default=0,
                    help="with --mc > 1: which batch instance the "
                         "reference-format JSON export slices out")
    pr.add_argument("--frames", default="")
    pr.add_argument("--plot", action="store_true",
                    help="live per-step rendering while the loop runs "
                         "(the original online plot); combine with "
                         "--frames to also save per-step PNGs")
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("sweep", help="sharded batch sweep w/ checkpoints")
    ps.add_argument("--scenario", choices=["circle", "frog", "parallel"],
                    default="circle")
    ps.add_argument("--batch", type=int, default=256)
    ps.add_argument("--n-veh", type=int, default=0)
    ps.add_argument("--steps", type=int, default=0)
    ps.add_argument("--hp", type=int, default=0)
    ps.add_argument("--controller", choices=["scp", "side_selection"],
                    default="scp")
    ps.add_argument("--rect-obstacles", action="store_true",
                    help="obstAsQCQP=0: rotated-rectangle obstacle faces "
                         "(side_selection controller)")
    ps.add_argument("--n-model", type=int, default=1,
                    help="mesh model-axis size (1 = pure data parallel)")
    ps.add_argument("--batched", action="store_true",
                    help="straggler-repacked batched stepping per shard "
                         "(the bench's path; incompatible with "
                         "--n-model > 1)")
    ps.add_argument("--kkt", choices=["dense", "banded", "auto"],
                    default="")
    ps.add_argument("--checkpoint", default="")
    ps.add_argument("--checkpoint-every", type=int, default=0)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--f64", action="store_true",
                    help="float64 (with --cpu only: the kernels are "
                         "float32)")
    ps.add_argument("--cpu", action="store_true",
                    help="run on the CPU under gloo (default: the CUDA "
                         "device under NCCL)")
    ps.set_defaults(fn=cmd_sweep)

    pb = sub.add_parser("bench", help="throughput benchmark (one GPU)")
    pb.add_argument("--batch", type=int, default=512)
    pb.add_argument("--hp", type=int, default=20)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    if args.cmd in ("run", "sweep") and args.f64 and not args.cpu:
        (pr if args.cmd == "run" else ps).error(
            "--f64 runs on the CPU only: the CUDA kernels are float32, so "
            "a float64 run on the card would fail at its first launch; add "
            "--cpu")
    return args.fn(args)


if __name__ == "__main__":
    main()
