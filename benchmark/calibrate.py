"""Readings that the output check's limits are set from, on the card:
for each seed, the port runs the cell's batch through the window's first
steps (the steps the check samples), and the sampled instance-steps are
compared with the float64 reference (the program's readings) and, the
control, with the reference computed one precision step below the stated
one, layer by layer as the configuration's ``control`` says: float32 with
TF32 matrix products where TF32 reaches the layer's arithmetic, bfloat16
where it does not (the plant multiplies no matrices). Prints one JSON line
per seed and side with the worst gap and the third quartile of each
number, the verdict on them, and every per-instance gap. ``--fault`` reads the
program with a fault of ``harness/faults.py`` planted, on
``--fault-seeds``.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--fault phases_truncated \
        --fault-seeds 4 5 6] [--batch B]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seed: int, device, batch=None, control=False,
             fault=None) -> dict:
    """The program's (and with ``control`` the control's) per-instance
    gaps on the sampled instance-steps of ``seed``; ``fault`` (a name in
    ``harness.faults.FAULTS``) breaks the program's step first."""
    import torch

    from harness import check, faults
    from harness.program import Program, capture, capture_out
    from traffic.generate import generate

    mix, config = cell.mix, cell.config
    tensors = generate(config, mix, seed, device, batch)
    prog = Program(config, tensors)
    if fault:
        faults.FAULTS[fault](prog)
    sample = check.plan(seed, mix, prog.batch)
    carry, ep, caps = prog.carry0, 0, {}
    try:
        for k in range(max(sample) + 1):
            if ep == mix["episode_steps"]:
                carry, ep = prog.carry0, 0
            if k in sample:
                cap = {}
                with capture(prog, carry,
                             torch.as_tensor(sample[k], device=device), cap):
                    carry, out = prog.step(carry)
                cap["out"] = capture_out(out)
                caps[k] = cap
            else:
                carry, out = prog.step(carry)
            ep += 1
    finally:
        getattr(prog, "restore", lambda: None)()
    del prog, carry, out
    out = {"program": {}, "control": {}}
    first = config["phases"][0][0] if config.get("phases") else None
    for k, cap in sorted(caps.items()):
        ref = check.reference(config, tensors, cap)
        for n, g in check.step_gaps(config, mix, cap, ref, seed, k).items():
            out["program"].setdefault(n, []).extend(g.tolist())
        if first is not None:
            # how many instances each side ran past the first phase's cap
            for side, it in (("iters_past_first", cap["out"]["scp_iters"]),
                             ("ref_iters_past_first", ref["iters"])):
                out["program"].setdefault(side, []).append(
                    int((it > first).sum()))
        if control:
            side = control_outputs(config, tensors, cap)
            for n, g in check.step_gaps(config, mix, cap, ref, seed, k,
                                        side=side).items():
                out["control"].setdefault(n, []).extend(g.tolist())
    return out


def control_outputs(config: dict, tensors: dict, cap: dict) -> dict:
    """The control's outputs: the reference in the program's place, each
    layer in the precision one step below the stated one that reaches its
    arithmetic (``config["control"]``: ``tf32``, float32 with TF32
    products; ``bfloat16``)."""
    import torch

    from harness import check

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        low = {"tf32": check.reference(config, tensors, cap,
                                       dtype=torch.float32)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    low["bfloat16"] = check.reference(config, tensors, cap,
                                      dtype=torch.bfloat16, controller=False)
    by = config["control"]
    return {**{n: low[by["pre"]][n] for n in check.PRE_KEYS},
            "qp_x": low[by["qp"]]["qp_x"],
            "u_pred": low[by["ctrl"]]["u_pred"],
            "state_next": low[by["plant"]]["state_next"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--fault", default=None,
                    help="a fault of harness/faults.py planted in the program")
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--instances", type=int, default=None,
                    help="instances sampled a step (default: the mix's)")
    args = ap.parse_args(argv)
    for path in (ROOT, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from harness import cells, check

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    if args.instances:
        cell.mix["check"]["instances"] = args.instances
    runs = [(s, None) for s in args.seeds] + [
        (s, args.fault) for s in args.fault_seeds]
    for seed, fault in runs:
        t0 = time.time()
        r = readings(cell, seed, torch.device("cuda"), args.batch,
                     control=fault is None and seed in args.control_seeds,
                     fault=fault)
        for side, per in r.items():
            if per:
                print(json.dumps({
                    "cell": cell.name, "seed": seed,
                    "side": f"fault:{fault}" if fault else side,
                    "worst": {n: max(v, default=None)
                              for n, v in per.items()},
                    "q3": check.reduce(per),
                    "verdict": check.verdict(check.reduce(per),
                                             check.limits(cell.config)),
                    "per_instance": per,
                    "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
