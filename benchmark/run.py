"""Run one cell of the PyTorch/CUDA port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is ``workloads/<cell>.json``; its
configuration, traffic mix and per-layer metric readers are found by name
(``configs/``, ``traffic/``, ``metrics/``) and its metrics in
``BENCHMARK.json``. The last line of standard output is the result (one
JSON object); the last lines of standard error name each number the output
check compared beside its limit. Exits non-zero, printing no result, when
no CUDA device (or fewer than the cell asks for) is present, or when JAX,
``jaxlib``, ``flax`` or the JAX package ``scp_tpu`` was loaded.
"""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the wall clock (``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "scp_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's, ``jaxlib``, ``flax`` or
    the JAX package's (compared whole: ``scp_tpu_torch`` is the port)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for path in (ROOT, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    import torch

    from harness import cells, check, runner

    # one host thread: the window's host work is one Python thread issuing
    # launches, and idle pool threads only contend with it for cores
    torch.set_num_threads(1)

    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the port on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", T_START, cells.benchmark_json(ROOT))
    bad = forbidden_modules()
    if bad:
        print("loaded in the benchmark's process: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, entry in result["check"].items():
        what = check.WHAT.get(name, "instance-steps with an error or "
                                    "outputs not finite")
        print(f"{name} = {entry['value']} (limit {entry['limit']}): {what}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
