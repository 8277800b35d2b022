"""Where the fused IPM kernel (scp_tpu_torch) spends its cycles.

Run on a machine with an NVIDIA GPU, from the repository root::

    python3 scripts/torch_k1_sections.py                       # bench shape
    python3 scripts/torch_k1_sections.py --shapes ii l1_1280 l1_256 l2
    python3 scripts/torch_k1_sections.py --tier device --shapes bench
    python3 scripts/torch_k1_sections.py --times device cluster --shapes l1_1280 l2

Builds the kernel with ``-DSCP_PROFILE_SECTIONS``: block 0 (in the cluster
tier: rank 0 of instance 0) then adds up the clock cycles between section
marks (load, diagonal + border, KKT formation, Cholesky, right-hand sides,
triangular solves, vector algebra + slab matvecs, update, store). Runs it
on numpy-seeded data (``testing.kernel_inputs``) at the shapes named:

* ``bench``: P = 6, hp = hu = 20, V = 4, 7 iterations, B = 64 (one CTA per
  SM at most) and B = 1024 (several CTAs share an SM);
* ``ii``: path (ii)'s side-selection QP, parallel-11 (55 pairs, 66 single
  slabs, every fifth row hard), hp = hu = 10, B = 1,280 x 8 iterations;
* ``l1_1280`` / ``l1_256``: path (l1)'s, the same at hp = hu = 20,
  B = 1,280 x 8 and 256 x 12 iterations;
* ``l2``: path (l2)'s, circle-4 (6 pairs) at hp = hu = 64, B = 256 x 7.

``--tier`` forces the storage tier (``shared``, ``device`` or ``cluster``;
default: the one ``ipm_kernel.struct_tier`` picks for the shape).
``--times`` instead builds the library as the program does and times the
tiers named at each shape, in turns (first, second, second, first), by
CUDA-graph replay (3 launches a graph, 3 replays), and holds their outputs
bit for bit against each other. Otherwise it prints
one JSON line per shape and width with each section's share of block 0's
cycles, its cycles per iteration, and the same grouped: formation
(diagonal + border, KKT formation), factor, solves, step algebra
(right-hand sides, vector algebra + matvecs, update). Each mark is a block
barrier, so the counts are of an instrumented kernel (its time is printed
beside them).
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SECTIONS = ("load", "diag_border", "kkt_form", "cholesky", "rhs", "solves",
            "vector_matvec", "update", "store")
GROUPS = {"formation": ("diag_border", "kkt_form"), "factor": ("cholesky",),
          "solves": ("solves",),
          "step_algebra": ("rhs", "vector_matvec", "update")}
# name: (V, hp = hu, single slabs per vehicle, hard rows, [(B, iterations)])
SHAPES = {
    "bench": (4, 20, 0, False, [(64, 7), (1024, 7)]),
    "ii": (11, 10, 6, True, [(1280, 8)]),
    "l1_1280": (11, 20, 6, True, [(1280, 8)]),
    "l1_256": (11, 20, 6, True, [(256, 12)]),
    "l2": (4, 64, 0, False, [(256, 7)]),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tier", choices=("shared", "device", "cluster"))
    ap.add_argument("--shapes", nargs="+", choices=tuple(SHAPES),
                    default=["bench"])
    ap.add_argument("--times", nargs=2, metavar="TIER",
                    choices=("shared", "device", "cluster"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from scp_tpu_torch.ops import _cuda_build, ipm_kernel
    from scp_tpu_torch.testing import kernel_inputs, torch_kernel_args
    if args.times:
        time_tiers(args.times, args.shapes)
        return

    _cuda_build.BUILD_DEFINES = ("SCP_PROFILE_SECTIONS",)
    lib = _cuda_build.load_library()
    lib.ipm_struct_read_sections.argtypes = [ctypes.c_void_p]
    lib.ipm_struct_read_sections.restype = ctypes.c_int
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    buf = (ctypes.c_ulonglong * 16)()
    for name in args.shapes:
        V, h, n_obst, hard, widths = SHAPES[name]
        for B, n_iters in widths:
            arrs, pairs, ov = kernel_inputs(B=B, V=V, hp=h, hu=h,
                                            n_obst=n_obst, seed=1,
                                            hard_rows=hard)
            targs = torch_kernel_args(arrs, device="cuda")
            kw = dict(pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6,
                      n_cor=0, n_iters=n_iters, lower_tri=True)
            if args.tier is not None:
                kw["tier"] = args.tier
            tier = ipm_kernel.struct_tier(len(pairs), len(ov), h, h, V, True,
                                          args.tier)
            ipm_kernel.ipm_iterate_struct(*targs, **kw)          # warm
            torch.cuda.synchronize()
            if lib.ipm_struct_read_sections(buf) != 0:
                sys.exit("reading the section counters failed")
            reps = 3 if B * h * V > 100_000 else 5
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                ipm_kernel.ipm_iterate_struct(*targs, **kw)
            end.record()
            torch.cuda.synchronize()
            if lib.ipm_struct_read_sections(buf) != 0:
                sys.exit("reading the section counters failed")
            cyc = dict(zip(SECTIONS, (buf[i] / reps
                                      for i in range(len(SECTIONS)))))
            total = sum(cyc.values())
            grouped = {g: sum(cyc[n] for n in names)
                       for g, names in GROUPS.items()}
            print(json.dumps({
                "card": card, "shape": name, "B": B, "n_iters": n_iters,
                "P": len(pairs), "S": len(ov), "hp": h, "V": V,
                "tier": tier._asdict(),
                "ms_per_launch_instrumented": start.elapsed_time(end) / reps,
                "block0_cycles": total,
                "share": {n: round(c / total, 4) for n, c in cyc.items()},
                "cycles_per_iteration": {n: round(c / n_iters) for n, c in
                                         cyc.items()},
                "grouped_share": {g: round(c / total, 4)
                                  for g, c in grouped.items()},
                "grouped_cycles_per_iteration": {
                    g: round(c / n_iters) for g, c in grouped.items()}}),
                flush=True)


def graph_ms(fn, reps=3, replays=3):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * replays)


def time_tiers(tiers, shapes):
    """Device ms per launch of K1 forced into each of two tiers, in turns,
    and whether their outputs agree bit for bit."""
    from scp_tpu_torch.ops import ipm_kernel
    from scp_tpu_torch.testing import kernel_inputs, torch_kernel_args
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    for name in shapes:
        V, h, n_obst, hard, widths = SHAPES[name]
        for B, n_iters in widths:
            arrs, pairs, ov = kernel_inputs(B=B, V=V, hp=h, hu=h,
                                            n_obst=n_obst, seed=1,
                                            hard_rows=hard)
            targs = torch_kernel_args(arrs, device="cuda")
            kw = dict(pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6,
                      n_cor=0, n_iters=n_iters, lower_tri=True)
            outs = [ipm_kernel.ipm_iterate_struct(*targs, **kw, tier=t)
                    for t in tiers]
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(*outs))
            ms = {t: [] for t in tiers}
            for t in (tiers[0], tiers[1], tiers[1], tiers[0]):
                ms[t].append(graph_ms(
                    lambda t=t: ipm_kernel.ipm_iterate_struct(
                        *targs, **kw, tier=t)))
            rep = {"card": card, "shape": name, "B": B, "n_iters": n_iters,
                   "ms": ms, "bit_identical": same,
                   "tiers": {t: ipm_kernel.struct_tier(
                       len(pairs), len(ov), h, h, V, True, t)._asdict()
                       for t in tiers}}
            if "cluster" in tiers:
                rep["cluster_geometry"] = ipm_kernel.cluster_geometry(
                    len(pairs), len(ov), h, h, V)[:3:2]
            print(json.dumps(rep), flush=True)
            del targs, outs


if __name__ == "__main__":
    main()
