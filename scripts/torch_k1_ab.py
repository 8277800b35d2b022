#!/usr/bin/env python3
"""K1's (or K2's) shared-memory tier, for comparing two checkouts.

Run from the root of each checkout on a machine with an NVIDIA GPU (the
parent unpacked into a git-ignored directory, this script given by path)::

    python3 /path/to/scripts/torch_k1_ab.py parent OUT   # in the parent
    python3 /path/to/scripts/torch_k1_ab.py change OUT   # in the change
    python3 scripts/torch_k1_ab.py --compare OUT/sass_parent.txt OUT/sass_change.txt
    python3 /path/to/scripts/torch_k1_ab.py parent OUT k2   # K2's

The first form builds the checkout's kernel library, times the structured
IPM kernel (K1) in the tier its shape takes at P = 6, hp = hu = 20, V = 4,
B = 1,024, 7 iterations, seeded inputs, by CUDA-graph replay (10 launches
a graph, 5 replays; six readings), prints one JSON line, and writes the
opcodes of the SASS of K1's shared-tier kernel (``cuobjdump -sass``) to
``OUT/sass_<name>.txt``. With ``k2`` it times the dense-G kernel (K2) on
one frog QP (mg = 440, n = 21, 7 iterations) at B = 1,024 and 256 (the
launch bounds of four and two CTAs an SM that ``dense_min_ctas`` picks
there) and writes the opcodes of its two shared-tier instantiations with
G in shared memory to ``OUT/sass_<name>_k2_<bound>.txt``. ``--compare``
prints the two opcode counts, their similarity ratio and the number of
differing blocks (``difflib``). Run parent, change, change, parent in one
call.
"""
import difflib
import json
import os
import re
import subprocess
import sys

import torch


def graph_ms(fn, reps=10, replays=5):
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


def sass_ops(lib, want) -> list:
    """The opcodes of the first SASS function of ``lib`` whose mangled name
    satisfies ``want``."""
    sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                           str(lib)], capture_output=True, text=True).stdout
    mine = [f for f in sass.split("Function : ") if want(f.split("\n")[0])]
    ops = []
    for line in mine[0].split("\n")[1:] if mine else []:
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m:
            ops.append(m.group(2))
    return ops


def measure_k2(name: str, out_dir: str) -> None:
    sys.path.insert(0, os.getcwd())
    from scp_tpu_torch.ops import _cuda_build, ipm_kernel
    from scp_tpu_torch.testing import DENSE_ARG_ORDER, dense_kernel_inputs
    lib = _cuda_build.build_library()
    a = dense_kernel_inputs(1024, 440, 1, 20, seed=440)
    t = [None if a[k] is None else torch.as_tensor(a[k], device="cuda")
         for k in DENSE_ARG_ORDER]
    kw = dict(n_iters=7, tol=1e-6, reg_rel=3e-6, n_cor=0, schur_slack=True)
    rep = {"who": name, "kernel": "k2"}
    for B in (1024, 256):
        tb = [None if x is None else x[:B].contiguous() for x in t]
        rep[f"ms_B{B}"] = [
            graph_ms(lambda: ipm_kernel.ipm_iterate_dense(*tb, **kw))
            for _ in range(6)]
    for bound in (4, 2):
        ops = sass_ops(lib, lambda h, b=bound: "ipm_dense_kernel" in h
                       and f"ILb1ELi{b}E" in h and "cluster" not in h)
        with open(os.path.join(out_dir, f"sass_{name}_k2_{bound}.txt"),
                  "w") as f:
            f.write("\n".join(ops))
        rep[f"sass_instructions_{bound}"] = len(ops)
    print(json.dumps(rep))


def measure(name: str, out_dir: str) -> None:
    sys.path.insert(0, os.getcwd())
    from scp_tpu_torch.ops import _cuda_build, ipm_kernel
    from scp_tpu_torch.testing import kernel_inputs, torch_kernel_args
    lib = _cuda_build.build_library()
    arrs, pairs, ov = kernel_inputs(B=1024, V=4, hp=20, hu=20, n_obst=0,
                                    seed=1)
    args = torch_kernel_args(arrs, device="cuda")
    kw = dict(pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6, n_cor=0,
              n_iters=7, lower_tri=True)
    ms = [graph_ms(lambda: ipm_kernel.ipm_iterate_struct(*args, **kw))
          for _ in range(6)]
    # the structured kernel's shared-memory instantiation (a parent without
    # the tiers has one, untemplated)
    ops = sass_ops(lib, lambda h: "ipm_struct_kernel" in h
                   and "ILb1" not in h)
    with open(os.path.join(out_dir, f"sass_{name}.txt"), "w") as f:
        f.write("\n".join(ops))
    print(json.dumps({"who": name, "ms": ms, "sass_instructions": len(ops)}))


def compare(path_a: str, path_b: str) -> None:
    a = open(path_a).read().split()
    b = open(path_b).read().split()
    sm = difflib.SequenceMatcher(None, a, b, autojunk=False)
    print("sass opcodes", len(a), len(b), "ratio", round(sm.ratio(), 5),
          "differing blocks",
          sum(1 for t in sm.get_opcodes() if t[0] != "equal"))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--compare"]:
        compare(*sys.argv[2:4])
    elif not torch.cuda.is_available():
        sys.exit("no CUDA device")
    elif sys.argv[3:4] == ["k2"]:
        measure_k2(*sys.argv[1:3])
    else:
        measure(*sys.argv[1:3])
