"""Where the fused IPM kernel (scp_tpu_torch) spends its cycles.

Run on a machine with an NVIDIA GPU, from the repository root::

    python3 scripts/torch_k1_sections.py

Builds the kernel with ``-DSCP_PROFILE_SECTIONS``: block 0 then adds up the
clock cycles between section marks (load, diagonal + border, KKT formation,
Cholesky, right-hand sides, triangular solves, vector algebra + slab
matvecs, update, store). Runs it on numpy-seeded data at the bench shape
(P = 6, hp = hu = 20, V = 4, 7 iterations) at B = 64 (one CTA per SM at
most) and B = 1024 (several CTAs share an SM), and prints one JSON line per
batch width with each section's share of block 0's cycles, its cycles per
iteration, and the same grouped: formation (diagonal + border, KKT
formation), factor, solves, step algebra (right-hand sides, vector algebra
+ matvecs, update). Each mark is a block barrier, so the counts are of an
instrumented kernel (its time is printed beside them).
"""
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


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from scp_tpu_torch.ops import _cuda_build, ipm_kernel
    from scp_tpu_torch.testing import kernel_inputs, torch_kernel_args

    _cuda_build.BUILD_DEFINES = ("SCP_PROFILE_SECTIONS",)
    lib = _cuda_build.load_library()
    lib.ipm_struct_read_sections.argtypes = [ctypes.c_void_p]
    lib.ipm_struct_read_sections.restype = ctypes.c_int
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    buf = (ctypes.c_ulonglong * 16)()
    for B in (64, 1024):
        arrs, pairs, ov = kernel_inputs(B=B, V=4, hp=20, hu=20, n_obst=0,
                                        seed=1)
        args = torch_kernel_args(arrs, device="cuda")
        kw = dict(pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6, n_cor=0,
                  n_iters=7, lower_tri=True)
        ipm_kernel.ipm_iterate_struct(*args, **kw)          # warm
        torch.cuda.synchronize()
        if lib.ipm_struct_read_sections(buf) != 0:
            sys.exit("reading the section counters failed")
        reps = 5
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            ipm_kernel.ipm_iterate_struct(*args, **kw)
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
            "card": card, "B": B, "n_iters": 7,
            "ms_per_launch_instrumented": start.elapsed_time(end) / reps,
            "block0_cycles": total,
            "share": {n: round(c / total, 4) for n, c in cyc.items()},
            "cycles_per_iteration": {n: round(c / 7) for n, c in
                                     cyc.items()},
            "grouped_share": {g: round(c / total, 4)
                              for g, c in grouped.items()},
            "grouped_cycles_per_iteration": {g: round(c / 7)
                                             for g, c in grouped.items()}}),
            flush=True)


if __name__ == "__main__":
    main()
