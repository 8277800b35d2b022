#!/usr/bin/env python3
"""Quick GPU check of the fused IPM and Riccati kernels of ``scp_tpu_torch``.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 scripts/torch_kernel_check.py                 # build + compare
    python3 scripts/torch_kernel_check.py --dump out.npz  # K1 outputs
    python3 scripts/torch_kernel_check.py --compare a.npz b.npz
    python3 scripts/torch_kernel_check.py --times         # K2/K6/K7 timing

The default mode builds the kernel library (printing ``ptxas -v``), runs the
dense-G IPM iteration (K2) and the Riccati factor / solve (K6 / K7) once on
seeded inputs at a few shapes and prints, per case, the largest difference
from the plain PyTorch version on the same inputs. ``--dump`` writes the
structured kernel's (K1) outputs on fixed seeded inputs; ``--compare``
reports whether two such dumps (e.g. from two checkouts, each run with its
own copy of this script) are bit-identical. ``--times`` times K6 / K7 (B =
256 / 64 / 16, V = 4, K = 64), K2 (frog's shape, B = 1024 / 256 / 64) and
K3 (n = 81, B = 1024) on seeded inputs three ways, twice over: the
profiler's device time summed per call, the mean duration of the kernel's
recorded events with their count, and CUDA events around the replay of a
CUDA graph of the calls (no host time between launches).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K1_CASES = (  # (B, V, hp, hu, n_obst, seed, hard_rows, n_cor, lower_tri)
    (256, 4, 20, 20, 0, 1, False, 0, True),
    (64, 3, 6, 8, 2, 7, True, 1, True),
    (32, 3, 7, 10, 1, 9, False, 2, False),
)


def dump_k1(path: str) -> None:
    from scp_tpu_torch.ops import ipm_kernel
    from scp_tpu_torch.testing import kernel_inputs, torch_kernel_args
    out = {}
    for i, (B, V, hp, hu, no, seed, hard, n_cor, tri) in enumerate(K1_CASES):
        arrs, pairs, ov = kernel_inputs(B=B, V=V, hp=hp, hu=hu, n_obst=no,
                                        seed=seed, hard_rows=hard)
        args = torch_kernel_args(arrs, device="cuda")
        res = ipm_kernel.ipm_iterate_struct(
            *args, pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6,
            n_cor=n_cor, n_iters=7, lower_tri=tri)
        torch.cuda.synchronize()
        for j, t in enumerate(res):
            out[f"case{i}_out{j}"] = t.cpu().numpy()
    np.savez(path, **out)
    print(json.dumps({"dumped": path, "arrays": len(out)}))


def compare(a: str, b: str) -> None:
    da, db = np.load(a), np.load(b)
    same = sorted(da.files) == sorted(db.files) and all(
        np.array_equal(da[k], db[k], equal_nan=True) for k in da.files)
    worst = max(float(np.nanmax(np.abs(da[k] - db[k]))) for k in da.files)
    print(json.dumps({"bit_identical": same, "max_abs_diff": worst,
                      "arrays": len(da.files)}))
    if not same:
        sys.exit(1)


def check_new_kernels() -> None:
    from scp_tpu_torch.ops import (_cuda_build, ipm_kernel, riccati,
                                   riccati_kernel)
    from scp_tpu_torch.testing import (DENSE_ARG_ORDER, dense_kernel_inputs,
                                       riccati_inputs)
    _cuda_build.build_library(verbose=True)
    dev = "cuda"
    worst = 0.0
    for B, V, K in ((256, 4, 64), (3, 3, 9), (16, 1, 20)):
        t = {k: torch.as_tensor(v, device=dev)
             for k, v in riccati_inputs(B, V, K, seed=V).items()}
        fk = riccati_kernel.riccati_factor(t["a_blk"], t["b_blk"], t["hy"],
                                           t["hu"])
        fp = riccati.riccati_factor_plain(t["a_blk"], t["b_blk"], t["hy"],
                                          t["hu"])
        duk = riccati_kernel.riccati_solve(*fk, t["a_blk"], t["b_blk"],
                                           t["r"])
        dup = riccati.riccati_solve_plain(*fp, t["a_blk"], t["b_blk"],
                                          t["r"])
        torch.cuda.synchronize()
        rep = {"case": f"riccati_B{B}_V{V}_K{K}"}
        for name, a, b in (("f", fk[0], fp.f), ("lh", fk[1], fp.lh),
                           ("kg", fk[2], fp.kg), ("du", duk, dup)):
            e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            rep[f"{name}_rel_err"] = e
            worst = max(worst, e)
        print(json.dumps(rep), flush=True)
    for B, mg, nb, d, schur, blocks in ((1024, 440, 1, 20, True, True),
                                        (64, 440, 1, 20, False, True),
                                        (3, 45, 2, 7, True, False),
                                        (8, 900, 4, 16, True, True)):
        a = dense_kernel_inputs(B, mg, nb, d, seed=mg, schur=schur,
                                blocks=blocks)
        args = [None if a[k] is None else torch.as_tensor(a[k], device=dev)
                for k in DENSE_ARG_ORDER]
        kw = dict(tol=1e-6, reg_rel=3e-6, n_cor=1, schur_slack=schur)
        ok = ipm_kernel.ipm_iterate_dense(*args, **kw)
        op = ipm_kernel.ipm_iterate_dense_plain(*args, **kw)
        torch.cuda.synchronize()
        e = max(float((x - y)[:, :-1].abs().max()) for x, y in
                zip(ok[:1] + ok[4:], op[:1] + op[4:]))
        worst = max(worst, e)
        print(json.dumps({"case": f"dense_B{B}_mg{mg}_n{nb * d + 1}_"
                          f"schur{int(schur)}_blocks{int(blocks)}",
                          "max_abs_err": e}), flush=True)
    print(json.dumps({"worst": worst}))


def _time_three_ways(fn, reps=20) -> dict:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    out = {"profiler_ms_per_call": sum(e.device_time_total for e in kern)
           / 1e3 / reps,
           "events": {e.key[:40]: [e.count, e.device_time_total / 1e3
                                   / max(e.count, 1)] for e in kern}}
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    out["graph_ms_per_call"] = start.elapsed_time(end) / (5 * reps)
    return out


def kernel_times() -> None:
    from scp_tpu_torch.ops import (_cuda_build, ipm_kernel, linalg_kernel,
                                   riccati_kernel)
    from scp_tpu_torch.testing import (DENSE_ARG_ORDER, dense_kernel_inputs,
                                       riccati_inputs)
    _cuda_build.build_library()
    dev = "cuda"
    card = __import__("subprocess").run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    t = {k: torch.as_tensor(v, device=dev)
         for k, v in riccati_inputs(256, 4, 64, seed=4).items()}
    a = dense_kernel_inputs(1024, 440, 1, 20, seed=440)
    d_args = [None if a[k] is None else torch.as_tensor(a[k], device=dev)
              for k in DENSE_ARG_ORDER]
    d_kw = dict(tol=1e-6, reg_rel=3e-6, n_cor=0, schur_slack=True)
    K = torch.eye(81, device=dev).expand(1024, 81, 81).contiguous()
    K += 0.01 * torch.ones_like(K)
    for rnd in range(2):
        for w in (256, 64, 16):
            f_args = [t[k][:w].contiguous()
                      for k in ("a_blk", "b_blk", "hy", "hu")]
            fac = riccati_kernel.riccati_factor(*f_args)
            s_args = (*fac, f_args[0], f_args[1], t["r"][:w].contiguous())
            for name, fn in (
                    ("riccati_factor",
                     lambda: riccati_kernel.riccati_factor(*f_args)),
                    ("riccati_solve",
                     lambda: riccati_kernel.riccati_solve(*s_args))):
                print(json.dumps({"round": rnd, "kernel": name, "B": w,
                                  **_time_three_ways(fn)}), flush=True)
        for w in (1024, 256, 64):
            args = [None if x is None else x[:w].contiguous()
                    for x in d_args]
            print(json.dumps({
                "round": rnd, "kernel": "ipm_iterate_dense", "B": w,
                **_time_three_ways(
                    lambda: ipm_kernel.ipm_iterate_dense(*args, **d_kw))}),
                flush=True)
        print(json.dumps({"round": rnd, "kernel": "cholesky", "B": 1024,
                          **_time_three_ways(
                              lambda: linalg_kernel.cholesky(K))}),
              flush=True)
    print(card.strip())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dump", metavar="PATH")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--times", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.dump:
        dump_k1(args.dump)
    elif args.compare:
        compare(*args.compare)
    elif args.times:
        kernel_times()
    else:
        check_new_kernels()


if __name__ == "__main__":
    main()
