#!/usr/bin/env python3
"""Quick GPU check of the fused IPM and Riccati kernels of ``scp_tpu_torch``.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 scripts/torch_kernel_check.py                 # build + compare
    python3 scripts/torch_kernel_check.py --dump out.npz  # K1 outputs
    python3 scripts/torch_kernel_check.py --compare a.npz b.npz
    python3 scripts/torch_kernel_check.py --times         # K2/K3/K5a/K6/K7
    python3 scripts/torch_kernel_check.py --sections      # K3's cycles

The default mode builds the kernel library (printing ``ptxas -v``), runs the
dense-G IPM iteration (K2) and the Riccati factor / solve (K6 / K7) once on
seeded inputs at a few shapes and prints, per case, the largest difference
from the plain PyTorch version on the same inputs; then the batched
Cholesky (K3) and the G product (K5a) at their boundary shapes (n across
the factor's panel edges, one indefinite instance; unaligned instance
bases, a tile larger than one stage, rows wider than a stage) against
the plain version and a float64 oracle. ``--dump`` writes the
structured kernel's (K1) outputs on fixed seeded inputs; ``--compare``
reports whether two such dumps (e.g. from two checkouts, each run with its
own copy of this script) are bit-identical. ``--times`` times K6 / K7 (B =
256 / 64 / 16, V = 4, K = 64), K2 (frog's shape, B = 1024 / 256 / 64),
K3 (n = 81, B = 1024 / 256 / 64 / 1, with its thread count varied) and
K5a (m = 120, n = 81 at B = 1024 / 256 / 64 and the P shape m = n = 81 at
B = 1024, with its stage and grid target varied), beside ``torch.linalg.
cholesky_ex`` / ``torch.bmm``, on seeded inputs three ways, twice over: the
profiler's device time summed per call, the mean duration of the kernel's
recorded events with their count, and CUDA events around the replay of a
CUDA graph of the calls (no host time between launches). ``--sections``
builds the library with ``-DSCP_PROFILE_SECTIONS`` and prints where block
0 of the blocked factor spends its clock cycles (load, diagonal blocks,
panel rows, trailing updates with the next diagonal block, store) at
n = 81, B = 1 and 1024, for each thread count.
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
    check_linalg_kernels()


def _spd(rng, B, n, dev):
    a = rng.normal(size=(B, n, n))
    return torch.as_tensor(a @ a.transpose(0, 2, 1) / n + np.eye(n),
                           dtype=torch.float32, device=dev)


def check_linalg_kernels() -> None:
    """K3 and K5a at their boundary shapes. Limits: the factor's residual
    max|L L^T - K| within 2e-5 of max|K| and both kernels no further from
    the float64 oracle than twice the plain float32 version plus 1e-5 of
    the result's scale (``chip_smoke.py``'s limits)."""
    from scp_tpu_torch.ops import linalg, linalg_kernel as lk
    dev = "cuda"
    rng = np.random.default_rng(4)
    bad = []
    for n in (1, lk.CHOL_PANEL - 1, lk.CHOL_PANEL, lk.CHOL_PANEL + 1, 32,
              33, 81, 239):
        for B in (1, 3, 1023):
            if n == 239 and B == 1023:
                B = 257
            K = _spd(rng, B, n, dev)
            if B == 3:
                K[1, n // 2, n // 2] = -1.0  # one indefinite instance
            L_k = lk.cholesky(K)
            L_p = linalg.cholesky_plain(K)
            L_d = linalg.cholesky_plain(K.double())
            torch.cuda.synchronize()
            ok = torch.isfinite(L_d).all(dim=(1, 2))
            nan_ok = bool((torch.isfinite(L_k).all(dim=(1, 2)) == ok).all()
                          and torch.isnan(L_k[~ok]).all())
            Lk, Lp, Ld = (torch.tril(t[ok]).double() for t in (L_k, L_p, L_d))
            resid = float((Lk @ Lk.transpose(1, 2) - K[ok].double())
                          .tril().abs().max())
            e_kd = float((Lk - Ld).abs().max())
            e_pd = float((Lp - Ld).abs().max())
            upper = float(torch.triu(L_k[ok], 1).abs().max())
            rep = {"case": f"cholesky_B{B}_n{n}", "geometry":
                   list(lk.chol_geometry(B, n)), "residual": resid,
                   "kernel_vs_f64": e_kd, "plain_vs_f64": e_pd,
                   "kernel_vs_plain": float((Lk - Lp).abs().max()),
                   "upper_zero": upper == 0.0, "nan_instances_ok": nan_ok}
            print(json.dumps(rep), flush=True)
            if (not nan_ok or upper != 0.0
                    or resid > 2e-5 * float(K[ok].abs().max())
                    or e_kd > 2 * e_pd + 1e-5 * float(Ld.abs().max())):
                bad.append(rep["case"])
    flat = torch.as_tensor(rng.normal(size=1024 * 120 * 81 + 1),
                           dtype=torch.float32, device=dev)
    cases = {"gmv_path_B1024_m120_n81": (1024, 120, 81, None),
             "gmv_P_shape_B1024_m81_n81": (1024, 81, 81, None),
             "gmv_view_base_4_bytes_past_16": (64, 81, 81, flat),
             "gmv_above_one_stage_B3_m900_n65": (3, 900, 65, None),
             "gmv_B1_m120_n81": (1, 120, 81, None),
             "gmv_odd_B3_m45_n31": (3, 45, 31, None),
             "gmv_row_one_column_past_a_stage_B2_m3":
                 (2, 3, lk.GMV_STAGE_BYTES // 4 - 2, None),
             "gmv_row_of_60000_B2_m3": (2, 3, 60000, None)}
    for case, (B, m, n, base) in cases.items():
        if base is None:
            G = torch.as_tensor(rng.normal(size=(B, m, n)),
                                dtype=torch.float32, device=dev)
        else:
            G = base[1:1 + B * m * n].view(B, m, n)
        x = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32,
                            device=dev)
        o_k, o_p = lk.gmv(G, x), linalg.gmv_plain(G, x)
        o_d = linalg.gmv_plain(G.double(), x.double())
        torch.cuda.synchronize()
        scale = float(o_d.abs().max())
        e_kd = float((o_k.double() - o_d).abs().max())
        e_pd = float((o_p.double() - o_d).abs().max())
        e_kp = float((o_k - o_p).abs().max())
        rep = {"case": case, "geometry": list(lk.gmv_geometry(B, m, n)),
               "base_mod_16": G.data_ptr() % 16, "kernel_vs_plain": e_kp,
               "kernel_vs_f64": e_kd, "plain_vs_f64": e_pd, "scale": scale}
        print(json.dumps(rep), flush=True)
        if e_kd > 2 * e_pd + 1e-5 * scale or e_kp > 2e-5 * scale:
            bad.append(case)
    print(json.dumps({"linalg_cases_failed": bad}), flush=True)
    if bad:
        sys.exit(1)


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
    from scp_tpu_torch.ops import _cuda_build, ipm_kernel, riccati_kernel
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
        linalg_times(rnd, K, dev)
    print(card.strip())


def linalg_times(rnd, K, dev) -> None:
    """K3 and K5a at their path shapes beside the library call, the first
    with each thread count and the second with each stage tried."""
    from scp_tpu_torch.ops import linalg_kernel as lk
    rng = np.random.default_rng(5)
    G = torch.as_tensor(rng.normal(size=(1024, 120, 81)), dtype=torch.float32,
                        device=dev)
    P = torch.as_tensor(rng.normal(size=(1024, 81, 81)), dtype=torch.float32,
                        device=dev)
    x = torch.as_tensor(rng.normal(size=(1024, 81)), dtype=torch.float32,
                        device=dev)
    saved = (lk.CHOL_FEW_INSTANCES, lk.CHOL_FEW_THREADS,
             lk.GMV_STAGE_BYTES, lk.GMV_MIN_CTAS)
    try:
        for w in (1024, 256, 64, 1):
            Kw = K[:w].contiguous()
            # (cholesky_ex: the same factor without the host check of its
            # info, which a CUDA graph cannot capture)
            print(json.dumps({"round": rnd,
                              "kernel": "torch.linalg.cholesky_ex",
                              "B": w, **_time_three_ways(
                                  lambda: torch.linalg.cholesky_ex(Kw))}),
                  flush=True)
            for threads in (128, 256):
                lk.CHOL_FEW_INSTANCES, lk.CHOL_FEW_THREADS = 1 << 30, threads
                print(json.dumps({
                    "round": rnd, "kernel": "cholesky", "B": w,
                    "geometry": list(lk.chol_geometry(w, 81)),
                    **_time_three_ways(lambda: lk.cholesky(Kw))}),
                    flush=True)
            lk.CHOL_FEW_INSTANCES, lk.CHOL_FEW_THREADS = saved[:2]
        for name, A, widths in (("G", G, (1024, 256, 64)), ("P", P, (1024,))):
            for w in widths:
                Aw, xw = A[:w].contiguous(), x[:w].contiguous()
                print(json.dumps({"round": rnd, "kernel": "torch.bmm",
                                  "shape": name, "B": w, **_time_three_ways(
                                      lambda: torch.bmm(Aw, xw[:, :, None]))}),
                      flush=True)
                for stage in (32 << 10, 16 << 10):
                    for min_ctas in (528, 1056, 2112):
                        lk.GMV_STAGE_BYTES, lk.GMV_MIN_CTAS = stage, min_ctas
                        print(json.dumps({
                            "round": rnd, "kernel": "gmv", "shape": name,
                            "B": w, "stage": stage, "min_ctas": min_ctas,
                            "geometry": list(
                                lk.gmv_geometry(w, *Aw.shape[1:])),
                            **_time_three_ways(lambda: lk.gmv(Aw, xw))}),
                            flush=True)
    finally:
        (lk.CHOL_FEW_INSTANCES, lk.CHOL_FEW_THREADS, lk.GMV_STAGE_BYTES,
         lk.GMV_MIN_CTAS) = saved


def k3_sections() -> None:
    import ctypes
    import subprocess
    from scp_tpu_torch.ops import _cuda_build, linalg_kernel as lk
    _cuda_build.BUILD_DEFINES = ("SCP_PROFILE_SECTIONS",)
    lib = _cuda_build.load_library()
    lib.chol_read_sections.argtypes = [ctypes.c_void_p]
    lib.chol_read_sections.restype = ctypes.c_int
    names = ("load", "first_diagonal_block", "panel_rows",
             "trailing_and_next_diagonal_block", "store")
    buf = (ctypes.c_ulonglong * 8)()
    rng = np.random.default_rng(6)
    saved = (lk.CHOL_FEW_INSTANCES, lk.CHOL_FEW_THREADS)
    try:
        for B in (1, 1024):
            K = _spd(rng, B, 81, "cuda")
            for threads in (128, 256):
                lk.CHOL_FEW_INSTANCES, lk.CHOL_FEW_THREADS = 1 << 30, threads
                lk.cholesky(K)
                torch.cuda.synchronize()
                lib.chol_read_sections(buf)
                reps = 10
                for _ in range(reps):
                    lk.cholesky(K)
                torch.cuda.synchronize()
                if lib.chol_read_sections(buf) != 0:
                    sys.exit("reading the section counters failed")
                cyc = {k: buf[i] / reps for i, k in enumerate(names)}
                print(json.dumps({"B": B, "n": 81, "threads": threads,
                                  "block0_cycles": sum(cyc.values()),
                                  "cycles": cyc}), flush=True)
    finally:
        lk.CHOL_FEW_INSTANCES, lk.CHOL_FEW_THREADS = saved
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dump", metavar="PATH")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--sections", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.dump:
        dump_k1(args.dump)
    elif args.compare:
        compare(*args.compare)
    elif args.times:
        kernel_times()
    elif args.sections:
        k3_sections()
    else:
        check_new_kernels()


if __name__ == "__main__":
    main()
