#!/usr/bin/env python3
"""Quick GPU check of the fused IPM, linear-algebra and Riccati kernels of
``scp_tpu_torch``.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 scripts/torch_kernel_check.py                 # build + compare
    python3 scripts/torch_kernel_check.py --dump out.npz  # K1 outputs
    python3 scripts/torch_kernel_check.py --dump b.npz --inputs a.npz
    python3 scripts/torch_kernel_check.py --compare a.npz b.npz
    python3 scripts/torch_kernel_check.py --times         # every kernel
    python3 scripts/torch_kernel_check.py --times k1 k4   # some of them
    python3 scripts/torch_kernel_check.py --sections      # K3's cycles
    python3 scripts/torch_kernel_check.py --sections k6k7 # K6 / K7's
    python3 scripts/torch_kernel_check.py --pivots        # K6 / K7's pivots

The default mode builds the kernel library (printing ``ptxas -v``), runs the
structured IPM kernel (K1) on seeded inputs at the bench shape and two odd
ones and on an instance whose KKT matrix is not positive definite, the
dense-G IPM iteration (K2) and the Riccati factor / solve (K6 / K7; V = 1
to 21 across the register kernels' last width V = 5 and the generic ones,
one and two right-hand sides) once on seeded inputs at a few shapes, and
prints, per case, the difference from the plain PyTorch version on the same
inputs; then the batched Cholesky (K3),
the Cholesky solve (K4) and the G products (K5a, K5b) at their boundary
shapes (n across the 16-column panels and blocks and past the shared-memory
kernels: 239, 240, 257, 400; an indefinite instance or a NaN factor among
good ones; unaligned instance bases, a tile larger than one stage, the
hp = 64 shape, rows wider than a stage; K5b twice on the same inputs, bit
for bit) against the plain version and a float64 oracle. ``--dump`` writes
K1's outputs on fixed seeded inputs (and K2's, K3's and K4's, the kernels
on the same blocked factor and solve);
``--compare`` reports whether two such dumps (e.g. from two checkouts,
each run with its own copy of this script) are bit-identical and, where
they are not, holds their controls to ``chip_smoke.py``'s kernel-vs-plain
limits (``U_ABS_LIMIT`` / ``U_MEDIAN_LIMIT``, twenty times wider on the
odd shapes, as there). ``--times`` times, on seeded inputs, K1 (the bench
shape, 7 iterations, B = 1024 / 256 / 64, with the CTAs one SM holds), K4
(n = 81 and K1's n = 80, B = 1024 / 256 / 64, with a warm and a cold L2,
for each thread count, beside ``torch.cholesky_solve``), K6 / K7 (V = 4,
K = 64, B = 256 / 64 / 16 / 1 and V = 16, B = 256; warm and cold L2; K7
with one and two right-hand sides, by graph replay), K2 (one QP of
frog's shape, 7 iterations, B = 1024 / 512 / 256 / 64, warm and cold L2,
at each of its two launch bounds), K5b (m = 120, n = 81 at B = 1024 / 256
/ 64 / 1 and the hp = 64 shape m = 384, n = 257 at B = 256, warm and cold,
beside ``torch.bmm``), ``k3k4large``: K3 and K4 at n = 240, 257 and 400
(warm and cold, beside ``torch.linalg.cholesky_ex`` /
``torch.cholesky_solve``), K3 (n = 81, B = 1024 / 256 / 64 / 1,
with its thread count varied) and K5a (m = 120, n = 81 at B = 1024 / 256 /
64 and the P shape m = n = 81 at B = 1024, with its stage and grid target
varied), beside ``torch.linalg.cholesky_ex`` / ``torch.bmm``, three ways,
twice over: the profiler's device time summed per call, the mean duration
of the kernel's recorded events with their count, and CUDA events around
the replay of a CUDA graph of the calls (no host time between launches).
Run against an older checkout (a copy of this script in its ``scripts/``),
the variants that checkout lacks are skipped. ``--sections`` builds the
library with ``-DSCP_PROFILE_SECTIONS`` and prints where block 0 of the
blocked factor spends its clock cycles (load, diagonal blocks, panel rows,
trailing updates with the next diagonal block, store) at n = 81, B = 1 and
1024, for each thread count; ``--sections k6k7`` the cycles of K6's and K7's
stage by section (thread 0 of block 0, per stage) at V = 4, B = 1 and 256,
and of the generic kernels at V = 16; ``--sections k2`` K2's cycles per
IPM iteration by section (block 0, one frog QP, B = 64 and 1024).
``--pivots`` compiles a test that
includes ``csrc/riccati.cu`` and holds its branch-free pivot square root and
reciprocal to ``__fsqrt_rn`` / ``__frcp_rn`` bit for bit on every float in
[1e-30, FLT_MAX] (the square root's domain; the reciprocal on its results).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (B, V, K): the long-horizon shape, odd and wide vehicle counts (V = 5 the
# widest register kernel, V = 6 the first generic one, W = 36 > 32)
RICCATI_CASES = ((256, 4, 64), (3, 3, 9), (16, 1, 20), (5, 2, 7),
                 (7, 5, 12), (9, 6, 10), (4, 16, 8), (2, 21, 5))

K1_CASES = (  # (B, V, hp, hu, n_obst, seed, hard_rows, n_cor, lower_tri)
    (256, 4, 20, 20, 0, 1, False, 0, True),
    (64, 3, 6, 8, 2, 7, True, 1, True),
    (32, 3, 7, 10, 1, 9, False, 2, False),
)


def capture_calibrated_k1(B: int = 1024) -> tuple:
    """K1's first full-width call of one calibrated step (``chip_smoke.py``'s
    main path: circle-4, hp = hu = 20, ``tuned_f32``, ``TUNED_F32_PHASES``,
    seed 42): its arguments (copies) and keywords."""
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.ops import ipm_kernel
    from scp_tpu_torch.scenarios import batch as batch_lib
    from scp_tpu_torch.sim import engine
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(42)
    cfg, data = batch_lib.make_batch("circle", B, generator=gen,
                                     dtype=torch.float32, device=dev,
                                     n_veh=4)
    cfg = config_lib.tuned_f32(cfg.replace(hp=20, hu=20))
    real = ipm_kernel.ipm_iterate_struct
    captured = []

    def spy(*args, **kw):
        if not captured and args[0].shape[0] == B:
            captured.append(([None if a is None else a.clone()
                              for a in args], kw))
        return real(*args, **kw)

    ipm_kernel.ipm_iterate_struct = spy
    try:
        engine.mpc_step_batch(cfg, data, engine.init_carry(cfg, data),
                              phases=config_lib.TUNED_F32_PHASES)
        torch.cuda.synchronize()
    finally:
        ipm_kernel.ipm_iterate_struct = real
    return captured[0]


def dump_k1(path: str, inputs: str | None = None) -> None:
    """K1's outputs on fixed seeded inputs (``K1_CASES``) and on the inputs
    of its first full-width call of a calibrated step, captured here or,
    with ``inputs``, read from another dump (so that two checkouts run K1
    on identical calibrated inputs)."""
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
    if inputs is None:
        args, kw = capture_calibrated_k1()
    else:
        d = np.load(inputs)
        kw = json.loads(str(d["cal_kw"]))
        kw["pairs"] = tuple(tuple(p) for p in kw["pairs"])
        kw["obst_veh"] = tuple(kw["obst_veh"])
        args = [None if f"cal_in{i}" not in d.files
                else torch.as_tensor(d[f"cal_in{i}"], device="cuda")
                for i in range(int(d["cal_n_in"]))]
    res = ipm_kernel.ipm_iterate_struct(*args, **kw)
    torch.cuda.synchronize()
    for i, a in enumerate(args):
        if a is not None:
            out[f"cal_in{i}"] = a.cpu().numpy()
    out["cal_n_in"] = np.array(len(args))
    out["cal_kw"] = np.array(json.dumps(kw))
    for j, t in enumerate(res):
        out[f"cal_out{j}"] = t.cpu().numpy()
    dump_shared_factor_kernels(out)
    np.savez(path, **out)
    print(json.dumps({"dumped": path, "arrays": len(out),
                      "calibrated_inputs_from": inputs or "this run"}))


def dump_shared_factor_kernels(out: dict) -> None:
    """The other kernels on the shared blocked factor and solve
    (``csrc/chol_blocked.cuh``), on seeded inputs: K3 and K4 at n = 33, 81
    and 239 (the shared-memory kernels), B = 1 and 1024, under the keys
    ``k3k4_*``, and K2 over one frog QP at B = 256 under ``k2_*``."""
    from scp_tpu_torch.ops import linalg_kernel as lk
    rng = np.random.default_rng(21)
    for n in (33, 81, 239):
        for B in (1, 1024):
            K = _spd(rng, B, n, "cuda")
            b = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32,
                                device="cuda")
            L = lk.cholesky(K)
            x = lk.cho_solve(L, b)
            torch.cuda.synchronize()
            out[f"k3k4_L_n{n}_B{B}"] = L.cpu().numpy()
            out[f"k3k4_x_n{n}_B{B}"] = x.cpu().numpy()
    res = dense_qp(_cut(dense_inputs("cuda"), 256))()
    torch.cuda.synchronize()
    for j, t in enumerate(res):
        out[f"k2_out{j}"] = t.cpu().numpy()


# chip_smoke.py's kernel-vs-plain limits on the controls (K1_CASES[0] is
# the bench shape; the others have a box of +-1 and twenty times the limits)
U_ABS_LIMIT = 5e-3
U_MEDIAN_LIMIT = 5e-5


def compare(a: str, b: str) -> None:
    da, db = np.load(a), np.load(b)
    same = sorted(da.files) == sorted(db.files) and all(
        np.array_equal(da[k], db[k], equal_nan=da[k].dtype.kind == "f")
        for k in da.files)
    worst = max(float(np.nanmax(np.abs(da[k] - db[k]))) for k in da.files
                if da[k].dtype.kind == "f")
    groups = {g: [k for k in da.files if k.startswith(g)]
              for g in ("case", "cal_out", "k3k4_", "k2_")}
    rep = {"bit_identical": same, "max_abs_diff": worst,
           "arrays": len(da.files),
           "bit_identical_by_kernel": {
               {"case": "k1_seeded", "cal_out": "k1_calibrated"}.get(g, g):
               bool(ks) and all(k in db.files and np.array_equal(
                   da[k], db[k], equal_nan=True) for k in ks)
               for g, ks in groups.items()},
           "controls": {}}
    ok = True
    for i, (B, V, hp, hu, *_rest) in enumerate(K1_CASES):
        nu = V * hu
        du = np.abs(da[f"case{i}_out0"][:, :nu]
                    - db[f"case{i}_out0"][:, :nu]).max(axis=1)
        scale = 1.0 if i == 0 else 20.0
        lim = (U_ABS_LIMIT * scale, U_MEDIAN_LIMIT * scale)
        fin = all(np.isfinite(d[k]).all() for d in (da, db)
                  for k in d.files if k.startswith(f"case{i}_"))
        flags = float(np.mean(da[f"case{i}_out10"][:, 1]
                              == db[f"case{i}_out10"][:, 1]))
        rep["controls"][f"case{i}"] = {
            "u_max": float(du.max()), "u_median": float(np.median(du)),
            "limits": lim, "finite": bool(fin), "frozen_flags_agree": flags}
        ok = ok and fin and du.max() <= lim[0] and np.median(du) <= lim[1]
    # the calibrated step's inputs (the bench shape, 7 iterations)
    if all(k in d.files for d in (da, db) for k in ("cal_out0", "cal_kw")):
        nu = da["cal_out0"].shape[1] - 1
        du = np.abs(da["cal_out0"][:, :nu] - db["cal_out0"][:, :nu]).max(1)
        outs = [k for k in da.files if k.startswith("cal_out")]
        ins = [k for k in da.files if k.startswith("cal_in")]
        fin = all(np.isfinite(d[k]).all() for d in (da, db) for k in outs)
        rep["controls"]["calibrated"] = {
            "inputs_identical": all(np.array_equal(da[k], db[k])
                                    for k in ins),
            "outputs_bit_identical": all(
                np.array_equal(da[k], db[k], equal_nan=True) for k in outs),
            "u_max": float(du.max()), "u_median": float(np.median(du)),
            "limits": (U_ABS_LIMIT, U_MEDIAN_LIMIT), "finite": bool(fin),
            "frozen_flags_agree": float(np.mean(
                da["cal_out10"][:, 1] == db["cal_out10"][:, 1]))}
        ok = (ok and fin and du.max() <= U_ABS_LIMIT
              and np.median(du) <= U_MEDIAN_LIMIT)
    rep["within_limits"] = bool(ok)
    print(json.dumps(rep))
    if not ok:
        sys.exit(1)


def check_k1() -> float:
    """K1 against its plain version on the same seeded inputs: the controls
    after 7 iterations (``chip_smoke.py``'s limits) and every variable after
    one (1e-4, round-off); then an instance whose KKT matrix is not positive
    definite must freeze (state kept, flag set) without touching the
    others, as the plain version does."""
    from scp_tpu_torch.ops import ipm_kernel
    from scp_tpu_torch.testing import kernel_inputs, torch_kernel_args
    worst, bad = 0.0, []
    for i, (B, V, hp, hu, no, seed, hard, n_cor, tri) in enumerate(K1_CASES):
        arrs, pairs, ov = kernel_inputs(B=B, V=V, hp=hp, hu=hu, n_obst=no,
                                        seed=seed, hard_rows=hard)
        args = torch_kernel_args(arrs, device="cuda")
        kw = dict(pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6,
                  n_cor=n_cor, n_iters=7, lower_tri=tri)
        ok_, op = (f(*args, **kw) for f in (
            ipm_kernel.ipm_iterate_struct, ipm_kernel.ipm_iterate_struct_plain))
        one_k, one_p = (f(*args, **{**kw, "n_iters": 1}) for f in (
            ipm_kernel.ipm_iterate_struct, ipm_kernel.ipm_iterate_struct_plain))
        torch.cuda.synchronize()
        nu = V * hu
        du = (ok_[0][:, :nu] - op[0][:, :nu]).abs().amax(dim=1)
        one = max(float((x - y)[:, :-1].abs().max()) for x, y in
                  zip(one_k[:1] + one_k[4:], one_p[:1] + one_p[4:]))
        scale = 1.0 if i == 0 else 20.0
        rep = {"case": f"k1_B{B}_V{V}_hp{hp}_hu{hu}_obst{no}_cor{n_cor}_"
                       f"tri{int(tri)}",
               "u_max": float(du.max()), "u_median": float(du.median()),
               "one_iter_max_abs_err": one,
               "finite": all(bool(torch.isfinite(t).all()) for t in ok_),
               "frozen_kernel": float(ok_[10][:, 1].mean()),
               "frozen_plain": float(op[10][:, 1].mean())}
        print(json.dumps(rep), flush=True)
        worst = max(worst, rep["u_max"])
        if (not rep["finite"] or rep["u_max"] > U_ABS_LIMIT * scale
                or rep["u_median"] > U_MEDIAN_LIMIT * scale or one > 1e-4):
            bad.append(rep["case"])
    # not positive definite: off-diagonals far above the unit diagonal
    arrs, pairs, ov = kernel_inputs(B=8, V=2, hp=4, hu=4, n_obst=0, seed=6)
    arrs["pb"][3] = 50.0
    arrs["pdiag"][3, :-1] = 1.0
    args = torch_kernel_args(arrs, device="cuda")
    kw = dict(pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6, n_iters=2)
    out = ipm_kernel.ipm_iterate_struct(*args, **kw)
    plain = ipm_kernel.ipm_iterate_struct_plain(*args, **kw)
    torch.cuda.synchronize()
    others = [i for i in range(8) if i != 3]
    rep = {"case": "k1_not_spd_instance_freezes",
           "finite": all(bool(torch.isfinite(t).all()) for t in out),
           "frozen": float(out[10][3, 1]), "frozen_plain": float(plain[10][3, 1]),
           "state_kept": all(torch.equal(o[3], a[3])
                             for o, a in zip(out[:10], args[7:17])),
           "others_u_max": float((out[0][others] - plain[0][others])
                                 .abs().max())}
    print(json.dumps(rep), flush=True)
    if not (rep["finite"] and rep["frozen"] == 1.0 == rep["frozen_plain"]
            and rep["state_kept"] and rep["others_u_max"] <= 1e-4):
        bad.append(rep["case"])
    print(json.dumps({"k1_worst_u_max": worst, "k1_cases_failed": bad}),
          flush=True)
    if bad:
        sys.exit(1)
    return worst


def check_new_kernels() -> None:
    from scp_tpu_torch.ops import (_cuda_build, ipm_kernel, riccati,
                                   riccati_kernel)
    from scp_tpu_torch.testing import DENSE_ARG_ORDER, riccati_inputs
    _cuda_build.build_library(verbose=True)
    check_k1()
    dev = "cuda"
    worst = 0.0
    two_rhs = hasattr(riccati_kernel, "solve_geometry")
    for B, V, K in RICCATI_CASES:
        t = {k: torch.as_tensor(v, device=dev)
             for k, v in riccati_inputs(B, V, K, seed=V).items()}
        t["a_blk"] = (0.9 * t["a_blk"]).contiguous()   # stable dynamics
        fk = riccati_kernel.riccati_factor(t["a_blk"], t["b_blk"], t["hy"],
                                           t["hu"])
        fp = riccati.riccati_factor_plain(t["a_blk"], t["b_blk"], t["hy"],
                                          t["hu"])
        duk = riccati_kernel.riccati_solve(*fk, t["a_blk"], t["b_blk"],
                                           t["r"])
        dup = riccati.riccati_solve_plain(*fp, t["a_blk"], t["b_blk"],
                                          t["r"])
        pairs = [("f", fk[0], fp.f), ("lh", fk[1], fp.lh),
                 ("kg", fk[2], fp.kg), ("du", duk, dup)]
        if two_rhs:
            r2 = torch.stack([t["r"], t["r"].flip(1)])
            du2 = riccati_kernel.riccati_solve(*fk, t["a_blk"], t["b_blk"],
                                               r2)
            du2p = riccati.riccati_solve_plain(*fp, t["a_blk"], t["b_blk"],
                                               r2)
            pairs.append(("du_two_rhs", du2, du2p))
            # the first right-hand side of a pair is the single launch's
            pairs.append(("du_two_rhs_vs_one", du2[0], duk))
        torch.cuda.synchronize()
        rep = {"case": f"riccati_B{B}_V{V}_K{K}"}
        if two_rhs:
            rep["geometry"] = {
                "factor": list(riccati_kernel.factor_geometry(B, V)),
                "solve_one": list(riccati_kernel.solve_geometry(B, V, K, 1)),
                "solve_two": list(riccati_kernel.solve_geometry(B, V, K, 2))}
        for name, a, b in pairs:
            e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            rep[f"{name}_rel_err"] = e
            rep[f"{name}_finite"] = bool(torch.isfinite(a).all())
            worst = max(worst, e)
        print(json.dumps(rep), flush=True)
    for B, mg, nb, d, schur, blocks, n_cor in (
            (1024, 440, 1, 20, True, True, 0), (64, 440, 1, 20, False, True, 1),
            (3, 45, 2, 7, True, False, 1), (8, 900, 4, 16, True, True, 1)):
        t = dense_inputs(dev, (B, mg, nb, d), seed=mg, blocks=blocks)
        args = [t[k] for k in DENSE_ARG_ORDER]
        kw = dict(tol=1e-6, reg_rel=3e-6, n_cor=n_cor, schur_slack=schur)
        rep = {"case": f"dense_B{B}_mg{mg}_n{nb * d + 1}_schur{int(schur)}_"
                       f"blocks{int(blocks)}_ncor{n_cor}"}
        for n_iters in (1, DENSE_ITERS):
            ok = ipm_kernel.ipm_iterate_dense(*args, n_iters=n_iters, **kw)
            op = ipm_kernel.ipm_iterate_dense_plain(*args, n_iters=n_iters,
                                                    **kw)
            torch.cuda.synchronize()
            e = max(float((x - y)[:, :-1].abs().max()) for x, y in
                    zip(ok[:1] + ok[4:], op[:1] + op[4:]))
            rep[f"iters{n_iters}"] = {
                "max_abs_err": e, "u_median": float(
                    (ok[0] - op[0])[:, :-1].abs().amax(1).median()),
                "frozen_equal": bool(torch.equal(ok[10][:, 1], op[10][:, 1])),
                "finite": all(bool(torch.isfinite(x).all()) for x in ok)}
            if n_iters == 1:
                worst = max(worst, e)
        rep["min_ctas"] = ipm_kernel.dense_min_ctas(B, _sm_count())
        rep["resident_ctas_per_sm"] = {
            str(b): ipm_kernel.dense_resident_ctas_per_sm(
                mg, nb * d + 1, nb if blocks else 0, d if blocks else 0,
                schur, n_cor, b) for b in (2, 4)}
        print(json.dumps(rep), flush=True)
    print(json.dumps({"worst": worst}))
    check_linalg_kernels()


def _spd(rng, B, n, dev):
    a = rng.normal(size=(B, n, n))
    return torch.as_tensor(a @ a.transpose(0, 2, 1) / n + np.eye(n),
                           dtype=torch.float32, device=dev)


# n across the factor's 16-column panels and blocks, the last n of the
# shared-memory kernels (239) and the large-n kernels past it (240, 257 =
# hp 64 with 4 vehicles, 400)
LINALG_NS = (1, 15, 16, 17, 32, 33, 81, 239, 240, 257, 400)


def check_linalg_kernels() -> None:
    """K3, K4 and K5a at their boundary shapes. Limits: the factor's
    residual max|L L^T - K| within 2e-5 of max|K|, the solve within 1e-4 of
    its scale from the plain version (well-conditioned inputs), and every
    kernel no further from the float64 oracle than twice the plain float32
    version plus 1e-5 of the result's scale (``chip_smoke.py``'s
    limits)."""
    from scp_tpu_torch.ops import linalg, linalg_kernel as lk
    dev = "cuda"
    rng = np.random.default_rng(4)
    bad = []
    for n in LINALG_NS:
        for B in (1, 3, 1023):
            if n >= 239 and B == 1023:
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
    # K4 at the same edges, on float32 factors of SPD matrices (the upper
    # triangle filled with garbage: only the lower one may be read), and a
    # NaN factor (K3's output for an indefinite instance) among good ones
    for n in LINALG_NS:
        for B in (1, 3, 1023):
            if n >= 239 and B == 1023:
                B = 257
            L = torch.linalg.cholesky(_spd(rng, B, n, dev)).contiguous()
            L += torch.triu(torch.full_like(L, 7.0), 1)
            if B == 3:
                L[1] = float("nan")
            b = torch.as_tensor(rng.normal(size=(B, n)), dtype=torch.float32,
                                device=dev)
            x_k = lk.cho_solve(L, b)
            Lt = torch.tril(L)
            x_p = linalg.cho_solve_plain(Lt, b)
            x_d = linalg.cho_solve_plain(Lt.double(), b.double())
            torch.cuda.synchronize()
            ok = torch.isfinite(x_d).all(dim=1)
            nan_ok = bool((torch.isfinite(x_k).all(dim=1) == ok).all()
                          and torch.isnan(x_k[~ok]).all())
            scale = float(x_d[ok].abs().max())
            e_kd = float((x_k[ok].double() - x_d[ok]).abs().max())
            e_pd = float((x_p[ok].double() - x_d[ok]).abs().max())
            e_kp = float((x_k[ok] - x_p[ok]).abs().max())
            rep = {"case": f"cho_solve_B{B}_n{n}",
                   "geometry": list(lk.solve_geometry(B, n)),
                   "kernel_vs_plain": e_kp, "kernel_vs_f64": e_kd,
                   "plain_vs_f64": e_pd, "scale": scale,
                   "nan_instances_ok": nan_ok}
            print(json.dumps(rep), flush=True)
            if (not nan_ok or e_kd > 2 * e_pd + 1e-5 * scale
                    or e_kp > 1e-4 * scale):
                bad.append(rep["case"])
    flat = torch.as_tensor(rng.normal(size=1024 * 120 * 81 + 1),
                           dtype=torch.float32, device=dev)
    cases = {"path_B1024_m120_n81": (1024, 120, 81, None),
             "path_B256_m120_n81": (256, 120, 81, None),
             "P_shape_B1024_m81_n81": (1024, 81, 81, None),
             "view_base_4_bytes_past_16": (64, 81, 81, flat),
             "above_one_stage_B3_m900_n65": (3, 900, 65, None),
             "B1_m120_n81": (1, 120, 81, None),
             "odd_B3_m45_n31": (3, 45, 31, None),
             "hp64_B256_m384_n257": (256, 384, 257, None),
             "row_one_column_past_a_stage_B2_m3":
                 (2, 3, lk.GMV_STAGE_BYTES // 4 - 2, None),
             "row_of_60000_B2_m3": (2, 3, 60000, None)}
    for case, (B, m, n, base) in cases.items():
        if base is None:
            G = torch.as_tensor(rng.normal(size=(B, m, n)),
                                dtype=torch.float32, device=dev)
        else:
            G = base[1:1 + B * m * n].view(B, m, n)
        for name, geometry, vec in (("gmv", "gmv_geometry", n),
                                    ("gtmv", "gtmv_geometry", m)):
            if not hasattr(lk, geometry):   # an older checkout
                continue
            x = torch.as_tensor(rng.normal(size=(B, vec)),
                                dtype=torch.float32, device=dev)
            kern, plain = getattr(lk, name), getattr(linalg, name + "_plain")
            o_k, o_p = kern(G, x), plain(G, x)
            o_d = plain(G.double(), x.double())
            again = kern(G, x)
            torch.cuda.synchronize()
            scale = float(o_d.abs().max())
            e_kd = float((o_k.double() - o_d).abs().max())
            e_pd = float((o_p.double() - o_d).abs().max())
            e_kp = float((o_k - o_p).abs().max())
            rep = {"case": f"{name}_{case}",
                   "geometry": list(getattr(lk, geometry)(B, m, n)),
                   "base_mod_16": G.data_ptr() % 16, "kernel_vs_plain": e_kp,
                   "kernel_vs_f64": e_kd, "plain_vs_f64": e_pd,
                   "scale": scale,
                   "repeat_bit_identical": torch.equal(o_k, again)}
            print(json.dumps(rep), flush=True)
            if (e_kd > 2 * e_pd + 1e-5 * scale or e_kp > 2e-5 * scale
                    or not rep["repeat_bit_identical"]):
                bad.append(rep["case"])
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


TIMED = ("k1", "k4", "k6k7", "k2", "k3", "k5a", "k5b", "k3k4large",
         "k5bvar")
L2_ROTATE_BYTES = 256 << 20   # as chip_smoke.py: five times the 50 MB L2


def _graph_ms(calls, replays=5):
    """Milliseconds per call of the thunks ``calls`` captured in order in
    one CUDA graph and replayed; None where the capture fails."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            for c in calls:
                c()
    except RuntimeError as exc:
        print(json.dumps({"graph_capture_failed": str(exc)[:200]}),
              flush=True)
        return None
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(calls))


def k1_times(rnd, dev) -> None:
    """K1 at the bench shape (P = 6, hp = hu = 20, V = 4, 7 iterations,
    lower-triangular slabs) by graph replay, with the CTAs one SM holds."""
    from scp_tpu_torch.ops import ipm_kernel
    from scp_tpu_torch.testing import kernel_inputs, torch_kernel_args
    arrs, pairs, ov = kernel_inputs(B=1024, V=4, hp=20, hu=20, n_obst=0,
                                    seed=1)
    args = torch_kernel_args(arrs, device=dev)
    kw = dict(pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6, n_cor=0,
              n_iters=7, lower_tri=True)
    ctas = (ipm_kernel.resident_ctas_per_sm(6, 0, 20, 20, 4, True)
            if hasattr(ipm_kernel, "resident_ctas_per_sm") else None)
    for w in (1024, 256, 64):
        aw = [None if a is None else a[:w].contiguous() for a in args]
        ms = _graph_ms([lambda: ipm_kernel.ipm_iterate_struct(*aw, **kw)]
                       * 10)
        print(json.dumps({"round": rnd, "kernel": "ipm_iterate_struct",
                          "B": w, "graph_ms_per_call": ms,
                          "ms_per_iteration": ms / 7,
                          "resident_ctas_per_sm": ctas}), flush=True)


def _profiler_ms(calls, reps=20) -> float:
    """Milliseconds of device time per call (torch.profiler) of ``reps``
    calls of the thunks ``calls`` in turn: for library calls that a CUDA
    graph cannot capture."""
    from torch.profiler import ProfilerActivity, profile
    calls[0]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(reps):
            calls[k % len(calls)]()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def k4_times(rnd, dev) -> None:
    """K4 at n = 81 (the adaptive path) and n = 80 (K1's factor), B = 1024 /
    256 / 64, warm (the same inputs every call) and cold (each call on the
    next of enough copies that 256 MiB pass through L2 between two reads of
    one), with each thread count the wrapper offers, by graph replay;
    torch.cholesky_solve (which a graph cannot capture) by the profiler."""
    from scp_tpu_torch.ops import linalg_kernel as lk
    rng = np.random.default_rng(8)
    variants = [None]
    if hasattr(lk, "SOLVE_FEW_THREADS"):
        variants = [128, 256]
        saved = (lk.SOLVE_FEW_INSTANCES, lk.SOLVE_FEW_THREADS)
    for n in (81, 80):
        K = torch.eye(n, device=dev).expand(1024, n, n).contiguous()
        K += 0.01 * torch.ones_like(K)
        L = torch.linalg.cholesky(K).contiguous()
        b = torch.as_tensor(rng.normal(size=(1024, n)), dtype=torch.float32,
                            device=dev)
        for w in (1024, 256, 64):
            Lw, bw = L[:w].contiguous(), b[:w].contiguous()
            count = 1 + -(-L2_ROTATE_BYTES // (4 * (Lw.numel() + bw.numel())))
            copies = [(Lw.clone(), bw.clone()) for _ in range(count)]
            lib = {"warm": _profiler_ms(
                [lambda: torch.cholesky_solve(bw[:, :, None], Lw)]),
                "cold": _profiler_ms(
                [lambda c=c: torch.cholesky_solve(c[1][:, :, None], c[0])
                 for c in copies])}
            print(json.dumps({"round": rnd, "kernel": "torch.cholesky_solve",
                              "n": n, "B": w, "profiler_ms_per_call": lib}),
                  flush=True)
            for var in variants:
                if var is not None:
                    lk.SOLVE_FEW_INSTANCES, lk.SOLVE_FEW_THREADS = 1 << 30, var
                geo = (list(lk.solve_geometry(w, n))
                       if hasattr(lk, "solve_geometry") else None)
                warm = _graph_ms([lambda: lk.cho_solve(Lw, bw)] * 20)
                cold = _graph_ms([lambda c=c: lk.cho_solve(*c)
                                  for c in copies])
                print(json.dumps({
                    "round": rnd, "kernel": "cho_solve", "n": n, "B": w,
                    "geometry": geo, "graph_ms_per_call": {
                        "warm": warm, "cold": cold},
                    "input_copies": count,
                    "warm_over_library": warm / lib["warm"],
                    "cold_over_library": cold / lib["cold"]}), flush=True)
            if variants[0] is not None:
                lk.SOLVE_FEW_INSTANCES, lk.SOLVE_FEW_THREADS = saved
            del copies


COLD_MAX_COPIES = 200          # graph size cap: small widths stay warmer


def k6k7_times(rnd, dev) -> None:
    """K6 and K7 (one and, where the checkout has it, two right-hand sides)
    at V = 4, K = 64, B = 256 / 64 / 16 / 1 and at V = 16, B = 256, by graph
    replay: warm (the same inputs every call) and cold (each call on the
    next of up to COLD_MAX_COPIES input copies, 256 MiB between two reads of
    one where that cap allows)."""
    from scp_tpu_torch.ops import riccati_kernel as rk
    from scp_tpu_torch.testing import riccati_inputs
    two = hasattr(rk, "solve_geometry")
    for V, widths in ((4, (256, 64, 16, 1)), (16, (256,))):
        t = {k: torch.as_tensor(v, device=dev)
             for k, v in riccati_inputs(256, V, 64, seed=4).items()}
        t["a_blk"] = (0.9 * t["a_blk"]).contiguous()
        for w in widths:
            f_args = tuple(t[k][:w].contiguous()
                           for k in ("a_blk", "b_blk", "hy", "hu"))
            fac = rk.riccati_factor(*f_args)
            r1 = t["r"][:w].contiguous()
            cases = [("riccati_factor", rk.riccati_factor, f_args),
                     ("riccati_solve", rk.riccati_solve,
                      (*fac, f_args[0], f_args[1], r1))]
            if two:
                cases.append(("riccati_solve_two_rhs", rk.riccati_solve,
                              (*fac, f_args[0], f_args[1],
                               torch.stack([r1, r1.flip(1)]))))
            ms = {}
            for name, fn, args in cases:
                nbytes = sum(a.numel() * 4 for a in args)
                count = min(COLD_MAX_COPIES, 1 + -(-L2_ROTATE_BYTES // nbytes))
                copies = [tuple(a.clone() for a in args) for _ in range(count)]
                warm = _graph_ms([lambda: fn(*args)] * 20)
                cold = _graph_ms([lambda c=c: fn(*c) for c in copies])
                ms[name] = warm
                geo = None
                if two:
                    geo = (list(rk.factor_geometry(w, V))
                           if name == "riccati_factor" else
                           list(rk.solve_geometry(w, V, 64,
                                                  args[-1].ndim - 2)))
                print(json.dumps({
                    "round": rnd, "kernel": name, "V": V, "K": 64, "B": w,
                    "geometry": geo,
                    "graph_ms_per_call": {"warm": warm, "cold": cold},
                    "input_copies": count,
                    "mib_between_reads": (count - 1) * nbytes / 2 ** 20}),
                    flush=True)
                del copies
            if two:
                print(json.dumps({
                    "round": rnd, "V": V, "B": w,
                    "two_rhs_over_two_one_rhs": ms["riccati_solve_two_rhs"]
                    / (2 * ms["riccati_solve"])}), flush=True)


# One QP of the dense-G branch at frog's shape (mg = 440 rows, one 20 x 20
# P block, n = 21 with the slack eliminated), 7 fixed iterations, no
# Gondzio corrector: the tuned_f32 frog path's QP.
DENSE_SHAPE = (1024, 440, 1, 20)
DENSE_KW = dict(tol=1e-6, reg_rel=3e-6, n_cor=0, schur_slack=True)
DENSE_ITERS = 7
STATE = ("x", "sg", "su", "sl", "zg", "zu", "zl", "rpg", "rpu", "rpl",
         "scal")
# K2's sections, as the kernel marks them, and grouped as the sections of
# the per-iteration K2 it replaced
K2_FINE_SECTIONS = ("load", "weights_mu", "product", "border", "px_diag",
                    "scale", "factor", "pred_rhs", "pred_solve",
                    "pred_vector", "corr_rhs", "corr_solve", "corr_vector",
                    "step", "store")
K2_GROUPS = {"load": ("load",),
             "weights_mu_product": ("weights_mu", "product", "border",
                                    "px_diag"),
             "scale_border": ("scale",), "factor": ("factor",),
             "predictor": ("pred_rhs", "pred_solve", "pred_vector"),
             "corrector": ("corr_rhs", "corr_solve", "corr_vector"),
             "step": ("step",), "store": ("store",)}


def dense_inputs(dev, shape=DENSE_SHAPE, seed=440, blocks=True):
    """``testing.dense_kernel_inputs`` of the checkout as tensors."""
    from scp_tpu_torch.testing import dense_kernel_inputs
    a = dense_kernel_inputs(*shape, seed=seed, blocks=blocks)
    return {k: None if v is None else torch.as_tensor(v, device=dev)
            for k, v in a.items()}


def dense_qp(t, kw=DENSE_KW, n_iters=DENSE_ITERS):
    """A thunk that runs one QP of the dense-G branch (``n_iters`` fixed
    iterations, one K2 launch) on the inputs ``t``."""
    from scp_tpu_torch.ops import ipm_kernel as ik
    state = [t[k] for k in STATE]
    return lambda: ik.ipm_iterate_dense(
        t["G"], t.get("P"), t["pb"], t["q"], t["pdiag"], *state,
        n_iters=n_iters, **kw)


def _cut(t, w):
    return {k: None if v is None else v[:w].contiguous() for k, v in t.items()}


def _sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def k2_times(rnd, dev) -> None:
    """One QP of the dense-G branch (7 iterations, frog's shape) at B =
    1024 / 512 / 256 / 64 by graph replay: warm (the same inputs every call)
    and cold (each call on the next of enough input copies that 256 MiB
    pass through L2 between two reads of one). Where the checkout picks
    K2's launch bound by the batch (``ipm_kernel.dense_min_ctas``), each
    width is timed at both bounds, the one picked marked."""
    from scp_tpu_torch.ops import ipm_kernel
    t_all = dense_inputs(dev)
    pick = getattr(ipm_kernel, "dense_min_ctas", None)
    for w in (1024, 512, 256, 64):
        t = _cut(t_all, w)
        nbytes = sum(v.numel() * 4 for v in t.values() if v is not None)
        count = 1 + -(-L2_ROTATE_BYTES // nbytes)
        copies = [{k: None if v is None else v.clone()
                   for k, v in t.items()} for _ in range(count)]
        for bound in (None,) if pick is None else (2, 4):
            if bound is not None:
                ipm_kernel.dense_min_ctas = lambda B, sms, b=bound: b
            try:
                warm = _graph_ms([dense_qp(t)] * 10)
                cold = _graph_ms([dense_qp(c) for c in copies])
            finally:
                if pick is not None:
                    ipm_kernel.dense_min_ctas = pick
            print(json.dumps({
                "round": rnd, "kernel": "dense_qp", "B": w,
                "min_ctas": bound, "picked": bound is None
                or bound == pick(w, _sm_count()),
                "n_iters": DENSE_ITERS, "launches_per_qp": 1,
                "graph_ms_per_qp": {"warm": warm, "cold": cold},
                "input_copies": count}), flush=True)
        del copies


# K5b's shapes: the adaptive path's (m = 120, n = 81) at its widths, and
# the long-horizon one's (hp = 64: m = 384, n = 257) at B = 256
K5B_CASES = ((1024, 120, 81), (256, 120, 81), (64, 120, 81), (1, 120, 81),
             (256, 384, 257))


def k5b_times(rnd, dev) -> None:
    """K5b (G^T v) at ``K5B_CASES`` beside ``torch.bmm`` on the same inputs,
    by graph replay, warm and cold (as :func:`k2_times`), with the geometry
    where the checkout has one."""
    from scp_tpu_torch.ops import linalg_kernel as lk
    rng = np.random.default_rng(11)
    for w, m, n in K5B_CASES:
        Gw = torch.as_tensor(rng.normal(size=(w, m, n)), dtype=torch.float32,
                             device=dev)
        vw = torch.as_tensor(rng.normal(size=(w, m)), dtype=torch.float32,
                             device=dev)
        count = 1 + -(-L2_ROTATE_BYTES // (4 * (Gw.numel() + vw.numel())))
        copies = [(Gw.clone(), vw.clone()) for _ in range(count)]
        rep = {"round": rnd, "kernel": "gtmv", "B": w, "m": m, "n": n,
               "input_copies": count, "geometry": (
                   list(lk.gtmv_geometry(w, m, n, *lk.sm_resources(dev)))
                   if hasattr(lk, "gtmv_geometry") else None)}
        for name, fn in (("gtmv", lk.gtmv),
                         ("torch.bmm",
                          lambda a, b: torch.bmm(b[:, None, :], a))):
            rep[name] = {
                "warm": _graph_ms([lambda fn=fn: fn(Gw, vw)] * 20),
                "cold": _graph_ms([lambda c=c, fn=fn: fn(*c)
                                   for c in copies])}
        rep["warm_over_bmm"] = rep["gtmv"]["warm"] / rep["torch.bmm"]["warm"]
        rep["cold_over_bmm"] = rep["gtmv"]["cold"] / rep["torch.bmm"]["cold"]
        print(json.dumps(rep), flush=True)
        del copies


def k5b_variants(rnd, dev) -> None:
    """K5b's geometry varied through ``linalg_kernel``'s module constants
    (grid target, stage size, cluster cap) at ``K5B_CASES``,
    by graph replay, warm and cold; ``torch.bmm`` beside each case."""
    from scp_tpu_torch.ops import linalg_kernel as lk
    if not hasattr(lk, "gtmv_geometry"):    # an older checkout
        return
    rng = np.random.default_rng(12)
    names = ("GTMV_CTAS_PER_SM", "GTMV_STAGE_BYTES", "GTMV_MAX_CLUSTER")
    saved = tuple(getattr(lk, k) for k in names)
    variants = [(c, kb << 10, mc) for c in (1, 2, 4)
                for kb in (16, 32) for mc in (8,)] + [(2, 32 << 10, 1)]
    try:
        for w, m, n in K5B_CASES:
            G = torch.as_tensor(rng.normal(size=(w, m, n)),
                                dtype=torch.float32, device=dev)
            v = torch.as_tensor(rng.normal(size=(w, m)), dtype=torch.float32,
                                device=dev)
            count = 1 + -(-L2_ROTATE_BYTES // (4 * (G.numel() + v.numel())))
            copies = [(G.clone(), v.clone()) for _ in range(count)]
            bmm = {"warm": _graph_ms([lambda: torch.bmm(v[:, None, :], G)]
                                     * 20),
                   "cold": _graph_ms([lambda c=c: torch.bmm(c[1][:, None, :],
                                                            c[0])
                                      for c in copies])}
            for var in variants:
                for k, val in zip(names, var):
                    setattr(lk, k, val)
                rep = {"round": rnd, "kernel": "gtmv_variant", "B": w,
                       "m": m, "n": n, "variant": dict(zip(names, var)),
                       "geometry": list(lk.gtmv_geometry(
                           w, m, n, *lk.sm_resources(dev))),
                       "gtmv": {"warm": _graph_ms([lambda: lk.gtmv(G, v)]
                                                  * 20),
                                "cold": _graph_ms([lambda c=c: lk.gtmv(*c)
                                                   for c in copies])},
                       "torch.bmm": bmm}
                rep["cold_over_bmm"] = rep["gtmv"]["cold"] / bmm["cold"]
                print(json.dumps(rep), flush=True)
            del copies
    finally:
        for k, val in zip(names, saved):
            setattr(lk, k, val)


# The factor and the solve past the shared-memory kernels: n = 240, 257
# (hp = 64 with 4 vehicles) and 400, at the widths of the hp = 64 paths
K3K4_LARGE_CASES = ((240, (1024, 256, 1)), (257, (1024, 256, 1)),
                    (400, (256, 1)))


def k3k4large_times(rnd, dev) -> None:
    """K3 and K4 for n >= 240 at ``K3K4_LARGE_CASES`` by graph replay, warm
    and cold (each call on the next of up to COLD_MAX_COPIES input copies),
    beside ``torch.linalg.cholesky_ex`` and ``torch.cholesky_solve`` (by
    the profiler: a graph cannot capture the solve). A checkout without
    the large-n kernels refuses the call: that is reported and skipped."""
    from scp_tpu_torch.ops import linalg_kernel as lk
    rng = np.random.default_rng(9)
    for n, widths in K3K4_LARGE_CASES:
        K_all = _spd(rng, max(widths), n, dev)
        b_all = torch.as_tensor(rng.normal(size=(max(widths), n)),
                                dtype=torch.float32, device=dev)
        for w in widths:
            K, b = K_all[:w].contiguous(), b_all[:w].contiguous()
            L = torch.linalg.cholesky(K).contiguous()
            for name, fn, lib, args in (
                    ("cholesky", lk.cholesky,
                     lambda K: torch.linalg.cholesky_ex(K), (K,)),
                    ("cho_solve", lk.cho_solve,
                     lambda L, b: torch.cholesky_solve(b[:, :, None], L),
                     (L, b))):
                nbytes = sum(a.numel() * 4 for a in args)
                count = min(COLD_MAX_COPIES,
                            1 + -(-L2_ROTATE_BYTES // nbytes))
                copies = [tuple(a.clone() for a in args)
                          for _ in range(count)]
                rep = {"round": rnd, "kernel": name, "n": n, "B": w,
                       "input_copies": count}
                try:
                    fn(*args)
                    rep["geometry"] = list(
                        (lk.chol_geometry if name == "cholesky"
                         else lk.solve_geometry)(w, n))
                    rep["graph_ms_per_call"] = {
                        "warm": _graph_ms([lambda: fn(*args)] * 10),
                        "cold": _graph_ms([lambda c=c: fn(*c)
                                           for c in copies])}
                except NotImplementedError as exc:
                    rep["refused"] = str(exc)[:80]
                rep["library_profiler_ms_per_call"] = {
                    "warm": _profiler_ms([lambda: lib(*args)], reps=10),
                    "cold": _profiler_ms([lambda c=c: lib(*c)
                                          for c in copies], reps=10)}
                print(json.dumps(rep), flush=True)
                del copies


def k2_sections() -> None:
    """Clock cycles of block 0 of K2 by section, per IPM iteration, over
    one QP of the dense-G branch (frog's shape, 7 iterations) at B = 64 and
    1024."""
    import ctypes
    import subprocess
    from scp_tpu_torch.ops import _cuda_build, ipm_kernel
    if "SCP_PROFILE_SECTIONS" not in _cuda_build.BUILD_DEFINES:
        _cuda_build.BUILD_DEFINES += ("SCP_PROFILE_SECTIONS",)
    lib = _cuda_build.load_library()
    lib.ipm_dense_read_sections.argtypes = [ctypes.c_void_p]
    lib.ipm_dense_read_sections.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 16)()
    t_all = dense_inputs("cuda")
    for B in (64, 1024):
        qp = dense_qp(_cut(t_all, B))
        qp()
        torch.cuda.synchronize()
        lib.ipm_dense_read_sections(buf)
        reps = 5
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            qp()
        end.record()
        torch.cuda.synchronize()
        if lib.ipm_dense_read_sections(buf) != 0:
            sys.exit("reading the section counters failed")
        fine = {k: buf[i] / reps / DENSE_ITERS
                for i, k in enumerate(K2_FINE_SECTIONS)}
        cyc = {g: sum(fine[k] for k in ks) for g, ks in K2_GROUPS.items()}
        print(json.dumps({
            "B": B, "n_iters": DENSE_ITERS,
            "min_ctas": ipm_kernel.dense_min_ctas(B, _sm_count()),
            "ms_per_qp_instrumented": start.elapsed_time(end) / reps,
            "cycles_per_iteration": sum(cyc.values()),
            "cycles": {k: round(c) for k, c in cyc.items()},
            "fine_cycles": {k: round(c) for k, c in fine.items()}}),
            flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


def kernel_times(which) -> None:
    from scp_tpu_torch.ops import _cuda_build
    _cuda_build.build_library()
    dev = "cuda"
    card = __import__("subprocess").run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    K = torch.eye(81, device=dev).expand(1024, 81, 81).contiguous()
    K += 0.01 * torch.ones_like(K)
    for rnd in range(2):
        if "k1" in which:
            k1_times(rnd, dev)
        if "k4" in which:
            k4_times(rnd, dev)
        if "k6k7" in which:
            k6k7_times(rnd, dev)
        if "k2" in which:
            k2_times(rnd, dev)
        if "k5b" in which:
            k5b_times(rnd, dev)
        if "k3k4large" in which:
            k3k4large_times(rnd, dev)
        if "k5bvar" in which:
            k5b_variants(rnd, dev)
        linalg_times(rnd, K, dev, which)
    print(card.strip())


def linalg_times(rnd, K, dev, which) -> None:
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
        for w in (1024, 256, 64, 1) if "k3" in which else ():
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
        for name, A, widths in ((("G", G, (1024, 256, 64)),
                                 ("P", P, (1024,)))
                                if "k5a" in which else ()):
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
    if "SCP_PROFILE_SECTIONS" not in _cuda_build.BUILD_DEFINES:
        _cuda_build.BUILD_DEFINES += ("SCP_PROFILE_SECTIONS",)
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


PIVOT_TEST = r"""
#include <cstdio>
#include "riccati.cu"
__global__ void pivot_test(unsigned long long* bad, unsigned base) {
  const unsigned bits = base + blockIdx.x * blockDim.x + threadIdx.x;
  const float x = __uint_as_float(bits);
  if (!(x >= 1e-30f) || !(x <= 3.4028235e38f)) return;
  const float d = __fsqrt_rn(x);
  if (__float_as_uint(sqrt_rn_pivot(x)) != __float_as_uint(d))
    atomicAdd(&bad[0], 1ULL);
  if (__float_as_uint(rcp_rn_pivot(d)) != __float_as_uint(__frcp_rn(d)))
    atomicAdd(&bad[1], 1ULL);
  atomicAdd(&bad[2], 1ULL);
}
int main() {
  unsigned long long* bad;
  cudaMallocManaged(&bad, 3 * sizeof(unsigned long long));
  bad[0] = bad[1] = bad[2] = 0;
  for (unsigned long long base = 0; base < 0x80000000ULL; base += 1ULL << 30)
    pivot_test<<<(1u << 30) / 256, 256>>>(bad, (unsigned)base);
  const cudaError_t err = cudaDeviceSynchronize();
  printf("{\"pivots_checked\": %llu, \"sqrt_mismatches\": %llu, "
         "\"rcp_mismatches\": %llu, \"cuda\": \"%s\"}\n", bad[2], bad[0],
         bad[1], cudaGetErrorString(err));
  return err != cudaSuccess || bad[0] || bad[1];
}
"""


def pivot_check() -> None:
    """The branch-free pivots of csrc/riccati.cu against the intrinsics,
    every positive float bit pattern in the square root's domain."""
    import shutil
    import subprocess
    from scp_tpu_torch.ops import _cuda_build
    _cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _cuda_build.BUILD_DIR / "pivot_test.cu"
    exe = _cuda_build.BUILD_DIR / "pivot_test"
    src.write_text(PIVOT_TEST)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *_cuda_build.NVCC_FLAGS[:2], "-std=c++17", "-O3",
                    "-I", str(_cuda_build.CSRC), "-o", str(exe), str(src)],
                   check=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True)
    print(out.stdout.strip(), flush=True)
    if out.returncode != 0:
        sys.exit(f"the pivots disagree with the intrinsics: {out.stderr}")


K6K7_SECTIONS = ("k6_pt_and_t", "k6_f_hm_and_z", "k6_chol_kg_and_y",
                 "k6_ftkg", "k6_sym", "k7_bwd_wait_exchange",
                 "k7_bwd_chain", "k7_fwd_wait_exchange", "k7_fwd_chain",
                 "k6gen_hy", "k6gen_t_and_x", "k6gen_f_hm_and_y",
                 "k6gen_chol", "k6gen_kg_and_store", "k6gen_ftkg",
                 "k6gen_sym")


def k6k7_sections() -> None:
    """Clock cycles of thread 0 of block 0 per stage of K6 and K7 (V = 4, K
    = 64) by section, at B = 1 and 256, one and two right-hand sides; and of
    the generic K6 and K7 at V = 16, B = 1."""
    import ctypes
    import subprocess
    from scp_tpu_torch.ops import _cuda_build, riccati_kernel as rk
    from scp_tpu_torch.testing import riccati_inputs
    if "SCP_PROFILE_SECTIONS" not in _cuda_build.BUILD_DEFINES:
        _cuda_build.BUILD_DEFINES += ("SCP_PROFILE_SECTIONS",)
    lib = _cuda_build.load_library()
    lib.riccati_read_sections.argtypes = [ctypes.c_void_p]
    lib.riccati_read_sections.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 16)()
    for V, B in ((4, 1), (4, 256), (16, 1)):
        t = {k: torch.as_tensor(v, device="cuda")
             for k, v in riccati_inputs(B, V, 64, seed=4).items()}
        t["a_blk"] = (0.9 * t["a_blk"]).contiguous()
        f_args = tuple(t[k][:B].contiguous()
                       for k in ("a_blk", "b_blk", "hy", "hu"))
        fac = rk.riccati_factor(*f_args)
        r1 = t["r"][:B].contiguous()
        for what, fn in (
                ("factor", lambda: rk.riccati_factor(*f_args)),
                ("solve_one", lambda: rk.riccati_solve(
                    *fac, f_args[0], f_args[1], r1)),
                ("solve_two", lambda: rk.riccati_solve(
                    *fac, f_args[0], f_args[1],
                    torch.stack([r1, r1.flip(1)])))):
            fn()
            torch.cuda.synchronize()
            lib.riccati_read_sections(buf)
            reps = 10
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            if lib.riccati_read_sections(buf) != 0:
                sys.exit("reading the section counters failed")
            cyc = {k: buf[i] / reps / 64 for i, k in enumerate(K6K7_SECTIONS)
                   if buf[i]}
            print(json.dumps({"B": B, "V": V, "K": 64, "call": what,
                              "defines": list(_cuda_build.BUILD_DEFINES),
                              "cycles_per_stage": sum(cyc.values()),
                              "cycles": cyc}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dump", metavar="PATH")
    ap.add_argument("--inputs", metavar="PATH",
                    help="with --dump: K1's calibrated inputs from this "
                         "dump instead of a captured step")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--times", nargs="*", choices=TIMED, metavar="KERNEL",
                    help=f"time these kernels (default: all of {TIMED})")
    ap.add_argument("--sections", nargs="*", choices=("k3", "k6k7", "k2"),
                    metavar="KERNEL",
                    help="cycles by section (default: k3)")
    ap.add_argument("--pivots", action="store_true")
    args = ap.parse_args()
    if args.compare:            # two dumps: no device needed
        compare(*args.compare)
        return
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    if args.dump:
        dump_k1(args.dump, args.inputs)
    elif args.times is not None:
        kernel_times(args.times or TIMED)
    elif args.pivots:
        pivot_check()
    elif args.sections is not None:
        if "k6k7" in args.sections:
            k6k7_sections()
        if "k2" in args.sections:
            k2_sections()
        if not args.sections or "k3" in args.sections:
            k3_sections()
    else:
        check_new_kernels()


if __name__ == "__main__":
    main()
