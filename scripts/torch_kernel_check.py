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
    python3 scripts/torch_kernel_check.py --sections k2 k4 # K2's, K4's
    python3 scripts/torch_kernel_check.py --pivots        # K6 / K7's pivots
    python3 scripts/torch_kernel_check.py --tiers         # K1 / K2 tiers

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
at each of its two launch bounds; one QP of (l3)'s shape, B = 256, mg =
384, n = 257, in each tier past the shared one beside the plain
version), K5b (m = 120, n = 81 at B = 1024 / 256
/ 64 / 1 and the hp = 64 shape m = 384, n = 257 at B = 256, warm and cold,
beside ``torch.bmm``), ``k3k4large``: K3 and K4 at n = 240, 257, 330 and
400 (warm and cold, beside ``torch.linalg.cholesky_ex`` /
``torch.cholesky_solve``; K3's cluster kernel, its one-CTA kernel and the
cluster kernel at each cluster size that holds the matrix, with the size
the geometry picks; K4's staged solve where it holds the triangle and its
one-CTA solve), K3 (n = 81, B = 1024 / 256 / 64 / 1,
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
1024, for each thread count, and at n = 257 for each large-n kernel;
``--sections k3trace`` the cluster factor's timeline across its ranks at
B = 1 (each step's duration, the hop between ranks, a panel's period); ``--sections k6k7`` the cycles of K6's and K7's
stage by section (thread 0 of block 0, per stage) at V = 4, B = 1 and 256,
and of the generic kernels at V = 16; ``--sections k2`` K2's cycles per
IPM iteration by section (block 0, one frog QP, B = 64 and 1024; one (l3)
QP at B = 256 in each tier past the shared one, the cluster tier's
product by part); ``--sections k4`` the staged solve's timeline in block
0 at n = 257 (each stripe's landing, the ends of the substitutions).
``--tiers`` builds the library (printing ``ptxas -v``) and holds K1's
device-memory and cluster tiers and K2's device-memory tier against their
shared-memory tier on the same inputs (bit for bit: the same sums in the
same order) at the bench shape, two odd K1 shapes and frog's K2 shape, K2's
cluster tier there too (its product sums in another order: to the
plain-version limits), and against the plain version past the shared tier
(parallel-11's side-selection QP at hp = 20 and circle-4 at hp = 64 for
K1, in the cluster tier and bit for bit the device tier; path (h)'s
n = 257 for K2, in the cluster tier, also against the device tier forced);
the default mode runs it too, and holds the staged large-n solve bit for
bit ``cho_solve_large_kernel`` at n = 240 / 257 / 330 / 400 x B = 1 / 16 /
256 / 1,024 (an instance base 4 bytes past 16 at B = 16).
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


# (B, V, hp, hu, n_obst, seed, hard_rows, n_cor, lower_tri, n_iters):
# shapes past K1's shared tier — parallel-11's side-selection QP at hp = 20
# (55 pairs, 66 single-vehicle slabs with every fifth row hard) and
# circle-4 at hp = 64
K1_DEVICE_CASES = (
    (64, 11, 20, 20, 6, 3, True, 0, True, 8),
    (32, 4, 64, 64, 0, 4, False, 0, True, 7),
)


def _tier_pair(fn, args, kw, tier="device"):
    """``fn`` in the tier its shape takes and forced into ``tier`` on the
    same inputs: whether every output is bit for bit the same, and the
    largest difference."""
    a = fn(*args, **kw)
    b = fn(*args, **kw, tier=tier)
    torch.cuda.synchronize()
    return {"bit_identical": all(torch.equal(x, y) for x, y in zip(a, b)),
            "max_abs_diff": max(float((x - y).abs().max())
                                for x, y in zip(a, b))}


def _dense_against(args, kw, fn, extra) -> dict:
    """K2 in the tier its shape takes against ``fn(..., **extra)`` (the
    plain version, or K2 with a tier forced) on the same inputs: the whole
    launch and one iteration."""
    from scp_tpu_torch.ops import ipm_kernel as ik
    a, b = ik.ipm_iterate_dense(*args, **kw), fn(*args, **kw, **extra)
    one = {**kw, "n_iters": 1}
    a1, b1 = ik.ipm_iterate_dense(*args, **one), fn(*args, **one, **extra)
    torch.cuda.synchronize()
    du = (a[0] - b[0])[:, :-1].abs().amax(1)
    err1 = max(float((x - y)[:, :-1].abs().max())
               for x, y in zip(a1[:1] + a1[4:], b1[:1] + b1[4:]))
    rep = {"u_max": float(du.max()), "u_median": float(du.median()),
           "one_iter_max_abs_err": err1,
           "finite": all(bool(torch.isfinite(x).all()) for x in a),
           "frozen_equal": bool(torch.equal(a[10][:, 1], b[10][:, 1])),
           "bit_identical": all(torch.equal(x, y) for x, y in zip(a, b))}
    rep["ok"] = (rep["finite"] and err1 <= 1e-4
                 and rep["u_median"] <= 20 * U_MEDIAN_LIMIT)
    return rep


def check_tiers() -> None:
    """K1 and K2 in their device-memory tier (see the module docstring);
    exits non-zero on a case off its limits."""
    from scp_tpu_torch.ops import ipm_kernel as ik
    from scp_tpu_torch.testing import (DENSE_ARG_ORDER, kernel_inputs,
                                       torch_kernel_args)
    bad = []
    for i, (B, V, hp, hu, no, seed, hard, n_cor, tri) in enumerate(K1_CASES):
        B = 1024 if i == 0 else B
        arrs, pairs, ov = kernel_inputs(B=B, V=V, hp=hp, hu=hu, n_obst=no,
                                        seed=seed, hard_rows=hard)
        args = torch_kernel_args(arrs, device="cuda")
        kw = dict(pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6,
                  n_cor=n_cor, n_iters=7, lower_tri=tri)
        for other in ("device", "cluster"):
            if other == "cluster" and "cluster" not in getattr(
                    ik, "TIERS", ()):
                continue                     # an older checkout
            rep = {"case": f"k1_tiers_B{B}_V{V}_hp{hp}_hu{hu}_tri{int(tri)}"
                           f"_{other}",
                   **_tier_pair(ik.ipm_iterate_struct, args, kw, other)}
            print(json.dumps(rep), flush=True)
            if not rep["bit_identical"]:
                bad.append(rep["case"])
    for B, V, hp, hu, no, seed, hard, n_cor, tri, n_it in K1_DEVICE_CASES:
        arrs, pairs, ov = kernel_inputs(B=B, V=V, hp=hp, hu=hu, n_obst=no,
                                        seed=seed, hard_rows=hard)
        args = torch_kernel_args(arrs, device="cuda")
        kw = dict(pairs=pairs, obst_veh=ov, tol=1e-6, reg_rel=3e-6,
                  n_cor=n_cor, n_iters=n_it, lower_tri=tri)
        tier = ik.struct_tier(len(pairs), len(ov), hp, hu, V, tri)
        ik.reset_launch_count()
        out_k = ik.ipm_iterate_struct(*args, **kw)
        cluster = tier.tier == "cluster"
        if cluster:   # the cluster tier bit for bit the device tier
            out_dev = ik.ipm_iterate_struct(*args, **kw, tier="device")
        out_p = ik.ipm_iterate_struct_plain(*args, **kw)
        one_k = ik.ipm_iterate_struct(*args, **{**kw, "n_iters": 1})
        one_p = ik.ipm_iterate_struct_plain(*args, **{**kw, "n_iters": 1})
        torch.cuda.synchronize()
        nu = V * hu
        du = (out_k[0][:, :nu] - out_p[0][:, :nu]).abs().amax(dim=1)
        one = max(float((x - y)[:, :-1].abs().max()) for x, y in
                  zip(one_k[:1] + one_k[4:], one_p[:1] + one_p[4:]))
        rep = {"case": f"k1_device_tier_B{B}_V{V}_hp{hp}_hu{hu}",
               "tier": tier._asdict(),
               "cluster_launches": getattr(ik, "cluster_launch_count", 0),
               "device_launches": ik.device_launch_count,
               "shared_launches": ik.launch_count,
               "cluster_bit_identical_device": (
                   all(torch.equal(x, y) for x, y in zip(out_k, out_dev))
                   if cluster else None),
               "u_max": float(du.max()), "u_median": float(du.median()),
               "one_iter_max_abs_err": one,
               "finite": all(bool(torch.isfinite(t).all()) for t in out_k),
               "frozen_kernel": float(out_k[10][:, 1].mean()),
               "frozen_plain": float(out_p[10][:, 1].mean())}
        print(json.dumps(rep), flush=True)
        if (rep["cluster_bit_identical_device"] is False
                or rep["device_launches"] + rep["cluster_launches"] != 2
                + cluster
                or rep["shared_launches"] or not rep["finite"]
                or rep["u_max"] > 20 * U_ABS_LIMIT
                or rep["u_median"] > 20 * U_MEDIAN_LIMIT or one > 1e-4):
            bad.append(rep["case"])
    # K2: frog's shape in its shared tier against the device tier forced
    # (bit for bit) and the cluster tier forced; path (h)'s n = 257 in the
    # tier its shape takes (the cluster tier) against the plain version
    # and the device tier forced. Past bit equality (the cluster tier sums
    # its product in another order): finite, one iteration within 1e-4 on
    # every state entry, the controls' median within 20 x U_MEDIAN_LIMIT.
    tiers = getattr(ik, "DENSE_TIERS", ("shared", "device"))
    for B, mg, nb, d, n_cor in ((1024, 440, 1, 20, 0), (64, 384, 4, 64, 0)):
        t = dense_inputs("cuda", (B, mg, nb, d), seed=mg)
        args = [t[k] for k in DENSE_ARG_ORDER]
        kw = dict(tol=1e-6, reg_rel=3e-6, n_cor=n_cor, schur_slack=True,
                  n_iters=DENSE_ITERS)
        tier = ik.dense_tier(mg, nb * d + 1, nb, d, True, n_cor)
        rep = {"case": f"k2_B{B}_mg{mg}_n{nb * d + 1}", "tier": tier._asdict()}
        ok = True
        others = [(f"{x}_forced", ik.ipm_iterate_dense, {"tier": x})
                  for x in tiers if x not in ("shared", tier.tier)]
        if tier.tier == "shared":
            rep.update(_tier_pair(ik.ipm_iterate_dense, args, kw))
            ok = rep["bit_identical"]
            others = [o for o in others if o[0] != "device_forced"]
        else:
            others.insert(0, ("plain", ik.ipm_iterate_dense_plain, {}))
        ik.reset_launch_count()
        for name, fn, extra in others:
            rep[name] = _dense_against(args, kw, fn, extra)
            ok = ok and rep[name]["ok"]
        rep["cluster_launches"] = getattr(ik, "dense_cluster_launch_count", 0)
        print(json.dumps(rep), flush=True)
        if not ok:
            bad.append(rep["case"])
    print(json.dumps({"tier_cases_failed": bad}), flush=True)
    if bad:
        sys.exit(1)


def check_new_kernels() -> None:
    from scp_tpu_torch.ops import (_cuda_build, ipm_kernel, riccati,
                                   riccati_kernel)
    from scp_tpu_torch.testing import DENSE_ARG_ORDER, riccati_inputs
    _cuda_build.build_library(verbose=True)
    check_k1()
    if hasattr(ipm_kernel, "struct_tier"):
        check_tiers()
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
            if B == 3:   # one indefinite instance (from n = 240 its pivot
                bad_row = n // 2 if n < 240 else 100   # on rank 6 of 8)
                K[1, bad_row, bad_row] = -1.0
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
            if n >= 240 and len(_chol_variants()) > 1:
                # the cluster factor bit for bit the one-CTA large-n kernel
                geo = lk.chol_cluster_geometry(B, n)
                rep["route"] = lk.chol_route(B, n)
                rep["cluster_geometry"] = list(geo[:3])
                rep["bit_identical_device_variant"] = _same_bits(
                    L_k, lk.cholesky(K, variant="device"))
                nan_ok = nan_ok and rep["bit_identical_device_variant"]
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
            if n >= 240 and len(_solve_variants()) > 1:
                # the staged solve bit for bit the parent's large-n kernel
                rep["route"] = lk.solve_route(B, n)
                rep["bit_identical_device_variant"] = _same_bits(
                    x_k, lk.cho_solve(L, b, variant="device"))
                nan_ok = nan_ok and rep["bit_identical_device_variant"]
            print(json.dumps(rep), flush=True)
            if (not nan_ok or e_kd > 2 * e_pd + 1e-5 * scale
                    or e_kp > 1e-4 * scale):
                bad.append(rep["case"])
    # the staged solve bit for bit cho_solve_large_kernel at every large n
    # (past its capacity, n = 400, both are that kernel) x B = 1 / 16 /
    # 256 / 1,024, on factors of seeded SPD matrices with garbage above
    # the diagonal, the instance base 4 bytes past 16 at B = 16
    if len(_solve_variants()) > 1:
        gen = torch.Generator(device=dev).manual_seed(14)
        for n in (240, 257, 330, 400):
            for B in (1, 16, 256, 1024):
                a = torch.randn((B, n, n), generator=gen, device=dev)
                L = torch.linalg.cholesky(a @ a.transpose(1, 2) / n
                                          + torch.eye(n, device=dev))
                L = L.contiguous()
                del a
                L += torch.triu(torch.full_like(L, 7.0), 1)
                if B == 16:   # a copy at a base 4 bytes past 16
                    base = torch.empty(B * n * n + 1, device=dev)
                    base[1:] = L.flatten()
                    L = base[1:].view(B, n, n)
                b = torch.as_tensor(rng.normal(size=(B, n)),
                                    dtype=torch.float32, device=dev)
                fits = lk.solve_staged_smem_bytes(n) <= lk.SMEM_LIMIT_BYTES
                lk.reset_launch_counts()
                x_s = lk.cho_solve(L, b, variant="staged" if fits else None)
                staged = lk.launch_counts["cho_solve_staged"]
                x_dev = lk.cho_solve(L, b, variant="device")
                torch.cuda.synchronize()
                rep = {"case": f"cho_solve_staged_B{B}_n{n}",
                       "route": lk.solve_route(B, n), "staged_launches": staged,
                       "base_mod_16": L.data_ptr() % 16,
                       "bit_identical_device_variant": _same_bits(x_s,
                                                                  x_dev),
                       "finite": bool(torch.isfinite(x_s).all())}
                print(json.dumps(rep), flush=True)
                if (not rep["bit_identical_device_variant"]
                        or not rep["finite"]
                        or staged != fits):
                    bad.append(rep["case"])
                del L, x_s, x_dev
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
                   "geometry": list(getattr(lk, geometry)(
                       B, m, n, *(lk.sm_resources(dev) if name == "gtmv"
                                 else ()))),
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
    tiers = ((None, ctas),)
    if hasattr(ipm_kernel, "struct_tier"):   # and the device tier forced
        tiers += (("device", ipm_kernel.resident_ctas_per_sm(
            6, 0, 20, 20, 4, True, tier="device")),)
    for tier, ctas_t in tiers:
        kw_t = kw if tier is None else {**kw, "tier": tier}
        for w in (1024, 256, 64):
            aw = [None if a is None else a[:w].contiguous() for a in args]
            ms = _graph_ms(
                [lambda: ipm_kernel.ipm_iterate_struct(*aw, **kw_t)] * 10)
            print(json.dumps({"round": rnd, "kernel": "ipm_iterate_struct",
                              "tier": tier or "shape's", "B": w,
                              "graph_ms_per_call": ms,
                              "ms_per_iteration": ms / 7,
                              "resident_ctas_per_sm": ctas_t}), flush=True)


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
                    "step", "store", "product_ring_wait",
                    "product_panel_copy", "product_tiles",
                    "product_border_sums")
# (the cluster tier's product_* parts lie inside its "product"; a checkout
# without them reads zeros there)
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
                    (330, (1024, 256, 1)), (400, (1024, 256, 1)))


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
                variants = [(None, None)]
                if name == "cho_solve" and len(_solve_variants()) > 1:
                    variants = [(v, None) for v in _solve_variants()
                                if v != "staged"
                                or lk.solve_staged_smem_bytes(n)
                                <= lk.SMEM_LIMIT_BYTES]
                if name == "cholesky":
                    variants = [(v, None) for v in _chol_variants()]
                    if len(_chol_variants()) > 1:   # the cluster's size
                        variants += [("cluster", c)
                                     for c in lk.CHOL_CLUSTER_SIZES]
                try:
                    for v, c in variants:
                        key = v if c is None else f"cluster_C{c}"
                        saved = lk.CHOL_CLUSTER_SIZES
                        if c is not None:
                            if lk.chol_cluster_smem_bytes(
                                    n, c, lk.stripe_deal(n, c)[2]) > \
                                    lk.SMEM_LIMIT_BYTES:
                                continue
                            lk.CHOL_CLUSTER_SIZES = (c,)
                        try:
                            call = (lambda a: _cholesky(a, v)) \
                                if name == "cholesky" else (
                                    (lambda *a: fn(*a)) if v is None
                                    else (lambda *a: fn(*a, variant=v)))
                            call(*args)
                            rep.setdefault("graph_ms_per_call", {})[key] = {
                                "warm": _graph_ms([lambda: call(*args)] * 10),
                                "cold": _graph_ms([lambda c_=c_: call(*c_)
                                                   for c_ in copies])}
                            if v == "cluster":
                                rep.setdefault("cluster_size", {})[key] = \
                                    lk.chol_cluster_geometry(w, n)[0]
                        finally:
                            lk.CHOL_CLUSTER_SIZES = saved
                    rep["geometry"] = list(
                        (lk.chol_geometry if name == "cholesky"
                         else lk.solve_geometry)(w, n))
                except NotImplementedError as exc:
                    rep["refused"] = str(exc)[:80]
                rep["library_profiler_ms_per_call"] = {
                    "warm": _profiler_ms([lambda: lib(*args)], reps=10),
                    "cold": _profiler_ms([lambda c=c: lib(*c)
                                          for c in copies], reps=10)}
                print(json.dumps(rep), flush=True)
                del copies


# (l3)'s K2 shape: circle-4 at hp = 64, B = 256, mg = 384, n = 257, four
# 64 x 64 P blocks, the slack eliminated, no Gondzio corrector
K2_L3_SHAPE = (256, 384, 4, 64)


def _k2_tiers(shape) -> tuple:
    """K2's tiers a checkout can run ``shape`` in: the one its shape takes
    (None) and, past the shared tier, each tier it can force there."""
    from scp_tpu_torch.ops import ipm_kernel as ik
    B, mg, nb, d = shape
    out = [None]
    for tier in getattr(ik, "DENSE_TIERS", ("device",)):
        if tier == "shared":
            continue
        try:
            ik.dense_tier(mg, nb * d + 1, nb, d, True, 0, tier)
        except (NotImplementedError, ValueError):
            continue
        out.append(tier)
    return tuple(out)


def k2_l3_times(rnd, dev) -> None:
    """One QP of (l3)'s shape (``K2_L3_SHAPE``, 7 iterations) in each tier
    the checkout has (the one the shape takes first), by graph replay, warm
    and cold, beside the plain version (CUDA events)."""
    from scp_tpu_torch.ops import ipm_kernel as ik
    B, mg, nb, d = K2_L3_SHAPE
    t = dense_inputs(dev, K2_L3_SHAPE, seed=mg)
    nbytes = sum(v.numel() * 4 for v in t.values() if v is not None)
    count = 1 + -(-L2_ROTATE_BYTES // nbytes)
    copies = [{k: None if v is None else v.clone() for k, v in t.items()}
              for _ in range(count)]
    rep = {"round": rnd, "kernel": "dense_qp_l3", "B": B, "mg": mg,
           "n": nb * d + 1, "n_iters": DENSE_ITERS, "input_copies": count,
           "tier_taken": ik.dense_tier(mg, nb * d + 1, nb, d, True,
                                       0).tier}
    for tier in _k2_tiers(K2_L3_SHAPE):
        kw = DENSE_KW if tier is None else {**DENSE_KW, "tier": tier}
        rep.setdefault("graph_ms_per_qp", {})[tier or "taken"] = {
            "warm": _graph_ms([dense_qp(t, kw)] * 3, replays=3),
            "cold": _graph_ms([dense_qp(c, kw) for c in copies],
                              replays=3)}
    state = [t[k] for k in STATE]
    plain = lambda: ik.ipm_iterate_dense_plain(   # noqa: E731
        t["G"], t.get("P"), t["pb"], t["q"], t["pdiag"], *state,
        n_iters=DENSE_ITERS, **DENSE_KW)
    plain()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        plain()
    end.record()
    torch.cuda.synchronize()
    rep["plain_ms_per_qp"] = start.elapsed_time(end) / 3
    print(json.dumps(rep), flush=True)
    del copies


# The staged solve against the one-CTA solve across the widths of one wave
# of CTAs (132 SMs of an H100) and past it
K4_WIDTHS = (1, 8, 32, 66, 132, 133, 200, 264)


def k4_width_times(rnd, dev) -> None:
    """The large-n solve's two kernels (``variant="staged"`` and
    ``"device"``) at n = 240 / 257 / 330 and ``K4_WIDTHS``, by graph
    replay (warm), in turns; a checkout without the staged solve is
    skipped."""
    from scp_tpu_torch.ops import linalg_kernel as lk
    if len(_solve_variants()) < 2:
        return
    gen = torch.Generator(device=dev).manual_seed(44)
    for n in (240, 257, 330):
        a = torch.randn((max(K4_WIDTHS), n, n), generator=gen, device=dev)
        L_all = torch.linalg.cholesky(a @ a.transpose(1, 2) / n
                                      + torch.eye(n, device=dev))
        del a
        b_all = torch.randn((max(K4_WIDTHS), n), generator=gen, device=dev)
        for w in K4_WIDTHS:
            L, b = L_all[:w].contiguous(), b_all[:w].contiguous()
            ms = {v: _graph_ms([lambda v=v: lk.cho_solve(L, b, variant=v)]
                               * 20) for v in ("staged", "device")}
            print(json.dumps({"round": rnd, "kernel": "cho_solve_widths",
                              "n": n, "B": w, "graph_ms_per_call": ms,
                              "staged_over_device": ms["staged"]
                              / ms["device"]}), flush=True)
        del L_all


def k2_sections() -> None:
    """Clock cycles of block 0 of K2 by section, per IPM iteration, over
    one QP of the dense-G branch (7 iterations): frog's shape at B = 64 and
    1024, and (l3)'s (``K2_L3_SHAPE``) at B = 256 in each tier past the
    shared one (in the cluster tier block 0 is rank 0 of instance 0)."""
    import ctypes
    import subprocess
    from scp_tpu_torch.ops import _cuda_build, ipm_kernel
    if "SCP_PROFILE_SECTIONS" not in _cuda_build.BUILD_DEFINES:
        _cuda_build.BUILD_DEFINES += ("SCP_PROFILE_SECTIONS",)
    lib = _cuda_build.load_library()
    lib.ipm_dense_read_sections.argtypes = [ctypes.c_void_p]
    lib.ipm_dense_read_sections.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 24)()
    t_all = dense_inputs("cuda")
    t_l3 = dense_inputs("cuda", K2_L3_SHAPE, seed=K2_L3_SHAPE[1])
    cases = [(B, None, _cut(t_all, B)) for B in (64, 1024)] + [
        (K2_L3_SHAPE[0], tier, t_l3) for tier in _k2_tiers(K2_L3_SHAPE)]
    for B, tier, t in cases:
        qp = dense_qp(t, DENSE_KW if tier is None
                      else {**DENSE_KW, "tier": tier})
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
        mg, n = t["G"].shape[1:]
        print(json.dumps({
            "B": B, "mg": mg, "n": n, "tier": tier or ipm_kernel.dense_tier(
                mg, n, t["pb"].shape[1], t["pb"].shape[2], True, 0).tier,
            "n_iters": DENSE_ITERS,
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
            k2_l3_times(rnd, dev)
        if "k5b" in which:
            k5b_times(rnd, dev)
        if "k3k4large" in which:
            k3k4large_times(rnd, dev)
            k4_width_times(rnd, dev)
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


def _same_bits(a, b) -> bool:
    """Bit for bit equal float32 tensors (NaN entries included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _solve_variants() -> tuple:
    """The solve variants ``linalg_kernel.cho_solve`` can be forced into
    from n = 240 in this checkout (an older one: ``"device"`` only)."""
    import inspect
    from scp_tpu_torch.ops import linalg_kernel as lk
    if "variant" in inspect.signature(lk.cho_solve).parameters:
        return lk.SOLVE_LARGE_VARIANTS
    return ("device",)


def _chol_variants() -> tuple:
    """The factor variants ``linalg_kernel.cholesky`` can be forced into
    from n = 240 in this checkout (an older one has no keyword: its one
    large-n kernel is reported as ``"device"``)."""
    import inspect
    from scp_tpu_torch.ops import linalg_kernel as lk
    if "variant" in inspect.signature(lk.cholesky).parameters:
        return lk.CHOL_LARGE_VARIANTS
    return ("device",)


def _cholesky(K, variant=None):
    from scp_tpu_torch.ops import linalg_kernel as lk
    if variant is None or len(_chol_variants()) == 1:
        return lk.cholesky(K)
    return lk.cholesky(K, variant=variant)


def k3_sections() -> None:
    """Clock cycles of block 0 of the factor by section: the shared-memory
    kernel at n = 81 (each thread count) and the large-n kernels at n = 257
    (each variant: ``device``, one CTA with the matrix in device memory;
    ``cluster``, the stripes over a cluster, block 0 = rank 0 of instance
    0), B = 1 and 1024."""
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

    def run(call, rep):
        call()
        torch.cuda.synchronize()
        lib.chol_read_sections(buf)
        reps = 10
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        torch.cuda.synchronize()
        if lib.chol_read_sections(buf) != 0:
            sys.exit("reading the section counters failed")
        cyc = {k: buf[i] / reps for i, k in enumerate(names)}
        print(json.dumps({**rep, "ms_per_call_instrumented":
                          start.elapsed_time(end) / reps,
                          "block0_cycles": sum(cyc.values()),
                          "cycles": cyc}), flush=True)

    try:
        for B in (1, 1024):
            K = _spd(rng, B, 81, "cuda")
            for threads in (128, 256):
                lk.CHOL_FEW_INSTANCES, lk.CHOL_FEW_THREADS = 1 << 30, threads
                run(lambda: lk.cholesky(K),
                    {"B": B, "n": 81, "threads": threads})
    finally:
        lk.CHOL_FEW_INSTANCES, lk.CHOL_FEW_THREADS = saved
    for B in (1, 1024):
        K = _spd(rng, B, 257, "cuda")
        for variant in _chol_variants():
            rep = {"B": B, "n": 257, "variant": variant}
            if variant == "cluster":
                rep["geometry"] = list(lk.chol_cluster_geometry(B, 257)[:3])
            run(lambda: _cholesky(K, variant), rep)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


def k4_sections() -> None:
    """The staged large-n solve's timeline in block 0 at n = 257, B = 1 and
    1,024 (a library built with ``-DSCP_PROFILE_SECTIONS``): the clock
    cycles from the kernel's start at which each 16-row stripe's copy was
    seen landed, and at which the forward and the backward substitutions
    ended; the call's time by CUDA events beside the one-CTA solve's
    (``variant="device"``) in the same build."""
    import ctypes
    import subprocess
    from scp_tpu_torch.ops import _cuda_build, linalg_kernel as lk
    if "SCP_PROFILE_SECTIONS" not in _cuda_build.BUILD_DEFINES:
        _cuda_build.BUILD_DEFINES += ("SCP_PROFILE_SECTIONS",)
    lib = _cuda_build.load_library()
    lib.cho_solve_read_trace.argtypes = [ctypes.c_void_p]
    lib.cho_solve_read_trace.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * 256)()
    gen = torch.Generator(device="cuda").manual_seed(4)
    n = 257
    for B in (1, 1024):
        a = torch.randn((B, n, n), generator=gen, device="cuda")
        L = torch.linalg.cholesky(a @ a.transpose(1, 2) / n
                                  + torch.eye(n, device="cuda")).contiguous()
        b = torch.randn((B, n), generator=gen, device="cuda")
        ms = {}
        for v in ("staged", "device"):
            lk.cho_solve(L, b, variant=v)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                lk.cho_solve(L, b, variant=v)
            end.record()
            torch.cuda.synchronize()
            ms[v] = start.elapsed_time(end) / 20
        lk.cho_solve(L, b, variant="staged")
        torch.cuda.synchronize()
        if lib.cho_solve_read_trace(buf) != 0:
            sys.exit("reading the solve's trace failed")
        ns = -(-n // 16)
        fwd = [(buf[64 + 2 * k], buf[65 + 2 * k]) for k in range(ns - 1)]
        bwd = [(buf[128 + 2 * k], buf[129 + 2 * k])
               for k in range(ns - 1, 0, -1)]
        print(json.dumps({
            "B": B, "n": n, "ms_per_call_instrumented": ms,
            "stripe_landed_cycles": [buf[i] for i in range(ns)],
            "forward_end_cycles": buf[32], "backward_end_cycles": buf[33],
            # warp 0's part of each step, and the wait for the step's end
            "forward_lead_cycles": [b - a for a, b in fwd],
            "forward_step_cycles": [fwd[k + 1][0] - fwd[k][0]
                                    for k in range(len(fwd) - 1)],
            "backward_lead_cycles": [b - a for a, b in bwd],
            "backward_step_cycles": [bwd[k + 1][0] - bwd[k][0]
                                     for k in range(len(bwd) - 1)]}),
            flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


TRACE_POINTS = ("taken", "solved", "pushed", "received", "next_factored",
                "trailing_done")


def k3_trace() -> None:
    """The cluster factor's timeline at B = 1 (n = 257 and 400, C = 8): the
    library built with ``-DSCP_CLUSTER_TRACE`` records the global timer on
    thread 0 of each rank at six points of each panel (``TRACE_POINTS``);
    prints, per n, the medians over panels of each rank's step durations,
    the next diagonal block's owner's (its update, pivots and push), the
    hop from that push to each rank holding the block, and a panel's
    period."""
    import ctypes
    import subprocess
    from scp_tpu_torch.ops import _cuda_build, linalg_kernel as lk
    if "SCP_CLUSTER_TRACE" not in _cuda_build.BUILD_DEFINES:
        _cuda_build.BUILD_DEFINES += ("SCP_CLUSTER_TRACE",)
    lib = _cuda_build.load_library()
    lib.chol_read_trace.argtypes = [ctypes.c_void_p]
    lib.chol_read_trace.restype = ctypes.c_int
    panels, points = 64, len(TRACE_POINTS)
    buf = (ctypes.c_ulonglong * (8 * panels * points))()
    rng = np.random.default_rng(6)
    for n in (257, 400):
        K = _spd(rng, 1, n, "cuda")
        C, _, _, (owner, _, _) = lk.chol_cluster_geometry(1, n)
        for _ in range(5):
            lk.cholesky(K)
        torch.cuda.synchronize()
        if lib.chol_read_trace(buf) != 0:
            sys.exit("reading the trace failed")
        t = np.array(buf, dtype=np.float64).reshape(8, panels, points)
        ns = -(-n // 16)
        med = {}
        for a, b in ((0, 1), (1, 2), (2, 3), (3, 5)):
            d = t[:C, :ns - 1, b] - t[:C, :ns - 1, a]
            med[f"{TRACE_POINTS[a]}->{TRACE_POINTS[b]}"] = float(
                np.median(d))
        lead = [owner[p + 1] for p in range(ns - 1)]
        own = np.array([t[lead[p], p, 4] - t[lead[p], p, 2]
                        for p in range(ns - 1)])
        hop = np.array([t[:C, p + 1, 0] - t[lead[p], p, 4]
                        for p in range(ns - 2)])
        period = t[:C, 1:ns - 1, 0] - t[:C, :ns - 2, 0]
        print(json.dumps({
            "n": n, "C": C, "panels": ns - 1,
            "median_ns_by_step": med,
            "owner_update_pivots_push_ns": float(np.median(own)),
            "hop_push_to_rank_taken_ns": {
                "median": float(np.median(hop)), "min": float(hop.min()),
                "max": float(hop.max())},
            "panel_period_ns": float(np.median(period)),
            "factor_ns": float(t[:C, ns - 2, 5].max() - t[:C, 0, 0].min())}),
            flush=True)
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
    ap.add_argument("--sections", nargs="*",
                    choices=("k3", "k6k7", "k2", "k3trace", "k4"),
                    metavar="KERNEL",
                    help="cycles by section (default: k3)")
    ap.add_argument("--pivots", action="store_true")
    ap.add_argument("--tiers", action="store_true",
                    help="build, then K1 / K2 in their device tier only")
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
    elif args.tiers:
        from scp_tpu_torch.ops import _cuda_build
        _cuda_build.build_library(verbose=True)
        check_tiers()
    elif args.sections is not None:
        if "k6k7" in args.sections:
            k6k7_sections()
        if "k2" in args.sections:
            k2_sections()
        if "k4" in args.sections:
            k4_sections()
        if "k3trace" in args.sections:
            k3_trace()
        if not args.sections or "k3" in args.sections:
            k3_sections()
    else:
        check_new_kernels()


if __name__ == "__main__":
    main()
