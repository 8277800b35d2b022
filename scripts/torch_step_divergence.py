"""Where the kernel path and the plain path of one MPC step part (scp_tpu_torch).

Run on a machine with an NVIDIA GPU, from the repository root::

    python3 scripts/torch_step_divergence.py [--path circle|frog|long_horizon]
        [--batch B] [--worst 8] [--seed 42] [--shadow N]

Drives the first ``mpc_step_batch`` step of a randomized batch (tuned_f32,
TUNED_F32_PHASES) three ways: float32 through the CUDA kernels, float32
through their plain PyTorch versions, and float64 through the plain versions
(the oracle). ``--path circle`` (the default): the 4-vehicle circle, hp = hu
= 20, B = 1024, through the structured kernel (K1); ``--path frog``: the
single-vehicle frog through the dense-G kernel (K2); ``--path
long_horizon``: the 4-vehicle circle at hp = hu = 64, B = 256, through the
Riccati factor and solve (K6 / K7), whose step also reports the feasible
share of the three runs. During the kernel run the first ``--shadow``
launches of each kernel (all of them by default on circle and frog, 24 on
long_horizon) are shadowed: the plain float32 version and the float64
oracle solve the SAME inputs, so a disagreement of the kernel on identical
inputs (a kernel fault) can be told apart from two float32 solvers drifting
apart over the SCP iterations (sensitivity of the non-convex outer loop to
round-off). On circle and frog the plain float32 version also solves the
same inputs perturbed by one part in 2^23 (a fixed random sign per entry):
how far a launch's fixed IPM iterations carry a float32 round-off, the
yardstick of the kernel's difference from the plain version.

Prints one JSON line per launch (errors of the controls on identical inputs)
and one for the step (per-instance difference of the clamped control
prediction between the three runs, with the worst instances listed, and
``chip_smoke.py``'s step limit: how many instances of the kernel's step lie
further from the float64 step than twice the plain float32 step plus 5e-3,
and the largest excess). ``--seed`` draws another batch (``chip_smoke.py``
uses 42).
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("circle", "frog", "long_horizon"),
                    default="circle")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--worst", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--shadow", type=int, default=None)
    opts = ap.parse_args()
    long = opts.path == "long_horizon"
    opts.batch = opts.batch or (256 if long else 1024)
    if opts.shadow is None:
        opts.shadow = 24 if long else 1 << 30
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.config import tree_map
    from scp_tpu_torch.ops import ipm_kernel
    from scp_tpu_torch.scenarios import batch as batch_lib
    from scp_tpu_torch.sim import engine

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    kind = "frog" if opts.path == "frog" else "circle"
    kw_b = dict(n_veh=4) if kind == "circle" else {}
    hp = 64 if long else 20
    cfg, data = batch_lib.make_batch(kind, opts.batch, generator=gen,
                                     dtype=torch.float32, device=dev, **kw_b)
    cfg = config_lib.tuned_f32(cfg.replace(hp=hp, hu=hp))
    phases = config_lib.TUNED_F32_PHASES
    if long:
        return long_horizon(opts, cfg, data, phases, tree_map)
    name = ("ipm_iterate_struct" if opts.path == "circle"
            else "ipm_iterate_dense")
    real = getattr(ipm_kernel, name)
    plain = getattr(ipm_kernel, name + "_plain")
    g_arg = 7 if opts.path == "circle" else 0   # an argument of width n

    def err(a, b):
        return (a - b).abs().amax(dim=1).double()

    launch = [0]
    gen_p = torch.Generator(device=dev).manual_seed(1)

    def perturbed(a):
        if a is None or not a.is_floating_point():
            return a
        sign = torch.randint(0, 2, a.shape, generator=gen_p, device=dev)
        return a * (1.0 + (2.0 * sign - 1.0) * 2.0 ** -23)

    def shadow(*args, **kw):
        out_k = real(*args, **kw)
        out_p = plain(*args, **kw)
        # (every operand but scal, the last: mu_prev and the freeze flags)
        out_q = plain(*[perturbed(a) for a in args[:-1]], args[-1], **kw)
        args64 = [None if a is None else a.double() for a in args]
        out_d = plain(*args64, **{**kw, "reg_rel": 1e-12})
        nu = args[g_arg].shape[-1] - 1
        uk, up, uq, ud = (o[0][:, :nu] for o in (out_k, out_p, out_q, out_d))
        e_kp, e_kd, e_pd = err(uk, up), err(uk, ud.float()), err(up, ud.float())
        e_pq = err(up, uq)
        print(json.dumps({
            "launch": launch[0], "B": args[0].shape[0],
            "n_iters": kw.get("n_iters", 1),
            "u_kernel_vs_plain32_max": float(e_kp.max()),
            "u_kernel_vs_plain32_p99": float(e_kp.quantile(0.99)),
            "u_kernel_vs_plain32_median": float(e_kp.median()),
            "u_plain32_vs_perturbed_max": float(e_pq.max()),
            "u_plain32_vs_perturbed_p99": float(e_pq.quantile(0.99)),
            "u_plain32_vs_perturbed_median": float(e_pq.median()),
            "u_kernel_vs_f64_max": float(e_kd.max()),
            "u_plain32_vs_f64_max": float(e_pd.max()),
            "frozen_kernel": float(out_k[10][:, 1].mean()),
            "frozen_plain32": float(out_p[10][:, 1].mean()),
            "frozen_differ_kernel_vs_plain32": int(
                (out_k[10][:, 1] != out_p[10][:, 1]).sum()),
            "frozen_differ_plain32_vs_perturbed": int(
                (out_p[10][:, 1] != out_q[10][:, 1]).sum()),
        }), flush=True)
        launch[0] += 1
        return out_k

    from scp_tpu_torch.ops import linalg, linalg_kernel as lk
    real_mv = (lk.gmv, lk.gtmv)

    def step(data_, wrapper):
        setattr(ipm_kernel, name, wrapper)
        if data_.x0.dtype == torch.float64:
            # the dense-G branch also multiplies by G through the float32
            # matvec kernels: the float64 oracle takes their plain versions
            lk.gmv, lk.gtmv = linalg.gmv_plain, linalg.gtmv_plain
        try:
            _, out = engine.mpc_step_batch(
                cfg, data_, engine.init_carry(cfg, data_), phases=phases)
        finally:
            setattr(ipm_kernel, name, real)
            lk.gmv, lk.gtmv = real_mv
        torch.cuda.synchronize()
        return out

    data64 = tree_map(
        lambda t: t.double() if t.is_floating_point() else t, data)
    out_k = step(data, shadow)
    out_p = step(data, plain)
    out_d = step(data64, plain)

    def du(a, b):
        return (a.u_pred.double() - b.u_pred.double()).abs().amax(dim=(1, 2))

    d_kp, d_kd, d_pd = du(out_k, out_p), du(out_k, out_d), du(out_p, out_d)

    def stats(d):
        return {"max": float(d.max()), "p99": float(d.quantile(0.99)),
                "median": float(d.median())}

    worst = torch.argsort(d_kp, descending=True)[:opts.worst].tolist()
    excess = d_kd - (2 * d_pd + 5e-3)
    print(json.dumps({
        "step": "first", "path": opts.path, "B": opts.batch,
        "seed": opts.seed,
        "instances_beyond_2x_plain32_of_f64_plus_5e-3": int(
            (excess > 0).sum()),
        "largest_excess": float(excess.max()),
        "u_pred_kernel_vs_plain32": stats(d_kp),
        "u_pred_kernel_vs_f64": stats(d_kd),
        "u_pred_plain32_vs_f64": stats(d_pd),
        "share_kernel_within_2x_plain32_of_f64_plus_5e-3": float(
            (d_kd <= 2 * d_pd + 5e-3).double().mean()),
        "worst_by_kernel_vs_plain32": [{
            "instance": i,
            "kernel_vs_plain32": float(d_kp[i]),
            "kernel_vs_f64": float(d_kd[i]),
            "plain32_vs_f64": float(d_pd[i]),
            "scp_iters": [int(o.scp_iters[i]) for o in (out_k, out_p, out_d)],
            "obj": [float(o.obj[i]) for o in (out_k, out_p, out_d)],
            "max_violation": [float(o.max_violation[i])
                              for o in (out_k, out_p, out_d)],
            "feasible": [bool(o.feasible[i]) for o in (out_k, out_p, out_d)],
        } for i in worst],
    }), flush=True)


def long_horizon(opts, cfg, data, phases, tree_map):
    """The long-horizon step three ways, with K6 / K7 launches shadowed."""
    from scp_tpu_torch.ops import linalg, linalg_kernel as lk, riccati
    from scp_tpu_torch.ops import riccati_kernel as rk
    from scp_tpu_torch.sim import engine

    owner = {"riccati_factor": rk, "riccati_solve": rk, "gmv": lk,
             "gtmv": lk}
    real = {k: getattr(owner[k], k) for k in owner}
    plain = {"riccati_factor":
             lambda *a: tuple(riccati.riccati_factor_plain(*a)),
             "riccati_solve": riccati.riccati_solve_plain,
             "gmv": linalg.gmv_plain, "gtmv": linalg.gtmv_plain}
    seen = {"riccati_factor": 0, "riccati_solve": 0}

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / max(
            float(b.abs().max()), 1e-30)

    def shadow(name):
        def call(*args):
            out = real[name](*args)
            if seen[name] < opts.shadow:
                outs = out if isinstance(out, tuple) else (out,)
                p32 = plain[name](*args)
                p32 = p32 if isinstance(p32, tuple) else (p32,)
                p64 = plain[name](*[a.double() for a in args])
                p64 = p64 if isinstance(p64, tuple) else (p64,)
                print(json.dumps({
                    "kernel": name, "launch": seen[name],
                    "B": args[0].shape[0],
                    "n_rhs": (args[-1].shape[0] if name == "riccati_solve"
                              and args[-1].ndim == 4 else 1),
                    "kernel_vs_plain32_rel": max(
                        rel(k, p) for k, p in zip(outs, p32)),
                    "kernel_vs_f64_rel": max(
                        rel(k, d) for k, d in zip(outs, p64)),
                    "plain32_vs_f64_rel": max(
                        rel(p, d) for p, d in zip(p32, p64)),
                    "finite": all(bool(torch.isfinite(k).all())
                                  for k in outs)}), flush=True)
            seen[name] += 1
            return out
        return call

    def step(data_, fns):
        for k, fn in fns.items():
            setattr(owner[k], k, fn)
        try:
            _, out = engine.mpc_step_batch(
                cfg, data_, engine.init_carry(cfg, data_), phases=phases)
        finally:
            for k in fns:
                setattr(owner[k], k, real[k])
        torch.cuda.synchronize()
        return out

    data64 = tree_map(
        lambda t: t.double() if t.is_floating_point() else t, data)
    out_k = step(data, {k: shadow(k) for k in seen})
    out_p = step(data, {k: plain[k] for k in seen})
    out_d = step(data64, plain)        # the float32-only kernels routed too

    def du(a, b):
        return (a.u_pred.double() - b.u_pred.double()).abs().amax(dim=(1, 2))

    d_kp, d_kd, d_pd = du(out_k, out_p), du(out_k, out_d), du(out_p, out_d)
    excess = d_kd - (2 * d_pd + 5e-3)
    # the feasible share over chained steps, as chip_smoke.py reads it
    carry, feas = engine.init_carry(cfg, data), []
    for _ in range(4):
        carry, out = engine.mpc_step_batch(cfg, data, carry, phases=phases)
        feas.append(float(out.feasible.float().mean()))
    print(json.dumps({
        "step": "first", "path": "long_horizon", "B": opts.batch,
        "hp": cfg.hp, "seed": opts.seed, "launches_first_step": seen,
        "feasible_share_first_step": {
            "kernel": float(out_k.feasible.float().mean()),
            "plain32": float(out_p.feasible.float().mean()),
            "f64": float(out_d.feasible.float().mean())},
        "feasible_share_4_chained_steps_kernel": sum(feas) / len(feas),
        "instances_beyond_2x_plain32_of_f64_plus_5e-3": int(
            (excess > 0).sum()),
        "largest_excess": float(excess.max()),
        "u_pred_kernel_vs_plain32_max": float(d_kp.max()),
        "u_pred_kernel_vs_plain32_p99": float(d_kp.quantile(0.99)),
        "u_pred_kernel_vs_plain32_median": float(d_kp.median()),
        "u_pred_kernel_vs_f64_max": float(d_kd.max()),
        "u_pred_plain32_vs_f64_max": float(d_pd.max())}), flush=True)


if __name__ == "__main__":
    main()
