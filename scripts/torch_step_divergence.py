"""Where the kernel path and the plain path of one MPC step part (scp_tpu_torch).

Run on a machine with an NVIDIA GPU, from the repository root::

    python3 scripts/torch_step_divergence.py [--path circle|frog]
        [--batch 1024] [--worst 8] [--seed 42]

Drives the first ``mpc_step_batch`` step of a randomized batch (hp = hu =
20, tuned_f32, TUNED_F32_PHASES) three ways: float32 through the CUDA
kernel, float32 through the kernel's plain PyTorch version, and float64
through the plain version (the oracle). ``--path circle`` (the default): the
4-vehicle circle through the structured kernel (K1); ``--path frog``: the
single-vehicle frog through the dense-G kernel (K2). During the kernel run every
launch is shadowed: the plain float32 version and the float64 oracle solve
the SAME inputs, so a disagreement of the kernel on identical inputs (a
kernel fault) can be told apart from two float32 solvers drifting apart over
the SCP iterations (sensitivity of the non-convex outer loop to round-off).

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
    ap.add_argument("--path", choices=("circle", "frog"), default="circle")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--worst", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.config import tree_map
    from scp_tpu_torch.ops import ipm_kernel
    from scp_tpu_torch.scenarios import batch as batch_lib
    from scp_tpu_torch.sim import engine

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(opts.seed)
    kw_b = dict(n_veh=4) if opts.path == "circle" else {}
    cfg, data = batch_lib.make_batch(opts.path, opts.batch, generator=gen,
                                     dtype=torch.float32, device=dev, **kw_b)
    cfg = config_lib.tuned_f32(cfg.replace(hp=20, hu=20))
    phases = config_lib.TUNED_F32_PHASES
    name = ("ipm_iterate_struct" if opts.path == "circle"
            else "ipm_iterate_dense")
    real = getattr(ipm_kernel, name)
    plain = getattr(ipm_kernel, name + "_plain")
    g_arg = 7 if opts.path == "circle" else 1   # an argument of width n

    def err(a, b):
        return (a - b).abs().amax(dim=1).double()

    launch = [0]

    def shadow(*args, **kw):
        out_k = real(*args, **kw)
        out_p = plain(*args, **kw)
        args64 = [None if a is None else a.double() for a in args]
        out_d = plain(*args64, **{**kw, "reg_rel": 1e-12})
        nu = args[g_arg].shape[-1] - 1
        uk, up, ud = (o[0][:, :nu] for o in (out_k, out_p, out_d))
        e_kp, e_kd, e_pd = err(uk, up), err(uk, ud.float()), err(up, ud.float())
        print(json.dumps({
            "launch": launch[0], "B": args[0].shape[0],
            "u_kernel_vs_plain32_max": float(e_kp.max()),
            "u_kernel_vs_plain32_p99": float(e_kp.quantile(0.99)),
            "u_kernel_vs_plain32_median": float(e_kp.median()),
            "u_kernel_vs_f64_max": float(e_kd.max()),
            "u_plain32_vs_f64_max": float(e_pd.max()),
            "frozen_kernel": float(out_k[10][:, 1].mean()),
            "frozen_plain32": float(out_p[10][:, 1].mean()),
        }), flush=True)
        launch[0] += 1
        return out_k

    def step(data_, wrapper):
        setattr(ipm_kernel, name, wrapper)
        try:
            _, out = engine.mpc_step_batch(
                cfg, data_, engine.init_carry(cfg, data_), phases=phases)
        finally:
            setattr(ipm_kernel, name, real)
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


if __name__ == "__main__":
    main()
