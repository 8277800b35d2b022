"""Error growth of the fused IPM kernel (scp_tpu_torch) over its iterations.

Run on a machine with an NVIDIA GPU, from the repository root::

    python3 scripts/torch_k1_accuracy.py [--batch 1024]

Captures the kernel's inputs from a real first SCP iteration of the
randomized 4-vehicle circle batch (hp = hu = 20, float32, tuned_f32), then
for n_iters = 1..7 compares three versions on the same inputs: the CUDA
kernel, the plain PyTorch version in float32, and the plain version in
float64 (the oracle). Prints one JSON line per iteration count with the
max / 99th percentile / median error of the controls and of the slack
variable, so float32 drift can be told apart from a kernel fault.
"""
import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def stats(a, b):
    d = (a - b).abs().amax(dim=1).double()
    return {"max": float(d.max()), "p99": float(d.quantile(0.99)),
            "median": float(d.median())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from scp_tpu_torch import config as config_lib
    from scp_tpu_torch.ops import ipm_kernel
    from scp_tpu_torch.scenarios import batch as batch_lib
    from scp_tpu_torch.sim import engine

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(42)
    cfg, data = batch_lib.make_batch("circle", opts.batch, generator=gen,
                                     dtype=torch.float32, device=dev, n_veh=4)
    cfg = config_lib.tuned_f32(cfg.replace(hp=20, hu=20))
    captured = []
    real = ipm_kernel.ipm_iterate_struct

    def recorder(*args, **kw):
        captured.append((args, kw))
        return real(*args, **kw)

    ipm_kernel.ipm_iterate_struct = recorder
    try:
        engine.mpc_step_batch(cfg, data, engine.init_carry(cfg, data),
                              phases=config_lib.TUNED_F32_PHASES)
    finally:
        ipm_kernel.ipm_iterate_struct = real
    args, kw = captured[0]
    args64 = [None if a is None else a.double() for a in args]
    nu = args[7].shape[1] - 1
    for k in range(1, 8):
        kw_k = {**kw, "n_iters": k}
        out_k = real(*args, **kw_k)
        out_p = ipm_kernel.ipm_iterate_struct_plain(*args, **kw_k)
        out_d = ipm_kernel.ipm_iterate_struct_plain(
            *args64, **{**kw_k, "reg_rel": 1e-12})
        xk, xp, xd = out_k[0], out_p[0], out_d[0].float()
        print(json.dumps({
            "n_iters": k,
            "u_kernel_vs_plain32": stats(xk[:, :nu], xp[:, :nu]),
            "u_kernel_vs_plain64": stats(xk[:, :nu], xd[:, :nu]),
            "u_plain32_vs_plain64": stats(xp[:, :nu], xd[:, :nu]),
            "slack_kernel_vs_plain32": stats(xk[:, nu:], xp[:, nu:]),
            "slack_kernel_vs_plain64": stats(xk[:, nu:], xd[:, nu:]),
            "slack_plain32_vs_plain64": stats(xp[:, nu:], xd[:, nu:]),
            "frozen_kernel": float(out_k[10][:, 1].mean()),
            "frozen_plain32": float(out_p[10][:, 1].mean()),
            "frozen_plain64": float(out_d[10][:, 1].mean()),
            "mu_kernel_median": float(out_k[10][:, 0].median()),
        }), flush=True)


if __name__ == "__main__":
    main()
