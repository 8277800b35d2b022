"""The port's multi-rank dry run (counterpart of
``__graft_entry__.dryrun_multichip``).

:func:`dryrun_multichip` runs inside an initialised job of ``n_ranks``
ranks: one sharded MPC step of a small circle batch over a (data, model)
layout (``n_model = 2`` when ``n_ranks`` is even), the step's summary
reduced over the data axis, and — with a model axis — the horizon-sharded
SCP solve held against the unsharded solve of the padded system (largest
control difference below 1e-5, the same SCP iteration counts).

Run it on this host's ranks::

    python -m scp_tpu_torch.parallel.dryrun --ranks 4 --cpu
    python -m scp_tpu_torch.parallel.dryrun --ranks 2          # 2 cards

The launcher starts the ranks as ``torchrun`` would
(``distributed.launch_local``); each joins with gloo (``--cpu``) or NCCL
(one card per rank).
"""
from __future__ import annotations

import argparse
import sys

import torch

from scp_tpu_torch import require_device
from scp_tpu_torch.parallel import distributed, horizon, mesh as mesh_lib

DU_LIMIT = 1e-5


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """The sharded MPC step and the sharded-against-unsharded solve check
    on ``n_ranks`` ranks (circle, 3 vehicles, hp = hu = 6, batch
    ``2 * n_ranks``, float32). Raises ``AssertionError`` on every rank when
    any rank's check fails."""
    from scp_tpu_torch.scenarios import batch as batch_lib
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.solvers import scp

    dev = require_device(device)
    n_model = 2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1
    mesh = mesh_lib.make_mesh(n_ranks // n_model, n_model)
    world = mesh_lib.world_group()

    gen = torch.Generator(device=dev).manual_seed(7)
    cfg, data = batch_lib.make_batch("circle", 2 * n_ranks, generator=gen,
                                     dtype=torch.float32, device=dev,
                                     n_veh=3)
    cfg = cfg.replace(hp=6, hu=6, max_scp_iter=3, qp_max_iter=8,
                      delta_tol_rel=1e-4, qp_tol=1e-5)
    block = mesh_lib.shard_batch(data, mesh)
    carry = engine.init_carry(cfg, block)
    if n_model > 1:
        _, out = engine.mpc_step_horizon(
            cfg, block, carry, axis_name=mesh.groups["model"],
            n_shards=n_model)
    else:
        _, out = engine.mpc_step(cfg, block, carry)
    total_obj = mesh_lib.all_reduce(out.obj.sum(), mesh.groups["data"])
    total_iters = mesh_lib.all_reduce(out.scp_iters.sum(),
                                      mesh.groups["data"])
    finite = mesh_lib.all_true(torch.isfinite(total_obj)[None], world)
    assert bool(finite), "non-finite objective in dry run"

    report = {"mesh": dict(mesh.shape), "batch": 2 * n_ranks,
              "total_obj": float(total_obj),
              "scp_iters": int(total_iters)}
    if n_model > 1:
        # the solver stage with its inputs sharded over both axes, pinned
        # against the unsharded solve of the padded system on this block
        carry1 = engine.init_carry(cfg, data)
        problem, _ = engine.controller_pre(cfg, data, carry1)
        kw = engine._scp_kwargs(cfg)
        res = horizon.solve_scp_sharded(cfg, problem, carry1.u_warm, mesh,
                                        **kw)
        padded = problem._replace(sys=horizon.pad_system(problem.sys,
                                                         n_model))
        p_blk, u_blk = mesh_lib.shard_batch((padded, carry1.u_warm), mesh)
        ref = scp.solve_scp(p_blk, u_blk, max_scp_iter=cfg.max_scp_iter,
                            **kw)
        du = float((res.u - ref.u).abs().max())
        same = torch.equal(res.iters, ref.iters)
        ok = torch.tensor(
            [bool(torch.isfinite(res.u).all()), du < DU_LIMIT, same],
            device=dev)
        ok = mesh_lib.all_true(ok, world).tolist()
        report.update(du=du, same_scp_iters=same)
        assert ok[0], "non-finite sharded solve"
        assert ok[1], f"sharded vs unsharded solve deviates: du = {du}"
        assert ok[2], "sharded vs unsharded SCP iteration counts differ"
    print(f"dryrun_multichip: mesh={report['mesh']} batch={2 * n_ranks} "
          f"total_obj={report['total_obj']:.3f} "
          f"scp_iters={report['scp_iters']}"
          + (f" du={report['du']:.3g}" if "du" in report else ""),
          flush=True)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scp_tpu_torch.parallel.dryrun")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--cpu", action="store_true",
                   help="CPU ranks under gloo (default: one card per rank "
                        "under NCCL)")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds before every rank is killed")
    p.add_argument("--worker", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        if args.cpu:
            torch.set_num_threads(1)
        distributed.initialize(backend="gloo" if args.cpu else "nccl",
                               timeout=60.0)
        try:
            dryrun_multichip(args.ranks,
                             distributed.local_device(args.cpu))
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        return 0
    child = ["-m", "scp_tpu_torch.parallel.dryrun", "--worker",
             "--ranks", str(args.ranks)]
    if args.cpu:
        child.append("--cpu")
    results = distributed.launch_local(child, args.ranks,
                                       timeout=args.timeout)
    code = 0
    for r in results:
        sys.stdout.write(f"[rank {r['rank']}] {r['stdout']}")
        if r["returncode"] != 0:
            code = 1
            sys.stderr.write(f"[rank {r['rank']}] exit {r['returncode']}:\n"
                             f"{r['stderr'][-3000:]}")
    return code


if __name__ == "__main__":
    sys.exit(main())
