"""Debugging aids (counterpart of ``scp_tpu/utils/debug.py``; the rest of
that module waits for roadmap item 10)."""
from __future__ import annotations


def scp_iteration_trace(cfg, data, carry=None) -> dict:
    """Per-SCP-iteration optimization trace for ONE scenario instance.

    Runs the controller preprocessing for the scenario (a batch of one,
    ``data`` as the builders return it) and solves the SCP with
    ``trace=True``, returning host numpy arrays truncated to the iterations
    that actually ran:

    ``{"obj", "max_violation", "merit", "delta", "qp_converged", "iters",
    "u", "feasible"}`` (``u`` of shape (V*hu,)).

    ``carry``: a :class:`scp_tpu_torch.sim.engine.SimCarry` mid-run state of
    that scenario (e.g. sliced out of a batched run at the misbehaving
    step); defaults to the initial state.
    """
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.solvers import scp as scp_lib

    if cfg.controller != "scp":
        raise ValueError("the trace records the SCP loop (controller 'scp')")
    if data.x0.shape[0] != 1:
        raise ValueError("the trace is of ONE scenario instance (B = 1)")
    if carry is None:
        carry = engine.init_carry(cfg, data)
    problem, _ = engine.controller_pre(cfg, data, carry)
    res, tr = scp_lib.solve_scp(problem, carry.u_warm,
                                max_scp_iter=cfg.max_scp_iter,
                                trace=True, **engine._scp_kwargs(cfg))
    n_it = int(tr.active[0].sum())
    out = {k: v[0, :n_it].cpu().numpy() for k, v in tr._asdict().items()
           if k != "active"}
    out.update(iters=n_it, u=res.u[0].cpu().numpy(),
               feasible=bool(res.feasible[0]))
    return out
