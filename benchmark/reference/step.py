"""One MPC step of the plain reference from a carry, with what each layer
of it produced: the condensed QP, the first QP's result, the controller's
result (clamped prediction and objective) and the plant's next state."""
from __future__ import annotations

import contextlib

import torch

from reference import engine, qp, scp
from reference.config import SCPConfig, ScenarioData, VehicleParams

PARAMS = ("lf", "lr", "length", "width", "q", "q_final", "r")


def scenario(tensors: dict, dtype) -> ScenarioData:
    """The reference's container of the benchmark's generated tensors."""
    def f(name):
        t = tensors[name]
        return t if t.dtype == torch.bool else t.to(dtype)
    return ScenarioData(
        x0=f("x0"), u0=f("u0"),
        params=VehicleParams(**{k: f(k) for k in PARAMS}),
        ref_points=f("ref_points"), ref_valid=f("ref_valid"),
        obstacles=f("obstacles"), dsafe_veh=f("dsafe_veh"),
        dsafe_obst=f("dsafe_obst"))


@contextlib.contextmanager
def _first_qp(into: dict):
    orig = qp.solve_qp_batched

    def wrapped(*args, **kw):
        sol = orig(*args, **kw)
        into.setdefault("qp_x", sol.x)
        return sol

    qp.solve_qp_batched = wrapped
    try:
        yield
    finally:
        qp.solve_qp_batched = orig


def run(config: dict, tensors: dict, carry: dict, dtype=torch.float64,
        controller: bool = True) -> dict:
    """The reference step of the instances in ``tensors`` (the benchmark's
    inputs) from ``carry`` (the state the port's closed loop reached:
    ``state``, ``u_prev2``, ``u_prev1``, ``u_warm``, ``state_meas``,
    ``step``). Under SCP the straggler phases follow the configuration's
    ``phases`` with the reference's own convergence
    (:func:`scp.solve_scp_batch`). ``controller=False`` leaves out the
    controller (and the first QP): the pre-processing's and the plant's
    layers alone."""
    qp.PRECISION = getattr(torch, config["dtype"])
    cfg = SCPConfig(**config["settings"])
    data = scenario(tensors, dtype)
    c = engine.SimCarry(
        state=carry["state"].to(dtype), u_prev2=carry["u_prev2"].to(dtype),
        u_prev1=carry["u_prev1"].to(dtype), u_warm=carry["u_warm"].to(dtype),
        step=int(carry["step"]), generator=None,
        state_meas=carry["state_meas"].to(dtype))
    out = {}
    problem, aux = engine.controller_pre(cfg, data, c)
    sys_, u_max = aux[0], aux[1]
    out.update(phi0=problem.phi0, psi0=problem.psi0, b3=sys_.b3,
               const3=sys_.const3)
    if not controller:
        states = engine.rollout_plant(cfg, data, c.state, c.u_prev2,
                                      c.u_prev1)
        out["state_next"] = states[:, -1]
        return out
    with _first_qp(out):
        if cfg.controller == "side_selection":
            res, _ = engine._side_selection_solve(cfg, data, c, aux)
        else:
            res = scp.solve_scp_batch(
                problem, c.u_warm,
                phases=tuple(map(tuple, config["phases"])),
                **engine._scp_kwargs(cfg))
    _, U_raw = scp.forward_u(sys_, res.u)
    out["u_pred"] = engine.clamp_controls(cfg, U_raw, c.u_prev1, u_max)
    out["obj"] = res.obj
    out["iters"] = res.iters
    states = engine.rollout_plant(cfg, data, c.state, c.u_prev2, c.u_prev1)
    out["state_next"] = states[:, -1]
    return out
