"""Frozen copy of the pieces of ``sim/engine.py`` of the PyTorch port that
one MPC step runs (steering limit, delay compensation, reference sampling,
obstacle forecast, discretize / condense, the controller, the clamps and
the plant rollout), for the benchmark's plain reference; imports nothing
of the port. ``SimCarry`` is the port's carry, copied so that the
reference reads the same fields.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference import bicycle, condensed, discretize, miqp, reference_path, scp
from reference import constraints as con
from reference.config import NY, SCPConfig, ScenarioData

# Obstacle table column indices (``scenarios/builders.py``)
OBST_X, OBST_Y, OBST_HEADING, OBST_SPEED, OBST_LENGTH, OBST_WIDTH = range(6)


class SimCarry(NamedTuple):
    state: torch.Tensor    # (B, V, NX) plant state at the current tick
    u_prev2: torch.Tensor  # (B, V) command applied during the delay window
    u_prev1: torch.Tensor  # (B, V) last command (active for the rest)
    u_warm: torch.Tensor   # (B, V*HP) SCP warm start = previous solution
    step: int              # MPC step index (host integer, same for the batch)
    generator: torch.Generator | None  # plant-noise generator (on the device)
    state_meas: torch.Tensor | None = None
    # (B, V, NX) the MEASURED state: the plant state ticks_delay_x ticks in
    # the past. Equals ``state`` when delay_x == 0; None defaults to it.
    state_hist: torch.Tensor | None = None
    # (B, ticks_delay_x, V, NX) ring buffer of the plant states at the
    # ticks_delay_x ticks BEFORE the current step boundary; None when
    # delay_x == 0.
    noise_offset: int = 0
    noise_total: int | None = None
    # the plant noise of a block of a larger batch: each tick draws the
    # noise of ``noise_total`` instances and keeps rows noise_offset ..
    # noise_offset + B; None draws for this batch alone.


def dynamic_steering_limit(cfg: SCPConfig, data: ScenarioData,
                           state: torch.Tensor) -> torch.Tensor:
    """min(mechanical, atan(a_lat_max * L / v^2)) per vehicle, (B, V)."""
    speed = state[..., 3]
    L = data.params.lf + data.params.lr
    dyn = torch.atan(cfg.lateral_accel_limit * L
                     / torch.clamp(speed ** 2, min=1e-9))
    return torch.clamp(dyn, max=cfg.mechanical_steering_limit)


def delay_compensate(cfg: SCPConfig, data: ScenarioData, state, u_last):
    """Integrate the nominal plant over the delay horizon.

    Returns (x0 (B, V, NX), trajectory (B, 10, NX, V)).
    """
    T = cfg.delay_comp_time
    n_steps = 9
    traj = bicycle.integrate(state, u_last, data.params.lf, data.params.lr,
                             h=T / n_steps, n_steps=n_steps, substeps=4)
    x0 = traj[:, :, -1, :]                       # traj: (B, V, 10, NX)
    return x0, traj.permute(0, 2, 3, 1)


def predict_obstacles(cfg: SCPConfig, data: ScenarioData,
                      step: int) -> torch.Tensor:
    """Constant-velocity obstacle forecast from the measured state at tick
    ``step*tps - ticks_delay_x``. Returns (B, O, HP, 2); with no obstacles a
    zero-size tensor."""
    b = data.x0.shape[0]
    dtype, device = data.x0.dtype, data.x0.device
    if cfg.n_obst == 0:
        return torch.zeros((b, 0, cfg.hp, 2), dtype=dtype, device=device)
    obst = data.obstacles
    t_meas = (step * cfg.ticks_per_sim - cfg.ticks_delay_x) * cfg.tick_length
    t_meas = max(t_meas, 0.0)
    speed = obst[..., OBST_SPEED]
    heading = obst[..., OBST_HEADING]
    vel = speed[..., None] * torch.stack(
        [torch.cos(heading), torch.sin(heading)], -1)
    base = obst[..., [OBST_X, OBST_Y]] + t_meas * vel
    horizon = (torch.arange(1, cfg.hp + 1, dtype=dtype, device=device)
               * cfg.dt + cfg.delay_comp_time)
    return base[:, :, None, :] + horizon[None, None, :, None] \
        * vel[:, :, None, :]


def clamp_controls(cfg: SCPConfig, U, u0, u_max):
    """Sequential magnitude/rate clamps.

    U: (B, HP, V) raw prediction; u0: (B, V) previous command; u_max:
    (B, V). The clamp order (min umax, max -umax, min prev+du, max prev-du)
    is preserved exactly — it matters when the rate window falls outside the
    magnitude box.
    """
    prev = u0
    rows = []
    for k in range(U.shape[1]):
        u = torch.minimum(U[:, k], u_max)
        u = torch.maximum(u, -u_max)
        u = torch.minimum(u, prev + cfg.du_lim)
        u = torch.maximum(u, prev - cfg.du_lim)
        rows.append(u)
        prev = u
    return torch.stack(rows, dim=1)


def rollout_plant(cfg: SCPConfig, data: ScenarioData, state, u_prev2,
                  u_prev1, generator: torch.Generator | None = None,
                  noise_rows: tuple[int, int] | None = None):
    """Integrate the true plant over one MPC step at tick resolution.

    The control entering tick m (1-based) is ``u_prev2`` for
    ``m <= ticks_delay_u`` and ``u_prev1`` after; under ``plant_compat_q10``
    the carried state only ever sees ``u_prev1``. ``noise_rows = (offset,
    total)``: the batch is rows ``offset .. offset + B`` of a batch of
    ``total``, whose noise each tick draws (None: this batch's alone; the
    two agree when offset = 0 and total = B). Returns
    (B, ticks_per_sim, V, NX).
    """
    tps = cfg.ticks_per_sim
    h = cfg.tick_length
    x = state
    states = []
    for m_idx in range(1, tps + 1):
        is_old = (not cfg.plant_compat_q10) and m_idx <= cfg.ticks_delay_u
        u = u_prev2 if is_old else u_prev1
        for _ in range(cfg.rk4_substeps):
            x = bicycle.rk4_step(x, u, data.params.lf, data.params.lr,
                                 h / cfg.rk4_substeps)
        if cfg.noise_std > 0:
            b = x.shape[0]
            lo, total = (0, b) if noise_rows is None else noise_rows
            noise = cfg.noise_std * h * torch.randn(
                (total,) + x.shape[1:-1] + (2,), generator=generator,
                dtype=x.dtype, device=x.device)[lo:lo + b]
            x = torch.cat([x[..., :2] + noise, x[..., 2:]], dim=-1)
        states.append(x)
    return torch.stack(states, dim=1)


def controller_pre(cfg: SCPConfig, data: ScenarioData, carry: SimCarry):
    """Controller preprocessing (delay compensation, reference sampling,
    obstacle forecast, discretize, condense).

    Returns (problem, aux) where ``aux = (sys_, u_max, ref_pts, x0, obst_pos,
    delay_traj)``.
    """
    # The steering limit uses the CURRENT state; delay compensation starts
    # from the MEASURED state, ticks_delay_x in the past.
    u_max = dynamic_steering_limit(cfg, data, carry.state)
    x_meas = carry.state if carry.state_meas is None else carry.state_meas

    x0, delay_traj = delay_compensate(cfg, data, x_meas, carry.u_prev1)
    step_sizes = x0[..., 3] * cfg.dt
    ref_pts = reference_path.sample_reference_batch(
        data.ref_points, data.ref_valid, x0[..., :2], step_sizes, cfg.hp,
        True)
    obst_pos = predict_obstacles(cfg, data, carry.step)

    A, B, E = discretize.linearize_and_discretize_batch(
        x0, carry.u_prev1, data.params.lf, data.params.lr, cfg.dt)
    b = x0.shape[0]
    ref_stack = ref_pts.reshape(b, cfg.n_veh, cfg.hp * NY)
    cm = condensed.build_condensed_batch(
        A, B, E, x0, ref_stack, data.params.q, data.params.r,
        data.params.q_final, cfg.hp, cfg.hu)

    sys_ = con.make_system(cm.math_b, cm.const_term, obst_pos,
                           data.dsafe_veh, data.dsafe_obst,
                           cfg.dsafe_extra, cfg.hp, cfg.hu)
    banded_pre = None
    if cfg.qp_kkt != "dense":
        # stage statement of the SAME problem for the banded (Riccati) KKT
        # path: dynamics + the cost's stage decomposition
        # (P == 2 blockdiag(B^T Q B + r I))
        qy = 2.0 * data.params.q[:, :, None].expand(b, cfg.n_veh, cfg.hp)
        qy = torch.cat([qy[:, :, :-1], 2.0 * data.params.q_final[:, :, None]],
                       dim=2)
        banded_pre = (A, B[..., 0], qy.to(data.x0.dtype), 2.0 * data.params.r)
    problem = scp.SCPProblem(sys=sys_, phi0=cm.phi0, psi0=cm.psi0,
                             gamma0=cm.gamma0, banded_pre=banded_pre)
    return problem, (sys_, u_max, ref_pts, x0, obst_pos, delay_traj)


def _scp_kwargs(cfg: SCPConfig) -> dict:
    return dict(
        u_lim=cfg.u_lim,
        delta_tol=cfg.delta_tol, delta_tol_rel=cfg.delta_tol_rel,
        u_step_tol=cfg.u_step_tol,
        merit_patience=cfg.merit_patience,
        keep_best=cfg.scp_keep_best,
        slack_weight=cfg.slack_weight,
        slack_ub=cfg.slack_ub,
        constraint_tolerance=cfg.constraint_tolerance,
        qp_max_iter=cfg.qp_max_iter, qp_tol=cfg.qp_tol,
        qp_fixed_iters=cfg.qp_fixed_iters or None,
        qp_correctors=cfg.qp_correctors,
        qp_warm_dual=cfg.qp_warm_dual,
        qp_cheap_k=cfg.qp_cheap_k,
        qp_kkt=cfg.qp_kkt,
        compat_q5=cfg.compat_q5)


def _side_selection_solve(cfg: SCPConfig, data: ScenarioData,
                          carry: SimCarry, aux):
    """The side-selection controller on the batch
    (:func:`miqp.solve_side_selection_stacked`), its result stated as an
    ``SCPResult`` (``iters`` = reselection rounds, ``max_violation`` = the
    slack, no QP failures counted) and its ``sides_stable`` flags."""
    sys_, u_max, ref_pts, x0, obst_pos, delay_traj = aux
    rect = {}
    if not (cfg.obst_as_qcqp or cfg.n_obst == 0):
        # obstAsQCQP=0: rotated-rectangle obstacle faces with chord-augmented
        # dimensions, built from the delay-compensated speeds
        normals, dists = miqp.rectangle_obstacle_geometry(
            data.obstacles, x0[..., 3], data.params.length,
            data.params.width, cfg.dt)
        rect = {"obst_normals": normals, "obst_dists": dists}
    iu, ju = sys_.pair_i[0], sys_.pair_j[0]
    ss = miqp.solve_side_selection_stacked(
        sys_, ref_pts, data.params.q, data.params.q_final, data.params.r,
        carry.u_prev1, u_max, carry.u_warm,
        du_lim=cfg.u_lim,
        slack_weight=cfg.slack_weight, slack_ub=cfg.slack_ub,
        constraint_tolerance=cfg.constraint_tolerance,
        n_rounds=cfg.side_selection_rounds,
        # the MIQP's rows use the RAW safety distances: dsafe_extra never
        # enters them
        dsafe_pair=data.dsafe_veh[:, iu, ju], dsafe_obst=data.dsafe_obst,
        qp_max_iter=cfg.qp_max_iter, qp_tol=cfg.qp_tol,
        qp_fixed_iters=cfg.qp_fixed_iters or None,
        qp_candidate_iters=cfg.side_selection_cand_iters or None,
        qp_correctors=cfg.qp_correctors, **rect)
    res = scp.SCPResult(
        u=ss.u, feasible=ss.feasible, converged=ss.converged, obj=ss.obj,
        max_violation=torch.clamp(ss.slack, min=0.0), iters=ss.rounds,
        qp_iters=ss.qp_iters,
        qp_fails=torch.zeros_like(ss.rounds))
    return res, ss.sides_stable
