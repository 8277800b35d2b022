"""Closed-loop MPC simulation engine on batched tensors (counterpart of
``scp_tpu/sim/engine.py``).

One MPC step — :func:`mpc_step` (per-instance SCP, ``vmap(mpc_step)`` of
``scp_tpu`` written out; one scenario is the B = 1 view) or
:func:`mpc_step_batch` (stacked SCP with straggler repacking) — reproduces,
for a batch of scenario instances:

1. dynamic steering limit from lateral acceleration;
2. delay compensation: forward-integrate the plant over
   ``delay_x + dt + delay_u`` holding the last commanded steering;
3. reference resampling + obstacle prediction;
4. linearize / discretize / condense;
5. SCP solve (straggler-repacked phases), or under
   ``controller="side_selection"`` the side-selection controller
   (``solvers/miqp.py``: its QPs batched over the instances in both step
   functions);
6. steering magnitude / rate clamps, applied sequentially along the horizon;
7. plant rollout at tick resolution with the actuator-delay control switch;
8. metrics.

Every tensor carries a leading batch axis B. Plant noise comes from the
carry's ``torch.Generator``; with ``noise_std = 0`` (the default) no number
is drawn. A rank of a distributed sweep holds a block of a larger batch:
its carry's ``noise_offset`` / ``noise_total`` make every tick draw the
noise of the whole batch and keep the block's rows, so an instance's noise
does not depend on how many ranks share the batch (``scp_tpu`` gets the
same by a PRNG key per instance). :func:`mpc_step_horizon` is the step
with its SCP solve horizon-sharded over a model process group. The closed
loops (:func:`simulate`, :func:`simulate_batch`, :func:`simulate_timed`)
are Python loops over steps whose outputs are stacked on a new leading
step axis.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

from scp_tpu_torch import assert_full_f32, require_device
from scp_tpu_torch.config import NY, SCPConfig, ScenarioData
from scp_tpu_torch.models import bicycle
from scp_tpu_torch.ops import (condensed, constraints as con, discretize,
                               reference_path)
from scp_tpu_torch.scenarios.builders import (OBST_HEADING, OBST_SPEED,
                                              OBST_X, OBST_Y)
from scp_tpu_torch.solvers import miqp, scp
from scp_tpu_torch.utils import timing


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


class StepOutput(NamedTuple):
    states: torch.Tensor         # (B, ticks_per_sim, V, NX) plant path
    u_applied: torch.Tensor      # (B, V) clamped first command
    u_pred: torch.Tensor         # (B, HP, V) clamped control prediction
    traj_pred: torch.Tensor      # (B, HP, NY, V) predicted trajectory
    ref_points: torch.Tensor     # (B, V, HP, 2) sampled reference
    x0_pred: torch.Tensor        # (B, V, NX) delay-compensated state
    feasible: torch.Tensor
    converged: torch.Tensor
    obj: torch.Tensor            # SCP tracking objective
    max_violation: torch.Tensor
    scp_iters: torch.Tensor
    qp_iters: torch.Tensor
    pred_obj: torch.Tensor       # objective re-evaluated on the prediction
    pred_feasible: torch.Tensor  # trajectory-distance feasibility
    delay_traj: torch.Tensor     # (B, 10, NX, V) delay-compensation rollout
    clamp_mag_events: torch.Tensor   # steering MAGNITUDE audit count
    clamp_rate_events: torch.Tensor  # steering RATE audit count
    # (|U| > uMax + 1e-3 / |dU| > duLim + 1e-3 on the RAW prediction)
    feas_disagree: torch.Tensor      # 1 when the QCQP-based and the
    # trajectory-distance feasibility criteria DISAGREE on this step
    sides_stable: torch.Tensor       # True for the SCP controller


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


@timing.spanned("pre")
def controller_pre(cfg: SCPConfig, data: ScenarioData, carry: SimCarry):
    """Controller preprocessing (delay compensation, reference sampling,
    obstacle forecast, discretize, condense).

    Returns (problem, aux) where ``aux = (sys_, u_max, ref_pts, x0, obst_pos,
    delay_traj)``. Spans: ``pre`` and its five parts.
    """
    with timing.span("pre.delay"):
        # The steering limit uses the CURRENT state; delay compensation
        # starts from the MEASURED state, ticks_delay_x in the past.
        u_max = dynamic_steering_limit(cfg, data, carry.state)
        x_meas = carry.state if carry.state_meas is None else carry.state_meas
        x0, delay_traj = delay_compensate(cfg, data, x_meas, carry.u_prev1)

    with timing.span("pre.reference"):
        step_sizes = x0[..., 3] * cfg.dt
        ref_pts = reference_path.sample_reference_batch(
            data.ref_points, data.ref_valid, x0[..., :2], step_sizes, cfg.hp,
            True)
        obst_pos = predict_obstacles(cfg, data, carry.step)

    with timing.span("pre.discretize"):
        A, B, E = discretize.linearize_and_discretize_batch(
            x0, carry.u_prev1, data.params.lf, data.params.lr, cfg.dt)
    b = x0.shape[0]
    with timing.span("pre.condense"):
        ref_stack = ref_pts.reshape(b, cfg.n_veh, cfg.hp * NY)
        cm = condensed.build_condensed_batch(
            A, B, E, x0, ref_stack, data.params.q, data.params.r,
            data.params.q_final, cfg.hp, cfg.hu)

    with timing.span("pre.system"):
        sys_ = con.make_system(cm.math_b, cm.const_term, obst_pos,
                               data.dsafe_veh, data.dsafe_obst,
                               cfg.dsafe_extra, cfg.hp, cfg.hu)
        banded_pre = None
        if cfg.qp_kkt != "dense":
            # stage statement of the SAME problem for the banded (Riccati)
            # KKT path: dynamics + the cost's stage decomposition
            # (P == 2 blockdiag(B^T Q B + r I))
            qy = 2.0 * data.params.q[:, :, None].expand(b, cfg.n_veh, cfg.hp)
            qy = torch.cat([qy[:, :, :-1],
                            2.0 * data.params.q_final[:, :, None]], dim=2)
            banded_pre = (A, B[..., 0], qy.to(data.x0.dtype),
                          2.0 * data.params.r)
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


@timing.spanned("post")
def step_post(cfg: SCPConfig, data: ScenarioData, carry: SimCarry,
              res, aux, sides_stable=None) -> tuple[SimCarry, StepOutput]:
    """Post-solve half of the MPC step: clamps, plant rollout, metrics.
    Spans: ``post`` and its three parts."""
    sys_, u_max, ref_pts, x0, obst_pos, delay_traj = aux
    with timing.span("post.forward"):
        # (B, HP, NY, V), (B, HP, V)
        traj_pred, U_raw = scp.forward_u(sys_, res.u)
        U = clamp_controls(cfg, U_raw, carry.u_prev1, u_max)
        u_cmd = U[:, 0]

        # Steering-limit audit on the RAW prediction: counts of
        # magnitude/rate excursions the clamps will remove.
        audit_eps = 1e-3
        mag_events = (U_raw.abs() > u_max[:, None, :] + audit_eps).sum(
            dim=(1, 2))
        dU_raw = torch.diff(U_raw, dim=1, prepend=carry.u_prev1[:, None, :])
        rate_events = (dU_raw.abs() > cfg.du_lim + audit_eps).sum(dim=(1, 2))

    with timing.span("post.plant"):
        states = rollout_plant(
            cfg, data, carry.state, carry.u_prev2, carry.u_prev1,
            carry.generator, None if carry.noise_total is None
            else (carry.noise_offset, carry.noise_total))

    with timing.span("post.metrics"):
        # objective / feasibility re-evaluated on the predicted trajectory
        # (B, HP, NY, V)
        sq_err = (ref_pts.permute(0, 2, 3, 1) - traj_pred) ** 2
        obj_x = torch.sum(data.params.q * sq_err[:, :-1].sum(dim=(1, 2)), 1) \
            + torch.sum(data.params.q_final * sq_err[:, -1].sum(dim=1), 1)
        obj_u = torch.sum(data.params.r * (U ** 2).sum(dim=1), 1)
        pred_obj = obj_x + obj_u
        pos_t = traj_pred.permute(0, 3, 1, 2)            # (B, V, HP, NY)
        iu, ju = sys_.pair_i[0], sys_.pair_j[0]
        d2 = torch.sum((pos_t[:, iu] - pos_t[:, ju]) ** 2, -1)  # (B, P, HP)
        ci_v = data.dsafe_veh[:, iu, ju][:, :, None] ** 2 - d2
        d2o = torch.sum((pos_t[:, :, None] - obst_pos[:, None]) ** 2, -1)
        ci_o = data.dsafe_obst[:, :, :, None] ** 2 - d2o
        pred_feasible = \
            (con._max_or_neg_inf(ci_v) <= cfg.constraint_tolerance) \
            & (con._max_or_neg_inf(ci_o) <= cfg.constraint_tolerance)

        d_ticks = cfg.ticks_delay_x
        if carry.state_meas is None:
            state_meas = state_hist = None
        elif d_ticks == 0:
            state_meas, state_hist = states[:, -1], None
        else:
            # Tick-resolution measurement history: ``full`` covers ticks
            # T-D .. T+tps of the global tick grid (T = this step's start,
            # D = ticks_delay_x); the measured state at the NEXT boundary
            # is tick T+tps-D and the carried history the D ticks before it.
            full = torch.cat(
                [carry.state_hist, carry.state[:, None], states], dim=1)
            state_meas = full[:, cfg.ticks_per_sim]
            state_hist = full[:, cfg.ticks_per_sim:
                              cfg.ticks_per_sim + d_ticks]
        new_carry = SimCarry(
            state=states[:, -1],
            u_prev2=carry.u_prev1,
            u_prev1=u_cmd,
            u_warm=res.u,
            step=carry.step + 1,
            generator=carry.generator,
            state_meas=state_meas,
            state_hist=state_hist,
            noise_offset=carry.noise_offset,
            noise_total=carry.noise_total,
        )
        b = res.u.shape[0]
        out = StepOutput(
            states=states, u_applied=u_cmd, u_pred=U,
            traj_pred=traj_pred,
            ref_points=ref_pts, x0_pred=x0,
            feasible=res.feasible, converged=res.converged, obj=res.obj,
            max_violation=res.max_violation, scp_iters=res.iters,
            qp_iters=res.qp_iters, pred_obj=pred_obj,
            pred_feasible=pred_feasible, delay_traj=delay_traj,
            clamp_mag_events=mag_events, clamp_rate_events=rate_events,
            feas_disagree=(res.feasible != pred_feasible).to(
                torch.int32),
            sides_stable=(torch.ones((b,), dtype=torch.bool,
                                     device=res.u.device)
                          if sides_stable is None else sides_stable))
    return new_carry, out


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


def mpc_controller(cfg: SCPConfig, data: ScenarioData, carry: SimCarry):
    """Controller half of one MPC step: preprocessing + the per-instance SCP
    solve (:func:`scp.solve_scp` on the batch axis) or the side-selection
    controller. Returns ``(res, aux, sides_stable)`` (``sides_stable`` None
    for the SCP controller); :func:`step_post` completes the step. Split
    out so the caller can time the controller separately
    (:func:`simulate_timed`)."""
    if cfg.controller not in ("scp", "side_selection"):
        raise ValueError(f"unknown controller {cfg.controller!r}")
    assert_full_f32()
    problem, aux = controller_pre(cfg, data, carry)
    if cfg.controller == "side_selection":
        res, sides_stable = _side_selection_solve(cfg, data, carry, aux)
        return res, aux, sides_stable
    res = scp.solve_scp(problem, carry.u_warm, max_scp_iter=cfg.max_scp_iter,
                        **_scp_kwargs(cfg))
    return res, aux, None


def _step_attrs(cfg: SCPConfig, data: ScenarioData, *args, **kw) -> dict:
    """The ``step`` span's attrs."""
    return {"B": data.x0.shape[0], "controller": cfg.controller}


@timing.spanned("step", _step_attrs)
def mpc_step(cfg: SCPConfig, data: ScenarioData,
             carry: SimCarry) -> tuple[SimCarry, StepOutput]:
    """One complete MPC step (controller + plant) through the per-instance
    path; ``data`` / ``carry`` carry a leading batch axis (size 1 for one
    scenario). Span: ``step``."""
    res, aux, sides_stable = mpc_controller(cfg, data, carry)
    return step_post(cfg, data, carry, res, aux, sides_stable=sides_stable)


@timing.spanned("step", _step_attrs)
def mpc_step_horizon(cfg: SCPConfig, data: ScenarioData, carry: SimCarry,
                     *, axis_name, n_shards: int
                     ) -> tuple[SimCarry, StepOutput]:
    """One MPC step with the SCP solve horizon-sharded over the ranks of
    ``axis_name``, the model ProcessGroup (``parallel.mesh.Mesh.groups
    ["model"]``, ``n_shards`` ranks; the name is ``scp_tpu``'s).

    Pre- and post-processing run whole on every rank (per-vehicle work);
    the SCP solve sees this rank's horizon block of the constraint system
    (``parallel.horizon.shard_system``), its QP rows row-sharded, so every
    rank comes out with the same result. Span: ``step``."""
    from scp_tpu_torch.parallel import horizon, mesh as mesh_lib

    if cfg.controller != "scp":
        raise ValueError("horizon sharding runs the SCP controller; got "
                         f"controller={cfg.controller!r}")
    assert_full_f32()
    problem, aux = controller_pre(cfg, data, carry)
    local_sys = horizon.shard_system(
        problem.sys, mesh_lib.axis_index(axis_name), n_shards)
    res = scp.solve_scp(problem._replace(sys=local_sys), carry.u_warm,
                        max_scp_iter=cfg.max_scp_iter, axis_name=axis_name,
                        n_con_total=horizon.padded_n_con(cfg, n_shards),
                        **_scp_kwargs(cfg))
    return step_post(cfg, data, carry, res, aux)


def mpc_step_batch(cfg: SCPConfig, data: ScenarioData, carry: SimCarry,
                   phase1_iters: int = 8, straggler_frac: int = 4,
                   phases: tuple[tuple[int, int], ...] | None = None):
    """Batched MPC step with straggler repacking (see
    ``scp.solve_scp_batch``), or the side-selection step
    (:func:`_side_selection_step_batch`). ``data``/``carry`` carry a
    leading batch axis. Runs on the device the tensors live on. Span:
    ``step`` (under side selection :func:`mpc_step`'s)."""
    if cfg.controller == "side_selection":
        if phases is not None:
            # the side-selection controller runs a FIXED round count: a
            # straggler phase schedule has no meaning for it and must not
            # be dropped silently
            raise ValueError(
                "phases (SCP straggler schedule) is not applicable to the "
                "side_selection controller; pass phases=None")
        return _side_selection_step_batch(cfg, data, carry)
    if cfg.controller != "scp":
        raise ValueError(f"unknown controller {cfg.controller!r}")
    assert_full_f32()
    with timing.span("step", **_step_attrs(cfg, data)):
        problem, aux = controller_pre(cfg, data, carry)
        res = scp.solve_scp_batch(
            problem, carry.u_warm,
            max_scp_iter=cfg.max_scp_iter,
            phase1_iters=phase1_iters, straggler_frac=straggler_frac,
            phases=phases,
            **_scp_kwargs(cfg))
        return step_post(cfg, data, carry, res, aux)


def _side_selection_step_batch(cfg: SCPConfig, data: ScenarioData,
                               carry: SimCarry):
    """Batched side-selection MPC step: every QP of the controller (all
    first-round candidates, then each reselection round) is one
    ``solve_qp_batched`` call over the batch. That is already what
    :func:`mpc_step` does on a batch, so the two steps are one."""
    return mpc_step(cfg, data, carry)


def init_carry(cfg: SCPConfig, data: ScenarioData,
               generator: torch.Generator | None = None) -> SimCarry:
    """Initial carry for a batch on the data's device. ``generator`` feeds
    the plant noise (None seeds a fresh one with 0 on that device)."""
    device = require_device(data.x0.device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    b = data.x0.shape[0]
    return SimCarry(
        state=data.x0,
        u_prev2=data.u0,
        u_prev1=data.u0,
        u_warm=torch.zeros((b, cfg.n_veh * cfg.hp), dtype=data.x0.dtype,
                           device=device),
        step=0,
        generator=generator,
        # tick_of_measurement = max(0, 0 - ticks_delay_x) -> initial state
        state_meas=data.x0,
        # ticks before t=0 measure the initial state
        state_hist=(data.x0[:, None].expand(
            (b, cfg.ticks_delay_x) + tuple(data.x0.shape[1:])).clone()
            if cfg.ticks_delay_x > 0 else None),
    )


def _stack_outputs(outs: list[StepOutput]) -> StepOutput:
    return StepOutput(*[torch.stack(field) for field in zip(*outs)])


def simulate(cfg: SCPConfig, data: ScenarioData,
             generator: torch.Generator | None = None,
             n_steps: int | None = None):
    """Run the closed loop through :func:`mpc_step` for ``n_steps``
    (default ``cfg.n_sim``). Returns ``(final_carry, StepOutput)`` with the
    outputs stacked ``(n_steps, B, ...)``."""
    carry = init_carry(cfg, data, generator)
    outs = []
    for _ in range(cfg.n_sim if n_steps is None else n_steps):
        carry, out = mpc_step(cfg, data, carry)
        outs.append(out)
    return carry, _stack_outputs(outs)


def simulate_batch(cfg: SCPConfig, data: ScenarioData,
                   generator: torch.Generator | None = None,
                   n_steps: int | None = None,
                   phases: tuple | None = None):
    """Batched closed loop through :func:`mpc_step_batch` (broadcast a
    single scenario with ``scenarios.batch.tile_scenario`` for Monte-Carlo
    over the generator's noise). With ``phases`` (e.g.
    ``config.TUNED_F32_PHASES``) each step runs the straggler-repacked
    batched SCP. Returns ``(final_carry, StepOutput)`` with the outputs
    stacked ``(n_steps, B, ...)``."""
    carry = init_carry(cfg, data, generator)
    kw = {"phases": phases} if phases is not None else {}
    outs = []
    for _ in range(cfg.n_sim if n_steps is None else n_steps):
        carry, out = mpc_step_batch(cfg, data, carry, **kw)
        outs.append(out)
    return carry, _stack_outputs(outs)


def simulate_timed(cfg: SCPConfig, data: ScenarioData,
                   generator: torch.Generator | None = None,
                   n_steps: int | None = None, warmup: bool = True):
    """Closed loop of :func:`simulate` with per-step wall-clock measurement:
    the controller's run time (preprocessing + SCP solve) and the whole
    step's. On a CUDA device each window is closed by
    ``torch.cuda.synchronize()``, so the times are the device's, not the
    enqueue's.

    ``warmup``: run one throwaway step first so first-call costs (kernel
    build and load, allocator growth) are not billed to step 0; the noise
    generator's state is restored afterwards, so the run is the same with
    and without it.

    Returns ``(final_carry, StepOutput stacked (n_steps, B, ...),
    step_times, controller_runtimes)`` — the time lists in seconds.
    """
    carry = init_carry(cfg, data, generator)
    on_cuda = data.x0.device.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(data.x0.device)

    if warmup:
        gen_state = carry.generator.get_state()
        mpc_step(cfg, data, carry)
        carry.generator.set_state(gen_state)
    outs, step_times, ctrl_times = [], [], []
    for _ in range(cfg.n_sim if n_steps is None else n_steps):
        sync()
        t0 = time.perf_counter()
        res, aux, sides_stable = mpc_controller(cfg, data, carry)
        sync()
        t1 = time.perf_counter()
        carry, out = step_post(cfg, data, carry, res, aux,
                               sides_stable=sides_stable)
        sync()
        t2 = time.perf_counter()
        outs.append(out)
        ctrl_times.append(t1 - t0)
        step_times.append(t2 - t0)
    return carry, _stack_outputs(outs), step_times, ctrl_times
