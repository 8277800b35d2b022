"""Visualization from logged simulation arrays, on the host (counterpart
of ``scp_tpu/viz/plot.py``).

The original controller's ``plotOnline.py`` (live per-step view: steering
staircases, the scenario view with references, predictions, vehicle and
obstacle rectangles) and ``draw_video.py`` (offline JSON -> per-step PNG
frames). Rendering reads one run's numpy arrays
(``utils.results.sim_outputs_to_arrays(cfg, out, instance=0)``) and the
scenario ``data`` as the builders return it (a batch of one; its instance
0 is drawn). ``matplotlib`` is imported inside the functions that draw.
"""
from __future__ import annotations

import math
import os

import numpy as np

from scp_tpu_torch.scenarios.builders import (OBST_HEADING, OBST_LENGTH,
                                              OBST_SPEED, OBST_WIDTH, OBST_X,
                                              OBST_Y)
from scp_tpu_torch.utils.results import to_numpy


def _first(t) -> np.ndarray:
    """numpy copy of instance 0 of a scenario tensor's batch axis."""
    return to_numpy(t[0])


def transformed_rectangle(x: float, y: float, angle: float, length: float,
                          width: float) -> np.ndarray:
    """Corner coordinates (5, 2) of a centered, rotated rectangle — the
    homogeneous-transform unit square of ``plotOnline.transformedRectangle``
    (plotOnline.py:120-132)."""
    c, s = math.cos(angle), math.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    half = np.array([
        [-length / 2, -width / 2], [length / 2, -width / 2],
        [length / 2, width / 2], [-length / 2, width / 2],
        [-length / 2, -width / 2]])
    return half @ rot.T + np.array([x, y])


def obstacle_position(obstacles: np.ndarray, t: float) -> np.ndarray:
    """Constant-velocity obstacle centers at time t. obstacles: (O, 6)."""
    heading = obstacles[:, OBST_HEADING]
    vel = obstacles[:, OBST_SPEED, None] * np.stack(
        [np.cos(heading), np.sin(heading)], axis=-1)
    return obstacles[:, [OBST_X, OBST_Y]] + t * vel


def predicted_obstacle_centers(cfg, obstacles: np.ndarray,
                               step: int) -> np.ndarray:
    """Obstacle centers over the prediction horizon of ``step``, the host's
    copy of ``engine.predict_obstacles``. Returns (O, HP, 2)."""
    heading = obstacles[:, OBST_HEADING]
    vel = obstacles[:, OBST_SPEED, None] * np.stack(
        [np.cos(heading), np.sin(heading)], axis=-1)
    t_meas = max((step * cfg.ticks_per_sim - cfg.ticks_delay_x)
                 * cfg.tick_length, 0.0)
    base = obstacles[:, [OBST_X, OBST_Y]] + t_meas * vel
    horizon = np.arange(1, cfg.hp + 1) * cfg.dt + cfg.delay_comp_time
    return base[:, None, :] + horizon[None, :, None] * vel[:, None, :]


def violation_flags(cfg, data, arrays: dict, step: int) -> np.ndarray:
    """(V, HP) bools: vehicle v's predicted step k violates some avoidance
    constraint (the original live plot's red-star condition, from the
    largest constraint value per vehicle and step).

    The distances are the controller's own: the SCP rows carry the
    ``dsafe_extra`` margin while the side-selection rows use the raw safety
    distances; padding those with the margin would star steps the
    controller rightly reports feasible."""
    pos = arrays["traj_pred"][step].transpose(2, 0, 1)   # (V, HP, 2)
    n_veh = pos.shape[0]
    tol = cfg.constraint_tolerance
    extra = 0.0 if cfg.controller == "side_selection" else cfg.dsafe_extra
    viol = np.zeros((n_veh, cfg.hp), bool)
    dv = _first(data.dsafe_veh)
    for v in range(n_veh):
        for j in range(n_veh):
            if j == v:
                continue
            d2 = ((pos[v] - pos[j]) ** 2).sum(-1)
            viol[v] |= (dv[v, j] + extra) ** 2 - d2 > tol
    obstacles = _first(data.obstacles)
    if len(obstacles):
        obst_k = predicted_obstacle_centers(cfg, obstacles, step)
        do = _first(data.dsafe_obst)
        for v in range(n_veh):
            d2 = ((pos[v][None] - obst_k) ** 2).sum(-1)  # (O, HP)
            viol[v] |= ((do[v][:, None] + extra) ** 2 - d2 > tol).any(0)
    return viol


def plot_step(ax, cfg, data, arrays: dict, step: int,
              scenario: str | None = None):
    """Draw one simulation step into a matplotlib axes.

    arrays: one run's ``utils.results.sim_outputs_to_arrays``. The original
    live view: references, predictions, the delay-compensation spur,
    vehicle / obstacle rectangles, and red stars on predicted steps that
    violate an avoidance constraint.

    ``scenario``: when given, the original fixed axis limits
    (:func:`builders.plot_limits`) and vehicle-number labels
    (:func:`builders.label_offsets`) instead of matplotlib's auto-scaling.
    """
    from scp_tpu_torch.scenarios import builders as _builders

    states = arrays["states"]          # (Nsim, tps, V, NX)
    traj_pred = arrays["traj_pred"]    # (Nsim, HP, NY, V)
    refs = arrays["ref_points"]        # (Nsim, V, HP, 2)
    n_veh = states.shape[2]
    obstacles = _first(data.obstacles)
    length, width = _first(data.params.length), _first(data.params.width)
    offsets = (_builders.label_offsets(scenario, n_veh)
               if scenario is not None else None)

    ax.clear()
    # driven path up to now
    past = states[: step + 1, :, :, :2].reshape(-1, n_veh, 2)
    for v in range(n_veh):
        ax.plot(past[:, v, 0], past[:, v, 1], "-", lw=1, alpha=0.6)
        ax.plot(refs[step, v, :, 0], refs[step, v, :, 1], ".", ms=3)
        ax.plot(traj_pred[step, :, 0, v], traj_pred[step, :, 1, v], "--", lw=1)
        if "delay_traj" in arrays:
            # delay-compensation spur (plotOnline.py:88-89)
            dtr = arrays["delay_traj"][step]             # (10, NX, V)
            ax.plot(dtr[:, 0, v], dtr[:, 1, v], "-", lw=2)
        x, y, ang = (states[step, -1, v, 0], states[step, -1, v, 1],
                     states[step, -1, v, 2])
        rect = transformed_rectangle(
            x, y, ang, float(length[v]), float(width[v]))
        # filled vehicle polygon with black edge (plotOnline.py:94 ax2.fill)
        ax.fill(rect[:, 0], rect[:, 1], fc=f"C{v % 10}", ec="k", lw=1)
        if offsets is not None:
            ax.annotate(str(v + 1), (x + offsets[v, 0], y + offsets[v, 1]),
                        fontsize=8, ha="center", va="center")
    if len(obstacles):
        t = (step + 1) * cfg.dt
        centers = obstacle_position(obstacles, t)
        for o in range(len(obstacles)):
            rect = transformed_rectangle(
                centers[o, 0], centers[o, 1], obstacles[o, OBST_HEADING],
                obstacles[o, OBST_LENGTH], obstacles[o, OBST_WIDTH])
            # obstacles filled black (plotOnline.py:100-101)
            ax.fill(rect[:, 0], rect[:, 1], color="k")
    # red stars on violated predicted steps (plotOnline.py:105-117)
    viol = violation_flags(cfg, data, arrays, step)
    for v in range(n_veh):
        for k in np.nonzero(viol[v])[0]:
            ax.plot(traj_pred[step, k, 0, v], traj_pred[step, k, 1, v], "r*")
    ax.set_aspect("equal")
    ax.set_xlabel(r"$x$ [m]")
    ax.set_ylabel(r"$y$ [m]")
    if scenario is not None:
        lim = _builders.plot_limits(scenario, n_veh)
        ax.set_xlim(lim[0])
        ax.set_ylim(lim[1])
    ax.set_title(f"step {step}")


def plot_steering(ax_list, cfg, arrays: dict, step: int):
    """Per-vehicle predicted steering staircases."""
    u_pred = arrays["u_pred"]          # (Nsim, HP, V)
    n_veh = u_pred.shape[2]
    for v in range(min(n_veh, len(ax_list))):
        ax = ax_list[v]
        ax.clear()
        ax.step(range(cfg.hp), np.degrees(u_pred[step, :, v]), where="post")
        ax.set_ylabel(f"u_{v + 1} [deg]")


def run_live(cfg, data, n_steps=None, generator=None, pause: float = 0.02,
             save_dir: str | None = None, show: bool = True,
             on_step=None, scenario: str | None = None,
             step_times: list | None = None):
    """Closed-loop simulation with LIVE per-step rendering.

    The original online-plotting mode: each MPC step is computed (one
    ``engine.mpc_step`` of the batch-of-one scenario, a host-driven loop)
    and drawn at once: past path, references, predictions, delay spur,
    rectangles, violation stars. ``show`` uses matplotlib's interactive
    mode (``plt.pause``); ``save_dir`` also writes a PNG per step;
    ``on_step(i, arrays)`` is an optional callback receiving the arrays of
    the steps so far. ``generator`` feeds the plant noise (as in
    ``engine.simulate``).

    The host's cost is flat per step: the outputs are written into
    preallocated (n_steps, ...) arrays and the plot and the callback see
    O(1) slices of them.

    ``step_times``: optional list the per-step wall-clock times [s] are
    appended to (the step and the read-back of its outputs, which waits
    for the device); give them to ``results.export_reference_json`` for
    the original ``stepTime`` key.

    Returns ``(final_carry, StepOutput stacked (n_steps, 1, ...))``, what
    :func:`scp_tpu_torch.sim.engine.simulate` returns.
    """
    import time

    import matplotlib.pyplot as plt

    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.utils import results as results_lib

    carry = engine.init_carry(cfg, data, generator)
    n = n_steps if n_steps is not None else cfg.n_sim
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    if show:
        plt.ion()
    # the original two-pane layout: per-vehicle steering staircases on the
    # left, the scenario view on the right
    n_stair = min(cfg.n_veh, 4)
    fig = plt.figure(figsize=(11, 7))
    gs = fig.add_gridspec(max(n_stair, 1), 3)
    stair_axes = [fig.add_subplot(gs[v, 0]) for v in range(n_stair)]
    ax = fig.add_subplot(gs[:, 1:])
    full: dict | None = None     # preallocated (n, ...) accumulation arrays
    outs = []
    try:
        for i in range(n):
            t0 = time.perf_counter()
            carry, out = engine.mpc_step(cfg, data, carry)
            step_arrays = results_lib.sim_outputs_to_arrays(
                cfg, type(out)(*[t[None] for t in out]), instance=0)
            if step_times is not None:
                # the read-back above waited for the device
                step_times.append(time.perf_counter() - t0)
            outs.append(out)
            if full is None:
                full = {k: np.empty((n,) + v.shape[1:], v.dtype)
                        for k, v in step_arrays.items()}
            for k, v in step_arrays.items():
                full[k][i] = v[0]
            arrays = {k: v[: i + 1] for k, v in full.items()}  # O(1) views
            plot_step(ax, cfg, data, arrays, i, scenario=scenario)
            plot_steering(stair_axes, cfg, arrays, i)
            if save_dir:
                fig.savefig(os.path.join(save_dir, f"{i:04d}.png"), dpi=90)
            if show:
                fig.canvas.draw_idle()
                plt.pause(pause)
            if on_step is not None:
                on_step(i, arrays)
    finally:
        if show:
            plt.ioff()
        plt.close(fig)
    return carry, engine._stack_outputs(outs)


def render_video_frames(cfg, data, arrays: dict, out_dir: str,
                        steps=None, scenario: str | None = None) -> list:
    """Offline per-step PNG frames (the original ``draw_video.py``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    n_sim = arrays["states"].shape[0]
    steps = range(n_sim) if steps is None else steps
    paths = []
    fig, ax = plt.subplots(figsize=(7, 7))
    for i in steps:
        plot_step(ax, cfg, data, arrays, i, scenario=scenario)
        p = os.path.join(out_dir, f"{i:04d}.png")
        fig.savefig(p, dpi=90)
        paths.append(p)
    plt.close(fig)
    return paths
