"""Scenario builders: Circle, Frog, Parallel (counterpart of
``scp_tpu/scenarios/builders.py``).

Each builder returns a ``(SCPConfig, ScenarioData)`` pair; the data carries
a leading batch axis of size 1 (every function of the port is written for
batched tensors). Randomized batches live in
``scp_tpu_torch.scenarios.batch``. The host-side plot geometry
(:func:`plot_limits`, :func:`label_offsets`) is numpy only.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from scp_tpu_torch import require_device
from scp_tpu_torch.config import (NX, SCPConfig, ScenarioData,
                                  default_vehicle_params)

# Obstacle table column indices
OBST_X, OBST_Y, OBST_HEADING, OBST_SPEED, OBST_LENGTH, OBST_WIDTH = range(6)


def safety_distances(speeds, lengths, widths, obstacles, dt, dtype,
                     device="cuda"):
    """Pairwise vehicle and vehicle-obstacle safety distances:
    ``dsafe = sqrt((max_chord/2)^2 + R^2)`` with ``max_chord`` the combined
    per-step travel and ``R`` the sum of half-diagonals. Computed on the
    host in float64; returns ``(dsafe_veh (V, V), dsafe_obst (V, O))``."""
    speeds = np.asarray(speeds, float)
    half_diag = 0.5 * np.hypot(np.asarray(lengths, float),
                               np.asarray(widths, float))
    chord = (speeds[:, None] + speeds[None, :]) * dt
    rr = half_diag[:, None] + half_diag[None, :]
    dsafe_veh = np.sqrt((chord / 2) ** 2 + rr ** 2)

    obstacles = np.asarray(obstacles, float).reshape(-1, 6)
    o_half_diag = 0.5 * np.hypot(obstacles[:, OBST_LENGTH],
                                 obstacles[:, OBST_WIDTH])
    o_chord = (speeds[:, None] + obstacles[None, :, OBST_SPEED]) * dt
    o_rr = half_diag[:, None] + o_half_diag[None, :]
    dsafe_obst = np.sqrt((o_chord / 2) ** 2 + o_rr ** 2)
    return (torch.as_tensor(dsafe_veh, dtype=dtype, device=device),
            torch.as_tensor(dsafe_obst, dtype=dtype, device=device))


def _make_scenario_data(starts, headings, speeds, ref_lines, obstacles,
                        n_ref_points, dt, dtype, device="cuda"):
    """Assemble ScenarioData (batch axis 1) from per-vehicle python lists."""
    n_veh = len(starts)
    params = default_vehicle_params(n_veh, dtype, device)
    x0 = np.zeros((n_veh, NX))
    for v, ((sx, sy), hd, sp) in enumerate(zip(starts, headings, speeds)):
        x0[v] = [sx, sy, hd, sp, 0.0, 0.0]

    ref_pts = np.zeros((n_veh, n_ref_points, 2))
    ref_valid = np.zeros((n_veh, n_ref_points), bool)
    for v, line in enumerate(ref_lines):
        line = np.asarray(line, float)
        k = len(line)
        ref_pts[v, :k] = line
        ref_pts[v, k:] = line[-1]
        ref_valid[v, :k] = True

    obstacles = np.asarray(obstacles, float).reshape(-1, 6)
    dsafe_veh, dsafe_obst = safety_distances(
        list(speeds), params.length[0].cpu().numpy(),
        params.width[0].cpu().numpy(), obstacles, dt, dtype, device)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)[None]

    return ScenarioData(
        x0=dev(x0),
        u0=torch.zeros((1, n_veh), dtype=dtype, device=device),
        params=params,
        ref_points=dev(ref_pts),
        ref_valid=torch.as_tensor(ref_valid, device=device)[None],
        obstacles=dev(obstacles),
        dsafe_veh=dsafe_veh[None],
        dsafe_obst=dsafe_obst[None],
    )


def circle(n_veh: int = 8, radius: float = 30.0, dtype=torch.float64,
           device="cuda", **cfg_overrides):
    """N vehicles on a circle driving to antipodal points."""
    device = require_device(device)
    angles = [2 * math.pi / n_veh * (i + 1) for i in range(n_veh)]
    starts, headings, speeds, lines = [], [], [], []
    for a in angles:
        c, s = math.cos(a), math.sin(a)
        starts.append((-c * radius, -s * radius))
        headings.append(a)
        speeds.append(4.0)
        lines.append([[-c * radius, -s * radius], [c * radius, s * radius]])
    cfg = SCPConfig(n_veh=n_veh, n_obst=0, n_ref_points=2, **cfg_overrides)
    data = _make_scenario_data(starts, headings, speeds, lines,
                               np.zeros((0, 6)), 2, cfg.dt, dtype, device)
    return cfg, data


def frog(dtype=torch.float64, device="cuda", **cfg_overrides):
    """One vehicle crossing two moving obstacle lanes."""
    device = require_device(device)
    starts = [(-18.0, 0.0)]
    headings = [0.0]
    speeds = [4.0]
    lines = [[[-100.0, 0.0], [100.0, 0.0]]]
    obstacles = []
    for o in range(-2, 9):
        for x in (7.0, 14.0):
            obstacles.append([x, 9.0 * o - 15.0, math.pi / 2, 2.0, 4.0, 2.0])
    obstacles = np.array(obstacles)
    cfg = SCPConfig(n_veh=1, n_obst=len(obstacles), n_ref_points=2,
                    **cfg_overrides)
    data = _make_scenario_data(starts, headings, speeds, lines, obstacles,
                               2, cfg.dt, dtype, device)
    return cfg, data


def parallel(n_veh: int = 11, dtype=torch.float64, device="cuda",
             **cfg_overrides):
    """Parallel lanes with 4 static obstacles."""
    device = require_device(device)
    _positions = np.arange(n_veh) - math.floor(n_veh / 2)
    order = list(range(n_veh))
    evens = order[0:n_veh:2]
    evens.reverse()
    order = evens + order[1:n_veh:2]
    positions = np.zeros(n_veh)
    positions[order] = _positions

    starts, headings, speeds, lines = [], [], [], []
    for i in range(n_veh):
        y = 3.0 * positions[i]
        starts.append((-37.0, y))
        headings.append(0.0)
        speeds.append(4.0)
        lines.append([[-30.0, y], [30.0, y]])

    obstacles = np.array([
        [-15.0, 5.0, 0.0, 0.0, 2.0, 4.0],
        [-2.0, -7.0, 0.0, 0.0, 4.0, 2.0],
        [10.0, 5.0, 0.0, 0.0, 4.0, 2.0],
        [20.0, -7.0, 0.0, 0.0, 2.0, 2.0],
    ])
    overrides = {"dsafe_extra": 0.9, **cfg_overrides}
    cfg = SCPConfig(n_veh=n_veh, n_obst=4, n_ref_points=2, **overrides)
    data = _make_scenario_data(starts, headings, speeds, lines, obstacles,
                               2, cfg.dt, dtype, device)
    return cfg, data


BUILDERS = {"circle": circle, "frog": frog, "parallel": parallel}


# ---- host-side plot geometry (numpy; not part of the tensor containers) ----

def plot_limits(scenario: str, n_veh: int = 0,
                radius: float = 30.0) -> np.ndarray:
    """The original controller's ``scenario.plotLimits`` (the axis limits of
    its live plot): ((xmin, xmax), (ymin, ymax)). The circle of two
    near-horizontal vehicles gets a narrow y range."""
    if scenario == "circle":
        lim = 1.1 * radius * np.array([[-1.0, 1.0], [-1.0, 1.0]])
        angles = [2 * math.pi / n_veh * (i + 1) for i in range(n_veh)]
        if n_veh == 2 and max(abs(math.sin(a)) for a in angles) < 0.1:
            lim[1] = [-6.0, 6.0]
        return lim
    if scenario == "frog":
        return 35.0 * np.array([[-1.0, 1.0], [-1.0, 1.0]])
    if scenario == "parallel":
        return np.array([[-50.0, 50.0], [-20.0, 20.0]])
    return 5.0 * np.array([[-10.0, 10.0], [-10.0, 10.0]])


def label_offsets(scenario: str, n_veh: int) -> np.ndarray:
    """Per-vehicle offsets (n_veh, 2) of the vehicle-number labels from the
    vehicle centers (the original controller's ``labelOffset``)."""
    out = np.zeros((n_veh, 2))
    if scenario == "circle":
        angles = [2 * math.pi / n_veh * (i + 1) for i in range(n_veh)]
        for i, a in enumerate(angles):
            c, s = math.cos(a), math.sin(a)
            out[i] = (np.array([[3.0, -3.0]])
                      @ np.array([[c, s], [-s, c]])
                      + np.array([[-2.0, 0.0]]))[0]
    elif scenario == "parallel":
        _positions = np.arange(n_veh) - math.floor(n_veh / 2)
        order = list(range(n_veh))
        evens = order[0:n_veh:2]
        evens.reverse()
        order = evens + order[1:n_veh:2]
        positions = np.zeros(n_veh)
        positions[order] = _positions
        out[:, 0] = -6.1 - 4.5 * np.mod(positions - 1, 2)
    return out
