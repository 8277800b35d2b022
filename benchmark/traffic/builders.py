"""Nominal scenario instances of the upstream scenario families, as plain
tensors: a frozen copy of the PyTorch port's ``scenarios/builders.py``
(circle, frog, parallel; ``Scenarios.py`` of the upstream controller),
returning a dict of tensors with a leading batch axis of 1 instead of the
port's ``ScenarioData``. The safety distances are computed on the host in
float64 and cast, as the port does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NX = 6  # state: [x, y, heading, v_rear, accel, steering]

# Obstacle table column indices
OBST_X, OBST_Y, OBST_HEADING, OBST_SPEED, OBST_LENGTH, OBST_WIDTH = range(6)

# The upstream's default vehicle (``Scenarios.py``): axle distances,
# bumper-to-bumper length and width [m], and the tracking / terminal /
# steering-rate weights.
VEHICLE = {"lf": 0.34, "lr": 0.34, "length": 0.98, "width": 0.88,
           "q": 1.0, "q_final": 20.0, "r": 4000.0}


def safety_distances(speeds, lengths, widths, obstacles, dt):
    """Pairwise vehicle and vehicle-obstacle safety distances
    ``sqrt((max_chord/2)^2 + R^2)``, float64 numpy ``(V, V)``, ``(V, O)``."""
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
    return dsafe_veh, dsafe_obst


def _scenario(starts, headings, speeds, ref_lines, obstacles, n_ref_points,
              dt, dtype, device):
    n_veh = len(starts)
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
        speeds, [VEHICLE["length"]] * n_veh, [VEHICLE["width"]] * n_veh,
        obstacles, dt)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)[None]

    out = {"x0": dev(x0), "u0": dev(np.zeros(n_veh)),
           "ref_points": dev(ref_pts),
           "ref_valid": torch.as_tensor(ref_valid, device=device)[None],
           "obstacles": dev(obstacles), "dsafe_veh": dev(dsafe_veh),
           "dsafe_obst": dev(dsafe_obst)}
    for key, value in VEHICLE.items():
        out[key] = dev(np.full(n_veh, value))
    return out


def circle(dt, dtype, device, n_veh=8, radius=30.0):
    """N vehicles on a circle driving to antipodal points."""
    angles = [2 * math.pi / n_veh * (i + 1) for i in range(n_veh)]
    starts, headings, speeds, lines = [], [], [], []
    for a in angles:
        c, s = math.cos(a), math.sin(a)
        starts.append((-c * radius, -s * radius))
        headings.append(a)
        speeds.append(4.0)
        lines.append([[-c * radius, -s * radius], [c * radius, s * radius]])
    return _scenario(starts, headings, speeds, lines, np.zeros((0, 6)), 2,
                     dt, dtype, device)


def frog(dt, dtype, device):
    """One vehicle crossing two moving obstacle lanes."""
    obstacles = [[x, 9.0 * o - 15.0, math.pi / 2, 2.0, 4.0, 2.0]
                 for o in range(-2, 9) for x in (7.0, 14.0)]
    return _scenario([(-18.0, 0.0)], [0.0], [4.0],
                     [[[-100.0, 0.0], [100.0, 0.0]]], np.array(obstacles),
                     2, dt, dtype, device)


def parallel(dt, dtype, device, n_veh=11):
    """Parallel lanes with 4 static obstacles."""
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
    return _scenario(starts, headings, speeds, lines, obstacles, 2, dt,
                     dtype, device)


BUILDERS = {"circle": circle, "frog": frog, "parallel": parallel}
