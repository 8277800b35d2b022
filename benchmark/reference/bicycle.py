"""Frozen copy of ``models/bicycle.py`` of the PyTorch port, for the benchmark's
plain reference (imports nothing of the port). The port's docstring:

Kinematic bicycle model on batched tensors (counterpart of
``scp_tpu/models/bicycle.py``).

A 6-state kinematic bicycle with a first-order steering actuator
``du = (u_ref - u)/0.1`` and rear-axle -> center speed correction. Every
function broadcasts over arbitrary leading axes (instances, vehicles): ``x``
is ``(..., NX)`` and ``u_ref``, ``lf``, ``lr`` are ``(...)``.

State layout: ``[x, y, heading, v_rear, accel, steering]``.
"""
from __future__ import annotations

import torch

from reference.config import NX, NU, NY

STEERING_TIME_CONSTANT = 0.1  # first-order actuator lag [s]


def ode(x: torch.Tensor, u_ref: torch.Tensor, lf: torch.Tensor,
        lr: torch.Tensor) -> torch.Tensor:
    """Continuous-time dynamics dx/dt. ``x``: (..., NX), ``u_ref``: (...)."""
    L = lf + lr
    R = lr / L
    phi = x[..., 2]
    v_rear = x[..., 3]
    a = x[..., 4]
    u = x[..., 5]
    tan_u = torch.tan(u)
    v_center = v_rear * torch.sqrt(1.0 + (R * tan_u) ** 2)
    beta = torch.atan(R * tan_u)  # slip angle
    return torch.stack([
        v_center * torch.cos(phi + beta),
        v_center * torch.sin(phi + beta),
        v_center * tan_u * torch.cos(beta) / L,
        a,
        torch.zeros_like(a),
        (u_ref - u) / STEERING_TIME_CONSTANT,
    ], dim=-1)


def output_matrix(dtype=torch.float64, device=None) -> torch.Tensor:
    """C = eye(NY, NX): the measured output is the (x, y) position."""
    return torch.eye(NY, NX, dtype=dtype, device=device)


def linearize(x: torch.Tensor, u_ref: torch.Tensor, lf: torch.Tensor,
              lr: torch.Tensor):
    """Exact continuous-time linearization around ``(x, u_ref)``.

    Returns ``(Ac (..., NX, NX), Bc (..., NX, NU), Ec (..., NX))`` with
    ``dx = Ac x + Bc u + Ec``. ``scp_tpu`` takes the Jacobian by forward-mode
    autodiff; here it is written out (six nonzero columns entries per row at
    most), which needs no nested ``vmap`` and agrees to round-off.
    """
    L = lf + lr
    R = lr / L
    phi = x[..., 2]
    v = x[..., 3]
    u = x[..., 5]
    t = torch.tan(u)
    sec2 = 1.0 + t * t
    g = torch.sqrt(1.0 + (R * t) ** 2)          # v_center / v_rear
    beta = torch.atan(R * t)
    dg_du = R * R * t * sec2 / g
    dbeta_du = R * sec2 / (g * g)
    c = torch.cos(phi + beta)
    s = torch.sin(phi + beta)
    vc = v * g
    cb = torch.cos(beta)

    Ac = x.new_zeros(x.shape[:-1] + (NX, NX))
    Ac[..., 0, 2] = -vc * s
    Ac[..., 0, 3] = g * c
    Ac[..., 0, 5] = v * dg_du * c - vc * s * dbeta_du
    Ac[..., 1, 2] = vc * c
    Ac[..., 1, 3] = g * s
    Ac[..., 1, 5] = v * dg_du * s + vc * c * dbeta_du
    Ac[..., 2, 3] = g * t * cb / L
    Ac[..., 2, 5] = (v * dg_du * t * cb + vc * sec2 * cb
                     - vc * t * torch.sin(beta) * dbeta_du) / L
    Ac[..., 3, 4] = 1.0
    Ac[..., 5, 5] = -1.0 / STEERING_TIME_CONSTANT
    Bc = x.new_zeros(x.shape[:-1] + (NX, NU))
    Bc[..., 5, 0] = 1.0 / STEERING_TIME_CONSTANT
    f0 = ode(x, u_ref, lf, lr)
    Ec = f0 - (Ac @ x[..., None])[..., 0] - Bc[..., 0] * u_ref[..., None]
    return Ac, Bc, Ec


def rk4_step(x: torch.Tensor, u_ref: torch.Tensor, lf, lr, h) -> torch.Tensor:
    """One classical RK4 step of size ``h`` with zero-order-hold control."""
    k1 = ode(x, u_ref, lf, lr)
    k2 = ode(x + 0.5 * h * k1, u_ref, lf, lr)
    k3 = ode(x + 0.5 * h * k2, u_ref, lf, lr)
    k4 = ode(x + h * k3, u_ref, lf, lr)
    return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def integrate(x0: torch.Tensor, u_ref: torch.Tensor, lf, lr, h: float,
              n_steps: int, substeps: int = 1) -> torch.Tensor:
    """Integrate ``n_steps`` intervals of length ``h`` with constant
    ``u_ref``. Returns the trajectory including the initial state,
    shape (..., n_steps+1, NX)."""
    hs = h / substeps
    traj = [x0]
    x = x0
    for _ in range(n_steps):
        for _ in range(substeps):
            x = rk4_step(x, u_ref, lf, lr, hs)
        traj.append(x)
    return torch.stack(traj, dim=-2)
