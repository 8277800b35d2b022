"""Frozen copy of ``ops/discretize.py`` of the PyTorch port, for the benchmark's
plain reference (imports nothing of the port). The port's docstring:

Exact zero-order-hold discretization of the linearized dynamics
(counterpart of ``scp_tpu/ops/discretize.py``).

Both augmentations of the ZOH are fused into ONE matrix exponential of the
``[[Ac, Bc, Ec], [0, 0, 0]]`` block; the exponential is a solve-free Taylor
scaling-and-squaring on batched 8x8 matrices (``torch.matmul``).
"""
from __future__ import annotations

import torch

from reference.config import NX, NU
from reference import bicycle

_SQUARINGS = 6    # scale by 2^-6: ||M/2^s|| <= 0.32 for ||dt*M|| <= 20
_ORDER = 12       # Taylor order after scaling


def _expm_taylor(M: torch.Tensor) -> torch.Tensor:
    """exp(M) by Taylor series + scaling-and-squaring, batched over leading
    axes. Order-12 truncation after scaling by 2^-6: error below 4e-20
    relative for ``||M|| <= 20``. The polynomial is evaluated
    Paterson-Stockmeyer style in powers of A^3, in the same order as
    ``scp_tpu`` so f64 results agree to round-off."""
    A = M * (1.0 / 2 ** _SQUARINGS)
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    inv_f = [1.0]
    for k in range(1, _ORDER + 1):
        inv_f.append(inv_f[-1] / k)

    A2 = A @ A
    A3 = A2 @ A

    def p(j):  # c_{3j} I + c_{3j+1} A + c_{3j+2} A^2
        out = inv_f[3 * j] * eye
        if 3 * j + 1 <= _ORDER:
            out = out + inv_f[3 * j + 1] * A
        if 3 * j + 2 <= _ORDER:
            out = out + inv_f[3 * j + 2] * A2
        return out

    # Horner in B = A^3: E = p0 + B (p1 + B (p2 + B (p3 + B p4)))
    E = p(4)
    for j in (3, 2, 1, 0):
        E = p(j) + A3 @ E
    for _ in range(_SQUARINGS):
        E = E @ E
    return E


def zoh(Ac: torch.Tensor, Bc: torch.Tensor, Ec: torch.Tensor, dt: float):
    """Discretize ``dx = Ac x + Bc u + Ec`` with a zero-order hold.

    Ac (..., NX, NX), Bc (..., NX, NU), Ec (..., NX). Returns
    ``(Ad, Bd, Ed)`` with ``x[k+1] = Ad x[k] + Bd u[k] + Ed``.
    """
    n_aug = NX + NU + 1
    M = Ac.new_zeros(Ac.shape[:-2] + (n_aug, n_aug))
    M[..., :NX, :NX] = Ac
    M[..., :NX, NX:NX + NU] = Bc
    M[..., :NX, NX + NU] = Ec
    eM = _expm_taylor(dt * M)
    Ad = eM[..., :NX, :NX]
    Bd = eM[..., :NX, NX:NX + NU]
    Ed = eM[..., :NX, NX + NU]
    return Ad, Bd, Ed


def linearize_and_discretize(x0: torch.Tensor, u0: torch.Tensor, lf, lr,
                             dt: float):
    """Continuous linearization at ``(x0, u0)`` + ZOH discretization, one
    (Ad, Bd, Ed) per linearization point; broadcasts over leading axes."""
    Ac, Bc, Ec = bicycle.linearize(x0, u0, lf, lr)
    return zoh(Ac, Bc, Ec, dt)


# The batch axes (instances, vehicles) are leading axes of the same function.
linearize_and_discretize_batch = linearize_and_discretize
