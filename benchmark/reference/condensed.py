"""Frozen copy of ``ops/condensed.py`` of the PyTorch port, for the benchmark's
plain reference (imports nothing of the port). The port's docstring:

Condensed MPC prediction and cost matrices (counterpart of
``scp_tpu/ops/condensed.py``).

For discrete dynamics ``x+ = A x + B u + E`` and output ``y = C x``::

    Y = MathA @ x0 + MathB @ U + MathC
    MathA[i]   = C A^(i+1)                    (i = 0..Hp-1)
    MathB[i,j] = C A^(i-j) B   for j <= i, j < Hu
    MathC[i]   = (sum_{m=0..i} C A^m) E

Every function broadcasts over leading axes (instances, vehicles). With
Hu < Hp the B-blocks with column index >= Hu are dropped (truncation, not
a held last control), as in ``scp_tpu``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference.config import NX, NU, NY
from reference.bicycle import output_matrix


class CondensedMatrices(NamedTuple):
    """Per-vehicle condensed matrices (leading axes: instances, vehicles)."""
    math_a: torch.Tensor      # (..., Hp*NY, NX)
    math_b: torch.Tensor      # (..., Hp*NY, Hu*NU)
    math_c: torch.Tensor      # (..., Hp*NY)
    const_term: torch.Tensor  # (..., Hp*NY)  = math_a @ x0 + math_c
    phi0: torch.Tensor        # (..., Hu*NU, Hu*NU) quadratic cost
    psi0: torch.Tensor        # (..., Hu*NU)       linear cost
    gamma0: torch.Tensor      # (...)              constant cost


def prediction_matrices(A: torch.Tensor, B: torch.Tensor, E: torch.Tensor,
                        hp: int, hu: int):
    """Build (math_a, math_b, math_c).

    A: (..., NX, NX), B: (..., NX, NU), E: (..., NX).
    """
    lead = A.shape[:-2]
    C = output_matrix(A.dtype, A.device).expand(lead + (NY, NX))

    # CA[i] = C @ A^i for i = 0..hp
    ca = [C]
    for _ in range(hp):
        ca.append(ca[-1] @ A)
    ca_all = torch.stack(ca, dim=-3)                    # (..., hp+1, NY, NX)
    ca_powers = ca_all[..., 1:, :, :]                   # CA^1..CA^hp

    math_a = ca_powers.reshape(lead + (hp * NY, NX))

    # math_c block i = (sum_{m<=i} C A^m) @ E
    ca_cumsum = torch.cumsum(ca_all[..., :hp, :, :], dim=-3)
    math_c = (ca_cumsum @ E[..., None, :, None])[..., 0].reshape(
        lead + (hp * NY,))

    # math_b block (i, j) = CA^(i-j) @ B, j <= i, j < hu.
    cab = ca_all @ B[..., None, :, :]                   # (..., hp+1, NY, NU)
    ii = torch.arange(hp, device=A.device)[:, None]
    jj = torch.arange(hu, device=A.device)[None, :]
    diff = ii - jj                                      # (hp, hu)
    blocks = cab[..., diff.clamp(0, hp), :, :]          # (..., hp, hu, NY, NU)
    blocks = torch.where((diff >= 0)[:, :, None, None], blocks,
                         torch.zeros((), dtype=A.dtype, device=A.device))
    # (..., hp, hu, NY, NU) -> (..., hp, NY, hu, NU) -> (..., hp*NY, hu*NU)
    math_b = blocks.transpose(-3, -2).reshape(lead + (hp * NY, hu * NU))
    return math_a, math_b, math_c


def cost_matrices(math_b: torch.Tensor, const_term: torch.Tensor,
                  reference: torch.Tensor, q_weight, r_weight, q_final,
                  hp: int, hu: int):
    """Quadratic tracking cost in the condensed variable U.

    Q = q*I with q_final on the last NY rows; R = r*I;
    Error = reference - const_term; phi0 = sym(B^T Q B + R),
    psi0 = -2 B^T Q Error, gamma0 = Error^T Q Error. ``q_weight``,
    ``r_weight``, ``q_final`` are (...) tensors.
    """
    lead = math_b.shape[:-2]
    q_diag = q_weight[..., None].expand(lead + (hp * NY,)).clone()
    q_diag[..., NY * (hp - 1):] = q_final[..., None]
    err = reference - const_term
    bq = math_b.transpose(-1, -2) * q_diag[..., None, :]      # B^T Q
    eye = torch.eye(hu * NU, dtype=math_b.dtype, device=math_b.device)
    phi0 = bq @ math_b + r_weight[..., None, None] * eye
    phi0 = 0.5 * (phi0 + phi0.transpose(-1, -2))
    psi0 = -2.0 * (bq @ err[..., None])[..., 0]
    gamma0 = torch.sum(err * q_diag * err, dim=-1)
    return phi0, psi0, gamma0


def build_condensed(A, B, E, x0, reference, q_weight, r_weight, q_final,
                    hp: int, hu: int) -> CondensedMatrices:
    """Full condensed-matrix pipeline.

    x0: (..., NX), reference: (..., hp*NY) stacked [x0,y0,x1,y1,...].
    """
    math_a, math_b, math_c = prediction_matrices(A, B, E, hp, hu)
    const_term = (math_a @ x0[..., None])[..., 0] + math_c
    phi0, psi0, gamma0 = cost_matrices(
        math_b, const_term, reference, q_weight, r_weight, q_final, hp, hu)
    return CondensedMatrices(math_a, math_b, math_c, const_term,
                             phi0, psi0, gamma0)


# The batch axes (instances, vehicles) are leading axes of the same function.
build_condensed_batch = build_condensed
