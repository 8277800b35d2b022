"""Frozen copy of ``ops/constraints.py`` of the PyTorch port, for the benchmark's
plain reference (imports nothing of the port). The port's docstring:

Structured QCQP collision constraints on batched tensors (counterpart of
``scp_tpu/ops/constraints.py``, ``linearize_ycoefs`` included).

Each pair constraint ``(i, j, k)`` is::

    c = (dsafe + extra)^2 - || p_i[k](u) - p_j[k](u) ||^2
    p_v[k](u) = const_term[v, k] + B[v, k] @ u_v

(and analogously with a fixed obstacle position). Constraint values,
gradients and the linearized QP rows all come from predicted positions via
batched einsums; no dense quadratic forms are built.

Stacked decision variable: ``u = concat_v(u_v)``, block of Hu per vehicle.
Row ordering: vehicle pairs in ``triu`` order (pair-major, horizon-minor),
then (vehicle, obstacle, k). Every tensor carries a leading batch axis B.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.config import NY


class ConstraintSystem(NamedTuple):
    """Problem data of a batch of scenario instances.

    V = n_veh, O = n_obst, K = hp, U = hu, P = V*(V-1)/2 pairs.
    """
    b3: torch.Tensor           # (B, V, K, NY, U)  per-step blocks of math_b
    const3: torch.Tensor       # (B, V, K, NY)     per-step const_term
    obst_pos: torch.Tensor     # (B, O, K, NY)     predicted obstacle centers
    dsafe2_pair: torch.Tensor  # (B, P)   (dsafe_veh + extra)^2 per pair
    dsafe2_obst: torch.Tensor  # (B, V, O) (dsafe_obst + extra)^2
    pair_i: torch.Tensor       # (B, P) pair indices (i < j), int64
    pair_j: torch.Tensor       # (B, P)
    pair_mask: torch.Tensor    # (B, P)   1.0 = coupled pair, 0.0 = ignored
    obst_mask: torch.Tensor    # (B, V, O) 1.0 = active obstacle constraint
    b3i: torch.Tensor          # (B, P, K, NY, U) = b3[:, pair_i], gathered
    b3j: torch.Tensor          # (B, P, K, NY, U) = b3[:, pair_j]  once


def _static_pairs(v: int):
    """triu pair indices as Python ints."""
    iu, ju = np.triu_indices(v, k=1)
    return list(zip(iu.tolist(), ju.tolist()))


def _pair_index(v: int, device):
    pairs = _static_pairs(v)
    iu = torch.tensor([i for i, _ in pairs], dtype=torch.long, device=device)
    ju = torch.tensor([j for _, j in pairs], dtype=torch.long, device=device)
    return iu, ju


def make_system(math_b, const_term, obst_pos, dsafe_veh, dsafe_obst,
                dsafe_extra, hp: int, hu: int,
                coupling: torch.Tensor | None = None,
                obst_coupling: torch.Tensor | None = None
                ) -> ConstraintSystem:
    """Assemble the structured system from per-vehicle condensed matrices.

    math_b: (B, V, hp*NY, hu), const_term: (B, V, hp*NY),
    obst_pos: (B, O, hp, NY), dsafe_veh (B, V, V), dsafe_obst (B, V, O).

    ``coupling`` is an optional (B, V, V) adjacency matrix selecting which
    vehicle pairs are constrained; ``obst_coupling`` (B, V, O) does the same
    for vehicle-obstacle constraints.
    """
    b, v = math_b.shape[:2]
    b3 = math_b.reshape(b, v, hp, NY, hu)
    const3 = const_term.reshape(b, v, hp, NY)
    iu, ju = _pair_index(v, math_b.device)
    dsafe2_pair = (dsafe_veh[:, iu, ju] + dsafe_extra) ** 2
    dsafe2_obst = (dsafe_obst + dsafe_extra) ** 2
    dtype = math_b.dtype
    if coupling is None:
        pair_mask = torch.ones((b, iu.shape[0]), dtype=dtype,
                               device=math_b.device)
    else:
        cm = coupling.to(dtype)
        pair_mask = torch.maximum(cm[:, iu, ju], cm[:, ju, iu])
    if obst_coupling is None:
        obst_mask = torch.ones_like(dsafe2_obst)
    else:
        obst_mask = obst_coupling.to(dtype)
    return ConstraintSystem(
        b3, const3, obst_pos, dsafe2_pair, dsafe2_obst,
        iu.expand(b, -1).contiguous(), ju.expand(b, -1).contiguous(),
        pair_mask, obst_mask, b3i=b3[:, iu], b3j=b3[:, ju])


def positions(sys: ConstraintSystem, u: torch.Tensor) -> torch.Tensor:
    """Predicted positions (B, V, K, NY) for stacked controls u (B, V*hu)."""
    b, v, k, _, hu = sys.b3.shape
    uv = u.reshape(b, v, hu)
    return sys.const3 + torch.einsum("bvkyu,bvu->bvky", sys.b3, uv)


def _pair_diff(pos: torch.Tensor, v: int) -> torch.Tensor:
    """pos[:, pair_i] - pos[:, pair_j] -> (B, P, K, NY)."""
    iu, ju = _pair_index(v, pos.device)
    return pos[:, iu] - pos[:, ju]


def constraint_values(sys: ConstraintSystem, u: torch.Tensor):
    """Exact (concave-quadratic) constraint values at ``u``.

    Returns ``(c_pair (B, P, K), c_obst (B, V, O, K))`` — positive =
    violated.
    """
    pos = positions(sys, u)
    d_pair = _pair_diff(pos, sys.b3.shape[1])
    c_pair = sys.dsafe2_pair[:, :, None] - torch.sum(d_pair ** 2, -1)
    d_obst = pos[:, :, None] - sys.obst_pos[:, None]      # (B, V, O, K, NY)
    c_obst = sys.dsafe2_obst[:, :, :, None] - torch.sum(d_obst ** 2, -1)
    return c_pair, c_obst


def linearize_slabs(sys: ConstraintSystem, u: torch.Tensor,
                    with_values: bool = False):
    """Linearize every constraint at ``u`` into PAIR-SPARSE row slabs.

    The rows are returned restricted to the vehicle blocks they touch —
    ``gi/gj (B, P, K, U)`` for the pair rows and ``gob (B, V, O, K, U)``
    for the obstacle rows — so the mostly-zero dense ``(C, n)`` matrix never
    has to exist. This is the native input of the structured fused QP
    (``qp.solve_qp_batched``'s ``g_slabs``). Coupling masks are already
    applied. Returns ``(gi, gj, gob, rhs)`` with rhs (B, C) over rows
    ordered [pairs p-major k-minor | (v, o) k-minor].

    ``with_values``: additionally return the raw constraint values
    ``(c_pair (B, P, K), c_obst (B, V, O, K))`` computed on the way.
    """
    b, v, k, _, hu = sys.b3.shape
    pos = positions(sys, u)
    iu, ju = _pair_index(v, u.device)

    # --- vehicle pairs ---
    d_pair = pos[:, iu] - pos[:, ju]                      # (B, P, K, NY)
    c_pair = sys.dsafe2_pair[:, :, None] - torch.sum(d_pair ** 2, -1)
    gi = -2.0 * torch.einsum("bpky,bpkyu->bpku", d_pair, sys.b3i)
    gj = 2.0 * torch.einsum("bpky,bpkyu->bpku", d_pair, sys.b3j)
    uv = u.reshape(b, v, hu)
    gdotu_pair = (torch.einsum("bpku,bpu->bpk", gi, uv[:, iu])
                  + torch.einsum("bpku,bpu->bpk", gj, uv[:, ju]))
    rhs_pair = gdotu_pair - c_pair

    # --- obstacles ---
    d_obst = pos[:, :, None] - sys.obst_pos[:, None]      # (B, V, O, K, NY)
    c_obst = sys.dsafe2_obst[:, :, :, None] - torch.sum(d_obst ** 2, -1)
    gv = -2.0 * torch.einsum("bvoky,bvkyu->bvoku", d_obst, sys.b3)
    gdotu_obst = torch.einsum("bvoku,bvu->bvok", gv, uv)
    rhs_obst = gdotu_obst - c_obst

    # Coupling masks: dropped constraints become 0·u <= big (trivially slack).
    big = torch.full((), 1e10, dtype=u.dtype, device=u.device)
    gi = gi * sys.pair_mask[:, :, None, None]
    gj = gj * sys.pair_mask[:, :, None, None]
    rhs_pair = torch.where(sys.pair_mask[:, :, None] > 0, rhs_pair, big)
    gv = gv * sys.obst_mask[:, :, :, None, None]
    rhs_obst = torch.where(sys.obst_mask[:, :, :, None] > 0, rhs_obst, big)

    rhs = torch.cat([rhs_pair.reshape(b, -1), rhs_obst.reshape(b, -1)],
                    dim=1)
    if with_values:
        return gi, gj, gv, rhs, c_pair, c_obst
    return gi, gj, gv, rhs


def linearize_ycoefs(sys: ConstraintSystem, u: torch.Tensor):
    """POSITION-space coefficients of the linearized rows at ``u``: the input
    of the banded (Riccati) KKT path (``ops/riccati.py``). Pair row (p, k)
    acts on the stage positions as ``y_pair[p,k]·Δy_k^i - y_pair[p,k]·Δy_k^j``
    and obstacle row (v, o, k) as ``y_obst[v,o,k]·Δy_k^v`` — the rows
    :func:`linearize_slabs` returns already multiplied into the condensed
    blocks. Coupling masks are applied (masked rows are zero rows). Returns
    ``(y_pair (B, P, K, NY), y_obst (B, V, O, K, NY))``."""
    pos = positions(sys, u)
    d_pair = _pair_diff(pos, sys.b3.shape[1])
    y_pair = -2.0 * d_pair * sys.pair_mask[:, :, None, None]
    d_obst = pos[:, :, None] - sys.obst_pos[:, None]
    y_obst = -2.0 * d_obst * sys.obst_mask[:, :, :, None, None]
    return y_pair, y_obst


def scatter_slabs(v: int, gi, gj, gob, dtype=None):
    """Assemble the dense stacked ``G (B, C, n)`` from row slabs (the dense
    layout, kept as the oracle-parity form; the fused QP never needs it)."""
    pairs = _static_pairs(v)
    b = gob.shape[0]
    k, hu = gob.shape[3], gob.shape[4]
    o = gob.shape[2]
    dtype = dtype or gi.dtype
    g_pair = torch.zeros((b, len(pairs), k, v, hu), dtype=dtype,
                         device=gob.device)
    for pp, (i, j) in enumerate(pairs):
        g_pair[:, pp, :, i] = gi[:, pp]
        g_pair[:, pp, :, j] = gj[:, pp]
    g_obst = torch.zeros((b, v, o, k, v, hu), dtype=dtype, device=gob.device)
    for vv in range(v):
        g_obst[:, vv, :, :, vv] = gob[:, vv]
    n = v * hu
    return torch.cat([g_pair.reshape(b, -1, n), g_obst.reshape(b, -1, n)],
                     dim=1)


def linearize(sys: ConstraintSystem, u: torch.Tensor):
    """Linearize every constraint at ``u``: rows ``g`` with ``g @ x <= rhs``.
    Returns ``(G (B, C, n), rhs (B, C))`` with C = P*K + V*O*K, n = V*hu."""
    v = sys.b3.shape[1]
    gi, gj, gob, rhs = linearize_slabs(sys, u)
    return scatter_slabs(v, gi, gj, gob, dtype=u.dtype), rhs


class Violations(NamedTuple):
    feasible: torch.Tensor       # (B,) bool
    max_violation: torch.Tensor  # (B,) max over violated constraints, 0 if none
    sum_violations: torch.Tensor
    c_pair: torch.Tensor
    c_obst: torch.Tensor


def _max_initial0(x: torch.Tensor) -> torch.Tensor:
    """max over all non-batch axes with initial value 0 (an empty constraint
    set — e.g. no obstacles — gives 0 instead of raising)."""
    flat = x.reshape(x.shape[0], -1)
    if flat.shape[1] == 0:
        return x.new_zeros((x.shape[0],))
    return flat.amax(dim=1).clamp(min=0.0)


def _max_or_neg_inf(x: torch.Tensor) -> torch.Tensor:
    """max over all non-batch axes with initial value -inf (an empty set —
    no obstacle, no pair — gives -inf instead of raising)."""
    flat = x.reshape(x.shape[0], -1)
    if flat.shape[1] == 0:
        return torch.full((x.shape[0],), float("-inf"), dtype=x.dtype,
                          device=x.device)
    return flat.amax(dim=1)


def evaluate(sys: ConstraintSystem, u: torch.Tensor, tol: float,
             compat_q5: bool = True) -> Violations:
    """Violation bookkeeping of the exact constraints at ``u``.

    ``compat_q5=True`` reproduces the original controller's loop-nesting
    quirk: with one vehicle obstacle violations are never counted, and with
    n > 2 vehicles each (v, o, k) obstacle term is counted ``nVeh - 1 - v``
    times in ``sum_violations``. ``feasible``/``max_violation`` are only
    affected by the single-vehicle skip.
    """
    c_pair, c_obst = constraint_values(sys, u)
    return violations_from_values(sys, c_pair, c_obst, tol, compat_q5)


def violations_from_values(sys: ConstraintSystem, c_pair, c_obst, tol: float,
                           compat_q5: bool = True) -> Violations:
    """:func:`evaluate`'s bookkeeping on PRECOMPUTED constraint values."""
    n_veh = sys.b3.shape[1]
    zero = torch.zeros((), dtype=c_pair.dtype, device=c_pair.device)

    pair_viol = torch.where(c_pair > tol, c_pair, zero) \
        * sys.pair_mask[:, :, None]
    obst_viol = torch.where(c_obst > tol, c_obst, zero) \
        * sys.obst_mask[:, :, :, None]

    if compat_q5 and n_veh == 1:
        obst_seen = torch.zeros_like(obst_viol)
    else:
        obst_seen = obst_viol

    max_pair = _max_initial0(pair_viol)
    max_obst = _max_initial0(obst_seen)
    max_violation = torch.maximum(max_pair, max_obst)
    if compat_q5:
        # multiplicity (nVeh - 1 - v) per vehicle v in the original sum
        mult = torch.clamp(
            n_veh - 1 - torch.arange(n_veh, dtype=c_pair.dtype,
                                     device=c_pair.device), min=0.0)
        sum_obst = torch.einsum("v,bvok->b", mult, obst_viol)
    else:
        sum_obst = obst_viol.sum(dim=(1, 2, 3))
    sum_violations = pair_viol.sum(dim=(1, 2)) + sum_obst
    feasible = (max_pair <= 0.0) & (max_obst <= 0.0)
    return Violations(feasible, max_violation, sum_violations, c_pair, c_obst)


def objective(phi0, psi0, gamma0, u: torch.Tensor) -> torch.Tensor:
    """Tracking objective u^T Phi0 u + Psi0^T u + gamma0 with block-diagonal
    per-vehicle Phi0.

    phi0: (B, V, hu, hu), psi0: (B, V, hu), gamma0: (B, V), u: (B, V*hu).
    Returns (B,).
    """
    b, v, hu, _ = phi0.shape
    uv = u.reshape(b, v, hu)
    quad = torch.einsum("bvu,bvuw,bvw->b", uv, phi0, uv)
    lin = torch.einsum("bvu,bvu->b", psi0, uv)
    return quad + lin + gamma0.sum(dim=1)
