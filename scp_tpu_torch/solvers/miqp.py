"""Side-selection controller on batched tensors (counterpart of
``scp_tpu/solvers/miqp.py``): the masked convex program that replaces the
big-M MIQP.

The MIQP encodes collision avoidance with binary side selection: per
(vehicle, obstacle, step) and per vehicle pair, binaries choose one of four
separating half-planes. Here the binaries are fixed by a heuristic instead:

1. pick each constraint's separating half-plane from the geometry of a
   warm-start trajectory (five candidate assignments in the first round);
2. solve the convex QP with those fixed linear rows + an exact-penalty
   slack (all candidates of all instances as one batch);
3. re-select sides from the new trajectory and re-solve, keep the best
   incumbent over the rounds, and report whether the reselection reached
   its fixed point.

The objective is the MIQP's: tracking cost ``Q |y_k - ref_k|^2``
(``Q_final`` on the terminal step) plus the steering-rate cost
``R (u_k - u_{k-1})^2``, with ``|u| <= uMax`` and hard ``|du| <= uLim``
rows.

Every function takes the leading batch axis B of the rest of the port; the
discrete choices (the candidate pick, the best incumbent, the faces'
ranking) are made by :func:`_arg_first`, which resolves ties to the first
index as ``jnp.argmax`` / ``jnp.argmin`` do.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from scp_tpu_torch.config import tree_map
from scp_tpu_torch.ops import constraints as con
from scp_tpu_torch.solvers import qp
from scp_tpu_torch.utils import timing

# The four axis-aligned half-plane normals of the big-M formulation: +x, -x,
# +y, -y (a host constant, moved to the device and dtype where it is used).
_SIDES = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])


class SideSelectionResult(NamedTuple):
    u: torch.Tensor             # (B, V*Hu) stacked controls
    obj: torch.Tensor           # (B,) QP objective value
    slack: torch.Tensor         # (B,) exact-penalty slack (0 => hard-feasible)
    feasible: torch.Tensor      # (B,) true QCQP feasibility of the solution
    converged: torch.Tensor     # (B,) QP converged on the kept round
    rounds: torch.Tensor        # (B,) side-reselection rounds used
    sides_stable: torch.Tensor  # (B,) bool — the reselection fixed point was
    # reached (the kept assignment equals the one its own solution induces,
    # or that solution already satisfies every induced row)
    qp_iters: torch.Tensor      # (B,) IPM iterations summed over every
    # solved QP: all first-round candidates + every reselection round


def _arg_first(x: torch.Tensor, dim: int, largest: bool = True
               ) -> torch.Tensor:
    """Index of the largest (``largest``) or smallest entry along ``dim``,
    by ``jnp.argmax`` / ``jnp.argmin``'s rule: the FIRST index among ties, a
    NaN counts as the extreme (the first NaN wins), and a row of equal
    values — all ``-inf`` included — gives 0."""
    m = x.amax(dim, keepdim=True) if largest else x.amin(dim, keepdim=True)
    hit = (x == m) | torch.isnan(x)
    shape = [1] * x.ndim
    shape[dim] = x.shape[dim]
    idx = torch.arange(x.shape[dim], device=x.device).reshape(shape)
    return torch.where(hit, idx, x.shape[dim]).amin(dim)


def select_sides(delta: torch.Tensor) -> torch.Tensor:
    """Index into ``_SIDES`` of the dominant-axis separating half-plane for
    displacement(s) ``delta (..., 2)`` (a - b): ``n·(a-b) >= d`` is the
    half-plane the MIQP's binaries would activate for this geometry (the
    index of ``scp_tpu``'s one-hot; the x side wins a tie)."""
    ax = delta[..., 0].abs() >= delta[..., 1].abs()
    pos_x = delta[..., 0] >= 0
    pos_y = delta[..., 1] >= 0
    return torch.where(ax, torch.where(pos_x, 0, 1), torch.where(pos_y, 2, 3))


def _slabs_from_selection(sys: con.ConstraintSystem,
                          sel_pair: torch.Tensor,    # (B, P, K) in [0, 4)
                          sel_obst: torch.Tensor,    # (B, V, O, K)
                          dsafe_pair: torch.Tensor,  # (B, P)
                          dsafe_obst: torch.Tensor,  # (B, V, O)
                          obst_normals=None, obst_dists=None):
    """Separation rows for an EXPLICIT side assignment, as pair-sparse row
    slabs: ``gi/gj (B, P, K, U)`` (the two vehicle blocks of each pair row)
    and ``gob (B, V, O, K, U)`` (the single block of each obstacle row),
    with the right-hand sides ``h_pair (B, P, K)`` and ``h_obst (B, V, O,
    K)``. The rows enforce ``n·(p_i - p_j) >= d`` for the given side of
    each constraint — the convex subproblem of the big-M MIQP once its
    binaries are fixed. ``obst_normals (B, O, 4, 2)`` / ``obst_dists (B, V,
    O, 4)`` switch the obstacle rows to the rotated-rectangle faces."""
    dtype = sys.b3.dtype
    sides = torch.as_tensor(_SIDES, dtype=dtype, device=sys.b3.device)
    iu, ju = sys.pair_i[0], sys.pair_j[0]

    # vehicle pairs: n·(p_i - p_j) >= d
    #   =>  -n·(B_i u_i - B_j u_j) <= n·(c_i - c_j) - d
    nvec_p = sides[sel_pair]                                  # (B, P, K, 2)
    gi = -torch.einsum("bpky,bpkyu->bpku", nvec_p, sys.b3i)
    gj = torch.einsum("bpky,bpkyu->bpku", nvec_p, sys.b3j)
    c_diff = sys.const3[:, iu] - sys.const3[:, ju]
    h_pair = torch.einsum("bpky,bpky->bpk", nvec_p, c_diff) \
        - dsafe_pair[:, :, None]

    # obstacles: axis-aligned circle mode or rotated rectangle faces
    if obst_normals is None:
        nvec_o = sides[sel_obst]                              # (B,V,O,K,2)
        d_o = dsafe_obst[:, :, :, None]                       # (B, V, O, 1)
    else:
        b, v, o, _ = sel_obst.shape
        bi = torch.arange(b, device=sel_obst.device)[:, None, None, None]
        vi = torch.arange(v, device=sel_obst.device)[None, :, None, None]
        oi = torch.arange(o, device=sel_obst.device)[None, None, :, None]
        nvec_o = obst_normals.to(dtype)[bi, oi, sel_obst]
        d_o = obst_dists.to(dtype)[bi, vi, oi, sel_obst]
    gob = -torch.einsum("bvoky,bvkyu->bvoku", nvec_o, sys.b3)
    rel_c = sys.const3[:, :, None] - sys.obst_pos[:, None]
    h_obst = torch.einsum("bvoky,bvoky->bvok", nvec_o, rel_c) - d_o
    return gi, gj, gob, h_pair, h_obst


def _rows_from_selection(sys: con.ConstraintSystem, sel_pair, sel_obst,
                         dsafe_pair, dsafe_obst, obst_normals=None,
                         obst_dists=None):
    """Dense ``(G (B, C, n), h (B, C))`` rows of an explicit side assignment
    (a scatter of :func:`_slabs_from_selection`)."""
    b, v = sys.b3.shape[:2]
    gi, gj, gob, h_pair, h_obst = _slabs_from_selection(
        sys, sel_pair, sel_obst, dsafe_pair, dsafe_obst, obst_normals,
        obst_dists)
    G = con.scatter_slabs(v, gi, gj, gob, dtype=sys.b3.dtype)
    h = torch.cat([h_pair.reshape(b, -1), h_obst.reshape(b, -1)], dim=1)
    return G, h


def _select_from_trajectory(sys: con.ConstraintSystem, u_ref: torch.Tensor,
                            obst_normals=None, obst_dists=None,
                            obst_sides=None, consistent_lateral=False,
                            u_max=None, lat_commit=None):
    """Heuristic side assignment ``(sel_pair (B, P, K), sel_obst (B, V, O,
    K))`` from the geometry at ``u_ref (B, V*hu)``.

    Side score of obstacle face s: ``n_s·delta - d_s`` (the signed margin
    of the face). ``obst_sides``: the subset of side indices the obstacle
    selection may use (e.g. (0, 1) = longitudinal faces only).

    ``consistent_lateral``: commit each (vehicle, obstacle) to ONE lateral
    face for the whole horizon — the side maximizing the worst-case margin
    over the steps (``"flip"``: the other side for obstacles whose per-step
    lateral preference is not constant). ``lat_commit``: per step choose
    among behind, ahead and that ONE committed lateral side (the other
    lateral side excluded).

    ``u_max (B, V)``: a face violated at ``u_ref`` is selectable only if
    the margin the controls can recover, ``||n_s · B_k||_1 * u_max``,
    covers the deficit, and faces are ranked by margin + 0.3 x that
    recoverable margin. Without ``u_max`` an unsatisfied longitudinal face
    is not selectable.
    """
    pos = con.positions(sys, u_ref)                           # (B, V, K, 2)
    iu, ju = sys.pair_i[0], sys.pair_j[0]
    sel_pair = select_sides(pos[:, iu] - pos[:, ju])            # (B, P, K)
    d_obst = pos[:, :, None] - sys.obst_pos[:, None]          # (B,V,O,K,2)
    lead = d_obst.shape[:-1]
    if obst_normals is None:
        normals = torch.as_tensor(_SIDES, dtype=d_obst.dtype,
                                  device=d_obst.device).expand(lead + (4, 2))
        dists = torch.sqrt(sys.dsafe2_obst)[:, :, :, None, None].expand(
            lead + (4,))
    else:
        normals = obst_normals[:, None, :, None].expand(lead + (4, 2))
        dists = obst_dists[:, :, :, None].expand(lead + (4,))
    score = torch.einsum("bvoksy,bvoky->bvoks", normals, d_obst) - dists
    neg_inf = torch.tensor(float("-inf"), dtype=score.dtype,
                           device=score.device)

    def committed_side(mode):
        """ONE lateral face per (vehicle, obstacle): the side maximizing the
        worst-case margin over the steps (``"flip"``: the other side where
        the per-step lateral preference is not constant)."""
        worst = score[..., 2:4].amin(dim=3)                   # (B, V, O, 2)
        pick = 2 + _arg_first(worst, -1)                      # (B, V, O)
        if mode == "flip":
            per_step = _arg_first(score[..., 2:4], -1)        # (B, V, O, K)
            crossing = (per_step != per_step[..., :1]).any(dim=-1)
            pick = torch.where(crossing, 5 - pick, pick)
        return pick

    if consistent_lateral:
        pick = committed_side(consistent_lateral)
        return sel_pair, pick[..., None].expand(lead)
    side_ids = torch.arange(4, device=score.device)
    if lat_commit is not None:
        other = 5 - committed_side(lat_commit)                # excluded
        excl = side_ids == other[..., None, None]
        score = torch.where(excl, neg_inf, score)
    if u_max is not None:
        # reachability: the margin the controls can recover, per face row
        grad = torch.einsum("bvoksy,bvkyu->bvoksu", normals, sys.b3)
        cap = grad.abs().sum(dim=-1) * u_max[:, :, None, None, None]
        score = torch.where(score + cap < 0, neg_inf, score + 0.3 * cap)
    else:
        lon = side_ids < 2
        score = torch.where(lon & (score < 0), neg_inf, score)
    if obst_sides is not None:
        allowed = torch.zeros(4, dtype=torch.bool, device=score.device)
        allowed[list(obst_sides)] = True
        score = torch.where(allowed, score, neg_inf)
    return sel_pair, _arg_first(score, -1)


def rectangle_obstacle_geometry(obstacles: torch.Tensor,   # (B, O, 6)
                                veh_speeds: torch.Tensor,  # (B, V)
                                veh_length: torch.Tensor,  # (B, V)
                                veh_width: torch.Tensor,   # (B, V)
                                dt: float):
    """Rotated-rectangle obstacle faces of the big-M MIQP (obstAsQCQP=0):
    face distances are the obstacle half dimensions augmented by the
    vehicle half-diagonal and a sampling-chord term ``l_cord = (v_veh +
    v_obst) * dt`` (cos(pi/4)/2 of it per face, floored at l_cord/2); face
    normals are the obstacle's rotated axes (+-(c, s), +-(-s, c)).

    Returns ``(normals (B, O, 4, 2), dists (B, V, O, 4))`` ordered as
    ``_SIDES`` (+x', -x', +y', -y' in the obstacle frame)."""
    heading = obstacles[..., 2]
    c, s = torch.cos(heading), torch.sin(heading)
    normals = torch.stack([
        torch.stack([c, s], -1), torch.stack([-c, -s], -1),
        torch.stack([-s, c], -1), torch.stack([s, -c], -1)], dim=2)

    r_veh = 0.5 * torch.hypot(veh_length, veh_width)          # (B, V)
    half_l = 0.5 * obstacles[..., 4]
    half_w = 0.5 * obstacles[..., 5]
    l_cord = (veh_speeds[:, :, None] + obstacles[:, None, :, 3]) * dt
    pad = l_cord * (math.cos(math.pi / 4) / 2)
    l = torch.maximum(half_l[:, None] + r_veh[:, :, None] + pad, l_cord / 2)
    w = torch.maximum(half_w[:, None] + r_veh[:, :, None] + pad, l_cord / 2)
    return normals, torch.stack([l, l, w, w], dim=-1)


def _first_differences(hu: int, dtype, device) -> torch.Tensor:
    """``D (hu, hu)`` with ``(D u)_k = u_k - u_{k-1}`` (u_{-1} left out)."""
    return (torch.eye(hu, dtype=dtype, device=device)
            - torch.diag(torch.ones(hu - 1, dtype=dtype, device=device), -1))


def rate_cost_matrices(r_weight: torch.Tensor, u0: torch.Tensor, hu: int,
                       dtype):
    """Steering-rate cost ``R sum_k (u_k - u_{k-1})^2`` with u_{-1} = u0.

    ``r_weight`` / ``u0``: (B, V). Returns per-vehicle ``(phi (B, V, hu,
    hu), psi (B, V, hu))``."""
    D = _first_differences(hu, dtype, r_weight.device)
    phi = r_weight[:, :, None, None] * (D.T @ D)
    psi = torch.zeros(r_weight.shape + (hu,), dtype=dtype,
                      device=r_weight.device)
    psi[:, :, 0] = -2.0 * r_weight * u0
    return phi, psi


def _assemble_qp(sys: con.ConstraintSystem, ref_points, q_weight, q_final,
                 r_weight, u0, u_max, *, du_lim, slack_weight, slack_ub,
                 dtype):
    """Selection-independent parts of the side-selection QP (x = [u;
    slack]): ``(q (B, n+1), lb, ub, G_rate (2n, n+1), h_rate (B, 2n), phi
    (B, V, hu, hu))``. P is stated by its blocks, ``P = blockdiag(2 phi)``
    plus a zero slack tail (:func:`_dense_p` builds it where a dense P is
    read). The rate rows ``|u_k - u_{k-1}| <= du_lim`` (the first anchored
    at u0) are hard: their slack coefficient is 0, and ``G_rate`` is the
    same for every instance."""
    b, v, hp, _, hu = sys.b3.shape
    n = v * hu
    device = sys.b3.device

    # tracking + rate objective in condensed space
    q_diag = q_weight[:, :, None].expand(b, v, hp).to(dtype).clone()
    q_diag[:, :, -1] = q_final
    b3 = sys.b3
    err = ref_points.to(dtype) - sys.const3                   # (B, V, K, NY)
    bq = b3 * q_diag[:, :, :, None, None]
    phi_track = torch.einsum("bvkyu,bvkyw->bvuw", bq, b3)
    psi_track = -2.0 * torch.einsum("bvkyu,bvky->bvu", bq, err)
    phi_rate, psi_rate = rate_cost_matrices(r_weight.to(dtype),
                                            u0.to(dtype), hu, dtype)
    phi = phi_track + phi_rate
    psi = psi_track + psi_rate

    def col(val):
        return torch.full((b, 1), val, dtype=dtype, device=device)

    q_qp = torch.cat([psi.reshape(b, n), col(slack_weight)], dim=1)
    u_box = u_max[:, :, None].expand(b, v, hu).reshape(b, n).to(dtype)
    lb = torch.cat([-u_box, col(0.0)], dim=1)
    ub = torch.cat([u_box, col(slack_ub)], dim=1)

    D_full = torch.block_diag(*([_first_differences(hu, dtype, device)] * v))
    rate_rhs0 = torch.zeros((b, n), dtype=dtype, device=device)
    rate_rhs0[:, ::hu] = u0.to(dtype)
    G_rate = torch.cat([torch.cat([D_full, -D_full]),
                        torch.zeros((2 * n, 1), dtype=dtype, device=device)],
                       dim=1)
    h_rate = torch.cat([du_lim + rate_rhs0, du_lim - rate_rhs0], dim=1)
    return q_qp, lb, ub, G_rate, h_rate, phi


def _dense_p(phi: torch.Tensor) -> torch.Tensor:
    """The dense ``P (B, n+1, n+1)`` of :func:`_assemble_qp`'s blocks."""
    b, v, hu, _ = phi.shape
    n = v * hu
    P = torch.zeros((b, n + 1, n + 1), dtype=phi.dtype, device=phi.device)
    for i in range(v):
        P[:, i * hu:(i + 1) * hu, i * hu:(i + 1) * hu] = 2.0 * phi[:, i]
    return P


def _rows_with_slack(G_sep, G_rate, bsz):
    """``[G_sep | -1]`` over ``[G_rate]``: the dense rows with their slack
    column (-1 on the separation rows, 0 on the hard rate rows)."""
    slack_col = -torch.ones(G_sep.shape[:2] + (1,), dtype=G_sep.dtype,
                            device=G_sep.device)
    return torch.cat([torch.cat([G_sep, slack_col], dim=2),
                      G_rate.expand((bsz,) + G_rate.shape)], dim=1)


def solve_fixed_sides(sys: con.ConstraintSystem, ref_points, q_weight,
                      q_final, r_weight, u0, u_max,
                      sel_pair: torch.Tensor, sel_obst: torch.Tensor, *,
                      du_lim: float,
                      slack_weight: float = 1e5, slack_ub: float = 1e8,
                      obst_normals=None, obst_dists=None,
                      dsafe_pair=None, dsafe_obst=None,
                      qp_max_iter: int = 30, qp_tol: float = 1e-8):
    """Solve the convex QP of ONE explicit side assignment per instance
    (the subproblem a branch-and-bound MIQP solves at an integer leaf;
    enumerating every assignment gives the exact integer optimum of a tiny
    instance). Returns ``(u (B, n), obj, slack, converged)``."""
    b, v, _, _, hu = sys.b3.shape
    n = v * hu
    dtype = sys.b3.dtype
    q_qp, lb, ub, G_rate, h_rate, phi = _assemble_qp(
        sys, ref_points, q_weight, q_final, r_weight, u0, u_max,
        du_lim=du_lim, slack_weight=slack_weight, slack_ub=slack_ub,
        dtype=dtype)
    if dsafe_pair is None:
        dsafe_pair = torch.sqrt(sys.dsafe2_pair)
    if dsafe_obst is None:
        dsafe_obst = torch.sqrt(sys.dsafe2_obst)
    G_sep, h_sep = _rows_from_selection(sys, sel_pair, sel_obst, dsafe_pair,
                                        dsafe_obst, obst_normals, obst_dists)
    sol = qp.solve_qp(_dense_p(phi), q_qp, _rows_with_slack(G_sep, G_rate, b),
                      torch.cat([h_sep, h_rate], dim=1), lb, ub,
                      max_iter=qp_max_iter, tol=qp_tol)
    return sol.x[:, :n], sol.obj, sol.x[:, n], sol.converged


def solve_side_selection(sys: con.ConstraintSystem, ref_points, q_weight,
                         q_final, r_weight, u0, u_max, u_init, **kw
                         ) -> SideSelectionResult:
    """ONE scenario instance, unbatched (``ref_points (V, Hp, 2)``, ``u0``
    ``(V,)``, ``u_init (V*Hu,)``, ``sys`` without a batch axis, and
    ``obst_normals`` / ``obst_dists`` / ``dsafe_pair`` / ``dsafe_obst``
    among ``kw`` likewise): the B = 1 view of
    :func:`solve_side_selection_stacked`, which takes the same keywords.
    Returns unbatched fields."""
    def up(x):
        return None if x is None else tree_map(lambda a: a[None], x)

    for k in ("obst_normals", "obst_dists", "dsafe_pair", "dsafe_obst"):
        kw[k] = up(kw.get(k))
    res = solve_side_selection_stacked(
        up(sys), up(ref_points), up(q_weight), up(q_final), up(r_weight),
        up(u0), up(u_max), up(u_init), **kw)
    return SideSelectionResult(*[t[0] for t in res])


@timing.spanned("ss.select", lambda sys, *a, **k: {"width": sys.b3.shape[0]})
def solve_side_selection_stacked(
        sys: con.ConstraintSystem,      # leading axis B on every field
        ref_points: torch.Tensor,       # (B, V, Hp, 2)
        q_weight, q_final, r_weight,    # (B, V) each
        u0: torch.Tensor,               # (B, V) previous commands
        u_max: torch.Tensor,            # (B, V) box bounds
        u_init: torch.Tensor,           # (B, V*Hu) side-selection seed
        *,
        du_lim: float,
        slack_weight: float = 1e5,
        slack_ub: float = 1e8,
        constraint_tolerance: float = 2 * 2.1e-3,
        n_rounds: int = 2,
        multi_candidate: bool = True,
        obst_normals=None, obst_dists=None,   # (B, O, 4, 2) / (B, V, O, 4)
        dsafe_pair=None, dsafe_obst=None,     # (B, P) / (B, V, O)
        qp_max_iter: int = 30,
        qp_tol: float = 1e-8,
        qp_fixed_iters: int | None = None,
        qp_candidate_iters: int | None = None,
        qp_correctors: int = 0) -> SideSelectionResult:
    """Solve the side-selection convex program for a batch of instances.

    First round: five candidate side assignments per instance (committed
    lateral side, its flip, longitudinal faces only, and the two
    horizon-consistent lateral sides), solved as ONE ``5B``-wide
    :func:`qp.solve_qp_batched` call (candidate-major) at
    ``qp_candidate_iters``; each instance keeps its best-ranked candidate
    (hard solutions by objective, ahead of soft ones by slack). Then ``n_rounds - 1`` reselection rounds at
    ``qp_fixed_iters``, the best incumbent over all rounds, and the
    fixed-point check on the slabs.

    The separation rows have the SCP's pair / obstacle slab layout, and the
    hard rate rows (slack coefficient 0, ``g_slack_mask``) are 2V
    single-block bidiagonal slabs of the same height when hp == hu — so a
    fixed-count solve with at least one pair takes the structured kernel
    (K1, ``lower_tri``) and reads only the slabs: the dense rows are then
    never scattered. Without a pair (one vehicle) a fixed-count solve takes
    the dense-G kernel (K2) and ``fixed_iters=None`` the adaptive branch;
    those read the dense rows, slack column included.

    ``obst_normals`` / ``obst_dists`` (from
    :func:`rectangle_obstacle_geometry`) switch obstacle avoidance to the
    rotated-rectangle mode (obstAsQCQP=0). ``dsafe_pair`` / ``dsafe_obst``:
    the separation distances of the half-plane rows (the MIQP's rows use
    the RAW safety distances; None takes the system's padded ones);
    selection and feasibility are evaluated at the same distances.
    ``qp_fixed_iters`` / ``qp_correctors``: the float32 calibration knobs
    (``config.TUNED_F32_SIDE_SELECTION``); None runs the adaptive IPM.

    Spans: ``ss.select`` (the call), ``ss.candidates`` (the first round),
    ``ss.round`` (each reselection round), ``ss.check`` (the fixed-point
    check), each with its ``width``.
    """
    b, v, hp, _, hu = sys.b3.shape
    n = v * hu
    dtype, device = u_init.dtype, u_init.device
    n_obst = sys.obst_pos.shape[1]
    n_pair = sys.dsafe2_pair.shape[1]
    q_qp, lb, ub, G_rate, h_rate, phi = _assemble_qp(
        sys, ref_points, q_weight, q_final, r_weight, u0, u_max,
        du_lim=du_lim, slack_weight=slack_weight, slack_ub=slack_ub,
        dtype=dtype)
    if dsafe_pair is None:
        dsafe_pair = torch.sqrt(sys.dsafe2_pair)
    if dsafe_obst is None:
        dsafe_obst = torch.sqrt(sys.dsafe2_obst)
    sys_sel = sys._replace(dsafe2_pair=dsafe_pair ** 2,
                           dsafe2_obst=dsafe_obst ** 2)
    rect = ({} if obst_normals is None
            else {"obst_normals": obst_normals, "obst_dists": obst_dists})

    # Row-structure statement for the fused QP: pair slabs, then vehicle-
    # major obstacle slabs, then the rate rows as 2V single-block slabs (+D
    # blocks, then -D blocks), all hp rows tall: only when hp == hu.
    g_struct = None
    if hp == hu:
        g_struct = (tuple(con._static_pairs(v)),
                    tuple([vv for vv in range(v) for _ in range(n_obst)]
                          + list(range(v)) * 2),
                    hp, hu, True)
    D_blk = _first_differences(hu, dtype, device)
    rate_slabs = torch.cat([D_blk.expand(v, hu, hu),
                            (-D_blk).expand(v, hu, hu)])      # (2V, hu, hu)
    # per-row slack coefficient magnitude: 1 on the separation rows, 0 on
    # the hard rate rows (qp's g_slack_mask contract)
    slack_mask = torch.cat([
        torch.ones((n_pair + v * n_obst) * hp, dtype=dtype, device=device),
        torch.zeros(2 * n, dtype=dtype, device=device)])

    def select(u_ref, **kw):
        return _select_from_trajectory(sys_sel, u_ref, u_max=u_max, **rect,
                                       **kw)

    def build_slabs(sel_pair, sel_obst):
        return _slabs_from_selection(sys, sel_pair, sel_obst, dsafe_pair,
                                     dsafe_obst, **rect)

    def build_rows(sel_pair, sel_obsts):
        """Rows of one obstacle assignment per entry of ``sel_obsts`` (and
        ``sel_pair`` for all), stacked candidate-major: ``(dense, h,
        slabs)`` with ``slabs = (gi, gj, gob_flat)`` — ``gob_flat (bsz,
        V*O + 2V, K, U)`` in ``g_struct``'s order — and ``dense()`` the
        dense rows, built only where the QP's route reads them."""
        parts = [build_slabs(sel_pair, so) for so in sel_obsts]
        gi, gj, gob5, h_pair, h_obst = (torch.cat(x) for x in zip(*parts))
        bsz = gi.shape[0]
        h = torch.cat([h_pair.reshape(bsz, -1), h_obst.reshape(bsz, -1),
                       h_rate.repeat(bsz // b, 1)], dim=1)
        slabs = None
        if hp == hu:
            slabs = (gi, gj, torch.cat([
                gob5.reshape(bsz, v * n_obst, hp, hu),
                rate_slabs.expand(bsz, 2 * v, hu, hu)], dim=1))

        def dense():
            G_sep = con.scatter_slabs(v, gi, gj, gob5, dtype=dtype)
            return _rows_with_slack(G_sep, G_rate, bsz)
        return dense, h, slabs

    def solve_batch(dense, h, u_ref, q_, lb_, ub_, phi_, fixed_iters=None,
                    slabs=None):
        fixed_iters = fixed_iters or qp_fixed_iters
        x0 = torch.cat([u_ref, torch.zeros((u_ref.shape[0], 1), dtype=dtype,
                                           device=device)], dim=1)
        stated = dict(fixed_iters=fixed_iters, p_blocks=2.0 * phi_,
                      slack_schur=True, g_struct=g_struct, g_slabs=slabs)
        # the fused kernels in whichever storage tier holds the shape (at
        # parallel-11, hp = 20, K1's device tier)
        route = qp._route(q_, h, None, banded=None, kkt="dense", **stated)
        # P stated by p_blocks (+ zero slack tail); the fixed-count solves
        # take the cheap certificate (an honest one costs two G passes and
        # only feeds `converged`)
        sol = qp.solve_qp_batched(
            None, q_, None if route == "struct" else dense(), h, lb_, ub_,
            max_iter=qp_max_iter, tol=qp_tol, x0=x0,
            correctors=qp_correctors, certificate=fixed_iters is None,
            g_slack_mask=None if slabs is None else slack_mask, **stated)
        ok = torch.isfinite(sol.x).all(dim=1)
        u_new = torch.where(ok[:, None], sol.x[:, :n], u_ref)
        return u_new, sol.obj, sol.x[:, n], sol.converged & ok, sol.iters

    big = torch.finfo(dtype).max

    def rank(obj, slack):
        # hard = slack within the QCQP tolerance: ranked by objective, ahead
        # of every soft solution (ranked by slack)
        return torch.where(slack < constraint_tolerance, obj,
                           big * 0.5 + slack)

    bi = torch.arange(b, device=device)
    if multi_candidate and n_obst > 0:
        with timing.span("ss.candidates", width=5 * b):
            sel_pair0, sel_a = select(u_init, lat_commit=True)
            _, sel_b = select(u_init, lat_commit="flip")
            _, sel_lon = select(u_init, obst_sides=(0, 1))
            _, sel_lat_c = _select_from_trajectory(
                sys_sel, u_init, consistent_lateral=True, **rect)
            _, sel_lat_f = _select_from_trajectory(
                sys_sel, u_init, consistent_lateral="flip", **rect)
            cand_obst = [sel_a, sel_b, sel_lon, sel_lat_c, sel_lat_f]
            n_cand = len(cand_obst)

            def tile(x):
                return x.repeat((n_cand,) + (1,) * (x.ndim - 1))

            # Candidate solves only need RANKING fidelity (the winner is
            # refined by the reselection rounds; an unconverged objective
            # overestimates, which is conservative for the incumbent), hence
            # their own iteration count.
            dense_c, h_c, slabs_c = build_rows(sel_pair0, cand_obst)
            u5, obj5, sl5, cv5, it5 = solve_batch(
                dense_c, h_c, tile(u_init), tile(q_qp), tile(lb), tile(ub),
                tile(phi), fixed_iters=qp_candidate_iters, slabs=slabs_c)
            pick = _arg_first(rank(obj5, sl5).reshape(n_cand, b), 0,
                              largest=False)
            u_0 = u5.reshape(n_cand, b, n)[pick, bi]
            obj0 = obj5.reshape(n_cand, b)[pick, bi]
            slack0 = sl5.reshape(n_cand, b)[pick, bi]
            conv0 = cv5.reshape(n_cand, b)[pick, bi]
            qp_its = it5.reshape(n_cand, b).sum(dim=0, dtype=torch.int32)
            sel0 = (sel_pair0, torch.stack(cand_obst)[pick, bi])
            n_reselect = n_rounds - 1
    else:
        u_0 = u_init
        obj0 = torch.full((b,), big, dtype=dtype, device=device)
        slack0 = torch.full((b,), big, dtype=dtype, device=device)
        conv0 = torch.zeros((b,), dtype=torch.bool, device=device)
        qp_its = torch.zeros((b,), dtype=torch.int32, device=device)
        sel0 = select(u_init, lat_commit=True)
        n_reselect = n_rounds

    rounds = [(u_0, obj0, slack0, conv0) + tuple(sel0)]
    u_ref = u_0
    for _ in range(n_reselect):
        with timing.span("ss.round", width=b):
            sel_pair_r, sel_obst_r = select(u_ref, lat_commit=True)
            dense_r, h_r, slabs_r = build_rows(sel_pair_r, [sel_obst_r])
            u_ref, obj_r, slack_r, conv_r, iters = solve_batch(
                dense_r, h_r, u_ref, q_qp, lb, ub, phi, slabs=slabs_r)
            qp_its = qp_its + iters
            rounds.append((u_ref, obj_r, slack_r, conv_r, sel_pair_r,
                           sel_obst_r))
    if n_reselect > 0:
        # best incumbent across the initial pick and every reselection round
        # (branch-and-bound keeps its incumbent)
        all_u, all_obj, all_slack, all_conv, all_selp, all_selo = (
            torch.stack(x) for x in zip(*rounds))
        best = _arg_first(rank(all_obj, all_slack), 0, largest=False)
        u, obj = all_u[best, bi], all_obj[best, bi]
        slack, conv = all_slack[best, bi], all_conv[best, bi]
        sel_last = (all_selp[best, bi], all_selo[best, bi])
    else:
        u, obj, slack, conv = u_0, obj0, slack0, conv0
        sel_last = sel0

    with timing.span("ss.check", width=b):
        # fixed-point check: the kept assignment equals the one its
        # solution induces, or the solution already satisfies every induced
        # row (evaluated on the slabs: the dense scatter is never built)
        sel_pair_f, sel_obst_f = select(u, lat_commit=True)
        identical = ((sel_last[0] == sel_pair_f).flatten(1).all(dim=1)
                     & (sel_last[1] == sel_obst_f).flatten(1).all(dim=1))
        gi_f, gj_f, gob_f, hp_f, ho_f = build_slabs(sel_pair_f,
                                                     sel_obst_f)
        uv = u.reshape(b, v, hu)
        iu, ju = sys.pair_i[0], sys.pair_j[0]
        res_p = (torch.einsum("bpku,bpu->bpk", gi_f, uv[:, iu])
                 + torch.einsum("bpku,bpu->bpk", gj_f, uv[:, ju])) - hp_f
        res_o = torch.einsum("bvoku,bvu->bvok", gob_f, uv) - ho_f
        induced_ok = torch.maximum(con._max_or_neg_inf(res_p),
                                   con._max_or_neg_inf(res_o)) \
            <= constraint_tolerance
        ev = con.evaluate(sys_sel, u, constraint_tolerance,
                          compat_q5=False)
    return SideSelectionResult(
        u=u, obj=obj, slack=slack, feasible=ev.feasible, converged=conv,
        rounds=torch.full((b,), n_rounds, dtype=torch.int32, device=device),
        sides_stable=identical | induced_ok, qp_iters=qp_its)
