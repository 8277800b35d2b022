"""Frozen copy of the stacked SCP loop of ``solvers/scp.py`` of the
PyTorch port (``solve_scp_stacked``, ``solve_scp_batch``, ``forward_u``),
for the benchmark's plain reference; imports nothing of the port. The
port's sharded, traced and banded options are left out: the
benchmark's configurations use none of them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference import constraints as con
from reference import qp
from reference.config import tree_map


class SCPProblem(NamedTuple):
    """A batch of scenario instances' SCP data (leading batch axis B)."""
    sys: con.ConstraintSystem
    phi0: torch.Tensor    # (B, V, hu, hu) per-vehicle cost blocks
    psi0: torch.Tensor    # (B, V, hu)
    gamma0: torch.Tensor  # (B, V)
    # Optional stage data for the banded (Riccati) KKT path (qp.BandedData
    # minus the per-iterate row coefficients): (a_blk (B, V, NX, NX),
    # b_blk (B, V, NX), qy (B, V, hp) = 2q / 2q_final, ru (B, V) = 2r)
    banded_pre: tuple | None = None


class SCPResult(NamedTuple):
    u: torch.Tensor              # (B, n) final stacked controls
    feasible: torch.Tensor       # (B,) bool — exact constraints within tolerance
    converged: torch.Tensor      # (B,) bool — merit stop before the cap
    obj: torch.Tensor            # (B,) tracking objective at u
    max_violation: torch.Tensor  # (B,)
    iters: torch.Tensor          # (B,) SCP iterations used
    qp_iters: torch.Tensor       # (B,) total inner-QP iterations
    qp_fails: torch.Tensor       # (B,) inner QPs that did not reach tolerance


def _scp_loop(problem: SCPProblem, u_init: torch.Tensor, qp_solve, *,
              max_scp_iter, delta_tol, delta_tol_rel, u_step_tol,
              merit_patience, keep_best, slack_weight, constraint_tolerance,
              qp_warm_dual, compat_q5):
    """The port's SCP iteration (``solvers/scp.py::_scp_loop``) without its
    sharded-mode reductions and per-iteration records: ``qp_solve(u, x0,
    z0) -> QPSolution`` solves the QP linearized at ``u``; converged
    instances freeze."""
    sys = problem.sys
    dtype, device = u_init.dtype, u_init.device
    b, v, hp, _, hu = sys.b3.shape
    n = v * hu
    n_con = sys.dsafe2_pair.shape[1] * hp + v * sys.obst_pos.shape[1] * hp
    single_veh = v == 1

    def ev_fn(u):
        return con.evaluate(sys, u, constraint_tolerance, compat_q5)

    def obj_fn(u):
        return con.objective(problem.phi0, problem.psi0, problem.gamma0, u)

    ev0 = ev_fn(u_init)
    obj_init = obj_fn(u_init)

    m_qp = n_con + 2 * (n + 1)
    zero = torch.zeros((b,), dtype=torch.int32, device=device)
    u, obj, viol, feasible = u_init, obj_init, ev0.max_violation, ev0.feasible
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    it, qp_iters, qp_fails, stall = zero, zero, zero, zero
    best_merit = obj_init + slack_weight * ev0.max_violation
    z = torch.zeros((b, m_qp), dtype=dtype, device=device)
    best = (u, obj, viol, feasible) if keep_best else None

    # Every still-active instance has run the same number of iterations, so
    # the loop condition any((it < max) & ~done) is any(~done) for max_scp_iter
    # rounds at most.
    for _ in range(max_scp_iter):
        if not bool((~done).any()):
            break
        sel = ~done
        x0 = torch.cat([u, torch.zeros((b, 1), dtype=dtype, device=device)],
                       dim=1)
        sol = qp_solve(u, x0, z if qp_warm_dual else None)
        # NaN guard: a diverged inner solve must not poison the iterate
        ok = torch.isfinite(sol.x).all(dim=1)
        u_new = torch.where(ok[:, None], sol.x[:, :n], u)
        ev = ev_fn(u_new)
        obj_new = obj_fn(u_new)
        merit_prev = obj + slack_weight * viol
        merit_new = obj_new + slack_weight * ev.max_violation
        delta = merit_prev - merit_new
        thresh = delta_tol + delta_tol_rel * merit_new.abs()
        small_delta = (delta.abs() < thresh) | ~ok
        if u_step_tol > 0:
            small_step = (u_new - u).abs().amax(dim=1) < u_step_tol
            small_delta = small_delta | small_step
        if merit_patience > 0:
            improved = (best_merit - merit_new) >= thresh
            stall_new = torch.where(improved, torch.zeros_like(stall),
                                    stall + 1)
            small_delta = small_delta | (stall_new >= merit_patience)
        else:
            stall_new = stall
        best_merit_new = torch.minimum(best_merit, merit_new)
        selc = sel[:, None]
        if keep_best:
            better = sel & (merit_new < best_merit)
            cand = (u_new, obj_new, ev.max_violation, ev.feasible)
            best = tuple(
                torch.where(better[:, None] if new_v.ndim == 2 else better,
                            new_v, old_v)
                for new_v, old_v in zip(cand, best))
        if single_veh:
            stop = small_delta
        else:
            stop = small_delta & (ev.max_violation <= constraint_tolerance)
        # freeze inactive instances
        u = torch.where(selc, u_new, u)
        obj = torch.where(sel, obj_new, obj)
        viol = torch.where(sel, ev.max_violation, viol)
        feasible = torch.where(sel, ev.feasible, feasible)
        done = torch.where(sel, stop, done)
        it = it + sel.to(torch.int32)
        qp_iters = qp_iters + torch.where(sel, sol.iters, zero)
        qp_fails = qp_fails + (sel & ~sol.converged).to(torch.int32)
        best_merit = torch.where(sel, best_merit_new, best_merit)
        stall = torch.where(sel, stall_new, stall)
        z = torch.where(selc, sol.z, z)

    if keep_best:
        u, obj, viol, feasible = best
    res = SCPResult(u=u, feasible=feasible, converged=done, obj=obj,
                    max_violation=viol, iters=it, qp_iters=qp_iters,
                    qp_fails=qp_fails)
    return res


def _check_kkt(problem: SCPProblem, qp_kkt: str) -> None:
    if qp_kkt not in ("dense", "banded", "auto"):
        raise ValueError(f"unknown qp_kkt {qp_kkt!r}")
    if qp_kkt == "banded" and problem.banded_pre is None:
        raise ValueError(
            "qp_kkt='banded' needs problem.banded_pre (engine.controller_pre "
            "builds it when cfg.qp_kkt != 'dense')")


def _nudged(u_init: torch.Tensor) -> torch.Tensor:
    """Numerical nudge of u[0]: exactly-zero first controls become eps (on
    a copy). eps is the stated precision's (``qp.PRECISION``), in whatever
    dtype the reference computes."""
    eps = torch.finfo(qp.PRECISION).eps
    u_init = u_init.clone()
    u_init[:, 0] = torch.where(u_init[:, 0].abs() < eps,
                               torch.full_like(u_init[:, 0], eps),
                               u_init[:, 0])
    return u_init


def _qp_vectors(problem: SCPProblem, u_lim, slack_weight, slack_ub, dtype,
                device):
    """``(q, lb, ub)`` of the SCP's QP: tracking gradient + slack weight,
    steering box + slack bounds."""
    b, v, hu = problem.psi0.shape
    n = v * hu

    def full(cols, value):
        return torch.full((b, cols), value, dtype=dtype, device=device)

    q_qp = torch.cat([problem.psi0.reshape(b, n), full(1, slack_weight)], 1)
    lb = torch.cat([full(n, -u_lim), full(1, 0.0)], dim=1)
    ub = torch.cat([full(n, u_lim), full(1, slack_ub)], dim=1)
    return q_qp, lb, ub


def solve_scp_stacked(problem: SCPProblem, u_init: torch.Tensor, *,
                      u_lim: float,
                      max_scp_iter: int = 20,
                      delta_tol: float = 1e-3,
                      delta_tol_rel: float = 0.0,
                      u_step_tol: float = 0.0,
                      merit_patience: int = 0,
                      keep_best: bool = False,
                      slack_weight: float = 1e5,
                      slack_ub: float = 1e8,
                      constraint_tolerance: float = 2 * 2.1 * 1e-3,
                      qp_max_iter: int = 30,
                      qp_tol: float = 1e-8,
                      qp_fixed_iters: int | None = None,
                      qp_cheap_k: bool = False,
                      qp_warm_dual: bool = False,
                      qp_correctors: int = 0,
                      qp_kkt: str = "dense",
                      qp_certificate: bool = False,
                      compat_q5: bool = True) -> SCPResult:
    """Batched SCP solve (leading batch axis) through
    :func:`qp.solve_qp_batched`, which picks its branch from ``qp_kkt`` and
    the shape: with ``qp_fixed_iters`` the structured fused kernel on the
    pair-sparse row slabs, or — with no vehicle pair (one vehicle) — the
    dense-G fused kernel; with ``qp_fixed_iters=None`` the adaptive branch
    on the dense rows scattered from the same slabs. ``qp_kkt="banded"``,
    or ``"auto"`` past the kernels' shared-memory gates, factors by the
    Riccati sweeps from ``problem.banded_pre``.
    """
    if qp_cheap_k:
        raise NotImplementedError(
            "qp_cheap_k (reduced-precision KKT formation) is not supported "
            "by the stacked/fused QP path")
    _check_kkt(problem, qp_kkt)
    sys = problem.sys
    dtype, device = u_init.dtype, u_init.device
    b, v, hp, _, hu = sys.b3.shape
    n_obst = sys.obst_pos.shape[1]
    n_con = sys.dsafe2_pair.shape[1] * hp + v * n_obst * hp
    u_init = _nudged(u_init)

    p_blocks = 2.0 * problem.phi0
    q_qp, lb, ub = _qp_vectors(problem, u_lim, slack_weight, slack_ub, dtype,
                               device)
    slack_col = torch.full((b, n_con, 1), -1.0, dtype=dtype, device=device)

    # Static pair structure of the constraint rows (pair-major then
    # (vehicle, obstacle) blocks, hp rows each, hu-wide vehicle column
    # blocks, slack column last). 5th element: the condensed prediction
    # matrix is block-lower-triangular, so slab row k touches only controls
    # u <= k and the kernel may skip the zero entries.
    g_struct = (tuple(con._static_pairs(v)),
                tuple(vv for vv in range(v) for _ in range(n_obst)),
                hp, hu, True)

    use_banded = (qp_kkt in ("banded", "auto")
                  and problem.banded_pre is not None)
    # the dense rows are read by the adaptive branch and wherever the
    # pair-sparse statement cannot engage (no pair: one vehicle); the
    # structured kernel and the banded branch work from the slabs alone
    dense_rows = not g_struct[0] or (qp_fixed_iters is None
                                     and qp_kkt != "banded")

    def qp_solve(u, x0, z0):
        gi_b, gj_b, gob_b, rhs = con.linearize_slabs(sys, u)
        G = torch.cat([con.scatter_slabs(v, gi_b, gj_b, gob_b, dtype),
                       slack_col], 2) if dense_rows else None
        return qp.solve_qp_batched(
            None, q_qp, G, rhs, lb, ub,
            max_iter=qp_max_iter, tol=qp_tol, x0=x0, z0=z0,
            fixed_iters=qp_fixed_iters, p_blocks=p_blocks,
            correctors=qp_correctors, slack_schur=True,
            certificate=qp_certificate, g_struct=g_struct,
            g_slabs=(gi_b, gj_b, gob_b),
            banded=None,
            kkt=qp_kkt)

    return _scp_loop(
        problem, u_init, qp_solve, max_scp_iter=max_scp_iter,
        delta_tol=delta_tol, delta_tol_rel=delta_tol_rel,
        u_step_tol=u_step_tol, merit_patience=merit_patience,
        keep_best=keep_best, slack_weight=slack_weight,
        constraint_tolerance=constraint_tolerance, qp_warm_dual=qp_warm_dual,
        compat_q5=compat_q5)


def solve_scp_batch(problems: SCPProblem, u_init: torch.Tensor, *,
                    u_lim: float, phases: tuple[tuple[int, int], ...],
                    **kw) -> SCPResult:
    """The port's ``solve_scp_batch``: multi-phase SCP with straggler
    repacking, on the whole batch. Stage k runs up to ``iters`` further
    SCP iterations on a ``1/frac``-width sub-batch into which the
    still-unconverged instances are gathered in batch order (stable
    argsort); stragglers beyond a stage's capacity keep their prior-stage
    result. Which instances get a later phase depends on every instance's
    convergence, so the reference runs the whole batch of the step and
    decides that from its own results."""
    b = u_init.shape[0]
    if phases[0][1] != 1:
        raise ValueError("first phase must cover the full batch")

    def run(p, u, iters, qp_it=None):
        kw2 = kw if qp_it is None else {**kw, "qp_fixed_iters": qp_it}
        return solve_scp_stacked(p, u, u_lim=u_lim, max_scp_iter=iters,
                                 **kw2)

    res = run(problems, u_init, phases[0][0], *phases[0][2:])
    for iters_k, frac_k, *qp_over in phases[1:]:
        m = max(b // frac_k, 1)
        order = torch.argsort(res.converged.to(torch.int8), stable=True)
        idx = order[:m]
        sub_problems = tree_map(lambda x: x[idx], problems)
        res_k = run(sub_problems, res.u[idx], iters_k, *qp_over)
        take = ~res.converged[idx]
        res_k = res_k._replace(
            iters=res_k.iters + res.iters[idx],
            qp_iters=res_k.qp_iters + res.qp_iters[idx],
            qp_fails=res_k.qp_fails + res.qp_fails[idx])

        def merge(a, b_k):
            sel = take.reshape((-1,) + (1,) * (b_k.ndim - 1))
            out = a.clone()
            out[idx] = torch.where(sel, b_k, a[idx])
            return out

        res = SCPResult(*[merge(a, b_k) for a, b_k in zip(res, res_k)])
    return res


def forward_u(sys: con.ConstraintSystem, u: torch.Tensor):
    """Predicted trajectory and per-vehicle controls. Returns
    (traj (B, hp, NY, V), U (B, hp, V))."""
    b, v, hp, _, hu = sys.b3.shape
    pos = con.positions(sys, u)          # (B, V, hp, NY)
    traj = pos.permute(0, 2, 3, 1)
    U = u.reshape(b, v, hu).transpose(1, 2)
    return traj, U
