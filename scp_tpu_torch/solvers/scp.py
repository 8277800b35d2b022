"""SCP outer loop on batched tensors (counterpart of
``scp_tpu/solvers/scp.py``: ``solve_scp``, ``solve_scp_stacked``,
``solve_scp_batch``, ``forward_u``).

Each iteration linearizes the concave avoidance constraints at the current
iterate, appends one slack variable ω (weight 1e5) shared by all avoidance
rows, solves the convex QP, and stops when the exact-penalty merit
``objective + w * max_violation`` decreases by less than ``delta_tol`` while
the worst violation is inside tolerance.

Every function takes a leading batch axis: :func:`solve_scp` is
``vmap(solve_scp)`` of ``scp_tpu`` written out (dense constraint rows, dense
P, the general :func:`qp.solve_qp`), :func:`solve_scp_stacked` states the
same QPs pair-sparsely to :func:`qp.solve_qp_batched`. Both run ONE loop
(:func:`_scp_loop`) and differ in the QP they hand it. With a stage
statement (``SCPProblem.banded_pre``) either can hand the QP its banded
(Riccati) form. :func:`solve_scp_multistart` runs three starts of each
instance as one batch.

Where ``scp_tpu`` runs a ``lax.while_loop`` with per-lane freezing, this is
a Python loop whose condition is ONE host read of ``any(not done)`` per SCP
iteration — a device synchronisation each time, counted in
:data:`host_sync_count` (the adaptive IPM loops count theirs in
``qp.host_sync_count``) and marked by a ``sync`` span; each iteration that
solves a QP is an ``scp.iter`` span (``utils.timing``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from scp_tpu_torch.config import tree_map
from scp_tpu_torch.ops import constraints as con
from scp_tpu_torch.parallel import mesh as mesh_lib
from scp_tpu_torch.solvers import qp
from scp_tpu_torch.utils import timing

# Host reads of a device value (device synchronisations) made by the SCP
# loops since the last reset.
host_sync_count = 0


def reset_host_sync_count() -> None:
    global host_sync_count
    host_sync_count = 0


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


class SCPTrace(NamedTuple):
    """Per-SCP-iteration record (``solve_scp(trace=True)``). Every field is
    ``(B, max_scp_iter)``; entries of iterations an instance did not run are
    zero / False and flagged inactive."""
    active: torch.Tensor         # bool — the iteration actually ran
    obj: torch.Tensor            # QCQP objective after the iteration
    max_violation: torch.Tensor  # worst constraint violation
    merit: torch.Tensor          # exact-penalty merit obj + w * viol
    delta: torch.Tensor          # merit decrease vs the previous iterate
    qp_converged: torch.Tensor   # bool — inner QP certificate


def _scp_loop(problem: SCPProblem, u_init: torch.Tensor, qp_solve, *,
              max_scp_iter, delta_tol, delta_tol_rel, u_step_tol,
              merit_patience, keep_best, slack_weight, constraint_tolerance,
              qp_warm_dual, compat_q5, trace=False, group=None):
    """The SCP iteration shared by :func:`solve_scp` and
    :func:`solve_scp_stacked`. ``qp_solve(u, x0, z0) -> QPSolution`` solves
    the QP linearized at ``u`` (``x0 = [u, 0]``, ``z0`` the previous duals or
    None).

    Converged instances freeze (they keep ``u, obj, viol, z``; counters add
    only where an instance is still active) while the batch continues.

    ``group``: the model process group of the horizon-sharded mode, where
    ``problem.sys`` is this rank's horizon block: the violation is
    MAX-reduced and the feasibility AND-reduced over it after every
    evaluation (``scp_tpu``'s ``reduce_ev``), so the merit / stop logic sees
    the same values on every rank, and the stop flags are AND-reduced before
    the host read of ``any(not done)``.
    """
    global host_sync_count
    sys = problem.sys
    dtype, device = u_init.dtype, u_init.device
    b, v, hp, _, hu = sys.b3.shape
    n = v * hu
    n_con = sys.dsafe2_pair.shape[1] * hp + v * sys.obst_pos.shape[1] * hp
    single_veh = v == 1

    def ev_fn(u):
        ev = con.evaluate(sys, u, constraint_tolerance, compat_q5)
        if group is None:
            return ev
        return ev._replace(
            feasible=mesh_lib.all_true(ev.feasible, group),
            max_violation=mesh_lib.all_reduce(ev.max_violation, group,
                                              "max"))

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
    records = []

    # Every still-active instance has run the same number of iterations, so
    # the loop condition any((it < max) & ~done) is any(~done) for max_scp_iter
    # rounds at most.
    for _ in range(max_scp_iter):
        host_sync_count += 1
        with timing.span("sync", site="scp") as sp:
            if sp.on:
                # the same one read: the count of active instances in
                # place of any()
                active = int((~done).sum())
                sp.set(active=active)
            else:
                active = bool((~done).any())
        if not active:
            break
        with timing.span("scp.iter", width=b):
            sel = ~done
            x0 = torch.cat([u, torch.zeros((b, 1), dtype=dtype,
                                           device=device)], dim=1)
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
            stop = mesh_lib.all_true(stop, group)
            if trace:
                records.append((sel,) + tuple(
                    torch.where(sel, e, torch.zeros_like(e))
                    for e in (obj_new, ev.max_violation, merit_new, delta,
                              sol.converged)))

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
    if not trace:
        return res
    # iterations after the last instance stopped did not run: zero records
    kinds = (torch.bool, dtype, dtype, dtype, dtype, torch.bool)
    cols = []
    for f, kind in enumerate(kinds):
        col = torch.zeros((b, max_scp_iter), dtype=kind, device=device)
        for i, rec in enumerate(records):
            col[:, i] = rec[f]
        cols.append(col)
    return res, SCPTrace(*cols)


def _banded_data(problem: SCPProblem, u: torch.Tensor) -> qp.BandedData:
    """The stage statement of the QP linearized at ``u``."""
    a_blk, b_blk, qy, ru = problem.banded_pre
    y_pair, y_obst = con.linearize_ycoefs(problem.sys, u)
    return qp.BandedData(a_blk, b_blk, y_pair, y_obst, qy, ru)


def _check_kkt(problem: SCPProblem, qp_kkt: str) -> None:
    if qp_kkt not in ("dense", "banded", "auto"):
        raise ValueError(f"unknown qp_kkt {qp_kkt!r}")
    if qp_kkt == "banded" and problem.banded_pre is None:
        raise ValueError(
            "qp_kkt='banded' needs problem.banded_pre (engine.controller_pre "
            "builds it when cfg.qp_kkt != 'dense')")


def _nudged(u_init: torch.Tensor) -> torch.Tensor:
    """Numerical nudge of u[0]: exactly-zero first controls become eps (on
    a copy)."""
    eps = torch.finfo(u_init.dtype).eps
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


def solve_scp(problem: SCPProblem, u_init: torch.Tensor, *,
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
              compat_q5: bool = True,
              axis_name=None,
              n_con_total: int | None = None,
              trace: bool = False):
    """Per-instance SCP on a leading batch axis (``vmap(solve_scp)`` of
    ``scp_tpu``): dense linearized rows with their slack column, the dense
    block-diagonal P, and the general :func:`qp.solve_qp` (adaptive loop or
    ``qp_fixed_iters``, Gondzio correctors honoured, honest certificate).

    ``qp_kkt``: ``"dense"`` and ``"auto"`` take the dense factorization (per
    instance ``"auto"`` is dense, as in ``scp_tpu``); ``"banded"`` factors
    the same KKT system by the Riccati sweeps and needs
    ``problem.banded_pre``. ``trace=True`` additionally returns an
    :class:`SCPTrace`; the loop is the same Python loop, so the traced
    result equals the untraced one.

    ``axis_name``: the horizon-sharded mode. It holds the model-axis
    ProcessGroup (the name is ``scp_tpu``'s); ``problem.sys`` is this
    rank's horizon block (``parallel.horizon.shard_system``) and
    ``n_con_total`` the global avoidance-row count. Linearization,
    evaluation and the QP's rows run on the block; the QP is row-sharded
    (:func:`qp.solve_qp`'s ``axis_name``), and the violation / feasibility
    are reduced at the start and after every QP, so the loop runs in
    lockstep on every rank. The row-sharded QP forms the dense KKT, so
    there ``qp_kkt="banded"`` solves dense, as ``scp_tpu`` does (its
    ``use_banded`` requires ``axis_name is None``); ``"auto"`` is dense per
    instance anyway.
    """
    if axis_name is not None:
        if n_con_total is None:
            raise ValueError("axis_name requires n_con_total")
        if qp_kkt == "banded":
            qp_kkt = "dense"
    _check_kkt(problem, qp_kkt)
    sys = problem.sys
    dtype, device = u_init.dtype, u_init.device
    b, v, hp, _, hu = sys.b3.shape
    n = v * hu
    n_con = sys.dsafe2_pair.shape[1] * hp + v * sys.obst_pos.shape[1] * hp
    u_init = _nudged(u_init)

    # Fixed QP cost: blockdiag(2 * phi0) plus a zero slack row / column; the
    # slack enters linearly with weight ``slack_weight``.
    P_qp = torch.zeros((b, n + 1, n + 1), dtype=dtype, device=device)
    for i in range(v):
        P_qp[:, i * hu:(i + 1) * hu, i * hu:(i + 1) * hu] = \
            2.0 * problem.phi0[:, i]
    q_qp, lb, ub = _qp_vectors(problem, u_lim, slack_weight, slack_ub, dtype,
                               device)
    slack_col = torch.full((b, n_con, 1), -1.0, dtype=dtype, device=device)

    def qp_solve(u, x0, z0):
        G_c, rhs = con.linearize(sys, u)
        G = torch.cat([G_c, slack_col], dim=2)
        return qp.solve_qp(P_qp, q_qp, G, rhs, lb, ub, max_iter=qp_max_iter,
                           tol=qp_tol, x0=x0, z0=z0,
                           fixed_iters=qp_fixed_iters, cheap_k=qp_cheap_k,
                           correctors=qp_correctors, axis_name=axis_name,
                           mg_total=n_con_total if axis_name is not None
                           else None,
                           banded=(_banded_data(problem, u)
                                   if qp_kkt == "banded" else None))

    return _scp_loop(
        problem, u_init, qp_solve, max_scp_iter=max_scp_iter,
        delta_tol=delta_tol, delta_tol_rel=delta_tol_rel,
        u_step_tol=u_step_tol, merit_patience=merit_patience,
        keep_best=keep_best, slack_weight=slack_weight,
        constraint_tolerance=constraint_tolerance, qp_warm_dual=qp_warm_dual,
        compat_q5=compat_q5, trace=trace, group=axis_name)


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
            banded=_banded_data(problem, u) if use_banded else None,
            kkt=qp_kkt)

    return _scp_loop(
        problem, u_init, qp_solve, max_scp_iter=max_scp_iter,
        delta_tol=delta_tol, delta_tol_rel=delta_tol_rel,
        u_step_tol=u_step_tol, merit_patience=merit_patience,
        keep_best=keep_best, slack_weight=slack_weight,
        constraint_tolerance=constraint_tolerance, qp_warm_dual=qp_warm_dual,
        compat_q5=compat_q5)


def solve_scp_batch(problems: SCPProblem, u_init: torch.Tensor, *,
                    u_lim: float,
                    max_scp_iter: int = 20,
                    phase1_iters: int = 8,
                    straggler_frac: int = 4,
                    phases: tuple[tuple[int, int], ...] | None = None,
                    stacked: bool | None = None,
                    **kw) -> SCPResult:
    """Multi-phase batched SCP with straggler repacking.

    ``phases`` is a schedule of ``(iters, frac)`` stages: stage k runs up to
    ``iters`` further SCP iterations on a ``1/frac``-width sub-batch into
    which the still-unconverged stragglers are gathered (stable-argsort
    packed). Default: ``((phase1_iters, 1), (max_scp_iter - phase1_iters,
    straggler_frac))``. Stragglers beyond a stage's capacity keep their
    prior-stage result. A phase entry may carry an optional third element
    overriding ``qp_fixed_iters`` for that phase.

    ``stacked``: ``None`` / ``True`` run :func:`solve_scp_stacked` (the
    port's default on every device), ``False`` runs :func:`solve_scp` (the
    per-instance path on the same batch).

    Spans: ``scp.phase`` for each phase, with ``k`` (its index), ``width``
    (its sub-batch), ``iters`` (its cap), ``stragglers`` (the unconverged
    instances entering it) and ``lanes_useful`` (the iterations run by the
    lanes that carry a straggler).
    """
    b = u_init.shape[0]
    if phases is None:
        phases = ((phase1_iters, 1),
                  (max_scp_iter - phase1_iters, straggler_frac))
    if phases[0][1] != 1:
        raise ValueError("first phase must cover the full batch")

    def run(p, u, iters, qp_it=None):
        kw2 = kw if qp_it is None else {**kw, "qp_fixed_iters": qp_it}
        solver = solve_scp if stacked is False else solve_scp_stacked
        return solver(p, u, u_lim=u_lim, max_scp_iter=iters, **kw2)

    with timing.span("scp.phase", k=0, width=b, iters=phases[0][0],
                     stragglers=b) as sp:
        res = run(problems, u_init, phases[0][0], *phases[0][2:])
        if sp.on:
            sp.set(lanes_useful=res.iters.sum())

    for k, (iters_k, frac_k, *qp_over) in enumerate(phases[1:], 1):
        m = max(b // frac_k, 1)
        with timing.span("scp.phase", k=k, width=m, iters=iters_k) as sp:
            if sp.on:
                sp.set(stragglers=(~res.converged).sum())
            # pack unconverged to the front (False sorts before True). The
            # order decides which stragglers get capacity, so the sort must
            # be stable.
            order = torch.argsort(res.converged.to(torch.int8), stable=True)
            idx = order[:m]
            sub_problems = tree_map(lambda x: x[idx], problems)
            res_k = run(sub_problems, res.u[idx], iters_k, *qp_over)

            take = ~res.converged[idx]
            if sp.on:
                # the lanes that carry a straggler: the filler lanes'
                # iterations are thrown away
                sp.set(lanes_useful=(res_k.iters * take).sum())
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


def solve_scp_multistart(problem: SCPProblem, u_init: torch.Tensor, *,
                         u_lim: float, **kw) -> SCPResult:
    """Multi-start SCP: the warm start plus saturated-left / right restarts,
    solved together as one batch of 3B instances through :func:`solve_scp`
    (start-major); per instance the feasible result with the lowest
    objective wins, and the earlier start wins ties (a 1e-6 x start-index
    tie-break, then the first minimum)."""
    b, n = u_init.shape
    starts = torch.cat([
        u_init,
        torch.full((b, n), u_lim, dtype=u_init.dtype, device=u_init.device),
        torch.full((b, n), -u_lim, dtype=u_init.dtype,
                   device=u_init.device)])
    problems = tree_map(lambda x: torch.cat([x, x, x]), problem)
    res = solve_scp(problems, starts, u_lim=u_lim, **kw)
    big = torch.finfo(u_init.dtype).max
    # candidates: feasible first, then objective; prefer earlier starts
    score = torch.where(res.feasible, res.obj,
                        torch.full_like(res.obj, big)).reshape(3, b) \
        + torch.arange(3, dtype=u_init.dtype,
                       device=u_init.device)[:, None] * 1e-6
    best = torch.argmin(score, dim=0)                     # (B,)
    pick = best * b + torch.arange(b, device=u_init.device)
    return SCPResult(*[f[pick] for f in res])


def forward_u(sys: con.ConstraintSystem, u: torch.Tensor):
    """Predicted trajectory and per-vehicle controls. Returns
    (traj (B, hp, NY, V), U (B, hp, V))."""
    b, v, hp, _, hu = sys.b3.shape
    pos = con.positions(sys, u)          # (B, V, hp, NY)
    traj = pos.permute(0, 2, 3, 1)
    U = u.reshape(b, v, hu).transpose(1, 2)
    return traj, U
