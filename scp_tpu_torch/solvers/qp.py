"""Primal-dual interior-point QP solvers on batched tensors (counterpart of
``scp_tpu/solvers/qp.py``: ``solve_qp`` and ``solve_qp_batched``).

Solves  min_x  0.5 x^T P x + q^T x   s.t.  G x <= h,  lb <= x <= ub

with a Mehrotra predictor-corrector method:

* the box rows ``[I; -I]`` are handled implicitly (a diagonal in the KKT
  matrix, copies in the matvecs);
* each Newton step solves the condensed normal equations
  ``(P + Ghat^T diag(z/s) Ghat) dx = rhs`` with one Cholesky factorization
  of the Jacobi-scaled (unit-diagonal) matrix, regularised relative to it;
* row equilibration of G plus cost scaling absorb the ill-conditioned
  exact-penalty scaling (slack weight 1e5, curvature ~8e3).

:func:`solve_qp` is the general dense solver (``vmap(solve_qp)`` of
``scp_tpu``, written on a leading batch axis): adaptive while-loop or fixed
iteration count, Gondzio correctors, iterative refinement, dual warm start.
Its factor and solves go through ``ops.linalg_kernel`` (hand-written CUDA
kernels on a GPU, plain PyTorch on the CPU), or, with a ``banded`` stage
statement (:class:`BandedData`), through the Riccati sweeps of
``ops.riccati`` — the same linear system in its multiple-shooting form.

:func:`solve_qp_batched` is the SCP-shaped batched solver with four branches
(its docstring says which operands take which, and how ``kkt="auto"``
routes by shape past the kernels' shared-memory gates):

* fixed count, pair-sparse statement: all iterations in ONE call of the
  structured kernel ``ops.ipm_kernel.ipm_iterate_struct`` (K1);
* fixed count otherwise (e.g. one vehicle): all iterations in ONE call of
  the dense-G kernel ``ops.ipm_kernel.ipm_iterate_dense`` (K2);
* ``fixed_iters=None``: the adaptive loop on a dense G through
  ``ops.linalg_kernel``;
* banded: the adaptive or fixed loop with the Riccati sweeps (K6, K7).

:func:`solve_qp` also runs row-sharded (``axis_name`` / ``mg_total``): each
rank of a model process group holds its block of the G rows and every
reduction over the rows is an ``all_reduce`` over that group
(:class:`_RowAxis`), so every rank takes the same Newton steps.

Not ported (``NotImplementedError``): ``cheap_k``. Two TPU devices are
deliberately absent: ghost alignment vehicles (the Hopper kernels take any
size) and every padding (``n_pad`` / ``mg_pad`` / lane tiles / benign pad
instances); the VMEM gate is replaced by the wrappers' shared-memory gates,
and the slack is eliminated whenever ``slack_schur`` asks, with no
``(n-1) % 8 == 0`` condition.

The adaptive loops read ``any(active)`` on the host once per IPM iteration
— a device synchronisation each time, counted in :data:`host_sync_count`
and marked by a ``sync`` span (``utils.timing``); :func:`solve_qp_batched`
is a ``qp`` span.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from scp_tpu_torch.ops import (constraints as con, ipm_kernel,
                               linalg_kernel, riccati)
from scp_tpu_torch.parallel import mesh as mesh_lib
from scp_tpu_torch.utils import timing

# Host reads of a device value (device synchronisations) made by the adaptive
# IPM loops since the last reset.
host_sync_count = 0


def reset_host_sync_count() -> None:
    global host_sync_count
    host_sync_count = 0


class BandedData(NamedTuple):
    """Stage-structured statement of the SCP's QP for the banded (Riccati)
    KKT path (leading batch axis B): the SAME QP the dense operands describe,
    in multiple-shooting form (``ops/riccati.py``) — per-vehicle discrete
    dynamics, the raw position-space coefficients of every constraint row
    (``constraints.linearize_ycoefs``) and the stage decomposition of the
    cost (``P == 2 blockdiag(B^T Q B + r I)`` => stage weights ``qy = 2q``
    per position, ``ru = 2r`` per input). The pairs are in the canonical
    triu order (``constraints._static_pairs``), the SCP row layout. Rows
    must act PURELY through the stage positions."""
    a_blk: torch.Tensor   # (B, V, NX, NX) discrete A per vehicle
    b_blk: torch.Tensor   # (B, V, NX)     discrete B per vehicle
    y_pair: torch.Tensor  # (B, P, K, NY)  pair-row position coefficients
    y_obst: torch.Tensor  # (B, V, O, K, NY)
    qy: torch.Tensor      # (B, V, K) stage tracking weights (2q, 2q_final)
    ru: torch.Tensor      # (B, V)    stage input weights (2r)


class QPSolution(NamedTuple):
    x: torch.Tensor           # (B, n) primal solution
    obj: torch.Tensor         # (B,) 0.5 x^T P x + q^T x (unscaled)
    iters: torch.Tensor       # (B,) iterations used
    converged: torch.Tensor   # (B,) bool
    gap: torch.Tensor         # (B,) final complementarity measure
    z: torch.Tensor           # (B, m + 2n) duals for [G; I; -I] rows (unscaled)


def _reg_rel(dtype) -> float:
    """Regularisation relative to the unit KKT diagonal: a float32 Cholesky
    of the ill-conditioned late-stage systems needs a proportionally larger
    floor than float64."""
    return 1e-12 if dtype == torch.float64 else 3e-6


class _RowAxis:
    """Reductions over the row axis of ``[G rows; box rows]`` vectors
    ``(B, mg + 2n)``. Unsharded (``group=None``) they are plain sums. Row-
    sharded, each rank of ``group`` holds its ``mg`` G rows and the box
    rows whole: a G-row contribution is ``all_reduce``d over the group and
    the replicated box rows' is added once, after (``scp_tpu``'s
    ``psum_rows`` / ``row_dot`` / ``pmin``)."""

    def __init__(self, group=None, mg: int = 0):
        self.group, self.mg = group, mg

    def dot(self, a, b):
        if self.group is None:
            return torch.sum(a * b, dim=1)
        mg = self.mg
        return self.sum(torch.sum(a[:, :mg] * b[:, :mg], dim=1)) \
            + torch.sum(a[:, mg:] * b[:, mg:], dim=1)

    def norm(self, v):
        if self.group is None:
            return _norm(v)
        return torch.sqrt(self.dot(v, v))

    def sum(self, t):
        return mesh_lib.all_reduce(t, self.group)

    def min(self, t):
        return mesh_lib.all_reduce(t, self.group, "min")

    def all(self, flag):
        return mesh_lib.all_true(flag, self.group)


_UNSHARDED = _RowAxis()


def _max_step(v, dv, ax: _RowAxis = _UNSHARDED):
    """Largest alpha in (0, 1] keeping v + alpha * dv >= 0.01 v, per
    instance (B,); row-sharded, the minimum over every rank's rows."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return torch.clamp(0.99 * ax.min(ratio.amin(dim=1)), max=1.0)


def _all_finite(*ts):
    ok = torch.isfinite(ts[0]).all(dim=1)
    for t in ts[1:]:
        ok = ok & torch.isfinite(t).all(dim=1)
    return ok


def _norm(v):
    return torch.linalg.vector_norm(v, dim=1)


def _adaptive_loop(iterate, state, max_iter: int, tol: float, m: int,
                   hnorm, qnorm, ax: _RowAxis = _UNSHARDED):
    """The adaptive while-loop shared by :func:`solve_qp` and the adaptive
    branch of :func:`solve_qp_batched`: every instance iterates until it
    converges, stalls, goes non-finite or reaches ``max_iter``; a stopped
    instance keeps its state and its iteration count while the others go
    on. ``iterate(x, s, z, rp) -> (x, s, z, rp, mu, rd, ok)``. One host read
    of ``any(active)`` per iteration; row-sharded, the stop flags are
    AND-reduced over the ranks before it, so every rank runs the same
    iterations (a rank that ran one more would hang the next collective)."""
    global host_sync_count
    x, s, z, rp = state
    B = x.shape[0]
    it = torch.zeros((B,), dtype=torch.int32, device=x.device)
    stop = torch.zeros((B,), dtype=torch.bool, device=x.device)
    while True:
        active = (it < max_iter) & ~stop
        host_sync_count += 1
        with timing.span("sync", site="ipm"):
            go = bool(active.any())
        if not go:
            break
        x2, s2, z2, rp2, mu, rd, ok = iterate(x, s, z, rp)
        keep = active[:, None]
        x = torch.where(keep, x2, x)
        s = torch.where(keep, s2, s)
        z = torch.where(keep, z2, z)
        rp = torch.where(keep, rp2, rp)
        # mu_new is the POST-step complementarity, compared with the
        # pre-step mu
        mu_new = ax.dot(s, z) / m
        converged_now = ((mu_new < tol)
                         & (ax.norm(rp) / hnorm < tol * 10)
                         & (_norm(rd) / qnorm < tol * 10))
        # Stall exit: in float32 the complementarity floor can sit above
        # ``tol``; once mu stops improving meaningfully below a loose
        # ceiling, further iterations only burn time for the whole batch.
        stalled = (mu_new > 0.7 * mu) & (mu_new < tol * 1e3)
        stop = stop | (active & ax.all(converged_now | stalled | ~ok))
        it = it + active.to(torch.int32)
    return x, s, z, it


def _dense_kkt(P_s, G_s, mg: int, n: int, reg_rel: float,
               ax: _RowAxis = _UNSHARDED):
    """``(factor, solve)`` of the dense condensed KKT system: ``factor(s, z)``
    is the Cholesky of the Jacobi-scaled ``P_s + Ghat^T diag(z/s) Ghat`` —
    ONE factorization per IPM iteration, shared by every solve of it — and
    ``solve(fac, rhs)`` solves with it. The raw K mixes O(1) rows with O(1/mu)
    rows; scaling to unit diagonal removes the disparity that destroys a
    float32 factor, and the regularisation becomes relative per row. The
    factor and the solve go through ``ops.linalg_kernel``. Row-sharded
    (``ax``), each rank's block of ``G^T W G`` is summed over the ranks —
    one ``all_reduce`` a factorization — before the box diagonal is
    added."""
    G_sT = G_s.transpose(1, 2)
    diag_idx = torch.arange(n, device=G_s.device)

    def factor(s, z):
        w = z / s
        K = P_s + ax.sum(torch.bmm(G_sT * w[:, None, :mg], G_s))
        K[:, diag_idx, diag_idx] += w[:, mg:mg + n] + w[:, mg + n:]
        dsc = torch.rsqrt(torch.clamp(
            torch.diagonal(K, dim1=1, dim2=2), min=1e-30))
        K = K * (dsc[:, :, None] * dsc[:, None, :])
        K[:, diag_idx, diag_idx] += reg_rel
        return linalg_kernel.cholesky(K), dsc

    def solve(fac, rhs):
        L, dsc = fac
        return dsc * linalg_kernel.cho_solve(L, (dsc * rhs).contiguous())

    return factor, solve


def _banded_kkt(banded: "BandedData", *, mg: int, n: int, d_row, cost_scale,
                p_diag_s, diag_gu, gsl, gtmv, p_border, reg_rel: float):
    """``(factor, solve)`` of the SAME system as :func:`_dense_kkt`,
    ``(K + reg * diag(K)) dx = rhs``, through its multiple-shooting form
    (``ops/riccati.py``): the u-space block is factored by the backward
    Riccati sweep, and the slack column (the last variable, a dense border)
    is eliminated by a 1x1 Schur complement: the first solve after a
    factorization solves the border column and its own right-hand side in
    ONE two-right-hand-side launch and keeps the border's solution for the
    later solves of that factorization, which take one each.

    ``d_row`` / ``cost_scale``: the equilibration; ``p_diag_s (B, n)``: the
    scaled P diagonal; ``diag_gu(w_g) -> (B, nu)``: ``diag(G^T W_g G)`` over
    the u columns; ``gsl (B, mg)``: the scaled slack column of G; ``gtmv``:
    ``G^T v`` (B, n); ``p_border (B, nu)`` or None: P's slack column (zero
    by the p_blocks contract)."""
    a_blk = banded.a_blk.contiguous()
    b_blk = banded.b_blk.contiguous()
    B, v = a_blk.shape[:2]
    nu = n - 1
    hu = nu // v
    k = banded.y_obst.shape[3]
    if v * hu != nu or k != hu:
        raise ValueError(
            f"the banded KKT needs n - 1 = V * hu with hp == hu (n={n}, "
            f"V={v}, hp={k})")
    pairs = tuple(con._static_pairs(v))
    if banded.y_pair.shape[1] != len(pairs):
        raise ValueError("y_pair does not hold one row block per vehicle "
                         "pair")
    pk = len(pairs) * k
    d_row2 = d_row * d_row
    qy_s = banded.qy * cost_scale[:, None, None]
    ru_s = banded.ru * cost_scale[:, None]

    def stagef(vec):            # u-space (B, nu) vehicle-major -> (B, K, V)
        return vec.reshape(B, v, hu).transpose(1, 2).contiguous()

    def unstage(du):            # (B, K, V) -> (B, nu)
        return du.transpose(1, 2).reshape(B, nu)

    def factor(s, z):
        w = z / s
        w_g = w[:, :mg]
        # equilibrated rows are d_row * raw rows: G^T W G = sum (w d^2) c c^T
        # on the raw position coefficients
        wd = w_g * d_row2
        hy = riccati.build_hy(pairs, banded.y_pair, banded.y_obst,
                              wd[:, :pk].reshape(B, len(pairs), k),
                              wd[:, pk:].reshape(B, v, -1, k), qy_s)
        dbox = w[:, mg:mg + n] + w[:, mg + n:]
        # dense-path equivalence: Jacobi scaling + reg on the unit diagonal
        # == solving (K + reg * diag(K)); diag(K) on u is a per-stage input
        # cost term
        diagk_u = p_diag_s[:, :nu] + diag_gu(w_g) + dbox[:, :nu]
        hu_diag = ru_s[:, None, :] + stagef(dbox[:, :nu] + reg_rel * diagk_u)
        fac = riccati.riccati_factor(a_blk, b_blk, hy, hu_diag)
        # slack border: K's last column restricted to u, and K_ww
        c_uw = gtmv(w_g * gsl)[:, :nu]
        if p_border is not None:
            c_uw = c_uw + p_border
        k_ww = (torch.sum(w_g * gsl * gsl, 1) + dbox[:, n - 1]
                + p_diag_s[:, n - 1]) * (1.0 + reg_rel)
        # the border's solution y2 = K_uu^-1 c_uw comes with the first solve
        return [fac, c_uw, k_ww, None]

    def solve(fac_b, rhs):
        fac, c_uw, k_ww, y2 = fac_b
        if y2 is None:
            both = riccati.riccati_solve(fac, a_blk, b_blk, torch.stack(
                [stagef(c_uw), stagef(rhs[:, :nu])]))
            y2, y1 = unstage(both[0]), unstage(both[1])
            fac_b[3] = y2
        else:
            y1 = unstage(riccati.riccati_solve(fac, a_blk, b_blk,
                                               stagef(rhs[:, :nu])))
        dw = (rhs[:, nu] - torch.sum(c_uw * y1, 1)) \
            / (k_ww - torch.sum(c_uw * y2, 1))
        return torch.cat([y1 - dw[:, None] * y2, dw[:, None]], dim=1)

    return factor, solve


def _ipm(q, h, lb, ub, d_row, cost_scale, *, pmv, gmv, gtmv, kkt, obj_fn,
         max_iter, tol, x0, z0, fixed_iters, correctors, refine_steps,
         ax: _RowAxis = _UNSHARDED, mg_total: int | None = None):
    """The Mehrotra iteration behind :func:`solve_qp`, the adaptive branch
    of :func:`solve_qp_batched` and its banded branch, on equilibrated
    operands: ``pmv / gmv / gtmv`` compute ``P_s x``, ``G_s x`` and
    ``G_s^T v`` (``G_s = d_row * G`` by rows, ``P_s = cost_scale * P``);
    ``kkt = (factor, solve)`` factors the condensed KKT system of an iterate
    and solves with it (:func:`_dense_kkt`, :func:`_banded_kkt`);
    ``obj_fn(x)`` is the unscaled objective. Row-sharded, ``ax`` reduces
    over the ranks' G rows and ``mg_total`` is their global count."""
    factor, tri_solve = kkt
    dtype, device = q.dtype, q.device
    B, n = q.shape
    mg = h.shape[1]
    m = (mg if mg_total is None else mg_total) + 2 * n
    hhat_s = torch.cat([h * d_row, ub, -lb], dim=1)
    q_s = q * cost_scale[:, None]

    def ghat_mv(v):
        """[G_s; I; -I] @ v — box rows are copies, never materialized."""
        return torch.cat([gmv(v), v, -v], dim=1)

    def ghat_tmv(v):
        """[G_s; I; -I]^T @ v."""
        return ax.sum(gtmv(v[:, :mg].contiguous())) + v[:, mg:mg + n] \
            - v[:, mg + n:]

    # --- initial point ---
    if x0 is None:
        x = torch.zeros((B, n), dtype=dtype, device=device)
    else:
        x = torch.minimum(torch.maximum(x0, lb), ub)
    # s from the initial residual, z = 1/s: every complementarity product
    # starts at 1, so mu_0 = 1 in equilibrated units however wide the bounds
    s = torch.clamp(hhat_s - ghat_mv(x), min=1.0)
    z = 1.0 / s
    if z0 is not None:
        # dual warm start: re-scale into equilibrated units and clip away
        # from the boundary; non-positive entries keep the cold init
        z_w = z0 * cost_scale[:, None] / torch.cat(
            [d_row, torch.ones((B, 2 * n), dtype=dtype, device=device)], 1)
        z = torch.where(z0 > 0, torch.clamp(z_w, min=1e-3, max=1e3), z)

    def kkt_solve(L, s, z, rd, rp, rc):
        w = z / s
        rhs = -(rd + ghat_tmv(w * rp - rc / s))
        dx = tri_solve(L, rhs)
        # iterative refinement against the EXACT K action (matvecs, not the
        # formed matrix)
        for _ in range(refine_steps):
            r2 = rhs - (pmv(dx) + ghat_tmv(w * ghat_mv(dx)))
            dx = dx + tri_solve(L, r2)
        dz = w * (ghat_mv(dx) + rp) - rc / s
        ds = -(rc + s * dz) / z
        return dx, ds, dz

    def iterate(x, s, z, rp):
        """One Mehrotra predictor-corrector step. Returns the updated
        (x, s, z, rp), the pre-step mu, rd and the finite flag.

        ``rp`` follows the EXACT recurrence rp <- (1 - alpha) rp in float32
        (recomputing ``G x + s - h`` there leaves ~1e-7 of noise that the
        barrier weights amplify); float64 recomputes it, which lets the
        endgame drive the residuals to round-off."""
        rd = pmv(x) + q_s + ghat_tmv(z)
        if dtype == torch.float64:
            rp = ghat_mv(x) + s - hhat_s
        mu = ax.dot(s, z) / m

        L = factor(s, z)

        # predictor (affine)
        dx_a, ds_a, dz_a = kkt_solve(L, s, z, rd, rp, s * z)
        alpha_p = _max_step(s, ds_a, ax)[:, None]
        alpha_d = _max_step(z, dz_a, ax)[:, None]
        mu_aff = ax.dot(s + alpha_p * ds_a, z + alpha_d * dz_a) / m
        sigma = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3

        # corrector
        smu = (sigma * mu)[:, None]
        rc = s * z + ds_a * dz_a - smu
        dx, ds, dz = kkt_solve(L, s, z, rd, rp, rc)
        alpha = torch.minimum(_max_step(s, ds, ax),
                              _max_step(z, dz, ax))[:, None]

        # Gondzio multiple centrality correctors: extra backsolves on the
        # SAME factor that push the complementarity products of an enlarged
        # trial step into [0.1, 10] * (sigma mu); accepted per instance only
        # when the combined step length actually grows.
        zero_n, zero_m = torch.zeros_like(rd), torch.zeros_like(rp)
        for _ in range(correctors):
            at = torch.clamp(alpha + 0.1, max=1.0)
            v_t = (s + at * ds) * (z + at * dz)
            drc = v_t - torch.minimum(torch.maximum(v_t, 0.1 * smu),
                                      10.0 * smu)
            dx_c, ds_c, dz_c = kkt_solve(L, s, z, zero_n, zero_m, drc)
            dx2, ds2, dz2 = dx + dx_c, ds + ds_c, dz + dz_c
            alpha2 = torch.minimum(_max_step(s, ds2, ax),
                                   _max_step(z, dz2, ax))[:, None]
            acc = alpha2 >= alpha + 0.01
            dx = torch.where(acc, dx2, dx)
            ds = torch.where(acc, ds2, ds)
            dz = torch.where(acc, dz2, dz)
            alpha = torch.where(acc, alpha2, alpha)

        x_new = x + alpha * dx
        s_new = s + alpha * ds
        z_new = z + alpha * dz
        rp_new = (1.0 - alpha) * rp
        # NaN guard: a failed Cholesky poisons the step — keep the previous
        # iterate and flag it instead of propagating NaNs
        ok = ax.all(_all_finite(x_new, s_new, z_new))
        okb = ok[:, None]
        return (torch.where(okb, x_new, x), torch.where(okb, s_new, s),
                torch.where(okb, z_new, z), torch.where(okb, rp_new, rp),
                mu, rd, ok)

    rp0 = ghat_mv(x) + s - hhat_s
    hnorm = 1.0 + ax.norm(hhat_s)
    qnorm = 1.0 + _norm(q_s)

    if fixed_iters is not None:
        # Fixed iteration count with per-instance freeze-on-stall: once mu
        # stops improving at the float32 floor, further Mehrotra steps can
        # corrupt the iterate.
        rp = rp0
        mu_prev = torch.full((B,), torch.finfo(dtype).max, dtype=dtype,
                             device=device)
        frozen = torch.zeros((B,), dtype=torch.bool, device=device)
        for _ in range(fixed_iters):
            x2, s2, z2, rp2, mu, _, ok = iterate(x, s, z, rp)
            stalled = (mu > 0.7 * mu_prev) & (mu < tol * 1e3)
            frozen = frozen | ax.all(stalled | (mu < tol) | ~ok)
            keep = ~frozen[:, None]
            x = torch.where(keep, x2, x)
            s = torch.where(keep, s2, s)
            z = torch.where(keep, z2, z)
            rp = torch.where(keep, rp2, rp)
            mu_prev = mu
        iters = torch.full((B,), fixed_iters, dtype=torch.int32,
                           device=device)
    else:
        x, s, z, iters = _adaptive_loop(iterate, (x, s, z, rp0), max_iter,
                                        tol, m, hnorm, qnorm, ax)

    # Honest post-hoc convergence certificate (stalls don't count).
    mu_f = ax.dot(s, z) / m
    rp_f = ax.norm(ghat_mv(x) + s - hhat_s)
    rd_f = _norm(pmv(x) + q_s + ghat_tmv(z))
    conv = (mu_f < tol * 10) & (rp_f / hnorm < tol * 100) \
        & (rd_f / qnorm < tol * 100)

    obj = obj_fn(x)
    z_unscaled = torch.cat([d_row * z[:, :mg], z[:, mg:]], dim=1) \
        / cost_scale[:, None]
    return QPSolution(x=x, obj=obj, iters=iters, converged=conv, gap=mu_f,
                      z=z_unscaled)


def solve_qp(P, q, G, h, lb, ub, *, max_iter: int = 30, tol: float = 1e-8,
             x0=None, z0=None, fixed_iters: int | None = None,
             cheap_k: bool = False, refine_steps: int = 0,
             correctors: int = 0, axis_name=None,
             mg_total: int | None = None, banded=None) -> QPSolution:
    """Solve a batch of dense QPs (``vmap(solve_qp)`` of ``scp_tpu``).

    ``P (B, n, n)`` PSD, ``q (B, n)``, ``G (B, m, n)``, ``h (B, m)``,
    ``lb``/``ub (B, n)``; an unbatched call (``q (n,)`` ...) is the B = 1
    view and returns unbatched fields.

    ``fixed_iters``: run exactly that many Mehrotra iterations with
    per-instance freeze on stall / convergence / non-finite steps; ``None``
    runs the adaptive loop (each instance stops on its own, keeping its
    state and its ``iters``). ``correctors``: Gondzio centrality correctors
    per iteration. ``refine_steps``: iterative refinement of each Newton
    solve against the exact KKT action. ``z0``: dual warm start
    ``(B, m + 2n)``; non-positive entries keep the cold start.

    ``banded``: a :class:`BandedData` stage statement of the same QP (the
    SCP shape: ``n = V*hu + 1`` with the slack last, rows acting through the
    stage positions). The KKT system is then factored by the banded
    (Riccati) sweeps instead of the dense Cholesky — the same linear system,
    O(hp) instead of O(n^3).

    ``axis_name``: the row-sharded mode. It holds the model-axis
    ``torch.distributed`` ProcessGroup (``parallel.mesh.Mesh.groups
    ["model"]``; the name is ``scp_tpu``'s, where it names a mesh axis).
    Each rank passes its own block of the G rows (its horizon block of the
    avoidance rows) and ``mg_total``, the global row count; the box rows
    are on every rank and counted once. ``G^T W G`` is then formed from
    each rank's rows and ``all_reduce``d once a factorization; row sums,
    norms and step-length minima are ``all_reduce``d too, and every flag
    that decides the loops is AND-reduced before the host reads it, so
    every rank takes the same steps and ``x`` is the same on all of them.
    ``z`` comes back in the local layout ``[local G rows; box rows]``. The
    banded KKT is not row-sharded (``ValueError``).

    Not ported: ``cheap_k``.
    """
    if cheap_k:
        raise NotImplementedError(
            "cheap_k (reduced-precision KKT formation) has no counterpart "
            "in the port: products stay full float32")
    if axis_name is not None:
        if mg_total is None:
            raise ValueError("axis_name requires mg_total")
        if banded is not None:
            raise ValueError("the banded KKT is not row-sharded: pass "
                             "banded=None with axis_name")
    if q.ndim == 1:
        def up(t):
            return None if t is None else t[None]
        sol = solve_qp(up(P), up(q), up(G), up(h), up(lb), up(ub),
                       max_iter=max_iter, tol=tol, x0=up(x0), z0=up(z0),
                       fixed_iters=fixed_iters, refine_steps=refine_steps,
                       correctors=correctors, axis_name=axis_name,
                       mg_total=mg_total,
                       banded=None if banded is None
                       else BandedData(*[t[None] for t in banded]))
        return QPSolution(*[t[0] for t in sol])

    # --- equilibration (box rows have exactly unit norm: untouched) ---
    d_row = 1.0 / torch.clamp(torch.linalg.vector_norm(G, dim=2), min=1e-10)
    G_s = G * d_row[:, :, None]
    cost_scale = 1.0 / torch.clamp(P.abs().amax(dim=(1, 2)), min=1.0)
    P_s = P * cost_scale[:, None, None]
    mg, n = G.shape[1], G.shape[2]
    reg_rel = _reg_rel(q.dtype)

    # the matvecs are plain products here, as they are in ``scp_tpu``
    def mv(A, v):
        return torch.bmm(A, v[:, :, None])[:, :, 0]

    def gtmv(v):
        return torch.bmm(v[:, None, :], G_s)[:, 0]

    ax = _UNSHARDED if axis_name is None else _RowAxis(axis_name, mg)
    if banded is None:
        kkt = _dense_kkt(P_s, G_s, mg, n, reg_rel, ax)
    else:
        nu = n - 1
        Gu2 = G_s[:, :, :nu] ** 2                    # loop-invariant
        kkt = _banded_kkt(
            banded, mg=mg, n=n, d_row=d_row, cost_scale=cost_scale,
            p_diag_s=torch.diagonal(P_s, dim1=1, dim2=2),
            diag_gu=lambda w_g: torch.einsum("bm,bmn->bn", w_g, Gu2),
            gsl=G_s[:, :, nu], gtmv=gtmv, p_border=P_s[:, :nu, nu],
            reg_rel=reg_rel)
    return _ipm(q, h, lb, ub, d_row, cost_scale,
                pmv=lambda x: mv(P_s, x), gmv=lambda x: mv(G_s, x),
                gtmv=gtmv, kkt=kkt, obj_fn=_dense_obj(P, q),
                max_iter=max_iter, tol=tol, x0=x0, z0=z0,
                fixed_iters=fixed_iters, correctors=correctors,
                refine_steps=refine_steps, ax=ax,
                mg_total=None if axis_name is None else mg_total)


def _dense_obj(P, q):
    def obj(x):
        return 0.5 * torch.einsum("bi,bij,bj->b", x, P, x) \
            + torch.sum(q * x, dim=1)
    return obj


# ---------------------------------------------------------------------------
# solve_qp_batched: the SCP-shaped batched solver
# ---------------------------------------------------------------------------

class _PStatement(NamedTuple):
    """What the batched branches need of P: the cost scale, the scaled
    diagonal, ``P_s x`` and the unscaled objective."""
    cost_scale: torch.Tensor     # (B,)
    p_diag_s: torch.Tensor       # (B, n)
    pb_s: torch.Tensor | None    # (B, nb, d, d) scaled blocks, or None
    P_s: torch.Tensor | None     # (B, n, n) scaled dense P, or None
    pmv: object
    obj_fn: object


def _p_statement(P, q, p_blocks, dense_pmv=None) -> _PStatement:
    """P from ``p_blocks`` (``P == blockdiag(p_blocks) + a diagonal tail``,
    the tail read from a dense ``P`` when one is given, else zero) or from
    the dense ``P`` alone. Every P-derived scalar of the block statement
    comes from the blocks. ``dense_pmv(P_s, x)`` multiplies by a dense P
    (default: a batched product)."""
    B, n = q.shape
    if p_blocks is None:
        if P is None:
            raise ValueError("P=None requires p_blocks")
        cost_scale = 1.0 / torch.clamp(P.abs().amax(dim=(1, 2)), min=1.0)
        P_s = (P * cost_scale[:, None, None]).contiguous()

        def pmv(x):
            if dense_pmv is not None:
                return dense_pmv(P_s, x.contiguous())
            return torch.bmm(P_s, x[:, :, None])[:, :, 0]
        return _PStatement(cost_scale, torch.diagonal(P_s, dim1=1, dim2=2),
                           None, P_s, pmv, _dense_obj(P, q))
    nb, d = p_blocks.shape[1], p_blocks.shape[2]
    nbd = nb * d
    if nbd > n:
        raise ValueError(f"p_blocks {tuple(p_blocks.shape)} exceed n={n}")
    tail = (torch.zeros((B, n - nbd), dtype=q.dtype, device=q.device)
            if P is None else torch.diagonal(P, dim1=1, dim2=2)[:, nbd:])
    absmax = p_blocks.abs().amax(dim=(1, 2, 3))
    if n > nbd:
        absmax = torch.maximum(absmax, tail.abs().amax(dim=1))
    cost_scale = 1.0 / torch.clamp(absmax, min=1.0)
    pb_s = (p_blocks * cost_scale[:, None, None, None]).contiguous()
    p_diag_s = torch.cat(
        [torch.diagonal(p_blocks, dim1=2, dim2=3).reshape(B, nbd), tail],
        dim=1) * cost_scale[:, None]
    ptail = p_diag_s[:, nbd:]

    def pmv(x):
        px = torch.einsum("bvij,bvj->bvi", pb_s, x[:, :nbd].reshape(B, nb, d))
        return torch.cat([px.reshape(B, nbd), ptail * x[:, nbd:]], dim=1)

    if P is not None:
        obj_fn = _dense_obj(P, q)
    else:
        def obj_fn(x):
            xq = x[:, :nbd].reshape(B, nb, d)
            quad = torch.einsum("bvi,bvij,bvj->b", xq, p_blocks, xq) \
                + torch.sum(tail * x[:, nbd:] ** 2, dim=1)
            return 0.5 * quad + torch.sum(q * x, dim=1)
    return _PStatement(cost_scale, p_diag_s, pb_s, None, pmv, obj_fn)


class _SlabRows(NamedTuple):
    """The equilibrated pair-sparse rows and their products."""
    d_row: torch.Tensor          # (B, mg)
    d_slack: torch.Tensor        # (B, mg) scaled slack coefficient magnitude
    gi: torch.Tensor             # (B, P, K, U)
    gj: torch.Tensor
    gob: torch.Tensor            # (B, S, K, U)
    gmv: object                  # (B, n) -> (B, mg)
    gtmv: object                 # (B, mg) -> (B, n)
    diag_gu: object              # w (B, mg) -> diag(G^T W G) on u, (B, nu)


def _slab_rows(g_slabs, g_struct, g_slack_mask, B, mg, n, dtype,
               device) -> _SlabRows:
    """Equilibrate the row slabs (``g_slabs``, the slack column implicit:
    ``-1`` where ``g_slack_mask`` is 1) once per solve and build the slab
    products."""
    pairs, obst_veh, _, hu, *_ = g_struct
    nu = n - 1
    nv = nu // hu
    gi_b, gj_b, gob_b = g_slabs
    if gob_b.ndim == 5:
        # (B, V, O, K, U) -> flat (B, S, K, U); v-major order matches the
        # canonical obst_veh enumeration
        gob_b = gob_b.reshape((B, -1) + tuple(gob_b.shape[3:]))
    if gob_b.shape[1] != len(obst_veh):
        raise ValueError("slab count must match g_struct obst_veh")
    if g_slack_mask is None:
        slack_mask = torch.ones((mg,), dtype=dtype, device=device)
    else:
        slack_mask = torch.as_tensor(g_slack_mask, dtype=dtype, device=device)
    # row norms in row order [pairs | single-block slabs]; a row's slack
    # coefficient is -1 where masked (slack_mask^2 == slack_mask)
    row_norm = torch.sqrt(torch.cat([
        (torch.sum(gi_b * gi_b, -1)
         + torch.sum(gj_b * gj_b, -1)).reshape(B, -1),
        torch.sum(gob_b * gob_b, -1).reshape(B, -1),
    ], dim=1) + slack_mask[None, :])                          # (B, mg)
    d_row = 1.0 / torch.clamp(row_norm, min=1e-10)
    d_slack = d_row * slack_mask[None, :]
    pk = gi_b.shape[1] * gi_b.shape[2]
    d_pairk = d_row[:, :pk].reshape(gi_b.shape[:3])
    gi_c = (gi_b * d_pairk[..., None]).contiguous()
    gj_c = (gj_b * d_pairk[..., None]).contiguous()
    gob_c = (gob_b * d_row[:, pk:].reshape(gob_b.shape[:3])[..., None]
             ).contiguous()
    pi_idx = torch.tensor([i for i, _ in pairs], dtype=torch.long,
                          device=device)
    pj_idx = torch.tensor([j for _, j in pairs], dtype=torch.long,
                          device=device)
    ov_idx = torch.tensor(list(obst_veh), dtype=torch.long, device=device)

    def gmv(x):                                               # (B,n)->(B,mg)
        xv = x[:, :nu].reshape(B, nv, hu)
        rows_p = (torch.einsum("bpku,bpu->bpk", gi_c, xv[:, pi_idx])
                  + torch.einsum("bpku,bpu->bpk", gj_c, xv[:, pj_idx]))
        rows_o = torch.einsum("bsku,bsu->bsk", gob_c, xv[:, ov_idx])
        rows = torch.cat([rows_p.reshape(B, -1), rows_o.reshape(B, -1)],
                         dim=1)
        return rows - d_slack * x[:, nu:]

    def col_sum(gi, gj, gob, v):
        """sum over the rows of ``v``-weighted slab entries, per u column;
        vehicle indices repeat across pairs: index_add_, not ``+=``."""
        vp = v[:, :pk].reshape(gi.shape[:3])
        vo = v[:, pk:].reshape(gob.shape[:3])
        acc = torch.zeros((B, nv, hu), dtype=dtype, device=device)
        acc.index_add_(1, pi_idx, torch.einsum("bpku,bpk->bpu", gi, vp))
        acc.index_add_(1, pj_idx, torch.einsum("bpku,bpk->bpu", gj, vp))
        acc.index_add_(1, ov_idx, torch.einsum("bsku,bsk->bsu", gob, vo))
        return acc.reshape(B, nu)

    def gtmv(v):                                              # (B,mg)->(B,n)
        slack = -torch.sum(d_slack * v, dim=1, keepdim=True)
        return torch.cat([col_sum(gi_c, gj_c, gob_c, v), slack], dim=1)

    sq = (gi_c * gi_c, gj_c * gj_c, gob_c * gob_c)

    def diag_gu(w_g):
        return col_sum(*sq, w_g)

    return _SlabRows(d_row, d_slack, gi_c, gj_c, gob_c, gmv, gtmv, diag_gu)


class _DenseRows(NamedTuple):
    """The equilibrated dense rows (slack column included) and their
    products through the G-matvec kernels."""
    d_row: torch.Tensor          # (B, mg)
    G_c: torch.Tensor            # (B, mg, n) = d_row * G, contiguous
    gmv: object                  # (B, n) -> (B, mg)
    gtmv: object                 # (B, mg) -> (B, n)


def _dense_rows(G) -> _DenseRows:
    if G is None:
        raise ValueError(
            "this branch of solve_qp_batched reads the dense G (B, mg, n), "
            "slack column included; g_slabs alone do not state it")
    d_row = 1.0 / torch.clamp(torch.linalg.vector_norm(G, dim=2), min=1e-10)
    G_c = (G * d_row[:, :, None]).contiguous()
    return _DenseRows(
        d_row, G_c, lambda x: linalg_kernel.gmv(G_c, x.contiguous()),
        lambda v: linalg_kernel.gtmv(G_c, v.contiguous()))


def _structured(g_struct, g_slabs, p_blocks, slack_schur) -> bool:
    """Whether the pair-sparse structure engages the structured kernel: a
    statement with at least one pair, its slabs, the P blocks and the slack
    elimination."""
    return (g_struct is not None and bool(g_struct[0]) and g_slabs is not None
            and p_blocks is not None and slack_schur)


def _route(q, h, G, *, fixed_iters, p_blocks, slack_schur, g_struct,
           g_slabs, banded, kkt) -> str:
    """The branch of :func:`solve_qp_batched` for these operands: "banded",
    "adaptive", "struct" (K1) or "dense" (K2). ``kkt="auto"`` takes the
    kernels where their shared-memory tier holds the shape (K1's with the
    slabs as the launch stores them: packed under ``lower_tri``) and the
    banded KKT past it when a stage statement is given; without one, and
    under ``kkt="dense"``, a fused kernel runs in whichever storage tier
    holds the shape (``ipm_kernel.struct_tier`` / ``dense_tier``: past the
    shared tier the cluster or device tier and the global tier past that,
    as ``scp_tpu`` falls back from its fused kernel to its XLA path). For the adaptive branch the gate is
    ``linalg_kernel.fits_chol_smem`` (n < 240), although the dense factor
    and solve take any n (from n = 240 with the matrix in device memory),
    so ``kkt="dense"`` runs the adaptive branch at every n. The route
    depends on the shape only, never on the device."""
    if kkt == "banded":
        return "banded"
    n, mg = q.shape[1], h.shape[1]
    if fixed_iters is None:
        if (kkt == "auto" and banded is not None
                and not linalg_kernel.fits_chol_smem(n)):
            return "banded"
        return "adaptive"
    if _structured(g_struct, g_slabs, p_blocks, slack_schur):
        route = "struct"
        nb, hu = p_blocks.shape[1], p_blocks.shape[2]
        shape = (len(g_struct[0]), len(g_struct[1]), int(g_struct[2]), hu,
                 nb, bool(g_struct[4]) if len(g_struct) > 4 else False)
        fits = ipm_kernel.fits_smem(*shape)
    else:
        route = "dense"
        nb, d = (0, 0) if p_blocks is None else tuple(p_blocks.shape[1:3])
        shape = (mg, n, nb, d, slack_schur)
        fits = ipm_kernel.fits_dense_smem(*shape)
    if kkt == "dense" or fits:
        return route
    if banded is None:
        # past the shared tier the cluster, device or global tier; K1's
        # tier function raises only where its global tier's index tables
        # exceed a block, naming the bytes (K2's never raises here)
        if route == "struct":
            ipm_kernel.struct_tier(*shape)
        return route
    return "banded"


def solve_qp_batched(P, q, G, h, lb, ub, *, max_iter: int = 30,
                     tol: float = 1e-8, x0=None, z0=None,
                     fixed_iters: int | None = None,
                     p_blocks=None, correctors: int = 0,
                     slack_schur: bool = False,
                     certificate: bool = True,
                     g_struct: tuple | None = None,
                     g_slabs: tuple | None = None,
                     g_slack_mask=None,
                     banded: "BandedData | None" = None,
                     kkt: str = "dense") -> QPSolution:
    """Solve a batch of SCP-shaped QPs (leading batch axis B).

    ``q (B, n)``, ``h (B, mg)``, ``lb``/``ub (B, n)``. ``z0``: optional dual
    warm start ``(B, mg + 2n)``; non-positive entries keep the cold start.
    ``P (B, n, n)`` may be ``None`` when ``p_blocks (B, V, hu, hu)`` states
    it (``P = blockdiag(p_blocks)`` + a zero tail). ``G (B, mg, n)`` is the
    dense constraint matrix WITH its own slack column; the pair-sparse
    statement ``g_slabs = (gi (B,P,K,U), gj (B,P,K,U), gob (B,V,O,K,U) or
    flat (B,S,K,U))`` with ``g_struct = (pairs, obst_veh, hp, hu[,
    lower_tri])`` states the same rows without it. HARD CONTRACT of the
    slabs: every avoidance row's slack coefficient is ``-1`` (0 where
    ``g_slack_mask`` is 0 — a hard row); the equilibration bakes it into
    each row norm.

    Branches (``kkt`` and the shape choose, the same on every device):

    * **fixed count, structured** (``fixed_iters`` set, ``g_struct`` with at
      least one pair, ``g_slabs``, ``p_blocks``, ``slack_schur``): all
      iterations in ONE call of ``ops.ipm_kernel.ipm_iterate_struct`` (K1);
      ``G`` is not read.
    * **fixed count, dense G** (any other fixed-count call; ``G``
      required): all iterations in ONE call of
      ``ops.ipm_kernel.ipm_iterate_dense`` (K2), which forms
      ``G^T diag(w_g) G`` itself, with ``p_blocks`` or the dense P, and the
      slack eliminated when ``slack_schur``.
    * **adaptive** (``fixed_iters=None``; ``G`` required): the adaptive loop
      with the factor, the solves and the G products through
      ``ops.linalg_kernel``; ``correctors`` is IGNORED on this branch, as in
      ``scp_tpu``'s lane implementation (``solve_qp`` honours it).
    * **banded** (``banded=BandedData``): the same iteration as the
      adaptive branch (fixed count with freeze-on-stall, or adaptive) with
      the KKT system factored by the Riccati sweeps (``ops.riccati``) and,
      with ``g_slabs``, every G product on the slabs; ``correctors`` is
      ignored here too.

    ``kkt="dense"`` takes the first three (the adaptive branch at any n:
    from n = 240 its factor and solve keep the matrix in device memory; a
    fused kernel in its device-memory tier past its shared one);
    ``"banded"`` the last; ``"auto"`` takes the fused kernels where their
    shared-memory tier holds the shape (the adaptive branch where the
    shared-memory factor's does, n < 240, or wherever no ``banded`` is
    given) and the banded branch past them — without ``banded`` a fused
    kernel's cluster or device tier, and its global tier past those.
    ``certificate=False`` takes the cheap convergence certificate of the
    fused branches (primal residual from the kernel's recurrence).
    """
    if kkt not in ("dense", "banded", "auto"):
        raise ValueError(f"unknown kkt {kkt!r}")
    if kkt == "banded" and banded is None:
        raise ValueError("kkt='banded' needs the stage statement "
                         "banded=BandedData(...)")
    route = _route(q, h, G, fixed_iters=fixed_iters, p_blocks=p_blocks,
                   slack_schur=slack_schur, g_struct=g_struct,
                   g_slabs=g_slabs, banded=banded, kkt=kkt)
    with timing.span("qp", route=route, B=q.shape[0], n=q.shape[1],
                     mg=h.shape[1], fixed_iters=fixed_iters or 0):
        if route == "banded":
            return _solve_qp_batched_banded(
                P, q, G, h, lb, ub, max_iter=max_iter, tol=tol, x0=x0,
                z0=z0, fixed_iters=fixed_iters, p_blocks=p_blocks,
                g_struct=g_struct, g_slabs=g_slabs,
                g_slack_mask=g_slack_mask, banded=banded)
        if route == "adaptive":
            return _solve_qp_batched_adaptive(
                P, q, G, h, lb, ub, max_iter=max_iter, tol=tol, x0=x0,
                z0=z0, p_blocks=p_blocks)
        if route == "struct":
            return _solve_qp_batched_struct(
                P, q, h, lb, ub, tol=tol, x0=x0, z0=z0,
                fixed_iters=fixed_iters, p_blocks=p_blocks,
                correctors=correctors, certificate=certificate,
                g_struct=g_struct, g_slabs=g_slabs,
                g_slack_mask=g_slack_mask)
        return _solve_qp_batched_dense(
            P, q, G, h, lb, ub, tol=tol, x0=x0, z0=z0,
            fixed_iters=fixed_iters, p_blocks=p_blocks,
            correctors=correctors, slack_schur=slack_schur,
            certificate=certificate)


def _fused_start(q, h, lb, ub, d_row, cost_scale, gmv, x0, z0):
    """Initial state of the fused branches, split by row section:
    ``(x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal)`` with ``scal =
    [mu of the previous iteration, frozen flag]``."""
    dtype, device = q.dtype, q.device
    B, n = q.shape
    mg = h.shape[1]
    hg, hl = h * d_row, -lb
    if x0 is None:
        x = torch.zeros((B, n), dtype=dtype, device=device)
    else:
        x = torch.minimum(torch.maximum(x0, lb), ub)
    gx = gmv(x)
    # s from the initial residual, z = 1/s: every complementarity product
    # starts at 1, so mu_0 = 1 in equilibrated units however wide the bounds
    sg = torch.clamp(hg - gx, min=1.0)
    su = torch.clamp(ub - x, min=1.0)
    sl = torch.clamp(hl + x, min=1.0)
    zg, zu, zl = 1.0 / sg, 1.0 / su, 1.0 / sl
    if z0 is not None:
        # dual warm start: re-scale into equilibrated units and clip away
        # from the boundary; non-positive entries keep the cold init
        z_w = z0 * cost_scale[:, None] / torch.cat(
            [d_row, torch.ones((B, 2 * n), dtype=dtype, device=device)],
            dim=1)
        z_w = torch.clamp(z_w, min=1e-3, max=1e3)
        zg = torch.where(z0[:, :mg] > 0, z_w[:, :mg], zg)
        zu = torch.where(z0[:, mg:mg + n] > 0, z_w[:, mg:mg + n], zu)
        zl = torch.where(z0[:, mg + n:] > 0, z_w[:, mg + n:], zl)
    scal = torch.zeros((B, 2), dtype=dtype, device=device)
    scal[:, 0] = torch.finfo(dtype).max
    # rp carried by the exact (1 - alpha) recurrence inside the kernels
    state = (x, sg, su, sl, zg, zu, zl, gx + sg - hg, x + su - ub,
             -x + sl - hl, scal)
    return tuple(t.contiguous() for t in state)


def _fused_finish(state, q, h, lb, ub, d_row, pst: _PStatement, gmv, gtmv,
                  *, tol, fixed_iters, certificate) -> QPSolution:
    """Certificate, objective and unscaled duals of the fused branches."""
    x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, _ = state
    B, n = x.shape
    m = h.shape[1] + 2 * n
    hg, hl = h * d_row, -lb
    q_s = q * pst.cost_scale[:, None]
    iters = torch.full((B,), fixed_iters, dtype=torch.int32, device=q.device)
    mu_f = (torch.sum(sg * zg, 1) + torch.sum(su * zu, 1)
            + torch.sum(sl * zl, 1)) / m
    hnorm = torch.sqrt(torch.sum(hg * hg, 1) + torch.sum(ub * ub, 1)
                       + torch.sum(hl * hl, 1))
    if not certificate:
        # Cheap certificate: the primal residual is carried through the
        # kernel by the exact recurrence, so its norm costs three small
        # reductions instead of an honest recomputation.
        rp_f = torch.sqrt(torch.sum(rpg * rpg, 1) + torch.sum(rpu * rpu, 1)
                          + torch.sum(rpl * rpl, 1))
        conv = (mu_f < tol * 10) \
            & (rp_f / (1.0 + hnorm) < tol * 100) \
            & torch.isfinite(x).all(dim=1)
    else:
        gx = gmv(x)
        rp_f = torch.sqrt(torch.sum((gx + sg - hg) ** 2, 1)
                          + torch.sum((x + su - ub) ** 2, 1)
                          + torch.sum((-x + sl - hl) ** 2, 1))
        rd = pst.pmv(x) + q_s + gtmv(zg) + zu - zl
        rd_f = torch.linalg.vector_norm(rd, dim=1)
        conv = (mu_f < tol * 10) \
            & (rp_f / (1.0 + hnorm) < tol * 100) \
            & (rd_f / (1.0 + torch.linalg.vector_norm(q_s, dim=1))
               < tol * 100)
    z_unscaled = torch.cat([d_row * zg, zu, zl], dim=1) \
        / pst.cost_scale[:, None]
    return QPSolution(x=x, obj=pst.obj_fn(x), iters=iters, converged=conv,
                      gap=mu_f, z=z_unscaled)


def _solve_qp_batched_struct(P, q, h, lb, ub, *, tol, x0, z0, fixed_iters,
                             p_blocks, correctors, certificate, g_struct,
                             g_slabs, g_slack_mask) -> QPSolution:
    """The fixed-count structured branch of :func:`solve_qp_batched`: all
    iterations in one call of the structured kernel (K1) on the
    equilibrated slabs."""
    dtype = q.dtype
    B, mg = h.shape
    n = q.shape[1]
    pairs, obst_veh, _, hu_s, *rest = g_struct
    lower_tri = bool(rest[0]) if rest else False
    nb, d = p_blocks.shape[1], p_blocks.shape[2]
    if nb * d != n - 1 or d != hu_s:
        raise ValueError(
            f"p_blocks {tuple(p_blocks.shape)} does not tile n - 1 = {n - 1} "
            f"with hu = {hu_s}")
    rows = _slab_rows(g_slabs, g_struct, g_slack_mask, B, mg, n, dtype,
                      q.device)
    pst = _p_statement(P, q, p_blocks)
    q_s = q * pst.cost_scale[:, None]
    state = _fused_start(q, h, lb, ub, rows.d_row, pst.cost_scale, rows.gmv,
                         x0, z0)
    out = ipm_kernel.ipm_iterate_struct(
        rows.gi, rows.gj, rows.gob if rows.gob.shape[1] else None,
        (-rows.d_slack).contiguous(), pst.pb_s, q_s.contiguous(),
        pst.p_diag_s.contiguous(), *state,
        pairs=tuple(pairs), obst_veh=tuple(obst_veh), tol=tol,
        reg_rel=_reg_rel(dtype), n_cor=correctors, n_iters=fixed_iters,
        lower_tri=lower_tri)
    return _fused_finish(out, q, h, lb, ub, rows.d_row, pst, rows.gmv,
                         rows.gtmv, tol=tol, fixed_iters=fixed_iters,
                         certificate=certificate)


def _solve_qp_batched_dense(P, q, G, h, lb, ub, *, tol, x0, z0, fixed_iters,
                            p_blocks, correctors, slack_schur,
                            certificate) -> QPSolution:
    """The fixed-count dense-G branch of :func:`solve_qp_batched`: all
    iterations in ONE call of the dense-G kernel (K2) on the equilibrated
    dense G, which forms ``G_k^T diag(zg / sg) G_k`` each iteration, adds
    the P blocks or the dense P, the box diagonal and the regularisation,
    eliminates the slack border (``slack_schur``: the last variable is a
    slack with a zero P row) and runs the step."""
    rows = _dense_rows(G)
    d_row, G_c, gmv, gtmv = rows
    pst = _p_statement(P, q, p_blocks, dense_pmv=linalg_kernel.gmv)
    q_s = (q * pst.cost_scale[:, None]).contiguous()
    state = _fused_start(q, h, lb, ub, d_row, pst.cost_scale, gmv, x0, z0)
    out = ipm_kernel.ipm_iterate_dense(
        G_c, pst.P_s, pst.pb_s, q_s, pst.p_diag_s.contiguous(), *state,
        n_iters=fixed_iters, tol=tol, reg_rel=_reg_rel(q.dtype),
        n_cor=correctors, schur_slack=slack_schur)
    return _fused_finish(out, q, h, lb, ub, d_row, pst, gmv, gtmv,
                         tol=tol, fixed_iters=fixed_iters,
                         certificate=certificate)


def _solve_qp_batched_adaptive(P, q, G, h, lb, ub, *, max_iter, tol, x0, z0,
                               p_blocks) -> QPSolution:
    """The adaptive branch of :func:`solve_qp_batched` (its docstring states
    the operands): the Mehrotra iteration on instance-major tensors, with
    the factor, the two solves per iteration, the G / G^T products and (on a
    dense P) the P product through ``ops.linalg_kernel``."""
    rows = _dense_rows(G)
    if P is None and p_blocks is None:
        raise ValueError("P=None requires p_blocks")
    B, mg, n = G.shape
    if P is None:
        # the KKT formation reads the dense P: rebuild it from the blocks
        # (blockdiag + zero tail)
        nb_, d_ = p_blocks.shape[1], p_blocks.shape[2]
        P = torch.zeros((B, n, n), dtype=q.dtype, device=q.device)
        for vb in range(nb_):
            P[:, vb * d_:(vb + 1) * d_, vb * d_:(vb + 1) * d_] = \
                p_blocks[:, vb]

    pst = _p_statement(P, q, p_blocks, dense_pmv=linalg_kernel.gmv)
    P_s = (P * pst.cost_scale[:, None, None]).contiguous()
    # ``correctors`` is deliberately not passed on (see solve_qp_batched)
    return _ipm(q, h, lb, ub, rows.d_row, pst.cost_scale, pmv=pst.pmv,
                gmv=rows.gmv, gtmv=rows.gtmv,
                kkt=_dense_kkt(P_s, rows.G_c, mg, n, _reg_rel(q.dtype)),
                obj_fn=_dense_obj(P, q), max_iter=max_iter, tol=tol, x0=x0,
                z0=z0, fixed_iters=None, correctors=0, refine_steps=0)


def _solve_qp_batched_banded(P, q, G, h, lb, ub, *, max_iter, tol, x0, z0,
                             fixed_iters, p_blocks, g_struct, g_slabs,
                             g_slack_mask, banded) -> QPSolution:
    """The banded branch of :func:`solve_qp_batched`: the iteration of the
    adaptive branch (fixed count with freeze-on-stall, or adaptive) with the
    KKT system factored by the Riccati sweeps. With a pair statement and its
    slabs every G product runs on the slabs (the dense G — large at long
    horizons — is never read); otherwise on the dense G through
    ``ops.linalg_kernel``. ``correctors`` is ignored, as on ``scp_tpu``'s
    lane path."""
    B, mg = h.shape
    n = q.shape[1]
    nu = n - 1
    if g_slabs is not None and g_struct is not None and g_struct[0]:
        rows = _slab_rows(g_slabs, g_struct, g_slack_mask, B, mg, n, q.dtype,
                          q.device)
        d_row, gmv, gtmv = rows.d_row, rows.gmv, rows.gtmv
        diag_gu, gsl = rows.diag_gu, -rows.d_slack
    else:
        d_row, G_c, gmv, gtmv = _dense_rows(G)
        Gu2 = G_c[:, :, :nu] ** 2

        def diag_gu(w_g):
            return torch.einsum("bm,bmn->bn", w_g, Gu2)
        gsl = G_c[:, :, nu]
    pst = _p_statement(P, q, p_blocks, dense_pmv=linalg_kernel.gmv)
    kkt = _banded_kkt(banded, mg=mg, n=n, d_row=d_row,
                      cost_scale=pst.cost_scale, p_diag_s=pst.p_diag_s,
                      diag_gu=diag_gu, gsl=gsl, gtmv=gtmv, p_border=None,
                      reg_rel=_reg_rel(q.dtype))
    return _ipm(q, h, lb, ub, d_row, pst.cost_scale, pmv=pst.pmv, gmv=gmv,
                gtmv=gtmv, kkt=kkt, obj_fn=pst.obj_fn, max_iter=max_iter,
                tol=tol, x0=x0, z0=z0, fixed_iters=fixed_iters, correctors=0,
                refine_steps=0)
