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
kernels on a GPU, plain PyTorch on the CPU).

:func:`solve_qp_batched` is the SCP-shaped batched solver with two branches:

* ``fixed_iters`` set and a pair-sparse statement of G (``g_struct`` +
  ``g_slabs`` + ``p_blocks`` + ``slack_schur``): all iterations run in ONE
  call of ``ops.ipm_kernel.ipm_iterate_struct``;
* ``fixed_iters=None``: the adaptive loop on a dense G, with the factor, the
  solves and the G matvecs through ``ops.linalg_kernel``.

Not ported yet (``NotImplementedError``): a fixed iteration count without an
engaged structure (the dense-G fused iteration), the banded (Riccati) KKT,
``cheap_k`` and the row-sharded mode of ``solve_qp``. Two TPU devices are
deliberately absent: ghost alignment vehicles (the Hopper kernels take any
size) and every padding (``n_pad`` / ``mg_pad`` / lane tiles / benign pad
instances); the VMEM gate is replaced by the wrappers' shared-memory gates.

The adaptive loops read ``any(active)`` on the host once per IPM iteration
— a device synchronisation each time, counted in :data:`host_sync_count`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from scp_tpu_torch.ops import ipm_kernel, linalg_kernel

# Host reads of a device value (device synchronisations) made by the adaptive
# IPM loops since the last reset.
host_sync_count = 0


def reset_host_sync_count() -> None:
    global host_sync_count
    host_sync_count = 0


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


def _max_step(v, dv):
    """Largest alpha in (0, 1] keeping v + alpha * dv >= 0.01 v, per
    instance (B,)."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return torch.clamp(0.99 * ratio.amin(dim=1), max=1.0)


def _all_finite(*ts):
    ok = torch.isfinite(ts[0]).all(dim=1)
    for t in ts[1:]:
        ok = ok & torch.isfinite(t).all(dim=1)
    return ok


def _norm(v):
    return torch.linalg.vector_norm(v, dim=1)


def _adaptive_loop(iterate, state, max_iter: int, tol: float, m: int,
                   hnorm, qnorm):
    """The adaptive while-loop shared by :func:`solve_qp` and the adaptive
    branch of :func:`solve_qp_batched`: every instance iterates until it
    converges, stalls, goes non-finite or reaches ``max_iter``; a stopped
    instance keeps its state and its iteration count while the others go
    on. ``iterate(x, s, z, rp) -> (x, s, z, rp, mu, rd, ok)``. One host read
    of ``any(active)`` per iteration."""
    global host_sync_count
    x, s, z, rp = state
    B = x.shape[0]
    it = torch.zeros((B,), dtype=torch.int32, device=x.device)
    stop = torch.zeros((B,), dtype=torch.bool, device=x.device)
    while True:
        active = (it < max_iter) & ~stop
        host_sync_count += 1
        if not bool(active.any()):
            break
        x2, s2, z2, rp2, mu, rd, ok = iterate(x, s, z, rp)
        keep = active[:, None]
        x = torch.where(keep, x2, x)
        s = torch.where(keep, s2, s)
        z = torch.where(keep, z2, z)
        rp = torch.where(keep, rp2, rp)
        # mu_new is the POST-step complementarity, compared with the
        # pre-step mu
        mu_new = torch.sum(s * z, dim=1) / m
        converged_now = ((mu_new < tol)
                         & (_norm(rp) / hnorm < tol * 10)
                         & (_norm(rd) / qnorm < tol * 10))
        # Stall exit: in float32 the complementarity floor can sit above
        # ``tol``; once mu stops improving meaningfully below a loose
        # ceiling, further iterations only burn time for the whole batch.
        stalled = (mu_new > 0.7 * mu) & (mu_new < tol * 1e3)
        stop = stop | (active & (converged_now | stalled | ~ok))
        it = it + active.to(torch.int32)
    return x, s, z, it


def _ipm(P, P_s, q, G_s, h, lb, ub, d_row, cost_scale, *, pmv, gmv, gtmv,
         max_iter, tol, x0, z0, fixed_iters, correctors, refine_steps):
    """The Mehrotra iteration behind :func:`solve_qp` and the adaptive branch
    of :func:`solve_qp_batched`, on equilibrated operands: ``G_s = d_row *
    G`` (rows), ``P_s = cost_scale * P``; ``pmv / gmv / gtmv`` compute
    ``P_s x``, ``G_s x`` and ``G_s^T v`` (plain products or kernel wrappers —
    the caller's choice). The factor and the solves go through
    ``ops.linalg_kernel``."""
    dtype, device = q.dtype, q.device
    B, n = q.shape
    mg = h.shape[1]
    m = mg + 2 * n
    hhat_s = torch.cat([h * d_row, ub, -lb], dim=1)
    q_s = q * cost_scale[:, None]

    def ghat_mv(v):
        """[G_s; I; -I] @ v — box rows are copies, never materialized."""
        return torch.cat([gmv(v), v, -v], dim=1)

    def ghat_tmv(v):
        """[G_s; I; -I]^T @ v."""
        return gtmv(v[:, :mg].contiguous()) + v[:, mg:mg + n] \
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

    reg_rel = _reg_rel(dtype)
    G_sT = G_s.transpose(1, 2)
    diag_idx = torch.arange(n, device=device)

    def factor(s, z):
        """Cholesky of the Jacobi-scaled condensed KKT matrix — ONE
        factorization per IPM iteration, shared by every solve of it. The
        raw K mixes O(1) rows with O(1/mu) rows; scaling to unit diagonal
        removes the disparity that destroys a float32 factor, and the
        regularisation becomes relative per row."""
        w = z / s
        K = P_s + torch.bmm(G_sT * w[:, None, :mg], G_s)
        K[:, diag_idx, diag_idx] += w[:, mg:mg + n] + w[:, mg + n:]
        dsc = torch.rsqrt(torch.clamp(
            torch.diagonal(K, dim1=1, dim2=2), min=1e-30))
        K = K * (dsc[:, :, None] * dsc[:, None, :])
        K[:, diag_idx, diag_idx] += reg_rel
        return linalg_kernel.cholesky(K), dsc

    def tri_solve(L, dsc, rhs):
        return dsc * linalg_kernel.cho_solve(L, (dsc * rhs).contiguous())

    def kkt_solve(L, dsc, s, z, rd, rp, rc):
        w = z / s
        rhs = -(rd + ghat_tmv(w * rp - rc / s))
        dx = tri_solve(L, dsc, rhs)
        # iterative refinement against the EXACT K action (matvecs, not the
        # formed matrix)
        for _ in range(refine_steps):
            r2 = rhs - (pmv(dx) + ghat_tmv(w * ghat_mv(dx)))
            dx = dx + tri_solve(L, dsc, r2)
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
        mu = torch.sum(s * z, dim=1) / m

        L, dsc = factor(s, z)

        # predictor (affine)
        dx_a, ds_a, dz_a = kkt_solve(L, dsc, s, z, rd, rp, s * z)
        alpha_p = _max_step(s, ds_a)[:, None]
        alpha_d = _max_step(z, dz_a)[:, None]
        mu_aff = torch.sum((s + alpha_p * ds_a) * (z + alpha_d * dz_a),
                           dim=1) / m
        sigma = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3

        # corrector
        smu = (sigma * mu)[:, None]
        rc = s * z + ds_a * dz_a - smu
        dx, ds, dz = kkt_solve(L, dsc, s, z, rd, rp, rc)
        alpha = torch.minimum(_max_step(s, ds), _max_step(z, dz))[:, None]

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
            dx_c, ds_c, dz_c = kkt_solve(L, dsc, s, z, zero_n, zero_m, drc)
            dx2, ds2, dz2 = dx + dx_c, ds + ds_c, dz + dz_c
            alpha2 = torch.minimum(_max_step(s, ds2),
                                   _max_step(z, dz2))[:, None]
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
        ok = _all_finite(x_new, s_new, z_new)
        okb = ok[:, None]
        return (torch.where(okb, x_new, x), torch.where(okb, s_new, s),
                torch.where(okb, z_new, z), torch.where(okb, rp_new, rp),
                mu, rd, ok)

    rp0 = ghat_mv(x) + s - hhat_s
    hnorm = 1.0 + _norm(hhat_s)
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
            frozen = frozen | stalled | (mu < tol) | ~ok
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
                                        tol, m, hnorm, qnorm)

    # Honest post-hoc convergence certificate (stalls don't count).
    mu_f = torch.sum(s * z, dim=1) / m
    rp_f = _norm(ghat_mv(x) + s - hhat_s)
    rd_f = _norm(pmv(x) + q_s + ghat_tmv(z))
    conv = (mu_f < tol * 10) & (rp_f / hnorm < tol * 100) \
        & (rd_f / qnorm < tol * 100)

    obj = 0.5 * torch.einsum("bi,bij,bj->b", x, P, x) \
        + torch.sum(q * x, dim=1)
    z_unscaled = torch.cat([d_row * z[:, :mg], z[:, mg:]], dim=1) \
        / cost_scale[:, None]
    return QPSolution(x=x, obj=obj, iters=iters, converged=conv, gap=mu_f,
                      z=z_unscaled)


def solve_qp(P, q, G, h, lb, ub, *, max_iter: int = 30, tol: float = 1e-8,
             x0=None, z0=None, fixed_iters: int | None = None,
             cheap_k: bool = False, refine_steps: int = 0,
             correctors: int = 0, axis_name: str | None = None,
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

    Not ported: ``cheap_k``, the row-sharded mode (``axis_name`` /
    ``mg_total``) and the ``banded`` KKT.
    """
    if cheap_k:
        raise NotImplementedError(
            "cheap_k (reduced-precision KKT formation) has no counterpart "
            "in the port: products stay full float32")
    if axis_name is not None or mg_total is not None:
        raise NotImplementedError(
            "row-sharded solve_qp (axis_name / mg_total) not ported yet: "
            "roadmap item 11 (scale-out)")
    if banded is not None:
        raise NotImplementedError(
            "banded KKT path not ported yet: roadmap item 8 (long horizons)")
    if q.ndim == 1:
        def up(t):
            return None if t is None else t[None]
        sol = solve_qp(up(P), up(q), up(G), up(h), up(lb), up(ub),
                       max_iter=max_iter, tol=tol, x0=up(x0), z0=up(z0),
                       fixed_iters=fixed_iters, refine_steps=refine_steps,
                       correctors=correctors)
        return QPSolution(*[t[0] for t in sol])

    # --- equilibration (box rows have exactly unit norm: untouched) ---
    d_row = 1.0 / torch.clamp(torch.linalg.vector_norm(G, dim=2), min=1e-10)
    G_s = G * d_row[:, :, None]
    cost_scale = 1.0 / torch.clamp(P.abs().amax(dim=(1, 2)), min=1.0)
    P_s = P * cost_scale[:, None, None]

    # the matvecs are plain products here, as they are in ``scp_tpu``
    def mv(A, v):
        return torch.bmm(A, v[:, :, None])[:, :, 0]

    return _ipm(P, P_s, q, G_s, h, lb, ub, d_row, cost_scale,
                pmv=lambda x: mv(P_s, x), gmv=lambda x: mv(G_s, x),
                gtmv=lambda v: torch.bmm(v[:, None, :], G_s)[:, 0],
                max_iter=max_iter, tol=tol, x0=x0, z0=z0,
                fixed_iters=fixed_iters, correctors=correctors,
                refine_steps=refine_steps)


def solve_qp_batched(P, q, G, h, lb, ub, *, max_iter: int = 30,
                     tol: float = 1e-8, x0=None, z0=None,
                     fixed_iters: int | None = None,
                     p_blocks=None, correctors: int = 0,
                     slack_schur: bool = False,
                     certificate: bool = True,
                     g_struct: tuple | None = None,
                     g_slabs: tuple | None = None,
                     g_slack_mask=None,
                     kkt: str = "dense") -> QPSolution:
    """Solve a batch of SCP-shaped QPs (leading batch axis B).

    ``q (B, n)``, ``h (B, mg)``, ``lb``/``ub (B, n)``. ``z0``: optional dual
    warm start ``(B, mg + 2n)``; non-positive entries keep the cold start.

    **Fixed iteration count** (``fixed_iters`` set): ``P`` and ``G`` must be
    ``None``; the problem is stated through ``p_blocks (B, V, hu, hu)``
    (P = blockdiag(p_blocks) + a zero slack row, ``n = V*hu + 1``) and
    ``g_slabs = (gi (B,P,K,U), gj (B,P,K,U), gob (B,V,O,K,U) or flat
    (B,S,K,U))`` with ``g_struct = (pairs, obst_veh, hp, hu[, lower_tri])``.
    HARD CONTRACT: every avoidance row's slack coefficient is ``-1`` (0 where
    ``g_slack_mask`` is 0 — a hard row); the equilibration bakes it into each
    row norm. ``certificate=False`` takes the cheap convergence certificate
    (primal residual from the kernel's recurrence). ``kkt="auto"`` resolves
    to the fused dense kernel; a shape beyond its shared-memory gate raises
    ``NotImplementedError`` (the banded path). Without an engaged structure
    this branch raises (the dense-G fused iteration is not ported yet).

    **Adaptive loop** (``fixed_iters=None``): ``G (B, mg, n)`` is the dense
    constraint matrix WITH its own slack column (``g_struct`` / ``g_slabs``
    / ``g_slack_mask`` / ``slack_schur`` are ignored, as in ``scp_tpu``);
    ``P (B, n, n)`` may be ``None`` when ``p_blocks`` states it
    (blockdiag + zero tail). With ``p_blocks`` the dual-residual product
    P @ x runs on the blocks, else through the G-matvec kernel on the dense
    P. Each instance stops on its own (``max_iter``, ``tol``); the
    certificate is always the honest one. ``correctors`` is IGNORED on this
    branch, as in ``scp_tpu``'s lane implementation (``solve_qp`` honours
    it).
    """
    if kkt == "banded":
        raise NotImplementedError(
            "banded KKT path not ported yet: roadmap item 8 (long horizons)")
    if kkt not in ("dense", "auto"):
        raise ValueError(f"unknown kkt {kkt!r}")
    if fixed_iters is None:
        return _solve_qp_batched_adaptive(P, q, G, h, lb, ub,
                                          max_iter=max_iter, tol=tol, x0=x0,
                                          z0=z0, p_blocks=p_blocks)
    if (not slack_schur or p_blocks is None or g_struct is None
            or not g_struct[0] or g_slabs is None):
        raise NotImplementedError(
            "a fixed iteration count needs the structured fused branch "
            "(slack_schur, p_blocks, g_slabs and a g_struct with at least "
            "one pair); the dense-G fused iteration is roadmap item 7b")
    if P is not None or G is not None:
        raise NotImplementedError(
            "dense P / G operands with a fixed iteration count belong to "
            "the dense-G fused iteration (roadmap item 7b); pass P=None, "
            "G=None with p_blocks and g_slabs")

    dtype = q.dtype
    B, mg = h.shape
    n = q.shape[1]
    m = mg + 2 * n
    pairs, obst_veh, hp_s, hu_s, *rest = g_struct
    lower_tri = bool(rest[0]) if rest else False
    nb, d = p_blocks.shape[1], p_blocks.shape[2]
    nu = n - 1
    if nb * d != nu or d != hu_s:
        raise ValueError(
            f"p_blocks {tuple(p_blocks.shape)} does not tile n - 1 = {nu} "
            f"with hu = {hu_s}")

    # --- equilibration (once per solve) ---
    gi_b, gj_b, gob_b = g_slabs
    if gob_b.ndim == 5:
        # (B, V, O, K, U) -> flat (B, S, K, U); v-major order matches the
        # canonical obst_veh enumeration
        gob_b = gob_b.reshape((B, -1) + tuple(gob_b.shape[3:]))
    if gob_b.shape[1] != len(obst_veh):
        raise ValueError("slab count must match g_struct obst_veh")
    if g_slack_mask is None:
        slack_mask = torch.ones((mg,), dtype=dtype, device=q.device)
    else:
        slack_mask = torch.as_tensor(g_slack_mask, dtype=dtype,
                                     device=q.device)
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
    has_obst = gob_b.shape[1] > 0
    gob_c = (gob_b * d_row[:, pk:].reshape(gob_b.shape[:3])[..., None]
             ).contiguous()

    # P == blockdiag(p_blocks) + a zero tail: every P-derived scalar comes
    # from the block statement.
    absmax = p_blocks.abs().amax(dim=(1, 2, 3))
    cost_scale = 1.0 / torch.clamp(absmax, min=1.0)           # (B,)
    tail_diag = torch.zeros((B, n - nu), dtype=dtype, device=q.device)
    p_diag_s = torch.cat(
        [torch.diagonal(p_blocks, dim1=2, dim2=3).reshape(B, nu),
         tail_diag], dim=1) * cost_scale[:, None]
    pb_s = (p_blocks * cost_scale[:, None, None, None]).contiguous()
    q_s = q * cost_scale[:, None]

    pi_idx = torch.tensor([i for i, _ in pairs], dtype=torch.long,
                          device=q.device)
    pj_idx = torch.tensor([j for _, j in pairs], dtype=torch.long,
                          device=q.device)
    ov_idx = torch.tensor(list(obst_veh), dtype=torch.long, device=q.device)

    def gmv(x):                                               # (B,n)->(B,mg)
        xv = x[:, :nu].reshape(B, nb, d)
        rows_p = (torch.einsum("bpku,bpu->bpk", gi_c, xv[:, pi_idx])
                  + torch.einsum("bpku,bpu->bpk", gj_c, xv[:, pj_idx]))
        rows_o = torch.einsum("bsku,bsu->bsk", gob_c, xv[:, ov_idx])
        rows = torch.cat([rows_p.reshape(B, -1), rows_o.reshape(B, -1)],
                         dim=1)
        return rows - d_slack * x[:, nu:]

    def gtmv(v):                                              # (B,mg)->(B,n)
        vp = v[:, :pk].reshape(gi_c.shape[:3])
        vo = v[:, pk:].reshape(gob_c.shape[:3])
        acc = torch.zeros((B, nb, d), dtype=dtype, device=q.device)
        # vehicle indices repeat across pairs: index_add_, not ``+=``
        acc.index_add_(1, pi_idx, torch.einsum("bpku,bpk->bpu", gi_c, vp))
        acc.index_add_(1, pj_idx, torch.einsum("bpku,bpk->bpu", gj_c, vp))
        acc.index_add_(1, ov_idx, torch.einsum("bsku,bsk->bsu", gob_c, vo))
        slack = -torch.sum(d_slack * v, dim=1, keepdim=True)
        return torch.cat([acc.reshape(B, nu), slack], dim=1)

    def pmv(x):
        xb = x[:, :nu].reshape(B, nb, d)
        px = torch.einsum("bvij,bvj->bvi", pb_s, xb)
        return torch.cat([px.reshape(B, nu), p_diag_s[:, nu:] * x[:, nu:]],
                         dim=1)

    # --- initial point ---
    hg = h * d_row
    hl = -lb
    if x0 is None:
        x = torch.zeros((B, n), dtype=dtype, device=q.device)
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
            [d_row, torch.ones((B, 2 * n), dtype=dtype, device=q.device)],
            dim=1)
        z_w = torch.clamp(z_w, min=1e-3, max=1e3)
        zg = torch.where(z0[:, :mg] > 0, z_w[:, :mg], zg)
        zu = torch.where(z0[:, mg:mg + n] > 0, z_w[:, mg:mg + n], zu)
        zl = torch.where(z0[:, mg + n:] > 0, z_w[:, mg + n:], zl)
    scal = torch.zeros((B, 2), dtype=dtype, device=q.device)
    scal[:, 0] = torch.finfo(dtype).max
    # rp carried by the exact (1 - alpha) recurrence inside the kernel
    rpg = gx + sg - hg
    rpu = x + su - ub
    rpl = -x + sl - hl

    reg_rel = 1e-12 if dtype == torch.float64 else 3e-6
    state = tuple(t.contiguous() for t in
                  (x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal))
    out = ipm_kernel.ipm_iterate_struct(
        gi_c, gj_c, gob_c if has_obst else None, (-d_slack).contiguous(),
        pb_s, q_s.contiguous(), p_diag_s.contiguous(), *state,
        pairs=tuple(pairs), obst_veh=tuple(obst_veh), tol=tol,
        reg_rel=reg_rel, n_cor=correctors, n_iters=fixed_iters,
        lower_tri=lower_tri)
    x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal = out
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
        rd = pmv(x) + q_s + gtmv(zg) + zu - zl
        rd_f = torch.linalg.vector_norm(rd, dim=1)
        conv = (mu_f < tol * 10) \
            & (rp_f / (1.0 + hnorm) < tol * 100) \
            & (rd_f / (1.0 + torch.linalg.vector_norm(q_s, dim=1))
               < tol * 100)

    # objective from the block statement (the tail diagonal is zero)
    xq = x[:, :nu].reshape(B, nb, d)
    quad = torch.einsum("bvi,bvij,bvj->b", xq, p_blocks, xq)
    obj = 0.5 * quad + torch.sum(q * x, dim=1)
    z_unscaled = torch.cat([d_row * zg, zu, zl], dim=1) / cost_scale[:, None]
    return QPSolution(x=x, obj=obj, iters=iters, converged=conv, gap=mu_f,
                      z=z_unscaled)


def _solve_qp_batched_adaptive(P, q, G, h, lb, ub, *, max_iter, tol, x0, z0,
                               p_blocks) -> QPSolution:
    """The adaptive branch of :func:`solve_qp_batched` (its docstring states
    the operands): the Mehrotra iteration on instance-major tensors, with
    the factor, the two solves per iteration, the G / G^T products and (on a
    dense P) the P product through ``ops.linalg_kernel``."""
    if G is None:
        raise ValueError(
            "the adaptive branch reads the dense G (B, mg, n), slack column "
            "included; g_slabs alone do not state it")
    if P is None and p_blocks is None:
        raise ValueError("P=None requires p_blocks")
    dtype, device = q.dtype, q.device
    B, _, n = G.shape

    if P is None:
        # the KKT formation reads the dense P: rebuild it from the blocks
        # (blockdiag + zero tail)
        nb_, d_ = p_blocks.shape[1], p_blocks.shape[2]
        P = torch.zeros((B, n, n), dtype=dtype, device=device)
        for vb in range(nb_):
            P[:, vb * d_:(vb + 1) * d_, vb * d_:(vb + 1) * d_] = \
                p_blocks[:, vb]

    # --- equilibration (once per solve) ---
    row_norm = torch.linalg.vector_norm(G, dim=2)              # (B, mg)
    d_row = 1.0 / torch.clamp(row_norm, min=1e-10)
    G_c = (G * d_row[:, :, None]).contiguous()
    if p_blocks is not None:
        # P == blockdiag(p_blocks) + diagonal tail: every P-derived scalar
        # comes from the compact statement
        nb, d = p_blocks.shape[1], p_blocks.shape[2]
        nbd = nb * d
        tail_diag = torch.diagonal(P, dim1=1, dim2=2)[:, nbd:]
        absmax = p_blocks.abs().amax(dim=(1, 2, 3))
        if n > nbd:
            absmax = torch.maximum(absmax, tail_diag.abs().amax(dim=1))
        cost_scale = 1.0 / torch.clamp(absmax, min=1.0)        # (B,)
    else:
        cost_scale = 1.0 / torch.clamp(P.abs().amax(dim=(1, 2)), min=1.0)
    P_s = (P * cost_scale[:, None, None]).contiguous()

    if p_blocks is None:
        def pmv(x):
            return linalg_kernel.gmv(P_s, x.contiguous())
    else:
        pb_s = p_blocks * cost_scale[:, None, None, None]
        ptail = tail_diag * cost_scale[:, None]

        def pmv(x):
            px = torch.einsum("bvij,bvj->bvi", pb_s,
                              x[:, :nbd].reshape(B, nb, d))
            return torch.cat([px.reshape(B, nbd), ptail * x[:, nbd:]], dim=1)

    # ``correctors`` is deliberately not passed on (see solve_qp_batched)
    return _ipm(P, P_s, q, G_c, h, lb, ub, d_row, cost_scale, pmv=pmv,
                gmv=lambda x: linalg_kernel.gmv(G_c, x.contiguous()),
                gtmv=lambda v: linalg_kernel.gtmv(G_c, v),
                max_iter=max_iter, tol=tol, x0=x0, z0=z0, fixed_iters=None,
                correctors=0, refine_steps=0)
