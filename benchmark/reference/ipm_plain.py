"""Frozen copy of the plain version of K1 (``ops/ipm_kernel.py``:
``ipm_iterate_struct_plain`` and its helpers) of the PyTorch port: the fused
Mehrotra iterations through dense batched algebra and ``torch.linalg``, for
the benchmark's plain reference; imports nothing of the port."""
from __future__ import annotations

import torch


def _scatter_dense(gi, gj, gob, pairs, obst_veh, V):
    """Dense (B, mg, nu) constraint block from the slabs."""
    B, P, hp, hu = gi.shape
    S = 0 if gob is None else gob.shape[1]
    G = gi.new_zeros((B, P + S, hp, V, hu))
    for p, (i, j) in enumerate(pairs):
        G[:, p, :, i] = gi[:, p]
        G[:, p, :, j] = gj[:, p]
    for o, v in enumerate(obst_veh):
        G[:, P + o, :, v] = gob[:, o]
    return G.reshape(B, (P + S) * hp, V * hu)


def _steplen(v, dv):
    neg = dv < 0
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        inf)
    return torch.clamp(0.99 * ratio.amin(dim=1), max=1.0)


def _steplen3(vs, dvs):
    out = _steplen(vs[0], dvs[0])
    for v, dv in zip(vs[1:], dvs[1:]):
        out = torch.minimum(out, _steplen(v, dv))
    return out


def _plain_factor(K):
    """Cholesky of the scaled KKT matrices; a failed factorization poisons
    the instance (NaN), which the step's finite check turns into a freeze —
    as a NaN pivot does in a kernel."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[:, None, None],
                       torch.full_like(L, float("nan")), L)


def _plain_solver(L, dsc, kb, inv_kappa):
    """``dx = K^-1 rhs`` through the Jacobi scaling and, with a border
    ``kb`` (the eliminated slack, the last variable), the bordered
    back-substitution; ``kb=None`` factors every variable."""
    if kb is None:
        def solve_kkt(rhs):
            rt = (dsc * rhs)[:, :, None]
            return dsc * torch.cholesky_solve(rt, L)[:, :, 0]
        return solve_kkt
    nu = kb.shape[1]

    def solve_kkt(rhs):
        rt = dsc * rhs
        rw = rt[:, nu:]
        ru = rt[:, :nu] - kb * (inv_kappa * rw)
        y = torch.cholesky_solve(ru[:, :, None], L)[:, :, 0]
        xw = (rw - torch.sum(kb * y, 1, keepdim=True)) * inv_kappa
        return dsc * torch.cat([y, xw], dim=1)
    return solve_kkt


def _plain_step(state, frozen, mu_prev, *, px, q, mu, m, gmv, gtmv,
                solve_kkt, tol, n_cor):
    """One Mehrotra predictor-corrector step on a factored KKT matrix — the
    step algebra both fused kernels share (``csrc/ipm_common.cuh``): predictor,
    corrector, ``n_cor`` Gondzio correctors with per-instance acceptance,
    step lengths, ``sigma = (mu_aff / mu)^3``, the ``(1 - alpha)`` residual
    recurrence and freeze on stall / convergence / a non-finite step.
    Returns the updated state and frozen flags."""
    x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl = state
    wg, wu, wl = zg / sg, zu / su, zl / sl

    def newton(tg, tu, tl):
        rhs = -(px + q + gtmv(zg + tg) + (zu + tu) - (zl + tl))
        dx = solve_kkt(rhs)
        return dx, gmv(dx)

    # predictor
    dx_a, gdx_a = newton(wg * rpg - zg, wu * rpu - zu, wl * rpl - zl)
    dzg_a = wg * (gdx_a + rpg) - zg
    dzu_a = wu * (dx_a + rpu) - zu
    dzl_a = wl * (-dx_a + rpl) - zl
    dsg_a = -sg - sg * dzg_a / zg
    dsu_a = -su - su * dzu_a / zu
    dsl_a = -sl - sl * dzl_a / zl
    a_p = _steplen3((sg, su, sl), (dsg_a, dsu_a, dsl_a))[:, None]
    a_d = _steplen3((zg, zu, zl), (dzg_a, dzu_a, dzl_a))[:, None]
    mu_aff = (torch.sum((sg + a_p * dsg_a) * (zg + a_d * dzg_a), 1)
              + torch.sum((su + a_p * dsu_a) * (zu + a_d * dzu_a)
                          + (sl + a_p * dsl_a) * (zl + a_d * dzl_a), 1)
              ) / m
    sigma = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3
    smu = (sigma * mu)[:, None]

    # corrector
    rcg = sg * zg + dsg_a * dzg_a - smu
    rcu = su * zu + dsu_a * dzu_a - smu
    rcl = sl * zl + dsl_a * dzl_a - smu
    dx, gdx = newton(wg * rpg - rcg / sg, wu * rpu - rcu / su,
                     wl * rpl - rcl / sl)
    dzg = wg * (gdx + rpg) - rcg / sg
    dzu = wu * (dx + rpu) - rcu / su
    dzl = wl * (-dx + rpl) - rcl / sl
    dsg = -(rcg + sg * dzg) / zg
    dsu = -(rcu + su * dzu) / zu
    dsl = -(rcl + sl * dzl) / zl
    alpha = torch.minimum(
        _steplen3((sg, su, sl), (dsg, dsu, dsl)),
        _steplen3((zg, zu, zl), (dzg, dzu, dzl)))[:, None]

    # Gondzio centrality correctors with per-instance acceptance
    for _ in range(n_cor):
        at = torch.clamp(alpha + 0.1, max=1.0)
        lo, hi = 0.1 * smu, 10.0 * smu

        def drc(v):
            return v - torch.minimum(torch.maximum(v, lo), hi)

        drg_c = drc((sg + at * dsg) * (zg + at * dzg))
        dru_c = drc((su + at * dsu) * (zu + at * dzu))
        drl_c = drc((sl + at * dsl) * (zl + at * dzl))
        tg, tu, tl = -drg_c / sg, -dru_c / su, -drl_c / sl
        dxc = solve_kkt(-(gtmv(tg) + tu - tl))
        gdxc = gmv(dxc)
        dzg_c, dzu_c, dzl_c = wg * gdxc + tg, wu * dxc + tu, -wl * dxc + tl
        dsg_c = -(drg_c + sg * dzg_c) / zg
        dsu_c = -(dru_c + su * dzu_c) / zu
        dsl_c = -(drl_c + sl * dzl_c) / zl
        dx2 = dx + dxc
        dzg2, dzu2, dzl2 = dzg + dzg_c, dzu + dzu_c, dzl + dzl_c
        dsg2, dsu2, dsl2 = dsg + dsg_c, dsu + dsu_c, dsl + dsl_c
        alpha2 = torch.minimum(
            _steplen3((sg, su, sl), (dsg2, dsu2, dsl2)),
            _steplen3((zg, zu, zl), (dzg2, dzu2, dzl2)))[:, None]
        acc = alpha2 >= alpha + 0.01
        dx = torch.where(acc, dx2, dx)
        dzg, dzu, dzl = (torch.where(acc, a, b) for a, b in
                         ((dzg2, dzg), (dzu2, dzu), (dzl2, dzl)))
        dsg, dsu, dsl = (torch.where(acc, a, b) for a, b in
                         ((dsg2, dsg), (dsu2, dsu), (dsl2, dsl)))
        alpha = torch.where(acc, alpha2, alpha)

    new = [x + alpha * dx, sg + alpha * dsg, su + alpha * dsu,
           sl + alpha * dsl, zg + alpha * dzg, zu + alpha * dzu,
           zl + alpha * dzl]
    ok = torch.ones_like(frozen)
    for t in new:
        ok = ok & torch.isfinite(t).all(dim=1)

    stalled = (mu > 0.7 * mu_prev) & (mu < tol * 1e3)
    converged = mu < tol
    frozen = frozen | stalled | converged | ~ok
    keep = ~frozen[:, None]
    x, sg, su, sl, zg, zu, zl = (
        torch.where(keep, a, b)
        for a, b in zip(new, (x, sg, su, sl, zg, zu, zl)))
    shrink = 1.0 - alpha
    rpg = torch.where(keep, shrink * rpg, rpg)
    rpu = torch.where(keep, shrink * rpu, rpu)
    rpl = torch.where(keep, shrink * rpl, rpl)
    return (x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl), frozen


def _mu_of(sg, zg, su, zu, sl, zl, m):
    return (torch.sum(sg * zg, 1) + torch.sum(su * zu + sl * zl, 1)) / m


def ipm_iterate_struct_plain(gi, gj, gob, gsl, pb, q, pdiag,
                             x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal,
                             *, pairs, obst_veh, tol: float, reg_rel: float,
                             n_cor: int = 0, n_iters: int = 1,
                             lower_tri: bool = False,
                             tier: str | None = None):
    """Plain PyTorch version of :func:`ipm_iterate_struct` (float32 or
    float64, any device), of every storage tier: the same function
    through dense batched algebra and ``torch.linalg`` — an oracle, not a
    fast path. ``lower_tri`` only lets the kernel skip exact zeros and
    ``tier`` only says where it keeps its working set, so both are ignored
    here."""
    del lower_tri, tier
    B, P, hp, hu = gi.shape
    V = pb.shape[1]
    nu = V * hu
    n = nu + 1
    mg = gsl.shape[1]
    m = mg + 2 * n

    Gu = _scatter_dense(gi, gj, gob, pairs, obst_veh, V)     # (B, mg, nu)
    Pd = torch.block_diag(*[torch.ones(hu, hu)] * V).to(gi.device) > 0
    Pfull = gi.new_zeros((B, nu, nu))
    Pfull[:, Pd] = pb.reshape(B, -1)
    eye = torch.eye(nu, dtype=torch.bool, device=gi.device)

    def gmv(v):                                   # (B, n) -> (B, mg)
        return torch.einsum("bmn,bn->bm", Gu, v[:, :nu]) + gsl * v[:, nu:]

    def gtmv(w):                                  # (B, mg) -> (B, n)
        return torch.cat([torch.einsum("bmn,bm->bn", Gu, w),
                          torch.sum(gsl * w, dim=1, keepdim=True)], dim=1)

    inv_kappa = 1.0 / (1.0 + reg_rel)
    mu_prev = scal[:, 0].clone()
    frozen = scal[:, 1] > 0.5
    mu = mu_prev
    state = (x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl)
    for _ in range(n_iters):
        x, sg, su, sl, zg, zu, zl = state[:7]
        px = torch.cat([torch.einsum("bij,bj->bi", Pfull, x[:, :nu]),
                        pdiag[:, nu:] * x[:, nu:]], dim=1)
        wg, wu, wl = zg / sg, zu / su, zl / sl
        mu = _mu_of(sg, zg, su, zu, sl, zl, m)

        # analytic diagonal, Jacobi scale
        gsq = torch.cat([torch.einsum("bm,bmn->bn", wg, Gu * Gu),
                         torch.sum(wg * gsl * gsl, 1, keepdim=True)], dim=1)
        dk = pdiag + gsq + (wu + wl)
        dsc = torch.rsqrt(torch.clamp(dk, min=1e-30))
        # scaled border of the eliminated slack
        kuw = gtmv(wg * gsl)
        kb = (dsc * kuw * dsc[:, nu:])[:, :nu]
        # scaled, bordered KKT matrix; its diagonal is analytic
        K = Pfull + torch.einsum("bmi,bm,bmj->bij", Gu, wg, Gu)
        K = K * (dsc[:, :nu, None] * dsc[:, None, :nu]) \
            - inv_kappa * kb[:, :, None] * kb[:, None, :]
        dval = (1.0 + reg_rel) - inv_kappa * kb * kb
        K = torch.where(eye, torch.diag_embed(dval), K)
        solve_kkt = _plain_solver(_plain_factor(K), dsc, kb, inv_kappa)
        state, frozen = _plain_step(
            state, frozen, mu_prev, px=px, q=q, mu=mu, m=m, gmv=gmv,
            gtmv=gtmv, solve_kkt=solve_kkt, tol=tol, n_cor=n_cor)
        mu_prev = mu
    scal_out = torch.stack([mu, frozen.to(gi.dtype)], dim=1)
    return state + (scal_out,)


# ---------------------------------------------------------------------------
# the dense-G fused iterations (K2)
# ---------------------------------------------------------------------------
