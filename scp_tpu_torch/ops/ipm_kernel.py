"""Fused structured IPM iterations: the Hopper kernel's wrapper and its plain
PyTorch version (counterpart of ``scp_tpu/ops/pallas_linalg.py::
ipm_iterate_lane_struct``).

All ``n_iters`` Mehrotra predictor-corrector iterations of every QP of a
batch run in one call: slab matvecs, the analytic KKT diagonal, the
Jacobi-scaled KKT matrix formed from the pair / obstacle row slabs + the
block-diagonal P + the box diagonal, a rank-1 Schur elimination of the slack
variable, a Cholesky on ``nu = n - 1`` columns, predictor + corrector
(+ ``n_cor`` Gondzio correctors), step lengths, ``sigma = (mu_aff/mu)^3``,
the exact ``(1 - alpha)`` primal-residual recurrence and per-instance
freeze on stall / convergence / non-finite steps.

Tensors are instance-major (``(B, ...)`` contiguous per instance); none of
the TPU tiling (lane layout, ``hu8`` / ``mg_pad`` / ``n_pad`` padding, row
masks) exists here. Argument layout, with ``n = V*hu + 1`` (the slack is the
last variable), ``mg = (P + S) * hp``:

* ``gi, gj (B, P, hp, hu)`` — pair rows restricted to the pair's two vehicle
  blocks; ``gob (B, S, hp, hu)`` or ``None`` — single-block (obstacle)
  slabs; ``gsl (B, mg)`` — the equilibrated slack column (0 = hard row);
* ``pb (B, V, hu, hu)`` — block-diagonal P; ``q, pdiag (B, n)``;
* state ``x, su, sl, zu, zl, rpu, rpl (B, n)``, ``sg, zg, rpg (B, mg)``,
  ``scal (B, 2) = [mu of the previous iteration, frozen flag]``;
* ``pairs`` — sequence of ``(i, j)`` vehicle pairs (i < j), ``obst_veh`` —
  the vehicle of each single-block slab.

:func:`ipm_iterate_struct` launches the CUDA kernel for CUDA tensors and
raises if it cannot; for CPU tensors it takes :func:`ipm_iterate_struct_plain`.
The kernel library is built with ``nvcc`` from ``scp_tpu_torch/csrc`` at first
use (``ops/_cuda_build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from scp_tpu_torch.ops import _cuda_build
from scp_tpu_torch.ops._cuda_build import SMEM_LIMIT_BYTES

# Launches of the CUDA kernel since the last reset (incremented where the
# kernel is launched and nowhere else).
launch_count = 0

_tables: dict = {}


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def smem_bytes(P: int, S: int, hp: int, hu: int, V: int) -> int:
    """Dynamic shared memory of the kernel for a shape (mirrors the carve in
    ``csrc/ipm_struct.cu::smem_words``)."""
    nu = V * hu
    n = nu + 1
    mg = (P + S) * hp
    m = mg + 2 * n
    ldk = nu | 1
    words = (nu * ldk + 2 * P * hp * hu + S * hp * hu + V * hu * hu + mg
             + 9 * m + 9 * n + 64 + V * V + 2 * P + S)
    return 4 * words


def check_smem_gate(P: int, S: int, hp: int, hu: int, V: int) -> int:
    """The port's gate for the fused dense kernel: shapes whose per-instance
    working set exceeds a block's shared memory are refused loudly (this is
    where the banded KKT path will take over under ``qp_kkt="auto"``)."""
    need = smem_bytes(P, S, hp, hu, V)
    if need > SMEM_LIMIT_BYTES:
        raise NotImplementedError(
            f"banded KKT path not ported yet: the fused dense IPM kernel "
            f"needs {need} bytes of shared memory per instance at P={P}, "
            f"S={S}, hp={hp}, hu={hu}, V={V} (limit {SMEM_LIMIT_BYTES})")
    return need


def _launcher():
    """The library's ``ipm_struct_launch`` with its argument types set."""
    fn = _cuda_build.load_library().ipm_struct_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p] * 18 + [p, p] + [p] * 11 + [i] * 9 + [f] * 3
                       + [ctypes.c_long, p])
        fn.restype = ctypes.c_int
    return fn


def _index_tables(pairs, obst_veh, device):
    key = (tuple(pairs), tuple(obst_veh), str(device))
    if key not in _tables:
        pt = torch.tensor([list(p) for p in pairs], dtype=torch.int32,
                          device=device).reshape(-1, 2).contiguous()
        ot = torch.tensor(list(obst_veh), dtype=torch.int32, device=device)
        _tables[key] = (pt, ot)
    return _tables[key]


def _check_shapes(gi, gj, gob, gsl, pb, q, pdiag, state, pairs, obst_veh):
    B, P, hp, hu = gi.shape
    V = pb.shape[1]
    S = 0 if gob is None else gob.shape[1]
    n = V * hu + 1
    mg = (P + S) * hp
    x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal = state
    want = {
        "gj": (gj, (B, P, hp, hu)), "gsl": (gsl, (B, mg)),
        "pb": (pb, (B, V, hu, hu)), "q": (q, (B, n)),
        "pdiag": (pdiag, (B, n)), "x": (x, (B, n)), "sg": (sg, (B, mg)),
        "su": (su, (B, n)), "sl": (sl, (B, n)), "zg": (zg, (B, mg)),
        "zu": (zu, (B, n)), "zl": (zl, (B, n)), "rpg": (rpg, (B, mg)),
        "rpu": (rpu, (B, n)), "rpl": (rpl, (B, n)), "scal": (scal, (B, 2)),
    }
    if gob is not None:
        want["gob"] = (gob, (B, S, hp, hu))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
        if t.dtype != gi.dtype or t.device != gi.device:
            raise ValueError(f"{name}: dtype/device differ from gi's")
    if len(pairs) != P or len(obst_veh) != S:
        raise ValueError("pairs / obst_veh do not match the slab counts")
    if P == 0:
        raise ValueError("the structured kernel needs at least one pair slab")
    for i, j in pairs:
        if not 0 <= i < j < V:
            raise ValueError(f"pair {(i, j)} is not i < j < V={V}")
    if any(not 0 <= v < V for v in obst_veh):
        raise ValueError("obst_veh names a vehicle outside [0, V)")
    return B, P, S, hp, hu, V, n, mg


def ipm_iterate_struct(gi, gj, gob, gsl, pb, q, pdiag,
                       x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal,
                       *, pairs, obst_veh, tol: float, reg_rel: float,
                       n_cor: int = 0, n_iters: int = 1,
                       lower_tri: bool = False):
    """Run ``n_iters`` fused Mehrotra iterations; returns the updated
    ``(x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal)``.

    CUDA tensors (float32, contiguous) go to the hand-written kernel —
    there is no fallback: a failing build, load or launch raises. CPU
    tensors go to :func:`ipm_iterate_struct_plain`.
    """
    state = (x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal)
    if gi.device.type != "cuda":
        return ipm_iterate_struct_plain(
            gi, gj, gob, gsl, pb, q, pdiag, *state, pairs=pairs,
            obst_veh=obst_veh, tol=tol, reg_rel=reg_rel, n_cor=n_cor,
            n_iters=n_iters, lower_tri=lower_tri)
    global launch_count
    B, P, S, hp, hu, V, n, mg = _check_shapes(
        gi, gj, gob, gsl, pb, q, pdiag, state, pairs, obst_veh)
    if gi.dtype != torch.float32:
        raise TypeError(
            f"the CUDA IPM kernel is float32 only, got {gi.dtype}")
    ins = [gi, gj, gob, gsl, pb, q, pdiag, *state]
    for t in ins:
        if t is not None and not t.is_contiguous():
            raise ValueError("the CUDA IPM kernel needs contiguous tensors")
    need = check_smem_gate(P, S, hp, hu, V)
    launch = _launcher()
    pt, ot = _index_tables(pairs, obst_veh, gi.device)
    outs = [torch.empty_like(t) for t in state]
    ptr = [0 if t is None else t.data_ptr() for t in ins]
    with torch.cuda.device(gi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            *ptr, pt.data_ptr(), ot.data_ptr() if S else 0,
            *[t.data_ptr() for t in outs],
            B, P, S, hp, hu, V, int(n_iters), int(n_cor), int(lower_tri),
            float(tol), float(tol * 1e3), float(reg_rel), need, stream)
    if err != 0:
        raise RuntimeError(
            f"ipm_struct_launch failed with CUDA error {err} "
            f"(B={B}, P={P}, S={S}, hp={hp}, hu={hu}, V={V}, smem={need})")
    launch_count += 1
    return tuple(outs)


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


def ipm_iterate_struct_plain(gi, gj, gob, gsl, pb, q, pdiag,
                             x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal,
                             *, pairs, obst_veh, tol: float, reg_rel: float,
                             n_cor: int = 0, n_iters: int = 1,
                             lower_tri: bool = False):
    """Plain PyTorch version of :func:`ipm_iterate_struct` (float32 or
    float64, any device): the same function through dense batched algebra
    and ``torch.linalg`` — an oracle, not a fast path. ``lower_tri`` only
    lets the kernel skip exact zeros, so it is ignored here."""
    del lower_tri
    B, P, hp, hu = gi.shape
    V = pb.shape[1]
    nu = V * hu
    n = nu + 1
    mg = gsl.shape[1]
    m = mg + 2 * n
    dtype = gi.dtype
    inf = torch.full((), float("inf"), dtype=dtype, device=gi.device)

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

    def steplen(v, dv):
        neg = dv < 0
        ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                            inf)
        return torch.clamp(0.99 * ratio.amin(dim=1), max=1.0)

    def steplen3(vs, dvs):
        out = steplen(vs[0], dvs[0])
        for v, dv in zip(vs[1:], dvs[1:]):
            out = torch.minimum(out, steplen(v, dv))
        return out

    inv_kappa = 1.0 / (1.0 + reg_rel)
    mu_prev = scal[:, 0].clone()
    frozen = scal[:, 1] > 0.5
    mu = mu_prev
    for _ in range(n_iters):
        px = torch.cat([torch.einsum("bij,bj->bi", Pfull, x[:, :nu]),
                        pdiag[:, nu:] * x[:, nu:]], dim=1)
        wg, wu, wl = zg / sg, zu / su, zl / sl
        mu = (torch.sum(sg * zg, 1) + torch.sum(su * zu + sl * zl, 1)) / m

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
        L, info = torch.linalg.cholesky_ex(K)
        # a failed factorization poisons the step (NaN), which the finite
        # check below turns into a freeze — as a NaN pivot does in a kernel
        L = torch.where((info != 0)[:, None, None],
                        torch.full_like(L, float("nan")), L)

        def solve_kkt(rhs):
            rt = dsc * rhs
            rw = rt[:, nu:]
            ru = rt[:, :nu] - kb * (inv_kappa * rw)
            y = torch.cholesky_solve(ru[:, :, None], L)[:, :, 0]
            xw = (rw - torch.sum(kb * y, 1, keepdim=True)) * inv_kappa
            return dsc * torch.cat([y, xw], dim=1)

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
        a_p = steplen3((sg, su, sl), (dsg_a, dsu_a, dsl_a))[:, None]
        a_d = steplen3((zg, zu, zl), (dzg_a, dzu_a, dzl_a))[:, None]
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
            steplen3((sg, su, sl), (dsg, dsu, dsl)),
            steplen3((zg, zu, zl), (dzg, dzu, dzl)))[:, None]

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
                steplen3((sg, su, sl), (dsg2, dsu2, dsl2)),
                steplen3((zg, zu, zl), (dzg2, dzu2, dzl2)))[:, None]
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
        mu_prev = mu
    scal_out = torch.stack([mu, frozen.to(dtype)], dim=1)
    return (x, sg, su, sl, zg, zu, zl, rpg, rpu, rpl, scal_out)
