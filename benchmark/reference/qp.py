"""Frozen copy of the fixed-count structured branch of ``solvers/qp.py``
of the PyTorch port (``solve_qp_batched`` with its pair-sparse slabs), for
the benchmark's plain reference; imports nothing of the port. Where the
port hands the iterations to its CUDA kernel K1, this copy runs the
kernel's plain version (``reference/ipm_plain.py``). Other branches of the
port's solver (adaptive, dense-G, banded) are not copied: the benchmark's
configurations take none of them, and a call that would route there raises.

Solves  min_x  0.5 x^T P x + q^T x   s.t.  G x <= h,  lb <= x <= ub
with a Mehrotra predictor-corrector method on Jacobi-scaled normal
equations, rows equilibrated and the cost scaled.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from reference import ipm_plain

class QPSolution(NamedTuple):
    x: torch.Tensor           # (B, n) primal solution
    obj: torch.Tensor         # (B,) 0.5 x^T P x + q^T x (unscaled)
    iters: torch.Tensor       # (B,) iterations used
    converged: torch.Tensor   # (B,) bool
    gap: torch.Tensor         # (B,) final complementarity measure
    z: torch.Tensor           # (B, m + 2n) duals for [G; I; -I] rows (unscaled)


# The precision the configuration states. The reference computes in
# float64, but regularises and nudges as the stated precision's algorithm
# does: those constants are part of the function, not of its rounding.
# ``reference.step.run`` sets it for the call.
PRECISION = torch.float32


def _reg_rel(dtype) -> float:
    """Regularisation relative to the unit KKT diagonal, of the stated
    precision (:data:`PRECISION`), whatever ``dtype`` computes."""
    del dtype
    return 1e-12 if PRECISION == torch.float64 else 3e-6


def _dense_obj(P, q):
    def obj(x):
        return 0.5 * torch.einsum("bi,bij,bj->b", x, P, x) \
            + torch.sum(q * x, dim=1)
    return obj


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


def _structured(g_struct, g_slabs, p_blocks, slack_schur) -> bool:
    """Whether the pair-sparse structure engages the structured kernel: a
    statement with at least one pair, its slabs, the P blocks and the slack
    elimination."""
    return (g_struct is not None and bool(g_struct[0]) and g_slabs is not None
            and p_blocks is not None and slack_schur)


def _route(q, h, G, *, fixed_iters, p_blocks, slack_schur, g_struct,
           g_slabs, banded, kkt) -> str:
    """The only branch this copy holds: the structured fixed-count one."""
    del q, h, G, banded, kkt
    if fixed_iters is None or not _structured(g_struct, g_slabs, p_blocks,
                                              slack_schur):
        raise NotImplementedError(
            "the reference holds only the structured fixed-count branch")
    return "struct"


def solve_qp_batched(P, q, G, h, lb, ub, *, max_iter: int = 30,
                     tol: float = 1e-8, x0=None, z0=None,
                     fixed_iters: int | None = None,
                     p_blocks=None, correctors: int = 0,
                     slack_schur: bool = False,
                     certificate: bool = True,
                     g_struct: tuple | None = None,
                     g_slabs: tuple | None = None,
                     g_slack_mask=None,
                     banded=None,
                     kkt: str = "dense") -> QPSolution:
    """The port's ``solve_qp_batched`` restricted to its structured
    fixed-count branch (see the module docstring)."""
    del max_iter
    _route(q, h, G, fixed_iters=fixed_iters, p_blocks=p_blocks,
           slack_schur=slack_schur, g_struct=g_struct, g_slabs=g_slabs,
           banded=banded, kkt=kkt)
    return _solve_qp_batched_struct(
        P, q, h, lb, ub, tol=tol, x0=x0, z0=z0, fixed_iters=fixed_iters,
        p_blocks=p_blocks, correctors=correctors, certificate=certificate,
        g_struct=g_struct, g_slabs=g_slabs, g_slack_mask=g_slack_mask)


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
    out = ipm_plain.ipm_iterate_struct_plain(
        rows.gi, rows.gj, rows.gob if rows.gob.shape[1] else None,
        (-rows.d_slack).contiguous(), pst.pb_s, q_s.contiguous(),
        pst.p_diag_s.contiguous(), *state,
        pairs=tuple(pairs), obst_veh=tuple(obst_veh), tol=tol,
        reg_rel=_reg_rel(dtype), n_cor=correctors, n_iters=fixed_iters,
        lower_tri=lower_tri)
    return _fused_finish(out, q, h, lb, ub, rows.d_row, pst, rows.gmv,
                         rows.gtmv, tol=tol, fixed_iters=fixed_iters,
                         certificate=certificate)
