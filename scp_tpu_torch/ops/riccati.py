"""Block-banded (Riccati) KKT solve of the condensed SCP Newton system
(counterpart of ``scp_tpu/ops/riccati.py``), on a leading batch axis.

The dense IPM factors ``K = P + G^T W G + D_box`` over the stacked controls,
O((V*hu)^3) per factorization, with a (V*hu)^2 working set that outgrows a
block's shared memory at long horizons. This module solves the SAME linear
system through its multiple-shooting form::

    variables   dx_k (V*NX, k=1..K), du_k (V, k=0..K-1)
    dynamics    dx_{k+1} = A dx_k + B du_k,   dx_0 = 0
    stage cost  1/2 dy_k^T Hy_k dy_k + 1/2 du_k^T Hu_k du_k - r_k^T du_k
                with dy_k = C dx_{k+1}  (positions of stage k+1)

Eliminating dx gives exactly ``K du = r``: the avoidance rows act through the
predicted positions only, so ``G^T W G`` decomposes into per-stage position
Hessians ``Hy_k`` (2V x 2V) and the tracking cost into the same stage form.
A backward Riccati sweep factors the block-tridiagonal system in
O(K (V*NX)^3), linear in the horizon.

:func:`riccati_factor` / :func:`riccati_solve` take CUDA float32 tensors to
the hand-written sweeps (``ops/riccati_kernel.py``, ``csrc/riccati.cu``) and
CPU tensors to the plain versions here (:func:`riccati_factor_plain`,
:func:`riccati_solve_plain`: the scans written as Python loops over the
stages). The small V x V Cholesky clamps its pivots at 1e-30 and never turns
an instance into NaN.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from scp_tpu_torch.config import NX, NY


def chol_small(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of small SPD matrices ``M (..., V, V)``, one
    column at a time; a pivot is ``sqrt(max(s, 1e-30))``."""
    v = M.shape[-1]
    L = torch.zeros_like(M)
    for j in range(v):
        lj = L[..., j, :j]
        s = M[..., j, j] - (lj * lj).sum(-1)
        d = torch.sqrt(torch.clamp(s, min=1e-30))
        L[..., j, j] = d
        if j + 1 < v:
            s2 = M[..., j + 1:, j] - (L[..., j + 1:, :j]
                                      * lj[..., None, :]).sum(-1)
            L[..., j + 1:, j] = s2 / d[..., None]
    return L


def chol_solve_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``(L L^T) x = b``, ``L (..., V, V)`` lower, ``b (..., V)`` or
    ``(..., V, M)``: the two triangular substitutions, each one batched
    call (``torch.linalg.solve_triangular``), so that a wide V costs no more
    launches than a narrow one."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    y = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0] if vec else x


@functools.lru_cache(maxsize=64)
def _pair_tables(pairs: tuple, v: int, device: torch.device) -> tuple:
    """Index tables of :func:`build_hy` on ``device``: ``tab (V, n)``, the
    pairs that add to vehicle v's diagonal block, in pair order (padded
    with P, a zero block), and ``(oi, oj, op)``: each pair's two
    off-diagonal blocks (i, j) and (j, i) and the pair that fills them.
    Refuses a pair of a vehicle with itself and a repeated pair."""
    per = [[] for _ in range(v)]
    for p, (i, j) in enumerate(pairs):
        if i == j:
            raise ValueError(f"pair {p} joins vehicle {i} with itself")
        per[i].append(p)
        per[j].append(p)
    blocks = [(i, j) for i, j in pairs] + [(j, i) for i, j in pairs]
    if len(set(blocks)) != len(blocks):
        raise ValueError("a vehicle pair is listed twice")
    n = max(len(x) for x in per)
    tab = [x + [len(pairs)] * (n - len(x)) for x in per]
    idx = lambda a: torch.tensor(a, dtype=torch.long, device=device)
    return (idx(tab), idx([b[0] for b in blocks]),
            idx([b[1] for b in blocks]), idx(list(range(len(pairs))) * 2))


def build_hy(pairs: tuple, y_pair: torch.Tensor, y_obst: torch.Tensor,
             w_pair: torch.Tensor, w_obst: torch.Tensor,
             qy_stage: torch.Tensor) -> torch.Tensor:
    """Per-stage position Hessians ``Hy (B, K, 2V, 2V)``.

    ``y_pair (B, P, K, NY)``: position coefficient of pair row (p, k), which
    acts as ``y·dy_k^i - y·dy_k^j`` for ``pairs[p] = (i, j)``;
    ``y_obst (B, V, O, K, NY)``: obstacle-row coefficients; ``w_pair (B, P,
    K)`` / ``w_obst (B, V, O, K)``: the IPM's barrier weights of those rows,
    already multiplied by the squared equilibration scale; ``qy_stage (B, V,
    K)``: diagonal tracking weight per vehicle and stage.

    Pair p adds ``w y y^T`` to the diagonal blocks (i, i) and (j, j) and
    subtracts it from (i, j) and (j, i); each diagonal block sums its pairs'
    terms in pair order, then the obstacle rows', then the tracking weight
    (``scp_tpu``'s order), a few batched operations whatever the number of
    pairs.
    """
    b, v, o, k, _ = y_obst.shape
    blocks = y_obst.new_zeros((b, k, v, v, NY, NY))   # blocks[.., i, j, a, c]
    diag = y_obst.new_zeros((b, k, v, NY, NY))
    if pairs:
        tab, oi, oj, op = _pair_tables(tuple(pairs), v, y_obst.device)
        wyy = ((w_pair[..., None, None] * y_pair[..., :, None])
               * y_pair[..., None, :]).transpose(1, 2)    # (B, K, P, NY, NY)
        wyy0 = torch.cat([wyy, wyy.new_zeros((b, k, 1, NY, NY))], 2)
        for s in range(tab.shape[1]):
            diag = diag + wyy0[:, :, tab[:, s]]
        blocks[:, :, oi, oj] = -wyy[:, :, op]
    if o:
        diag = diag + torch.einsum("bvok,bvoka,bvokc->bvkac", w_obst, y_obst,
                                   y_obst).transpose(1, 2)
    for a in range(NY):
        diag[..., a, a] += qy_stage.transpose(1, 2)
    ar = torch.arange(v, device=y_obst.device)
    blocks[:, :, ar, ar] = diag
    return blocks.transpose(3, 4).reshape(b, k, v * NY, v * NY)


class RiccatiFactor(NamedTuple):
    """Per-stage factorization of the block-banded KKT (axes B, K)."""
    f: torch.Tensor     # (B, K, V, V, NX)  F_k = B^T Ptilde_{k+1} A
    lh: torch.Tensor    # (B, K, V, V)      chol(Hu_k + B^T Ptilde_{k+1} B)
    kg: torch.Tensor    # (B, K, V, V, NX)  gain (Hm)^{-1} F_k


def riccati_factor_plain(a_blk: torch.Tensor, b_blk: torch.Tensor,
                         hy: torch.Tensor,
                         hu_diag: torch.Tensor) -> RiccatiFactor:
    """Backward Riccati sweep over the stage Hessians (the scan as a loop).

    ``a_blk (B, V, NX, NX)`` / ``b_blk (B, V, NX)``: per-vehicle discrete
    dynamics (the same at every stage); ``hy (B, K, 2V, 2V)`` from
    :func:`build_hy`; ``hu_diag (B, K, V)``: per-stage diagonal input
    Hessian. The cost-to-go is symmetrised after every stage.
    """
    bsz, v = a_blk.shape[:2]
    k = hy.shape[1]
    w = v * NX
    P = hy.new_zeros((bsz, w, w))
    f, lh, kg = [None] * k, [None] * k, [None] * k
    for kk in reversed(range(k)):
        # positions are entries 0:NY of each vehicle's NX block
        Pt5 = P.reshape(bsz, v, NX, v, NX).clone()
        Pt5[:, :, :NY, :, :NY] += hy[:, kk].reshape(bsz, v, NY, v, NY)
        T = torch.einsum("bvj,bvjwk->bvwk", b_blk, Pt5)       # (B, V, V, NX)
        F = torch.einsum("bvwj,bwjk->bvwk", T, a_blk)
        Hm = torch.einsum("bvwk,bwk->bvw", T, b_blk) \
            + torch.diag_embed(hu_diag[:, kk])
        Lh = chol_small(Hm)
        Ff = F.reshape(bsz, v, w)
        Kg = chol_solve_small(Lh, Ff)                         # (B, V, W)
        # P_k = A^T Ptilde A - F^T Hm^-1 F
        PA = torch.einsum("bviwj,bwjk->bviwk", Pt5, a_blk)
        AtPA = torch.einsum("bvji,bvjwk->bviwk", a_blk, PA).reshape(bsz, w, w)
        Pk = AtPA - Ff.transpose(1, 2) @ Kg
        P = 0.5 * (Pk + Pk.transpose(1, 2))
        f[kk], lh[kk], kg[kk] = F, Lh, Kg.reshape(bsz, v, v, NX)
    return RiccatiFactor(f=torch.stack(f, 1), lh=torch.stack(lh, 1),
                         kg=torch.stack(kg, 1))


def riccati_solve_plain(f: torch.Tensor, lh: torch.Tensor, kg: torch.Tensor,
                        a_blk: torch.Tensor, b_blk: torch.Tensor,
                        r: torch.Tensor) -> torch.Tensor:
    """Solve the factored banded KKT for the stage linear terms ``r (B, K,
    V)`` (the u-space right-hand side, stage-major). Returns ``du (B, K,
    V)``: a backward sweep of the value function's linear term
    ``p_k = A^T p_{k+1} + F_k^T kff_k`` with ``kff_k = -Hm^-1 (B^T p_{k+1}
    - r_k)``, then the forward rollout ``du_k = kff_k - Kg_k x_k``.
    ``r (n_rhs, B, K, V)`` solves each right-hand side against the same
    factor and returns ``du`` of that shape."""
    if r.ndim == 4:
        return torch.stack([riccati_solve_plain(f, lh, kg, a_blk, b_blk, ri)
                            for ri in r])
    bsz, k, v = r.shape
    p = r.new_zeros((bsz, v, NX))
    kff = [None] * k
    for kk in reversed(range(k)):
        g = torch.einsum("bvj,bvj->bv", b_blk, p) - r[:, kk]
        kf = -chol_solve_small(lh[:, kk], g)
        p = torch.einsum("bvjk,bvj->bvk", a_blk, p) \
            + torch.einsum("bvwk,bv->bwk", f[:, kk], kf)
        kff[kk] = kf
    x = r.new_zeros((bsz, v, NX))
    du = []
    for kk in range(k):
        u = kff[kk] - torch.einsum("bvwk,bwk->bv", kg[:, kk], x)
        x = torch.einsum("bvkj,bvj->bvk", a_blk, x) + b_blk * u[..., None]
        du.append(u)
    return torch.stack(du, 1)


def riccati_factor(a_blk: torch.Tensor, b_blk: torch.Tensor, hy: torch.Tensor,
                   hu_diag: torch.Tensor) -> RiccatiFactor:
    """The backward Riccati sweep of :func:`riccati_factor_plain`: the
    hand-written kernel for CUDA float32 tensors, the plain version for CPU
    tensors (``ops/riccati_kernel.py`` decides)."""
    from scp_tpu_torch.ops import riccati_kernel  # it imports this module
    return RiccatiFactor(*riccati_kernel.riccati_factor(
        a_blk, b_blk, hy, hu_diag))


def riccati_solve(fac: RiccatiFactor, a_blk: torch.Tensor,
                  b_blk: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The banded solve of :func:`riccati_solve_plain` against
    :func:`riccati_factor`'s factors (kernel or plain version, as there);
    ``r (B, K, V)`` or two right-hand sides ``r (2, B, K, V)`` in one
    launch."""
    from scp_tpu_torch.ops import riccati_kernel  # it imports this module
    return riccati_kernel.riccati_solve(fac.f, fac.lh, fac.kg, a_blk, b_blk,
                                        r)
