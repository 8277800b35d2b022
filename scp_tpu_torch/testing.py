"""Numpy-seeded test data for the fused IPM kernel, shared by the CPU tests and
``chip_smoke.py`` (which must not import the test tree)."""
from __future__ import annotations

import numpy as np

KERNEL_ARG_ORDER = ("gi", "gj", "gob", "gsl", "pb", "q", "pdiag", "x", "sg",
                    "su", "sl", "zg", "zu", "zl", "rpg", "rpu", "rpl", "scal")
STATE_NAMES = KERNEL_ARG_ORDER[7:]


def kernel_inputs(B, V, hp, hu, n_obst, seed, pairs=None, hard_rows=False,
                  dtype=np.float32):
    """SCP-shaped QP data in the instance-major argument layout of
    ``ops.ipm_kernel.ipm_iterate_struct``: equilibrated lower-triangular
    slabs, unit-scaled block-diagonal P, a cold start at x = 0 with soft rows
    partly violated (so the slack has to work) and, with ``hard_rows``, every
    fifth row hard (zero slack coefficient, strictly feasible at x = 0).
    Returns ``(dict of numpy arrays keyed by KERNEL_ARG_ORDER, pairs,
    obst_veh)``."""
    rng = np.random.default_rng(seed)
    if pairs is None:
        pairs = tuple((i, j) for i in range(V) for j in range(i + 1, V))
    obst_veh = tuple(v for v in range(V) for _ in range(n_obst))
    P, S = len(pairs), len(obst_veh)
    n = V * hu + 1
    mg = (P + S) * hp
    tri = np.tril(np.ones((hp, hu)))
    gi = rng.normal(size=(B, P, hp, hu)) * 0.3 * tri
    gj = rng.normal(size=(B, P, hp, hu)) * 0.3 * tri
    gob = rng.normal(size=(B, S, hp, hu)) * 0.3 * tri
    gsl = -np.ones((B, mg))
    if hard_rows:
        gsl[:, ::5] = 0.0
    norm = np.sqrt(np.concatenate(
        [((gi ** 2).sum(-1) + (gj ** 2).sum(-1)).reshape(B, -1),
         (gob ** 2).sum(-1).reshape(B, -1)], 1) + gsl ** 2)
    d_row = 1.0 / norm
    gi *= d_row[:, :P * hp].reshape(B, P, hp, 1)
    gj *= d_row[:, :P * hp].reshape(B, P, hp, 1)
    gob *= d_row[:, P * hp:].reshape(B, S, hp, 1)
    gsl *= d_row
    A = rng.normal(size=(B, V, hu, hu))
    pb = np.einsum("bvij,bvkj->bvik", A, A) / hu + 3.0 * np.eye(hu)
    pb /= np.abs(pb).max(axis=(1, 2, 3), keepdims=True)
    q = rng.normal(size=(B, n))
    q[:, -1] = 2.0
    pdiag = np.concatenate(
        [np.diagonal(pb, axis1=2, axis2=3).reshape(B, -1),
         np.zeros((B, 1))], 1)
    h = np.where(gsl == 0.0, 0.5,
                 rng.uniform(-0.3, 0.5, size=(B, mg))) * d_row
    ub = np.ones((B, n))
    ub[:, -1] = 100.0
    hl = np.ones((B, n))
    hl[:, -1] = 0.0
    x = np.zeros((B, n))
    sg = np.maximum(h, 1.0)
    su = np.maximum(ub - x, 1.0)
    sl = np.maximum(hl + x, 1.0)
    scal = np.zeros((B, 2))
    scal[:, 0] = np.finfo(dtype).max
    arrs = dict(gi=gi, gj=gj, gob=gob, gsl=gsl, pb=pb, q=q, pdiag=pdiag,
                x=x, sg=sg, su=su, sl=sl, zg=1.0 / sg, zu=1.0 / su,
                zl=1.0 / sl, rpg=sg - h, rpu=x + su - ub, rpl=-x + sl - hl,
                scal=scal)
    return ({k: np.ascontiguousarray(v, dtype) for k, v in arrs.items()},
            pairs, obst_veh)


def torch_kernel_args(arrs, device="cpu"):
    """Argument list of ``ipm_iterate_struct`` from :func:`kernel_inputs`
    (``gob`` becomes ``None`` when there are no single-block slabs)."""
    import torch
    return [None if (k == "gob" and arrs[k].shape[1] == 0)
            else torch.as_tensor(arrs[k].copy(), device=device)
            for k in KERNEL_ARG_ORDER]


DENSE_ARG_ORDER = ("G", "P", "pb", "q", "pdiag") + STATE_NAMES


def dense_kernel_inputs(B, mg, nb, d, seed, blocks=True, dtype=np.float32):
    """An SCP-shaped QP in the argument layout of
    ``ops.ipm_kernel.ipm_iterate_dense`` at its first iteration: equilibrated
    dense rows with a -1 slack column (``n = nb*d + 1``), unit-scaled
    block-diagonal P (``blocks``: stated as blocks ``pb``, else as the dense
    ``P``; the slack's P row is zero, so that it may be eliminated) and a
    cold start at x = 0 with rows partly violated. Returns a dict of numpy
    arrays keyed by DENSE_ARG_ORDER (``P`` / ``pb`` None where the other is
    given)."""
    rng = np.random.default_rng(seed)
    nu = nb * d
    n = nu + 1
    G = np.concatenate([rng.normal(size=(B, mg, nu)) * 0.3,
                        -np.ones((B, mg, 1))], axis=2)
    d_row = 1.0 / np.linalg.norm(G, axis=2)
    G *= d_row[:, :, None]
    A = rng.normal(size=(B, nb, d, d))
    pb = np.einsum("bvij,bvkj->bvik", A, A) / d + 3.0 * np.eye(d)
    pb /= np.abs(pb).max(axis=(1, 2, 3), keepdims=True)
    P = np.zeros((B, n, n))
    for v in range(nb):
        P[:, v * d:(v + 1) * d, v * d:(v + 1) * d] = pb[:, v]
    q = rng.normal(size=(B, n))
    q[:, -1] = 2.0
    pdiag = np.diagonal(P, axis1=1, axis2=2).copy()
    h = rng.uniform(-0.3, 0.5, size=(B, mg)) * d_row
    ub = np.ones((B, n))
    ub[:, -1] = 100.0
    hl = np.ones((B, n))
    hl[:, -1] = 0.0
    x = np.zeros((B, n))
    sg = np.maximum(h, 1.0)
    su = np.maximum(ub - x, 1.0)
    sl = np.maximum(hl + x, 1.0)
    scal = np.zeros((B, 2))
    scal[:, 0] = np.finfo(dtype).max
    arrs = dict(G=G, P=None if blocks else P, pb=pb if blocks else None,
                q=q, pdiag=pdiag, x=x, sg=sg, su=su, sl=sl, zg=1.0 / sg,
                zu=1.0 / su, zl=1.0 / sl, rpg=sg - h, rpu=x + su - ub,
                rpl=-x + sl - hl, scal=scal)
    return {k: None if v is None else np.ascontiguousarray(v, dtype)
            for k, v in arrs.items()}


def riccati_inputs(B, V, K, seed, n_obst=2, dtype=np.float32):
    """A randomized banded system in the argument layout of
    ``ops.riccati_kernel.riccati_factor`` / ``riccati_solve``: mildly
    contractive per-vehicle dynamics, stage Hessians from random position
    coefficients with positive barrier weights (assembled as
    ``ops.riccati.build_hy`` does), a positive input diagonal and a
    right-hand side. Returns a dict ``a_blk, b_blk, hy, hu, r`` of numpy
    arrays."""
    from scp_tpu_torch.config import NX, NY
    rng = np.random.default_rng(seed)
    a_blk = 0.95 * (np.eye(NX) + 0.1 * rng.normal(size=(B, V, NX, NX)))
    b_blk = rng.normal(size=(B, V, NX))
    pairs = [(i, j) for i in range(V) for j in range(i + 1, V)]
    hy = np.zeros((B, K, V, NY, V, NY))
    for i, j in pairs:
        y = rng.normal(size=(B, K, NY))
        wyy = rng.uniform(0.1, 100.0, size=(B, K, 1, 1)) \
            * y[..., :, None] * y[..., None, :]
        hy[:, :, i, :, i] += wyy
        hy[:, :, j, :, j] += wyy
        hy[:, :, i, :, j] -= wyy
        hy[:, :, j, :, i] -= wyy
    for v in range(V):
        for _ in range(n_obst):
            y = rng.normal(size=(B, K, NY))
            hy[:, :, v, :, v] += rng.uniform(0.1, 100.0, size=(B, K, 1, 1)) \
                * y[..., :, None] * y[..., None, :]
        q = rng.uniform(0.5, 3.0, size=(B, K))
        for a in range(NY):
            hy[:, :, v, a, v, a] += q
    arrs = dict(a_blk=a_blk, b_blk=b_blk,
                hy=hy.reshape(B, K, V * NY, V * NY),
                hu=rng.uniform(0.5, 50.0, size=(B, K, V)),
                r=rng.normal(size=(B, K, V)))
    return {k: np.ascontiguousarray(v, dtype) for k, v in arrs.items()}
