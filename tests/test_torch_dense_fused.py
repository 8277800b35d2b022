"""The dense-G fused fixed-iteration branch of ``solve_qp_batched`` (the
dense-G iteration K2, ``ops/ipm_kernel.py::ipm_iterate_dense``), single-vehicle
frog through the batched step, ``solve_scp_multistart`` and
``utils.debug.scp_iteration_trace`` against ``scp_tpu``'s, on the CPU.

Tolerances: float32 against ``scp_tpu``'s fused branch with the Pallas
kernel in interpret mode 5e-5 on the controls (radians, box +-0.052; the
limit ``tests/test_qp_batched.py`` holds that branch to against its own
vmap) — both sides sum in other orders, and the port eliminates the slack
border whenever asked where ``scp_tpu`` does so only when (n-1) % 8 == 0;
one iteration against ``pallas_linalg.ipm_iterate_lane`` itself (on the
product ``scp_tpu``'s loop forms) 1e-5 on every state entry, three chained
iterations 2e-5; float64 steps and SCP results 5e-6 rad (the limit of the
port's other chained-step tests) with every integer and flag equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.ops import pallas_linalg as jpll
from scp_tpu.scenarios import builders as jbuilders
from scp_tpu.sim import engine as jengine
from scp_tpu.solvers import qp as jqp
from scp_tpu.solvers import scp as jscp
from scp_tpu.utils import debug as jdebug
from scp_tpu_torch import config as tconfig, convert
from scp_tpu_torch.ops import ipm_kernel
from scp_tpu_torch.ops import linalg_kernel as lk
from scp_tpu_torch.scenarios import builders as tbuilders
from scp_tpu_torch.sim import engine as tengine
from scp_tpu_torch.solvers import qp as tqp
from scp_tpu_torch.solvers import scp as tscp
from scp_tpu_torch.testing import DENSE_ARG_ORDER, dense_kernel_inputs
from scp_tpu_torch.utils import debug as tdebug

from torch_parity import (assert_close, assert_stripes_cover, jax_problem,
                          scenario_pair, scp_qp_data, tonp)


def _interpret(fn):
    old = jpll.INTERPRET
    jpll.INTERPRET = True
    try:
        return fn()
    finally:
        jpll.INTERPRET = old


@pytest.mark.parametrize("hp,blocks,schur,n_cor,warm", [
    (5, True, True, 0, False),     # scp_tpu: no Schur border (4 % 8)
    (8, True, True, 1, True),      # both eliminate the slack
    (5, False, False, 1, False),   # dense P, nothing eliminated
    (8, False, True, 0, True),     # dense P, both eliminate the slack
])
def test_dense_branch_matches_pallas_interpret(hp, blocks, schur, n_cor,
                                               warm):
    ja, ta = scp_qp_data("frog", 2, hp, np.float32)
    n = ta["q"].shape[1]
    m = ta["h"].shape[1] + 2 * n
    z0 = np.abs(np.random.default_rng(hp).normal(size=(2, m))) \
        .astype(np.float32) if warm else None
    kw = dict(fixed_iters=6, tol=1e-6, correctors=n_cor, slack_schur=schur)
    want = _interpret(lambda: jqp.solve_qp_batched(
        ja["P"], ja["q"], ja["G"], ja["h"], ja["lb"], ja["ub"], x0=ja["x0"],
        z0=None if z0 is None else jnp.asarray(z0), use_pallas=True,
        p_blocks=ja["p_blocks"] if blocks else None, **kw))
    ipm_kernel.reset_launch_count()
    got = tqp.solve_qp_batched(
        None if blocks else ta["P"], ta["q"], ta["G"], ta["h"], ta["lb"],
        ta["ub"], x0=ta["x0"],
        z0=None if z0 is None else torch.as_tensor(z0),
        p_blocks=ta["p_blocks"] if blocks else None,
        g_struct=ta["g_struct"], g_slabs=ta["g_slabs"], kkt="auto", **kw)
    assert ipm_kernel.launch_count == 0          # CPU: the plain version
    assert got.x.dtype == torch.float32
    nu = n - 1
    np.testing.assert_allclose(got.x[:, :nu].numpy(),
                               np.asarray(want.x)[:, :nu], atol=5e-5)
    # (the slack, ~1e-6 here, enters the objective with weight 1e5: the
    # objective of a float32 solve is not compared)
    np.testing.assert_allclose(got.x[:, nu].numpy(),
                               np.asarray(want.x)[:, nu], rtol=1e-3,
                               atol=1e-4)


def _lane(a, rows):
    """(B, d) numpy -> (rows, B) lane layout, zero padded."""
    out = np.zeros((rows, a.shape[0]), np.float32)
    out[:a.shape[1]] = a.T
    return jnp.asarray(out)


def _jax_dense_iterations(a, schur, blocks, n_cor, n_iters):
    """``n_iters`` chained iterations of ``scp_tpu``'s dense-G fixed loop on
    the inputs ``a`` (``dense_kernel_inputs``), laid out as the TPU kernel
    takes them (lanes of 128 instances, padded rows): per iteration the
    product ``G_k^T diag(zg / sg) G_k`` (+ the dense P) formed as
    ``scp_tpu/solvers/qp.py``'s ``fori_body`` forms it, then
    ``pallas_linalg.ipm_iterate_lane`` in interpret mode. Returns the final
    state in the port's (B, rows) layout."""
    B, mg, n = a["G"].shape
    n_pad, mg_pad = jpll.pad_dim(n), jpll._pad_to(mg, jpll._MV_MB)
    G_lane = np.zeros((mg_pad, n_pad, B), np.float32)
    G_lane[:mg, :n] = a["G"].transpose(1, 2, 0)
    if schur:
        G_k = jnp.asarray(a["G"][:, :, :n - 1])
        P_pad = None if blocks else jnp.asarray(a["P"][:, :n - 1, :n - 1])
    else:
        G_k = jnp.asarray(np.pad(a["G"], ((0, 0), (0, 0), (0, n_pad - n))))
        if not blocks:
            Pp = np.zeros((B, n_pad, n_pad), np.float32)
            Pp[:, :n, :n] = a["P"]
            Pp[:, np.arange(n, n_pad), np.arange(n, n_pad)] = 1.0
            P_pad = jnp.asarray(Pp)

    def vec(name, rows, fill):
        out = np.full((rows, B), fill, np.float32)
        out[:a[name].shape[1]] = a[name].T
        return jnp.asarray(out)

    state = [_lane(a["x"], n_pad), vec("sg", mg_pad, 1.0),
             vec("su", n_pad, 1.0), vec("sl", n_pad, 1.0),
             _lane(a["zg"], mg_pad), _lane(a["zu"], n_pad),
             _lane(a["zl"], n_pad), _lane(a["rpg"], mg_pad),
             _lane(a["rpu"], n_pad), _lane(a["rpl"], n_pad),
             _lane(a["scal"], 8)]
    for _ in range(n_iters):
        wg = jnp.transpose(state[4][:mg] / state[1][:mg], (1, 0))
        Kprod = jax.lax.dot_general(
            G_k, G_k * wg[:, :, None], (((1,), (1,)), ((0,), (0,))),
            precision=jax.lax.Precision.HIGHEST)
        if blocks:
            K_lane, px = jnp.transpose(Kprod, (2, 1, 0)), None
        else:
            K_lane = jnp.transpose(P_pad + Kprod, (2, 1, 0))
            x = np.asarray(state[0])[:n].T
            px = _lane(np.einsum("bij,bj->bi", a["P"], x), n_pad)
        state = list(_interpret(lambda: jpll.ipm_iterate_lane(
            K_lane, jnp.asarray(G_lane), px, _lane(a["q"], n_pad),
            vec("pdiag", n_pad, 1.0), *state, mg=mg, n=n, m_true=mg + 2 * n,
            tol=1e-6, reg_rel=3e-6, n_cor=n_cor, schur_slack=schur,
            pb=jnp.asarray(a["pb"].transpose(1, 2, 3, 0)) if blocks
            else None)))
    rows = (n, mg, n, n, mg, n, n, mg, n, n, 2)
    return [np.asarray(w)[:r].T for w, r in zip(state, rows)]


def _check_state(got, want, atol, rtol, slack_atol=0.0):
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 0:   # x: the slack entry lives on a scale of its own
            np.testing.assert_allclose(g[:, :-1].numpy(), w[:, :-1],
                                       atol=atol)
            np.testing.assert_allclose(g[:, -1].numpy(), w[:, -1],
                                       rtol=rtol, atol=slack_atol)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol,
                                       err_msg=str(i))


@pytest.mark.parametrize("schur,blocks", [(True, True), (False, False)])
def test_plain_iteration_matches_ipm_iterate_lane(schur, blocks):
    """One iteration of the plain dense-G version (``n_iters=1``, the
    product formed inside) against the Pallas kernel itself (interpret
    mode) on the product ``scp_tpu``'s loop forms, on the same inputs:
    1e-5 absolute / 1e-4 relative on every state entry."""
    B, mg, nb, d = 128, 12, 1, 8
    a = dense_kernel_inputs(B, mg, nb, d, seed=3, blocks=blocks)
    want = _jax_dense_iterations(a, schur, blocks, n_cor=1, n_iters=1)
    t = [None if a[k] is None else torch.as_tensor(a[k])
         for k in DENSE_ARG_ORDER]
    got = ipm_kernel.ipm_iterate_dense_plain(
        *t, n_iters=1, tol=1e-6, reg_rel=3e-6, n_cor=1, schur_slack=schur)
    _check_state(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("schur,blocks,n_cor", [
    (True, True, 0), (False, False, 1), (True, False, 1), (False, True, 0)])
def test_plain_iterations_match_chained_ipm_iterate_lane(schur, blocks,
                                                        n_cor):
    """``n_iters=3`` of the plain dense-G version against three chained
    iterations of ``scp_tpu``'s loop (product + Pallas kernel, interpret
    mode), with every fifth instance entering frozen (its state must come
    back unchanged). Limits 2e-5 absolute / 2e-4 relative on every state
    entry, the slack's included: twice the one iteration's, since each
    iteration starts from the other side's float32 iterate, whose round-off
    the next factor carries forward (after three iterations a slack of
    ~1e-4 differs by ~2e-7, beyond a relative limit alone)."""
    B, mg, nb, d = 128, 12, 1, 8
    a = dense_kernel_inputs(B, mg, nb, d, seed=5 + n_cor, blocks=blocks)
    a["scal"][::5, 1] = 1.0
    want = _jax_dense_iterations(a, schur, blocks, n_cor=n_cor, n_iters=3)
    t = [None if a[k] is None else torch.as_tensor(a[k])
         for k in DENSE_ARG_ORDER]
    got = ipm_kernel.ipm_iterate_dense_plain(
        *t, n_iters=3, tol=1e-6, reg_rel=3e-6, n_cor=n_cor,
        schur_slack=schur)
    _check_state(got, want, atol=2e-5, rtol=2e-4, slack_atol=2e-5)
    frozen = a["scal"][:, 1] > 0.5
    assert bool(got[10][frozen, 1].eq(1.0).all())
    np.testing.assert_array_equal(got[0][frozen].numpy(), a["x"][frozen])
    np.testing.assert_array_equal(got[10][:, 1].numpy(), want[10][:, 1])


def test_dense_branch_makes_one_kernel_call_per_qp(monkeypatch):
    """The fixed-count dense-G branch hands all its iterations to ONE call
    of ``ipm_iterate_dense`` (``n_iters=fixed_iters``): no product, no
    per-iteration algebra around it."""
    _, ta = scp_qp_data("frog", 2, 5, np.float32)
    calls = []
    real = ipm_kernel.ipm_iterate_dense

    def spy(*args, **kw):
        calls.append(kw["n_iters"])
        return real(*args, **kw)

    monkeypatch.setattr(ipm_kernel, "ipm_iterate_dense", spy)
    for blocks in (True, False):
        calls.clear()
        got = tqp.solve_qp_batched(
            None if blocks else ta["P"], ta["q"], ta["G"], ta["h"], ta["lb"],
            ta["ub"], x0=ta["x0"], fixed_iters=6, tol=1e-6,
            slack_schur=True, p_blocks=ta["p_blocks"] if blocks else None,
            kkt="dense")
        assert calls == [6]
        assert bool(torch.isfinite(got.x).all())


def _old_dense_smem_bytes(mg, n, nb, d, schur, g_smem):
    """The carve of the kernel that ran one iteration per launch on a
    pre-formed product (every vector, G when it fit)."""
    nk = n - 1 if schur else n
    words = nk * (nk | 1) + nb * d * d + 9 * (mg + 2 * n) + 9 * n + 33
    return 4 * (words + (mg * (n | 1) if g_smem else 0))


def test_dense_carve_at_frog_fits_four_ctas():
    """At single-vehicle frog (mg = 440, n = 21, one 20 x 20 block, the slack
    eliminated, no corrector) G sits in shared memory and four CTAs share
    an SM (228 KB, 1 KB reserved per CTA); a corrector takes an m-vector
    more (three CTAs), a dense P none (it stays in device memory)."""
    ik = ipm_kernel
    frog = ik.dense_smem_bytes(440, 21, 1, 20, True, True, n_cor=0)
    assert frog == 56_568
    assert 4 * (frog + 1024) <= 228 * 1024
    assert ik.dense_tier(440, 21, 1, 20, True, 0) \
        == ("shared", frog, 0, True)
    with_cor = ik.dense_smem_bytes(440, 21, 1, 20, True, True, n_cor=1)
    assert with_cor == frog + 4 * (440 + 42)
    assert with_cor == _old_dense_smem_bytes(440, 21, 1, 20, True, True) + 16
    dense_p = ik.dense_smem_bytes(440, 21, 0, 0, True, True, n_cor=0)
    assert dense_p == frog - 4 * 400


@pytest.mark.parametrize("schur", [True, False])
def test_dense_gate_admits_no_fewer_shapes(schur):
    """The route and the shared tier follow the new carve and admit every
    shape (and every G in shared memory) the one-iteration kernel admitted;
    past it the cluster tier takes the shape where the smallest cluster
    holds it (the KKT matrix in its stripes), else the device tier (the
    factor in device memory, G too) with the rest of the carve, and only
    past that the tier function raises, naming the bytes."""
    ik = ipm_kernel
    limit = ik.SMEM_LIMIT_BYTES
    for mg in (12, 120, 440, 900, 2000, 6000, 20000):
        for nb, d in ((1, 20), (4, 16), (0, 0), (2, 7), (8, 20)):
            n = max(nb * d, 20) + 1
            nk = n - 1 if schur else n
            old_fits = _old_dense_smem_bytes(mg, n, nb, d, schur,
                                             False) <= limit
            assert ik.fits_dense_smem(mg, n, nb, d, schur) == old_fits
            for n_cor in (0, 1, 2):
                rest = ik.dense_smem_bytes(mg, n, nb, d, schur, False, n_cor,
                                           device=True)
                assert rest == ik.dense_smem_bytes(
                    mg, n, nb, d, schur, False, n_cor) - 4 * nk * (nk | 1)
                if not old_fits:
                    cl = ik.dense_cluster_geometry(mg, n, schur, n_cor)
                    sizes = [c for c in ik.DENSE_CLUSTER_SIZES
                             if ik.dense_cluster_smem_bytes(
                                 mg, n, schur, n_cor, c,
                                 lk.stripe_deal(nk, c)[2]) <= limit]
                    if sizes:
                        C = sizes[0]
                        assert cl == (C, lk.stripe_deal(nk, C)[2],
                                      ik.dense_cluster_smem_bytes(
                                          mg, n, schur, n_cor, C, cl[1]))
                        assert ik.dense_tier(mg, n, nb, d, schur, n_cor) \
                            == ("cluster", cl[2], 0, False)
                        continue
                    assert cl is None
                    if rest > limit:
                        with pytest.raises(NotImplementedError,
                                           match=f"{rest} bytes"):
                            ik.dense_tier(mg, n, nb, d, schur, n_cor)
                        continue
                    assert ik.dense_tier(mg, n, nb, d, schur, n_cor) \
                        == ("device", rest, nk * ik.kkt_ld(nk, True), False)
                    continue
                t = ik.dense_tier(mg, n, nb, d, schur, n_cor)
                assert t.tier == "shared" and t.workspace_floats == 0
                assert t.smem_bytes == ik.dense_smem_bytes(
                    mg, n, nb, d, schur, t.g_smem, n_cor) <= limit
                old_g = _old_dense_smem_bytes(mg, n, nb, d, schur,
                                              True) <= limit
                assert t.g_smem or not old_g


def test_dense_tier_at_the_hp64_qp():
    """Path (h)'s dense QP (circle-4, hp = 64: mg = 384, n = 257, four 64 x
    64 P blocks, the slack eliminated): 370,416 bytes with the factor, past
    a block; a cluster of two CTAs holds it in 218,308 bytes each (with a
    Gondzio corrector's vector; :func:`test_dense_cluster_carve_at_l3`),
    the device tier forced in 107,248 (the 256 x 257 factor, 263,168 bytes,
    in a workspace of 256 rows of 256 floats), and the route takes K2 there
    under kkt="dense" and, without a stage statement, under "auto"."""
    ik = ipm_kernel
    assert ik.dense_smem_bytes(384, 257, 4, 64, True, False) == 370_416
    assert ik.dense_tier(384, 257, 4, 64, True) \
        == ("cluster", 218_308, 0, False)
    assert ik.dense_tier(384, 257, 4, 64, True, tier="device") \
        == ("device", 107_248, 256 * 256, False)
    assert ik.dense_tier(440, 21, 1, 20, True, 0, tier="device") \
        == ("device", 56_568 - 4 * 20 * 21 - 4 * (440 * 21 + 4),
            20 * 32, False)
    q, h = torch.zeros((1, 257)), torch.zeros((1, 384))
    pb = torch.zeros((1, 4, 64, 64))
    for kkt in ("dense", "auto"):
        assert tqp._route(q, h, None, fixed_iters=7, p_blocks=pb,
                          slack_schur=True, g_struct=None, g_slabs=None,
                          banded=None, kkt=kkt) == "dense"
    assert tqp._route(q, h, None, fixed_iters=7, p_blocks=pb,
                      slack_schur=True, g_struct=None, g_slabs=None,
                      banded=object(), kkt="auto") == "banded"


def test_dense_cluster_carve_at_l3():
    """K2's cluster tier at (l3)'s QP (mg = 384, n = 257, nk = 256, no
    corrector), in words, as the kernel carves it: the step's vectors 8 x
    898 + 9 x 257 + 33 = 9,530 (no P blocks, no factor, no G), the
    stripes from 9,532; the factor's buffers 2 x 272 + 8 + 17,536 (this
    rank's stripes: the deal halves the triangle's 35,072) + 2 x 16 x 272
    = 26,792; the deal 32 -> 36,356; the row pointers 512 -> 36,868; the
    ring's mbarriers 4 -> 36,872; two stages of 16 rows (16 x 257 + 3
    rounded to 4,116) -> 45,104; the panel twice at a leading dimension of
    260 -> 53,424; the border's 257 -> 53,681 words, 214,724 bytes: C = 2,
    one CTA an SM (228 KB), the stripes covering the triangle once."""
    ik = ipm_kernel
    assert lk.stripe_deal(256, 2)[2] == 35_072 // 2 == 17_536
    assert ik.dense_cluster_smem_bytes(384, 257, True, 0, 2, 17_536) \
        == 4 * 53_681 == 214_724
    assert ik.dense_cluster_geometry(384, 257, True, 0) == (2, 17_536,
                                                            214_724)
    assert ik.dense_tier(384, 257, 4, 64, True, 0) \
        == ("cluster", 214_724, 0, False)
    assert 2 * (214_724 + 1024) > 228 * 1024
    # with a corrector one m-vector more: the vectors 10,428 words, the
    # stripes from 10,428 (896 words later)
    assert ik.dense_cluster_smem_bytes(384, 257, True, 1, 2, 17_536) \
        == 214_724 + 4 * 896
    assert_stripes_cover(256, 2)


@pytest.mark.parametrize("tier", ["shared", "cluster", "device"])
def test_dense_tier_keyword_runs_the_plain_version_on_the_cpu(tier):
    """``tier`` only picks where the kernel keeps its KKT matrix: on CPU
    tensors the wrapper runs the plain version, bit for bit the call
    without it, and counts no launch; forced on the card past a tier's
    capacity, the tier function raises, naming it."""
    a = dense_kernel_inputs(3, 30, 4, 5, seed=21)
    t = [None if a[k] is None else torch.as_tensor(a[k])
         for k in DENSE_ARG_ORDER]
    kw = dict(n_iters=3, tol=1e-6, reg_rel=3e-6, n_cor=0, schur_slack=True)
    ipm_kernel.reset_launch_count()
    want = ipm_kernel.ipm_iterate_dense(*t, **kw)
    got = ipm_kernel.ipm_iterate_dense(*t, **kw, tier=tier)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert ipm_kernel.dense_launch_count == 0
    assert ipm_kernel.dense_cluster_launch_count == 0
    assert ipm_kernel.dense_device_launch_count == 0
    assert ipm_kernel.dense_tier(30, 21, 4, 5, True, 0, tier).tier == tier
    with pytest.raises(NotImplementedError, match=f"{tier} tier"):
        ipm_kernel.dense_tier(60_000, 21, 4, 5, True, 0, tier)
    with pytest.raises(ValueError, match="unknown tier"):
        ipm_kernel.dense_tier(30, 21, 4, 5, True, 0, "global")


def test_plain_k2_at_the_l3_shape_scaled_down():
    """(l3)'s QP — circle-4's dense rows, four P blocks, the slack
    eliminated, 7 fixed iterations, no corrector — at hp = 5 (mg = 30, n =
    21), B = 2, float64: the port's dense fixed-count branch (K2's plain
    version on the CPU) against ``scp_tpu``'s fixed-count path off the TPU
    (``use_pallas=False``, its XLA loop, which it takes at (l3)'s size): 1e-9
    on x and the duals (two orders of the same float64 sums), the same
    frozen flags."""
    ja, ta = scp_qp_data("circle", 2, 5, np.float64, n_veh=4)
    n, mg = ta["q"].shape[1], ta["h"].shape[1]
    assert (n, mg, ta["p_blocks"].shape[1:]) == (21, 30, (4, 5, 5))
    kw = dict(fixed_iters=7, tol=1e-6, correctors=0, slack_schur=True)
    want = jqp.solve_qp_batched(
        ja["P"], ja["q"], ja["G"], ja["h"], ja["lb"], ja["ub"], x0=ja["x0"],
        use_pallas=False, p_blocks=ja["p_blocks"], **kw)
    calls = []
    real = ipm_kernel.ipm_iterate_dense

    def spy(*args, **k):
        calls.append(ipm_kernel.dense_tier(
            mg, n, 4, 5, True, k["n_cor"], "cluster").tier)
        return real(*args, **k)

    ipm_kernel.ipm_iterate_dense = spy
    try:
        got = tqp.solve_qp_batched(
            None, ta["q"], ta["G"], ta["h"], ta["lb"], ta["ub"],
            x0=ta["x0"], p_blocks=ta["p_blocks"], kkt="dense", **kw)
    finally:
        ipm_kernel.ipm_iterate_dense = real
    assert calls == ["cluster"] and got.x.dtype == torch.float64
    assert_close(got.x, want.x, 1e-9, name="x")
    assert_close(got.z, want.z, 1e-9, rtol=1e-9, name="z")
    assert_close(got.converged, want.converged, 0, name="converged")


@pytest.mark.parametrize("B,sms,want", [
    (1, 132, 2), (64, 132, 2), (256, 132, 2), (264, 132, 2), (265, 132, 4),
    (528, 132, 4), (1024, 132, 4), (100, 50, 2), (101, 50, 4)])
def test_dense_launch_bound_by_batch(B, sms, want):
    """K2 runs at two CTAs an SM while the batch is one wave at two (B <=
    2 x SMs), and at four beyond."""
    assert ipm_kernel.dense_min_ctas(B, sms) == want


@pytest.mark.parametrize("breakage", ["shape", "dtype", "both_p", "no_p",
                                      "pb_shape", "p_shape"])
def test_dense_wrapper_checks_its_arguments(breakage):
    a = dense_kernel_inputs(2, 12, 1, 8, seed=3)
    t = {k: None if v is None else torch.as_tensor(v) for k, v in a.items()}
    if breakage == "shape":
        t["q"] = t["q"][:, :-1]
    elif breakage == "dtype":
        t["zg"] = t["zg"].double()
    elif breakage == "both_p":
        t["P"] = torch.zeros((2, 9, 9))
    elif breakage == "no_p":
        t["pb"] = None
    elif breakage == "pb_shape":
        t["pb"] = t["pb"][:, :, :-1]
    else:
        t["pb"], t["P"] = None, torch.zeros((2, 9, 8))
    with pytest.raises(ValueError):
        ipm_kernel.ipm_iterate_dense(*[t[k] for k in DENSE_ARG_ORDER],
                                     tol=1e-6, reg_rel=3e-6)


def test_dense_kernel_operand_limits():
    """What only the kernel refuses: float64 (TypeError) and non-contiguous
    operands (ValueError)."""
    a = dense_kernel_inputs(2, 12, 1, 8, seed=3)
    ins = [None if a[k] is None else torch.as_tensor(a[k])
           for k in DENSE_ARG_ORDER]
    ipm_kernel._check_launchable(ins)
    with pytest.raises(TypeError):
        ipm_kernel._check_launchable([ins[0].double()] + ins[1:])
    strided = ins[:3] + [ins[3].t().contiguous().t()] + ins[4:]
    with pytest.raises(ValueError):
        ipm_kernel._check_launchable(strided)


def test_frog_mpc_step_batch_tuned_f32_float64():
    """Single-vehicle frog through mpc_step_batch under tuned_f32 (7 fixed
    IPM iterations, qp_kkt="auto": no vehicle pair, so the dense-G fused
    branch), hp = 5, float64, two chained steps against scp_tpu's step."""
    cfg_j, data_j, cfg_t, data_t = scenario_pair(
        "frog", 3, 5, np.float64, cfg_over=dict(hp=5, hu=5))
    cfg_j = cfg_j.replace(**{k: v for k, v in
                             tconfig.TUNED_F32_OVERRIDES.items()})
    cfg_t = tconfig.tuned_f32(cfg_t)
    phases = tconfig.TUNED_F32_PHASES
    carry_j = jax.vmap(lambda d: jengine.init_carry(cfg_j, d))(data_j)
    step_j = jax.jit(functools.partial(jengine.mpc_step_batch, cfg_j,
                                       phases=phases))
    c_t = tengine.init_carry(cfg_t, data_t)
    for i in range(2):
        carry_j, out_j = step_j(data_j, carry_j)
        c_t, out_t = tengine.mpc_step_batch(cfg_t, data_t, c_t,
                                            phases=phases)
        assert_close(out_t.u_pred, out_j.u_pred, 5e-6, name=f"u_pred {i}")
        for f in ("feasible", "converged", "scp_iters", "qp_iters"):
            assert_close(getattr(out_t, f), getattr(out_j, f), 0,
                         name=f"{f} {i}")


def test_solve_scp_multistart_matches_scp_tpu_on_frog():
    cfg_j, data_j, _, _ = scenario_pair("frog", 2, 9, np.float64,
                                        cfg_over=dict(hp=5, hu=5))
    problem_j, _, carry_j = jax_problem(cfg_j, data_j)
    problem_t = convert.problem_from_numpy(tonp(problem_j), torch.float64,
                                           "cpu")
    u0 = np.random.default_rng(9).uniform(-0.02, 0.02, size=(2, 5))
    kw = dict(u_lim=cfg_j.u_lim, max_scp_iter=4, qp_tol=1e-9,
              qp_max_iter=25)
    want = jax.jit(jax.vmap(
        lambda p, u: jscp.solve_scp_multistart(p, u, **kw)))(
        problem_j, jnp.asarray(u0))
    got = tscp.solve_scp_multistart(problem_t, torch.as_tensor(u0), **kw)
    assert_close(got.u, want.u, 5e-6, name="u")
    for f in ("feasible", "converged", "iters", "qp_iters", "qp_fails"):
        assert_close(getattr(got, f), getattr(want, f), 0, name=f)
    # the winner is one of the three starts' own results
    one = tscp.solve_scp(problem_t, torch.as_tensor(u0), **kw)
    better = (~one.feasible & got.feasible) | (got.obj <= one.obj + 1e-12)
    assert bool(better.all())


def test_scp_iteration_trace_matches_scp_tpu_on_frog():
    cfg_j, data_j = jbuilders.frog(dtype=jnp.float64)
    cfg_j = cfg_j.replace(hp=5, hu=5, max_scp_iter=5)
    cfg_t, data_t = tbuilders.frog(dtype=torch.float64, device="cpu",
                                   hp=5, hu=5, max_scp_iter=5)
    want = jdebug.scp_iteration_trace(cfg_j, data_j)
    got = tdebug.scp_iteration_trace(cfg_t, data_t)
    assert got.keys() == want.keys()
    assert got["iters"] == want["iters"] and got["iters"] >= 1
    assert got["feasible"] == want["feasible"]
    np.testing.assert_array_equal(got["qp_converged"], want["qp_converged"])
    for k in ("obj", "max_violation", "merit", "delta"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["u"], want["u"], atol=5e-6)
    with pytest.raises(ValueError, match="ONE scenario"):
        tdebug.scp_iteration_trace(
            cfg_t, convert.scenario_from_numpy(
                tonp(jax.tree_util.tree_map(lambda x: jnp.stack([x, x]),
                                            data_j)), torch.float64, "cpu"))
