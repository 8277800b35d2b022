"""solve_qp of the port (the general dense solver on a leading batch axis)
against vmap(scp_tpu.solvers.qp.solve_qp), and the adaptive branch of
solve_qp_batched against scp_tpu's — on the CPU, where the port's factor,
solves and matvecs run their plain versions.

float64 tolerances: both sides run the same Mehrotra iteration on the same
dense KKT matrix, so they differ by reduction order only, amplified by
barrier weights z/s of up to 1e12 in the last iterations: iterates are held
to 1e-8 (controls, rad; random QPs: absolute on O(1) solutions), duals and
objectives to 1e-6 relative, and iteration counts and convergence flags must
be IDENTICAL. float32: both sides sit at the float32 floor of the same
optimum; the tolerance is stated at each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.ops import pallas_linalg as pll
from scp_tpu.solvers import qp as jqp
from scp_tpu_torch import convert
from scp_tpu_torch.ops import linalg_kernel
from scp_tpu_torch.solvers import qp as tqp

from torch_parity import TDT, assert_close, jit_fast, scp_qp_data

KEYS = ("P", "q", "G", "h", "lb", "ub")


def _random_qps(b, n, m, seed, np_dtype=np.float64):
    """Dense random QPs with x = 0 strictly feasible and some rows and
    bounds active at the optimum; instances differ in conditioning, so the
    adaptive loop stops them at different iterations."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, n, n))
    scale = 10.0 ** rng.uniform(-1, 2, size=(b, 1, 1))
    P = scale * (a @ a.transpose(0, 2, 1) / n) + 0.1 * np.eye(n)
    q = rng.normal(size=(b, n)) * 3.0 * scale[:, :, 0]
    G = rng.normal(size=(b, m, n))
    h = rng.uniform(0.05, 1.0, size=(b, m))
    lb = -rng.uniform(0.2, 1.0, size=(b, n))
    ub = rng.uniform(0.2, 1.0, size=(b, n))
    return {k: v.astype(np_dtype) for k, v in
            dict(P=P, q=q, G=G, h=h, lb=lb, ub=ub).items()}


def _jax_solve_qp(d, x0=None, z0=None, **kw):
    b = d["q"].shape[0]
    x0 = np.zeros_like(d["q"]) if x0 is None else x0

    def one(P, q, G, h, lb, ub, x0_, z0_):
        return jqp.solve_qp(P, q, G, h, lb, ub, x0=x0_, z0=z0_,
                            use_pallas=False, **kw)

    args = [jnp.asarray(d[k]) for k in KEYS] + [jnp.asarray(x0)]
    if z0 is None:
        return jax.jit(jax.vmap(lambda *a: one(*a, None)))(*args)
    assert z0.shape[0] == b
    return jax.jit(jax.vmap(one))(*args, jnp.asarray(z0))


def _torch_solve_qp(d, x0=None, z0=None, **kw):
    ops = convert.qp_from_numpy({**d, "x0": x0, "z0": z0},
                               TDT[d["q"].dtype.type], "cpu")
    return tqp.solve_qp(**ops, **kw)


def _compare64(got, want, x_tol=1e-8):
    assert_close(got.iters, want.iters, 0, name="iters")
    assert_close(got.converged, want.converged, 0, name="converged")
    assert_close(got.x, want.x, x_tol, name="x")
    assert_close(got.obj, want.obj, 1e-9, rtol=1e-6, name="obj")
    assert_close(got.z, want.z, 1e-7, rtol=1e-6, name="z")
    assert_close(got.gap, want.gap, 1e-12, rtol=1e-3, name="gap")


@pytest.mark.parametrize("kw", [
    dict(),                                        # adaptive, defaults
    dict(max_iter=9, tol=1e-10),                   # some run into the cap
    dict(fixed_iters=12),
    dict(fixed_iters=9, correctors=2),
    dict(correctors=1, refine_steps=2),
    dict(fixed_iters=10, refine_steps=1, tol=1e-6),
])
def test_solve_qp_f64_random_qps(kw):
    d = _random_qps(7, 9, 14, seed=1)
    want = _jax_solve_qp(d, **kw)
    got = _torch_solve_qp(d, **kw)
    _compare64(got, want)
    if "fixed_iters" not in kw:
        # instances really stopped at different iterations
        assert len(set(np.asarray(want.iters).tolist())) > 1
    assert got.iters.dtype == torch.int32 and got.converged.dtype == torch.bool
    as_np = convert.to_numpy(got)
    assert set(as_np) == set(got._fields) and as_np["x"].shape == (7, 9)


def test_solve_qp_f64_warm_starts():
    """x0 outside the box is clipped; z0 with non-positive entries keeps the
    cold start there."""
    d = _random_qps(5, 8, 12, seed=2)
    cold = _jax_solve_qp(d)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-2.0, 2.0, size=(5, 8))
    z0 = np.asarray(cold.z).copy()
    z0[:, ::3] = 0.0
    z0[:, 1::5] = -1.0
    want = _jax_solve_qp(d, x0=x0, z0=z0)
    got = _torch_solve_qp(d, x0=x0, z0=z0)
    _compare64(got, want)
    assert not np.array_equal(np.asarray(want.iters), np.asarray(cold.iters))


@pytest.mark.parametrize("kind,kw", [
    ("circle", dict(n_veh=3, radius=8.0)),
    ("parallel", dict(n_veh=2)),
])
def test_solve_qp_f64_scp_subproblem(kind, kw):
    """The QP of a real SCP iteration (slack weight 1e5, slack bound 1e8,
    active avoidance rows): adaptive loop, then 14 fixed iterations."""
    ja, _ = scp_qp_data(kind, 5, 6, np.float64, **kw)
    d = {k: np.asarray(ja[k]) for k in KEYS}
    n = d["q"].shape[1] - 1
    for opts in (dict(tol=1e-8), dict(fixed_iters=14, tol=1e-8)):
        want = _jax_solve_qp(d, x0=np.asarray(ja["x0"]), **opts)
        got = _torch_solve_qp(d, x0=np.asarray(ja["x0"]), **opts)
        assert_close(got.iters, want.iters, 0, name="iters")
        assert_close(got.converged, want.converged, 0, name="converged")
        assert_close(got.x[:, :n], want.x[:, :n], 1e-8, name="u")
        assert_close(got.x[:, n], want.x[:, n], 1e-6, rtol=1e-6, name="slack")
        assert_close(got.obj, want.obj, 1e-6, rtol=1e-6, name="obj")
        assert_close(got.z, want.z, 1e-3, rtol=1e-3, name="z")


@pytest.mark.parametrize("solver", ["solve_qp", "solve_qp_fixed14",
                                    "solve_qp_batched_dense"])
def test_f64_at_hp64_past_the_shared_memory_kernels(solver):
    """n = 257 (circle, 4 vehicles, hp = hu = 64: the long-horizon shape),
    one SCP iteration's QP, B = 2, float64: ``solve_qp`` (adaptive, and 14
    fixed iterations) and ``solve_qp_batched(fixed_iters=None,
    kkt="dense")`` against scp_tpu's, whose CPU route factors with
    ``linalg.blocked_cholesky``. On the card this size takes the large-n
    factor and solve; here the wrappers' plain versions."""
    ja, ta = scp_qp_data("circle", 2, 64, np.float64, n_veh=4)
    n = ja["q"].shape[1] - 1
    assert n + 1 == 257 and not linalg_kernel.fits_chol_smem(n + 1)
    if solver == "solve_qp_batched_dense":
        want = _batched_j(ja, False, tol=1e-8)
        got = _batched_t(ta, tol=1e-8, kkt="dense")
    else:
        d = {k: np.asarray(ja[k]) for k in KEYS}
        opts = dict(tol=1e-8)
        if solver == "solve_qp_fixed14":
            opts["fixed_iters"] = 14
        want = _jax_solve_qp(d, x0=np.asarray(ja["x0"]), **opts)
        got = _torch_solve_qp(d, x0=np.asarray(ja["x0"]), **opts)
    assert_close(got.iters, want.iters, 0, name="iters")
    assert_close(got.converged, want.converged, 0, name="converged")
    assert_close(got.x[:, :n], want.x[:, :n], 1e-8, name="u")
    assert_close(got.x[:, n], want.x[:, n], 1e-6, rtol=1e-6, name="slack")
    assert_close(got.obj, want.obj, 1e-6, rtol=1e-6, name="obj")
    assert_close(got.z, want.z, 1e-3, rtol=1e-3, name="z")


def test_f32_at_hp64_converges_where_scp_tpu_does():
    """float32 at n = 257 (circle, 4 vehicles, hp = hu = 64, B = 8, one SCP
    iteration's QP): the adaptive ``solve_qp_batched(kkt="dense")`` of both
    packages, scp_tpu on its XLA path, tol 1e-7, at most 30 iterations.
    float32 converges on few of these QPs in both (4 of 8 here; float64 on
    7 of 8), so a low converged share at this size is the algorithm's in
    float32, not the port's: the flags are identical, the iteration counts
    equal on every converged instance, and their controls agree within
    2.5e-4 rad (measured 1.23e-4; box +-0.052)."""
    ja, ta = scp_qp_data("circle", 8, 64, np.float32, n_veh=4)
    n = ja["q"].shape[1] - 1
    assert n + 1 == 257

    def jax_solve(P, q, G, h, lb, ub, x0, pb, slabs):
        return jqp.solve_qp_batched(
            P, q, G, h, lb, ub, x0=x0, p_blocks=pb, slack_schur=True,
            g_struct=ja["g_struct"], g_slabs=slabs, use_pallas=False,
            tol=1e-7, max_iter=30, kkt="dense")
    args = [ja[k] for k in KEYS + ("x0", "p_blocks", "g_slabs")]
    want = jit_fast(jax_solve, *args)(*args)
    got = _batched_t(ta, tol=1e-7, max_iter=30, kkt="dense")
    conv = np.asarray(want.converged)
    assert got.x.dtype == torch.float32
    assert_close(got.converged, conv, 0, name="converged")
    assert 0 < conv.sum() < 8
    assert_close(got.iters[conv], np.asarray(want.iters)[conv], 0,
                 name="iters")
    assert_close(got.x[conv, :n], np.asarray(want.x)[conv, :n], 2.5e-4,
                 name="u")


def test_solve_qp_f32_random_qps():
    """float32, adaptive, tol = 1e-6: most instances leave by the stall
    exit at the float32 floor, at an iteration that depends on round-off, so
    the counts may differ by a step or two while the solutions agree to 2e-4
    on O(1) variables. A stalled float32 solve of an ill-conditioned
    instance can sit 1e-2 from the float64 optimum; the port must be as
    close to it as scp_tpu is (x1.5 + 1e-4)."""
    d = _random_qps(7, 9, 14, seed=1, np_dtype=np.float32)
    want = _jax_solve_qp(d, tol=1e-6)
    got = _torch_solve_qp(d, tol=1e-6)
    assert got.x.dtype == torch.float32
    assert_close(got.x, want.x, 2e-4, name="x")
    assert np.abs(got.iters.numpy() - np.asarray(want.iters)).max() <= 2
    exact = _torch_solve_qp(_random_qps(7, 9, 14, seed=1), tol=1e-10)
    e_port = (got.x.double() - exact.x).abs().amax(dim=1).numpy()
    e_jax = np.abs(np.asarray(want.x, np.float64) - exact.x.numpy()).max(1)
    assert np.all(e_port <= 1.5 * e_jax + 1e-4), (e_port, e_jax)


def test_solve_qp_unbatched_is_the_b1_view():
    d = _random_qps(3, 6, 8, seed=4)
    full = _torch_solve_qp(d, correctors=1)
    one = tqp.solve_qp(*[torch.as_tensor(d[k][1]) for k in KEYS],
                       correctors=1)
    assert one.x.shape == (6,) and one.iters.shape == ()
    alone = _torch_solve_qp({k: v[1:2] for k, v in d.items()}, correctors=1)
    for a, b_ in zip(one, alone):
        assert torch.equal(a, b_[0])
    assert_close(one.x, full.x[1], 1e-12)
    assert int(one.iters) == int(full.iters[1])


def test_stopped_instances_keep_state_and_host_reads_are_counted():
    """An instance that has stopped is not touched by the iterations the
    others still run: solving it alone gives the same answer bit for bit.
    The loop reads any(active) once per iteration plus once to leave."""
    d = _random_qps(6, 7, 10, seed=6)
    tqp.reset_host_sync_count()
    full = _torch_solve_qp(d)
    reads = tqp.host_sync_count
    assert reads == int(full.iters.max()) + 1
    first = int(full.iters.argmin())
    assert int(full.iters[first]) < int(full.iters.max())
    alone = _torch_solve_qp({k: v[first:first + 1] for k, v in d.items()})
    assert int(alone.iters[0]) == int(full.iters[first])
    assert_close(alone.x[0], full.x[first], 1e-13)
    tqp.reset_host_sync_count()
    _torch_solve_qp(d, fixed_iters=5)
    assert tqp.host_sync_count == 0


@pytest.mark.parametrize("kw,item", [
    (dict(cheap_k=True), "cheap_k"),
    (dict(axis_name="model", mg_total=8), "item 11"),
    (dict(banded=True), "item 8"),
])
def test_solve_qp_unported_options_raise(kw, item):
    if item == "item 11":
        # roadmap item 11 is ported (the row-sharded solve is held against
        # scp_tpu's through solve_scp in tests/test_torch_horizon.py); the
        # banded KKT is not row-sharded, and axis_name needs mg_total
        _, ta = scp_qp_data("circle", 2, 4, np.float64, n_veh=2,
                            banded=True)
        args = [ta[k] for k in ("P", "q", "G", "h", "lb", "ub")]
        with pytest.raises(ValueError, match="not row-sharded"):
            tqp.solve_qp(*args, banded=ta["banded"], **kw)
        with pytest.raises(ValueError, match="requires mg_total"):
            tqp.solve_qp(*args, axis_name=kw["axis_name"])
        return
    if item == "item 8":
        # roadmap item 8 is ported: with a stage statement the banded KKT
        # solves the same QP as the dense factor (float64 round-off;
        # tests/test_torch_banded_qp.py holds it against scp_tpu)
        _, ta = scp_qp_data("circle", 2, 4, np.float64, n_veh=2,
                            banded=True)
        args = [ta[k] for k in ("P", "q", "G", "h", "lb", "ub")]
        dense = tqp.solve_qp(*args, x0=ta["x0"], tol=1e-10)
        band = tqp.solve_qp(*args, x0=ta["x0"], tol=1e-10,
                            banded=ta["banded"])
        assert_close(band.x, dense.x.numpy(), 1e-7, name="x")
        return
    d = _random_qps(2, 4, 4, seed=0)
    with pytest.raises(NotImplementedError, match=item):
        _torch_solve_qp(d, **kw)


# --------------------------------------------------------------------------
# adaptive branch of solve_qp_batched
# --------------------------------------------------------------------------

def _batched_j(a, use_pallas, with_blocks=True, z0=None, **kw):
    return jqp.solve_qp_batched(
        a["P"], a["q"], a["G"], a["h"], a["lb"], a["ub"], x0=a["x0"], z0=z0,
        p_blocks=a["p_blocks"] if with_blocks else None, slack_schur=True,
        g_struct=a["g_struct"], g_slabs=a["g_slabs"], use_pallas=use_pallas,
        **kw)


def _batched_t(a, with_blocks=True, dense_p=False, z0=None, **kw):
    return tqp.solve_qp_batched(
        a["P"] if (dense_p or not with_blocks) else None, a["q"], a["G"],
        a["h"], a["lb"], a["ub"], x0=a["x0"], z0=z0,
        p_blocks=a["p_blocks"] if with_blocks else None, slack_schur=True,
        g_struct=a["g_struct"], g_slabs=a["g_slabs"], **kw)


@pytest.mark.parametrize("variant", ["blocks_no_P", "blocks_and_P",
                                     "dense_P_only"])
def test_batched_adaptive_f64_matches_scp_tpu(variant):
    """float64 against scp_tpu's CPU route (vmap(solve_qp) on the dense P
    and G). P stated by blocks only, by blocks and densely, or densely only
    (then P @ x goes through the G-matvec wrapper)."""
    ja, ta = scp_qp_data("circle", 6, 6, np.float64, n_veh=3, radius=8.0)
    with_blocks = variant != "dense_P_only"
    want = _batched_j(ja, False, with_blocks=with_blocks, tol=1e-8)
    tqp.reset_host_sync_count()
    got = _batched_t(ta, with_blocks=with_blocks,
                     dense_p=variant == "blocks_and_P", tol=1e-8)
    n = ja["q"].shape[1] - 1
    assert_close(got.iters, want.iters, 0, name="iters")
    assert_close(got.converged, want.converged, 0, name="converged")
    assert_close(got.x[:, :n], want.x[:, :n], 1e-8, name="u")
    assert_close(got.x[:, n], want.x[:, n], 1e-6, rtol=1e-6, name="slack")
    assert_close(got.obj, want.obj, 1e-6, rtol=1e-6, name="obj")
    assert_close(got.z, want.z, 1e-3, rtol=1e-3, name="z")
    assert tqp.host_sync_count == int(got.iters.max()) + 1
    assert bool(got.converged.all())


def test_batched_adaptive_f64_obstacles_warm_dual_and_cap():
    ja, ta = scp_qp_data("parallel", 4, 6, np.float64, n_veh=3)
    cold = _batched_j(ja, False, tol=1e-8)
    z0 = np.asarray(cold.z).copy()
    z0[:, ::4] = 0.0
    want = _batched_j(ja, False, tol=1e-8, max_iter=6, z0=jnp.asarray(z0))
    got = _batched_t(ta, tol=1e-8, max_iter=6, z0=torch.as_tensor(z0))
    assert_close(got.iters, want.iters, 0, name="iters")
    assert int(got.iters.max()) == 6
    n = ja["q"].shape[1] - 1
    assert_close(got.x[:, :n], want.x[:, :n], 1e-8, name="u")
    assert_close(got.converged, want.converged, 0)


def test_batched_adaptive_ignores_correctors_like_scp_tpu_lane_path():
    """scp_tpu's lane implementation of the adaptive branch never reads
    ``correctors`` (solve_qp does); the port keeps that."""
    _, ta = scp_qp_data("circle", 3, 6, np.float64, n_veh=2, radius=6.0)
    a = _batched_t(ta, tol=1e-8)
    b_ = _batched_t(ta, tol=1e-8, correctors=2)
    assert torch.equal(a.x, b_.x) and torch.equal(a.iters, b_.iters)


def test_batched_adaptive_f32_matches_pallas_interpret():
    """float32, scp_tpu's lane path with its Pallas kernels (cholesky_lane,
    cho_solve_lane, gmv_lane, gtmv_lane) in interpret mode, tiny (n = 13,
    mg = 6, at most 12 iterations). Both stop at the float32 floor: controls
    within 2e-4 rad (box +-0.052), iteration counts within 2."""
    ja, ta = scp_qp_data("circle", 4, 6, np.float32, n_veh=2, radius=6.0)
    old = pll.INTERPRET
    pll.INTERPRET = True
    try:
        want = jax.jit(lambda: _batched_j(ja, True, tol=1e-6, max_iter=12))()
    finally:
        pll.INTERPRET = old
    linalg_kernel.reset_launch_counts()
    got = _batched_t(ta, tol=1e-6, max_iter=12)
    n = ja["q"].shape[1] - 1
    assert got.x.dtype == torch.float32 and got.x.shape == want.x.shape
    assert_close(got.x[:, :n], want.x[:, :n], 2e-4, name="u")
    assert np.abs(got.iters.numpy() - np.asarray(want.iters)).max() <= 2
    assert int(got.iters.max()) <= 12
    assert sum(linalg_kernel.launch_counts.values()) == 0


def test_batched_adaptive_needs_the_dense_G():
    _, ta = scp_qp_data("circle", 2, 6, np.float64, n_veh=2, radius=6.0)
    with pytest.raises(ValueError, match="dense G"):
        tqp.solve_qp_batched(None, ta["q"], None, ta["h"], ta["lb"], ta["ub"],
                             p_blocks=ta["p_blocks"], g_slabs=ta["g_slabs"],
                             g_struct=ta["g_struct"])
    with pytest.raises(ValueError, match="p_blocks"):
        tqp.solve_qp_batched(None, ta["q"], ta["G"], ta["h"], ta["lb"],
                             ta["ub"])
