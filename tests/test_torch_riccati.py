"""Banded (Riccati) KKT sweeps of the port (``ops/riccati.py``,
``ops/riccati_kernel.py``) and ``constraints.linearize_ycoefs`` against
``scp_tpu``'s on the same numpy-seeded inputs, on the CPU.

Tolerances: float64 against ``scp_tpu``'s scans 1e-10 relative (the same
algorithm; sums in another order); float32 against the Pallas sweeps in
interpret mode 2e-5 on the factors and 5e-4 on the solve (the TPU kernel
addresses the cost-to-go by symmetry and never symmetrises, the plain version
symmetrises every stage — the same function in exact arithmetic, float32
round-off apart; the same limits ``tests/test_riccati.py`` holds the Pallas
kernels to).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.ops import constraints as jcon
from scp_tpu.ops import pallas_riccati as jpr
from scp_tpu.ops import riccati as jric
from scp_tpu_torch.ops import constraints as tcon
from scp_tpu_torch.ops import riccati as tric
from scp_tpu_torch.ops import riccati_kernel as trk
from scp_tpu_torch.testing import riccati_inputs

from torch_parity import assert_close, jax_problem, scenario_pair, tonp


def _system(B, V, K, seed, dtype=np.float64):
    r = riccati_inputs(B, V, K, seed=seed, dtype=dtype)
    # stable dynamics: the random ones grow over long horizons
    r["a_blk"] = (0.9 * r["a_blk"]).astype(dtype)
    return r


def _t(a):
    return torch.as_tensor(np.array(a))


def test_chol_small_and_solve_match_scp_tpu():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(5, 4, 4))
    M = a @ a.transpose(0, 2, 1) + 0.5 * np.eye(4)
    b = rng.normal(size=(5, 4))
    b2 = rng.normal(size=(5, 4, 3))
    L_j = np.asarray(jric.chol_small(jnp.asarray(M)))
    L_t = tric.chol_small(_t(M))
    assert_close(L_t, L_j, 1e-13, name="L")
    assert_close(tric.chol_solve_small(L_t, _t(b)),
                 jric.chol_solve_small(jnp.asarray(L_j), jnp.asarray(b)),
                 1e-12, name="x")
    assert_close(tric.chol_solve_small(L_t, _t(b2)),
                 jric.chol_solve_small(jnp.asarray(L_j), jnp.asarray(b2)),
                 1e-12, name="X")
    np.testing.assert_allclose(
        tric.chol_solve_small(L_t, _t(b)).numpy(),
        np.linalg.solve(M, b[..., None])[..., 0], rtol=1e-10)


def test_chol_small_clamps_and_never_poisons():
    """A non-positive pivot becomes sqrt(1e-30), as in scp_tpu: the
    instance stays finite (unlike the dense Cholesky kernel's NaN)."""
    M = np.array([[[1.0, 2.0], [2.0, 1.0]], [[2.0, 0.0], [0.0, 3.0]]])
    L_t = tric.chol_small(_t(M))
    assert bool(torch.isfinite(L_t).all())
    assert_close(L_t, jric.chol_small(jnp.asarray(M)), 1e-12)
    assert float(L_t[0, 1, 1]) == pytest.approx(1e-15)


@pytest.mark.parametrize("V,O", [(1, 3), (3, 2), (4, 0)])
def test_build_hy_matches_scp_tpu(V, O):
    rng = np.random.default_rng(V)
    B, K = 3, 5
    pairs = tuple((i, j) for i in range(V) for j in range(i + 1, V))
    P = len(pairs)
    yp = rng.normal(size=(B, P, K, 2))
    yo = rng.normal(size=(B, V, O, K, 2))
    wp = rng.uniform(0.1, 10, size=(B, P, K))
    wo = rng.uniform(0.1, 10, size=(B, V, O, K))
    qy = rng.uniform(0.5, 3, size=(B, V, K))
    want = jax.vmap(lambda *a: jric.build_hy(pairs, *a))(
        *map(jnp.asarray, (yp, yo, wp, wo, qy)))
    got = tric.build_hy(pairs, *map(_t, (yp, yo, wp, wo, qy)))
    assert_close(got, want, 1e-13, name="hy")


@pytest.mark.parametrize("V,K", [(1, 7), (3, 5), (4, 6)])
def test_plain_sweeps_match_scp_tpu_scans_float64(V, K):
    r = _system(3, V, K, seed=10 + V)
    fac_j = jax.vmap(jric._riccati_factor_scan)(
        *map(jnp.asarray, (r["a_blk"], r["b_blk"], r["hy"], r["hu"])))
    du_j = jax.vmap(jric._riccati_solve_scan)(
        fac_j, jnp.asarray(r["a_blk"]), jnp.asarray(r["b_blk"]),
        jnp.asarray(r["r"]))
    t = {k: _t(v) for k, v in r.items()}
    fac_t = tric.riccati_factor_plain(t["a_blk"], t["b_blk"], t["hy"],
                                      t["hu"])
    du_t = tric.riccati_solve_plain(*fac_t, t["a_blk"], t["b_blk"], t["r"])
    for name in ("f", "lh", "kg"):
        want = np.asarray(getattr(fac_j, name))
        assert_close(getattr(fac_t, name), want,
                     1e-10 * np.abs(want).max(), name=name)
    assert_close(du_t, du_j, 1e-10 * np.abs(np.asarray(du_j)).max(),
                 name="du")


def test_entry_points_take_the_plain_versions_on_the_cpu():
    r = _system(2, 2, 4, seed=3)
    t = {k: _t(v) for k, v in r.items()}
    trk.reset_launch_counts()
    fac = tric.riccati_factor(t["a_blk"], t["b_blk"], t["hy"], t["hu"])
    du = tric.riccati_solve(fac, t["a_blk"], t["b_blk"], t["r"])
    ref = tric.riccati_factor_plain(t["a_blk"], t["b_blk"], t["hy"], t["hu"])
    assert isinstance(fac, tric.RiccatiFactor)
    for a, b in zip(fac, ref):
        assert torch.equal(a, b)
    assert torch.equal(du, tric.riccati_solve_plain(*ref, t["a_blk"],
                                                    t["b_blk"], t["r"]))
    assert trk.launch_counts == dict.fromkeys(
        ("riccati_factor", "riccati_solve", "riccati_factor_device",
         "riccati_solve_device"), 0)


def test_banded_solve_is_the_dense_solve():
    """The factored sweep solves exactly the condensed system K du = r of
    the stage statement (the formulation's defining property)."""
    from scp_tpu.ops import condensed as jcond
    rng = np.random.default_rng(5)
    V, K = 2, 6
    r = _system(1, V, K, seed=5)
    a, b = r["a_blk"][0], r["b_blk"][0]
    # condensed position blocks b3[v, k, :, j] = C A^(k-j) B
    b3 = np.zeros((V, K, 2, K))
    for v in range(V):
        _, mb, _ = jcond.prediction_matrices(
            jnp.asarray(a[v]), jnp.asarray(b[v][:, None]), jnp.zeros((6,)),
            K, K)
        b3[v] = np.asarray(mb).reshape(K, 2, K)
    hy = r["hy"][0].reshape(K, V, 2, V, 2)
    Kd = np.zeros((V * K, V * K))
    for k in range(K):
        for i in range(V):
            for j in range(V):
                Kd[i * K:(i + 1) * K, j * K:(j + 1) * K] += \
                    b3[i, k].T @ hy[k, i, :, j, :] @ b3[j, k]
    Kd[np.arange(V * K), np.arange(V * K)] += r["hu"][0].T.reshape(-1)
    t = {k: _t(v) for k, v in r.items()}
    fac = tric.riccati_factor(t["a_blk"], t["b_blk"], t["hy"], t["hu"])
    du = tric.riccati_solve(fac, t["a_blk"], t["b_blk"], t["r"])
    want = np.linalg.solve(Kd, r["r"][0].T.reshape(-1))
    np.testing.assert_allclose(du[0].numpy().T.reshape(-1), want,
                               rtol=1e-9, atol=1e-12)
    del rng


@pytest.mark.parametrize("V,K", [(1, 6), (3, 5)])
def test_plain_sweeps_match_pallas_kernels_interpret_float32(V, K):
    r = _system(3, V, K, seed=20 + V, dtype=np.float32)
    j = {k: jnp.asarray(v, jnp.float32) for k, v in r.items()}
    old = jpr.INTERPRET
    jpr.INTERPRET = True
    try:
        f_j, lh_j, kg_j = jpr.riccati_factor_lane(j["a_blk"], j["b_blk"],
                                                  j["hy"], j["hu"])
        du_j = jpr.riccati_solve_lane(f_j, lh_j, kg_j, j["a_blk"],
                                      j["b_blk"], j["r"])
    finally:
        jpr.INTERPRET = old
    t = {k: torch.as_tensor(v) for k, v in r.items()}
    fac = tric.riccati_factor(t["a_blk"], t["b_blk"], t["hy"], t["hu"])
    du = tric.riccati_solve(fac, t["a_blk"], t["b_blk"], t["r"])
    for got, want, name in ((fac.f, f_j, "f"), (fac.lh, lh_j, "lh"),
                            (fac.kg, kg_j, "kg")):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(du.numpy(), np.asarray(du_j), rtol=5e-4,
                               atol=1e-5)


@pytest.mark.parametrize("V,K", [(1, 6), (3, 5)])
def test_plain_two_rhs_match_pallas_solve_interpret_float32(V, K):
    """Two right-hand sides against one factor (the kernel's n_rhs = 2) are
    two solves of ``riccati_solve_lane`` in interpret mode."""
    r = _system(3, V, K, seed=30 + V, dtype=np.float32)
    r2 = np.stack([r["r"], np.random.default_rng(V).normal(
        size=r["r"].shape).astype(np.float32)])
    j = {k: jnp.asarray(v, jnp.float32) for k, v in r.items()}
    old = jpr.INTERPRET
    jpr.INTERPRET = True
    try:
        f_j, lh_j, kg_j = jpr.riccati_factor_lane(j["a_blk"], j["b_blk"],
                                                  j["hy"], j["hu"])
        want = [np.asarray(jpr.riccati_solve_lane(
            f_j, lh_j, kg_j, j["a_blk"], j["b_blk"], jnp.asarray(ri)))
            for ri in r2]
    finally:
        jpr.INTERPRET = old
    t = {k: torch.as_tensor(v) for k, v in r.items()}
    fac = tric.riccati_factor(t["a_blk"], t["b_blk"], t["hy"], t["hu"])
    du = tric.riccati_solve(fac, t["a_blk"], t["b_blk"], torch.as_tensor(r2))
    assert du.shape == r2.shape and du.dtype == torch.float32
    for i in range(2):
        np.testing.assert_allclose(du[i].numpy(), want[i], rtol=5e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("V,K", [(1, 7), (4, 6)])
def test_plain_two_rhs_match_scp_tpu_scan_float64(V, K):
    r = _system(3, V, K, seed=40 + V)
    r2 = np.stack([r["r"], np.random.default_rng(V).normal(
        size=r["r"].shape)])
    fac_j = jax.vmap(jric._riccati_factor_scan)(
        *map(jnp.asarray, (r["a_blk"], r["b_blk"], r["hy"], r["hu"])))
    want = [np.asarray(jax.vmap(jric._riccati_solve_scan)(
        fac_j, jnp.asarray(r["a_blk"]), jnp.asarray(r["b_blk"]),
        jnp.asarray(ri))) for ri in r2]
    t = {k: _t(v) for k, v in r.items()}
    fac = tric.riccati_factor_plain(t["a_blk"], t["b_blk"], t["hy"], t["hu"])
    du = tric.riccati_solve_plain(*fac, t["a_blk"], t["b_blk"], _t(r2))
    for i in range(2):
        np.testing.assert_allclose(du[i].numpy(), want[i], rtol=1e-9,
                                   atol=1e-12)


def test_solve_takes_one_or_two_right_hand_sides():
    """``r (2, B, K, V)`` is two solves against one factor, exactly, on the
    CPU (the plain version); any other leading axis is refused."""
    r = _system(2, 3, 4, seed=2, dtype=np.float32)
    t = {k: torch.as_tensor(v) for k, v in r.items()}
    fac = trk.riccati_factor(t["a_blk"], t["b_blk"], t["hy"], t["hu"])
    r2 = torch.stack([t["r"], 2.0 * t["r"].flip(1)])
    du2 = trk.riccati_solve(*fac, t["a_blk"], t["b_blk"], r2)
    for i in range(2):
        assert torch.equal(du2[i], trk.riccati_solve(
            *fac, t["a_blk"], t["b_blk"], r2[i]))
    with pytest.raises(ValueError):
        trk.riccati_solve(*fac, t["a_blk"], t["b_blk"],
                          torch.stack([t["r"]] * 3))


@pytest.mark.parametrize("B", [1, 3, 16, 256, 1023])
@pytest.mark.parametrize("V", [1, 4, 6, 16, 21])
def test_launch_geometry(B, V):
    """The geometry the wrappers hand the launchers (csrc/riccati.cu checks
    the same): one warp per instance, every instance covered exactly once,
    a CTA within a block's shared memory, and both gates admit V."""
    limit = trk.SMEM_LIMIT_BYTES
    geos = [("factor", trk.factor_geometry(B, V), trk.factor_smem_bytes(V),
             trk.check_factor_smem_gate(V))]
    for K in (5, 64):
        for n_rhs in (1, 2):
            per = trk.solve_smem_bytes(V, K, n_rhs)
            geos.append((f"solve K={K} n_rhs={n_rhs}",
                         trk.solve_geometry(B, V, K, n_rhs), per,
                         trk.check_solve_smem_gate(V, K, n_rhs)))
    for name, (ipc, threads, smem), per, gate in geos:
        assert 1 <= ipc <= trk.MAX_WARPS, name
        assert threads == 32 * ipc, name
        assert smem == ipc * per <= limit and gate == per, name
        blocks = -(-B // ipc)
        covered = [blk * ipc + w for blk in range(blocks)
                   for w in range(ipc) if blk * ipc + w < B]
        assert covered == list(range(B)), name
        assert blocks * ipc - B < ipc, name      # no CTA without an instance


# The shared tier's launch at B = 256 for V = 1 ... 24, as the parent
# computed it: (instances per CTA, threads, shared-memory bytes per CTA) of
# the factor and of the solve at K = 64 with one and two right-hand sides.
_SHARED_FACTOR_B256 = [
    (2, 64, 1792), (2, 64, 3616), (2, 64, 7936), (2, 64, 13760),
    (2, 64, 22496), (2, 64, 31264), (2, 64, 40832), (2, 64, 53952),
    (2, 64, 66336), (2, 64, 82816), (2, 64, 97952), (2, 64, 117792),
    (2, 64, 135744), (2, 64, 158944), (2, 64, 179648), (2, 64, 206208),
    (2, 64, 229728), (1, 32, 129824), (1, 32, 142960), (1, 32, 159600),
    (1, 32, 174144), (1, 32, 192464), (1, 32, 208384), (1, 32, 228384)]
_SHARED_SOLVE1_B256 = [
    (2, 64, 1792), (2, 64, 5248), (2, 64, 10368), (2, 64, 17152),
    (2, 64, 25600), (2, 64, 20544), (2, 64, 26880), (2, 64, 34048),
    (2, 64, 42048), (2, 64, 50880), (2, 64, 60544), (2, 64, 71040),
    (2, 64, 82368), (2, 64, 94528), (2, 64, 107520), (2, 64, 121344),
    (2, 64, 136000), (2, 64, 151488), (2, 64, 167808), (2, 64, 184960),
    (2, 64, 202944), (2, 64, 221760), (1, 32, 120704), (1, 32, 130944)]
_SHARED_SOLVE2_B256 = [
    (2, 64, 2432), (2, 64, 6496), (2, 64, 12256), (2, 64, 19648),
    (2, 64, 28736), (2, 64, 24096), (2, 64, 31040), (2, 64, 38784),
    (2, 64, 47392), (2, 64, 56800), (2, 64, 67072), (2, 64, 78144),
    (2, 64, 90080), (2, 64, 102816), (2, 64, 116416), (2, 64, 130816),
    (2, 64, 146080), (2, 64, 162144), (2, 64, 179072), (2, 64, 196800),
    (2, 64, 215392), (1, 32, 117392), (1, 32, 127520), (1, 32, 138048)]


def test_gates_admit_every_vehicle_count_the_parent_admitted():
    """Every V <= 24 stays in the shared tier with the parent's launch
    (the register kernels end at V = 5, the generic ones take the rest);
    V = 25 ... 64, which the parent refused, is taken by the device tier,
    and only a forced shared tier refuses it."""
    for V in range(1, 25):
        assert trk.check_factor_smem_gate(V) == trk.factor_smem_bytes(V)
        assert trk.factor_tier(V) == "shared"
        assert trk.factor_geometry(256, V) == _SHARED_FACTOR_B256[V - 1]
        for n_rhs, want in ((1, _SHARED_SOLVE1_B256),
                            (2, _SHARED_SOLVE2_B256)):
            assert trk.check_solve_smem_gate(V, 64, n_rhs) \
                == trk.solve_smem_bytes(V, 64, n_rhs)
            assert trk.solve_tier(V, 64, n_rhs) == "shared"
            assert trk.solve_geometry(256, V, 64, n_rhs) == want[V - 1]
    for V in range(25, 65):
        assert trk.factor_tier(V) == "device"
        assert trk.factor_device_geometry(V).smem_bytes \
            <= trk.SMEM_LIMIT_BYTES
        for n_rhs in (1, 2):
            assert trk.solve_tier(V, 64, n_rhs) == "device"
            assert trk.solve_device_geometry(V, n_rhs).smem_small
    with pytest.raises(NotImplementedError, match="V <= 24"):
        trk.solve_tier(25, 64, tier="shared")
    with pytest.raises(NotImplementedError, match="V <= 24"):
        trk.factor_tier(25, tier="shared")


def test_wrappers_check_shapes_and_gate_shared_memory():
    r = _system(2, 3, 4, seed=1, dtype=np.float32)
    t = {k: torch.as_tensor(v) for k, v in r.items()}
    with pytest.raises(ValueError):
        trk.riccati_factor(t["a_blk"], t["b_blk"], t["hy"][:, :, :4],
                           t["hu"])
    with pytest.raises(ValueError):
        trk.riccati_solve(t["hy"], t["hu"], t["hy"], t["a_blk"], t["b_blk"],
                          t["r"])
    # V = 4 (the long-horizon path) fits; 6,880 bytes per instance
    assert trk.check_factor_smem_gate(4) == trk.factor_smem_bytes(4) == 6880
    assert trk.check_factor_smem_gate(16) < trk.SMEM_LIMIT_BYTES
    with pytest.raises(NotImplementedError, match="shared memory"):
        trk.check_factor_smem_gate(25)


@pytest.mark.parametrize("kind,kw", [
    ("circle", dict(n_veh=3)),
    ("frog", dict()),
])
def test_linearize_ycoefs_matches_scp_tpu(kind, kw):
    cfg_j, data_j, _, _ = scenario_pair(kind, 2, 4, np.float64,
                                        cfg_over=dict(hp=5, hu=5), **kw)
    problem, _, _ = jax_problem(cfg_j, data_j)
    rng = np.random.default_rng(4)
    u = rng.uniform(-0.02, 0.02, size=(2, cfg_j.n_veh * 5))
    yp_j, yo_j = jax.vmap(jcon.linearize_ycoefs)(problem.sys,
                                                  jnp.asarray(u))
    from scp_tpu_torch import convert
    sys_t = convert.system_from_numpy(tonp(problem.sys), torch.float64,
                                      "cpu")
    yp_t, yo_t = tcon.linearize_ycoefs(sys_t, torch.as_tensor(u))
    assert_close(yp_t, yp_j, 1e-12, name="y_pair")
    assert_close(yo_t, yo_j, 1e-12, name="y_obst")
    # the slabs are the same rows multiplied into the condensed blocks
    gi, gj, gob, _ = tcon.linearize_slabs(sys_t, torch.as_tensor(u))
    assert_close(gob, torch.einsum("bvoky,bvkyu->bvoku", yo_t, sys_t.b3)
                 .numpy(), 1e-12, name="gob")
    if cfg_j.n_veh > 1:
        assert_close(gi, torch.einsum("bpky,bpkyu->bpku", yp_t, sys_t.b3i)
                     .numpy(), 1e-12, name="gi")
