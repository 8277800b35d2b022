"""The banded (Riccati) sweeps past 24 vehicles (``ops/riccati.py``,
``ops/riccati_kernel.py``'s device tier) against ``scp_tpu``'s scans on the
same numpy-seeded inputs, on the CPU, and the device tier's launch as the
wrappers compute it.

Tolerances: float64 against ``scp_tpu``'s scans (``_riccati_factor_scan`` /
``_riccati_solve_scan``, compiled once per vehicle count by a module-scoped
fixture) 1e-9 of each output's largest entry: the same algorithm, its sums
and the triangular substitutions in another order. ``scp_tpu``'s scan
unrolls the V x V Cholesky while it is traced (~30 s at V = 25, ~60 s at
V = 32 on the CPU), so each vehicle count is traced once for every test of
it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.ops import riccati as jric
from scp_tpu_torch.config import NX
from scp_tpu_torch.ops import riccati as tric
from scp_tpu_torch.ops import riccati_kernel as trk
from scp_tpu_torch.testing import riccati_inputs

from torch_parity import assert_close, jit_fast

B, K = 2, 4


@pytest.fixture(scope="module", params=[25, 32])
def wide(request):
    """``(V, inputs, scp_tpu's factor, scp_tpu's du of two right-hand
    sides)`` at V = 25 and 32, B = 2, K = 4, float64."""
    V = request.param
    r = riccati_inputs(B, V, K, seed=V, dtype=np.float64)
    r["a_blk"] = 0.9 * r["a_blk"]          # stable over the stages
    r2 = np.stack([r["r"], np.random.default_rng(V).normal(
        size=r["r"].shape)])
    args = tuple(jnp.asarray(r[k]) for k in ("a_blk", "b_blk", "hy", "hu"))
    fac = jit_fast(jax.vmap(jric._riccati_factor_scan), *args)(*args)
    solve = jax.vmap(jax.vmap(jric._riccati_solve_scan),
                     in_axes=(None, None, None, 0))
    s_args = (fac, args[0], args[1], jnp.asarray(r2))
    du = jit_fast(solve, *s_args)(*s_args)
    return V, r, r2, fac, np.asarray(du)


def _t(a):
    return torch.as_tensor(np.array(a))


def _port_factor(r):
    return tric.riccati_factor_plain(_t(r["a_blk"]), _t(r["b_blk"]),
                                     _t(r["hy"]), _t(r["hu"]))


def test_plain_factor_matches_scp_tpu_scan_past_24_vehicles(wide):
    V, r, _, fac_j, _ = wide
    fac = _port_factor(r)
    assert fac.f.shape == (B, K, V, V, NX)
    for name in ("f", "lh", "kg"):
        want = np.asarray(getattr(fac_j, name))
        assert_close(getattr(fac, name), want, 1e-9 * np.abs(want).max(),
                     name=f"{name} V={V}")


@pytest.mark.parametrize("rhs", [0, 1])
def test_plain_solve_one_rhs_matches_scp_tpu_scan_past_24_vehicles(wide,
                                                                   rhs):
    V, r, r2, _, du_j = wide
    fac = _port_factor(r)
    du = tric.riccati_solve_plain(*fac, _t(r["a_blk"]), _t(r["b_blk"]),
                                  _t(r2[rhs]))
    assert_close(du, du_j[rhs], 1e-9 * np.abs(du_j[rhs]).max(),
                 name=f"du V={V}")


def test_plain_solve_two_rhs_matches_scp_tpu_scan_past_24_vehicles(wide):
    V, r, r2, _, du_j = wide
    fac = _port_factor(r)
    du = tric.riccati_solve_plain(*fac, _t(r["a_blk"]), _t(r["b_blk"]),
                                  _t(r2))
    assert du.shape == r2.shape
    assert_close(du, du_j, 1e-9 * np.abs(du_j).max(), name=f"du V={V}")


def test_wrappers_take_the_plain_versions_on_the_cpu_in_either_tier(wide):
    """On the CPU the wrappers run the plain versions whatever the tier
    (forced or chosen) and launch nothing; an unknown tier is refused."""
    V, r, r2, _, _ = wide
    t = {k: _t(v) for k, v in r.items()}
    ref = _port_factor(r)
    trk.reset_launch_counts()
    for tier in (None, "shared", "device"):
        fac = trk.riccati_factor(t["a_blk"], t["b_blk"], t["hy"], t["hu"],
                                 tier=tier)
        for a, b in zip(fac, ref):
            assert torch.equal(a, b)
        du = trk.riccati_solve(*fac, t["a_blk"], t["b_blk"], _t(r2),
                               tier=tier)
        assert torch.equal(du, tric.riccati_solve_plain(
            *ref, t["a_blk"], t["b_blk"], _t(r2)))
    assert set(trk.launch_counts.values()) == {0}
    with pytest.raises(ValueError, match="tier"):
        trk.riccati_factor(t["a_blk"], t["b_blk"], t["hy"], t["hu"],
                           tier="global")


@pytest.mark.parametrize("V", [1, 4, 24, 25, 32, 48, 64, 82, 83, 128])
def test_factor_device_geometry(V):
    """The device tier's factor launch (``csrc/riccati.cu``'s
    ``factor_dev_small_words`` / ``factor_dev_ws_words``): a CTA of
    DEVICE_THREADS per instance, the two W x W cost-to-go buffers in the
    workspace, the small part (A, B, Hm, L, 1 / diag(L), Kg) in shared
    memory up to V = 82 and after the buffers past it."""
    W = V * NX
    small = (trk._round4(42 * V) + trk._round4(2 * V * V + V)
             + trk._round4(6 * V * V))
    g = trk.factor_device_geometry(V)
    assert g.smem_small == (V <= 82)
    if g.smem_small:
        assert g.smem_bytes == 4 * small <= trk.SMEM_LIMIT_BYTES
        assert g.workspace_floats == 2 * W * W
    else:
        assert 4 * small > trk.SMEM_LIMIT_BYTES
        assert g.smem_bytes == 0
        assert g.workspace_floats == 2 * W * W + small
    # every instance's workspace starts on a 16-byte boundary, Kg on 8
    assert g.workspace_floats % 4 == 0
    assert (trk._round4(42 * V) + trk._round4(2 * V * V + V)) % 2 == 0


@pytest.mark.parametrize("V", [1, 25, 32, 48, 1874, 1875])
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_solve_device_geometry(V, n_rhs):
    """The device tier's solve: lam / x twice, the running sums, kff, u
    and 1 / diag(L) in shared memory while they fit a block, else in the
    workspace; the factor is read in place, so K never enters."""
    words = trk._round4(2 * n_rhs * V * NX + 3 * n_rhs * V + V)
    g = trk.solve_device_geometry(V, n_rhs)
    assert g.smem_small == (4 * words <= trk.SMEM_LIMIT_BYTES)
    assert (g.smem_bytes, g.workspace_floats) == (
        (4 * words, 0) if g.smem_small else (0, words))
    if n_rhs == 2:
        assert g.smem_small == (V <= 1874)


def test_tiers_are_chosen_from_the_shape_alone():
    """The shared tier up to V = 24 while its carve fits (the solve's
    grows with K), the device tier past it; no batch, no device."""
    assert [trk.factor_tier(V) for V in (1, 5, 6, 24, 25, 48, 200)] == \
        ["shared"] * 4 + ["device"] * 3
    assert trk.solve_tier(24, 20, 2) == "shared"
    assert trk.solve_tier(25, 20, 2) == "device"
    # a long horizon overflows the shared tier's kff at V = 24
    K_long = next(K for K in range(64, 4096)
                  if trk.solve_smem_bytes(24, K, 2) > trk.SMEM_LIMIT_BYTES)
    assert trk.solve_tier(24, K_long - 1, 2) == "shared"
    assert trk.solve_tier(24, K_long, 2) == "device"
    with pytest.raises(NotImplementedError, match="shared memory"):
        trk.solve_tier(24, K_long, 2, tier="shared")
    assert trk.solve_tier(4, 64, 1, tier="device") == "device"
    assert trk.factor_tier(4, tier="device") == "device"
    with pytest.raises(ValueError):
        trk.factor_tier(4, tier="cluster")


def test_build_hy_refuses_self_and_repeated_pairs():
    """``build_hy`` fills each off-diagonal block from one pair: a pair of
    a vehicle with itself, or a pair listed twice, is refused."""
    b, v, k = 1, 3, 2
    y_obst = torch.zeros((b, v, 0, k, 2))
    w_obst = torch.zeros((b, v, 0, k))
    qy = torch.ones((b, v, k))
    for pairs in (((0, 1), (1, 1)), ((0, 1), (1, 0))):
        with pytest.raises(ValueError):
            tric.build_hy(pairs, torch.ones((b, 2, k, 2)), y_obst,
                          torch.ones((b, 2, k)), w_obst, qy)


@pytest.mark.parametrize("V,O", [(25, 1), (32, 0)])
def test_build_hy_matches_scp_tpu_past_24_vehicles(V, O):
    """Every vehicle pair of the fleet (300 at V = 25, 496 at V = 32)."""
    rng = np.random.default_rng(V)
    b, k = 2, 3
    pairs = tuple((i, j) for i in range(V) for j in range(i + 1, V))
    P = len(pairs)
    yp = rng.normal(size=(b, P, k, 2))
    yo = rng.normal(size=(b, V, O, k, 2))
    wp = rng.uniform(0.1, 10, size=(b, P, k))
    wo = rng.uniform(0.1, 10, size=(b, V, O, k))
    qy = rng.uniform(0.5, 3, size=(b, V, k))
    want = jax.vmap(lambda *a: jric.build_hy(pairs, *a))(
        *map(jnp.asarray, (yp, yo, wp, wo, qy)))
    got = tric.build_hy(pairs, *map(_t, (yp, yo, wp, wo, qy)))
    assert_close(got, want, 1e-12, name="hy")
