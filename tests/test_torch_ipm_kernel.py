"""The fused structured IPM iterations of the port (ops/ipm_kernel.py).

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
here against the TPU kernel ``pallas_linalg.ipm_iterate_lane_struct`` run in
Pallas interpret mode on the same numpy-seeded inputs (float32, shapes where
the Pallas kernel engages: (n - 1) % 8 == 0, batch = one 128-lane tile).

Tolerances. Both sides are float32 and sum in different orders (the Pallas
kernel accumulates per 8-sublane block, the plain version through dense
batched products, and they factor with different Cholesky algorithms). After
one iteration that is round-off: 2e-5 absolute on variables of order one.
After seven iterations the barrier weights z/s reach 1e6 and more and amplify
the round-off, so single instances drift: 2e-3 absolute on the controls
(box +-1), with the batch median held to 5e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.ops import pallas_linalg as pll
from scp_tpu_torch.ops import ipm_kernel as ik
from scp_tpu_torch.ops import linalg_kernel as lk
from scp_tpu_torch.testing import (KERNEL_ARG_ORDER, STATE_NAMES,
                                   kernel_inputs, torch_kernel_args)
from torch_parity import assert_stripes_cover

B = pll.TB


def _to_lane(arrs, pairs, obst_veh, hp, hu):
    """Instance-major arrays -> the Pallas kernel's padded lane layout."""
    V = arrs["pb"].shape[1]
    n = V * hu + 1
    mg = arrs["gsl"].shape[1]
    n_pad, mg_pad = pll.pad_dim(n), pll._pad_to(mg, pll._MV_MB)
    hu8 = pll._pad_to(hu, 8)

    def slab(a):
        a = np.transpose(a, (1, 2, 3, 0))
        return jnp.asarray(np.pad(a, ((0, 0), (0, 0), (0, hu8 - hu), (0, 0))))

    def vec(a, rows, fill):
        out = np.full((rows, a.shape[0]), fill, np.float32)
        out[:a.shape[1]] = a.T
        return jnp.asarray(out)

    pad_n = dict(q=0.0, pdiag=1.0, x=0.0, su=1.0, sl=1.0, zu=0.0, zl=0.0,
                 rpu=0.0, rpl=0.0)
    pad_m = dict(gsl=0.0, sg=1.0, zg=0.0, rpg=0.0)
    lane = {}
    for k in KERNEL_ARG_ORDER:
        a = arrs[k]
        if k in ("gi", "gj"):
            lane[k] = slab(a)
        elif k == "gob":
            lane[k] = slab(a) if obst_veh else None
        elif k == "pb":
            lane[k] = jnp.asarray(np.transpose(a, (1, 2, 3, 0)))
        elif k == "scal":
            s = np.zeros((8, a.shape[0]), np.float32)
            s[:2] = a.T
            lane[k] = jnp.asarray(s)
        elif k in pad_n:
            lane[k] = vec(a, n_pad, pad_n[k])
        else:
            lane[k] = vec(a, mg_pad, pad_m[k])
    return lane, n, mg


def _pallas(arrs, pairs, obst_veh, hp, hu, *, n_iters, n_cor, lower_tri,
            tol=1e-6):
    lane, n, mg = _to_lane(arrs, pairs, obst_veh, hp, hu)
    old = pll.INTERPRET
    pll.INTERPRET = True
    try:
        out = pll.ipm_iterate_lane_struct(
            *[lane[k] for k in KERNEL_ARG_ORDER],
            g_struct=(tuple(pairs), tuple(obst_veh), hp, hu, lower_tri),
            mg=mg, n=n, m_true=mg + 2 * n, tol=tol, reg_rel=3e-6,
            n_cor=n_cor, n_iters=n_iters)
    finally:
        pll.INTERPRET = old
    res = {}
    for name, a in zip(STATE_NAMES, out):
        a = np.asarray(a)
        rows = 2 if name == "scal" else (
            mg if name in ("sg", "zg", "rpg") else n)
        res[name] = a[:rows].T
    return res


CASES = {
    # name: (kernel_inputs kwargs, n_iters, n_cor, lower_tri)
    "one_iteration": (dict(V=3, hp=5, hu=8, n_obst=0), 1, 0, True),
    "seven_iterations": (dict(V=3, hp=5, hu=8, n_obst=0), 7, 0, True),
    "dense_slabs_flag_off": (dict(V=2, hp=8, hu=8, n_obst=0), 7, 0, False),
    "obstacle_slabs": (dict(V=3, hp=5, hu=8, n_obst=1), 7, 0, True),
    "hard_rows": (dict(V=3, hp=5, hu=8, n_obst=1, hard_rows=True), 7, 0,
                  True),
    "one_corrector": (dict(V=3, hp=5, hu=8, n_obst=0), 7, 1, True),
    "missing_pair": (dict(V=3, hp=5, hu=8, n_obst=0,
                          pairs=((0, 1), (1, 2))), 7, 0, True),
    "four_vehicles": (dict(V=4, hp=6, hu=8, n_obst=0), 7, 0, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_pallas_kernel_interpret(name):
    kw, n_iters, n_cor, lower_tri = CASES[name]
    arrs, pairs, obst_veh = kernel_inputs(B=B, seed=11, **kw)
    want = _pallas(arrs, pairs, obst_veh, kw["hp"], kw["hu"],
                   n_iters=n_iters, n_cor=n_cor, lower_tri=lower_tri)
    got = ik.ipm_iterate_struct(
        *torch_kernel_args(arrs), pairs=pairs, obst_veh=obst_veh, tol=1e-6,
        reg_rel=3e-6, n_cor=n_cor, n_iters=n_iters, lower_tri=lower_tri)
    got = dict(zip(STATE_NAMES, (g.numpy() for g in got)))
    nu = arrs["x"].shape[1] - 1
    du = np.abs(got["x"][:, :nu] - want["x"][:, :nu]).max(axis=1)
    if n_iters == 1:
        assert du.max() < 2e-5
        for k in ("zg", "zu", "zl", "rpg", "rpu", "rpl"):
            np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=1e-4,
                                       err_msg=k)
    else:
        assert du.max() < 2e-3, du.max()
        assert np.median(du) < 5e-5, np.median(du)
    # the duality measure and the frozen flags are what the caller reads
    np.testing.assert_allclose(got["scal"][:, 0], want["scal"][:, 0],
                               rtol=5e-2, atol=1e-7)
    assert np.mean(got["scal"][:, 1] == want["scal"][:, 1]) >= 0.97
    assert ik.launch_count == 0          # no kernel launch on the CPU


def test_plain_float64_is_the_oracle_of_float32():
    """The plain version runs in float64 too; float32 stays near it."""
    arrs, pairs, obst_veh = kernel_inputs(B=16, V=3, hp=5, hu=8, n_obst=1,
                                          seed=3, hard_rows=True)
    kw = dict(pairs=pairs, obst_veh=obst_veh, tol=1e-6, n_cor=1, n_iters=5)
    a32 = torch_kernel_args(arrs)
    a64 = [None if a is None else a.double() for a in a32]
    o32 = ik.ipm_iterate_struct(*a32, reg_rel=3e-6, **kw)
    o64 = ik.ipm_iterate_struct_plain(*a64, reg_rel=1e-12, **kw)
    assert o64[0].dtype == torch.float64
    assert float((o32[0][:, :-1].double() - o64[0][:, :-1]).abs().max()) < 5e-3


def test_frozen_instances_keep_their_state():
    arrs, pairs, obst_veh = kernel_inputs(B=8, V=2, hp=4, hu=4, n_obst=0,
                                          seed=5)
    arrs["scal"][::2, 1] = 1.0               # frozen on entry
    args = torch_kernel_args(arrs)
    out = ik.ipm_iterate_struct(*args, pairs=pairs, obst_veh=obst_veh,
                                tol=1e-6, reg_rel=3e-6, n_iters=3)
    for o, name in zip(out[:-1], STATE_NAMES):
        assert torch.equal(o[::2], torch.as_tensor(arrs[name])[::2]), name
    assert not torch.equal(out[0][1::2], torch.as_tensor(arrs["x"])[1::2])
    assert bool((out[-1][::2, 1] == 1.0).all())


def test_failed_factorization_freezes_instead_of_raising():
    """A KKT matrix that is not positive definite must freeze the instance
    (state kept, frozen flag set), not raise or spread NaN."""
    arrs, pairs, obst_veh = kernel_inputs(B=4, V=2, hp=4, hu=4, n_obst=0,
                                          seed=6)
    # off-diagonals far above the (analytic, unit) diagonal: not SPD
    arrs["pb"][0] = 50.0
    arrs["pdiag"][0, :-1] = 1.0
    out = ik.ipm_iterate_struct(*torch_kernel_args(arrs), pairs=pairs,
                                obst_veh=obst_veh, tol=1e-6, reg_rel=3e-6,
                                n_iters=2)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert float(out[-1][0, 1]) == 1.0
    assert torch.equal(out[0][0], torch.as_tensor(arrs["x"])[0])


def test_shared_memory_gate():
    """The bench shape fits three times into an SM's shared memory and takes
    the shared tier with that carve; circle-4 at hp = 64 (nu = 256) no
    longer raises: the cluster tier takes it, and the device tier where
    forced."""
    assert ik.smem_bytes(6, 0, 20, 20, 4) < ik.SMEM_LIMIT_BYTES // 3
    assert ik.struct_tier(6, 0, 20, 20, 4) \
        == ("shared", ik.smem_bytes(6, 0, 20, 20, 4), 0, False)
    t = ik.struct_tier(6, 0, 64, 64, 4)
    assert t.tier == "cluster" and t.smem_bytes <= ik.SMEM_LIMIT_BYTES
    assert t.workspace_floats == 0
    t = ik.struct_tier(6, 0, 64, 64, 4, tier="device")
    assert t.tier == "device" and t.smem_bytes <= ik.SMEM_LIMIT_BYTES
    assert t.workspace_floats == 256 * 256


# Shared memory an H100 SM offers CTAs (228 KB), and what it reserves for
# each resident CTA (1 KB).
SM_SHARED_BYTES = 228 * 1024
CTA_RESERVED_BYTES = 1024


@pytest.mark.parametrize("case", ["four_ctas_at_bench_shape",
                                  "gate_admits_bench_refuses_hp64",
                                  "grows_with_hp", "grows_with_P",
                                  "packed_never_larger"])
def test_carve_and_gate(case):
    """The structured kernel's shared-memory carve (``smem_bytes``, which
    the launcher checks against the kernel's own): at the bench shape
    (P = 6, hp = hu = 20, V = 4, lower-triangular slabs, stored packed) four
    CTAs share an SM; the shared tier admits that shape and not hp = 64,
    which the device tier takes (the factor and the slabs out of shared
    memory; by default the cluster tier, the factor in a cluster's shared
    memory) and the ``kkt="auto"`` route sends to the banded path; past the
    device tier's own carve the global tier takes the shape, and the device
    tier forced there raises, naming the bytes; the carve grows with hp and
    with P, and packing never takes more than whole rows."""
    bench = (6, 0, 20, 20, 4)
    if case == "four_ctas_at_bench_shape":
        need = ik.smem_bytes(*bench, lower_tri=True)
        assert 4 * (need + CTA_RESERVED_BYTES) <= SM_SHARED_BYTES
        # whole slab rows would not: the packing is what buys the 4th CTA
        assert 4 * (ik.smem_bytes(*bench) + CTA_RESERVED_BYTES) \
            > SM_SHARED_BYTES
    elif case == "gate_admits_bench_refuses_hp64":
        assert ik.struct_tier(*bench, lower_tri=True) \
            == ("shared", ik.smem_bytes(*bench, lower_tri=True), 0, False)
        assert ik.fits_smem(*bench) and ik.fits_smem(*bench, lower_tri=True)
        for tri in (False, True):
            assert not ik.fits_smem(6, 0, 64, 64, 4, tri)
            t = ik.struct_tier(6, 0, 64, 64, 4, lower_tri=tri)
            assert t == ("cluster", ik.cluster_geometry(6, 0, 64, 64, 4)[2],
                         0, False)
            t = ik.struct_tier(6, 0, 64, 64, 4, lower_tri=tri, tier="device")
            assert t == ("device", ik.smem_bytes(6, 0, 64, 64, 4, tri, True),
                         256 * 256, False)
            assert ik.struct_tier(6, 0, 200, 200, 4, lower_tri=tri).tier \
                == "global"
            with pytest.raises(NotImplementedError,
                               match="global tier") as err:
                ik.struct_tier(6, 0, 200, 200, 4, lower_tri=tri,
                               tier="device")
            assert str(ik.smem_bytes(6, 0, 200, 200, 4, tri, True)) \
                in str(err.value)
    elif case in ("grows_with_hp", "grows_with_P"):
        for tri in (False, True):
            if case == "grows_with_hp":
                sizes = [ik.smem_bytes(6, 1, hp, 20, 4, lower_tri=tri)
                         for hp in range(1, 70)]
            else:
                sizes = [ik.smem_bytes(P, 0, 20, 20, 4, lower_tri=tri)
                         for P in range(1, 12)]
            assert all(a < b for a, b in zip(sizes, sizes[1:]))
    else:
        for hp in range(1, 40):
            for hu in range(1, 30):
                assert ik.slab_words(hp, hu, True) \
                    == sum(min(k + 1, hu) for k in range(hp)) \
                    <= ik.slab_words(hp, hu, False) == hp * hu
                assert ik.smem_bytes(3, 2, hp, hu, 3, lower_tri=True) \
                    <= ik.smem_bytes(3, 2, hp, hu, 3)


# (P, S, hp, hu, V, lower_tri) -> (tier, shared bytes, workspace floats,
# CTAs an instance): the bench shape, the side-selection QP of parallel-11
# (55 pairs, 44 obstacle + 22 hard rate slabs) at hp = 10 / 16 / 20,
# circle-4 at hp = 64, circle-8 at hp = 20 and circle-16 at hp = 10 (in the
# shared tier only with their slabs packed), circle-16 at hp = 16. Past the
# shared tier the cluster tier: two CTAs an instance, each with the
# device tier's carve (the vectors, the P blocks, the slack column, the tables),
# its half of the KKT matrix's 16-row stripes, the panel buffer, the
# diagonal-block buffers, the deal and the row pointers.
TIER_SHAPES = {
    "bench": ((6, 0, 20, 20, 4, True), ("shared", 56_192, 0, 1)),
    "parallel11_hp10": ((55, 66, 10, 10, 11, True),
                        ("shared", 153_668, 0, 1)),
    "parallel11_hp16": ((55, 66, 16, 16, 11, True),
                        ("cluster", 171_608, 0, 2)),
    "parallel11_hp20": ((55, 66, 20, 20, 11, True),
                        ("cluster", 227_072, 0, 2)),
    "circle4_hp64": ((6, 0, 64, 64, 4, True), ("cluster", 218_240, 0, 2)),
    "circle8_hp20": ((28, 0, 20, 20, 8, True), ("shared", 203_280, 0, 1)),
    "circle16_hp10": ((120, 0, 10, 10, 16, True), ("shared", 229_744, 0, 1)),
    "circle16_hp16": ((120, 0, 16, 16, 16, True),
                      ("cluster", 232_400, 0, 2)),
}
# whole carves (shared tier) of the shapes past it, for the record
WHOLE_CARVES = {"parallel11_hp16": 329_492, "parallel11_hp20": 481_908,
                "circle4_hp64": 471_904, "circle16_hp16": 516_784}


@pytest.mark.parametrize("name", sorted(TIER_SHAPES))
def test_struct_tier_at_real_shapes(name):
    """The tier function at the side-selection, long-horizon and circle-8 /
    16 shapes: the shared tier where the packed carve fits a block (232,448
    bytes), the cluster tier past it (its C and bytes a CTA); forcing the
    device tier gives the whole carve less the factor and the slabs at
    every shape, and each rank's cluster carve is that plus its stripes."""
    shape, want = TIER_SHAPES[name]
    P, S, hp, hu, V, tri = shape
    t = ik.struct_tier(*shape)
    geo = ik.cluster_geometry(*shape[:5])
    C = geo[0] if t.tier == "cluster" else 1
    assert (t.tier, t.smem_bytes, t.workspace_floats, C) == want
    whole = ik.smem_bytes(*shape)
    nu = V * hu
    rest = whole - 4 * (nu * (nu | 1)
                        + (2 * P + S) * ik.slab_words(hp, hu, tri))
    assert ik.smem_bytes(*shape, device=True) == rest
    assert ik.struct_tier(*shape, tier="device") \
        == ("device", rest, nu * ik.kkt_ld(nu, True), False)
    area = lk.stripe_deal(nu, geo[0])[2]
    assert geo[1] == area and geo[2] == ik.cluster_smem_bytes(
        P, S, hp, hu, V, geo[0], area) <= ik.SMEM_LIMIT_BYTES
    assert ik.struct_tier(*shape, tier="cluster") == ("cluster", geo[2], 0,
                                                      False)
    if t.tier == "cluster":
        assert whole == WHOLE_CARVES[name] > ik.SMEM_LIMIT_BYTES
        assert not ik.fits_smem(*shape)
        assert geo[2] - rest >= 4 * area
    else:
        assert whole == want[1] <= ik.SMEM_LIMIT_BYTES
        assert ik.fits_smem(*shape)
    assert ik.kkt_ld(nu, True) % 32 == 0 and ik.kkt_ld(nu, False) % 2 == 1


def test_struct_tier_raises_only_past_the_device_tier():
    """Past the device tier's own carve (parallel-11 at hp = 64: 567,444
    bytes of vectors alone) the global tier takes the shape (its vectors
    and the KKT matrix in device memory: 1,320 bytes a CTA); the device tier
    forced there raises, naming the bytes and the whole carve; a tier
    forced past its own carve raises too, and an unknown tier's name is
    refused."""
    assert ik.struct_tier(55, 66, 64, 64, 11, True) \
        == ("global", 1_320, 87_328 + 704 * 704, False)
    with pytest.raises(NotImplementedError,
                       match="567444 bytes .* device tier .*4017044 with"):
        ik.struct_tier(55, 66, 64, 64, 11, True, tier="device")
    with pytest.raises(ValueError, match="unknown tier"):
        ik.struct_tier(6, 0, 20, 20, 4, True, tier="banded")
    with pytest.raises(NotImplementedError, match="shared tier"):
        ik.struct_tier(55, 66, 20, 20, 11, True, tier="shared")
    with pytest.raises(NotImplementedError, match="cluster tier"):
        ik.struct_tier(55, 66, 64, 64, 11, True, tier="cluster")


# (P, S, hp, hu, V) -> (bytes a CTA, workspace floats an instance) of K1's
# global tier: parallel-11's side-selection QP at hp = 32 (the first
# horizon past the device tier's carve, 239,380 bytes) and 64, circle-16 at
# hp = 28 (235,184 bytes of device-tier carve) and 64 (the vectors, then
# the 1,024 x 1,024 KKT matrix), and forced at the bench shape and at
# (l1)'s (parallel-11, hp = 20).
GLOBAL_SHAPES = {
    "parallel11_hp32": ((55, 66, 32, 32, 11), (1_320, 43_680 + 352 * 352)),
    "parallel11_hp64": ((55, 66, 64, 64, 11), (1_320, 87_328 + 704 * 704)),
    "circle16_hp28": ((120, 0, 28, 28, 16), (2_116, 41_472 + 448 * 448)),
    "circle16_hp64": ((120, 0, 64, 64, 16), (2_116, 94_752 + 1024 * 1024)),
    "bench_forced": ((6, 0, 20, 20, 4), (244, 3_136 + 80 * 96)),
    "l1_forced": ((55, 66, 20, 20, 11), (1_320, 27_328 + 220 * 224)),
}


@pytest.mark.parametrize("name", sorted(GLOBAL_SHAPES))
def test_global_geometry(name):
    """K1's global tier: the bytes a CTA (the scratch, the tables and the
    flag) and the workspace an instance (the vectors rounded up to 32
    floats, then the ``nu x ldk`` KKT matrix); ``struct_tier`` takes it
    where the device tier's carve exceeds a block and ``tier="global"``
    forces it anywhere."""
    shape, want = GLOBAL_SHAPES[name]
    P, S, hp, hu, V = shape
    g = ik.global_geometry(*shape)
    assert (g.smem_bytes, g.workspace_floats) == want
    assert g.smem_bytes == ik.global_smem_bytes(*shape) \
        == 4 * (32 + V * V + 2 * P + S + 1) <= ik.SMEM_LIMIT_BYTES
    nu = V * hu
    assert g.vec_floats == ik.global_layout(*shape)["K"][0]
    assert g.workspace_floats == g.vec_floats + nu * ik.kkt_ld(nu, True)
    forced = ik.struct_tier(*shape, True, tier="global")
    assert forced == ("global", g.smem_bytes, g.workspace_floats, False)
    if name.endswith("_forced"):
        assert ik.struct_tier(*shape, True).tier != "global"
    else:
        assert ik.smem_bytes(*shape, True, True) > ik.SMEM_LIMIT_BYTES
        assert ik.struct_tier(*shape, True) == forced
        assert ik.struct_tier(*shape, False) == forced


@pytest.mark.parametrize("shape", [shape for shape, _ in GLOBAL_SHAPES.values()]
                         + [(3, 2, 7, 10, 3), (1, 0, 3, 5, 2), (4, 3, 9, 6, 3)])
def test_global_workspace_layout(shape):
    """One instance's slot of the global workspace, mirroring
    ``csrc/ipm_struct.cu::carve_global``: every vector the kernel keeps
    there placed once, in the carve's order, none overlapping another, the
    vectors rounded up to 32 floats, and the KKT matrix from there to the
    slot's end (128-byte rows)."""
    P, S, hp, hu, V = shape
    nu = V * hu
    n, mg = nu + 1, (P + S) * hp
    m = mg + 2 * n
    lay = ik.global_layout(*shape)
    vecs = ["s", "z", "rp", "w", "a1", "a2", "a3", "dz", "ds", "x", "px",
            "dsc", "kb", "rhs", "dx", "dinv"]
    assert list(lay) == vecs + ["K"]
    sizes = {k: m for k in vecs[:9]} | {k: n for k in vecs[9:]}
    end = 0
    for k in vecs:
        assert lay[k] == (end, sizes[k]), k
        end += sizes[k]
    vec = ik.global_geometry(*shape).vec_floats
    assert vec == -(-end // 32) * 32 == -(-(9 * m + 7 * n) // 32) * 32
    spans = sorted(lay.values())
    assert all(a + la <= b for (a, la), (b, _) in zip(spans, spans[1:]))
    assert lay["K"] == (vec, nu * ik.kkt_ld(nu, True))
    assert lay["K"][0] % 32 == 0


def test_global_tier_keyword_runs_the_plain_version_on_the_cpu():
    """``tier="global"`` only says where the kernel keeps its working set:
    on CPU tensors the wrapper runs the plain version, bit for bit the call
    without it, no launch is counted, and that matches scp_tpu's fused
    Pallas iterations (in interpret mode) on the same seeded inputs."""
    arrs, pairs, obst_veh = kernel_inputs(B=B, V=3, hp=5, hu=8, n_obst=1,
                                          seed=14)
    kw = dict(pairs=pairs, obst_veh=obst_veh, tol=1e-6, reg_rel=3e-6,
              n_iters=1, lower_tri=True)
    args = torch_kernel_args(arrs)
    plain = ik.ipm_iterate_struct(*args, **kw)
    for fn in (ik.ipm_iterate_struct, ik.ipm_iterate_struct_plain):
        got = fn(*args, **kw, tier="global")
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert ik.global_launch_count == ik.launch_count == 0
    want = _pallas(arrs, pairs, obst_veh, 5, 8, n_iters=1, n_cor=0,
                   lower_tri=True)
    got = dict(zip(STATE_NAMES, (g.numpy() for g in got)))
    for k in ("x", "zg", "zu", "zl", "rpg", "rpu", "rpl"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("shape", [(55, 66, 20, 20, 11), (6, 0, 64, 64, 4),
                                   (6, 0, 20, 20, 4), (120, 0, 16, 16, 16),
                                   (3, 2, 7, 10, 3)])
def test_cluster_geometry(shape):
    """K1's cluster tier: the smallest of STRUCT_CLUSTER_SIZES whose ranks
    each fit a block; the stripes cover the KKT matrix's lower triangle
    once, and no smaller cluster fits."""
    P, S, hp, hu, V = shape
    C, area, need = ik.cluster_geometry(*shape)
    nu = V * hu
    assert C in ik.STRUCT_CLUSTER_SIZES and need <= ik.SMEM_LIMIT_BYTES
    for smaller in ik.STRUCT_CLUSTER_SIZES[:ik.STRUCT_CLUSTER_SIZES.index(C)]:
        assert ik.cluster_smem_bytes(
            P, S, hp, hu, V, smaller, lk.stripe_deal(nu, smaller)[2]) \
            > ik.SMEM_LIMIT_BYTES
    assert_stripes_cover(nu, C)


def test_cluster_tier_keyword_runs_the_plain_version_on_the_cpu():
    """``tier="cluster"`` only picks where the kernel keeps its KKT matrix:
    on CPU tensors the wrapper runs the plain version, bit for bit the call
    without it, and that matches scp_tpu's fused Pallas iterations (in
    interpret mode) on the same seeded inputs."""
    arrs, pairs, obst_veh = kernel_inputs(B=B, V=3, hp=5, hu=8, n_obst=1,
                                          seed=12)
    kw = dict(pairs=pairs, obst_veh=obst_veh, tol=1e-6, reg_rel=3e-6,
              n_iters=1, lower_tri=True)
    args = torch_kernel_args(arrs)
    plain = ik.ipm_iterate_struct(*args, **kw)
    got = ik.ipm_iterate_struct(*args, **kw, tier="cluster")
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert ik.launch_count == ik.cluster_launch_count == 0
    want = _pallas(arrs, pairs, obst_veh, 5, 8, n_iters=1, n_cor=0,
                   lower_tri=True)
    got = dict(zip(STATE_NAMES, (g.numpy() for g in got)))
    for k in ("x", "zg", "zu", "zl", "rpg", "rpu", "rpl"):
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=1e-4,
                                   err_msg=k)


def test_device_tier_keyword_runs_the_plain_version_on_the_cpu():
    """``tier="device"`` only picks where the kernel keeps its working set:
    on CPU tensors the wrapper runs the plain version, bit for bit the call
    without it, and the plain version takes the keyword too."""
    arrs, pairs, obst_veh = kernel_inputs(B=3, V=2, hp=4, hu=4, n_obst=1,
                                          seed=8)
    kw = dict(pairs=pairs, obst_veh=obst_veh, tol=1e-6, reg_rel=3e-6,
              n_iters=3, lower_tri=True)
    args = torch_kernel_args(arrs)
    want = ik.ipm_iterate_struct(*args, **kw)
    for fn in (ik.ipm_iterate_struct, ik.ipm_iterate_struct_plain):
        got = fn(*args, **kw, tier="device")
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ik.launch_count == ik.device_launch_count == 0


@pytest.mark.parametrize("breakage", ["shape", "dtype", "pairs", "order"])
def test_wrapper_checks_its_arguments(breakage):
    arrs, pairs, obst_veh = kernel_inputs(B=2, V=2, hp=4, hu=4, n_obst=1,
                                          seed=7)
    args = torch_kernel_args(arrs)
    state = tuple(args[7:])
    if breakage == "shape":
        args[5] = args[5][:, :-1]
    elif breakage == "dtype":
        args[5] = args[5].double()
    elif breakage == "pairs":
        pairs = pairs + ((0, 1),)
    else:
        pairs = ((1, 0),)
    with pytest.raises(ValueError):
        ik._check_shapes(*args[:7], state if breakage != "shape"
                         else tuple(args[7:]), pairs, obst_veh)


def test_library_is_keyed_by_a_hash_of_the_sources():
    from scp_tpu_torch.ops import _cuda_build as cb
    path = cb.library_path()
    assert path.parent.name == "build" and path.suffix == ".so"
    assert path == cb.library_path()
    # every kernel source of csrc/ goes into the one library
    assert {p.name for p in cb.sources()} == {
        "ipm_dense.cu", "ipm_dense_global.cu", "ipm_struct.cu", "linalg.cu",
        "riccati.cu"}
    for header in ("chol_blocked.cuh", "ipm_common.cuh", "ipm_dense.cuh",
                   "smem.cuh"):
        assert (cb.CSRC / header).exists()
    old = cb.BUILD_DEFINES
    cb.BUILD_DEFINES = ("SCP_PROFILE_SECTIONS",)
    try:
        assert cb.library_path() != path
    finally:
        cb.BUILD_DEFINES = old
