"""K2's global tier (``ops/ipm_kernel.py``: the dense-G kernel with the
step's vectors in a device-memory workspace, past its device tier's own
carve): where ``dense_tier`` takes it, its workspace as the kernel carves
it, and single-vehicle frog past the device tier's carve against
``scp_tpu`` on the CPU, which falls back from its fused kernel to its XLA
path there.

Tolerances: float64, 1e-8 on the QP's iterate and on the controls (two
orders of the same float64 sums over 4,320 rows; the frog QP at hp = 180
agreed to 3.4e-9 on x), every integer and flag equal.
"""
import ctypes
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from scp_tpu.sim import engine as jengine
from scp_tpu.solvers import qp as jqp
from scp_tpu_torch import config as tcfg
from scp_tpu_torch.ops import ipm_kernel as ik
from scp_tpu_torch.sim import engine as tengine
from scp_tpu_torch.solvers import qp as tqp

from torch_parity import assert_close, jit_fast, scenario_pair, scp_qp_data

# Rows a horizon step of single-vehicle frog's QPs: 22 obstacle rows in
# the SCP step's, two steering-rate rows more in side selection's.
FROG_ROWS = {"side_selection": 24, "scp": 22}


def _frog(kind, hp):
    """(mg, n, nb, d, schur) of frog's QP at hp = hu = ``hp``: one hp x hp
    P block and the slack eliminated."""
    return FROG_ROWS[kind] * hp, hp + 1, 1, hp, True


@pytest.mark.parametrize("kind,last,first", [("side_selection", 168, 169),
                                             ("scp", 177, 178)])
def test_frog_takes_the_global_tier_past_the_cluster_tier(kind, last, first):
    """With no Gondzio corrector (the default and the calibrated settings)
    frog's side-selection QP takes the cluster tier up to hp = 168 and the
    global tier from 169; its SCP QP under qp_kkt="dense" the cluster tier
    up to 177 and the global tier from 178. There no cluster of up to 8
    CTAs holds the stripes and the device tier's carve exceeds a block (at
    hp = 180: 286,072 / 274,552 bytes against 232,448). The route takes K2
    there under "dense", and under "auto" without a stage statement."""
    assert ik.dense_tier(*_frog(kind, last), 0).tier == "cluster"
    for hp in (first, first + 1, 180):
        shape = _frog(kind, hp)
        mg, n, _, _, schur = shape
        t = ik.dense_tier(*shape, 0)
        g = ik.dense_global_geometry(mg, n, schur, 0)
        assert t == ("global", 132, g.workspace_floats, False)
        assert ik.dense_cluster_geometry(mg, n, schur, 0) is None
        assert ik.dense_smem_bytes(*shape, False, 0, device=True) \
            > ik.SMEM_LIMIT_BYTES
        q, h = torch.zeros((1, n)), torch.zeros((1, mg))
        pb = torch.zeros((1, 1, hp, hp))
        for kkt in ("dense", "auto"):
            assert tqp._route(q, h, None, fixed_iters=12, p_blocks=pb,
                              slack_schur=True, g_struct=None, g_slabs=None,
                              banded=None, kkt=kkt) == "dense"
    assert ik.dense_smem_bytes(*_frog(kind, 180), False, 0, device=True) \
        == {"side_selection": 286_072, "scp": 274_552}[kind]


def test_global_carve_at_frog_hp180():
    """K2's global tier at frog's side-selection QP, hp = 180 (mg = 4,320,
    n = 181, nk = 180, no corrector), in words, as the kernel carves it: the
    eight m-vectors 8 x 4,682 = 37,456 and the seven n-vectors 7 x 181 =
    1,267 (dz shares the predictor's a2; no P block, q or pdiag: read in
    place) = 38,723, rounded up to 38,752; the 180 x 192 factor 34,560 ->
    73,312 floats (293,248 bytes) an instance, 94 MB at 320 wide. The SCP
    QP (mg = 3,960): 8 x 4,322 + 1,267 = 35,843 -> 35,872 + 34,560 =
    70,432. Shared memory: the reduction scratch and the flag, 132 bytes,
    at every shape."""
    g = ik.dense_global_geometry(4320, 181, True, 0)
    assert g == (132, 38_752, 73_312)
    assert 4 * g.workspace_floats == 293_248
    assert 320 * 4 * g.workspace_floats == 93_839_360
    assert ik.dense_global_geometry(3960, 181, True, 0) == (132, 35_872,
                                                           70_432)
    # a corrector gives dz its own m-vector
    assert ik.dense_global_geometry(4320, 181, True, 1).vec_floats \
        == -(-(9 * 4682 + 7 * 181) // 32) * 32
    assert ik.dense_global_smem_bytes() == 4 * (32 + 1) == 132


@pytest.mark.parametrize("mg,n,schur,n_cor", [
    (4320, 181, True, 0), (3960, 181, True, 2), (440, 21, True, 1),
    (30, 21, False, 0), (384, 257, True, 1), (7, 5, False, 3)])
def test_dense_global_workspace_layout(mg, n, schur, n_cor):
    """One instance's slot of K2's global workspace, mirroring
    ``csrc/ipm_dense.cuh::carve_dense_global``: every vector the kernel
    keeps there placed once, in the carve's order (dz only with
    correctors), none overlapping another, the vectors rounded up to 32
    floats, and the ``nk x ldk`` factor from there to the slot's end
    (128-byte rows)."""
    nk = n - 1 if schur else n
    m = mg + 2 * n
    lay = ik.dense_global_layout(mg, n, schur, n_cor)
    vm = ["s", "z", "rp", "w", "a1", "a2", "a3", "ds"] + (["dz"] if n_cor
                                                          else [])
    vn = ["x", "px", "dsc", "kb", "rhs", "dx", "dinv"]
    assert list(lay) == vm + vn + ["K"]
    end = 0
    for k in vm + vn:
        assert lay[k] == (end, m if k in vm else n), k
        end += lay[k][1]
    g = ik.dense_global_geometry(mg, n, schur, n_cor)
    assert g.vec_floats == -(-end // 32) * 32 == lay["K"][0]
    assert lay["K"] == (g.vec_floats, nk * ik.kkt_ld(nk, True))
    assert g.workspace_floats == g.vec_floats + nk * ik.kkt_ld(nk, True)
    spans = sorted(lay.values())
    assert all(a + la <= b for (a, la), (b, _) in zip(spans, spans[1:]))
    assert ik.dense_tier(mg, n, 1, nk, schur, n_cor, "global") \
        == ("global", 132, g.workspace_floats, False)


def test_global_launch_arguments_follow_the_prototype():
    """``ipm_kernel.DENSE_GLOBAL_LAUNCH_ARGS`` names the arguments of
    ``csrc/ipm_dense_global.cu::ipm_dense_global_launch`` one by one, in its
    prototype's order and with its types (a pointer for every pointer, the
    stream included; int, float, long)."""
    src = (Path(ik.__file__).parents[1] / "csrc"
           / "ipm_dense_global.cu").read_text()
    proto = re.search(r"\nint ipm_dense_global_launch\((.*?)\)\s*\{", src,
                      re.S).group(1)
    want = []
    for param in proto.split(","):
        ctype, name = re.fullmatch(r"\s*(.*?)\s*(\w+)\s*", param).groups()
        kind = (ctypes.c_void_p if "*" in ctype else
                {"int": ctypes.c_int, "float": ctypes.c_float,
                 "long": ctypes.c_long}[ctype])
        want.append((name, kind))
    assert list(ik.DENSE_GLOBAL_LAUNCH_ARGS) == want
    assert len(want) == 16 + 12 + 10 + 3 + 3


def test_frog_qp_hp180_matches_scp_tpu(monkeypatch):
    """One frog QP at hp = hu = 180, B = 1, float64 (mg = 3,960, n = 181):
    the port's fixed-count dense branch (K2 in its global tier; its plain
    version on the CPU) through ``solve_qp_batched(fixed_iters=12,
    kkt="dense", slack_schur=True, p_blocks=...)`` against scp_tpu's
    ``solve_qp_batched`` on the same inputs (its XLA path: the fused
    kernel's estimate exceeds its budget there): x and the duals within
    1e-8, the convergence flags equal."""
    ja, ta = scp_qp_data("frog", 1, 180, np.float64)
    assert ta["G"].shape == (1, 3960, 181)
    kw = dict(fixed_iters=12, tol=1e-6, correctors=0, slack_schur=True)
    want = jqp.solve_qp_batched(
        ja["P"], ja["q"], ja["G"], ja["h"], ja["lb"], ja["ub"], x0=ja["x0"],
        p_blocks=ja["p_blocks"], **kw)
    tiers, real = [], ik.ipm_iterate_dense

    def spy(G, *a, **k):
        tiers.append(ik.dense_tier(G.shape[1], G.shape[2], 1, 180,
                                   k["schur_slack"], k["n_cor"]).tier)
        return real(G, *a, **k)
    monkeypatch.setattr(ik, "ipm_iterate_dense", spy)
    got = tqp.solve_qp_batched(
        None, ta["q"], ta["G"], ta["h"], ta["lb"], ta["ub"], x0=ta["x0"],
        p_blocks=ta["p_blocks"], kkt="dense", **kw)
    assert tiers == ["global"]
    assert_close(got.x, np.asarray(want.x), 1e-8, name="x")
    assert_close(got.z, np.asarray(want.z), 1e-8, rtol=1e-8, name="z")
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))


def test_frog_side_selection_hp180_matches_scp_tpu(monkeypatch):
    """One calibrated side-selection step of frog at hp = hu = 180, B = 1,
    float64 (``tuned_f32``'s settings and TUNED_F32_SIDE_SELECTION: 8
    fixed IPM iterations a candidate, 12 a round), the port on the CPU (K2's
    plain version, in the global tier: mg = 4,320, n = 181) against
    scp_tpu's ``mpc_step_batch``: the controls within 1e-8, the objectives
    to 1e-6 (rtol 1e-8), every integer and flag (the selection, the rounds,
    feasible, sides_stable) equal. The frog reference line ends before the
    horizon does; both packages sample it alike."""
    over = {**tcfg.TUNED_F32_OVERRIDES, **tcfg.TUNED_F32_SIDE_SELECTION,
            "controller": "side_selection", "hp": 180, "hu": 180}
    cfg_j, data_j, cfg_t, data_t = scenario_pair("frog", 1, seed=5,
                                                 cfg_over=over)
    carry_j = jax.vmap(lambda d: jengine.init_carry(cfg_j, d))(data_j)
    step = jit_fast(lambda d, c: jengine.mpc_step_batch(cfg_j, d, c),
                    data_j, carry_j)
    _, out_j = step(data_j, carry_j)
    out_j = jax.tree_util.tree_map(np.asarray, out_j)

    tiers, real = [], ik.ipm_iterate_dense

    def spy(G, *a, **k):
        tiers.append((G.shape[0], k["n_iters"], ik.dense_tier(
            G.shape[1], G.shape[2], 1, 180, k["schur_slack"],
            k["n_cor"]).tier))
        return real(G, *a, **k)
    monkeypatch.setattr(ik, "ipm_iterate_dense", spy)
    _, out_t = tengine.mpc_step_batch(cfg_t, data_t,
                                      tengine.init_carry(cfg_t, data_t))
    assert tiers == [(5, 8, "global"), (1, 12, "global")]
    for name in out_j._fields:
        want, got = getattr(out_j, name), getattr(out_t, name)
        if want.dtype.kind in "biu":
            assert_close(got, want, 0, name=name)
        elif name in ("obj", "pred_obj"):
            assert_close(got, want, 1e-6, rtol=1e-8, name=name)
        elif name in ("u_applied", "u_pred"):
            assert_close(got, want, 1e-8, name=name)
