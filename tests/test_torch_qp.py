"""solve_qp_batched of the port (the fixed-iteration structured branch; the
adaptive branch is held in test_torch_solve_qp.py)
against scp_tpu.solvers.qp.solve_qp_batched on real SCP sub-problems: the QP
of one SCP iteration of a small circle (vehicles meet inside the horizon, so
avoidance rows are active) or of the parallel-lanes scenario (obstacle
slabs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.ops import pallas_linalg as pll
from scp_tpu.solvers import qp as jqp
from scp_tpu_torch.solvers import qp as tqp

from torch_parity import SLACK_W, assert_close, scp_qp_data as _qp_data

def _solve_j(a, **kw):
    return jqp.solve_qp_batched(
        a["P"], a["q"], a["G"], a["h"], a["lb"], a["ub"], x0=a["x0"],
        p_blocks=a["p_blocks"], slack_schur=True, g_struct=a["g_struct"],
        g_slabs=a["g_slabs"], **kw)


def _solve_t(a, **kw):
    return tqp.solve_qp_batched(
        None, a["q"], None, a["h"], a["lb"], a["ub"], x0=a["x0"],
        p_blocks=a["p_blocks"], slack_schur=True, g_struct=a["g_struct"],
        g_slabs=a["g_slabs"], **kw)


@pytest.mark.parametrize("kind,kw", [
    ("circle", dict(n_veh=3, radius=8.0)),
    ("parallel", dict(n_veh=3)),
])
def test_f64_matches_scp_tpu_vmap_fallback(kind, kw):
    """float64, 14 fixed iterations. scp_tpu's CPU fallback is
    vmap(solve_qp): the same Mehrotra method on the dense KKT matrix with a
    recomputed primal residual, where the port eliminates the slack by a
    Schur step and carries the residual by recurrence — identical in exact
    arithmetic. 1e-7 on the controls (rad), 1e-6 relative on the objective
    leave room for the two factorizations' float64 round-off through
    barrier weights of up to 1e12."""
    ja, ta = _qp_data(kind, 6, 6, np.float64, **kw)
    want = _solve_j(ja, fixed_iters=14, tol=1e-8, use_pallas=False)
    got = _solve_t(ta, fixed_iters=14, tol=1e-8)
    n = ja["q"].shape[1] - 1
    assert_close(got.x[:, :n], want.x[:, :n], 1e-7, name="x")
    assert_close(got.x[:, n], want.x[:, n], 1e-5, rtol=1e-6, name="slack")
    assert_close(got.obj, want.obj, 1e-6, rtol=1e-6, name="obj")
    assert_close(got.converged, want.converged, 0)
    assert_close(got.z, want.z, 1e-3, rtol=1e-3, name="z")
    assert got.iters.tolist() == [14] * 6
    assert got.z.shape == want.z.shape and got.gap.shape == (6,)


@pytest.mark.parametrize("hp,kind,kw", [
    (8, "circle", dict(n_veh=3, radius=8.0)),
    (8, "parallel", dict(n_veh=2)),
    # (n - 1) % 8 != 0: scp_tpu appends a ghost alignment vehicle, the port
    # takes nu = 30 as it is; the padded QP is separable, the optimum equal
    (10, "circle", dict(n_veh=3, radius=8.0)),
])
def test_f32_matches_scp_tpu_fused_kernel_interpret(hp, kind, kw):
    """float32, the Pallas kernel in interpret mode (use_pallas=True) against
    the port's plain version, 12 fixed iterations. Both are at the float32
    floor of the same optimum: 2e-4 rad on the controls (box +-0.052), the
    tolerance scp_tpu's own tests hold its fused path to. The objective is a
    small difference of large terms (|q| ~ 1e3 per control), so it is held to
    what 2e-4 on every control can move it, 2e-4 * sum|q_u|, plus the slack's
    weight 1e5 times a float32-sized 5e-7 disagreement on the slack."""
    ja, ta = _qp_data(kind, 8, hp, np.float32, **kw)
    old = pll.INTERPRET
    pll.INTERPRET = True
    try:
        want = jax.jit(lambda: _solve_j(ja, fixed_iters=12, tol=1e-6,
                                        use_pallas=True, certificate=False))()
    finally:
        pll.INTERPRET = old
    got = _solve_t(ta, fixed_iters=12, tol=1e-6, certificate=False)
    n = ja["q"].shape[1] - 1
    assert got.x.shape == want.x.shape and got.z.shape == want.z.shape
    if (n % 8) == 0:
        assert_close(got.x[:, :n], want.x[:, :n], 2e-4, name="x")
    else:
        # Ghost padding changes mu's normalisation (m counts the ghost box
        # rows), so the two runs take different IPM trajectories and stop
        # at different points of the same float32 neighbourhood. Both are
        # then held against a tight float64 solve of the port: the port
        # must be as close to it as scp_tpu is (x1.5 + 1e-3 rad), and the
        # two within 6e-3 rad of each other (median 1e-3).
        ta64 = {k: (v.double() if isinstance(v, torch.Tensor) else v)
                for k, v in ta.items()}
        ta64["g_slabs"] = tuple(g.double() for g in ta["g_slabs"])
        oracle = _solve_t(ta64, fixed_iters=30, tol=1e-10).x[:, :n].numpy()
        e_port = np.abs(got.x[:, :n].numpy() - oracle).max(axis=1)
        e_jax = np.abs(np.asarray(want.x)[:, :n] - oracle).max(axis=1)
        e_both = np.abs(got.x[:, :n].numpy()
                        - np.asarray(want.x)[:, :n]).max(axis=1)
        assert np.all(e_port <= 1.5 * e_jax + 1e-3), (e_port, e_jax)
        assert e_both.max() <= 6e-3 and np.median(e_both) <= 1e-3, e_both
        return
    obj_tol = 2e-4 * np.abs(np.asarray(ja["q"])[:, :n]).sum(axis=1) \
        + SLACK_W * 5e-7
    assert np.all(np.abs(got.obj.numpy() - np.asarray(want.obj)) <= obj_tol)
    assert np.mean(got.converged.numpy() == np.asarray(want.converged)) >= 0.75


def test_dual_warm_start_and_honest_certificate():
    ja, ta = _qp_data("circle", 6, 6, np.float64, n_veh=3, radius=8.0)
    cold_j = _solve_j(ja, fixed_iters=14, tol=1e-8, use_pallas=False)
    cold_t = _solve_t(ta, fixed_iters=14, tol=1e-8)
    z0 = np.asarray(cold_j.z).copy()
    z0[:, ::3] = 0.0                      # "no information" entries
    warm_j = _solve_j(ja, fixed_iters=8, tol=1e-8, use_pallas=False,
                      z0=jnp.asarray(z0))
    warm_t = _solve_t(ta, fixed_iters=8, tol=1e-8, z0=torch.as_tensor(z0))
    n = ja["q"].shape[1] - 1
    assert_close(warm_t.x[:, :n], warm_j.x[:, :n], 1e-6, name="warm x")
    # both certificates agree on a well-converged solve
    cheap = _solve_t(ta, fixed_iters=14, tol=1e-8, certificate=False)
    assert torch.equal(cheap.converged, cold_t.converged)
    assert torch.equal(cheap.x, cold_t.x)


def test_hard_rows_keep_the_slack_out():
    """A row whose slack coefficient is masked to 0 is a hard constraint: at
    the solution it holds without the slack's help."""
    ja, ta = _qp_data("parallel", 4, 6, np.float64, n_veh=3)
    mg = ta["h"].shape[1]
    mask = np.ones(mg)
    mask[-6:] = 0.0                       # the last obstacle block: hard
    sol = _solve_t(ta, fixed_iters=16, tol=1e-8, g_slack_mask=mask)
    gob = ta["g_slabs"][2]
    x = sol.x
    lhs = torch.einsum("bku,bu->bk", gob[:, -1, -1], x[:, 12:18])
    assert bool((lhs <= ta["h"][:, -6:] + 1e-6).all())
    assert bool(torch.isfinite(sol.x).all())


@pytest.mark.parametrize("breakage", [
    "adaptive", "banded", "no_schur", "no_blocks", "no_slabs", "no_struct",
    "dense_P", "dense_G", "single_vehicle"])
def test_unported_branches_raise(breakage):
    """Every fixed-count argument combination now has a branch (roadmap
    items 7b and 8 are ported): the structured kernel, the dense-G kernel
    (no engaged structure, the dense G read) or the banded branch, and each
    lands on the structured branch's solution (float64, 14 iterations: 1e-6
    rad on the controls). Only the adaptive branch handed slabs alone still
    raises: it reads the dense G. One vehicle (no pair) runs the dense-G
    kernel and lands on the adaptive dense solve."""
    single = breakage == "single_vehicle"
    _, ta = (_qp_data("frog", 2, 6, np.float64) if single else
             _qp_data("circle", 2, 6, np.float64, n_veh=2, radius=8.0,
                      banded=breakage == "banded"))
    kw = dict(fixed_iters=14, tol=1e-8, p_blocks=ta["p_blocks"],
              slack_schur=True, g_struct=ta["g_struct"],
              g_slabs=ta["g_slabs"], kkt="auto")
    args = (ta["q"], ta["h"], ta["lb"], ta["ub"])
    P = G = None
    if breakage == "adaptive":
        with pytest.raises(ValueError, match="dense G"):
            tqp.solve_qp_batched(None, ta["q"], None, *args[1:],
                                 **{**kw, "fixed_iters": None})
        return
    if single:
        ref = tqp.solve_qp_batched(ta["P"], ta["q"], ta["G"], *args[1:],
                                   x0=ta["x0"], tol=1e-10, max_iter=40)
    else:
        ref = tqp.solve_qp_batched(None, ta["q"], None, *args[1:],
                                   x0=ta["x0"], **kw)
    if breakage == "banded":
        kw.update(kkt="banded", banded=ta["banded"])
    elif breakage == "no_schur":
        kw["slack_schur"] = False
        G = ta["G"]
    elif breakage == "no_blocks":
        kw["p_blocks"] = None
        P, G = ta["P"], ta["G"]
    elif breakage == "no_slabs":
        kw["g_slabs"] = None
        G = ta["G"]
    elif breakage == "no_struct":
        kw["g_struct"] = None
        G = ta["G"]
    elif breakage == "dense_P":
        P = ta["P"]
    else:                                  # dense_G, single_vehicle
        G = ta["G"]
    sol = tqp.solve_qp_batched(P, ta["q"], G, *args[1:], x0=ta["x0"], **kw)
    n = ta["q"].shape[1] - 1
    assert_close(sol.x[:, :n], ref.x[:, :n].numpy(), 1e-6, name="x")
    assert bool(torch.isfinite(sol.z).all())


def test_auto_kkt_refuses_shapes_beyond_shared_memory():
    """qp_kkt="auto" routes by K1's shared-memory tier, with the slabs as
    the launch stores them (packed under lower_tri): the structured kernel
    at the bench shape and at circle-8, hp = 20 / circle-16, hp = 10 (which
    fit only packed), the banded branch past the tier given a stage
    statement (circle-4, hp = 64), and without one K1 past its shared tier
    (its cluster tier there; the device tier past that) — the fallback
    scp_tpu takes there too; kkt="dense" takes the fused kernel in any
    tier. Past the device tier's own carve (hp = 200) K1's global tier
    takes the shape: the route no longer refuses it."""
    from scp_tpu_torch.ops import ipm_kernel
    assert ipm_kernel.struct_tier(P=6, S=0, hp=64, hu=64, V=4).tier \
        == "cluster"
    assert ipm_kernel.fits_smem(6, 0, 20, 20, 4)
    assert not ipm_kernel.fits_smem(6, 0, 64, 64, 4)

    def route(hp, banded, V=4, kkt="auto"):
        pairs = tuple((i, j) for i in range(V) for j in range(i + 1, V))
        return tqp._route(torch.zeros((1, V * hp + 1)),
                          torch.zeros((1, len(pairs) * hp)), None,
                          fixed_iters=7,
                          p_blocks=torch.zeros((1, V, hp, hp)),
                          slack_schur=True,
                          g_struct=(pairs, (), hp, hp, True),
                          g_slabs=(), banded=banded, kkt=kkt)

    assert route(20, None) == "struct"
    assert route(64, object()) == "banded"
    assert route(64, None) == "struct"
    assert route(64, object(), kkt="dense") == "struct"
    # packed, these fit the shared tier; with whole slab rows they would not
    for V, hp in ((8, 20), (16, 10)):
        P = V * (V - 1) // 2
        assert ipm_kernel.fits_smem(P, 0, hp, hp, V, True)
        assert not ipm_kernel.fits_smem(P, 0, hp, hp, V)
        assert route(hp, object(), V=V) == "struct"
    assert route(200, None) == "struct"
    assert ipm_kernel.struct_tier(6, 0, 200, 200, 4, True).tier == "global"
    assert route(200, object()) == "banded"
    with pytest.raises(ValueError):
        _, ta = _qp_data("circle", 2, 6, np.float64, n_veh=2, radius=8.0)
        tqp.solve_qp_batched(None, ta["q"], None, ta["h"], ta["lb"], ta["ub"],
                             fixed_iters=3, p_blocks=ta["p_blocks"],
                             slack_schur=True, g_struct=ta["g_struct"],
                             g_slabs=ta["g_slabs"], kkt="sparse")
