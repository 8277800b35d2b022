"""The banded (Riccati) KKT path of the port against ``scp_tpu``'s, on the
CPU, on the same numpy-seeded SCP-iteration QPs:

* ``solve_qp(banded=...)`` (fixed and adaptive) against
  ``vmap(scp_tpu.solve_qp, banded=...)`` in float64: iterates within 1e-8,
  iteration counts and flags equal;
* the banded branch of ``solve_qp_batched`` in float64 against the same
  (on a CPU backend ``scp_tpu``'s batched banded call IS that vmap, and the
  lane iteration is ``solve_qp``'s with no correctors), and in float32
  against ``scp_tpu``'s lane branch with the Pallas kernels in interpret
  mode (2e-3 relative / 2e-5 absolute on x: the limits
  ``tests/test_riccati.py`` holds that branch to against its own vmap);
* banded against dense on the same QP (float64 round-off: 1e-7);
* ``kkt="auto"`` routes by shape: the structured kernel below its
  shared-memory gate, the banded branch above it;
* ``solve_scp(qp_kkt="banded")``, ``solve_scp_stacked`` with the stage
  statement, ``mpc_step`` / ``mpc_step_batch`` with ``qp_kkt="banded"``
  against ``scp_tpu`` in float64.
"""
import jax
import numpy as np
import pytest
import torch

from scp_tpu.ops import pallas_linalg as jpll
from scp_tpu.ops import pallas_riccati as jpr
from scp_tpu.sim import engine as jengine
from scp_tpu.solvers import qp as jqp
from scp_tpu.solvers import scp as jscp
from scp_tpu_torch import convert
from scp_tpu_torch.ops import ipm_kernel, riccati_kernel
from scp_tpu_torch.sim import engine as tengine
from scp_tpu_torch.solvers import qp as tqp
from scp_tpu_torch.solvers import scp as tscp

from torch_parity import (assert_close, jax_problem, scenario_pair,
                          scp_qp_data, tonp)

DENSE_KEYS = ("P", "q", "G", "h", "lb", "ub", "x0")


def _jax_solve_qp(ja, **kw):
    def one(P, q, G, h, lb, ub, x0, bd):
        return jqp.solve_qp(P, q, G, h, lb, ub, x0=x0, banded=bd, **kw)
    return jax.jit(jax.vmap(one))(*[ja[k] for k in DENSE_KEYS],
                                  ja["banded"])


@pytest.mark.parametrize("fixed_iters", [8, None])
def test_solve_qp_banded_matches_scp_tpu_float64(fixed_iters):
    ja, ta = scp_qp_data("circle", 3, 5, np.float64, n_veh=3, banded=True)
    kw = dict(fixed_iters=fixed_iters, tol=1e-8, max_iter=30)
    want = _jax_solve_qp(ja, **kw)
    got = tqp.solve_qp(*[ta[k] for k in DENSE_KEYS[:6]], x0=ta["x0"],
                       banded=ta["banded"], **kw)
    assert_close(got.x, want.x, 1e-8, name="x")
    assert_close(got.z, want.z, 1e-8 * float(np.abs(want.z).max()),
                 name="z")
    assert_close(got.iters, want.iters, 0, name="iters")
    assert_close(got.converged, want.converged, 0, name="converged")
    assert_close(got.obj, want.obj, 1e-8 * float(np.abs(want.obj).max()))


def test_solve_qp_banded_unbatched_call_and_frog():
    """One vehicle (no pair rows, obstacle rows only) through the unbatched
    B = 1 view."""
    ja, ta = scp_qp_data("frog", 1, 6, np.float64, banded=True)
    want = _jax_solve_qp(ja, fixed_iters=None, tol=1e-8)
    got = tqp.solve_qp(*[ta[k][0] for k in DENSE_KEYS[:6]],
                       x0=ta["x0"][0], tol=1e-8,
                       banded=tqp.BandedData(*[t[0] for t in ta["banded"]]))
    assert got.x.ndim == 1
    assert_close(got.x, want.x[0], 1e-8, name="x")
    assert int(got.iters) == int(want.iters[0])


@pytest.mark.parametrize("fixed_iters", [6, None])
def test_banded_branch_of_solve_qp_batched_float64(fixed_iters):
    ja, ta = scp_qp_data("circle", 3, 5, np.float64, n_veh=3, banded=True)
    want = _jax_solve_qp(ja, fixed_iters=fixed_iters, tol=1e-8)
    got = tqp.solve_qp_batched(
        None, ta["q"], None, ta["h"], ta["lb"], ta["ub"], x0=ta["x0"],
        fixed_iters=fixed_iters, tol=1e-8, p_blocks=ta["p_blocks"],
        slack_schur=True, g_struct=ta["g_struct"], g_slabs=ta["g_slabs"],
        banded=ta["banded"], kkt="banded")
    assert_close(got.x, want.x, 1e-8, name="x")
    assert_close(got.iters, want.iters, 0, name="iters")
    assert_close(got.converged, want.converged, 0, name="converged")
    # the same branch on the dense rows (no pair statement) agrees too
    dense = tqp.solve_qp_batched(
        ta["P"], ta["q"], ta["G"], ta["h"], ta["lb"], ta["ub"],
        x0=ta["x0"], fixed_iters=fixed_iters, tol=1e-8,
        banded=ta["banded"], kkt="banded")
    assert_close(dense.x, want.x, 1e-8, name="dense-row x")


def test_banded_branch_matches_pallas_lane_interpret_float32():
    ja, ta = scp_qp_data("circle", 2, 4, np.float32, n_veh=2, banded=True)
    kw = dict(fixed_iters=5, tol=1e-6, kkt="banded")
    old = (jpll.INTERPRET, jpr.INTERPRET)
    jpll.INTERPRET = jpr.INTERPRET = True
    try:
        want = jqp.solve_qp_batched(
            None, ja["q"], ja["G"], ja["h"], ja["lb"], ja["ub"],
            x0=ja["x0"], use_pallas=True, p_blocks=ja["p_blocks"],
            slack_schur=True, g_struct=ja["g_struct"],
            g_slabs=ja["g_slabs"], banded=ja["banded"], **kw)
    finally:
        jpll.INTERPRET, jpr.INTERPRET = old
    got = tqp.solve_qp_batched(
        None, ta["q"], None, ta["h"], ta["lb"], ta["ub"], x0=ta["x0"],
        p_blocks=ta["p_blocks"], slack_schur=True, g_struct=ta["g_struct"],
        g_slabs=ta["g_slabs"], banded=ta["banded"], **kw)
    assert got.x.dtype == torch.float32
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=2e-3,
                               atol=2e-5)


def test_banded_equals_dense_on_the_same_qp():
    _, ta = scp_qp_data("circle", 3, 5, np.float64, n_veh=3, banded=True)
    common = dict(x0=ta["x0"], tol=1e-10, max_iter=40)
    dense = tqp.solve_qp_batched(ta["P"], ta["q"], ta["G"], ta["h"],
                                 ta["lb"], ta["ub"], **common)
    band = tqp.solve_qp_batched(None, ta["q"], None, ta["h"], ta["lb"],
                                ta["ub"], p_blocks=ta["p_blocks"],
                                slack_schur=True, g_struct=ta["g_struct"],
                                g_slabs=ta["g_slabs"], banded=ta["banded"],
                                kkt="banded", **common)
    assert_close(band.x, dense.x.numpy(), 1e-7, name="x")
    assert bool(band.converged.all()) and bool(dense.converged.all())


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("past_gate", [False, True])
def test_auto_routes_by_shape(monkeypatch, past_gate):
    """kkt="auto": the structured kernel where its shared-memory tier holds
    the shape (the carve with the slabs packed, as the launch stores
    them), the banded branch just past it (the limit is moved to the test
    shape, so the CPU plain path stays small); without a stage statement
    K1's device tier takes the shape, and past that tier's own carve its
    global tier."""
    _, ta = scp_qp_data("circle", 2, 5, np.float64, n_veh=3, banded=True)
    tri = bool(ta["g_struct"][4])
    need = ipm_kernel.smem_bytes(3, 0, 5, 5, 3, tri)
    monkeypatch.setattr(ipm_kernel, "SMEM_LIMIT_BYTES",
                        need - 1 if past_gate else need)
    calls = []
    _spy(monkeypatch, ipm_kernel, "ipm_iterate_struct", calls)
    _spy(monkeypatch, riccati_kernel, "riccati_factor", calls)
    kw = dict(x0=ta["x0"], fixed_iters=6, tol=1e-8, p_blocks=ta["p_blocks"],
              slack_schur=True, g_struct=ta["g_struct"],
              g_slabs=ta["g_slabs"], kkt="auto")
    sol = tqp.solve_qp_batched(None, ta["q"], None, ta["h"], ta["lb"],
                               ta["ub"], banded=ta["banded"], **kw)
    if past_gate:
        assert set(calls) == {"riccati_factor"} and len(calls) == 6
        # without a stage statement: K1's device tier
        calls.clear()
        dev = tqp.solve_qp_batched(None, ta["q"], None, ta["h"], ta["lb"],
                                   ta["ub"], **kw)
        assert calls == ["ipm_iterate_struct"]
        assert ipm_kernel.struct_tier(3, 0, 5, 5, 3, tri).tier == "device"
        assert bool(torch.isfinite(dev.x).all())
        # past the device tier's own carve K1's global tier takes the
        # shape (the vectors in device memory too): the same plain version
        # here, bit for bit
        monkeypatch.setattr(ipm_kernel, "SMEM_LIMIT_BYTES",
                            ipm_kernel.smem_bytes(3, 0, 5, 5, 3, tri,
                                                  device=True) - 1)
        assert ipm_kernel.struct_tier(3, 0, 5, 5, 3, tri).tier == "global"
        calls.clear()
        glob = tqp.solve_qp_batched(None, ta["q"], None, ta["h"], ta["lb"],
                                    ta["ub"], **kw)
        assert calls == ["ipm_iterate_struct"]
        assert torch.equal(glob.x, dev.x)
    else:
        assert calls == ["ipm_iterate_struct"]
    assert bool(torch.isfinite(sol.x).all())


@pytest.mark.parametrize("correctors,refine_steps,solves", [
    (0, 0, 2), (1, 0, 3), (0, 1, 4)])
def test_banded_kkt_two_solves_per_factor(monkeypatch, correctors,
                                          refine_steps, solves):
    """One Mehrotra iteration of the banded KKT: one Riccati factor, and
    the border column solved with the predictor's right-hand side in ONE
    two-right-hand-side solve; the corrector, each Gondzio corrector and
    each refinement step take one more solve of one right-hand side."""
    ja, ta = scp_qp_data("circle", 2, 4, np.float64, n_veh=2, banded=True)
    calls = []
    real_f, real_s = (riccati_kernel.riccati_factor,
                      riccati_kernel.riccati_solve)

    def factor(*a):
        calls.append("factor")
        return real_f(*a)

    def solve(*a):
        calls.append(f"solve{a[-1].shape[0] if a[-1].ndim == 4 else 1}")
        return real_s(*a)
    monkeypatch.setattr(riccati_kernel, "riccati_factor", factor)
    monkeypatch.setattr(riccati_kernel, "riccati_solve", solve)
    kw = dict(fixed_iters=1, tol=1e-8, correctors=correctors,
              refine_steps=refine_steps)
    got = tqp.solve_qp(*[ta[k] for k in DENSE_KEYS[:6]], x0=ta["x0"],
                       banded=ta["banded"], **kw)
    assert calls == ["factor", "solve2"] + ["solve1"] * (solves - 1)
    want = _jax_solve_qp(ja, **kw)
    assert_close(got.x, want.x, 1e-8, name="x")


def _problems(kind, b, hp, seed, **kw):
    cfg_j, data_j, cfg_t, data_t = scenario_pair(
        kind, b, seed, np.float64, cfg_over=dict(hp=hp, hu=hp,
                                                 qp_kkt="banded"), **kw)
    problem_j, _, carry_j = jax_problem(cfg_j, data_j)
    problem_t = convert.problem_from_numpy(tonp(problem_j), torch.float64,
                                           "cpu")
    assert problem_t.banded_pre is not None
    return cfg_j, problem_j, carry_j, cfg_t, problem_t


SCP_KW = dict(max_scp_iter=4, qp_tol=1e-9, qp_max_iter=25)


@pytest.mark.parametrize("qp_fixed_iters", [None, 8])
def test_solve_scp_banded_matches_scp_tpu(qp_fixed_iters):
    cfg_j, problem_j, carry_j, _, problem_t = _problems("circle", 2, 5, 6,
                                                        n_veh=3)
    kw = dict(u_lim=cfg_j.u_lim, qp_kkt="banded",
              qp_fixed_iters=qp_fixed_iters, **SCP_KW)
    want = jax.vmap(lambda p, u: jscp.solve_scp(p, u, **kw))(
        problem_j, carry_j.u_warm)
    got = tscp.solve_scp(problem_t, torch.zeros((2, 15), dtype=torch.float64),
                         **kw)
    assert_close(got.u, want.u, 5e-8, name="u")
    for f in ("iters", "qp_iters", "feasible", "converged", "qp_fails"):
        assert_close(getattr(got, f), getattr(want, f), 0, name=f)


@pytest.mark.parametrize("qp_kkt", ["banded", "auto"])
def test_solve_scp_stacked_with_stage_statement(qp_kkt):
    """The stacked solver hands the stage statement to the batched QP. On a
    CPU backend ``scp_tpu`` solves it as vmap(solve_qp, banded=...) for
    "banded" and "auto" alike; the port routes "auto" by shape (the
    structured kernel's plain version here), the same system to float64
    round-off."""
    cfg_j, problem_j, carry_j, _, problem_t = _problems("circle", 2, 5, 8,
                                                        n_veh=3)
    kw = dict(u_lim=cfg_j.u_lim, qp_kkt=qp_kkt, qp_fixed_iters=8, **SCP_KW)
    want = jscp.solve_scp_stacked(problem_j, carry_j.u_warm, **kw)
    got = tscp.solve_scp_stacked(problem_t,
                                 torch.zeros((2, 15), dtype=torch.float64),
                                 **kw)
    assert_close(got.u, want.u, 5e-8, name="u")
    for f in ("iters", "feasible", "converged"):
        assert_close(getattr(got, f), getattr(want, f), 0, name=f)


def test_solve_scp_banded_needs_the_stage_statement():
    _, _, _, _, problem_t = _problems("circle", 1, 5, 6, n_veh=2)
    bare = problem_t._replace(banded_pre=None)
    for fn in (tscp.solve_scp, tscp.solve_scp_stacked):
        with pytest.raises(ValueError, match="banded_pre"):
            fn(bare, torch.zeros((1, 10), dtype=torch.float64), u_lim=0.05,
               qp_kkt="banded")


def test_mpc_step_banded_three_chained_steps():
    """mpc_step (per-instance SCP) and mpc_step_batch (stacked SCP) with
    qp_kkt="banded": three chained steps, circle 3 vehicles, hp = 5, float64,
    against scp_tpu's."""
    cfg_j, data_j, cfg_t, data_t = scenario_pair(
        "circle", 2, 12, np.float64,
        cfg_over=dict(hp=5, hu=5, qp_kkt="banded", max_scp_iter=4,
                      qp_max_iter=25), n_veh=3)
    carry_j = jax.vmap(lambda d: jengine.init_carry(cfg_j, d))(data_j)
    step_j = jax.jit(jax.vmap(lambda d, c: jengine.mpc_step(cfg_j, d, c)))
    c_t = tengine.init_carry(cfg_t, data_t)
    c_b = tengine.init_carry(cfg_t, data_t)
    for i in range(3):
        carry_j, out_j = step_j(data_j, carry_j)
        c_t, out_t = tengine.mpc_step(cfg_t, data_t, c_t)
        c_b, out_b = tengine.mpc_step_batch(cfg_t, data_t, c_b,
                                            phases=((4, 1),))
        assert_close(out_t.u_pred, out_j.u_pred, 5e-6, name=f"u_pred {i}")
        assert_close(out_t.states, out_j.states, 1e-5, name=f"states {i}")
        assert_close(out_t.feasible, out_j.feasible, 0, name="feasible")
        assert_close(out_t.scp_iters, out_j.scp_iters, 0, name="scp_iters")
        assert_close(out_b.u_pred, out_j.u_pred, 5e-6, name=f"batch {i}")
        assert_close(out_b.feasible, out_j.feasible, 0, name="batch feas")
