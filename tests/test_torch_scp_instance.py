"""The per-instance SCP of the port (solve_scp on a leading batch axis, with
its trace), the adaptive-IPM route of solve_scp_stacked and
solve_scp_batch(stacked=False) against scp_tpu, float64 on the CPU.

scp_tpu's inner QP on the CPU is solve_qp with the blocked XLA Cholesky, the
port's is the same Mehrotra iteration with torch's: the QPs agree to ~1e-8
rad per solve (tests/test_torch_solve_qp.py), compounding over the SCP
iterations, so controls are held to 2e-6 rad, objectives to 1e-6 relative,
violations to 1e-5, and every integer / boolean output (SCP iterations, the
TOTAL of inner IPM iterations, failures, flags, the trace's active mask) must
be identical.
"""
import jax
import numpy as np
import pytest
import torch

from scp_tpu.sim import engine as jengine
from scp_tpu.solvers import scp as jscp
from scp_tpu_torch import convert
from scp_tpu_torch.sim import engine as tengine
from scp_tpu_torch.solvers import scp as tscp

from torch_parity import assert_close, jax_problem, scenario_pair, tonp

EXACT = ("feasible", "converged", "iters", "qp_iters", "qp_fails")


def _setup(kind, b, hp, cfg_over, **kw):
    over = dict(hp=hp, hu=hp, **cfg_over)
    cfg_j, data_j, cfg_t, _ = scenario_pair(kind, b, seed=8, cfg_over=over,
                                            **kw)
    problem_j, _, carry_j = jax_problem(cfg_j, data_j)
    problem_t = convert.problem_from_numpy(tonp(problem_j)._asdict(),
                                           torch.float64, "cpu")
    kw_j = jengine._scp_kwargs(cfg_j)
    assert kw_j == tengine._scp_kwargs(cfg_t)
    skw = dict(kw_j)
    u_lim = skw.pop("u_lim")
    u0_t = torch.as_tensor(np.array(carry_j.u_warm))
    return problem_j, problem_t, carry_j.u_warm, u0_t, u_lim, skw


def _compare(got, want, u_tol=2e-6):
    for name in want._fields:
        if name in EXACT:
            assert_close(getattr(got, name), getattr(want, name), 0,
                         name=name)
    assert_close(got.u, want.u, u_tol, name="u")
    assert_close(got.obj, want.obj, 1e-4, rtol=1e-6, name="obj")
    assert_close(got.max_violation, want.max_violation, 1e-5,
                 name="max_violation")


@pytest.mark.parametrize("kind,kw,over", [
    # the DEFAULT solver settings: adaptive IPM, qp_tol 1e-7, 30 iterations
    ("circle", dict(n_veh=3, radius=8.0), dict()),
    ("circle", dict(n_veh=3, radius=8.0), dict(qp_fixed_iters=14,
                                               qp_tol=1e-8)),
    ("circle", dict(n_veh=3, radius=8.0),
     dict(scp_keep_best=True, merit_patience=2, delta_tol_rel=1e-4,
          u_step_tol=1e-5, qp_correctors=1)),
    ("circle", dict(n_veh=2, radius=6.0), dict(qp_warm_dual=True)),
    ("parallel", dict(n_veh=3), dict()),
    ("frog", dict(), dict()),                    # single vehicle, obstacles
])
def test_solve_scp_matches_vmapped_scp_tpu(kind, kw, over):
    problem_j, problem_t, u0_j, u0_t, u_lim, skw = _setup(kind, 4, 6, over,
                                                          **kw)
    want = jax.jit(jax.vmap(lambda p, u: jscp.solve_scp(
        p, u, u_lim=u_lim, max_scp_iter=6, **skw)))(problem_j, u0_j)
    got = tscp.solve_scp(problem_t, u0_t, u_lim=u_lim, max_scp_iter=6, **skw)
    if kind != "frog":       # (the lone vehicle's first QP already settles)
        assert int(np.asarray(want.iters).max()) > 1
    _compare(got, want)


def test_trace_equals_untraced_and_scp_tpu_trace():
    problem_j, problem_t, u0_j, u0_t, u_lim, skw = _setup(
        "circle", 5, 6, dict(delta_tol_rel=1e-4, u_step_tol=1e-5,
                             merit_patience=2), n_veh=3, radius=12.0)
    want, trace_j = jax.jit(jax.vmap(lambda p, u: jscp.solve_scp(
        p, u, u_lim=u_lim, max_scp_iter=9, trace=True, **skw)))(
            problem_j, u0_j)
    plain = tscp.solve_scp(problem_t, u0_t, u_lim=u_lim, max_scp_iter=9,
                           **skw)
    got, trace_t = tscp.solve_scp(problem_t, u0_t, u_lim=u_lim,
                                  max_scp_iter=9, trace=True, **skw)
    for a, b_ in zip(got, plain):
        assert torch.equal(a, b_)
    _compare(got, want)
    assert trace_t._fields == trace_j._fields
    assert_close(trace_t.active, trace_j.active, 0, name="active")
    assert_close(trace_t.qp_converged, trace_j.qp_converged, 0)
    assert_close(trace_t.obj, trace_j.obj, 1e-4, rtol=1e-6, name="obj")
    assert_close(trace_t.max_violation, trace_j.max_violation, 1e-5)
    assert_close(trace_t.merit, trace_j.merit, 1e-3, rtol=1e-6, name="merit")
    assert_close(trace_t.delta, trace_j.delta, 1e-3, rtol=1e-5, name="delta")
    # the mask says how many iterations each instance ran, and entries of
    # iterations that did not run are zero
    assert torch.equal(trace_t.active.sum(dim=1).to(torch.int32), got.iters)
    assert float(trace_t.obj[~trace_t.active].abs().sum()) == 0.0
    assert tuple(trace_t.obj.shape) == (5, 9)
    assert len(set(got.iters.tolist())) > 1 and bool(got.converged.all())


@pytest.mark.parametrize("kind,kw,over", [
    ("circle", dict(n_veh=3, radius=8.0), dict()),
    ("circle", dict(n_veh=2, radius=6.0), dict(qp_warm_dual=True,
                                               qp_max_iter=12)),
    ("parallel", dict(n_veh=3), dict()),
])
def test_solve_scp_stacked_adaptive_ipm(kind, kw, over):
    """qp_fixed_iters=None: the stacked solver hands the dense rows and the
    P blocks to the adaptive branch of solve_qp_batched."""
    problem_j, problem_t, u0_j, u0_t, u_lim, skw = _setup(kind, 5, 6, over,
                                                          **kw)
    assert skw["qp_fixed_iters"] is None
    want = jax.jit(lambda p, u: jscp.solve_scp_stacked(
        p, u, u_lim=u_lim, max_scp_iter=6, qp_use_pallas=False, **skw))(
            problem_j, u0_j)
    got = tscp.solve_scp_stacked(problem_t, u0_t, u_lim=u_lim,
                                 max_scp_iter=6, **skw)
    assert int(np.asarray(want.iters).max()) > 1
    _compare(got, want)


@pytest.mark.parametrize("phases", [None, ((2, 1), (2, 2), (3, 4))])
def test_solve_scp_batch_per_instance_path(phases):
    """stacked=False on both sides: vmap(solve_scp) in scp_tpu, solve_scp on
    the batch axis in the port, under the same straggler repacking."""
    problem_j, problem_t, u0_j, u0_t, u_lim, skw = _setup(
        "circle", 8, 6, dict(), n_veh=3, radius=8.0)
    want = jax.jit(lambda p, u: jscp.solve_scp_batch(
        p, u, u_lim=u_lim, max_scp_iter=7, phase1_iters=3, straggler_frac=2,
        phases=phases, stacked=False, **skw))(problem_j, u0_j)
    got = tscp.solve_scp_batch(
        problem_t, u0_t, u_lim=u_lim, max_scp_iter=7, phase1_iters=3,
        straggler_frac=2, phases=phases, stacked=False, **skw)
    first = (phases or ((3, 1),))[0][0]
    assert int(np.asarray(want.iters).max()) > first
    _compare(got, want)
    # the stacked solver on the same batch reaches the same answers
    stacked = tscp.solve_scp_batch(
        problem_t, u0_t, u_lim=u_lim, max_scp_iter=7, phase1_iters=3,
        straggler_frac=2, phases=phases, stacked=True, **skw)
    assert torch.equal(stacked.iters, got.iters)
    assert_close(stacked.u, got.u.numpy(), 2e-6, name="stacked u")


@pytest.mark.parametrize("kw,item", [
    (dict(axis_name="model", n_con_total=12), "item 11"),
    (dict(qp_kkt="banded"), "item 8"),
    (dict(qp_cheap_k=True), "cheap_k"),
])
def test_solve_scp_unported_options_raise(kw, item, monkeypatch):
    if item == "item 11":
        # roadmap item 11 is ported (tests/test_torch_horizon.py holds the
        # horizon-sharded solve against scp_tpu, and with qp_kkt="banded"
        # bit for bit the dense run): with axis_name the row-sharded QP
        # takes the dense KKT under qp_kkt="banded" as under "dense", as
        # scp_tpu's solve_scp does (its use_banded needs axis_name None),
        # with or without the stage statement; what stays refused is
        # axis_name without the global row count
        _, problem_t, _, u0_t, u_lim, skw = _setup(
            "circle", 2, 6, dict(qp_kkt="banded"), n_veh=2, radius=6.0)
        seen = []

        def first_qp(problem, u_init, qp_solve, **_):
            return qp_solve(u_init, None, None)

        def solve_qp(*a, **k):
            seen.append((k["banded"], k["axis_name"], k["mg_total"]))
            return "solved"
        monkeypatch.setattr(tscp, "_scp_loop", first_qp)
        monkeypatch.setattr(tscp.qp, "solve_qp", solve_qp)
        for kkt in ("banded", "dense"):
            for pre in (problem_t, problem_t._replace(banded_pre=None)):
                assert tscp.solve_scp(pre, u0_t, u_lim=u_lim,
                                      **{**skw, "qp_kkt": kkt, **kw}) \
                    == "solved"
        assert seen == [(None, "model", 12)] * 4
        for kkt in ("banded", "dense"):
            with pytest.raises(ValueError, match="requires n_con_total"):
                tscp.solve_scp(problem_t, u0_t, u_lim=u_lim,
                               **{**skw, "qp_kkt": kkt,
                                  "axis_name": kw["axis_name"]})
        return
    if item == "item 8":
        # roadmap item 8 is ported: with the stage statement that
        # controller_pre builds, qp_kkt="banded" solves the same SCP as the
        # dense factor (float64 round-off; tests/test_torch_banded_qp.py
        # holds it against scp_tpu)
        _, problem_t, _, u0_t, u_lim, skw = _setup(
            "circle", 2, 6, dict(qp_kkt="banded"), n_veh=2, radius=6.0)
        band = tscp.solve_scp(problem_t, u0_t, u_lim=u_lim, max_scp_iter=3,
                              **skw)
        dense = tscp.solve_scp(problem_t, u0_t, u_lim=u_lim, max_scp_iter=3,
                               **{**skw, "qp_kkt": "dense"})
        assert skw["qp_kkt"] == "banded"
        assert torch.equal(band.iters, dense.iters)
        assert_close(band.u, dense.u.numpy(), 1e-7, name="u")
        return
    _, problem_t, _, u0_t, u_lim, skw = _setup("circle", 2, 6, dict(),
                                               n_veh=2, radius=6.0)
    with pytest.raises(NotImplementedError, match=item):
        tscp.solve_scp(problem_t, u0_t, u_lim=u_lim, **{**skw, **kw})
