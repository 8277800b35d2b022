"""The SCP outer loop of the port against scp_tpu: solve_scp_stacked and
solve_scp_batch (with a phase schedule, so the stable argsort packing and the
merge run), float64 on the CPU. scp_tpu's inner QP on the CPU is its
vmap(solve_qp) fallback — the same Mehrotra method as the port's plain fused
iteration — so the SCP iterates agree to the QPs' float64 agreement (1e-7 rad
per solve, compounding over iterations: 2e-6) and every integer / boolean
output must be identical."""
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
    over = dict(hp=hp, hu=hp, qp_fixed_iters=14, qp_tol=1e-8, **cfg_over)
    cfg_j, data_j, cfg_t, data_t = scenario_pair(kind, b, seed=8,
                                                 cfg_over=over, **kw)
    problem_j, _, carry_j = jax_problem(cfg_j, data_j)
    problem_t = convert.problem_from_numpy(tonp(problem_j)._asdict(),
                                           torch.float64, "cpu")
    kw_j = jengine._scp_kwargs(cfg_j)
    kw_t = tengine._scp_kwargs(cfg_t)
    assert kw_j == kw_t
    return problem_j, problem_t, carry_j.u_warm, kw_j


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
    ("circle", dict(n_veh=3, radius=8.0), dict()),
    ("circle", dict(n_veh=3, radius=8.0),
     dict(scp_keep_best=True, merit_patience=2, delta_tol_rel=1e-4,
          u_step_tol=1e-5)),
    ("circle", dict(n_veh=2, radius=6.0), dict(qp_warm_dual=True)),
    ("parallel", dict(n_veh=3), dict()),
])
def test_solve_scp_stacked(kind, kw, over):
    problem_j, problem_t, u0, skw = _setup(kind, 6, 6, over, **kw)
    skw = dict(skw)
    u_lim = skw.pop("u_lim")
    want = jax.jit(lambda p, u: jscp.solve_scp_stacked(
        p, u, u_lim=u_lim, max_scp_iter=6, qp_use_pallas=False, **skw))(
            problem_j, u0)
    got = tscp.solve_scp_stacked(problem_t, torch.as_tensor(np.array(u0)),
                                 u_lim=u_lim, max_scp_iter=6, **skw)
    assert int(np.asarray(want.iters).max()) > 1
    _compare(got, want)


@pytest.mark.parametrize("phases", [
    None,
    ((2, 1), (2, 2), (3, 4)),
    ((2, 1, 10), (4, 2, 14)),          # per-phase qp_fixed_iters override
])
def test_solve_scp_batch_phases(phases):
    problem_j, problem_t, u0, skw = _setup(
        "circle", 8, 6, dict(), n_veh=3, radius=8.0)
    skw = dict(skw)
    u_lim = skw.pop("u_lim")
    want = jax.jit(lambda p, u: jscp.solve_scp_batch(
        p, u, u_lim=u_lim, max_scp_iter=7, phase1_iters=3, straggler_frac=2,
        phases=phases, stacked=True, qp_use_pallas=False, **skw))(
            problem_j, u0)
    tscp.reset_host_sync_count()
    got = tscp.solve_scp_batch(
        problem_t, torch.as_tensor(np.array(u0)), u_lim=u_lim, max_scp_iter=7,
        phase1_iters=3, straggler_frac=2, phases=phases, **skw)
    # stragglers really were repacked: some instance ran past phase one
    first = (phases or ((3, 1),))[0][0]
    assert int(np.asarray(want.iters).max()) > first
    _compare(got, want)
    # one host read per SCP iteration, at most one more per phase
    n_phase = len(phases) if phases else 2
    total = 7 if phases is None else sum(p[0] for p in phases)
    assert 0 < tscp.host_sync_count <= total + n_phase


def test_forward_u():
    problem_j, problem_t, _, _ = _setup("circle", 3, 6, dict(), n_veh=3,
                                        radius=8.0)
    u = np.random.default_rng(0).uniform(-0.05, 0.05, size=(3, 18))
    want = jax.vmap(jscp.forward_u)(problem_j.sys, u)
    got = tscp.forward_u(problem_t.sys, torch.as_tensor(u))
    assert_close(got[0], want[0], 1e-10)
    assert_close(got[1], want[1], 0)


def test_exact_zero_first_control_is_nudged():
    """u_init[:, 0] == 0 becomes eps, and the caller's tensor is left
    alone."""
    _, problem_t, u0, skw = _setup("circle", 2, 6, dict(), n_veh=2,
                                   radius=6.0)
    skw = dict(skw)
    u_lim = skw.pop("u_lim")
    u = torch.zeros((2, 12), dtype=torch.float64)
    res = tscp.solve_scp_stacked(problem_t, u, u_lim=u_lim, max_scp_iter=0,
                                 **skw)
    assert float(res.u[0, 0]) == torch.finfo(torch.float64).eps
    assert float(u[0, 0]) == 0.0 and int(res.iters.max()) == 0


def test_unported_options_raise():
    _, problem_t, _, skw = _setup("circle", 2, 6, dict(), n_veh=2,
                                  radius=6.0)
    skw = dict(skw)
    u_lim = skw.pop("u_lim")
    u = torch.zeros((2, 12), dtype=torch.float64)
    # the per-instance path is ported: stacked=False runs solve_scp
    res = tscp.solve_scp_batch(problem_t, u, u_lim=u_lim, stacked=False,
                               max_scp_iter=2, phase1_iters=1, **skw)
    assert tuple(res.u.shape) == (2, 12) and int(res.iters.max()) >= 1
    with pytest.raises(NotImplementedError):
        tscp.solve_scp_stacked(problem_t, u, u_lim=u_lim,
                               **{**skw, "qp_cheap_k": True})
    # the banded KKT is ported (roadmap item 8); it needs the stage
    # statement, which this problem (built with qp_kkt="dense") lacks
    assert problem_t.banded_pre is None
    with pytest.raises(ValueError, match="banded_pre"):
        tscp.solve_scp_stacked(problem_t, u, u_lim=u_lim,
                               **{**skw, "qp_kkt": "banded"})
    with pytest.raises(ValueError):
        tscp.solve_scp_batch(problem_t, u, u_lim=u_lim,
                             phases=((2, 2), (2, 4)), **skw)
