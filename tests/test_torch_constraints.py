"""Structured collision constraints of the port against scp_tpu, with and
without obstacles (circle: pairs only; parallel: pairs + static obstacles;
frog: one vehicle, obstacles only). float64 on the CPU; both sides run the
same einsum contractions, so they agree to round-off: 1e-9 relative to values
of order 1e2..1e3 (squared distances in metres)."""
import jax
import numpy as np
import pytest
import torch

from scp_tpu.ops import constraints as jcon
from scp_tpu_torch import convert
from scp_tpu_torch.ops import constraints as tcon

from torch_parity import assert_close, jax_problem, scenario_pair, tonp

CASES = {
    "circle": dict(kind="circle", n_veh=3, radius=8.0),
    "parallel": dict(kind="parallel", n_veh=3),
    "frog": dict(kind="frog"),
}
B, HP = 4, 6


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw = dict(CASES[request.param])
    cfg_j, data_j, cfg_t, data_t = scenario_pair(
        kw.pop("kind"), B, seed=5, cfg_over=dict(hp=HP, hu=HP), **kw)
    problem_j, _, _ = jax_problem(cfg_j, data_j)
    problem_t = convert.problem_from_numpy(tonp(problem_j)._asdict(),
                                           torch.float64, "cpu")
    rng = np.random.default_rng(1)
    u = rng.uniform(-0.05, 0.05, size=(B, cfg_j.n_veh * HP))
    return cfg_j, problem_j, problem_t, u, torch.as_tensor(u), data_t


def test_make_system(case):
    cfg_j, problem_j, problem_t, _, _, data_t = case
    s = problem_t.sys
    b, v = s.b3.shape[:2]
    math_b = s.b3.reshape(b, v, HP * 2, HP)
    const = s.const3.reshape(b, v, HP * 2)
    got = tcon.make_system(math_b, const, s.obst_pos, data_t.dsafe_veh,
                           data_t.dsafe_obst, cfg_j.dsafe_extra, HP, HP)
    for name in got._fields:
        assert_close(getattr(got, name), getattr(problem_j.sys, name), 1e-12,
                     rtol=1e-12, name=name)


def test_make_system_coupling_masks():
    cfg_j, data_j, cfg_t, data_t = scenario_pair(
        "parallel", B, seed=5, cfg_over=dict(hp=HP, hu=HP), n_veh=3)
    problem_j, _, _ = jax_problem(cfg_j, data_j)
    s = problem_j.sys
    coupling = np.array([[0, 1, 0], [0, 0, 0], [0, 1, 0]], float)
    ocoup = np.array([[1, 0, 1, 0], [0, 0, 0, 0], [1, 1, 1, 1]], float)
    math_b = np.asarray(s.b3).reshape(B, 3, HP * 2, HP)
    const = np.asarray(s.const3).reshape(B, 3, HP * 2)
    want = jax.vmap(lambda mb, ct, op, dv, do: jcon.make_system(
        mb, ct, op, dv, do, cfg_j.dsafe_extra, HP, HP, coupling, ocoup))(
            math_b, const, s.obst_pos, data_j.dsafe_veh, data_j.dsafe_obst)
    tt = lambda a: torch.as_tensor(np.array(a))   # noqa: E731
    got = tcon.make_system(
        tt(math_b), tt(const), tt(s.obst_pos), data_t.dsafe_veh,
        data_t.dsafe_obst, cfg_j.dsafe_extra, HP, HP,
        tt(coupling).expand(B, -1, -1), tt(ocoup).expand(B, -1, -1))
    assert_close(got.pair_mask, want.pair_mask, 0)
    assert_close(got.obst_mask, want.obst_mask, 0)
    u = np.random.default_rng(2).uniform(-0.05, 0.05, size=(B, 3 * HP))
    wj = jax.vmap(jcon.linearize_slabs)(want, u)
    gt = tcon.linearize_slabs(got, tt(u))
    for g, w in zip(gt, wj):
        assert_close(g, w, 1e-9, rtol=1e-9)
    evj = jax.vmap(lambda s_, u_: jcon.evaluate(s_, u_, 1e-3, False))(want, u)
    evt = tcon.evaluate(got, tt(u), 1e-3, False)
    assert_close(evt.sum_violations, evj.sum_violations, 1e-9, rtol=1e-9)


def test_positions_and_constraint_values(case):
    _, problem_j, problem_t, u, ut, _ = case
    assert_close(tcon.positions(problem_t.sys, ut),
                 jax.vmap(jcon.positions)(problem_j.sys, u), 1e-10)
    want = jax.vmap(jcon.constraint_values)(problem_j.sys, u)
    got = tcon.constraint_values(problem_t.sys, ut)
    assert_close(got[0], want[0], 1e-9, rtol=1e-9)
    assert_close(got[1], want[1], 1e-9, rtol=1e-9)


def test_linearize_slabs_with_values(case):
    _, problem_j, problem_t, u, ut, _ = case
    want = jax.vmap(lambda s, x: jcon.linearize_slabs(s, x, True))(
        problem_j.sys, u)
    got = tcon.linearize_slabs(problem_t.sys, ut, with_values=True)
    assert len(got) == len(want) == 6
    for g, w, name in zip(got, want,
                          ("gi", "gj", "gob", "rhs", "c_pair", "c_obst")):
        assert_close(g, w, 1e-9, rtol=1e-9, name=name)


def test_scatter_slabs_and_linearize(case):
    cfg_j, problem_j, problem_t, u, ut, _ = case
    Gw, rw = jax.vmap(jcon.linearize)(problem_j.sys, u)
    Gg, rg = tcon.linearize(problem_t.sys, ut)
    assert Gg.shape == (B, cfg_j.n_constraints, cfg_j.n_veh * HP)
    assert_close(Gg, Gw, 1e-9, rtol=1e-9)
    assert_close(rg, rw, 1e-9, rtol=1e-9)


@pytest.mark.parametrize("compat_q5", [True, False])
def test_evaluate(case, compat_q5):
    cfg_j, problem_j, problem_t, u, ut, _ = case
    # a loose tolerance AND a scaled-up input make some rows violated
    for scale, tol in ((1.0, cfg_j.constraint_tolerance), (0.0, -50.0)):
        want = jax.vmap(lambda s, x: jcon.evaluate(s, x, tol, compat_q5))(
            problem_j.sys, u * scale)
        got = tcon.evaluate(problem_t.sys, ut * scale, tol, compat_q5)
        for name in want._fields:
            assert_close(getattr(got, name), getattr(want, name), 1e-9,
                         rtol=1e-9, name=name)


def test_objective(case):
    _, problem_j, problem_t, u, ut, _ = case
    want = jax.vmap(jcon.objective)(problem_j.phi0, problem_j.psi0,
                                    problem_j.gamma0, u)
    got = tcon.objective(problem_t.phi0, problem_t.psi0, problem_t.gamma0, ut)
    assert_close(got, want, 0, rtol=1e-12)


@pytest.mark.parametrize("compat_q5", [True, False])
def test_penalty_score(case, compat_q5):
    _, problem_j, problem_t, u, ut, _ = case
    # c_quad small enough that the score is not one huge number, and a
    # shrunken safety distance sign flip is not needed: violations exist in
    # the small-circle and obstacle cases already
    want = jax.vmap(lambda s, p, q, g, x: jcon.penalty_score(
        s, p, q, g, x, 10.0, 0.5, compat_q5))(
            problem_j.sys, problem_j.phi0, problem_j.psi0, problem_j.gamma0, u)
    got = tcon.penalty_score(problem_t.sys, problem_t.phi0, problem_t.psi0,
                             problem_t.gamma0, ut, 10.0, 0.5, compat_q5)
    assert_close(got[0], want[0], 0, rtol=1e-10, name="score")
    assert_close(got[1], want[1], 1e-7, rtol=1e-9, name="gradient")


def test_static_pairs():
    for v in (1, 2, 5):
        assert tcon._static_pairs(v) == jcon._static_pairs(v)
