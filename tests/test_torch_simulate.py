"""The per-instance step and the closed loops of the port (mpc_controller,
mpc_step, simulate, simulate_batch, simulate_timed) against
scp_tpu.sim.engine on the same numpy scenario, float64 on the CPU, plant
noise off (the two packages draw different random numbers from a seed).

Tolerances as for the batched step (tests/test_torch_engine.py): the inner
QPs agree to ~1e-8 rad per solve, which compounds over SCP iterations and
chained steps: controls 5e-6 rad, positions / states 1e-5 m, objectives 1e-6
relative; every integer / boolean output identical.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from scp_tpu import config as jcfg
from scp_tpu.sim import engine as jengine
from scp_tpu_torch import config as tcfg
from scp_tpu_torch.ops import ipm_kernel, linalg_kernel, riccati_kernel
from scp_tpu_torch.scenarios import batch as tbatch
from scp_tpu_torch.scenarios import builders as tbuilders
from scp_tpu_torch.sim import engine as tengine

from torch_parity import assert_close, scenario_pair

TOL = dict(u=5e-6, pos=1e-5, obj_rel=1e-6)
U_FIELDS = ("u_applied", "u_pred")
SMALL = dict(hp=8, hu=8, max_scp_iter=8)


def _compare_outputs(out_t, out_j, tol=TOL):
    """Every StepOutput field, whatever leading axes both carry."""
    assert out_t._fields == out_j._fields
    for name in out_j._fields:
        w, g = np.asarray(getattr(out_j, name)), getattr(out_t, name)
        if w.dtype.kind in "biu":
            assert_close(g, w, 0, name=name)
        elif name in U_FIELDS:
            assert_close(g, w, tol["u"], name=name)
        elif name in ("obj", "pred_obj"):
            assert_close(g, w, 1e-6, rtol=tol["obj_rel"], name=name)
        else:
            assert_close(g, w, tol["pos"], name=name)


def _squeeze_b(out_t):
    """Drop the size-1 batch axis behind the step axis."""
    return type(out_t)(*[v[:, 0] for v in out_t])


@pytest.mark.parametrize("kind,b,kw,over", [
    ("circle", 1, dict(n_veh=3, radius=8.0), dict()),
    ("circle", 3, dict(n_veh=3, radius=8.0), dict()),
    ("parallel", 2, dict(n_veh=3), dict()),
    ("circle", 2, dict(n_veh=2, radius=7.0),
     dict(qp_fixed_iters=12, qp_correctors=1, delay_x=0.05,
          plant_compat_q10=False)),
])
def test_mpc_step_matches_vmapped_scp_tpu(kind, b, kw, over):
    """Two chained steps of mpc_step against vmap(mpc_step); the default
    solver settings run the adaptive IPM."""
    cfg_j, data_j, cfg_t, data_t = scenario_pair(
        kind, b, seed=5, cfg_over=dict(**SMALL, **over), **kw)
    carry_j = jax.vmap(lambda d: jengine.init_carry(cfg_j, d))(data_j)
    carry_t = tengine.init_carry(cfg_t, data_t)
    step_j = jax.jit(jax.vmap(lambda d, c: jengine.mpc_step(cfg_j, d, c)))
    for _ in range(2):
        carry_j, out_j = step_j(data_j, carry_j)
        carry_t, out_t = tengine.mpc_step(cfg_t, data_t, carry_t)
        _compare_outputs(out_t, out_j)
    assert carry_t.step == 2
    assert_close(carry_t.u_warm, carry_j.u_warm, TOL["u"], name="u_warm")
    assert_close(carry_t.state, carry_j.state, TOL["pos"], name="state")
    assert ipm_kernel.launch_count == 0
    assert sum(linalg_kernel.launch_counts.values()) == 0


def test_tuned_mpc_step_at_hp64_takes_the_dense_kkt(monkeypatch):
    """The calibrated one-scenario controller at the long horizon: circle,
    4 vehicles, hp = hu = 64 (n = 257), ``TUNED_F32_OVERRIDES``
    (``qp_kkt="auto"``, 7 fixed IPM iterations), two chained steps of
    ``mpc_step`` against vmap(scp_tpu's), float64. Per instance "auto" is
    the dense factorization in both packages: every factor is one n = 257
    matrix (on the card, the large-n factor and solve) and the Riccati
    sweeps never run."""
    over = dict(hp=64, hu=64, **jcfg.TUNED_F32_OVERRIDES)
    cfg_j, data_j, cfg_t, data_t = scenario_pair("circle", 1, seed=5,
                                                 cfg_over=over, n_veh=4)
    assert cfg_t == tcfg.tuned_f32(cfg_t) and cfg_t.qp_kkt == "auto"
    sizes = []
    real = linalg_kernel.cholesky

    def spy(K):
        sizes.append(tuple(K.shape))
        return real(K)

    def no_riccati(*a, **k):
        raise AssertionError("the dense KKT was wanted")

    monkeypatch.setattr(linalg_kernel, "cholesky", spy)
    monkeypatch.setattr(riccati_kernel, "riccati_factor", no_riccati)
    carry_j = jax.vmap(lambda d: jengine.init_carry(cfg_j, d))(data_j)
    carry_t = tengine.init_carry(cfg_t, data_t)
    step_j = jax.jit(jax.vmap(lambda d, c: jengine.mpc_step(cfg_j, d, c)))
    for _ in range(2):
        carry_j, out_j = step_j(data_j, carry_j)
        carry_t, out_t = tengine.mpc_step(cfg_t, data_t, carry_t)
        _compare_outputs(out_t, out_j)
    assert sizes and set(sizes) == {(1, 257, 257)}
    assert not linalg_kernel.fits_chol_smem(257)
    assert bool(out_t.feasible.all())


def test_simulate_matches_scp_tpu_closed_loop():
    """simulate, 5 steps, circle, 3 vehicles, hp = 8: ONE scenario through
    scp_tpu's scanned closed loop and through the port's B = 1 loop."""
    cfg_j, data_j, cfg_t, data_t = scenario_pair(
        "circle", 1, seed=6, cfg_over=SMALL, n_veh=3, radius=8.0)
    one_j = jax.tree_util.tree_map(lambda x: x[0], data_j)
    carry_j, outs_j = jax.jit(
        lambda d: jengine.simulate(cfg_j, d, n_steps=5))(one_j)
    carry_t, outs_t = tengine.simulate(cfg_t, data_t, n_steps=5)
    assert tuple(outs_t.u_pred.shape) == (5, 1, 8, 3)
    _compare_outputs(_squeeze_b(outs_t), outs_j)
    assert carry_t.step == 5 == int(carry_j.step)
    assert_close(carry_t.state[0], carry_j.state, TOL["pos"], name="state")
    # the constraints were active along the way
    assert int(outs_t.scp_iters.max()) > 2


def test_simulate_batch_matches_scp_tpu_and_the_per_instance_loop():
    """simulate_batch (stacked SCP, phase schedule) against scp_tpu's
    simulate_batch, and against the port's own simulate on the same batch
    (= vmap(mpc_step)): the two routes solve the same QPs."""
    phases = ((3, 1), (2, 2), (3, 4))
    cfg_j, data_j, cfg_t, data_t = scenario_pair(
        "circle", 4, seed=7, cfg_over=SMALL, n_veh=3, radius=8.0)
    _, outs_j = jax.jit(lambda d: jengine.simulate_batch(
        cfg_j, d, n_steps=3, phases=phases))(data_j)
    carry_t, outs_t = tengine.simulate_batch(cfg_t, data_t, n_steps=3,
                                             phases=phases)
    _compare_outputs(outs_t, outs_j)
    assert carry_t.step == 3 and tuple(outs_t.feasible.shape) == (3, 4)
    # default schedule: (8, 1) then stragglers at quarter width
    _, outs_d = tengine.simulate_batch(cfg_t, data_t, n_steps=2)
    _, outs_i = tengine.simulate(cfg_t, data_t, n_steps=2)
    assert_close(outs_d.u_pred, outs_i.u_pred.numpy(), TOL["u"])
    assert torch.equal(outs_d.feasible, outs_i.feasible)
    assert torch.equal(outs_d.scp_iters, outs_i.scp_iters)


def test_simulate_timed_returns_the_outputs_of_simulate():
    cfg, data = tbuilders.circle(3, radius=8.0, dtype=torch.float64,
                                 device="cpu", **SMALL)
    carry, outs = tengine.simulate(cfg, data, n_steps=3)
    carry_w, outs_w, step_times, ctrl_times = tengine.simulate_timed(
        cfg, data, n_steps=3)
    for a, b_ in zip(outs, outs_w):
        assert torch.equal(a, b_)
    assert torch.equal(carry.state, carry_w.state) and carry_w.step == 3
    assert len(step_times) == len(ctrl_times) == 3
    assert all(0 < c <= s for c, s in zip(ctrl_times, step_times))
    _, outs_c, _, _ = tengine.simulate_timed(cfg, data, n_steps=3,
                                             warmup=False)
    assert torch.equal(outs_c.u_pred, outs.u_pred)


def test_plant_noise_in_the_closed_loop():
    """noise_std = reference_noise_std(cfg): the same generator seed gives
    the same run, the warm-up step of simulate_timed draws nothing that the
    run sees, another seed gives another run, and the carried positions
    disperse by about noise_std * tick * sqrt(ticks) per step."""
    cfg, data = tbuilders.circle(2, radius=9.0, dtype=torch.float64,
                                 device="cpu", hp=6, hu=6, max_scp_iter=3)
    assert tcfg.reference_noise_std(cfg) == jcfg.reference_noise_std(
        jcfg.SCPConfig(**dataclasses.asdict(cfg)))
    cfg = cfg.replace(noise_std=1e3 * tcfg.reference_noise_std(cfg))

    def gen(seed):
        return torch.Generator(device="cpu").manual_seed(seed)

    _, a = tengine.simulate(cfg, data, gen(1), n_steps=2)
    _, b_ = tengine.simulate(cfg, data, gen(1), n_steps=2)
    _, c, _, _ = tengine.simulate_timed(cfg, data, gen(1), n_steps=2)
    _, d = tengine.simulate(cfg, data, gen(2), n_steps=2)
    assert torch.equal(a.states, b_.states)
    assert torch.equal(a.states, c.states)
    assert not torch.equal(a.states, d.states)
    # Monte-Carlo over one scenario: simulate_batch on a tiled batch
    many = tbatch.tile_scenario(data, 400)
    _, mc = tengine.simulate_batch(cfg, many, gen(3), n_steps=1)
    _, clean = tengine.simulate_batch(cfg.replace(noise_std=0.0), many,
                                      n_steps=1)
    dev = (mc.states - clean.states)[0, :, -1, :, :2]
    want = cfg.noise_std * cfg.tick_length * np.sqrt(cfg.ticks_per_sim)
    assert abs(float(dev.std()) / want - 1.0) < 0.1


def test_per_instance_entry_points_refuse_other_controllers():
    cfg, data = tbuilders.circle(2, dtype=torch.float64, device="cpu",
                                 hp=6, hu=6)
    carry = tengine.init_carry(cfg, data)
    # the side-selection controller runs (solvers/miqp.py)
    res, _, sides = tengine.mpc_controller(
        cfg.replace(controller="side_selection"), data, carry)
    assert sides.dtype == torch.bool and tuple(res.u.shape) == (1, 12)
    with pytest.raises(ValueError):
        tengine.mpc_controller(cfg.replace(controller="pid"), data, carry)
    # the banded KKT is ported (roadmap item 8): the same step as the dense
    # factor, to float64 round-off
    _, out_b = tengine.mpc_step(cfg.replace(qp_kkt="banded"), data, carry)
    _, out_d = tengine.mpc_step(cfg, data, carry)
    assert torch.allclose(out_b.u_pred, out_d.u_pred, rtol=0, atol=1e-8)
    res, aux, sides = tengine.mpc_controller(cfg, data, carry)
    assert sides is None and len(aux) == 6
    assert tuple(res.u.shape) == (1, 12)
