"""The side-selection controller through the port's engine (mpc_step,
mpc_step_batch, the closed loops) against scp_tpu.sim.engine under
controller="side_selection", float64 on the CPU, plant noise off; and the
calibrated float32 configuration's kernel routes.

Each scp_tpu reference (its jitted mpc_step_batch, two chained steps) runs
once per module and serves both of the port's step functions: in the port
both solve the controller's QPs batched over the instances, as scp_tpu's
mpc_step_batch does (scp_tpu's own tests hold that equal to its vmapped
per-instance step to 1e-9).
"""
import jax
import numpy as np
import pytest
import torch

from scp_tpu.sim import engine as jengine
from scp_tpu_torch import config as tcfg
from scp_tpu_torch.ops import ipm_kernel
from scp_tpu_torch.scenarios import batch as tbatch, builders as tbuilders
from scp_tpu_torch.sim import engine as tengine

from torch_parity import assert_close, jit_fast, scenario_pair

SMALL = dict(hp=5, hu=5, qp_max_iter=25, controller="side_selection")
STEP_CASES = {"parallel_rect": ("parallel", dict(obst_as_qcqp=False),
                                dict(n_veh=4))}
U_TOL, STATE_TOL = 1e-9, 1e-10
N_STEPS = 2


@pytest.fixture(scope="module")
def step_ref():
    """``step_ref(case)``: the batch in both packages and scp_tpu's outputs
    of N_STEPS chained side-selection steps (numpy), one jitted run per
    case."""
    cache = {}

    def get(name):
        if name not in cache:
            kind, over, kw = STEP_CASES[name]
            cfg_j, data_j, cfg_t, data_t = scenario_pair(
                kind, 4, seed=11, cfg_over={**SMALL, **over}, **kw)
            carry = jax.vmap(lambda d: jengine.init_carry(cfg_j, d))(data_j)
            step = jit_fast(lambda d, c: jengine.mpc_step_batch(cfg_j, d, c),
                            data_j, carry)
            outs = []
            for _ in range(N_STEPS):
                carry, out = step(data_j, carry)
                outs.append(jax.tree_util.tree_map(np.asarray, out))
            cache[name] = (cfg_t, data_t, outs,
                           jax.tree_util.tree_map(np.asarray, carry))
        return cache[name]
    return get


def _compare(out_t, out_j):
    """Every StepOutput field: integers and flags equal, the controls and
    the states to U_TOL / STATE_TOL, the rest to 1e-9 (objectives
    relative)."""
    assert out_t._fields == out_j._fields
    for name in out_j._fields:
        want, got = getattr(out_j, name), getattr(out_t, name)
        if want.dtype.kind in "biu":
            assert_close(got, want, 0, name=name)
        elif name in ("u_applied", "u_pred"):
            assert_close(got, want, U_TOL, name=name)
        elif name in ("states", "x0_pred", "delay_traj"):
            assert_close(got, want, STATE_TOL, name=name)
        elif name in ("obj", "pred_obj"):
            assert_close(got, want, 1e-9, rtol=1e-9, name=name)
        else:
            assert_close(got, want, 1e-9, name=name)


@pytest.mark.parametrize("entry", ["mpc_step", "mpc_step_batch"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_side_selection_step_matches_scp_tpu(step_ref, case, entry):
    """Two chained steps of parallel-4 (pairs, obstacles, the first-round
    candidates) in rotated-rectangle mode (obstAsQCQP=0: the faces built
    from the delay-compensated speeds), B = 4, hp = hu = 5, adaptive IPM.
    (The circle-mode rows are the same solve without the faces:
    test_torch_miqp.py holds it on frog, circle-3 and parallel-4.)"""
    cfg_t, data_t, outs_j, carry_j = step_ref(case)
    step = getattr(tengine, entry)
    carry = tengine.init_carry(cfg_t, data_t)
    for out_j in outs_j:
        carry, out_t = step(cfg_t, data_t, carry)
        _compare(out_t, out_j)
    assert carry.step == N_STEPS
    assert_close(carry.state, carry_j.state, STATE_TOL, name="state")
    assert_close(carry.u_warm, carry_j.u_warm, U_TOL, name="u_warm")
    # the controller's integers, as the SCP fields carry them
    assert out_t.scp_iters.tolist() == [cfg_t.side_selection_rounds] * 4
    assert int(out_t.qp_iters.min()) > 0


def test_phases_are_refused_under_side_selection():
    cfg, data = tbuilders.frog(dtype=torch.float64, device="cpu")
    cfg = cfg.replace(controller="side_selection")
    carry = tengine.init_carry(cfg, data)
    with pytest.raises(ValueError, match="side_selection"):
        tengine.mpc_step_batch(cfg, data, carry,
                               phases=tcfg.TUNED_F32_PHASES)


def test_closed_loop_side_selection_frog():
    """scp_tpu's closed-loop frog assertions (tests/test_miqp.py) on the
    port's output: 8 steps of simulate, float64, feasible on every step,
    forward progress through the obstacle field."""
    cfg, data = tbuilders.frog(dtype=torch.float64, device="cpu")
    cfg = cfg.replace(controller="side_selection", qp_max_iter=25)
    carry, out = tengine.simulate(cfg, data, n_steps=8)
    assert bool(out.feasible.all()), \
        f"infeasible steps: {torch.nonzero(~out.feasible[:, 0])}"
    assert bool(torch.isfinite(carry.state).all())
    assert float(carry.state[0, 0, 0]) > float(data.x0[0, 0, 0]) + 8.0


def test_closed_loops_agree_under_side_selection():
    """simulate, simulate_batch and simulate_timed drive the same stacked
    controller: identical outputs (frog, B = 2, 2 steps)."""
    cfg, data = tbatch.make_batch("frog", 2, dtype=torch.float64,
                                  device="cpu")
    cfg = cfg.replace(**SMALL)
    _, outs = tengine.simulate(cfg, data, n_steps=2)
    _, outs_b = tengine.simulate_batch(cfg, data, n_steps=2)
    _, outs_t, step_times, _ = tengine.simulate_timed(cfg, data, n_steps=2)
    for a, b_, c in zip(outs, outs_b, outs_t):
        assert torch.equal(a, b_) and torch.equal(a, c)
    assert len(step_times) == 2 and bool(outs.sides_stable.any())


@pytest.mark.parametrize("kind,n_veh,b,route", [
    ("frog", 1, 2, "dense"), ("parallel", 11, 1, "struct")])
def test_tuned_f32_side_selection_routes(monkeypatch, kind, n_veh, b,
                                         route):
    """The calibrated float32 controller (TUNED_F32_OVERRIDES updated by
    TUNED_F32_SIDE_SELECTION) at the widths of the card's paths, hp = hu =
    10: frog takes the dense-G kernel (K2), parallel-11 the structured one
    (K1, hard rate rows) — one call for the 5B-wide candidates at 8
    iterations, one for the B-wide round at 12, nothing else."""
    cfg, data = tbatch.make_batch(kind, b, dtype=torch.float32, device="cpu",
                                  **({"n_veh": n_veh} if n_veh > 1 else {}))
    cfg = tcfg.tuned_f32(cfg.replace(controller="side_selection"),
                         **tcfg.TUNED_F32_SIDE_SELECTION)
    assert (cfg.qp_fixed_iters, cfg.side_selection_cand_iters) == (12, 8)
    assert cfg.hp == cfg.hu == 10
    calls = {"struct": [], "dense": []}
    for name in calls:
        real = getattr(ipm_kernel, f"ipm_iterate_{name}")

        def spy(*a, _real=real, _name=name, **k):
            calls[_name].append((a[0].shape[0], k["n_iters"]))
            return _real(*a, **k)
        monkeypatch.setattr(ipm_kernel, f"ipm_iterate_{name}", spy)
    carry, out = tengine.mpc_step_batch(cfg, data,
                                        tengine.init_carry(cfg, data))
    assert calls[route] == [(5 * b, 8), (b, 12)]
    assert not calls["dense" if route == "struct" else "struct"]
    assert out.qp_iters.tolist() == [5 * 8 + 12] * b
    for name, val in out._asdict().items():
        if val.is_floating_point():
            assert bool(torch.isfinite(val).all()), name


def test_parallel11_past_the_shared_tier_matches_scp_tpu(monkeypatch):
    """Side selection at parallel-11, hp = hu = 16 — a QP past K1's shared
    tier (329,492 bytes), which the port runs in K1's cluster tier where
    scp_tpu falls back from its fused kernel to its XLA path: one step,
    B = 1, float64, 12 fixed IPM iterations a round and 8 a candidate, the
    port on the CPU (the plain version of every tier) against scp_tpu's
    mpc_step_batch to U_TOL, with the same selections. Both launches (the 5
    candidates, then the round) take the structured route, in the cluster
    tier."""
    over = dict(SMALL, hp=16, hu=16, qp_fixed_iters=12,
                side_selection_cand_iters=8)
    cfg_j, data_j, cfg_t, data_t = scenario_pair(
        "parallel", 1, seed=11, cfg_over=over, n_veh=11)
    carry_j = jax.vmap(lambda d: jengine.init_carry(cfg_j, d))(data_j)
    step = jit_fast(lambda d, c: jengine.mpc_step_batch(cfg_j, d, c),
                    data_j, carry_j)
    _, out_j = step(data_j, carry_j)
    out_j = jax.tree_util.tree_map(np.asarray, out_j)

    tiers, real = [], ipm_kernel.ipm_iterate_struct

    def spy(*a, **k):
        gi, gob, pb = a[0], a[2], a[4]
        tiers.append((gi.shape[0], k["n_iters"], ipm_kernel.struct_tier(
            gi.shape[1], gob.shape[1], gi.shape[2], gi.shape[3],
            pb.shape[1], k["lower_tri"]).tier))
        return real(*a, **k)
    monkeypatch.setattr(ipm_kernel, "ipm_iterate_struct", spy)
    _, out_t = tengine.mpc_step_batch(cfg_t, data_t,
                                      tengine.init_carry(cfg_t, data_t))
    assert tiers == [(5, 8, "cluster"), (1, 12, "cluster")]
    _compare(out_t, out_j)


def test_parallel11_global_tier_matches_scp_tpu(monkeypatch):
    """Side selection at parallel-11, hp = hu = 32 — the smallest horizon
    at which K1 takes its global tier (the device tier's vectors alone
    need 239,380 bytes of shared memory), where scp_tpu falls back from its
    fused kernel to its XLA path: one calibrated step (12 fixed IPM
    iterations a round, 8 a candidate), B = 1, float64, the port on the CPU
    (the plain version of every tier) against scp_tpu's mpc_step_batch: the
    controls to 1e-8, the objectives to 1e-6 (rtol 1e-8), every discrete
    output equal. Both launches (the 5 candidates, then the round) take the
    structured route, in the global tier."""
    over = dict(SMALL, hp=32, hu=32, qp_fixed_iters=12,
                side_selection_cand_iters=8)
    cfg_j, data_j, cfg_t, data_t = scenario_pair(
        "parallel", 1, seed=11, cfg_over=over, n_veh=11)
    carry_j = jax.vmap(lambda d: jengine.init_carry(cfg_j, d))(data_j)
    step = jit_fast(lambda d, c: jengine.mpc_step_batch(cfg_j, d, c),
                    data_j, carry_j)
    _, out_j = step(data_j, carry_j)
    out_j = jax.tree_util.tree_map(np.asarray, out_j)

    from scp_tpu_torch.solvers import qp as tqp
    routes, real_route = [], tqp._route

    def route_spy(*a, **k):
        routes.append(real_route(*a, **k))
        return routes[-1]
    monkeypatch.setattr(tqp, "_route", route_spy)
    tiers, real = [], ipm_kernel.ipm_iterate_struct

    def spy(*a, **k):
        gi, gob, pb = a[0], a[2], a[4]
        tiers.append((gi.shape[0], k["n_iters"], ipm_kernel.struct_tier(
            gi.shape[1], gob.shape[1], gi.shape[2], gi.shape[3],
            pb.shape[1], k["lower_tri"]).tier))
        return real(*a, **k)
    monkeypatch.setattr(ipm_kernel, "ipm_iterate_struct", spy)
    _, out_t = tengine.mpc_step_batch(cfg_t, data_t,
                                      tengine.init_carry(cfg_t, data_t))
    # (side selection asks for the route of each QP before solving it)
    assert routes == ["struct"] * 4
    assert tiers == [(5, 8, "global"), (1, 12, "global")]
    for name in out_j._fields:
        want, got = getattr(out_j, name), getattr(out_t, name)
        if want.dtype.kind in "biu":
            assert_close(got, want, 0, name=name)
        elif name in ("obj", "pred_obj"):
            assert_close(got, want, 1e-6, rtol=1e-8, name=name)
        elif name in ("u_applied", "u_pred"):
            assert_close(got, want, 1e-8, name=name)
