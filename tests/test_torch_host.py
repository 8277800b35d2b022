"""The port's host side against scp_tpu's, on the CPU: results export
(npz arrays, the reference-format JSON), plot geometry and frames,
checkpoint resume, the debug aids, timing, and the native QP binding.

Everything here is host numpy or one small CPU closed loop: exact equality
where both packages compute the same numbers from the same arrays; the
native binding against the port's float64 ``solve_qp`` within 1e-8.
"""
import json
import math
import os

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from scp_tpu.runtime import native as jnative
from scp_tpu.scenarios import builders as jbuilders
from scp_tpu.sim import engine as jengine
from scp_tpu.utils import debug as jdebug
from scp_tpu.utils import results as jresults
from scp_tpu.viz import plot as jplot
from scp_tpu_torch import convert
from scp_tpu_torch.runtime import native as tnative
from scp_tpu_torch.scenarios import builders as tbuilders
from scp_tpu_torch.sim import engine as tengine
from scp_tpu_torch.solvers import qp as tqp
from scp_tpu_torch.utils import checkpoint, debug, results, timing
from scp_tpu_torch.viz import plot as tplot

from torch_parity import tonp

N_SIM = 3


def _pair(kind, **kw):
    """One nominal scenario in both packages (the port's as a batch of
    one, converted from scp_tpu's numpy)."""
    cfg_j, data_j = jbuilders.BUILDERS[kind](dtype=jnp.float64, **kw)
    data_t = convert.scenario_from_numpy(tonp(data_j), torch.float64, "cpu",
                                         batched=False)
    return cfg_j, data_j, data_t


def _fake_outputs(cfg, n_sim, batch, seed, near=False):
    """A seeded numpy StepOutput of scp_tpu's field layout: ``(n_sim, ...)``
    with ``batch=None``, else ``(n_sim, batch, ...)``. ``near`` puts the
    predicted positions within a few metres of each other and of frog's
    first obstacle lane (violations)."""
    rng = np.random.default_rng(seed)
    v, hp, tps = cfg.n_veh, cfg.hp, cfg.ticks_per_sim
    lead = (n_sim,) if batch is None else (n_sim, batch)

    def f(*shape, scale=1.0):
        return rng.normal(size=lead + shape) * scale

    def i(*shape):
        return rng.integers(0, 9, size=lead + shape).astype(np.int32)

    def b(*shape):
        return rng.random(size=lead + shape) < 0.5

    traj = f(hp, 2, v, scale=3.0 if near else 20.0)
    if near:
        traj[..., 0, :] += 7.0
    return jengine.StepOutput(
        states=f(tps, v, 6, scale=10.0), u_applied=f(v, scale=0.02),
        u_pred=f(hp, v, scale=0.02), traj_pred=traj,
        ref_points=f(v, hp, 2, scale=20.0), x0_pred=f(v, 6, scale=10.0),
        feasible=b(), converged=b(), obj=f(), max_violation=f(),
        scp_iters=i(), qp_iters=i(), pred_obj=f(), pred_feasible=b(),
        delay_traj=f(10, 6, v), clamp_mag_events=i(),
        clamp_rate_events=i(), feas_disagree=i(), sides_stable=b())


def _to_torch(out, add_batch=False):
    return tengine.StepOutput(*[
        torch.as_tensor(np.array(a))[:, None] if add_batch
        else torch.as_tensor(np.array(a)) for a in out])


@pytest.mark.parametrize("kind,kw,instance", [
    ("circle", dict(n_veh=3), None),
    ("frog", dict(), None),
    ("parallel", dict(n_veh=3), 2),
])
def test_export_reference_json_equals_scp_tpu(tmp_path, kind, kw, instance):
    """Same numpy StepOutput arrays in, the same JSON out, value for value
    (a one-scenario run, and one instance of a batched run)."""
    cfg_j, data_j, data_t = _pair(kind, **kw)
    batch = None if instance is None else 4
    out_j = _fake_outputs(cfg_j, N_SIM, batch, seed=3)
    out_t = _to_torch(out_j, add_batch=instance is None)
    times = dict(step_times=[0.25, 0.5, 0.125],
                 controller_runtimes=[0.125, 0.25, 0.0625])
    pj, pt = tmp_path / "j.json", tmp_path / "t.json"
    jresults.export_reference_json(str(pj), cfg_j, data_j, out_j,
                                   instance=instance, **times)
    results.export_reference_json(str(pt), cfg_j, data_t, out_t,
                                  instance=instance, **times)
    got, want = json.loads(pt.read_text()), json.loads(pj.read_text())
    assert len(want) == 11 and list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k
    # without measured times the two keys are zero-filled in both
    results.export_reference_json(str(pt), cfg_j, data_t, out_t,
                                  instance=instance)
    got = json.loads(pt.read_text())
    assert got["stepTime"] == got["controllerRuntime"] == [0.0] * N_SIM


def test_export_refuses_a_batch_without_instance(tmp_path):
    cfg_j, _, data_t = _pair("circle", n_veh=3)
    out_t = _to_torch(_fake_outputs(cfg_j, 2, 3, seed=1))
    with pytest.raises(ValueError, match="instance="):
        results.export_reference_json(str(tmp_path / "x.json"), cfg_j,
                                      data_t, out_t)


def test_sim_outputs_to_arrays_and_npz_equal_scp_tpu(tmp_path):
    cfg_j, _, _ = _pair("circle", n_veh=3)
    out_j = _fake_outputs(cfg_j, N_SIM, 4, seed=5)
    out_t = _to_torch(out_j)
    want = jresults.sim_outputs_to_arrays(cfg_j, out_j)
    got = results.sim_outputs_to_arrays(cfg_j, out_t)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # one instance: scp_tpu's arrays of that instance's unbatched run
    sliced = jengine.StepOutput(*[a[:, 2] for a in out_j])
    want1 = jresults.sim_outputs_to_arrays(cfg_j, sliced)
    got1 = results.sim_outputs_to_arrays(cfg_j, out_t, instance=2)
    for k in want1:
        np.testing.assert_array_equal(got1[k], want1[k], err_msg=k)
    path = results.result_path(str(tmp_path), "circle", 3, "scp", True)
    assert path == jresults.result_path(str(tmp_path), "circle", 3, "scp",
                                        True)
    results.save_npz(path, got1)
    back = results.load_npz(path)
    for k in want1:
        np.testing.assert_array_equal(back[k], want1[k], err_msg=k)


@pytest.mark.parametrize("kind,kw", [("frog", {}), ("parallel", {"n_veh": 3}),
                                     ("circle", {"n_veh": 2})])
def test_obstacle_path_full_res_equals_scp_tpu(kind, kw):
    cfg_j, data_j, data_t = _pair(kind, **kw)
    np.testing.assert_array_equal(
        results.obstacle_path_full_res(cfg_j, data_t),
        jresults.obstacle_path_full_res(cfg_j, data_j))


@pytest.mark.parametrize("scenario,n_veh", [
    ("circle", 2), ("circle", 3), ("circle", 8), ("frog", 1),
    ("parallel", 4), ("parallel", 11), ("other", 2)])
def test_plot_limits_and_label_offsets_equal_scp_tpu(scenario, n_veh):
    np.testing.assert_array_equal(tbuilders.plot_limits(scenario, n_veh),
                                  jbuilders.plot_limits(scenario, n_veh))
    np.testing.assert_array_equal(tbuilders.label_offsets(scenario, n_veh),
                                  jbuilders.label_offsets(scenario, n_veh))


@pytest.mark.parametrize("kind,kw,controller", [
    ("frog", {}, "scp"), ("frog", {}, "side_selection"),
    ("circle", {"n_veh": 3}, "scp"), ("parallel", {"n_veh": 3}, "scp")])
def test_violation_flags_and_obstacle_centers_equal_scp_tpu(kind, kw,
                                                            controller):
    cfg_j, data_j, data_t = _pair(kind, **kw)
    cfg_j = cfg_j.replace(controller=controller)
    arrays = jresults.sim_outputs_to_arrays(
        cfg_j, _fake_outputs(cfg_j, N_SIM, None, seed=7, near=True))
    any_true = False
    for step in range(N_SIM):
        want = jplot.violation_flags(cfg_j, data_j, arrays, step)
        got = tplot.violation_flags(cfg_j, data_t, arrays, step)
        np.testing.assert_array_equal(got, want)
        any_true |= bool(want.any())
        obst = np.asarray(data_j.obstacles)
        np.testing.assert_array_equal(
            tplot.predicted_obstacle_centers(cfg_j, obst, step),
            jplot.predicted_obstacle_centers(cfg_j, obst, step))
        np.testing.assert_array_equal(
            tplot.obstacle_position(obst, 0.4 * step),
            jplot.obstacle_position(obst, 0.4 * step))
    assert any_true          # the inputs do reach the violation branch
    np.testing.assert_array_equal(
        tplot.transformed_rectangle(1.0, -2.0, 0.3, 4.0, 2.0),
        jplot.transformed_rectangle(1.0, -2.0, 0.3, 4.0, 2.0))


def _frames_lines(monkeypatch, render, *args, **kw):
    """The (x, y) data of every line of every figure ``render`` saves."""
    import matplotlib.figure

    saved = []

    def savefig(fig, path, *a, **k):
        saved.append([(np.asarray(ln.get_xdata(), float),
                       np.asarray(ln.get_ydata(), float))
                      for ax in fig.axes for ln in ax.lines])
        open(path, "wb").close()
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    paths = render(*args, **kw)
    return paths, saved


def test_render_video_frames_draws_the_lines_of_scp_tpu(tmp_path,
                                                        monkeypatch):
    matplotlib.use("Agg")
    cfg_j, data_j, data_t = _pair("frog")
    arrays = jresults.sim_outputs_to_arrays(
        cfg_j, _fake_outputs(cfg_j, 2, None, seed=9, near=True))
    pj, lj = _frames_lines(monkeypatch, jplot.render_video_frames, cfg_j,
                           data_j, arrays, str(tmp_path / "j"),
                           scenario="frog")
    pt, lt = _frames_lines(monkeypatch, tplot.render_video_frames, cfg_j,
                           data_t, arrays, str(tmp_path / "t"),
                           scenario="frog")
    assert [os.path.basename(p) for p in pt] == \
        [os.path.basename(p) for p in pj] == ["0000.png", "0001.png"]
    assert len(lt) == len(lj) == 2
    for frame_t, frame_j in zip(lt, lj):
        assert len(frame_t) == len(frame_j) > 3
        for (xt, yt), (xj, yj) in zip(frame_t, frame_j):
            np.testing.assert_array_equal(xt, xj)
            np.testing.assert_array_equal(yt, yj)


def _noisy_loop(seed=3):
    cfg, data = tbuilders.circle(3, radius=8.0, dtype=torch.float64,
                                 device="cpu", hp=5, hu=5, max_scp_iter=4)
    cfg = cfg.replace(noise_std=1e-3)
    return cfg, data


def test_checkpoint_resume_is_bitwise_with_plant_noise(tmp_path):
    """save -> load -> continue equals the run that was never stopped, bit
    for bit (the generator's state included); the write leaves no
    temporary file."""
    cfg, data = _noisy_loop()

    def run(carry, n):
        for _ in range(n):
            carry, out = tengine.mpc_step(cfg, data, carry)
        return carry, out

    def fresh(seed):
        return tengine.init_carry(
            cfg, data, torch.Generator().manual_seed(seed))

    straight, out_s = run(fresh(11), 2)
    first, _ = run(fresh(11), 1)
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, first, step=first.step)
    assert sorted(os.listdir(tmp_path)) == ["ckpt.npz"]
    resumed, step = checkpoint.load(path, fresh(99))
    assert step == 1 and resumed.step == 1
    resumed, out_r = run(resumed, 1)
    for name, a, b in zip(straight._fields, straight, resumed):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        elif isinstance(a, torch.Generator):
            assert torch.equal(a.get_state(), b.get_state())
        else:
            assert a == b, name
    assert torch.equal(out_s.states, out_r.states)
    # the noise did draw numbers
    assert not torch.equal(fresh(11).generator.get_state(),
                           straight.generator.get_state())
    # resume_or_init: the checkpoint when present, else a fresh start
    carry, step = checkpoint.resume_or_init(path, fresh, 5)
    assert step == 1 and torch.equal(carry.u_warm, first.u_warm)
    carry, step = checkpoint.resume_or_init(str(tmp_path / "none"), fresh, 5)
    assert step == 0 and carry.step == 0


def test_checkpoint_refuses_another_structure(tmp_path):
    cfg, data = _noisy_loop()
    carry = tengine.init_carry(cfg, data)
    checkpoint.save(str(tmp_path / "c.npz"), carry, 0)
    cfg2, data2 = tbuilders.circle(2, dtype=torch.float64, device="cpu",
                                   hp=5, hu=5)
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load(str(tmp_path / "c.npz"),
                        tengine.init_carry(cfg2, data2))
    no_meas = carry._replace(state_meas=None)
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load(str(tmp_path / "c.npz"), no_meas)


def test_check_finite_names_the_bad_leaf_as_scp_tpu_does():
    cfg_j, _, _ = _pair("circle", n_veh=2)
    out_j = _fake_outputs(cfg_j, 2, None, seed=2)
    out_j.obj[1] = np.nan
    tree_j = {"run": (out_j, 1.0)}
    tree_t = {"run": (_to_torch(out_j), 1.0)}
    with pytest.raises(FloatingPointError) as ej:
        jdebug.check_finite(tree_j, "sim")
    with pytest.raises(FloatingPointError) as et:
        debug.check_finite(tree_t, "sim")
    assert str(et.value) == str(ej.value)
    assert "['run'][0].obj: 1 non-finite" in str(et.value)
    out_j.obj[1] = 0.0
    debug.check_finite({"run": (_to_torch(out_j), 1.0)}, "sim")


def test_enable_nan_debugging_raises_at_the_op():
    x = torch.tensor([0.0, 1.0])
    debug.enable_nan_debugging()
    try:
        y = x + 1.0               # finite: no error
        with pytest.raises(FloatingPointError, match="aten.div"):
            x / x
        with pytest.raises(FloatingPointError, match="aten.sqrt"):
            torch.sqrt(y - 2.0)
    finally:
        debug.enable_nan_debugging(False)
    assert torch.isnan(x / x).any()     # switched off again


def test_determinism_check():
    gen = torch.Generator().manual_seed(0)
    assert debug.determinism_check(
        lambda a: (a * 2, {"n": torch.arange(3)}), torch.ones(4)) == 0.0
    assert debug.determinism_check(
        lambda: torch.rand(3, generator=gen)) > 0.0
    same = iter([torch.tensor([np.nan, 1.0]), torch.tensor([np.nan, 1.0])])
    assert debug.determinism_check(lambda: next(same)) == 0.0
    flip = iter([torch.tensor([np.nan, 1.0]), torch.tensor([1.0, 1.0])])
    assert debug.determinism_check(lambda: next(flip)) == math.inf


def test_timing_helpers(tmp_path):
    """``profile_trace`` writes a Chrome trace that holds the program's
    spans (an ``scp.step`` range of one MPC step) beside the operators,
    and its records are its own block's alone."""
    cfg, data = tbuilders.circle(3, dtype=torch.float64, device="cpu")
    cfg = cfg.replace(hp=5, hu=5)
    carry = tengine.init_carry(cfg, data)
    timing.clear()
    with torch.profiler.profile():          # an earlier session's step
        tengine.mpc_step(cfg, data, carry)
    with timing.profile_trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
        tengine.mpc_step(cfg, data, carry)
    assert [r["name"] for r in timing.recorded()].count("step") == 1
    timing.clear()
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "scp.step" in names and "scp.pre" in names
    assert any("mm" in e.key for e in prof.key_averages())


def _random_qp(n, m, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    P = a @ a.T + n * np.eye(n)
    q = rng.normal(size=n)
    G = rng.normal(size=(m, n))
    h = rng.uniform(0.5, 2.0, size=m)          # x = 0 strictly feasible
    return P, q, G, h, -2.0 * np.ones(n), 2.0 * np.ones(n)


@pytest.mark.parametrize("n,m,seed", [(10, 8, 50), (6, 0, 51), (12, 20, 52)])
def test_solve_qp_native_equals_scp_tpu_and_the_port(n, m, seed):
    """The same bits as scp_tpu's binding (one library, one call), and the
    port's float64 solve_qp within 1e-8."""
    args = _random_qp(n, m, seed)
    if m == 0:
        args = (args[0], args[1], np.zeros((0, n)), np.zeros(0),
                args[4], args[5])
    got = tnative.solve_qp_native(*args)
    want = jnative.solve_qp_native(*args)
    assert got.converged and want.converged
    np.testing.assert_array_equal(got.x, want.x)
    assert (got.obj, got.gap, got.primal_residual, got.iters) == \
        (want.obj, want.gap, want.primal_residual, want.iters)
    # tensors are taken as well
    again = tnative.solve_qp_native(*[torch.as_tensor(a) for a in args])
    np.testing.assert_array_equal(again.x, got.x)
    if m:
        sol = tqp.solve_qp(*[torch.as_tensor(a) for a in args],
                           max_iter=50, tol=1e-10)
        assert bool(sol.converged)
        np.testing.assert_allclose(sol.x.numpy(), got.x, atol=1e-8, rtol=0)
        np.testing.assert_allclose(float(sol.obj), got.obj, atol=1e-8,
                                   rtol=1e-8)
