"""The port's command line against scp_tpu's, on the CPU: the config each
flag set builds, a float64 closed loop's summary against scp_tpu's
``engine.simulate`` (floats within 1e-8, counts exact), the Monte-Carlo
and export branches, ``sweep``'s summary against ``scp_tpu.cli.cmd_sweep``'s
(within 1e-12), and the refusals."""
import argparse
import dataclasses
import functools
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu import cli as jcli
from scp_tpu.scenarios import batch as jbatch
from scp_tpu.sim import engine as jengine
from scp_tpu_torch import cli as tcli, convert
from scp_tpu_torch.scenarios import batch as tbatch

from torch_parity import jit_fast, tonp

FLAG_GRID = list(itertools.product(
    [("circle", 0), ("circle", 3), ("frog", 2), ("parallel", 5)],
    [("scp", False, ""), ("scp", False, "banded"), ("scp", False, "auto"),
     ("side_selection", True, ""), ("side_selection", False, "")],
    [0, 7], [False, True]))


@pytest.mark.parametrize("f64", [False, True])
def test_build_equals_scp_tpu_field_by_field(f64):
    """``_build`` gives scp_tpu.cli._build's config for every flag set of
    the grid (scenario / vehicles, controller, rectangle obstacles, --kkt,
    --hp, --noise), in float32 (the tuned overrides) and float64."""
    jdt, tdt = (jnp.float64, torch.float64) if f64 else \
        (jnp.float32, torch.float32)
    n = 0
    for (scen, nv), (ctrl, rect, kkt), hp, noise in FLAG_GRID:
        args = argparse.Namespace(scenario=scen, n_veh=nv, controller=ctrl,
                                  rect_obstacles=rect, kkt=kkt, hp=hp,
                                  noise=noise)
        cfg_j, _ = jcli._build(args, jdt)
        cfg_t, data_t = tcli._build(args, tdt, "cpu")
        want, got = dataclasses.asdict(cfg_j), dataclasses.asdict(cfg_t)
        assert list(got) == list(want)
        for k in want:
            assert got[k] == want[k], (args, k, got[k], want[k])
        assert data_t.x0.dtype == tdt and data_t.x0.device.type == "cpu"
        n += 1
    assert n == len(FLAG_GRID) == 80


def _jax_summary(cfg, out, n_steps):
    """scp_tpu.cli.cmd_run's summary formulas, less the wall times."""
    return {
        "feasible_frac": float(jnp.mean(out.feasible)),
        "mean_scp_iters": float(np.asarray(out.scp_iters).mean()),
        "mean_obj": float(np.asarray(out.obj).mean()),
        "final_max_violation": float(np.asarray(out.max_violation).max()),
        "clamp_mag_events": int(np.asarray(out.clamp_mag_events).sum()),
        "clamp_rate_events": int(np.asarray(out.clamp_rate_events).sum()),
        "feas_disagree_steps": int(np.asarray(out.feas_disagree).sum()),
        "mean_qp_iters": float(np.asarray(out.qp_iters).mean()),
        "n_veh": cfg.n_veh, "steps": n_steps}


def test_run_f64_cpu_summary_equals_scp_tpu_simulate(capsys):
    """``run --cpu --f64`` on circle-3 at hp = 6 for 3 steps against
    scp_tpu's ``engine.simulate`` on the same config (no plant noise, so
    the generators play no part)."""
    argv = ["run", "--cpu", "--f64", "--n-veh", "3", "--hp", "6",
            "--steps", "3"]
    got = tcli.main(argv)
    printed = json.loads(capsys.readouterr().out)
    assert printed == got
    args = argparse.Namespace(scenario="circle", n_veh=3, controller="scp",
                              rect_obstacles=False, kkt="", hp=6,
                              noise=False)
    cfg_j, data_j = jcli._build(args, jnp.float64)
    key = jax.random.PRNGKey(0)
    sim = jit_fast(functools.partial(jengine.simulate, cfg_j, n_steps=3),
                   data_j, key)
    _, out_j = sim(data_j, key)
    want = _jax_summary(cfg_j, out_j, 3)
    assert got["scenario"] == "circle" and got["mc"] == 1
    assert got["wall_s"] > 0 and got["steps_per_sec"] > 0
    for k, w in want.items():
        if isinstance(w, int):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-8, atol=1e-8,
                                       err_msg=k)


def test_run_mc_export_out_and_frames(tmp_path, capsys):
    """--mc 2 through simulate_batch, one instance exported in the
    reference format, the npz of the batch, and frames of that instance."""
    js, npz, frames = (tmp_path / "r.json", tmp_path / "r.npz",
                       tmp_path / "frames")
    got = tcli.main(["run", "--cpu", "--n-veh", "3", "--hp", "5",
                     "--steps", "2", "--mc", "2", "--noise",
                     "--export-json", str(js), "--export-instance", "1",
                     "--out", str(npz), "--frames", str(frames)])
    err = capsys.readouterr().err
    assert "instance 1 of the 2-wide batch" in err
    assert got["mc"] == 2 and got["steps"] == 2
    payload = json.loads(js.read_text())
    assert len(payload) == 11
    assert np.asarray(payload["controlPredictions"]).shape == (5, 3, 2)
    assert np.asarray(payload["vehiclePathFullRes"]).shape == (6, 3, 81)
    assert payload["stepTime"] == [0.0, 0.0]      # not measured on --mc
    arrays = np.load(npz)
    assert arrays["u_pred"].shape == (2, 2, 5, 3)
    np.testing.assert_array_equal(
        np.asarray(payload["controlPredictions"]),
        arrays["u_pred"][:, 1].transpose(1, 2, 0))
    assert sorted(p.name for p in frames.iterdir()) == ["0000.png",
                                                        "0001.png"]


def test_run_export_json_measures_step_times(tmp_path):
    js = tmp_path / "one.json"
    tcli.main(["run", "--cpu", "--scenario", "frog", "--hp", "4",
               "--steps", "2", "--export-json", str(js)])
    payload = json.loads(js.read_text())
    assert all(t > 0 for t in payload["stepTime"])
    assert all(0 < c <= t for c, t in zip(payload["controllerRuntime"],
                                          payload["stepTime"]))
    assert np.asarray(payload["obstaclePathFullRes"]).shape[:2] == (22, 6)


@pytest.mark.parametrize("argv,says", [
    (["run", "--f64"], "--f64 runs on the CPU only"),
    (["sweep", "--f64"], "--f64 runs on the CPU only"),
])
def test_run_refusals_before_any_work(argv, says, capsys, monkeypatch):
    def no_work(*a, **k):
        raise AssertionError("the run must be refused before any work")
    monkeypatch.setattr(tcli, "_build", no_work)
    monkeypatch.setattr(tcli, "sweep_inputs", no_work)
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert e.value.code == 2
    assert says in capsys.readouterr().err


@pytest.mark.parametrize("cmd,kkt", [("run", "banded"), ("sweep", "dense")])
def test_side_selection_runs_as_without_kkt(cmd, kkt, capsys):
    """``--kkt`` has no effect on the side-selection controller (its QPs
    always take the dense KKT; scp_tpu's CLI takes the flag and runs):
    frog side selection on the CPU with ``--kkt`` gives the summary of the
    same run without it, wall times aside, and one line on stderr says
    so."""
    base = [cmd, "--cpu", "--f64", "--scenario", "frog", "--controller",
            "side_selection", "--hp", "4", "--steps", "2"]
    if cmd == "sweep":
        base += ["--batch", "2"]
    timeless = ("wall_s", "steps_per_sec", "solves_per_sec")
    want = tcli.main(base)
    assert "--kkt" not in capsys.readouterr().err
    got = tcli.main(base + ["--kkt", kkt])
    assert "--kkt has no effect" in capsys.readouterr().err
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k not in timeless:
            assert got[k] == v, k


def test_sweep_names_the_scale_out_item(capsys, monkeypatch):
    """Scale-out (ROADMAP item 11) is ported: ``sweep --cpu --f64`` prints
    ``scp_tpu.cli.cmd_sweep``'s summary for the same flags (circle-3,
    hp = 5, 16 instances, 2 steps, seed 5) on the same batch — scp_tpu's,
    converted, since the two packages' generators differ — its floats
    within 1e-12; the wall time and the mesh (8 JAX devices here, one
    rank) aside."""
    argv = ["sweep", "--cpu", "--f64", "--n-veh", "3", "--hp", "5",
            "--batch", "16", "--steps", "2", "--seed", "5"]
    jcli.cmd_sweep(argparse.Namespace(
        scenario="circle", batch=16, n_veh=3, steps=2, hp=5,
        controller="scp", rect_obstacles=False, n_model=1, batched=False,
        kkt="", checkpoint="", checkpoint_every=0, seed=5, f64=True,
        cpu=True))
    want = json.loads(capsys.readouterr().out)

    def scp_tpu_batch(kind, n, generator=None, dtype=None, device=None,
                      **kw):
        cfg_j, data_j = jbatch.make_batch(kind, n, key=jax.random.PRNGKey(5),
                                          dtype=jnp.float64, **kw)
        return (convert.config_from_dict(dataclasses.asdict(cfg_j)),
                convert.scenario_from_numpy(tonp(data_j), dtype, device))
    monkeypatch.setattr(tbatch, "make_batch", scp_tpu_batch)
    got = tcli.main(argv)
    assert json.loads(capsys.readouterr().out) == got
    assert got["mesh"] == {"data": 1, "model": 1} and got["wall_s"] > 0
    for k in ("scenario", "batch", "steps"):
        assert got[k] == want[k], k
    for k in ("feasible_frac", "mean_obj", "mean_scp_iters"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_bench_subcommand_sets_the_module_constants(monkeypatch):
    from scp_tpu_torch import bench
    seen = {}
    monkeypatch.setattr(bench, "worker",
                        lambda: seen.update(B=bench.BATCH, hp=bench.HP))
    monkeypatch.setattr(bench, "BATCH", bench.BATCH)
    monkeypatch.setattr(bench, "HP", bench.HP)
    tcli.main(["bench", "--batch", "8", "--hp", "0"])
    assert seen == {"B": 8, "hp": 20}
