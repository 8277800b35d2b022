"""scp_tpu_torch.config pinned to scp_tpu.config, import hygiene of the port,
its device policy, and the numpy converters."""
import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from scp_tpu import config as jcfg
from scp_tpu_torch import config as tcfg
from scp_tpu_torch import convert

REPO = pathlib.Path(__file__).resolve().parent.parent
FIELDS = [f.name for f in dataclasses.fields(jcfg.SCPConfig)]
PROPS = ["ticks_per_sim", "n_sim", "ticks_total", "ticks_delay_x",
         "ticks_delay_u", "n_pairs", "n_constraints", "delay_comp_time"]


def test_same_fields_in_same_order():
    assert [f.name for f in dataclasses.fields(tcfg.SCPConfig)] == FIELDS


@pytest.mark.parametrize("name", FIELDS)
def test_default_equals_scp_tpu(name):
    assert getattr(tcfg.SCPConfig(), name) == getattr(jcfg.SCPConfig(), name)


@pytest.mark.parametrize("name", PROPS)
def test_derived_property_equals_scp_tpu(name):
    for over in (dict(), dict(n_veh=4, n_obst=3, hp=20, hu=20),
                 dict(delay_x=0.07, delay_u=0.05, dt=0.2, t_end=7.0)):
        assert getattr(tcfg.SCPConfig(**over), name) \
            == getattr(jcfg.SCPConfig(**over), name)


@pytest.mark.parametrize("name", ["TUNED_F32_OVERRIDES", "TUNED_F32_V16",
                                  "TUNED_F32_SIDE_SELECTION",
                                  "TUNED_F32_PHASES", "NX", "NU", "NY"])
def test_calibrated_constants_equal_scp_tpu(name):
    assert getattr(tcfg, name) == getattr(jcfg, name)


def test_tuned_f32_equals_scp_tpu():
    a = tcfg.tuned_f32(tcfg.SCPConfig(n_veh=4, hp=20, hu=20), qp_tol=1e-5)
    b = jcfg.tuned_f32(jcfg.SCPConfig(n_veh=4, hp=20, hu=20), qp_tol=1e-5)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.qp_fixed_iters == 7 and a.qp_kkt == "auto"


def test_hu_not_hp_rejected():
    with pytest.raises(ValueError):
        tcfg.SCPConfig(hp=10, hu=8)
    with pytest.raises(ValueError):
        tcfg.SCPConfig().replace(hp=12)


def test_config_is_frozen_and_hashable():
    cfg = tcfg.SCPConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.hp = 3
    assert hash(cfg) == hash(tcfg.SCPConfig())


def test_default_vehicle_params_equal_scp_tpu():
    pj = jcfg.default_vehicle_params(3)
    pt = tcfg.default_vehicle_params(3, torch.float64, "cpu")
    for f in dataclasses.fields(jcfg.VehicleParams):
        np.testing.assert_array_equal(
            getattr(pt, f.name).numpy()[0], np.asarray(getattr(pj, f.name)))


def _port_sources():
    files = sorted((REPO / "scp_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_sources_never_import_jax_or_scp_tpu():
    """No file of the port, and not chip_smoke.py, imports jax or anything of
    the JAX package."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|scp_tpu)(\s|\.|$)", re.M)
    assert len(_port_sources()) > 10
    bad = [str(p) for p in _port_sources() if pat.search(p.read_text())]
    assert not bad, bad


def test_port_imports_with_jax_and_scp_tpu_blocked():
    """Every module of the port imports in a process where ``jax`` and
    ``scp_tpu`` cannot be imported, and none imports matplotlib (the
    plotting functions import it where they draw)."""
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in sorted((REPO / "scp_tpu_torch").rglob("*.py"))
            if p.name != "__init__.py"]
    assert {"scp_tpu_torch.ops.riccati", "scp_tpu_torch.ops.riccati_kernel",
            "scp_tpu_torch.utils.debug", "scp_tpu_torch.cli",
            "scp_tpu_torch.bench", "scp_tpu_torch.utils.results",
            "scp_tpu_torch.utils.timing", "scp_tpu_torch.utils.checkpoint",
            "scp_tpu_torch.runtime.native", "scp_tpu_torch.viz.plot"
            } <= set(mods)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['scp_tpu'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') "
        "for k, v in sys.modules.items() if v is not None)\n"
        "assert 'matplotlib' not in sys.modules\n"
        "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_tf32_stays_off():
    import scp_tpu_torch
    assert torch.backends.cuda.matmul.allow_tf32 is False
    scp_tpu_torch.assert_full_f32()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            scp_tpu_torch.assert_full_f32()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("entry", ["make_batch", "circle", "frog",
                                   "parallel", "cli_run", "bench_worker"])
def test_entry_points_default_to_cuda_and_raise_without_gpu(entry,
                                                            monkeypatch):
    """Builders, ``cli run`` and ``bench.worker`` run on the card unless
    told otherwise (``device="cpu"``, ``--cpu``): without a GPU the default
    raises instead of falling back to the CPU."""
    from scp_tpu_torch import bench, cli
    from scp_tpu_torch.scenarios import batch, builders
    for name, val in dict(BATCH=2, ITERS=1, LSTEPS=1, REPS=2, HP=3).items():
        monkeypatch.setattr(bench, name, val)

    def cli_run(device="cuda"):
        summary = cli.main(["run", "--n-veh", "2", "--hp", "3", "--steps",
                            "1"] + (["--cpu"] if device == "cpu" else []))
        return device, summary

    fn = {"make_batch": lambda **kw: batch.make_batch("circle", 2, **kw),
          "circle": lambda **kw: builders.circle(2, **kw),
          "frog": lambda **kw: builders.frog(**kw),
          "parallel": lambda **kw: builders.parallel(3, **kw),
          "cli_run": cli_run,
          "bench_worker": lambda **kw: (kw, bench.worker(**kw))}[entry]
    if torch.cuda.is_available():
        if entry in ("cli_run", "bench_worker"):
            return                  # the card's runs are chip_smoke.py's
        assert fn()[1].x0.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    if entry == "cli_run":
        assert cli_run(device="cpu")[1]["steps"] == 1
    elif entry == "bench_worker":
        assert fn(device="cpu")[1]["value"] > 0
    else:
        assert fn(device="cpu")[1].x0.device.type == "cpu"


def test_convert_round_trip():
    from scp_tpu_torch.scenarios import builders
    from scp_tpu_torch.sim import engine
    cfg, data = builders.parallel(3, dtype=torch.float64, device="cpu")
    as_np = convert.to_numpy(data)
    assert set(as_np) == {f.name for f in dataclasses.fields(data)}
    back = convert.scenario_from_numpy(as_np, torch.float64, "cpu")
    for name, val in as_np.items():
        if name != "params":
            assert torch.equal(getattr(back, name), getattr(data, name))
    assert back.ref_valid.dtype == torch.bool
    assert torch.equal(back.params.r, data.params.r)
    carry = engine.init_carry(cfg, data)
    c_np = convert.to_numpy(carry)
    assert c_np["generator"] is None and c_np["step"] == 0
    c_np.pop("generator")
    c2 = convert.carry_from_numpy(c_np, torch.float64, "cpu")
    assert torch.equal(c2.state, carry.state) and c2.step == 0
    unb = convert.scenario_from_numpy(
        {k: (v[0] if k != "params" else {kk: vv[0] for kk, vv in v.items()})
         for k, v in as_np.items()}, torch.float64, "cpu", batched=False)
    assert torch.equal(unb.x0, data.x0)
    cfg2 = convert.config_from_dict(dataclasses.asdict(cfg))
    assert cfg2 == cfg
