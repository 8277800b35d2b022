"""Every configuration, cell, traffic mix and metric reader parses and is
found by name, and agrees with BENCHMARK.json and with the port."""
import dataclasses
import json

import pytest
import torch

from harness import cells, check
from traffic.generate import HERE as TRAFFIC, load_mix

BENCH_JSON = cells.benchmark_json()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_benchmark_json_has_the_contract_keys():
    assert set(BENCH_JSON) == KEYS
    assert BENCH_JSON["paths"] == ["benchmark"]
    assert BENCH_JSON["command"] == ["python3", "benchmark/run.py"]
    names = [m["name"] for m in BENCH_JSON["end_to_end"]]
    assert "setup_s" in names


@pytest.mark.parametrize("entry", BENCH_JSON["workloads"],
                         ids=lambda e: e["name"])
def test_each_cell_is_found_by_name(entry):
    cell = cells.load(entry["name"])
    assert cell.config["name"] == entry["config"]
    assert cell.mix == load_mix(entry["traffic"])
    assert cell.chips == entry["chips"] == 1
    w = json.loads((cells.WORKLOADS / f"{entry['name']}.json").read_text())
    assert {k: entry[k] for k in ("config", "traffic", "chips", "why")} == w
    e2e = [m["name"] for m in cells.end_to_end_for(entry["name"], BENCH_JSON)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cells.per_layer_for(entry["name"], BENCH_JSON)


@pytest.mark.parametrize("entry", BENCH_JSON["configs"],
                         ids=lambda e: e["name"])
def test_each_configuration_file_is_its_own(entry):
    config = cells.load_config(entry["name"])
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    whole = check.whole_batch(config)
    assert set(config["limits"]) == {"pre", "qp", "ctrl", "plant"} | (
        {"strag"} if whole else set())
    assert set(config["limits"]) <= set(check.NUMBERS)


@pytest.mark.parametrize("name", ["circle8-hp10", "parallel11-ss-hp10"])
def test_configuration_settings_are_the_ports(name):
    """The file's settings are what the port's own builder and calibrated
    float32 settings give for the scenario."""
    from scp_tpu_torch import config as C
    from scp_tpu_torch.scenarios import builders
    config = cells.load_config(name)
    s = config["settings"]
    cfg, _ = builders.BUILDERS[config["scenario"]](
        dtype=torch.float32, device="cpu", **config["scenario_args"])
    cfg = cfg.replace(hp=s["hp"], hu=s["hu"], controller=s["controller"])
    extra = (C.TUNED_F32_SIDE_SELECTION if s["controller"] == "side_selection"
             else {})
    assert dataclasses.asdict(C.tuned_f32(cfg, **extra)) == s
    if config["phases"] is not None:
        assert tuple(map(tuple, config["phases"])) == C.TUNED_F32_PHASES


@pytest.mark.parametrize("metric", BENCH_JSON["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    read = cells.metric_reader(metric["name"])
    assert read({}) is None
    assert metric["moves"] in {m["name"] for m in BENCH_JSON["end_to_end"]}


def test_every_traffic_file_is_named_by_a_cell():
    named = {w["traffic"] for w in BENCH_JSON["workloads"]}
    assert {p.stem for p in TRAFFIC.glob("*.json")} == named


def test_a_name_that_is_not_there_is_refused():
    with pytest.raises(FileNotFoundError):
        cells.load("no.such.cell")
    with pytest.raises(FileNotFoundError):
        cells.metric_reader("no_such_metric")
