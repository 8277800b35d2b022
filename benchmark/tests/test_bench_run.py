"""A run of the harness on the CPU at a tiny size (the look for a card
skipped): the last line's schema, the metrics each cell reports, the import
check, and run.py's refusal without a card."""
import json
import subprocess
import sys
import time

import pytest

import run as run_py
from harness import cells, runner

BENCH_JSON = cells.benchmark_json()


def tiny_run(name, trace, seconds=0.5, batch=3, fault=None, seed=2 ** 31 + 5):
    return runner.run(cells.load(name), seed, seconds, trace, "cpu",
                      time.time(), BENCH_JSON, batch=batch, fault=fault)


def check_schema(result, name, trace):
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    assert list(result)[-1] == "check"
    assert result["attempted"] > 0 and result["failed"] == 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = (cells.per_layer_for(name, BENCH_JSON) if trace
            else cells.end_to_end_for(name, BENCH_JSON))
    for m in result["metrics"]:
        assert m in {w["name"] for w in want}
    for m, entry in result["metrics"].items():
        assert set(entry) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        bd = result["breakdown"]
        assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    else:
        assert set(result["metrics"]) == {w["name"] for w in want}
    for entry in result["check"].values():
        assert set(entry) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("name, trace", [("circle8.sweep", False),
                                         ("parallel11ss.tick", False),
                                         ("parallel11ss.sweep", True)])
def test_a_tiny_run_on_the_cpu_gives_the_result_line(name, trace):
    result = tiny_run(name, trace)
    check_schema(result, name, trace)
    assert result["correct"] is True, result["check"]
    assert run_py.forbidden_modules() == []


def test_forbidden_modules_compare_whole_top_level_names():
    mods = ["scp_tpu_torch", "scp_tpu_torch.sim", "torch", "jaxtyping",
            "scp_tpu", "scp_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]
    assert run_py.forbidden_modules(mods) == [
        "flax.linen", "jax.numpy", "jaxlib", "scp_tpu", "scp_tpu.ops"]


def test_run_refuses_without_a_card_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without")
    proc = subprocess.run(
        [sys.executable, str(cells.BENCH / "run.py"), "--workload",
         "parallel11ss.tick", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=cells.BENCH.parent,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
