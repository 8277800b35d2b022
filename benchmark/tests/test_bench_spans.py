"""The per-layer metrics that read the port's own spans
(``scp_tpu_torch.utils.timing``): each reader on a synthetic record, and
nothing read where the steps and the port's ``step`` spans differ in
number or where the port has no tracer; a traced run on the CPU at a tiny
size, in which every new metric reads; and on the card, one step of each
cell's batch is bit for bit the same with tracing on and off."""
import time

import pytest
import torch

from harness import cells, program_spans, runner
from scp_tpu_torch.utils import timing

BENCH_JSON = cells.benchmark_json()
NEW = ("host_wait_ms_per_step", "host_issue_ms_per_step",
       "host_issue_ms_per_step.tick", "scp_lane_use")
MS = 1_000_000          # ns


def _rec(name, step, parent, t0, t1, **attrs):
    return {"name": name, "step": step, "parent": parent,
            "start_ns": t0 * MS, "end_ns": t1 * MS, "attrs": attrs}


def synthetic():
    """Two steps: the first with two SCP phases (8 lanes x 2 iterations,
    then 2 lanes x 1), three reads of 5 ms; the second with none."""
    return [
        _rec("step", 0, None, 0, 100),                               # 0
        _rec("scp.phase", 0, 0, 10, 60, k=0, width=8, iters=3,
             stragglers=8, lanes_useful=12),                         # 1
        _rec("sync", 0, 1, 10, 15, site="scp", active=8),            # 2
        _rec("scp.iter", 0, 1, 15, 30, width=8),                     # 3
        _rec("sync", 0, 1, 30, 35, site="scp", active=4),            # 4
        _rec("scp.iter", 0, 1, 35, 50, width=8),                     # 5
        _rec("scp.phase", 0, 0, 60, 90, k=1, width=2, iters=2,
             stragglers=4, lanes_useful=2),                          # 6
        _rec("sync", 0, 6, 60, 65, site="scp", active=2),            # 7
        _rec("scp.iter", 0, 6, 65, 80, width=2),                     # 8
        _rec("qp", 0, 8, 66, 79, route="struct"),                    # 9
        _rec("step", 1, None, 100, 160),                             # 10
        _rec("pre", 1, 10, 100, 120),                                # 11
    ]


@pytest.fixture
def spans(monkeypatch):
    recs = synthetic()
    monkeypatch.setattr(timing, "recorded", lambda: recs)
    return recs


@pytest.mark.parametrize("name, want", [
    ("host_wait_ms_per_step", 15.0 / 2),
    ("host_issue_ms_per_step", (160.0 - 15.0) / 2),
    ("host_issue_ms_per_step.tick", (160.0 - 15.0) / 2),
    ("scp_lane_use", 100.0 * 14 / (8 * 2 + 2 * 1))])
def test_each_reader_on_a_synthetic_record(spans, name, want):
    read = cells.metric_reader(name)
    assert read({"steps": 2}) == pytest.approx(want)
    assert read({"steps": 3}) is None        # steps and spans differ
    assert read({"steps": 0}) is None and read({}) is None


def test_readers_read_nothing_without_the_spans_they_read(monkeypatch):
    recs = [_rec("step", 0, None, 0, 10), _rec("pre", 0, 0, 1, 2)]
    monkeypatch.setattr(timing, "recorded", lambda: recs)
    record = {"steps": 1}
    assert cells.metric_reader("host_wait_ms_per_step")(record) is None
    assert cells.metric_reader("scp_lane_use")(record) is None
    assert cells.metric_reader("host_issue_ms_per_step")(record) == 10.0
    # a port without the tracer (a checkout older than it)
    monkeypatch.delattr(timing, "recorded")
    for name in NEW:
        assert cells.metric_reader(name)(record) is None
    assert program_spans.records(record) is None


@pytest.mark.parametrize("name", ["circle8.sweep", "parallel11ss.tick"])
def test_a_tiny_traced_run_reads_the_program_spans(name):
    timing.clear()
    cell = cells.load(name)
    result = runner.run(cell, 2 ** 31 + 11, 0.5, True, "cpu", time.time(),
                        BENCH_JSON, batch=3)
    n_sync = sum(1 for r in timing.recorded() if r["name"] == "sync")
    timing.clear()
    metrics = result["metrics"]
    listed = {m["name"] for m in cells.per_layer_for(name, BENCH_JSON)}
    for m in NEW:
        assert (m in metrics) == (m in listed), m
    if name == "circle8.sweep":
        assert 0.0 < metrics["scp_lane_use"]["value"] <= 100.0
        assert metrics["host_wait_ms_per_step"]["value"] > 0.0
        assert metrics["host_issue_ms_per_step"]["value"] > 0.0
        # one sync span for each of the port's counted reads, no other
        assert metrics["host_reads_per_step"]["value"] == pytest.approx(
            n_sync / cell.mix["trace_steps"])
    else:
        assert metrics["host_issue_ms_per_step.tick"]["value"] > 0.0


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH_JSON["workloads"]])
def test_tracing_changes_no_output_on_the_card(card, name):
    """One step of the cell's batch from the set-up's carry, without and
    then under a profiler: every output and the next carry bit for bit the
    same, as many host reads, and one ``step`` span."""
    from harness.program import Program
    from traffic.generate import generate

    cell = cells.load(name)
    prog = Program(cell.config, generate(cell.config, cell.mix, 5, card))
    prog.step(prog.carry0)                       # build and warm up
    torch.cuda.synchronize()
    timing.clear()
    prog.reset_counters()
    carry_off, out_off = prog.step(prog.carry0)
    torch.cuda.synchronize()
    reads_off = prog.host_reads()
    prog.reset_counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        carry_on, out_on = prog.step(prog.carry0)
        torch.cuda.synchronize()
    reads_on = prog.host_reads()
    recs = timing.recorded()
    timing.clear()
    for field, a in out_off._asdict().items():
        assert torch.equal(a, getattr(out_on, field)), field
    for field in ("state", "u_prev2", "u_prev1", "u_warm"):
        assert torch.equal(getattr(carry_off, field),
                           getattr(carry_on, field)), field
    assert reads_on == reads_off
    assert sum(1 for r in recs if r["name"] == "sync") == reads_on
    assert [r["name"] for r in recs].count("step") == 1
    # the spans are host ranges: none of them on the device's timeline
    assert not any(e.name.startswith(timing.PREFIX)
                   and e.device_type == torch.autograd.DeviceType.CUDA
                   for e in prof.events())
