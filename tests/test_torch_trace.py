"""The port's spans (``utils/timing.py``) on the CPU: nothing is recorded
while no profiler records; under a ``torch.profiler`` session each step
has one ``step`` span, every span nests under the layer that calls it, each
record has its profiler range of the same name in the same order, an
``scp.iter`` follows each SCP read that found an instance still active,
the phases' useful lanes add up to the step's SCP iterations, and the
step's outputs are bit for bit those of the step without the profiler."""
import importlib.util
import os

import pytest
import torch

from scp_tpu_torch import config as tcfg
from scp_tpu_torch.scenarios import batch as tbatch
from scp_tpu_torch.sim import engine
from scp_tpu_torch.utils import timing

B = 4

# the layer each span is opened from: the names of its possible parents
PARENTS = {
    "step": {None},
    "pre": {"step"}, "post": {"step"},
    "pre.delay": {"pre"}, "pre.reference": {"pre"},
    "pre.discretize": {"pre"}, "pre.condense": {"pre"},
    "pre.system": {"pre"},
    "post.forward": {"post"}, "post.plant": {"post"},
    "post.metrics": {"post"},
    "scp.phase": {"step"},
    "scp.iter": {"scp.phase", "step"},
    "qp": {"scp.iter", "ss.candidates", "ss.round"},
    "k1": {"qp"}, "k2": {"qp"},
    "ss.select": {"step"},
    "ss.candidates": {"ss.select"}, "ss.round": {"ss.select"},
    "ss.check": {"ss.select"},
}
SYNC_PARENTS = {"scp": {"scp.phase", "step"}, "ipm": {"qp"}}


def _case(name):
    """(cfg, data, step function) of a case at B = 4."""
    gen = torch.Generator().manual_seed(7)
    if name == "side_selection":
        cfg, data = tbatch.make_batch("parallel", B, generator=gen,
                                      dtype=torch.float32, device="cpu",
                                      n_veh=3)
        cfg = tcfg.tuned_f32(
            cfg.replace(controller="side_selection", hp=6, hu=6),
            **tcfg.TUNED_F32_SIDE_SELECTION)
        return cfg, data, lambda c: engine.mpc_step_batch(cfg, data, c)
    cfg, data = tbatch.make_batch("circle", B, generator=gen,
                                  dtype=torch.float32, device="cpu",
                                  n_veh=4)
    cfg = cfg.replace(hp=6, hu=6)
    if name == "mpc_step_batch_adaptive":
        # the default settings: the adaptive IPM, one read an iteration
        return cfg, data, lambda c: engine.mpc_step_batch(cfg, data, c)
    cfg = tcfg.tuned_f32(cfg)
    if name == "mpc_step":
        return cfg, data, lambda c: engine.mpc_step(cfg, data, c)
    return cfg, data, lambda c: engine.mpc_step_batch(
        cfg, data, c, phases=tcfg.TUNED_F32_PHASES)


CASES = ["mpc_step", "mpc_step_batch_phases", "side_selection",
         "mpc_step_batch_adaptive"]


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        result = fn()
    return result, prof


@pytest.fixture(scope="module", params=CASES)
def traced(request):
    """One step of the case from its initial carry with tracing off, then
    the same step under a CPU profiler: (case, off, on, records, ranges)
    with ``ranges`` the profiler's ``scp.*`` ranges in order."""
    cfg, data, step = _case(request.param)
    carry = engine.init_carry(cfg, data)
    timing.clear()
    off = step(carry)
    assert timing.recorded() == []
    on, prof = _profiled(lambda: step(carry))
    recs = timing.recorded()
    timing.clear()
    ranges = sorted(((e.time_range.start, -e.time_range.end, e.name)
                     for e in prof.events()
                     if e.name.startswith(timing.PREFIX)))
    return request.param, off, on, recs, [n for _, _, n in ranges]


def test_nothing_is_recorded_without_a_profiler(traced):
    """With no profiler session the step leaves no record (asserted in
    the fixture) and every span is the one shared no-op."""
    assert timing.span("step", B=B) is timing.span("qp")
    assert not timing.span("step").on


def test_one_step_span_and_every_span_under_its_layer(traced):
    case, _, _, recs, _ = traced
    steps = [r for r in recs if r["name"] == "step"]
    assert len(steps) == 1
    assert steps[0]["attrs"]["B"] == B
    assert {r["step"] for r in recs} == {steps[0]["step"]}
    for r in recs:
        parent = None if r["parent"] is None else recs[r["parent"]]
        pname = None if parent is None else parent["name"]
        want = (SYNC_PARENTS[r["attrs"]["site"]] if r["name"] == "sync"
                else PARENTS[r["name"]])
        assert pname in want, (r["name"], pname)
        assert r["end_ns"] is not None and r["end_ns"] >= r["start_ns"]
        if parent is not None:
            assert parent["start_ns"] <= r["start_ns"]
            assert r["end_ns"] <= parent["end_ns"]
    names = {r["name"] for r in recs}
    assert {"pre", "post", "pre.delay", "pre.reference", "pre.discretize",
            "pre.condense", "pre.system", "post.forward", "post.plant",
            "post.metrics"} <= names
    if case == "side_selection":
        assert {"ss.select", "ss.candidates", "ss.round", "ss.check",
                "qp", "k1"} <= names
        assert "sync" not in names
        widths = {r["name"]: r["attrs"]["width"] for r in recs
                  if r["name"].startswith("ss.")}
        assert widths["ss.candidates"] == 5 * B
        assert widths["ss.select"] == widths["ss.round"] == B
    else:
        assert {"sync", "scp.iter"} <= names
    if case == "mpc_step_batch_phases":
        k1 = [r["attrs"] for r in recs if r["name"] == "k1"]
        assert k1 and all(a["tier"] == "plain" and a["hp"] == 6
                          and a["n_iters"] == 7 for a in k1)
        assert {r["attrs"]["route"] for r in recs
                if r["name"] == "qp"} == {"struct"}
    if case == "mpc_step_batch_adaptive":
        assert any(r["name"] == "sync" and r["attrs"]["site"] == "ipm"
                   for r in recs)


def test_each_record_has_its_profiler_range_in_order(traced):
    _, _, _, recs, ranges = traced
    assert ranges == [timing.PREFIX + r["name"] for r in recs]


def test_an_scp_iteration_follows_each_read_of_an_active_instance(traced):
    case, _, _, recs, _ = traced
    reads = [i for i, r in enumerate(recs)
             if r["name"] == "sync" and r["attrs"]["site"] == "scp"]
    if case == "side_selection":
        assert not reads
        return
    assert reads
    for i in reads:
        active = recs[i]["attrs"]["active"]
        assert isinstance(active, int) and 0 <= active <= B
        later = [r for r in recs[i + 1:] if r["parent"] == recs[i]["parent"]]
        if active > 0:
            assert later and later[0]["name"] == "scp.iter"
            assert later[0]["attrs"]["width"] > 0
        else:
            assert not any(r["name"] == "scp.iter" for r in later)


def test_useful_lanes_add_up_to_the_scp_iterations(traced):
    case, _, (_, out), recs, _ = traced
    phases = [(i, r) for i, r in enumerate(recs) if r["name"] == "scp.phase"]
    if not case.startswith("mpc_step_batch"):
        assert not phases
        return
    # without a schedule the default one: (8, 1), (max_scp_iter - 8, 4)
    schedule = (tcfg.TUNED_F32_PHASES if case == "mpc_step_batch_phases"
                else ((8, 1), (12, 4)))
    assert [r["attrs"]["k"] for _, r in phases] == list(range(len(schedule)))
    assert [r["attrs"]["iters"] for _, r in phases] == [
        p[0] for p in schedule]
    assert [r["attrs"]["width"] for _, r in phases] == [
        max(B // p[1], 1) for p in schedule]
    assert sum(r["attrs"]["lanes_useful"] for _, r in phases) \
        == int(out.scp_iters.sum())
    assert phases[0][1]["attrs"]["stragglers"] == B
    for i, r in phases:
        a = r["attrs"]
        n_iter = sum(1 for c in recs
                     if c["parent"] == i and c["name"] == "scp.iter")
        assert n_iter <= a["iters"]
        assert 0 <= a["lanes_useful"] <= a["width"] * n_iter
        assert 0 <= a["stragglers"] <= B


def test_tracing_changes_no_output(traced):
    _, (carry_off, out_off), (carry_on, out_on), _, _ = traced
    for name, a in out_off._asdict().items():
        assert torch.equal(a, getattr(out_on, name)), name
    for name in ("state", "u_prev2", "u_prev1", "u_warm", "state_meas"):
        assert torch.equal(getattr(carry_off, name),
                           getattr(carry_on, name)), name
    assert carry_off.step == carry_on.step == 1


def _step_profiler():
    """``scripts/torch_step_profile.py`` as a module."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "torch_step_profile.py")
    spec = importlib.util.spec_from_file_location("torch_step_profile", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_step_profiler_reads_every_span_and_attr(traced):
    """The step profiler's tables hold every span: each name's self time,
    each span with all its attrs under ``calls`` but the phases and the
    reads, which ``scp_detail`` lists a step with their counts."""
    case, _, (_, out), recs, _ = traced
    prof = _step_profiler()
    assert set(prof.span_table(recs, 1)) == {r["name"] for r in recs}
    calls = prof.calls_by_attrs(recs, 1)
    others = [r for r in recs if r["name"] not in ("scp.phase", "sync")]
    assert sum(calls.values()) == len(others)
    for r in others:
        key = " ".join([r["name"]] + [f"{k}={v}" for k, v in
                                      sorted(r["attrs"].items())])
        assert key in calls
    if case == "mpc_step_batch_phases":
        assert any(k.startswith("k1 ") and "tier=plain" in k and "hp=6" in k
                   for k in calls)
    (one,) = prof.scp_detail(recs)
    assert one["scp_active"] == [r["attrs"]["active"] for r in recs
                                 if r["name"] == "sync"
                                 and r["attrs"]["site"] == "scp"]
    assert one["ipm_reads"] == sum(1 for r in recs if r["name"] == "sync"
                                   and r["attrs"]["site"] == "ipm")
    phases = [r["attrs"] for r in recs if r["name"] == "scp.phase"]
    assert [(p["k"], p["width"], p["iters"], p["stragglers"],
             p["lanes_useful"]) for p in one["phases"]] == [
        (a["k"], a["width"], a["iters"], a["stragglers"], a["lanes_useful"])
        for a in phases]
    if phases:
        assert sum(p["lanes_useful"] for p in one["phases"]) \
            == int(out.scp_iters.sum())
        assert sum(p["ran"] for p in one["phases"]) == sum(
            1 for r in recs if r["name"] == "scp.iter")


def test_span_records_attrs_nest_and_close_on_raise():
    """The tracer alone: a device-tensor attr is read when the records are
    read, a span closes when its block raises, spans outside a step carry
    no step id, and ``clear`` starts the ids again."""
    timing.clear()

    def run():
        with timing.span("step", B=2):
            with timing.span("qp", route="struct") as sp:
                assert sp.on
                sp.set(lanes=torch.tensor(3))
            with pytest.raises(ValueError):
                with timing.span("sync", site="scp"):
                    raise ValueError("inside a span")
        with timing.span("post"):
            pass

    _, prof = _profiled(run)
    recs = timing.recorded()
    assert [r["name"] for r in recs] == ["step", "qp", "sync", "post"]
    assert [r["parent"] for r in recs] == [None, 0, 0, None]
    assert [r["step"] for r in recs] == [0, 0, 0, None]
    assert recs[1]["attrs"] == {"route": "struct", "lanes": 3}
    assert all(r["end_ns"] >= r["start_ns"] for r in recs)
    assert timing.recorded() == recs          # read again, left in place
    names = [e.name for e in prof.events()
             if e.name.startswith(timing.PREFIX)]
    assert sorted(names) == sorted(timing.PREFIX + r["name"] for r in recs)
    timing.clear()
    assert timing.recorded() == []
    _profiled(lambda: timing.span("step").__enter__().__exit__(None, None,
                                                                None))
    assert timing.recorded()[0]["step"] == 0
    timing.clear()
