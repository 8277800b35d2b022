"""The port's own spans (``scp_tpu_torch.utils.timing``) of the traced
run's profiled steps, for the per-layer metrics that read them and for
the port's step profiler (``scripts/torch_step_profile.py``). A port
without the tracer, or a record whose steps and the port's ``step`` spans
differ in number, gives nothing to read."""
from __future__ import annotations


def records(record: dict) -> list[dict] | None:
    """The port's span records of the profiled steps (each record's
    ``parent`` an index into the list), or None where there is nothing to
    read."""
    steps = record.get("steps")
    if not steps:
        return None
    from scp_tpu_torch.utils import timing
    recorded = getattr(timing, "recorded", None)
    if recorded is None:
        return None
    recs = recorded()
    if sum(1 for r in recs if r["name"] == "step") != steps:
        return None
    return recs


def ms(rec: dict) -> float:
    """A span's duration on the host's clock [ms]."""
    return (rec["end_ns"] - rec["start_ns"]) * 1e-6


def total_ms(recs: list[dict], name: str) -> float:
    """The summed duration of the spans ``name`` inside a step [ms]."""
    return sum(ms(r) for r in recs
               if r["name"] == name and r["step"] is not None)


def host_wait_ms(recs: list[dict]) -> float | None:
    """The time the host sat in the program's device reads (``sync``
    spans) [ms], or None where the steps made no read."""
    if not any(r["name"] == "sync" for r in recs):
        return None
    return total_ms(recs, "sync")


def host_issue_ms(recs: list[dict]) -> float:
    """The host's own time in the steps: the ``step`` spans less the time
    it sat in the program's device reads [ms]."""
    return total_ms(recs, "step") - total_ms(recs, "sync")


def phase_iterations(recs: list[dict]) -> dict[int, int]:
    """For each ``scp.phase`` record (by index) the number of ``scp.iter``
    spans under it, at any depth."""
    iters = {i: 0 for i, r in enumerate(recs) if r["name"] == "scp.phase"}
    for r in recs:
        if r["name"] == "scp.iter":
            p = r["parent"]      # the nearest scp.phase above it
            while p is not None and p not in iters:
                p = recs[p]["parent"]
            if p is not None:
                iters[p] += 1
    return iters


def lane_use(recs: list[dict]) -> float | None:
    """Share of the SCP phases' lane-iterations that carry an instance
    still iterating [%]: Σ ``lanes_useful`` over Σ ``width`` x the phase's
    ``scp.iter`` spans; None where no phase ran an iteration."""
    iters = phase_iterations(recs)
    run = sum(recs[i]["attrs"]["width"] * n for i, n in iters.items())
    if not run:
        return None
    useful = sum(recs[i]["attrs"]["lanes_useful"] for i in iters)
    return 100.0 * useful / run


def host_issue_ms_per_step(record: dict) -> float | None:
    """:func:`host_issue_ms`, a step's mean over the profiled steps."""
    recs = records(record)
    if recs is None:
        return None
    return host_issue_ms(recs) / record["steps"]
