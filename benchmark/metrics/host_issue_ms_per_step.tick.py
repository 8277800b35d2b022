"""``host_issue_ms_per_step`` in the fleet controller's tick, where it
moves the step's tail (layer: host issue)."""
from harness import program_spans


def read(record):
    return program_spans.host_issue_ms_per_step(record)
