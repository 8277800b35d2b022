"""Milliseconds a step of the host's own time, unsynchronised: the port's
``step`` spans less its ``sync`` spans (``scp_tpu_torch.utils.timing``)
over the traced run's profiled steps (layer: host issue)."""
from harness import program_spans


def read(record):
    return program_spans.host_issue_ms_per_step(record)
