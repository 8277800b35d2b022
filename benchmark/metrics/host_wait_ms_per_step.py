"""Milliseconds a step the host sits in the port's reads of a device value:
the port's ``sync`` spans (``scp_tpu_torch.utils.timing``) over the traced
run's profiled steps (layer: host issue)."""
from harness import program_spans


def read(record):
    recs = program_spans.records(record)
    wait = None if recs is None else program_spans.host_wait_ms(recs)
    return None if wait is None else wait / record["steps"]
