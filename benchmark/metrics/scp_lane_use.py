"""Share of the SCP loop's lane-iterations that carry an instance still
iterating [%]: over the port's ``scp.phase`` spans, the iterations run by
the lanes that hold a straggler (``lanes_useful``) over the lanes run
(``width`` x the phase's ``scp.iter`` spans) (layer: SCP loop)."""
from harness import program_spans


def read(record):
    recs = program_spans.records(record)
    return None if recs is None else program_spans.lane_use(recs)
