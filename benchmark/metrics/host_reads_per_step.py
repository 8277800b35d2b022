"""Host reads of a device value per step: the port's counters
``scp.host_sync_count + qp.host_sync_count`` over the traced steps
(layer: host issue)."""


def read(record):
    if not record.get("steps") or "host_reads" not in record:
        return None
    return record["host_reads"] / record["steps"]
