"""CUDA kernel launches per step in the traced window's profiler trace
(layer: host issue)."""


def read(record):
    if not record.get("steps") or not record.get("kernel_count"):
        return None          # no device trace, or nothing ran on the device
    return record["kernel_count"] / record["steps"]
