"""Device milliseconds of K1 (kernels named ``ipm_struct*``) a step, from
the profiler trace (layer: QP kernel K1)."""


def read(record):
    if not record.get("steps") or not record.get("k1_kernel_count"):
        return None
    return record["k1_device_s"] * 1e3 / record["steps"]
