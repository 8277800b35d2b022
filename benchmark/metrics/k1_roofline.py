"""K1's share of its roofline [%]: the sum of each launch's least time
(from the launch's own shape: the benchmark's frozen ``k1_work`` and
``bound_of`` at 67 TFLOP/s float32 and 3.35 TB/s) over K1's device time in
the traced window. Launch shapes are recorded by a wrapper on the port's
``ipm_kernel.ipm_iterate_struct``."""
from harness import yardstick


def read(record):
    calls = record.get("k1_calls") or []
    n_kernels = record.get("k1_kernel_count") or 0
    # one K1 kernel in the trace for each call of the wrapper, or the
    # shapes do not describe the kernels timed: nothing to read
    if (not calls or n_kernels != len(calls)
            or not record.get("k1_device_s")):
        return None
    bound_ms = sum(yardstick.bound_of(*yardstick.k1_work(
        c["P"], c["S"], c["hp"], c["hu"], c["V"], c["B"], c["n_iters"],
        c["n_cor"], c["lower_tri"]))[0] for c in calls)
    return 100.0 * bound_ms * 1e-3 / record["k1_device_s"]
