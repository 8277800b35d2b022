"""The traced run's record: a ``torch.profiler`` session over a few steps
of the window, reduced to what the per-layer metric readers
(``metrics/<name>.py``) read. Device activity comes from the trace; the
spans are the benchmark's own ``record_function`` ranges around the port's
layers (``program.spans``)."""
from __future__ import annotations

from torch.autograd import DeviceType

from harness import yardstick

WINDOW = "bench.window"
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def _range(e):
    return e.time_range.start, e.time_range.end


def reduce(prof, record: dict) -> dict:
    """Fill ``record`` from the profiler's events: device activity
    (``device`` intervals, ``kernels`` by name), the traced window's
    bounds, ``busy_s`` / ``window_s`` and the idle gaps labelled with the
    span open on the host at their middle."""
    device, spans, window = [], [], None
    for e in prof.events():
        if e.name.startswith("bench.") and e.device_type == DeviceType.CUDA:
            continue        # a range's copy on the device's timeline
        if e.device_type == DeviceType.CUDA:
            s, t = _range(e)
            if t > s:
                device.append((s, t, e.name))
        elif e.name == WINDOW:
            window = _range(e)
        elif e.name.startswith("bench."):
            spans.append(_range(e) + (e.name[len("bench."):],))
    if window is None:
        raise RuntimeError("the profiler trace holds no window range")
    lo, hi = window
    device = [(max(s, lo), min(t, hi), n) for s, t, n in device
              if t > lo and s < hi]
    intervals = [(s, t) for s, t, _ in device]
    record["window_s"] = (hi - lo) * 1e-6
    record["busy_s"] = yardstick.union_seconds(intervals) * 1e-6
    kernels = [(s, t, n) for s, t, n in device
               if not n.startswith(NOT_KERNELS)]
    record["kernel_count"] = len(kernels)
    by_name = {}
    for s, t, n in device:
        by_name[n] = by_name.get(n, 0.0) + (t - s) * 1e-6
    record["device_ops"] = sorted(by_name.items(), key=lambda kv: -kv[1])
    record["k1_device_s"] = sum((t - s) * 1e-6 for s, t, n in kernels
                                if "ipm_struct" in n)
    record["k1_kernel_count"] = sum(1 for _, _, n in kernels
                                    if "ipm_struct" in n)

    def label(mid):
        inner = None
        for s, t, name in spans:
            if s <= mid <= t and (inner is None or s >= inner[0]):
                inner = (s, name)
        return inner[1] if inner else "outside the spans"

    gaps = yardstick.gaps(intervals, lo, hi)
    gaps.sort(key=lambda g: g[0] - g[1])
    record["idle_gaps"] = [(label(0.5 * (s + t)), (t - s) * 1e-6)
                           for s, t in gaps[:10]]
    return record


def breakdown(record: dict) -> dict:
    return {"device_ops": [[n[:120], s] for n, s in
                           record["device_ops"][:10]],
            "idle_gaps": [[n, s] for n, s in record["idle_gaps"][:10]]}
