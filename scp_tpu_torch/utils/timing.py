"""Timing and profiling helpers (counterpart of ``scp_tpu/utils/timing.py``).

The original controller times itself with ad-hoc wall clocks
(``controllerRuntime``, ``optimizerTime``, ``stepTime``) dumped to JSON.
Here: an accumulating timer, a call timer whose window is closed by
``torch.cuda.synchronize`` where the results live on the card (CUDA work is
asynchronous: without it the window closes at the enqueue), a
``torch.profiler`` trace context, and a throughput counter.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

from scp_tpu_torch.utils.debug import leaves_with_path


@dataclass
class Timer:
    """Accumulating wall-clock timer (the caller synchronizes the device
    inside the block when it times device work)."""
    name: str = ""
    total: float = 0.0
    count: int = 0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


def timed_blocked(fn, *args, **kw):
    """Run ``fn``, wait until the device results are ready, and return
    ``(result, seconds)``: every CUDA device holding an output tensor is
    synchronized before the clock stops."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    for dev in {t.device for _, t in leaves_with_path(out)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` trace of the block: CPU activities, and CUDA ones
    where a GPU is present. The Chrome trace is written to
    ``log_dir/trace.json`` (open with Perfetto or ``chrome://tracing``);
    the profiler is yielded, so ``key_averages()`` can be read after the
    block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def throughput(n_items: int, seconds: float) -> float:
    return n_items / max(seconds, 1e-12)
