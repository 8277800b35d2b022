"""Tracing and profiling (counterpart of ``scp_tpu/utils/timing.py``).

The original controller times itself with ad-hoc wall clocks
(``controllerRuntime``, ``optimizerTime``, ``stepTime``: here
``engine.simulate_timed``). This module holds the port's one tracer and
its one exporter.

**Spans.** ``span(name, **attrs)`` marks a layer of the MPC step. It is on
exactly while a ``torch.profiler`` session records in the process; no
variable, option or flag turns it on. Off, it returns one shared no-op
context (under a microsecond). On, it

* opens a profiler range ``"scp." + name`` on the profiler's own timeline,
  the clock of the device trace, so that a gap in the device's work can be
  put down to what the host was doing. The range is a plain CPU range
  (``_RecordFunctionFast``): unlike ``torch.profiler.record_function`` it
  casts no copy of itself onto the device's timeline, so a span adds no
  interval to the device's activity in the trace;
* appends a record to an in-memory list: ``name``, ``step`` (the id of
  the enclosing ``step`` span; each ``step`` span starts a new one, None
  outside a step), ``parent`` (the index of the enclosing span's record,
  or None), ``start_ns`` / ``end_ns`` (``time.perf_counter_ns``) and
  ``attrs``.

An attr is an int, a float, a string or a 0-d device tensor; a tensor is
read only when the records are read (:func:`recorded`), so a span never
synchronises. ``with span(...) as sp``: ``sp.on`` says whether the span
records, ``sp.set(**attrs)`` adds attrs (a no-op when off), so work that
only feeds an attr runs only while tracing. The tracer keeps one stack of
open spans for the process: spans are opened and closed by the thread
that runs the step. :func:`spanned` makes each call of a function a span.

:func:`recorded` returns the records with their attrs resolved and keeps
them, so several readers can read them; :func:`clear` empties them. The
records of every profiler session in the process pile up (device-tensor
attrs kept alive) until :func:`clear`: a caller that opens its own
``torch.profiler`` session clears first, so that it reads only its own.
:func:`profile_trace` does so: it wraps a block in a ``torch.profiler``
session, starting from no record, and writes its Chrome trace, which then
holds the program's spans beside the card's kernels.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

PREFIX = "scp."


class _Off:
    """The span while no profiler records: does nothing."""
    __slots__ = ()
    on = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Tracer:
    """The records, the stack of open spans and the step ids."""

    def __init__(self):
        self.records: list[dict] = []
        self.open: list[int] = []      # indices of the open spans' records
        self.last_step = -1
        self.step: int | None = None   # the open ``step`` span's id


_TRACER = _Tracer()


class _Span:
    __slots__ = ("_name", "_attrs", "_tracer", "_rec", "_index", "_range")
    on = True

    def __init__(self, name: str, attrs: dict):
        self._name, self._attrs = name, attrs

    def __enter__(self):
        tr = self._tracer = _TRACER
        if self._name == "step":
            tr.last_step += 1
            tr.step = tr.last_step
        self._index = len(tr.records)
        self._rec = {"name": self._name, "step": tr.step,
                     "parent": tr.open[-1] if tr.open else None,
                     "start_ns": time.perf_counter_ns(), "end_ns": None,
                     "attrs": self._attrs}
        tr.records.append(self._rec)
        tr.open.append(self._index)
        self._range = _RecordFunctionFast(PREFIX + self._name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self._rec["end_ns"] = time.perf_counter_ns()
        tr = self._tracer
        if tr.open and tr.open[-1] == self._index:
            tr.open.pop()
        if self._name == "step":
            tr.step = None
        return False

    def set(self, **attrs) -> None:
        self._attrs.update(attrs)


def span(name: str, **attrs):
    """A span of the layer ``name`` (a context manager): recorded while a
    ``torch.profiler`` session records, a shared no-op otherwise."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, attrs)


def spanned(name: str, attrs=None):
    """Decorator: each call of the function is a span ``name``;
    ``attrs(*args, **kwargs)`` gives its attrs, and is called only while
    tracing."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not _profiler_enabled():
                return fn(*args, **kw)
            with _Span(name, {} if attrs is None else attrs(*args, **kw)):
                return fn(*args, **kw)
        return call
    return wrap


def recorded() -> list[dict]:
    """The span records so far, each device-tensor attr read into a
    Python number (in place: a later call reads nothing again)."""
    for rec in _TRACER.records:
        attrs = rec["attrs"]
        for key, value in attrs.items():
            if isinstance(value, torch.Tensor):
                attrs[key] = value.item()
    return list(_TRACER.records)


def clear() -> None:
    """Drop every record and start the step ids again (a span open across
    the call records into nothing)."""
    global _TRACER
    _TRACER = _Tracer()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` trace of the block: CPU activities, and CUDA ones
    where a GPU is present. The Chrome trace, the program's spans
    (``scp.*`` ranges) included, is written to ``log_dir/trace.json``
    (open with Perfetto or ``chrome://tracing``); the profiler is yielded,
    so ``key_averages()`` can be read after the block. The span records
    are cleared on entry: :func:`recorded` after the block gives this
    block's alone."""
    clear()
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
