"""Debugging aids: NaN detection, cross-run determinism checks and the
per-iteration SCP trace (counterpart of ``scp_tpu/utils/debug.py``).

* :func:`enable_nan_debugging` — raise at the first torch op whose floating
  output holds a NaN, naming the op (``jax_debug_nans``' counterpart; it
  reads every output back, so use it on small CPU repros);
* :func:`check_finite` — assertion helper for trees of outputs;
* :func:`determinism_check` — runs a function again on the same inputs and
  reports the worst deviation, the batched-compute analogue of a race
  detector;
* :func:`scp_iteration_trace` — the SCP loop of one scenario, iteration by
  iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class NaNCheckMode(TorchDispatchMode):
    """Dispatch mode that raises ``FloatingPointError`` at the first op
    whose floating-point output holds a NaN, naming the op.

    The port's hand-written CUDA kernels are launched through ``ctypes``
    (``ops/_cuda_build.py``), not as torch ops, so the mode does not see
    them: a NaN a kernel writes is caught at the next torch op that reads
    it, and the error then names that op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.numel() and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN in the output of {func} (shape {tuple(t.shape)})")
        return out


_NAN_MODE: NaNCheckMode | None = None


def enable_nan_debugging(enable: bool = True) -> None:
    """Switch :class:`NaNCheckMode` on (or off) for the calling thread, for
    every op from here on (``with NaNCheckMode(): ...`` scopes it to a
    block instead). Every op's output is read back to the host, which
    serializes the device."""
    global _NAN_MODE
    if enable and _NAN_MODE is None:
        _NAN_MODE = NaNCheckMode()
        _NAN_MODE.__enter__()
    elif not enable and _NAN_MODE is not None:
        mode, _NAN_MODE = _NAN_MODE, None
        mode.__exit__(None, None, None)


def leaves_with_path(tree: Any, path: str = ""):
    """(path, leaf) of every array-like leaf of a tree of NamedTuples,
    dataclasses, dicts, tuples and lists; the path is written as
    ``jax.tree_util.keystr`` writes it (``.field``, ``['key']``, ``[i]``)."""
    if isinstance(tree, torch.Tensor) or isinstance(tree, np.ndarray):
        yield path, tree
    elif hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from leaves_with_path(getattr(tree, name),
                                         f"{path}.{name}")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves_with_path(getattr(tree, f.name),
                                         f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{path}[{i}]")
    elif isinstance(tree, float):
        yield path, np.asarray(tree)


def check_finite(tree: Any, name: str = "output") -> None:
    """Raise with the offending leaf's path if any array holds NaN / Inf."""
    for path, leaf in leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            bad = int((~torch.isfinite(leaf)).sum())
        else:
            if leaf.dtype.kind != "f":
                continue
            bad = int(np.sum(~np.isfinite(leaf)))
        if bad:
            raise FloatingPointError(
                f"{name}{path}: {bad} non-finite values "
                f"(shape {tuple(leaf.shape)})")


def determinism_check(fn: Callable, *args, runs: int = 2) -> float:
    """Max abs deviation of ``fn(*args)``'s floating outputs across
    repeated executions (a NaN in one run and not the other counts as
    ``inf``; NaNs in the same place in both as no deviation).

    The kernels are deterministic per launch geometry; a nonzero deviation
    points at an op that adds in no fixed order (atomics), at host-side
    randomness, or at a generator consumed by ``fn`` (restore its state
    between the runs)."""
    def floats(out):
        return [t for _, t in leaves_with_path(out)
                if (t.is_floating_point() if isinstance(t, torch.Tensor)
                    else t.dtype.kind == "f")]

    ref = floats(fn(*args))
    worst = 0.0
    for _ in range(runs - 1):
        for a, b in zip(ref, floats(fn(*args))):
            a = torch.as_tensor(a).double()
            b = torch.as_tensor(b).to(a.device).double()
            if not a.numel():
                continue
            d = (a - b).abs()
            nan_a, nan_b = torch.isnan(a), torch.isnan(b)
            d = torch.where(nan_a & nan_b, torch.zeros_like(d), d)
            d = torch.where(nan_a ^ nan_b, torch.full_like(d, np.inf), d)
            worst = max(worst, float(d.max()))
    return worst


def scp_iteration_trace(cfg, data, carry=None) -> dict:
    """Per-SCP-iteration optimization trace for ONE scenario instance.

    Runs the controller preprocessing for the scenario (a batch of one,
    ``data`` as the builders return it) and solves the SCP with
    ``trace=True``, returning host numpy arrays truncated to the iterations
    that actually ran:

    ``{"obj", "max_violation", "merit", "delta", "qp_converged", "iters",
    "u", "feasible"}`` (``u`` of shape (V*hu,)).

    ``carry``: a :class:`scp_tpu_torch.sim.engine.SimCarry` mid-run state of
    that scenario (e.g. sliced out of a batched run at the misbehaving
    step); defaults to the initial state.
    """
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.solvers import scp as scp_lib

    if cfg.controller != "scp":
        raise ValueError("the trace records the SCP loop (controller 'scp')")
    if data.x0.shape[0] != 1:
        raise ValueError("the trace is of ONE scenario instance (B = 1)")
    if carry is None:
        carry = engine.init_carry(cfg, data)
    problem, _ = engine.controller_pre(cfg, data, carry)
    res, tr = scp_lib.solve_scp(problem, carry.u_warm,
                                max_scp_iter=cfg.max_scp_iter,
                                trace=True, **engine._scp_kwargs(cfg))
    n_it = int(tr.active[0].sum())
    out = {k: v[0, :n_it].cpu().numpy() for k, v in tr._asdict().items()
           if k != "active"}
    out.update(iters=n_it, u=res.u[0].cpu().numpy(),
               feasible=bool(res.feasible[0]))
    return out
