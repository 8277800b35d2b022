"""State carried between the two packages: the scenario, the carry, QP
operands and results.

There are no weights. ``from_numpy`` functions turn numpy copies of
``scp_tpu``'s containers — given as dicts / tuples of numpy arrays, field by
field — into this package's containers on a device and dtype; ``to_numpy``
goes the other way for results (a ``QPSolution``, ``SCPResult``,
``SCPTrace``, ``RiccatiFactor`` or ``StepOutput`` becomes a dict of arrays).
The module takes numpy arrays and dicts only; callers do the
``np.asarray(jax_array)`` step themselves.

Batch axis: this package's containers always carry a leading batch axis.
``batched=False`` marks unbatched (single-instance) numpy input, which gets
a batch axis of size 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from scp_tpu_torch.config import SCPConfig, ScenarioData, VehicleParams
from scp_tpu_torch.ops.constraints import ConstraintSystem
from scp_tpu_torch.sim.engine import SimCarry
from scp_tpu_torch.solvers.qp import BandedData
from scp_tpu_torch.solvers.scp import SCPProblem

_INT_FIELDS = {"pair_i", "pair_j"}
_BOOL_FIELDS = {"ref_valid"}


def _tensor(name, a, dtype, device, batched):
    a = np.array(a)    # a writable copy: torch refuses read-only buffers
    if name in _INT_FIELDS:
        t = torch.as_tensor(a.astype(np.int64), device=device)
    elif name in _BOOL_FIELDS:
        t = torch.as_tensor(a.astype(bool), device=device)
    else:
        t = torch.as_tensor(a, device=device).to(dtype)
    return t if batched else t[None]


def _fields(obj) -> dict:
    """Field dict of a dataclass instance, NamedTuple or dict."""
    if isinstance(obj, dict):
        return obj
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    return obj._asdict()


def config_from_dict(fields: dict) -> SCPConfig:
    """``SCPConfig`` from a dict of ``scp_tpu.config.SCPConfig``'s fields
    (``dataclasses.asdict`` of it); unknown keys raise."""
    return SCPConfig(**fields)


def scenario_from_numpy(data, dtype=torch.float64, device="cuda",
                        batched: bool = True) -> ScenarioData:
    """``ScenarioData`` from a numpy field dict (``params`` nested)."""
    f = _fields(data)
    params = VehicleParams(**{
        k: _tensor(k, v, dtype, device, batched)
        for k, v in _fields(f["params"]).items()})
    rest = {k: _tensor(k, v, dtype, device, batched)
            for k, v in f.items() if k != "params"}
    return ScenarioData(params=params, **rest)


def carry_from_numpy(carry, dtype=torch.float64, device="cuda",
                     batched: bool = True,
                     generator: torch.Generator | None = None) -> SimCarry:
    """``SimCarry`` from a numpy field dict of ``scp_tpu``'s carry. The PRNG
    key is not carried (pass a ``generator`` for plant noise); ``step`` must
    be the same for every instance and becomes a host integer."""
    f = _fields(carry)
    step = np.unique(np.asarray(f["step"]))
    if step.size != 1:
        raise ValueError("instances of one batch must share the step index")

    def opt(name):
        v = f.get(name)
        return None if v is None else _tensor(name, v, dtype, device, batched)

    return SimCarry(
        state=opt("state"), u_prev2=opt("u_prev2"), u_prev1=opt("u_prev1"),
        u_warm=opt("u_warm"), step=int(step[0]), generator=generator,
        state_meas=opt("state_meas"), state_hist=opt("state_hist"))


def system_from_numpy(sys_, dtype=torch.float64, device="cuda",
                      batched: bool = True) -> ConstraintSystem:
    """``ConstraintSystem`` from a numpy field dict / tuple."""
    return ConstraintSystem(**{
        k: _tensor(k, v, dtype, device, batched)
        for k, v in _fields(sys_).items()})


def problem_from_numpy(problem, dtype=torch.float64, device="cuda",
                       batched: bool = True) -> SCPProblem:
    """``SCPProblem`` from a numpy field dict / tuple, with its
    ``banded_pre`` stage statement (a 4-tuple of arrays) when it has one."""
    f = _fields(problem)
    pre = f.get("banded_pre")
    return SCPProblem(
        sys=system_from_numpy(f["sys"], dtype, device, batched),
        phi0=_tensor("phi0", f["phi0"], dtype, device, batched),
        psi0=_tensor("psi0", f["psi0"], dtype, device, batched),
        gamma0=_tensor("gamma0", f["gamma0"], dtype, device, batched),
        banded_pre=None if pre is None else tuple(
            _tensor("banded_pre", a, dtype, device, batched) for a in pre))


def banded_from_numpy(banded, dtype=torch.float64, device="cuda",
                      batched: bool = True) -> BandedData:
    """``solvers.qp.BandedData`` from a numpy field dict / tuple of
    ``scp_tpu.solvers.qp.BandedData``'s fields."""
    if not isinstance(banded, dict) and not hasattr(banded, "_fields"):
        banded = dict(zip(BandedData._fields, banded))
    return BandedData(**{k: _tensor(k, v, dtype, device, batched)
                         for k, v in _fields(banded).items()})


def qp_from_numpy(operands: dict, dtype=torch.float64, device="cuda",
                  batched: bool = True) -> dict:
    """Dense QP operands (``P, q, G, h, lb, ub`` and optionally ``x0, z0``;
    ``None`` entries stay ``None``) as tensors, ready for
    ``solvers.qp.solve_qp(**...)``."""
    return {k: None if v is None else _tensor(k, v, dtype, device, batched)
            for k, v in operands.items()}


def to_numpy(obj):
    """Numpy copy of a tensor or of a (nested) container of tensors:
    dataclasses and NamedTuples become dicts, tuples stay tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: to_numpy(v) for k, v in _fields(obj).items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: to_numpy(v) for k, v in obj._asdict().items()}
    if isinstance(obj, (tuple, list)):
        return tuple(to_numpy(v) for v in obj)
    if isinstance(obj, torch.Generator):
        return None
    return obj
