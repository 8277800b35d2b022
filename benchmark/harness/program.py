"""The system under test: the PyTorch/CUDA port (``scp_tpu_torch``). Every
name of the port that the benchmark touches is here: the step it times,
the carry it resets, the counters it reads, and the wrappers it installs
around the port's layers for a sampled or a traced step."""
from __future__ import annotations

import contextlib
import time

import torch

from scp_tpu_torch import config as port_config
from scp_tpu_torch.ops import ipm_kernel
from scp_tpu_torch.sim import engine
from scp_tpu_torch.solvers import qp as port_qp
from scp_tpu_torch.solvers import scp as port_scp

PARAMS = ("lf", "lr", "length", "width", "q", "q_final", "r")
CARRY = ("state", "u_prev2", "u_prev1", "u_warm", "state_meas")


class Program:
    """The port's closed loop on one batch: ``step`` is the timed call
    (``engine.mpc_step_batch``), ``carry0`` the set-up's initial carry
    every episode starts from."""

    def __init__(self, config: dict, tensors: dict):
        self.cfg = port_config.SCPConfig(**config["settings"])
        phases = config.get("phases")
        self.phases = None if phases is None else tuple(map(tuple, phases))
        self.data = port_config.ScenarioData(
            x0=tensors["x0"], u0=tensors["u0"],
            params=port_config.VehicleParams(
                **{k: tensors[k] for k in PARAMS}),
            ref_points=tensors["ref_points"], ref_valid=tensors["ref_valid"],
            obstacles=tensors["obstacles"], dsafe_veh=tensors["dsafe_veh"],
            dsafe_obst=tensors["dsafe_obst"])
        self.batch = tensors["x0"].shape[0]
        self.carry0 = engine.init_carry(self.cfg, self.data)

    def step(self, carry):
        return engine.mpc_step_batch(self.cfg, self.data, carry,
                                     phases=self.phases)

    @staticmethod
    def bad_rows(out) -> torch.Tensor:
        """Instances of a step whose outputs are not finite (a device count,
        not read here)."""
        ok = (torch.isfinite(out.u_pred).flatten(1).all(1)
              & torch.isfinite(out.states[:, -1]).flatten(1).all(1)
              & torch.isfinite(out.obj))
        return (~ok).sum()

    @staticmethod
    def reset_counters() -> None:
        port_scp.reset_host_sync_count()
        port_qp.reset_host_sync_count()

    @staticmethod
    def host_reads() -> int:
        """The port's counters of host reads of a device value."""
        return port_scp.host_sync_count + port_qp.host_sync_count


def _rows(t, idx):
    return None if t is None else t.index_select(0, idx).clone()


def _copy(t):
    return None if t is None else t.clone()


@contextlib.contextmanager
def _patched(module, name, wrapper):
    orig = getattr(module, name)
    setattr(module, name, wrapper(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def capture(prog: Program, carry, idx: torch.Tensor, into: dict):
    """Copy out what one step starts from and, for the instances ``idx``,
    what its layers produce: the whole batch's carry, and at ``idx`` the
    condensed QP that ``engine.controller_pre`` builds and the first QP's
    result (the QP that K1 solved; for side selection every candidate of
    each instance). The step's own outputs are copied by
    :func:`capture_out`."""
    into["rows"] = idx
    into["carry"] = {k: _copy(getattr(carry, k)) for k in CARRY}
    into["carry"]["step"] = carry.step
    b = prog.batch

    def pre(orig):
        def wrapped(cfg, data, c):
            problem, aux = orig(cfg, data, c)
            into["pre"] = {
                "phi0": _rows(problem.phi0, idx),
                "psi0": _rows(problem.psi0, idx),
                "b3": _rows(problem.sys.b3, idx),
                "const3": _rows(problem.sys.const3, idx)}
            return problem, aux
        return wrapped

    def first_qp(orig):
        def wrapped(*args, **kw):
            sol = orig(*args, **kw)
            if "qp_x" not in into:
                bsz = sol.x.shape[0]
                rows = torch.cat([idx + c * b for c in range(bsz // b)])
                into["qp_x"] = _rows(sol.x, rows)
            return sol
        return wrapped

    with _patched(engine, "controller_pre", pre), \
            _patched(port_qp, "solve_qp_batched", first_qp):
        yield


def capture_out(out) -> dict:
    """The step's outputs for the whole batch."""
    return {"u_pred": out.u_pred.clone(), "obj": out.obj.clone(),
            "state_next": out.states[:, -1].clone(),
            "scp_iters": out.scp_iters.clone()}


@contextlib.contextmanager
def ranges(record: dict):
    """Mark the port's layers in a profiled step: each call is a
    ``torch.profiler.record_function`` range (host side only, nothing
    synchronised), and every K1 launch's shape goes to
    ``record["k1_calls"]``."""
    record.setdefault("k1_calls", [])

    def rng(name):
        def wrapper(orig):
            def wrapped(*args, **kw):
                with torch.profiler.record_function(f"bench.{name}"):
                    return orig(*args, **kw)
            return wrapped
        return wrapper

    def k1(orig):
        def wrapped(gi, gj, gob, gsl, pb, *args, **kw):
            B, P, hp, hu = gi.shape
            record["k1_calls"].append(dict(
                P=P, S=0 if gob is None else gob.shape[1], hp=hp, hu=hu,
                V=pb.shape[1], B=B, n_iters=int(kw.get("n_iters", 1)),
                n_cor=int(kw.get("n_cor", 0)),
                lower_tri=bool(kw.get("lower_tri", False))))
            return orig(gi, gj, gob, gsl, pb, *args, **kw)
        return wrapped

    with _layers(rng), _patched(ipm_kernel, "ipm_iterate_struct", k1):
        yield


@contextlib.contextmanager
def spans(record: dict, sync):
    """Time the port's layers in a step: a host-clock span around each
    call, closed by a device synchronisation, summed into
    ``record["spans"]``. The synchronisations serialise host and device, so
    these steps are not the ones profiled."""
    record.setdefault("spans", {})

    def span(name):
        def wrapper(orig):
            def wrapped(*args, **kw):
                t0 = time.perf_counter()
                out = orig(*args, **kw)
                sync()
                record["spans"][name] = (record["spans"].get(name, 0.0)
                                         + time.perf_counter() - t0)
                return out
            return wrapped
        return wrapper

    with _layers(span):
        yield


@contextlib.contextmanager
def _layers(make):
    """``make(name)``'s wrapper around each of the port's layers: the
    pre-processing, the controller (SCP or side selection) and the post
    (clamps, plant)."""
    with _patched(engine, "controller_pre", make("pre")), \
            _patched(port_scp, "solve_scp_batch", make("solve")), \
            _patched(engine, "_side_selection_solve", make("solve")), \
            _patched(engine, "step_post", make("post")):
        yield
