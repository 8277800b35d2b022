"""Result persistence: a structured array store and the reference-format
JSON export (counterpart of ``scp_tpu/utils/results.py``).

The original controller dumps 11 arrays as JSON, keyed
``Data/<scenario>_num_<n>_control_<name>[...].json``. Here results are kept
as compressed ``.npz`` (fast, typed), with an optional export in the
original schema so its ``draw_video.py`` tooling can read the port's runs.

Every tensor reaches numpy through ``.detach().cpu().numpy()`` (a CUDA
tensor cannot go through ``np.asarray``); numpy arrays pass as they are.
The port's containers carry a batch axis: a closed loop's stacked
``StepOutput`` is ``(n_steps, B, ...)`` and ``ScenarioData`` is
``(B, ...)``, one scenario being B = 1.
"""
from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch

_FIELDS = ("states", "u_applied", "u_pred", "traj_pred", "ref_points",
           "x0_pred", "feasible", "converged", "obj", "max_violation",
           "scp_iters", "qp_iters", "pred_obj", "pred_feasible",
           "delay_traj", "clamp_mag_events", "clamp_rate_events",
           "feas_disagree", "sides_stable")


def to_numpy(x) -> np.ndarray:
    """numpy copy of a tensor (on any device) or of an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def result_path(base_dir: str, scenario: str, n_veh: int, controller: str,
                noise: bool = False, ext: str = "npz") -> str:
    suffix = "_with_noise" if noise else ""
    name = f"{scenario}_num_{n_veh}_control_{controller}{suffix}.{ext}"
    return os.path.join(base_dir, name)


def save_npz(path: str, arrays: Mapping[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **{k: to_numpy(v) for k, v in arrays.items()})


def load_npz(path: str) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def sim_outputs_to_arrays(cfg, out, instance: int | None = None) -> dict:
    """Flatten a stacked StepOutput into a plain numpy array dict.

    ``instance``: keep only that instance of the batch axis behind the step
    axis, which gives one run's layout: ``states (Nsim, tps, V, NX)``,
    ``u_applied (Nsim, V)``, ``u_pred (Nsim, HP, V)``, ``traj_pred (Nsim,
    HP, NY, V)``, ``ref_points (Nsim, V, HP, 2)``, ``delay_traj (Nsim, 10,
    NX, V)``. Without it every array keeps the shape it has."""
    def arr(name):
        a = to_numpy(getattr(out, name))
        return a if instance is None else a[:, instance]
    return {name: arr(name) for name in _FIELDS}


def obstacle_path_full_res(cfg, data, instance: int = 0) -> np.ndarray:
    """Constant-velocity obstacle paths at tick resolution, of the scenario
    ``instance`` of ``data``'s batch axis.

    Returns (nObst, 6, ticks_total + 1), the original ``obstaclePathFullRes``
    (x, y advanced; heading / speed / dimensions constant).
    """
    obst = to_numpy(data.obstacles[instance]).astype(float)   # (O, 6)
    ticks = cfg.ticks_total
    path = np.repeat(obst[:, :, None], ticks + 1, axis=2)
    t = np.arange(ticks + 1) * cfg.tick_length
    vel = obst[:, 3:4] * np.stack([np.cos(obst[:, 2:3]), np.sin(obst[:, 2:3])],
                                  axis=0)           # (2, O, 1)
    path[:, 0, :] += t[None, :] * vel[0]
    path[:, 1, :] += t[None, :] * vel[1]
    return path


def export_reference_json(path: str, cfg, data, out,
                          step_times=None, controller_runtimes=None,
                          instance: int | None = None) -> None:
    """Export one run in the original result schema: all 11 keys of its
    JSON dump, so its ``draw_video.py`` can read the port's runs.

    ``out``: a stacked StepOutput ``(Nsim, B, ...)`` (tensors or numpy).
    ``instance``: the instance of a BATCHED run (``engine.simulate_batch``,
    the CLI's ``--mc``) to export, since the format holds one run; ``None``
    exports a one-scenario run (B = 1). ``data``: the scenario, either the
    batch of one the run was tiled from or the whole batch.

    The full-resolution vehicle / obstacle paths are rebuilt from the
    per-step tick states and constant-velocity extrapolation; the per-step
    delay-compensation trajectories come from ``StepOutput.delay_traj``.

    ``step_times`` / ``controller_runtimes``: measured per-step host wall
    times [s] (the original ``stepTime`` / ``controllerRuntime``), which
    host-driven runs give (``engine.simulate_timed``,
    ``viz.plot.run_live(step_times=...)``). Other runs have no per-step
    time: the keys are filled with zeros then (the schema stays complete;
    zero means "not measured", not "took 0 s").
    """
    if instance is None and to_numpy(out.u_applied).shape[1] != 1:
        raise ValueError(
            "the reference format holds one run: pass instance= to export "
            "one instance of a batched run")
    arrays = sim_outputs_to_arrays(cfg, out, instance=instance or 0)
    # the scenario of the run: the batch of one it was tiled from, or the
    # exported instance of a whole batch
    inst = 0 if data.x0.shape[0] == 1 else (instance or 0)
    n_sim, tps, n_veh, nx = arrays["states"].shape
    # (NX, V, ticks+1) like vehiclePathFullRes
    ticks = n_sim * tps
    veh_path = np.zeros((nx, n_veh, ticks + 1))
    veh_path[:, :, 0] = to_numpy(data.x0[inst]).T
    veh_path[:, :, 1:] = arrays["states"].reshape(
        ticks, n_veh, nx).transpose(2, 1, 0)
    ctrl_path = np.zeros((n_veh, ticks + 1))
    ctrl_path[:, 1:] = np.repeat(arrays["u_applied"], tps, axis=0).T

    payload = {
        "vehiclePathFullRes": veh_path.tolist(),
        "obstaclePathFullRes":
            obstacle_path_full_res(cfg, data, inst).tolist(),
        "controlPathFullRes": ctrl_path.tolist(),
        "controlPredictions": arrays["u_pred"].transpose(1, 2, 0).tolist(),
        "trajectoryPredictions":
            arrays["traj_pred"].transpose(1, 2, 3, 0).tolist(),
        "initial_pos":
            arrays["x0_pred"][:, :, :2].transpose(2, 1, 0).tolist(),
        "ReferenceTrajectory":
            arrays["ref_points"].transpose(2, 3, 1, 0).tolist(),
        "MPC_delay_compensation_trajectory":
            arrays["delay_traj"].transpose(1, 2, 3, 0).tolist(),
        "evaluations_obj_value": arrays["pred_obj"].tolist(),
        "stepTime": (list(map(float, step_times)) if step_times is not None
                     else [0.0] * n_sim),
        "controllerRuntime": (list(map(float, controller_runtimes))
                              if controller_runtimes is not None
                              else [0.0] * n_sim),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f)
