"""Scenario-batch generation: thousands of randomized instances as one
``ScenarioData`` (counterpart of ``scp_tpu/scenarios/batch.py``).

Randomization perturbs initial conditions within a scenario family. Where
``scp_tpu`` takes a PRNG key, these functions take a ``torch.Generator`` on
the data's device; the two give different numbers from the same seed.
"""
from __future__ import annotations

import torch

from scp_tpu_torch import require_device
from scp_tpu_torch.config import SCPConfig, ScenarioData, tree_map
from scp_tpu_torch.scenarios import builders


def stack_scenarios(datas: list[ScenarioData]) -> ScenarioData:
    """Concatenate same-shape ScenarioData instances along the batch axis."""
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *datas)


def tile_scenario(data: ScenarioData, n: int) -> ScenarioData:
    """Repeat a batch-of-one scenario n times (materialized copy)."""
    return tree_map(
        lambda x: x.expand((n,) + x.shape[1:]).clone(), data)


def _normal(generator, shape, dtype, device):
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def _tnorm(generator, shape, dtype, device, scale):
    """Truncated (±2σ) normal jitter — unbounded tails would let rare
    instances consume a scenario's entire initial-feasibility margin."""
    return scale * _normal(generator, shape, dtype, device).clamp(-2.0, 2.0)


def randomize_circle(generator: torch.Generator, cfg: SCPConfig,
                     data: ScenarioData, n: int, *, pos_jitter: float = 0.5,
                     heading_jitter: float = 0.05,
                     speed_jitter: float = 0.2) -> ScenarioData:
    """Batch of n perturbed copies of a circle scenario.

    Initial positions/headings/speeds are jittered; reference lines and
    safety distances are kept (dsafe uses nominal speeds).
    """
    batch = tile_scenario(data, n)
    v = cfg.n_veh
    dtype, device = data.x0.dtype, data.x0.device
    dpos = pos_jitter * _normal(generator, (n, v, 2), dtype, device)
    dhead = heading_jitter * _normal(generator, (n, v), dtype, device)
    dspeed = speed_jitter * _normal(generator, (n, v), dtype, device)
    batch.x0[:, :, 0:2] += dpos
    batch.x0[:, :, 2] += dhead
    batch.x0[:, :, 3] += dspeed
    return batch


def randomize_frog(generator: torch.Generator, cfg: SCPConfig,
                   data: ScenarioData, n: int, *, phase_jitter: float = 2.0,
                   start_jitter: float = 0.5,
                   speed_jitter: float = 0.2) -> ScenarioData:
    """Batch of n perturbed frog-crossing instances: each obstacle's initial
    y is jittered (a phase shift along its motion), plus vehicle start-x and
    speed jitter. Safety distances stay nominal."""
    batch = tile_scenario(data, n)
    dtype, device = data.x0.dtype, data.x0.device
    n_obst = data.obstacles.shape[1]
    dphase = _tnorm(generator, (n, n_obst), dtype, device, phase_jitter)
    dx = _tnorm(generator, (n, cfg.n_veh), dtype, device, start_jitter)
    dspeed = _tnorm(generator, (n, cfg.n_veh), dtype, device, speed_jitter)
    batch.obstacles[:, :, builders.OBST_Y] += dphase
    batch.x0[:, :, 0] += dx
    batch.x0[:, :, 3] += dspeed
    return batch


def randomize_parallel(generator: torch.Generator, cfg: SCPConfig,
                       data: ScenarioData, n: int, *,
                       start_jitter: float = 0.6,
                       lane_shift_jitter: float = 0.2,
                       obst_jitter: float = 0.2,
                       speed_jitter: float = 0.04) -> ScenarioData:
    """Batch of n perturbed parallel-lane instances: vehicle start-x jitter,
    a COMMON y shift of the whole lane set relative to the (independently
    jittered) static obstacles, and small speed jitter. Lane spacing itself
    is untouched (it sits just outside dsafe + extra)."""
    batch = tile_scenario(data, n)
    dtype, device = data.x0.dtype, data.x0.device
    v, n_obst = cfg.n_veh, data.obstacles.shape[1]
    dx = _tnorm(generator, (n, v), dtype, device, start_jitter)
    dlane = _tnorm(generator, (n,), dtype, device, lane_shift_jitter)
    dobst = _tnorm(generator, (n, n_obst, 2), dtype, device, obst_jitter)
    dspeed = _tnorm(generator, (n, v), dtype, device, speed_jitter)
    batch.x0[:, :, 0] += dx
    batch.x0[:, :, 1] += dlane[:, None]
    batch.x0[:, :, 3] += dspeed
    batch.ref_points[:, :, :, 1] += dlane[:, None, None]
    batch.obstacles[:, :, :2] += dobst
    return batch


RANDOMIZERS = {
    "circle": randomize_circle,
    "frog": randomize_frog,
    "parallel": randomize_parallel,
}


def make_batch(kind: str, n: int, generator: torch.Generator | None = None,
               dtype=torch.float32, device="cuda",
               **kw) -> tuple[SCPConfig, ScenarioData]:
    """Build a randomized batch of a named scenario family on ``device``.

    ``generator`` must live on ``device``; None seeds a fresh one with 0.
    """
    device = require_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cfg, data = builders.BUILDERS[kind](dtype=dtype, device=device, **kw)
    batch = RANDOMIZERS[kind](generator, cfg, data, n)
    return cfg, batch
