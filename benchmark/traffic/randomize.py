"""Randomized batches of a scenario family: frozen copies of the PyTorch
port's ``scenarios/batch.py`` randomizers on the benchmark's dict of
tensors. Every number comes from one ``torch.Generator`` on the data's
device, in a few batched draws."""
from __future__ import annotations

import torch

from traffic.builders import OBST_Y


def tile(data: dict, n: int) -> dict:
    """Repeat a batch-of-one scenario n times (materialized copies)."""
    return {k: v.expand((n,) + v.shape[1:]).clone() for k, v in data.items()}


def _normal(generator, shape, like):
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _tnorm(generator, shape, like, scale):
    """Truncated (+-2 sigma) normal jitter."""
    return scale * _normal(generator, shape, like).clamp(-2.0, 2.0)


def circle(generator, data, n, *, pos_jitter, heading_jitter,
           speed_jitter):
    """Initial positions / headings / speeds jittered; references and
    safety distances kept."""
    batch = tile(data, n)
    x0 = batch["x0"]
    v = x0.shape[1]
    dpos = pos_jitter * _normal(generator, (n, v, 2), x0)
    dhead = heading_jitter * _normal(generator, (n, v), x0)
    dspeed = speed_jitter * _normal(generator, (n, v), x0)
    x0[:, :, 0:2] += dpos
    x0[:, :, 2] += dhead
    x0[:, :, 3] += dspeed
    return batch


def frog(generator, data, n, *, phase_jitter, start_jitter, speed_jitter):
    """Each obstacle's initial y jittered, vehicle start-x and speed too."""
    batch = tile(data, n)
    x0, obst = batch["x0"], batch["obstacles"]
    dphase = _tnorm(generator, (n, obst.shape[1]), x0, phase_jitter)
    dx = _tnorm(generator, (n, x0.shape[1]), x0, start_jitter)
    dspeed = _tnorm(generator, (n, x0.shape[1]), x0, speed_jitter)
    obst[:, :, OBST_Y] += dphase
    x0[:, :, 0] += dx
    x0[:, :, 3] += dspeed
    return batch


def parallel(generator, data, n, *, start_jitter, lane_shift_jitter,
             obst_jitter, speed_jitter):
    """Vehicle start-x jitter, a common y shift of the lane set against the
    independently jittered static obstacles, small speed jitter."""
    batch = tile(data, n)
    x0, obst = batch["x0"], batch["obstacles"]
    v, n_obst = x0.shape[1], obst.shape[1]
    dx = _tnorm(generator, (n, v), x0, start_jitter)
    dlane = _tnorm(generator, (n,), x0, lane_shift_jitter)
    dobst = _tnorm(generator, (n, n_obst, 2), x0, obst_jitter)
    dspeed = _tnorm(generator, (n, v), x0, speed_jitter)
    x0[:, :, 0] += dx
    x0[:, :, 1] += dlane[:, None]
    x0[:, :, 3] += dspeed
    batch["ref_points"][:, :, :, 1] += dlane[:, None, None]
    obst[:, :, :2] += dobst
    return batch


RANDOMIZERS = {"circle": circle, "frog": frog, "parallel": parallel}
