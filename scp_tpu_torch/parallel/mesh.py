"""The (data, model) rank layout and its collectives (counterpart of
``scp_tpu/parallel/mesh.py``).

``scp_tpu`` lays its devices out as a ``jax.sharding.Mesh`` inside one
process and reduces with ``psum`` / ``pmin`` / ``pmax`` inside
``shard_map``. Here one rank is one process of a ``torch.distributed`` job:
:class:`Mesh` stands in for the device mesh (rank = ``d * n_model + m``,
the row-major layout of ``scp_tpu``'s ``devices.reshape(n_data, n_model)``),
and a reduction over an axis is an ``all_reduce`` over that axis's process
group (:func:`all_reduce`, :func:`all_true`).

With no process group initialised the mesh is (1, 1), its groups are
``None`` and every collective is the identity: :func:`all_reduce` is the one
place that says so.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) layout of the job's ranks.

    ``shape = {"data": n_data, "model": n_model}``; ``data_index`` /
    ``model_index`` are this rank's coordinates; ``groups["data"]`` holds
    the ranks that share this rank's model index (the scenario axis),
    ``groups["model"]`` those that share its data index (the horizon axis).
    Without a process group both are ``None``."""
    shape: dict
    data_index: int = 0
    model_index: int = 0
    groups: dict = dataclasses.field(
        default_factory=lambda: {"data": None, "model": None})


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced (``"sum"``, ``"min"``, ``"max"``) over the ranks of
    ``group``, as a new tensor on ``t``'s device. ``group=None`` means no
    process group (a (1, 1) mesh): the identity, ``t`` itself."""
    if group is None:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    return out


def all_true(flag: torch.Tensor, group) -> torch.Tensor:
    """Element-wise AND of a bool tensor over ``group`` (the ``psum`` of
    ``where(flag, 0, 1) == 0`` of ``scp_tpu``)."""
    if group is None:
        return flag
    return all_reduce(flag.to(torch.int32), group, "min") > 0


def axis_index(group) -> int:
    """This rank's index along the axis ``group`` spans (0 without one)."""
    return 0 if group is None else dist.get_rank(group=group)


def world_group():
    """The group of every rank, or ``None`` without a process group."""
    return dist.group.WORLD if dist.is_initialized() else None


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """This rank's (data, model) mesh over every rank of the job. Defaults
    to all ranks on the data axis.

    Every rank creates every group, in the same order (``new_group`` is a
    collective of the whole job). ``n_data * n_model`` must be the world
    size: ranks outside the mesh have no counterpart here."""
    if not dist.is_initialized():
        world, rank = 1, 0
    else:
        world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None:
        n_data = world // n_model
    if n_data < 1:
        raise ValueError(
            f"n_model={n_model} needs at least that many devices (ranks); "
            f"have {world}")
    if n_data * n_model != world:
        raise ValueError(
            f"a ({n_data}, {n_model}) mesh needs {n_data * n_model} ranks; "
            f"the job has {world}")
    shape = {"data": n_data, "model": n_model}
    if not dist.is_initialized():
        return Mesh(shape)
    d, m = divmod(rank, n_model)
    groups = {}
    for dd in range(n_data):            # one model group per data index
        g = dist.new_group([dd * n_model + mm for mm in range(n_model)])
        if dd == d:
            groups["model"] = g
    for mm in range(n_model):           # one data group per model index
        g = dist.new_group([dd * n_model + mm for dd in range(n_data)])
        if mm == m:
            groups["data"] = g
    return Mesh(shape, d, m, groups)


def _block(x, lo: int, hi: int):
    if isinstance(x, torch.Tensor):
        return x[lo:hi].clone()
    if isinstance(x, dict):
        return {k: _block(v, lo, hi) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: _block(getattr(x, f.name), lo, hi)
                          for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        items = [_block(v, lo, hi) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    for v in (x if isinstance(x, (tuple, list)) else ()):
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def shard_batch(tree, mesh: Mesh):
    """This rank's block of the leading (scenario) axis of every tensor of
    ``tree`` (dataclasses, NamedTuples, tuples, dicts): block ``d`` of
    ``n_data`` equal blocks for data index ``d``. Every rank passes the
    same full batch, as ``scp_tpu``'s multi-process ingestion does."""
    n_data = int(mesh.shape["data"])
    n = _first_tensor(tree).shape[0]
    if n % n_data != 0:
        raise ValueError(
            f"batch size {n} is not divisible by the mesh's data axis "
            f"({n_data} shards); pad the batch or resize the mesh "
            f"(e.g. make_mesh(n_data=...))")
    b = n // n_data
    return _block(tree, mesh.data_index * b, (mesh.data_index + 1) * b)


def sharded_batch_run(fn: Callable, mesh: Mesh, *, reduce_metrics=True):
    """Wrap ``fn(batch) -> (outputs, metrics)`` — per-instance outputs and
    metrics on a leading batch axis — into a runner of this rank's block
    (``shard_batch``'s): with ``reduce_metrics`` every metric is summed over
    the block and then over the data axis, one ``all_reduce`` each
    (``metrics`` a tensor or a tuple of them)."""
    def reduce(m):
        return all_reduce(m.sum(dim=0), mesh.groups["data"])

    def run(block):
        out, metrics = fn(block)
        if reduce_metrics:
            metrics = (reduce(metrics) if isinstance(metrics, torch.Tensor)
                       else tuple(map(reduce, metrics)))
        return out, metrics
    return run
