"""Checkpoint / resume for long closed-loop runs (counterpart of
``scp_tpu/utils/checkpoint.py``).

The original controller has no mid-run checkpoint: only the final JSON dump
and the warm start carried between steps. For long batched runs the carry
(``sim.engine.SimCarry``: plant states, command history, warm starts, the
step index and the plant-noise ``torch.Generator``) is written as one plain
``.npz``. A resumed run continues bit for bit as one that was never
stopped, plant noise included: the generator's state is saved and restored
into the generator of the carry it is loaded into, on that generator's
device.

A distributed sweep writes one file per rank (``proc_path``,
``save_sharded``, ``load_sharded``): each rank holds its block of the
batch as one tensor and writes that block with its global offset.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _npz(path: str) -> str:
    """The file a checkpoint path names (``np.savez`` appends ``.npz``)."""
    return path if path.endswith(".npz") else path + ".npz"


def _atomic_savez(path: str, **payload) -> None:
    """Write an .npz atomically: a temporary file in the same directory,
    then ``os.replace``. A kill mid-write must never leave a corrupt
    checkpoint behind (``np.load`` would fail on the truncated file at
    resume)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    path = _npz(path)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def _kind(value) -> str:
    if value is None:
        return "none"
    if isinstance(value, torch.Tensor):
        return "tensor"
    if isinstance(value, torch.Generator):
        return "generator"
    if isinstance(value, int):
        return "int"
    raise TypeError(f"cannot checkpoint a carry field of type "
                    f"{type(value).__name__}")


def save(path: str, carry: Any, step: int) -> None:
    """Write ``carry`` (a NamedTuple of tensors, ints, ``None`` and
    ``torch.Generator``s) and the run's ``step`` to ``path``."""
    payload = {"step": np.asarray(step),
               "fields": np.asarray(carry._fields),
               "kinds": np.asarray([_kind(v) for v in carry])}
    for name, value in zip(carry._fields, carry):
        kind = _kind(value)
        if kind == "tensor":
            payload[f"leaf_{name}"] = value.detach().cpu().numpy()
        elif kind == "int":
            payload[f"leaf_{name}"] = np.asarray(value)
        elif kind == "generator":
            payload[f"leaf_{name}"] = value.get_state().numpy()
    _atomic_savez(path, **payload)


def load(path: str, carry_like: Any) -> tuple[Any, int]:
    """Restore a carry, using ``carry_like`` for structure, dtypes and
    devices. A saved generator state is set into ``carry_like``'s generator
    (which the returned carry holds)."""
    with np.load(_npz(path)) as f:
        step = int(f["step"])
        fields = tuple(str(x) for x in f["fields"])
        kinds = tuple(str(x) for x in f["kinds"])
        like_kinds = tuple(_kind(v) for v in carry_like)
        if fields != carry_like._fields or kinds != like_kinds:
            raise ValueError(
                f"checkpoint structure mismatch: {list(zip(fields, kinds))} "
                f"against {list(zip(carry_like._fields, like_kinds))}")
        values = []
        for name, kind, like in zip(fields, kinds, carry_like):
            if kind == "tensor":
                a = f[f"leaf_{name}"]
                if a.shape != tuple(like.shape):
                    raise ValueError(f"checkpoint field {name}: shape "
                                     f"{a.shape} against {tuple(like.shape)}")
                values.append(torch.from_numpy(a).to(
                    device=like.device, dtype=like.dtype))
            elif kind == "int":
                values.append(int(f[f"leaf_{name}"]))
            elif kind == "generator":
                like.set_state(torch.from_numpy(f[f"leaf_{name}"].copy()))
                values.append(like)
            else:
                values.append(None)
    return type(carry_like)(*values), step


def resume_or_init(path: str, init_fn, *args, **kw):
    """Resume-or-start: ``init_fn(*args, **kw)``'s carry, replaced by the
    checkpoint at ``path`` when there is one. Returns ``(carry, step)``."""
    carry = init_fn(*args, **kw)
    if os.path.exists(_npz(path)):
        return load(path, carry)
    return carry, 0


# ---- one file per rank of a distributed (torch.distributed) run ----
#
# No rank holds the whole batch: each writes its OWN block of every carry
# tensor with the block's global offset and shape, and the rank count. A
# rank's block is one contiguous tensor, so ``scp_tpu``'s ``_local_block``
# (the gathering of a process's addressable shards of a global jax Array)
# has no counterpart.


def proc_path(path: str, process_index: int | None = None) -> str:
    """A rank's checkpoint file, ``<base>.proc<k>.npz`` (``np.savez``
    appends ``.npz`` to names without it, so it stays last); ``k`` defaults
    to this rank (0 without a process group)."""
    if process_index is None:
        import torch.distributed as dist
        process_index = dist.get_rank() if dist.is_initialized() else 0
    base = path[:-4] if path.endswith(".npz") else path
    return f"{base}.proc{process_index}.npz"


def _world() -> tuple[int, int]:
    import torch.distributed as dist
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def save_sharded(path: str, carry: Any, step: int, offset: int,
                 global_batch: int) -> None:
    """Write THIS rank's block of a data-sharded carry: every tensor
    field's block (rows ``offset .. offset + B`` of ``global_batch``) with
    its offset and global shape; ints, ``None`` and generator states as
    :func:`save` writes them; the rank and the rank count."""
    rank, world = _world()
    payload = {"step": np.asarray(step),
               "fields": np.asarray(carry._fields),
               "kinds": np.asarray([_kind(v) for v in carry]),
               "process_index": np.asarray(rank),
               "process_count": np.asarray(world)}
    for name, value in zip(carry._fields, carry):
        kind = _kind(value)
        if kind == "tensor":
            payload[f"leaf_{name}"] = value.detach().cpu().numpy()
            payload[f"start_{name}"] = np.asarray(offset)
            payload[f"gshape_{name}"] = np.asarray(
                (global_batch,) + tuple(value.shape[1:]))
        elif kind == "int":
            payload[f"leaf_{name}"] = np.asarray(value)
        elif kind == "generator":
            payload[f"leaf_{name}"] = value.get_state().numpy()
    _atomic_savez(proc_path(path, rank), **payload)


def load_sharded(path: str, carry_like: Any, offset: int,
                 global_batch: int) -> tuple[Any, int]:
    """Restore THIS rank's block from its file (:func:`save_sharded`),
    using ``carry_like`` (this rank's block) for structure, dtypes and
    devices. A file written by another rank count, or whose block is not
    rows ``offset .. offset + B`` of ``global_batch``, raises
    ``ValueError``."""
    rank, world = _world()
    with np.load(proc_path(path, rank)) as f:
        if int(f["process_count"]) != world:
            raise ValueError(
                f"checkpoint written with {int(f['process_count'])} ranks; "
                f"this job has {world}")
        for name, like in zip(carry_like._fields, carry_like):
            if _kind(like) != "tensor" or f"start_{name}" not in f:
                continue
            want = (global_batch,) + tuple(like.shape[1:])
            got = (int(f[f"start_{name}"]),
                   tuple(int(x) for x in f[f"gshape_{name}"]))
            if got != (offset, want):
                raise ValueError(
                    f"checkpoint field {name}: block at {got[0]} of "
                    f"{got[1]}, this rank holds {offset} of {want}")
    return load(proc_path(path, rank), carry_like)
