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

The per-process shard files of a distributed run (``proc_path``,
``save_sharded``, ``load_sharded``) come with the scale-out slice.
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
