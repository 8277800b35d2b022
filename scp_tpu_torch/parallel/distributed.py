"""Multi-process start-up and the sharded, checkpointed sweep (counterpart of
``scp_tpu/parallel/distributed.py``).

``scp_tpu`` joins processes with ``jax.distributed`` and runs one
``shard_map`` over a (data, model) device mesh. Here one rank is one
process of a ``torch.distributed`` job: :func:`initialize` joins it,
:func:`global_mesh` lays the ranks out (``parallel.mesh``), and
:func:`sweep` steps this rank's block of the scenario batch, reducing each
step's summary over the data axis. :func:`launch_local` starts N ranks of
a module on this host the way ``torchrun`` does.

The backend is the caller's: NCCL on ``cuda`` (the default), gloo on the
CPU. Two ranks on one card need gloo with CUDA tensors, chosen by an
explicit ``backend="gloo"``; NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from scp_tpu_torch.parallel import mesh as mesh_lib

# Seconds a collective may wait for the other ranks before the job fails
# (a rank that died must not hang the others for ever). A data-parallel
# sweep waits at the end of every chunk for the slowest rank's block.
TIMEOUT_S = 600.0


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               timeout: float = TIMEOUT_S) -> None:
    """Join the job's process group (a no-op for one process).

    With no arguments it reads what ``torchrun`` puts in the environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of rank
    0. ``backend`` defaults to ``"nccl"`` (the entry points run on
    ``cuda``); pass ``"gloo"`` for CPU ranks, or for CUDA tensors of
    several ranks on one card. Under NCCL the rank's current device is set
    to :func:`local_device`'s."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or dist.is_initialized():
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    backend = backend or "nccl"
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout))


def local_device(cpu: bool = False) -> torch.device:
    """This rank's device: the CPU, or the card ``LOCAL_RANK`` names (what
    ``torchrun`` and :func:`launch_local` set; 0 without it)."""
    if cpu:
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def global_mesh(n_model: int = 1) -> mesh_lib.Mesh:
    """(data, model) mesh over every rank of the job; build it on every
    rank, in the same order."""
    return mesh_lib.make_mesh(n_model=n_model)


def _multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def sweep(cfg, data_batch, mesh: mesh_lib.Mesh, *, n_steps: int,
          generator: torch.Generator | None = None,
          checkpoint_path: str | None = None, checkpoint_every: int = 0,
          resume: bool = True, phases=None):
    """Run a sharded closed-loop sweep over a scenario batch.

    Every rank passes the same full ``data_batch`` and steps its data
    block (:func:`mesh.shard_batch`); with a model axis each step's SCP
    solve is horizon-sharded (``engine.mpc_step_horizon``). ``phases``
    (e.g. ``config.TUNED_F32_PHASES``): each step is
    ``engine.mpc_step_batch`` on the block (straggler repacking sized by
    the block's width), else ``engine.mpc_step``.

    ``generator``: the plant noise of the WHOLE batch (None: seed 0 on the
    data's device). Every rank draws the whole batch's noise each tick and
    keeps its block's rows, so an instance's noise does not depend on the
    rank count.

    The summary is ``(obj, feasible, scp_iters)`` per step, each summed over
    the block and ``all_reduce``d over the data axis only (the model ranks
    of a block hold the same results; summing over them would count each
    instance n_model times).

    Checkpointing: with ``checkpoint_every = k > 0`` the steps run in
    chunks of k and the carry is saved after every chunk, the final partial
    one included. One process writes ``checkpoint_path``; ranks of a job
    write one file each (``utils.checkpoint.save_sharded``). With
    ``resume`` an existing checkpoint restarts the sweep from its step; the
    ranks of a job resume only when every one of them finds its file at
    the same step (an ``all_gather``), else they all start again from 0.
    A resumed run ends bit for bit as an uninterrupted one.

    Returns ``(carry, summary)``: this rank's block's carry and the
    summary tensors of shape (n_steps,); steps before a resume are zero.
    """
    from scp_tpu_torch.sim import engine
    from scp_tpu_torch.utils import checkpoint

    n_model = int(mesh.shape["model"])
    if n_model > 1 and cfg.controller != "scp":
        raise ValueError(
            f"n_model={n_model} requires the SCP controller (horizon "
            f"sharding); got controller={cfg.controller!r}")
    if phases is not None and n_model > 1:
        raise ValueError("phases (batched stepping) is incompatible with "
                         "a model axis; use n_model=1 or phases=None")

    n = data_batch.x0.shape[0]
    block = mesh_lib.shard_batch(data_batch, mesh)
    b = block.x0.shape[0]
    offset = mesh.data_index * b
    device = block.x0.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    carry = engine.init_carry(cfg, block, generator)._replace(
        noise_offset=offset, noise_total=n)

    multiprocess = _multiprocess()
    start = 0
    if checkpoint_path and resume and multiprocess:
        local_step = -1
        if os.path.exists(checkpoint.proc_path(checkpoint_path)):
            with np.load(checkpoint.proc_path(checkpoint_path)) as f:
                local_step = int(f["step"])
        mine = torch.tensor([local_step], dtype=torch.int64, device=device)
        steps = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(steps, mine)
        steps = torch.cat(steps).tolist()
        if min(steps) == max(steps) >= 0:
            carry, start = checkpoint.load_sharded(checkpoint_path, carry,
                                                   offset, n)
    elif (checkpoint_path and resume
          and os.path.exists(checkpoint._npz(checkpoint_path))):
        carry, start = checkpoint.load(checkpoint_path, carry)

    def save(c, k):
        if multiprocess:
            checkpoint.save_sharded(checkpoint_path, c, k, offset, n)
        else:
            checkpoint.save(checkpoint_path, c, k)

    def step(c):
        if n_model > 1:
            return engine.mpc_step_horizon(
                cfg, block, c, axis_name=mesh.groups["model"],
                n_shards=n_model)
        if phases is not None:
            return engine.mpc_step_batch(cfg, block, c, phases=phases)
        return engine.mpc_step(cfg, block, c)

    chunk = checkpoint_every if checkpoint_every > 0 else n_steps - start
    parts = []
    k = start
    while k < n_steps:
        rows = []
        for _ in range(min(chunk, n_steps - k)):
            carry, out = step(carry)
            rows.append((out.obj.sum(), out.feasible.to(torch.float32).sum(),
                         out.scp_iters.sum()))
            k += 1
        parts.append([mesh_lib.all_reduce(torch.stack(col),
                                          mesh.groups["data"])
                      for col in zip(*rows)])
        if checkpoint_path and checkpoint_every:
            save(carry, k)

    dtypes = (block.x0.dtype, torch.float32, torch.int64)
    summary = []
    for i, dt in enumerate(dtypes):
        head = torch.zeros((start,), dtype=dt, device=device)
        summary.append(torch.cat([head] + [p[i].to(dt) for p in parts]))
    return carry, tuple(summary)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local(argv: list[str], n_ranks: int, *,
                 timeout: float) -> list[dict]:
    """Start ``n_ranks`` processes of ``python argv...`` on this host with
    the environment ``torchrun`` gives its workers (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR=localhost``, a free
    ``MASTER_PORT``; this package on ``PYTHONPATH``), so each joins with a
    bare :func:`initialize`. Waits
    at most ``timeout`` seconds for all of them and kills every one left on
    expiry (``TimeoutError``). Returns each rank's ``{"rank", "returncode",
    "stdout", "stderr"}``."""
    port = _free_port()
    # the package importable in every rank, wherever it was started from
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    procs, files = [], []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for r in range(n_ranks):
                out = open(os.path.join(tmp, f"{r}.out"), "w+")
                err = open(os.path.join(tmp, f"{r}.err"), "w+")
                files.append((out, err))
                e = {**os.environ,
                     "WORLD_SIZE": str(n_ranks), "RANK": str(r),
                     "LOCAL_RANK": str(r), "MASTER_ADDR": "localhost",
                     "MASTER_PORT": str(port), "PYTHONPATH": path}
                procs.append(subprocess.Popen(
                    [sys.executable] + list(argv), stdout=out, stderr=err,
                    env=e))
            deadline = time.monotonic() + timeout
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            raise TimeoutError(
                f"{argv}: {n_ranks} ranks did not end within {timeout} s; "
                "all killed") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for r, (p, (out, err)) in enumerate(zip(procs, files)):
            out.seek(0)
            err.seek(0)
            results.append({"rank": r, "returncode": p.returncode,
                            "stdout": out.read(), "stderr": err.read()})
            out.close()
            err.close()
    return results
