"""Horizon-block (model-axis) sharding of the SCP solve (counterpart of
``scp_tpu/parallel/horizon.py``).

The avoidance rows of the SCP's QP — the dominant cost of an IPM iteration,
the ``m * n^2`` formation of ``G^T W G`` — are indexed by the horizon step
k. Slicing the k axis of a :class:`~scp_tpu_torch.ops.constraints.
ConstraintSystem` over the ranks of a model process group makes every rank

* evaluate and linearize only its block of ``hp / n_shards`` horizon steps
  (``constraints.linearize`` / ``evaluate`` unchanged: a row depends on its
  own k only);
* form its block of the condensed KKT matrix, one ``all_reduce`` a
  factorization rebuilding the whole (``qp.solve_qp(axis_name=...)``);
* reduce step lengths, complementarity and violation maxima with
  ``all_reduce`` (``scp.solve_scp(axis_name=...)``).

The decision vector u (``V * hu`` numbers) is the same on every rank. Where
``scp_tpu`` places the blocks with ``shard_map`` in-specs
(``system_pspecs``), here :func:`shard_system`'s slice is the placement: a
rank holds its own block and nothing of another's.
"""
from __future__ import annotations

import torch

from scp_tpu_torch.ops import constraints as con
from scp_tpu_torch.parallel import mesh as mesh_lib
from scp_tpu_torch.solvers import scp

# Padded horizon steps place every vehicle at a distinct far-away position
# (pair distance^2 >= 2e10 against dsafe^2 ~ 10), so the pad rows linearize
# to the same inert ``0*u <= ~1e10`` form the coupling masks already emit
# and evaluate as satisfied by a mile.
_PAD_SEP = 1e5

# the k axis of each k-indexed field of a (batched) ConstraintSystem
_K_AXIS = {"b3": 2, "const3": 2, "obst_pos": 2, "b3i": 2, "b3j": 2}


def padded_hp(hp: int, n_shards: int) -> int:
    """Smallest multiple of ``n_shards`` >= hp (the horizon pad target)."""
    return -(-hp // n_shards) * n_shards


def padded_n_con(cfg, n_shards: int) -> int:
    """Global avoidance-row count of the PADDED system: the ``n_con_total``
    / ``mg_total`` the sharded solver is told (pad rows take part in the
    IPM's complementarity averages as masked rows do)."""
    return padded_hp(cfg.hp, n_shards) * (
        cfg.n_pairs + cfg.n_veh * cfg.n_obst)


def pad_system(sys: con.ConstraintSystem, n_shards: int
               ) -> con.ConstraintSystem:
    """Pad the horizon axis to a multiple of ``n_shards`` with inert steps:
    zero ``math_b`` blocks and vehicles hugely separated (vehicle v at
    ``(v + 1) * 1e5`` on both axes, obstacles at ``-1e5``), so every row of
    a pad step is satisfied and linearizes to a zero row with a large
    positive right-hand side — the shape of a coupling-masked row."""
    hp = sys.b3.shape[2]
    pad = padded_hp(hp, n_shards) - hp
    if pad == 0:
        return sys
    b, v = sys.b3.shape[:2]
    dt, dev = sys.b3.dtype, sys.b3.device

    def zpad(a):
        shape = list(a.shape)
        shape[2] = pad
        return torch.cat([a, torch.zeros(shape, dtype=a.dtype, device=dev)],
                         dim=2)

    sep = (torch.arange(v, dtype=dt, device=dev) + 1.0) * _PAD_SEP
    c_pad = sep[None, :, None, None].expand(b, v, pad, sys.const3.shape[-1])
    o = sys.obst_pos
    o_pad = torch.full((o.shape[0], o.shape[1], pad, o.shape[3]), -_PAD_SEP,
                       dtype=dt, device=dev)
    return sys._replace(b3=zpad(sys.b3),
                        const3=torch.cat([sys.const3, c_pad], dim=2),
                        obst_pos=torch.cat([o, o_pad], dim=2),
                        b3i=zpad(sys.b3i), b3j=zpad(sys.b3j))


def shard_system(sys: con.ConstraintSystem, shard_idx: int, n_shards: int
                 ) -> con.ConstraintSystem:
    """Block ``shard_idx`` of ``n_shards`` of the horizon axis of a
    (batched) system, padded first (:func:`pad_system`) when ``hp`` is not
    a multiple of ``n_shards``. Pair topology, safety distances and masks
    have no k axis and stay whole."""
    sys = pad_system(sys, n_shards)
    kl = sys.b3.shape[2] // n_shards
    k0 = shard_idx * kl
    return sys._replace(**{
        f: getattr(sys, f).narrow(axis, k0, kl).contiguous()
        for f, axis in _K_AXIS.items()})


def solve_scp_sharded(cfg, problems: scp.SCPProblem, u_init: torch.Tensor,
                      mesh: mesh_lib.Mesh, **scp_kw) -> scp.SCPResult:
    """Batched SCP solve over a (data, model) mesh with horizon sharding.

    Every rank passes the same full batch (``problems`` / ``u_init`` with a
    leading batch axis); a rank solves its data block
    (:func:`mesh.shard_batch`) with its model block of every instance's
    horizon. Returns this rank's data block of the result, the same on
    every rank of its model group."""
    n_model = mesh.shape["model"]
    problems = problems._replace(sys=pad_system(problems.sys, n_model))
    prob, u0 = mesh_lib.shard_batch((problems, u_init), mesh)
    local = prob._replace(
        sys=shard_system(prob.sys, mesh.model_index, n_model))
    return scp.solve_scp(local, u0, max_scp_iter=cfg.max_scp_iter,
                         axis_name=mesh.groups["model"],
                         n_con_total=padded_n_con(cfg, n_model), **scp_kw)
