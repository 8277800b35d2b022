"""Horizon (model-axis) sharding of the port's SCP solve over 2 and 4 gloo
ranks, against scp_tpu on the CPU in float64: the sharded ``solve_scp``
against ``vmap(solve_scp)`` of the padded system (rtol 1e-9 / atol 1e-11,
the SCP iteration counts equal; tests/test_horizon_parallel.py's cases,
hp = 10 over 4 ranks padded to 12 among them), ``mpc_step_horizon``
against ``mpc_step``, the sweep with a model axis against the pure data-
parallel one, the padding and slicing of the constraint system, and the
dry run over 4 CPU ranks.

The multi-rank jobs run this file as a script (``python
tests/test_torch_horizon.py <job> <dir>``) through
``distributed.launch_local``; every rank writes its results into ``<dir>``.
No JAX is imported before a test needs it.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from scp_tpu_torch.parallel import distributed, horizon, mesh as mesh_lib
from scp_tpu_torch.scenarios import batch as tbatch
from scp_tpu_torch.sim import engine as tengine
from scp_tpu_torch.solvers import scp as tscp

JOB_TIMEOUT = 240
GROUP_TIMEOUT = 60.0
RTOL, ATOL = 1e-9, 1e-11

# name -> (scenario, B, vehicles, hp, seed): tests/test_horizon_parallel.py
CASES = {"circle3": ("circle", 4, 3, 8, 2),
         "parallel4": ("parallel", 4, 4, 8, 9),
         "circle3_hp10": ("circle", 2, 3, 10, 7)}
# job -> [(case, n_data, n_model)]
LAYOUTS = {"two": [("circle3", 1, 2), ("parallel4", 1, 2)],
           "four": [("parallel4", 1, 4), ("circle3_hp10", 1, 4),
                    ("circle3", 2, 2)]}
STEP_CASE = ("circle", 4, 3, 6, 4)            # mpc_step_horizon
SWEEP_OVER = dict(max_scp_iter=2, qp_max_iter=8)
RES_FIELDS = ("u", "iters", "feasible", "obj", "max_violation")


def _setup(kind, b, n_veh, hp, seed, **over):
    gen = torch.Generator().manual_seed(seed)
    cfg, data = tbatch.make_batch(kind, b, generator=gen,
                                  dtype=torch.float64, device="cpu",
                                  n_veh=n_veh)
    cfg = cfg.replace(**{**dict(hp=hp, hu=hp, max_scp_iter=6,
                                qp_max_iter=20), **over})
    carry = tengine.init_carry(cfg, data)
    problem, _ = tengine.controller_pre(cfg, data, carry)
    return cfg, data, carry, problem


def _step_arrays(carry, out) -> dict:
    return {"state": carry.state.numpy(), "u_applied": out.u_applied.numpy(),
            "feasible": out.feasible.numpy(),
            "scp_iters": out.scp_iters.numpy()}


# ---- the jobs (run as a script, one process a rank) ----

def _job(name: str, out: str) -> None:
    rank = dist.get_rank()
    res = {}
    for case, n_data, n_model in LAYOUTS[name]:
        cfg, _, carry, problem = _setup(*CASES[case])
        mesh = mesh_lib.make_mesh(n_data, n_model)
        got = horizon.solve_scp_sharded(cfg, problem, carry.u_warm, mesh,
                                        **tengine._scp_kwargs(cfg))
        for f in RES_FIELDS:
            res[f"{case}_{n_data}x{n_model}_{f}"] = getattr(got, f).numpy()
        if name == "two":
            # qp_kkt="banded" under axis_name: the dense KKT, as scp_tpu
            got = horizon.solve_scp_sharded(
                cfg, problem, carry.u_warm, mesh,
                **{**tengine._scp_kwargs(cfg), "qp_kkt": "banded"})
            for f in RES_FIELDS:
                res[f"{case}_{n_data}x{n_model}_banded_{f}"] = \
                    getattr(got, f).numpy()
    if name == "two":
        mesh = mesh_lib.make_mesh(1, 2)
        cfg, data, carry, _ = _setup(*STEP_CASE)
        c, o = tengine.mpc_step_horizon(cfg, data, carry,
                                        axis_name=mesh.groups["model"],
                                        n_shards=2)
        res.update({f"step_{k}": v for k, v in _step_arrays(c, o).items()})
        for hp in (4, 5):                     # 5: padded to 6 over 2
            cfg, data, _, _ = _setup("circle", 8, 3, hp, 5, **SWEEP_OVER)
            c, s = distributed.sweep(cfg, data, mesh, n_steps=2)
            res[f"sweep{hp}_state"] = c.state.numpy()
            res[f"sweep{hp}_summary"] = np.stack(
                [x.double().numpy() for x in s])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


def _run_job(name: str, out, n_ranks: int) -> list[dict]:
    res = distributed.launch_local(
        [os.path.abspath(__file__), name, str(out)], n_ranks,
        timeout=JOB_TIMEOUT)
    for r in res:
        assert r["returncode"] == 0, (r["rank"], r["stderr"][-3000:])
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(n_ranks)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both jobs' results: {"two": [rank dicts], "four": [...]}."""
    return {name: _run_job(name, tmp_path_factory.mktemp(name), n)
            for name, n in (("two", 2), ("four", 4))}


def _jax_problem(problem):
    import jax.numpy as jnp

    from scp_tpu.ops import constraints as jcon
    from scp_tpu.solvers import scp as jscp
    j = lambda t: jnp.asarray(t.numpy())           # noqa: E731
    return jscp.SCPProblem(
        sys=jcon.ConstraintSystem(**{k: j(v) for k, v in
                                     problem.sys._asdict().items()}),
        phi0=j(problem.phi0), psi0=j(problem.psi0),
        gamma0=j(problem.gamma0))


@pytest.fixture(scope="module")
def references():
    """scp_tpu's ``vmap(solve_scp)`` of each case's system padded for 2 and
    for 4 shards (``jit_fast``, one compile a shape), on the port's
    problems converted."""
    import jax

    from scp_tpu import config as jconfig
    from scp_tpu.parallel import horizon as jhorizon
    from scp_tpu.sim import engine as jengine
    from scp_tpu.solvers import scp as jscp
    from torch_parity import jit_fast, tonp

    out = {}
    for case, spec in CASES.items():
        cfg, _, carry, problem = _setup(*spec)
        cfg_j = jconfig.SCPConfig(**dataclasses.asdict(cfg))
        kw = jengine._scp_kwargs(cfg_j)
        pj = _jax_problem(problem)
        u0 = carry.u_warm.numpy()
        for n in sorted({m for c, _, m in sum(LAYOUTS.values(), [])
                         if c == case}):
            padded = pj._replace(sys=jhorizon.pad_system(pj.sys, n))
            fn = jax.vmap(lambda p, u: jscp.solve_scp(
                p, u, max_scp_iter=cfg_j.max_scp_iter, **kw))
            res = jit_fast(fn, padded, u0)(padded, u0)
            out[case, n] = tonp(res)
    return out


# ---- the sharded solve against scp_tpu ----

def _check(got: dict, key: str, want, rows=slice(None)):
    np.testing.assert_allclose(got[f"{key}_u"], want.u[rows], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got[f"{key}_iters"], want.iters[rows])
    np.testing.assert_array_equal(got[f"{key}_feasible"],
                                  want.feasible[rows])
    np.testing.assert_allclose(got[f"{key}_obj"], want.obj[rows], rtol=RTOL)
    np.testing.assert_allclose(got[f"{key}_max_violation"],
                               want.max_violation[rows], atol=1e-10)


@pytest.mark.parametrize("case", ["circle3", "parallel4"])
def test_solve_scp_sharded_two_ranks_equals_scp_tpu(ranks, references,
                                                    case):
    """Over two model ranks, and with qp_kkt="banded", which the
    row-sharded QP solves dense as scp_tpu does: bit for bit the dense
    run."""
    for res in ranks["two"]:
        _check(res, f"{case}_1x2", references[case, 2])
        _check(res, f"{case}_1x2_banded", references[case, 2])
        for f in RES_FIELDS:
            np.testing.assert_array_equal(res[f"{case}_1x2_banded_{f}"],
                                          res[f"{case}_1x2_{f}"])


def test_solve_scp_sharded_four_way_equals_scp_tpu(ranks, references):
    """hp = 8 over 4 model ranks: a block of 2 horizon steps each."""
    for res in ranks["four"]:
        _check(res, "parallel4_1x4", references["parallel4", 4])


def test_solve_scp_sharded_padded_hp(ranks, references):
    """hp = 10 over 4 ranks pads to 12 with inert steps: the sharded solve
    equals scp_tpu's solve OF THE PADDED SYSTEM to float64 round-off, and
    stays within solver tolerance of the port's unpadded solve (the same
    feasibility; the pad rows shift the complementarity average)."""
    cfg, _, carry, problem = _setup(*CASES["circle3_hp10"])
    assert horizon.pad_system(problem.sys, 4).b3.shape[2] == 12
    plain = tscp.solve_scp(problem, carry.u_warm,
                           max_scp_iter=cfg.max_scp_iter,
                           **tengine._scp_kwargs(cfg))
    for res in ranks["four"]:
        _check(res, "circle3_hp10_1x4", references["circle3_hp10", 4])
        np.testing.assert_array_equal(res["circle3_hp10_1x4_feasible"],
                                      plain.feasible.numpy())
        np.testing.assert_allclose(res["circle3_hp10_1x4_u"],
                                   plain.u.numpy(), atol=5e-5)


def test_solve_scp_sharded_over_data_and_model_axes(ranks, references):
    """A (2, 2) layout: rank d * 2 + m solves block d of the batch with
    horizon block m; the two model ranks of a block agree bit for bit."""
    four = ranks["four"]
    for r, res in enumerate(four):
        d = r // 2
        _check(res, "circle3_2x2", references["circle3", 2],
               rows=slice(2 * d, 2 * d + 2))
    for f in RES_FIELDS:
        for a, b in ((0, 1), (2, 3)):
            np.testing.assert_array_equal(four[a][f"circle3_2x2_{f}"],
                                          four[b][f"circle3_2x2_{f}"])


# ---- the step and the sweep ----

def test_mpc_step_horizon_equals_mpc_step(ranks):
    """The whole step (pre-processing, the sharded solve over 2 ranks,
    post-processing) against the port's unsharded ``mpc_step``."""
    cfg, data, carry, _ = _setup(*STEP_CASE)
    want = _step_arrays(*tengine.mpc_step(cfg, data, carry))
    for res in ranks["two"]:
        np.testing.assert_allclose(res["step_state"], want["state"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(res["step_u_applied"], want["u_applied"],
                                   rtol=RTOL, atol=1e-12)
        for k in ("feasible", "scp_iters"):
            np.testing.assert_array_equal(res[f"step_{k}"], want[k])


def _padded_sweep(cfg, data, n_steps, n_shards):
    """The unsharded closed loop of the system padded for ``n_shards``:
    ``mpc_step`` with the SCP solve of the padded system."""
    c = tengine.init_carry(cfg, data)
    obj, feas = [], []
    for _ in range(n_steps):
        problem, aux = tengine.controller_pre(cfg, data, c)
        problem = problem._replace(
            sys=horizon.pad_system(problem.sys, n_shards))
        res = tscp.solve_scp(problem, c.u_warm, max_scp_iter=cfg.max_scp_iter,
                             **tengine._scp_kwargs(cfg))
        c, out = tengine.step_post(cfg, data, c, res, aux)
        obj.append(float(out.obj.sum()))
        feas.append(float(out.feasible.sum()))
    return c, np.array(obj), np.array(feas)


@pytest.mark.parametrize("hp", [4, 5])
def test_sweep_with_a_model_axis_counts_each_instance_once(ranks, hp):
    """n_model = 2 goes through ``mpc_step_horizon`` and sums over the data
    ranks only: 8 feasible of 8 (not 16), the summary and the states of the
    unsharded loop of the same (at hp = 5: padded to 6) system to float64
    round-off, and the feasibility of the pure data-parallel sweep; hp = 5
    against that sweep's states within solver tolerance (the pad rows
    shift the complementarity average)."""
    cfg, data, _, _ = _setup("circle", 8, 3, hp, 5, **SWEEP_OVER)
    c1, s1 = distributed.sweep(cfg, data, mesh_lib.make_mesh(), n_steps=2)
    c_pad, obj_pad, feas_pad = _padded_sweep(cfg, data, 2, 2)
    for res in ranks["two"]:
        s2, state2 = res[f"sweep{hp}_summary"], res[f"sweep{hp}_state"]
        assert s2[1, -1] == 8.0
        np.testing.assert_array_equal(s2[1], s1[1].numpy())
        np.testing.assert_array_equal(s2[1], feas_pad)
        np.testing.assert_allclose(s2[0], obj_pad, rtol=1e-12)
        np.testing.assert_allclose(state2, c_pad.state.numpy(), rtol=1e-12,
                                   atol=1e-13)
        np.testing.assert_allclose(state2, c1.state.numpy(),
                                   atol=1e-12 if hp == 4 else 5e-5)


def test_one_shard_without_a_group_is_mpc_step():
    """``mpc_step_horizon`` over one shard and no process group is
    ``mpc_step`` bit for bit (the collectives are the identity)."""
    cfg, data, carry, _ = _setup(*STEP_CASE)
    c1, o1 = tengine.mpc_step_horizon(cfg, data, carry, axis_name=None,
                                      n_shards=1)
    c2, o2 = tengine.mpc_step(cfg, data, carry)
    assert torch.equal(c1.state, c2.state)
    assert torch.equal(o1.u_pred, o2.u_pred)


# ---- padding and slicing against scp_tpu ----

@pytest.mark.parametrize("hp,n_shards", [(10, 4), (8, 2), (5, 2)])
def test_pad_and_shard_system_equal_scp_tpu(hp, n_shards):
    import jax

    from scp_tpu.parallel import horizon as jhorizon
    _, _, _, problem = _setup("parallel", 2, 4, hp, 3)
    pj = _jax_problem(problem)
    pad_t = horizon.pad_system(problem.sys, n_shards)
    pad_j = jhorizon.pad_system(pj.sys, n_shards)
    for f in pad_t._fields:
        np.testing.assert_array_equal(getattr(pad_t, f).numpy(),
                                      np.asarray(getattr(pad_j, f)), f)
    for k in range(n_shards):
        loc_t = horizon.shard_system(problem.sys, k, n_shards)
        loc_j = jax.vmap(lambda s: jhorizon.shard_system(s, k, n_shards))(
            pj.sys)
        for f in loc_t._fields:
            np.testing.assert_array_equal(getattr(loc_t, f).numpy(),
                                          np.asarray(getattr(loc_j, f)), f)
    cfg = _setup("parallel", 1, 4, hp, 3)[0]
    assert horizon.padded_hp(hp, n_shards) == jhorizon.padded_hp(hp,
                                                                  n_shards)
    assert horizon.padded_n_con(cfg, n_shards) == (
        horizon.padded_hp(hp, n_shards) * (cfg.n_pairs
                                           + cfg.n_veh * cfg.n_obst))


# ---- the dry run ----

def test_dryrun_multichip_over_four_cpu_ranks():
    """``python -m scp_tpu_torch.parallel.dryrun --ranks 4 --cpu``: the
    (2, 2) layout's sharded step and its solve against the unsharded one
    (du < 1e-5, the same SCP iterations) on every rank."""
    p = subprocess.run(
        [sys.executable, "-m", "scp_tpu_torch.parallel.dryrun", "--ranks",
         "4", "--cpu", "--timeout", str(JOB_TIMEOUT)],
        capture_output=True, text=True, timeout=JOB_TIMEOUT + 30,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [ln for ln in p.stdout.splitlines() if "dryrun_multichip" in ln]
    assert len(lines) == 4
    assert all("mesh={'data': 2, 'model': 2}" in ln and " du=" in ln
               for ln in lines)
    # every rank reports the totals of the whole batch
    assert len({ln.split("] ", 1)[1].split(" du=")[0] for ln in lines}) == 1


if __name__ == "__main__":
    torch.set_num_threads(1)
    distributed.initialize(backend="gloo", timeout=GROUP_TIMEOUT)
    try:
        _job(sys.argv[1], sys.argv[2])
    finally:
        dist.destroy_process_group()
