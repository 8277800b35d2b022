"""The port's data-parallel sweep against scp_tpu's, and against itself over
2 gloo ranks, on the CPU: the float64 sweep summary of
``scp_tpu.parallel.distributed.sweep`` on the same batch (circle-3, hp = 5,
B = 16, 2 steps, as tests/test_parallel.py), 2 ranks against 1 instance for
instance with plant noise on, checkpoints killed and resumed bit for bit
(one file, and one file per rank), the chunk cadence, the guards, and
``cli sweep``.

The multi-rank jobs run this file as a script (``python
tests/test_torch_parallel.py <job> <dir>``) through
``distributed.launch_local``; a job writes each rank's results into
``<dir>`` and the tests read them. Its imports stay light: no JAX here
before a test needs it.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from scp_tpu_torch.parallel import distributed, mesh as mesh_lib
from scp_tpu_torch.scenarios import batch as tbatch
from scp_tpu_torch.sim import engine as tengine
from scp_tpu_torch.utils import checkpoint

JOB_TIMEOUT = 240            # seconds before a job's ranks are killed
GROUP_TIMEOUT = 60.0         # seconds a collective waits for the others

# tests/test_parallel.py's sweep: circle-3, hp = 5, B = 16, 2 steps
SEED, B, STEPS = 5, 16, 2
SMALL = dict(hp=5, hu=5, max_scp_iter=2, qp_max_iter=8)
NOISE_STD, NOISE_SEED = 1e-3, 3
BATCHED = ((1, 1), (1, 2))      # straggler phases: the second half-width


def _batch(noise: bool, seed: int = SEED, b: int = B):
    gen = torch.Generator().manual_seed(seed)
    cfg, data = tbatch.make_batch("circle", b, generator=gen,
                                  dtype=torch.float64, device="cpu", n_veh=3)
    cfg = cfg.replace(**SMALL)
    if noise:
        cfg = cfg.replace(noise_std=NOISE_STD)
    return cfg, data


def _gen():
    return torch.Generator().manual_seed(NOISE_SEED)


def _tensors(carry) -> dict:
    return {k: v for k, v in carry._asdict().items()
            if isinstance(v, torch.Tensor)}


def _carries_equal(a, b) -> bool:
    for name, x, y in zip(a._fields, a, b):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif isinstance(x, torch.Generator):
            if not torch.equal(x.get_state(), y.get_state()):
                return False
        elif x != y:
            return False
    return True


# ---- the jobs (run as a script, one process a rank) ----

def _job_sweep(out: str) -> None:
    """2 ranks: the noisy per-instance sweep, the batched sweep (noise
    off), and a checkpoint killed after 3 of 6 steps and resumed; then
    rank 1's file removed, so the ranks must both start again from 0."""
    rank = dist.get_rank()
    mesh = distributed.global_mesh()
    cfg, data = _batch(noise=True)
    carry, summ = distributed.sweep(cfg, data, mesh, n_steps=STEPS,
                                    generator=_gen())
    cfg0, _ = _batch(noise=False)
    carry_b, summ_b = distributed.sweep(cfg0, data, mesh, n_steps=STEPS,
                                        phases=BATCHED)
    path = os.path.join(out, "ckpt.npz")
    ref, summ_ref = distributed.sweep(cfg, data, mesh, n_steps=6,
                                      generator=_gen())
    distributed.sweep(cfg, data, mesh, n_steps=3, generator=_gen(),
                      checkpoint_path=path, checkpoint_every=3)
    with np.load(checkpoint.proc_path(path)) as f:
        step_after_kill = int(f["step"])
    got, summ_res = distributed.sweep(cfg, data, mesh, n_steps=6,
                                      generator=_gen(), checkpoint_path=path,
                                      checkpoint_every=3)
    with np.load(checkpoint.proc_path(path)) as f:
        step_after_resume = int(f["step"])
    resumed_bitwise = _carries_equal(got, ref) and all(
        torch.equal(a[3:], b[3:]) for a, b in zip(summ_res, summ_ref))
    dist.barrier()
    if rank == 1:
        os.remove(checkpoint.proc_path(path))
    dist.barrier()
    _, summ_restart = distributed.sweep(cfg, data, mesh, n_steps=6,
                                        generator=_gen(),
                                        checkpoint_path=path,
                                        checkpoint_every=3)
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             offset=carry.noise_offset, total=carry.noise_total,
             **{f"carry_{k}": v.numpy() for k, v in _tensors(carry).items()},
             **{f"batched_{k}": v.numpy()
                for k, v in _tensors(carry_b).items()},
             summary=np.stack([s.double().numpy() for s in summ]),
             summary_batched=np.stack([s.double().numpy() for s in summ_b]),
             step_after_kill=step_after_kill,
             step_after_resume=step_after_resume,
             resumed_bitwise=resumed_bitwise,
             restart_first_obj=float(summ_restart[0][0]))


JOBS = {"sweep": _job_sweep}


def _run_job(name: str, out, n_ranks: int = 2) -> list[dict]:
    res = distributed.launch_local(
        [os.path.abspath(__file__), name, str(out)], n_ranks,
        timeout=JOB_TIMEOUT)
    for r in res:
        assert r["returncode"] == 0, (r["rank"], r["stderr"][-3000:])
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(n_ranks)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sweep2")
    return out, _run_job("sweep", out)


@pytest.fixture(scope="module")
def one_rank_noisy():
    cfg, data = _batch(noise=True)
    return distributed.sweep(cfg, data, mesh_lib.make_mesh(),
                             n_steps=STEPS, generator=_gen())


# ---- against scp_tpu ----

def test_sweep_f64_summary_equals_scp_tpu_sweep():
    """No plant noise: the per-step summary (obj, feasible, scp_iters) and
    the final plant states of the port's 1-rank sweep against
    ``scp_tpu.parallel.distributed.sweep`` over its 8 CPU devices, on the
    same batch."""
    import jax

    from scp_tpu.parallel import distributed as jdist
    from torch_parity import scenario_pair
    cfg_j, data_j, cfg_t, data_t = scenario_pair("circle", B, SEED,
                                                 n_veh=3, cfg_over=SMALL)
    c_j, s_j = jdist.sweep(cfg_j, data_j, jdist.global_mesh(),
                           n_steps=STEPS)
    c_t, s_t = distributed.sweep(cfg_t, data_t, mesh_lib.make_mesh(),
                                 n_steps=STEPS)
    for got, want in zip(s_t, s_j):
        np.testing.assert_allclose(got.double().numpy(),
                                   np.asarray(want, float), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_allclose(c_t.state.numpy(), np.asarray(c_j.state),
                               rtol=1e-9, atol=1e-10)
    assert jax.device_count() == 8 and float(s_t[1][-1]) == B


# ---- 2 gloo ranks against 1 ----

def test_two_gloo_ranks_equal_one_rank_instance_for_instance(two_ranks,
                                                             one_rank_noisy):
    """With plant noise on: each rank's block of the 2-rank sweep equals
    the same rows of the 1-rank sweep, bit for bit — every rank draws the
    whole batch's noise and keeps its rows."""
    _, ranks = two_ranks
    carry1, _ = one_rank_noisy
    for r, res in enumerate(ranks):
        rows = slice(r * B // 2, (r + 1) * B // 2)
        assert int(res["offset"]) == rows.start and int(res["total"]) == B
        for k, v in _tensors(carry1).items():
            np.testing.assert_array_equal(res[f"carry_{k}"], v[rows].numpy(),
                                          err_msg=k)
    # the noise did move the plant
    _, data = _batch(noise=False)
    cfg0, _ = _batch(noise=False)
    quiet, _ = distributed.sweep(cfg0, data, mesh_lib.make_mesh(),
                                 n_steps=STEPS)
    assert not torch.equal(quiet.state, carry1.state)


def test_every_rank_reports_the_summary_of_the_whole_batch(two_ranks,
                                                          one_rank_noisy):
    _, ranks = two_ranks
    _, summ1 = one_rank_noisy
    want = np.stack([s.double().numpy() for s in summ1])
    np.testing.assert_array_equal(ranks[0]["summary"], ranks[1]["summary"])
    np.testing.assert_allclose(ranks[0]["summary"], want, rtol=1e-13)
    assert ranks[0]["summary"][1, -1] == B


def test_batched_sweep_blocks_equal_one_rank_runs_of_the_block(two_ranks):
    """``phases`` (straggler repacking): each rank's block equals, bit for
    bit, a 1-rank batched sweep of that block — a phase's capacity is sized
    by the block, so the whole batch's 1-rank run is not the comparison —
    and the reduced summary is the sum of the blocks' summaries."""
    _, ranks = two_ranks
    cfg, data = _batch(noise=False)
    total = 0
    for r, res in enumerate(ranks):
        blk = mesh_lib.shard_batch(data, mesh_lib.Mesh(
            {"data": 2, "model": 1}, data_index=r))
        c, s = distributed.sweep(cfg, blk, mesh_lib.make_mesh(),
                                 n_steps=STEPS, phases=BATCHED)
        for k, v in _tensors(c).items():
            np.testing.assert_array_equal(res[f"batched_{k}"], v.numpy(),
                                          err_msg=k)
        total = total + np.stack([x.double().numpy() for x in s])
    np.testing.assert_array_equal(ranks[0]["summary_batched"], total)
    np.testing.assert_array_equal(ranks[1]["summary_batched"], total)


def test_world_size_one_noise_is_the_pre_slice_draw(one_rank_noisy):
    """At world size 1 the sweep's carry draws for (offset 0, total B):
    bit for bit the chained ``mpc_step`` of a carry that draws for its own
    batch (the draw before the sweep existed)."""
    carry1, _ = one_rank_noisy
    cfg, data = _batch(noise=True)
    c = tengine.init_carry(cfg, data, _gen())
    assert c.noise_total is None
    for _ in range(STEPS):
        c, _ = tengine.mpc_step(cfg, data, c)
    assert (carry1.noise_offset, carry1.noise_total) == (0, B)
    for k, v in _tensors(c).items():
        assert torch.equal(v, getattr(carry1, k)), k
    assert torch.equal(c.generator.get_state(), carry1.generator.get_state())


# ---- checkpoints ----

def test_sweep_kill_resume_is_bitwise_single_rank(tmp_path):
    """Kill a checkpointed sweep after 3 of 6 steps, resume: the final
    carry (plant noise and the generator's state included) equals the
    uninterrupted run's bit for bit, and the summary's last steps too."""
    cfg, data = _batch(noise=True, b=8)
    mesh = mesh_lib.make_mesh()
    ref, s_ref = distributed.sweep(cfg, data, mesh, n_steps=6,
                                   generator=_gen())
    path = str(tmp_path / "sweep_ckpt.npz")
    distributed.sweep(cfg, data, mesh, n_steps=3, generator=_gen(),
                      checkpoint_path=path, checkpoint_every=3)
    with np.load(path) as f:
        assert int(f["step"]) == 3
    got, s_got = distributed.sweep(cfg, data, mesh, n_steps=6,
                                   generator=_gen(), checkpoint_path=path,
                                   checkpoint_every=3)
    assert _carries_equal(got, ref)
    for a, b in zip(s_got, s_ref):
        assert torch.equal(a[3:], b[3:])
        assert not a[:3].any()                  # zero-filled before resume
    with np.load(path) as f:
        assert int(f["step"]) == 6


def test_sweep_kill_resume_is_bitwise_with_per_rank_files(two_ranks):
    out, ranks = two_ranks
    for r, res in enumerate(ranks):
        assert int(res["step_after_kill"]) == 3
        assert int(res["step_after_resume"]) == 6
        assert bool(res["resumed_bitwise"]), r
        assert os.path.exists(out / f"ckpt.proc{r}.npz")


def test_ranks_start_again_when_one_file_is_missing(two_ranks):
    """Rank 1's file removed: the all-gathered steps disagree, so BOTH
    ranks start from 0 (a first step that is reported, not zero-filled)."""
    _, ranks = two_ranks
    for res in ranks:
        assert float(res["restart_first_obj"]) > 0


def test_sweep_checkpoint_cadence(tmp_path, monkeypatch):
    """``checkpoint_every`` is honoured: a 5-step sweep with k = 2 saves
    after every chunk (2, 4, 5)."""
    cfg, data = _batch(noise=False, b=4)
    saved = []
    real = checkpoint.save
    monkeypatch.setattr(checkpoint, "save", lambda p, c, k: (
        saved.append(k), real(p, c, k)))
    distributed.sweep(cfg, data, mesh_lib.make_mesh(), n_steps=5,
                      checkpoint_path=str(tmp_path / "cadence.npz"),
                      checkpoint_every=2, resume=False)
    assert saved == [2, 4, 5]


def test_load_sharded_refuses_another_rank_count(tmp_path, monkeypatch):
    cfg, data = _batch(noise=False, b=4)
    carry = tengine.init_carry(cfg, data)
    path = str(tmp_path / "c.npz")
    monkeypatch.setattr(checkpoint, "_world", lambda: (0, 2))
    checkpoint.save_sharded(path, carry, 3, 0, 8)
    with np.load(checkpoint.proc_path(path, 0)) as f:
        assert int(f["process_count"]) == 2
        assert tuple(f["gshape_state"]) == (8,) + tuple(carry.state.shape[1:])
    got, step = checkpoint.load_sharded(path, carry, 0, 8)
    assert step == 3 and torch.equal(got.state, carry.state)
    with pytest.raises(ValueError, match="block at"):
        checkpoint.load_sharded(path, carry, 4, 8)
    monkeypatch.setattr(checkpoint, "_world", lambda: (0, 1))
    with pytest.raises(ValueError, match="ranks"):
        checkpoint.load_sharded(path, carry, 0, 8)


# ---- the mesh and the guards ----

def test_shard_batch_divisibility_guard():
    m = mesh_lib.Mesh({"data": 8, "model": 1}, data_index=3)
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.shard_batch({"x": torch.zeros((12, 3))}, m)
    blk = mesh_lib.shard_batch({"x": torch.arange(16.0)[:, None]}, m)
    assert blk["x"].flatten().tolist() == [6.0, 7.0]


@pytest.mark.parametrize("what", ["side_selection", "phases"])
def test_sweep_refuses_a_model_axis_with(what):
    cfg, data = _batch(noise=False, b=4)
    m = mesh_lib.Mesh({"data": 1, "model": 2})
    if what == "side_selection":
        cfg = cfg.replace(controller="side_selection")
        with pytest.raises(ValueError, match="requires the SCP controller"):
            distributed.sweep(cfg, data, m, n_steps=1)
    else:
        with pytest.raises(ValueError, match="incompatible"):
            distributed.sweep(cfg, data, m, n_steps=1, phases=((2, 1),))


def test_make_mesh_without_a_process_group():
    m = mesh_lib.make_mesh()
    assert m.shape == {"data": 1, "model": 1}
    assert m.groups == {"data": None, "model": None}
    t = torch.arange(3.0)
    assert mesh_lib.all_reduce(t, None) is t
    with pytest.raises(ValueError, match="needs at least that many"):
        mesh_lib.make_mesh(n_model=2)
    assert distributed.initialize() is None and not dist.is_initialized()


def test_sharded_batch_run_sums_metrics_over_the_batch():
    cfg, data = _batch(noise=False, b=4)

    def per_batch(d):
        c, out = tengine.mpc_step(cfg, d, tengine.init_carry(cfg, d))
        return c.state, (out.obj, out.max_violation)

    m = mesh_lib.make_mesh()
    states, metrics = mesh_lib.sharded_batch_run(per_batch, m)(
        mesh_lib.shard_batch(data, m))
    ref_states, (obj, _) = per_batch(data)
    assert torch.equal(states, ref_states)
    assert torch.equal(metrics[0], obj.sum(dim=0))


# ---- cli sweep ----

def test_cli_sweep_two_ranks_print_the_one_rank_summary(monkeypatch):
    """``torchrun``-style 2 ranks of ``cli sweep --cpu --f64``: both print
    the summary that one process prints for the same flags (the mesh
    aside). Each rank on one thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    argv = ["sweep", "--cpu", "--f64", "--n-veh", "3", "--hp", "4",
            "--batch", "4", "--steps", "2", "--seed", "1"]
    res = distributed.launch_local(["-m", "scp_tpu_torch.cli"] + argv, 2,
                                   timeout=JOB_TIMEOUT)
    outs = []
    for r in res:
        assert r["returncode"] == 0, r["stderr"][-3000:]
        outs.append(json.loads(r["stdout"]))
    from scp_tpu_torch import cli
    one = cli.main(argv)
    assert outs[0]["mesh"] == {"data": 2, "model": 1}
    for o in outs:
        for k in ("scenario", "batch", "steps", "feasible_frac",
                  "mean_scp_iters"):
            assert o[k] == one[k], k
        np.testing.assert_allclose(o["mean_obj"], one["mean_obj"],
                                   rtol=1e-13)


if __name__ == "__main__":
    torch.set_num_threads(1)
    distributed.initialize(backend="gloo", timeout=GROUP_TIMEOUT)
    try:
        JOBS[sys.argv[1]](sys.argv[2])
    finally:
        dist.destroy_process_group()
