"""The dense-G fused fixed-iteration branch of ``solve_qp_batched`` (the
dense-G iteration K2, ``ops/ipm_kernel.py::ipm_iterate_dense``), single-vehicle
frog through the batched step, ``solve_scp_multistart`` and
``utils.debug.scp_iteration_trace`` against ``scp_tpu``'s, on the CPU.

Tolerances: float32 against ``scp_tpu``'s fused branch with the Pallas
kernel in interpret mode 5e-5 on the controls (radians, box +-0.052; the
limit ``tests/test_qp_batched.py`` holds that branch to against its own
vmap) — both sides sum in other orders, and the port eliminates the slack
border whenever asked where ``scp_tpu`` does so only when (n-1) % 8 == 0;
one iteration against ``pallas_linalg.ipm_iterate_lane`` itself 1e-5 on
every state entry; float64 steps and SCP results 5e-6 rad (the limit of the
port's other chained-step tests) with every integer and flag equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.ops import pallas_linalg as jpll
from scp_tpu.scenarios import builders as jbuilders
from scp_tpu.sim import engine as jengine
from scp_tpu.solvers import qp as jqp
from scp_tpu.solvers import scp as jscp
from scp_tpu.utils import debug as jdebug
from scp_tpu_torch import config as tconfig, convert
from scp_tpu_torch.ops import ipm_kernel
from scp_tpu_torch.scenarios import builders as tbuilders
from scp_tpu_torch.sim import engine as tengine
from scp_tpu_torch.solvers import qp as tqp
from scp_tpu_torch.solvers import scp as tscp
from scp_tpu_torch.testing import DENSE_ARG_ORDER, dense_kernel_inputs
from scp_tpu_torch.utils import debug as tdebug

from torch_parity import (assert_close, jax_problem, scenario_pair,
                          scp_qp_data, tonp)


def _interpret(fn):
    old = jpll.INTERPRET
    jpll.INTERPRET = True
    try:
        return fn()
    finally:
        jpll.INTERPRET = old


@pytest.mark.parametrize("hp,blocks,schur,n_cor,warm", [
    (5, True, True, 0, False),     # scp_tpu: no Schur border (4 % 8)
    (8, True, True, 1, True),      # both eliminate the slack
    (5, False, False, 1, False),   # dense P, nothing eliminated
    (8, False, True, 0, True),     # dense P, both eliminate the slack
])
def test_dense_branch_matches_pallas_interpret(hp, blocks, schur, n_cor,
                                               warm):
    ja, ta = scp_qp_data("frog", 2, hp, np.float32)
    n = ta["q"].shape[1]
    m = ta["h"].shape[1] + 2 * n
    z0 = np.abs(np.random.default_rng(hp).normal(size=(2, m))) \
        .astype(np.float32) if warm else None
    kw = dict(fixed_iters=6, tol=1e-6, correctors=n_cor, slack_schur=schur)
    want = _interpret(lambda: jqp.solve_qp_batched(
        ja["P"], ja["q"], ja["G"], ja["h"], ja["lb"], ja["ub"], x0=ja["x0"],
        z0=None if z0 is None else jnp.asarray(z0), use_pallas=True,
        p_blocks=ja["p_blocks"] if blocks else None, **kw))
    ipm_kernel.reset_launch_count()
    got = tqp.solve_qp_batched(
        None if blocks else ta["P"], ta["q"], ta["G"], ta["h"], ta["lb"],
        ta["ub"], x0=ta["x0"],
        z0=None if z0 is None else torch.as_tensor(z0),
        p_blocks=ta["p_blocks"] if blocks else None,
        g_struct=ta["g_struct"], g_slabs=ta["g_slabs"], kkt="auto", **kw)
    assert ipm_kernel.launch_count == 0          # CPU: the plain version
    assert got.x.dtype == torch.float32
    nu = n - 1
    np.testing.assert_allclose(got.x[:, :nu].numpy(),
                               np.asarray(want.x)[:, :nu], atol=5e-5)
    # (the slack, ~1e-6 here, enters the objective with weight 1e5: the
    # objective of a float32 solve is not compared)
    np.testing.assert_allclose(got.x[:, nu].numpy(),
                               np.asarray(want.x)[:, nu], rtol=1e-3,
                               atol=1e-4)


def _lane(a, rows):
    """(B, d) numpy -> (rows, B) lane layout, zero padded."""
    out = np.zeros((rows, a.shape[0]), np.float32)
    out[:a.shape[1]] = a.T
    return jnp.asarray(out)


@pytest.mark.parametrize("schur,blocks", [(True, True), (False, False)])
def test_plain_iteration_matches_ipm_iterate_lane(schur, blocks):
    """One iteration of the plain dense-G version against the Pallas kernel
    itself (interpret mode) on the same inputs, laid out as the TPU kernel
    takes them (lanes of 128 instances, padded rows)."""
    B, mg, nb, d = 128, 12, 1, 8
    n = nb * d + 1
    a = dense_kernel_inputs(B, mg, nb, d, seed=3, schur=schur, blocks=blocks)
    n_pad, mg_pad = jpll.pad_dim(n), jpll._pad_to(mg, jpll._MV_MB)
    K = a["K"]
    if not schur:
        Kp = np.zeros((B, n_pad, n_pad), np.float32)
        Kp[:, :n, :n] = K
        Kp[:, np.arange(n, n_pad), np.arange(n, n_pad)] = 1.0
        K = Kp
    G_lane = np.zeros((mg_pad, n_pad, B), np.float32)
    G_lane[:mg, :n] = a["G"].transpose(1, 2, 0)

    def vec(name, rows, fill):
        out = np.full((rows, B), fill, np.float32)
        out[:a[name].shape[1]] = a[name].T
        return jnp.asarray(out)

    ones_n, ones_m = (n_pad, 1.0), (mg_pad, 1.0)
    args = [jnp.asarray(K.transpose(1, 2, 0)), jnp.asarray(G_lane),
            None if blocks else _lane(a["px"], n_pad), _lane(a["q"], n_pad),
            vec("pdiag", *ones_n), _lane(a["x"], n_pad), vec("sg", *ones_m),
            vec("su", *ones_n), vec("sl", *ones_n), _lane(a["zg"], mg_pad),
            _lane(a["zu"], n_pad), _lane(a["zl"], n_pad),
            _lane(a["rpg"], mg_pad), _lane(a["rpu"], n_pad),
            _lane(a["rpl"], n_pad), _lane(a["scal"], 8)]
    kw = dict(tol=1e-6, reg_rel=3e-6, n_cor=1)
    want = _interpret(lambda: jpll.ipm_iterate_lane(
        *args, mg=mg, n=n, m_true=mg + 2 * n, schur_slack=schur,
        pb=None if not blocks else jnp.asarray(
            a["pb"].transpose(1, 2, 3, 0)), **kw))
    t = [None if a[k] is None else torch.as_tensor(a[k])
         for k in DENSE_ARG_ORDER]
    got = ipm_kernel.ipm_iterate_dense_plain(*t, schur_slack=schur, **kw)
    rows = (n, mg, n, n, mg, n, n, mg, n, n, 2)
    for i, (g, w, r) in enumerate(zip(got, want, rows)):
        w = np.asarray(w)[:r].T
        if i == 0:   # x: the slack entry lives on a scale of its own
            np.testing.assert_allclose(g[:, :-1].numpy(), w[:, :-1],
                                       atol=1e-5)
            np.testing.assert_allclose(g[:, -1].numpy(), w[:, -1],
                                       rtol=1e-4)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5,
                                       err_msg=str(i))


def test_frog_mpc_step_batch_tuned_f32_float64():
    """Single-vehicle frog through mpc_step_batch under tuned_f32 (7 fixed
    IPM iterations, qp_kkt="auto": no vehicle pair, so the dense-G fused
    branch), hp = 5, float64, two chained steps against scp_tpu's step."""
    cfg_j, data_j, cfg_t, data_t = scenario_pair(
        "frog", 3, 5, np.float64, cfg_over=dict(hp=5, hu=5))
    cfg_j = cfg_j.replace(**{k: v for k, v in
                             tconfig.TUNED_F32_OVERRIDES.items()})
    cfg_t = tconfig.tuned_f32(cfg_t)
    phases = tconfig.TUNED_F32_PHASES
    carry_j = jax.vmap(lambda d: jengine.init_carry(cfg_j, d))(data_j)
    step_j = jax.jit(functools.partial(jengine.mpc_step_batch, cfg_j,
                                       phases=phases))
    c_t = tengine.init_carry(cfg_t, data_t)
    for i in range(2):
        carry_j, out_j = step_j(data_j, carry_j)
        c_t, out_t = tengine.mpc_step_batch(cfg_t, data_t, c_t,
                                            phases=phases)
        assert_close(out_t.u_pred, out_j.u_pred, 5e-6, name=f"u_pred {i}")
        for f in ("feasible", "converged", "scp_iters", "qp_iters"):
            assert_close(getattr(out_t, f), getattr(out_j, f), 0,
                         name=f"{f} {i}")


def test_solve_scp_multistart_matches_scp_tpu_on_frog():
    cfg_j, data_j, _, _ = scenario_pair("frog", 2, 9, np.float64,
                                        cfg_over=dict(hp=5, hu=5))
    problem_j, _, carry_j = jax_problem(cfg_j, data_j)
    problem_t = convert.problem_from_numpy(tonp(problem_j), torch.float64,
                                           "cpu")
    u0 = np.random.default_rng(9).uniform(-0.02, 0.02, size=(2, 5))
    kw = dict(u_lim=cfg_j.u_lim, max_scp_iter=4, qp_tol=1e-9,
              qp_max_iter=25)
    want = jax.jit(jax.vmap(
        lambda p, u: jscp.solve_scp_multistart(p, u, **kw)))(
        problem_j, jnp.asarray(u0))
    got = tscp.solve_scp_multistart(problem_t, torch.as_tensor(u0), **kw)
    assert_close(got.u, want.u, 5e-6, name="u")
    for f in ("feasible", "converged", "iters", "qp_iters", "qp_fails"):
        assert_close(getattr(got, f), getattr(want, f), 0, name=f)
    # the winner is one of the three starts' own results
    one = tscp.solve_scp(problem_t, torch.as_tensor(u0), **kw)
    better = (~one.feasible & got.feasible) | (got.obj <= one.obj + 1e-12)
    assert bool(better.all())


def test_scp_iteration_trace_matches_scp_tpu_on_frog():
    cfg_j, data_j = jbuilders.frog(dtype=jnp.float64)
    cfg_j = cfg_j.replace(hp=5, hu=5, max_scp_iter=5)
    cfg_t, data_t = tbuilders.frog(dtype=torch.float64, device="cpu",
                                   hp=5, hu=5, max_scp_iter=5)
    want = jdebug.scp_iteration_trace(cfg_j, data_j)
    got = tdebug.scp_iteration_trace(cfg_t, data_t)
    assert got.keys() == want.keys()
    assert got["iters"] == want["iters"] and got["iters"] >= 1
    assert got["feasible"] == want["feasible"]
    np.testing.assert_array_equal(got["qp_converged"], want["qp_converged"])
    for k in ("obj", "max_violation", "merit", "delta"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["u"], want["u"], atol=5e-6)
    with pytest.raises(ValueError, match="ONE scenario"):
        tdebug.scp_iteration_trace(
            cfg_t, convert.scenario_from_numpy(
                tonp(jax.tree_util.tree_map(lambda x: jnp.stack([x, x]),
                                            data_j)), torch.float64, "cpu"))
