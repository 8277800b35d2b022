"""Helpers shared by the ``test_torch_*`` parity tests: the same inputs go
through a ``scp_tpu`` (JAX) function and its ``scp_tpu_torch`` counterpart on
the CPU, and the results are compared as numpy arrays."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from scp_tpu.ops import constraints as jcon
from scp_tpu.scenarios import batch as jbatch
from scp_tpu.sim import engine as jengine
from scp_tpu_torch import convert

TDT = {np.float64: torch.float64, np.float32: torch.float32}
JDT = {np.float64: jnp.float64, np.float32: jnp.float32}


# XLA's cheapest compile, for a reference that runs once or twice on small
# shapes: there the compile, not the run, is what a test pays for
# (float64 outputs of the side-selection controller agree with the
# optimised build's to 1e-16, and every integer is the same)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jit_fast(fn, *args):
    """``jax.jit(fn)`` lowered for ``args`` and compiled with FAST_COMPILE;
    the compiled function takes the same positional arguments."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)


def tonp(tree):
    """numpy copy of every leaf of a JAX pytree."""
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_close(t_val, j_val, atol, rtol=0.0, name=""):
    """Port value (tensor) against JAX value, exact for bool / int."""
    a = t_val.detach().cpu().numpy() if isinstance(t_val, torch.Tensor) \
        else np.asarray(t_val)
    b = np.asarray(j_val)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype == bool or a.dtype.kind in "iu":
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=name)


def scenario_pair(kind, b, seed, np_dtype=np.float64, cfg_over=None, **kw):
    """The same randomized batch in both packages: built by ``scp_tpu`` and
    converted. Returns ``(cfg_j, data_j, cfg_t, data_t)``."""
    cfg_j, data_j = jbatch.make_batch(
        kind, b, key=jax.random.PRNGKey(seed), dtype=JDT[np_dtype], **kw)
    if cfg_over:
        cfg_j = cfg_j.replace(**cfg_over)
    cfg_t = convert.config_from_dict(dataclasses.asdict(cfg_j))
    data_t = convert.scenario_from_numpy(tonp(data_j), TDT[np_dtype], "cpu")
    return cfg_j, data_j, cfg_t, data_t


def jax_problem(cfg_j, data_j):
    """``controller_pre`` of ``scp_tpu`` over the batch: (problem, aux,
    carry), all with a leading batch axis."""
    carry = jax.vmap(lambda d: jengine.init_carry(cfg_j, d))(data_j)
    problem, aux = jax.jit(jax.vmap(
        lambda d, c: jengine.controller_pre(cfg_j, d, c)))(data_j, carry)
    return problem, aux, carry


U_LIM, SLACK_W, SLACK_UB = np.pi / 180 * 3, 1e5, 1e8


def scp_qp_data(kind, b, hp, np_dtype, seed=2, banded=False, **kw):
    """One SCP iteration's QP in both packages' argument forms; with
    ``banded`` also its stage statement (``BandedData``) under the key
    ``banded``."""
    over = dict(hp=hp, hu=hp, qp_kkt="auto" if banded else "dense")
    cfg_j, data_j, _, _ = scenario_pair(kind, b, seed, np_dtype,
                                        cfg_over=over, **kw)
    problem, _, _ = jax_problem(cfg_j, data_j)
    v, n_obst = cfg_j.n_veh, cfg_j.n_obst
    n = v * hp
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.02, 0.02, size=(b, n)).astype(np_dtype)
    gi, gj, gob, rhs = jax.vmap(jcon.linearize_slabs)(problem.sys, u)
    G = jax.vmap(lambda a, c, d: jcon.scatter_slabs(v, a, c, d))(gi, gj, gob)
    G = jnp.concatenate([G, -jnp.ones(G.shape[:2] + (1,), G.dtype)], axis=2)
    pb = 2.0 * problem.phi0
    P = jnp.zeros((b, n + 1, n + 1), pb.dtype)
    for i in range(v):
        P = P.at[:, i * hp:(i + 1) * hp, i * hp:(i + 1) * hp].set(pb[:, i])
    one = np.ones((b, 1), np_dtype)
    q = np.concatenate([np.asarray(problem.psi0).reshape(b, n),
                        SLACK_W * one], 1)
    lb = np.concatenate([np.full((b, n), -U_LIM, np_dtype), 0 * one], 1)
    ub = np.concatenate([np.full((b, n), U_LIM, np_dtype), SLACK_UB * one], 1)
    x0 = np.concatenate([u, 0 * one], 1)
    g_struct = (tuple(jcon._static_pairs(v)),
                tuple(vv for vv in range(v) for _ in range(n_obst)),
                hp, hp, True)
    jax_args = dict(P=P, q=q, G=G, h=rhs, lb=lb, ub=ub, x0=x0, p_blocks=pb,
                    g_struct=g_struct, g_slabs=(gi, gj, gob))
    tt = lambda a: torch.as_tensor(np.array(a))     # noqa: E731
    t_args = dict(P=tt(P), q=tt(q), G=tt(G), h=tt(rhs), lb=tt(lb), ub=tt(ub),
                  x0=tt(x0), p_blocks=tt(pb), g_struct=g_struct,
                  g_slabs=(tt(gi), tt(gj), tt(gob)))
    if banded:
        from scp_tpu.solvers import qp as jqp
        from scp_tpu_torch.solvers import qp as tqp
        yp, yo = jax.vmap(jcon.linearize_ycoefs)(problem.sys, u)
        a_blk, b_blk, qy, ru = problem.banded_pre
        jax_args["banded"] = jqp.BandedData(a_blk, b_blk, yp, yo, qy, ru)
        t_args["banded"] = tqp.BandedData(
            *[tt(a) for a in (a_blk, b_blk, yp, yo, qy, ru)])
    return jax_args, t_args


def assert_stripes_cover(n, C):
    """The cluster factor's deal (``linalg_kernel.stripe_deal``): every
    entry of the n x n lower triangle in exactly one 16-row stripe, each
    rank's stripes disjoint and within its area."""
    from scp_tpu_torch.ops import linalg_kernel as lk
    owner, offset, area = lk.stripe_deal(n, C)
    used = [set() for _ in range(C)]
    seen = np.zeros((n, n), dtype=int)
    for s, (q, off) in enumerate(zip(owner, offset)):
        rows, ld = min(16, n - 16 * s), 16 * (s + 1) + 1
        assert rows * ld == lk.stripe_words(n, s) and 0 <= q < C
        span = set(range(off, off + rows * ld))
        assert not span & used[q] and off + rows * ld <= area
        used[q] |= span
        for r in range(rows):
            seen[16 * s + r, :16 * s + r + 1] += 1
    assert (seen[np.tril_indices(n)] == 1).all()
    assert (seen[np.triu_indices(n, 1)] == 0).all()
    assert area == max(len(u) for u in used)

