"""Helpers shared by the ``test_torch_*`` parity tests: the same inputs go
through a ``scp_tpu`` (JAX) function and its ``scp_tpu_torch`` counterpart on
the CPU, and the results are compared as numpy arrays."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from scp_tpu.scenarios import batch as jbatch
from scp_tpu.sim import engine as jengine
from scp_tpu_torch import convert

TDT = {np.float64: torch.float64, np.float32: torch.float32}
JDT = {np.float64: jnp.float64, np.float32: jnp.float32}


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
