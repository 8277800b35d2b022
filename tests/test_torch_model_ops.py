"""Model and pre-processing ops of the port against scp_tpu on the same
numpy-seeded inputs (float64 on the CPU). Tolerances are the ones scp_tpu
itself was held to against the original controller: model 1e-12, ZOH and
Jacobian 1e-9, condensed matrices 1e-8, reference sampling 1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.models import bicycle as jbic
from scp_tpu.ops import condensed as jcond
from scp_tpu.ops import discretize as jdisc
from scp_tpu.ops import reference_path as jref
from scp_tpu_torch.models import bicycle as tbic
from scp_tpu_torch.ops import condensed as tcond
from scp_tpu_torch.ops import discretize as tdisc
from scp_tpu_torch.ops import reference_path as tref

from torch_parity import assert_close

B, V = 5, 3


def _states(seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((B, V, 6))
    x[..., 0:2] = rng.normal(size=(B, V, 2)) * 20
    x[..., 2] = rng.uniform(-3, 3, size=(B, V))
    x[..., 3] = rng.uniform(1.0, 8.0, size=(B, V))
    x[..., 4] = rng.normal(size=(B, V)) * 0.3
    x[..., 5] = rng.uniform(-0.05, 0.05, size=(B, V))
    u = rng.uniform(-0.05, 0.05, size=(B, V))
    lf = 0.34 + rng.uniform(0, 0.1, size=(B, V))
    lr = 0.34 + rng.uniform(0, 0.1, size=(B, V))
    return x, u, lf, lr


def _t(*arrs):
    return [torch.as_tensor(np.array(a)) for a in arrs]


def _vv(fn):            # vmap over instances and vehicles
    return jax.vmap(jax.vmap(fn))


def test_ode():
    x, u, lf, lr = _states()
    assert_close(tbic.ode(*_t(x, u, lf, lr)), _vv(jbic.ode)(x, u, lf, lr),
                 1e-12)


def test_rk4_step():
    x, u, lf, lr = _states(1)
    want = _vv(lambda a, b, c, d: jbic.rk4_step(a, b, c, d, 0.01))(x, u, lf, lr)
    assert_close(tbic.rk4_step(*_t(x, u, lf, lr), 0.01), want, 1e-12)


@pytest.mark.parametrize("substeps", [1, 4])
def test_integrate(substeps):
    x, u, lf, lr = _states(2)
    want = _vv(lambda a, b, c, d: jbic.integrate(
        a, b, c, d, h=0.43 / 9, n_steps=9, substeps=substeps))(x, u, lf, lr)
    got = tbic.integrate(*_t(x, u, lf, lr), h=0.43 / 9, n_steps=9,
                         substeps=substeps)
    assert_close(got, want, 1e-12)


def test_linearize_written_out_equals_autodiff():
    """The port writes the Jacobian out; scp_tpu takes it by jacfwd."""
    x, u, lf, lr = _states(3)
    want = _vv(jbic.linearize)(x, u, lf, lr)
    got = tbic.linearize(*_t(x, u, lf, lr))
    for g, w, name in zip(got, want, ("Ac", "Bc", "Ec")):
        assert_close(g, w, 1e-12, rtol=1e-12, name=name)


def test_output_matrix_and_init_state():
    assert_close(tbic.output_matrix(torch.float64), jbic.output_matrix(), 0)
    assert_close(
        tbic.make_init_state(1.0, 2.0, 0.3, 4.0, device="cpu"),
        jbic.make_init_state(1.0, 2.0, 0.3, 4.0), 0)


def test_expm_taylor():
    rng = np.random.default_rng(4)
    M = rng.normal(size=(B, 8, 8)) * 1.5
    want = jax.vmap(jdisc._expm_taylor)(M)
    assert_close(tdisc._expm_taylor(torch.as_tensor(M)), want, 1e-9,
                 rtol=1e-12)


def test_zoh_and_linearize_and_discretize():
    x, u, lf, lr = _states(5)
    want = _vv(lambda a, b, c, d: jdisc.linearize_and_discretize(
        a, b, c, d, 0.4))(x, u, lf, lr)
    got = tdisc.linearize_and_discretize_batch(*_t(x, u, lf, lr), 0.4)
    for g, w, name in zip(got, want, ("Ad", "Bd", "Ed")):
        assert_close(g, w, 1e-9, name=name)
    Ac, Bc, Ec = _vv(jbic.linearize)(x, u, lf, lr)
    want = _vv(lambda a, b, c: jdisc.zoh(a, b, c, 0.4))(Ac, Bc, Ec)
    got = tdisc.zoh(*_t(Ac, Bc, Ec), 0.4)
    for g, w in zip(got, want):
        assert_close(g, w, 1e-9)


@pytest.mark.parametrize("hp,hu", [(6, 6), (8, 5)])
def test_build_condensed(hp, hu):
    x, u, lf, lr = _states(6)
    rng = np.random.default_rng(7)
    A, Bm, E = _vv(lambda a, b, c, d: jdisc.linearize_and_discretize(
        a, b, c, d, 0.4))(x, u, lf, lr)
    ref = rng.normal(size=(B, V, hp * 2)) * 10
    qw = rng.uniform(0.5, 2, size=(B, V))
    rw = rng.uniform(1e3, 5e3, size=(B, V))
    qf = rng.uniform(10, 30, size=(B, V))
    want = _vv(lambda *a: jcond.build_condensed(*a, hp, hu))(
        A, Bm, E, x, ref, qw, rw, qf)
    got = tcond.build_condensed_batch(*_t(A, Bm, E, x, ref, qw, rw, qf),
                                      hp, hu)
    for name in want._fields:
        w = np.asarray(getattr(want, name))
        # 1e-8 absolute on entries of order one; the cost matrices carry the
        # r weight (~5e3) and squared errors (~1e4), so relative there
        assert_close(getattr(got, name), w, 1e-8, rtol=1e-10, name=name)


def _polylines(seed, n_pts):
    rng = np.random.default_rng(seed)
    pts = np.cumsum(rng.uniform(2, 8, size=(B, V, n_pts, 2)), axis=2)
    valid = np.ones((B, V, n_pts), bool)
    if n_pts > 2:               # pad some polylines with a repeated vertex
        valid[::2, :, -1] = False
        pts[::2, :, -1] = pts[::2, :, -2]
    pos = pts[:, :, 0] + rng.normal(size=(B, V, 2)) * 3
    pos[0] = pts[0, :, -1] + 5.0        # past the end of the line
    pos[1] = pts[1, :, 0] - 5.0         # before the start
    step = rng.uniform(0.8, 2.5, size=(B, V))
    return pts, valid, pos, step


@pytest.mark.parametrize("n_pts", [2, 4])
def test_project_to_polyline(n_pts):
    pts, valid, pos, _ = _polylines(8, n_pts)
    want = _vv(jref.project_to_polyline)(pts, valid, pos)
    got = tref.project_to_polyline(*_t(pts, valid, pos))
    assert_close(got[0], want[0], 1e-10, name="arclength")
    assert_close(got[1], want[1], 1e-10, name="distance")


@pytest.mark.parametrize("n_pts", [2, 4])
@pytest.mark.parametrize("end_compat", [True, False])
def test_sample_reference(n_pts, end_compat):
    pts, valid, pos, step = _polylines(9, n_pts)
    hp = 12                              # long enough to run off the end
    want = _vv(lambda a, b, c, d: jref.sample_reference(
        a, b, c, d, hp, end_compat))(pts, valid, pos, step)
    got = tref.sample_reference_batch(*_t(pts, valid, pos, step), hp,
                                      end_compat)
    assert_close(got, want, 1e-10)
