"""The banded KKT path past 24 vehicles: one banded QP of the port against
``scp_tpu``'s on the same numpy-seeded circle-25 SCP-iteration QP (float64,
iterates within 1e-8, iteration counts equal), and the calibrated
circle-25 step routed to the banded branch at hp = 10, as ``scp_tpu``'s
route takes it there. ``scp_tpu``'s banded QP traces its V x V Cholesky
unrolled (~100 s at V = 25 on the CPU); it is compiled once.
"""
import jax
import numpy as np
import pytest
import torch

from scp_tpu.solvers import qp as jqp
from scp_tpu_torch import config as config_lib
from scp_tpu_torch.scenarios import batch as batch_lib
from scp_tpu_torch.sim import engine as tengine
from scp_tpu_torch.solvers import qp as tqp

from torch_parity import assert_close, jit_fast, scp_qp_data

DENSE_KEYS = ("P", "q", "G", "h", "lb", "ub", "x0")


def test_banded_qp_circle25_matches_scp_tpu_float64():
    ja, ta = scp_qp_data("circle", 2, 6, np.float64, banded=True, n_veh=25)
    kw = dict(fixed_iters=6, tol=1e-8)

    def one(P, q, G, h, lb, ub, x0, bd):
        return jqp.solve_qp(P, q, G, h, lb, ub, x0=x0, banded=bd, **kw)
    args = [ja[k] for k in DENSE_KEYS] + [ja["banded"]]
    want = jit_fast(jax.vmap(one), *args)(*args)
    got = tqp.solve_qp_batched(
        None, ta["q"], None, ta["h"], ta["lb"], ta["ub"], x0=ta["x0"],
        p_blocks=ta["p_blocks"], slack_schur=True, g_struct=ta["g_struct"],
        g_slabs=ta["g_slabs"], banded=ta["banded"], kkt="banded", **kw)
    assert ta["banded"].a_blk.shape[1] == 25
    assert_close(got.x, want.x, 1e-8, name="x")
    assert_close(got.z, want.z, 1e-8 * float(np.abs(want.z).max()),
                 name="z")
    assert_close(got.iters, want.iters, 0, name="iters")
    assert_close(got.converged, want.converged, 0, name="converged")


class _Routed(Exception):
    pass


@pytest.mark.parametrize("n_veh", [25, 32])
def test_calibrated_wide_circle_routes_to_banded(monkeypatch, n_veh):
    """The calibrated float32 settings (``qp_kkt="auto"``, 7 fixed IPM
    iterations) on a circle of 25 / 32 vehicles at hp = 10: K1's shared
    tier does not hold the KKT matrix, so the first QP of the step takes
    the banded branch (K6 / K7 on the card)."""
    routes = []
    real = tqp._route

    def spy(*a, **k):
        routes.append(real(*a, **k))
        raise _Routed
    monkeypatch.setattr(tqp, "_route", spy)
    gen = torch.Generator().manual_seed(0)
    cfg, data = batch_lib.make_batch("circle", 1, generator=gen,
                                     dtype=torch.float32, device="cpu",
                                     n_veh=n_veh)
    cfg = config_lib.tuned_f32(cfg.replace(hp=10, hu=10))
    assert cfg.qp_kkt == "auto" and cfg.qp_fixed_iters == 7
    with pytest.raises(_Routed):
        tengine.mpc_step_batch(cfg, data, tengine.init_carry(cfg, data),
                               phases=config_lib.TUNED_F32_PHASES)
    assert routes == ["banded"]
