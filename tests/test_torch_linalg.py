"""Batched Cholesky, Cholesky solve and the two G matvecs of the port
(ops/linalg.py plain versions, ops/linalg_kernel.py wrappers — which run the
plain versions on the CPU) against numpy in float64 and against scp_tpu's
Pallas kernels in interpret mode in float32.

Tolerances: float64 against numpy 1e-12 relative to the result's scale (two
LAPACK-style routines on well-conditioned matrices); float32 against the
Pallas kernels 2e-5 relative to the result's scale (both sides accumulate n
or m float32 products in different orders; n <= 24, m <= 40 here). Factors
are compared on their lower triangles only: scp_tpu's kernel leaves garbage
above the diagonal, the port writes zeros there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.ops import pallas_linalg as pll
from scp_tpu_torch.ops import linalg as tl
from scp_tpu_torch.ops import linalg_kernel as tk

F32_REL = 2e-5


def _spd(rng, b, n, dtype):
    a = rng.normal(size=(b, n, n))
    return (a @ a.transpose(0, 2, 1) / n + np.eye(n)).astype(dtype)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture
def interpret():
    old = pll.INTERPRET
    pll.INTERPRET = True
    yield
    pll.INTERPRET = old


@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (3, 31, 45), (5, 16, 24)])
def test_plain_versions_match_numpy_f64(b, n, m):
    rng = np.random.default_rng(n)
    K = _spd(rng, b, n, np.float64)
    rhs = rng.normal(size=(b, n))
    G = rng.normal(size=(b, m, n))
    v = rng.normal(size=(b, m))
    L = tl.cholesky_plain(torch.as_tensor(K))
    assert _rel(L, np.linalg.cholesky(K)) < 1e-12
    assert float(torch.triu(L, diagonal=1).abs().max()) == 0.0
    x = tl.cho_solve_plain(L, torch.as_tensor(rhs))
    assert _rel(x, np.linalg.solve(K, rhs[..., None])[..., 0]) < 1e-12
    # only the lower triangle of the factor is read
    junk = L + torch.triu(torch.full_like(L, 7.0), diagonal=1)
    assert torch.equal(tl.cho_solve_plain(junk, torch.as_tensor(rhs)), x)
    assert _rel(tl.gmv_plain(torch.as_tensor(G), torch.as_tensor(rhs)),
                np.einsum("bmn,bn->bm", G, rhs)) < 1e-12
    assert _rel(tl.gtmv_plain(torch.as_tensor(G), torch.as_tensor(v)),
                np.einsum("bmn,bm->bn", G, v)) < 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrappers_take_the_plain_versions_on_cpu(dtype):
    """A CPU tensor of either type goes to the plain version, and no launch
    is counted."""
    rng = np.random.default_rng(0)
    K = torch.as_tensor(_spd(rng, 4, 9, np.float64)).to(dtype)
    rhs = torch.as_tensor(rng.normal(size=(4, 9))).to(dtype)
    G = torch.as_tensor(rng.normal(size=(4, 6, 9))).to(dtype)
    v = torch.as_tensor(rng.normal(size=(4, 6))).to(dtype)
    tk.reset_launch_counts()
    L = tk.cholesky(K)
    assert torch.equal(L, tl.cholesky_plain(K)) and L.dtype == dtype
    assert torch.equal(tk.cho_solve(L, rhs), tl.cho_solve_plain(L, rhs))
    assert torch.equal(tk.gmv(G, rhs), tl.gmv_plain(G, rhs))
    assert torch.equal(tk.gtmv(G, v), tl.gtmv_plain(G, v))
    assert tk.launch_counts == {"cholesky": 0, "cho_solve": 0, "gmv": 0,
                                "gtmv": 0}


@pytest.mark.parametrize("kernel", ["cholesky_lane", "cho_solve_lane",
                                    "gmv_lane", "gtmv_lane"])
def test_f32_matches_pallas_lane_kernels_interpret(kernel, interpret):
    """The lane-layout kernels (K3a, K4a, K5a, K5b) at their own alignment:
    B = 128 lanes, n = 16, m = 32."""
    b, n, m = 128, 16, 32
    rng = np.random.default_rng(3)
    K = _spd(rng, b, n, np.float32)
    rhs = rng.normal(size=(b, n)).astype(np.float32)
    G = rng.normal(size=(b, m, n)).astype(np.float32)
    v = rng.normal(size=(b, m)).astype(np.float32)
    tt = torch.as_tensor
    if kernel == "cholesky_lane":
        want = np.transpose(np.asarray(pll.cholesky_lane(jnp.asarray(K))),
                            (2, 1, 0))          # out[c, r, b] = L_b[r, c]
        got = tk.cholesky(tt(K))
        assert got.dtype == torch.float32
        assert _rel(torch.tril(got), np.tril(want)) < F32_REL
    elif kernel == "cho_solve_lane":
        Lt = pll.cholesky_lane(jnp.asarray(K))
        want = np.asarray(pll.cho_solve_lane(Lt, jnp.asarray(rhs.T))).T
        got = tk.cho_solve(tk.cholesky(tt(K)), tt(rhs))
        assert _rel(got, want) < F32_REL
    elif kernel == "gmv_lane":
        want = np.asarray(pll.gmv_lane(pll.to_lane3(jnp.asarray(G)),
                                       jnp.asarray(rhs.T))).T
        assert _rel(tk.gmv(tt(G), tt(rhs)), want) < F32_REL
    else:
        want = np.asarray(pll.gtmv_lane(pll.to_lane3(jnp.asarray(G)),
                                        jnp.asarray(v.T))).T
        assert _rel(tk.gtmv(tt(G), tt(v)), want) < F32_REL


@pytest.mark.parametrize("b,n", [(5, 13), (2, 24)])
def test_f32_matches_pallas_vmap_fronts_interpret(b, n, interpret):
    """pll.cholesky / pll.cho_solve under vmap (K3b, K4b: the same kernel
    bodies behind padding to 8 rows and 128 lanes) at sizes that need the
    padding; the port pads nothing."""
    rng = np.random.default_rng(n)
    K = _spd(rng, b, n, np.float32)
    rhs = rng.normal(size=(b, n)).astype(np.float32)
    L_j = jax.vmap(pll.cholesky)(jnp.asarray(K))
    x_j = jax.vmap(pll.cho_solve)(L_j, jnp.asarray(rhs))
    L_t = tk.cholesky(torch.as_tensor(K))
    assert _rel(torch.tril(L_t), np.tril(np.asarray(L_j))) < F32_REL
    assert _rel(tk.cho_solve(L_t, torch.as_tensor(rhs)), x_j) < F32_REL
    # the port's solve reads scp_tpu's factor (garbage above the diagonal)
    # as well as its own
    mixed = tk.cho_solve(torch.as_tensor(np.array(L_j)), torch.as_tensor(rhs))
    assert _rel(mixed, x_j) < F32_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_indefinite_instance_is_nan_and_the_others_untouched(dtype):
    """jnp.linalg.cholesky semantics: no exception, NaN for that instance
    only — so the IPM's finite check freezes it."""
    rng = np.random.default_rng(5)
    K = torch.as_tensor(_spd(rng, 4, 7, np.float64)).to(dtype)
    good = tk.cholesky(K)
    K_bad = K.clone()
    K_bad[2, 3, 3] = -1.0
    L = tk.cholesky(K_bad)
    assert bool(torch.isnan(L[2]).all())
    keep = [0, 1, 3]
    assert torch.equal(L[keep], good[keep])
    x = tk.cho_solve(L, torch.ones((4, 7), dtype=dtype))
    assert bool(torch.isnan(x[2]).all())
    assert bool(torch.isfinite(x[keep]).all())
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(K_bad.numpy())))
    assert np.isnan(np.tril(want[2])[np.tril_indices(7)]).all()
    assert np.isfinite(want[keep]).all()


def test_shared_memory_gate_threshold():
    """One instance's matrix must fit a block's 232,448 bytes of shared
    memory: n = 239 does, n = 240 does not (hp = 64 with 4 vehicles is
    n = 257: the banded path's shape)."""
    assert tk.chol_smem_bytes(81) == 4 * (81 * 81 + 81 + 1)
    assert tk.solve_smem_bytes(80) == 4 * (80 * 81 + 160)
    assert tk.check_chol_smem_gate(239) <= tk.SMEM_LIMIT_BYTES == 232_448
    for n in (240, 257):
        with pytest.raises(NotImplementedError,
                           match="banded KKT path not ported"):
            tk.check_chol_smem_gate(n)


@pytest.mark.parametrize("breakage", ["solve_shape", "mv_shape", "dtype",
                                      "empty"])
def test_wrappers_refuse_inconsistent_operands(breakage):
    K = torch.eye(4).repeat(2, 1, 1)
    G = torch.ones((2, 3, 4))
    with pytest.raises(ValueError):
        if breakage == "solve_shape":
            tk.cho_solve(K, torch.ones((2, 5)))
        elif breakage == "mv_shape":
            tk.gtmv(G, torch.ones((2, 4)))
        elif breakage == "dtype":
            tk.gmv(G, torch.ones((2, 4), dtype=torch.float64))
        else:
            tk.cholesky(torch.ones((0, 4, 4)))


def _gmv_covered(total, per_step):
    """Indices the staged G product's steps cover (its tiles over an
    instance's rows, or its stages over a row's columns), each step as the
    kernel computes it (first index, count)."""
    covered = []
    for first in range(0, total, per_step):
        covered += range(first, min(total, first + per_step))
    return covered


@pytest.mark.parametrize("kernel,B", [("cholesky", b) for b in
                                      (1, 3, 64, 1023, 1024)]
                         + [("cho_solve", b) for b in
                            (1, 3, 64, 1023, 1024)]
                         + [("gmv", b) for b in (1, 3, 64, 256, 1024)])
def test_launch_geometry(kernel, B):
    """The geometry the wrappers hand the launchers: within a block's shared
    memory, every instance, row and column computed exactly once, and the
    factor's shared-memory gate where it was (n = 239 in, n = 240 out)."""
    limit = tk.SMEM_LIMIT_BYTES
    if kernel == "cholesky":
        for n in range(1, 240):             # one CTA per instance
            threads, smem = tk.chol_geometry(B, n)
            assert threads in (128, 256)
            assert smem == tk.chol_smem_bytes(n) <= limit
            # the need the gate checks covers the launch
            assert smem <= max(tk.chol_smem_bytes(n), tk.solve_smem_bytes(n))
            assert tk.fits_chol_smem(n)
        assert not tk.fits_chol_smem(240) and not tk.fits_chol_smem(257)
        return
    if kernel == "cho_solve":
        for n in range(1, 240):             # one CTA per instance
            threads, smem = tk.solve_geometry(B, n)
            assert threads in (128, 256)
            assert smem == tk.solve_smem_bytes(n) <= limit
            assert smem <= max(tk.chol_smem_bytes(n), tk.solve_smem_bytes(n))
            assert tk.fits_chol_smem(n)
        assert tk.solve_smem_bytes(240) > limit   # the gate unmoved
        return
    stage = tk.GMV_STAGE_BYTES // 4 - 3
    shapes = [(120, 81), (81, 81), (900, 65), (45, 31), (1, 1), (3, 20000),
              (3, 60000), (2, stage), (3, stage + 1)] + [
                  (120, n) for n in range(1, 240)]
    for m, n in shapes:
        rows, cols, smem = tk.gmv_geometry(B, m, n)
        assert 1 <= rows <= m and 1 <= cols <= n
        assert cols == n or rows == 1       # a stage is whole rows or one
        assert smem == tk.gmv_smem_bytes(cols, rows) <= limit
        # the stage holds the tile and up to three floats of alignment
        assert (smem - 16) // 4 >= rows * cols + 3 + cols + rows
        assert _gmv_covered(m, rows) == list(range(m))
        assert _gmv_covered(n, cols) == list(range(n))
        assert B * -(-m // rows) < 2 ** 31
