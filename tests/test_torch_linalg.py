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

from scp_tpu.ops import linalg as jl
from scp_tpu.ops import pallas_linalg as pll
from scp_tpu_torch.ops import linalg as tl
from scp_tpu_torch.ops import linalg_kernel as tk
from torch_parity import assert_stripes_cover

F32_REL = 2e-5
TDT_OF = {np.float32: torch.float32, np.float64: torch.float64}


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


@pytest.mark.parametrize("n,np_dtype", [(240, np.float64), (257, np.float64),
                                        (240, np.float32), (257, np.float32)])
def test_plain_versions_match_blocked_at_large_n(n, np_dtype):
    """Past the shared-memory kernels (n = 240; hp = 64 with 4 vehicles is
    n = 257): the plain versions, which the wrappers run on the CPU, against
    scp_tpu's ``blocked_cholesky`` / ``blocked_cho_solve`` (its factor and
    solve off the TPU) under vmap: 1e-12 of the result's scale in float64,
    F32_REL in float32 (two orders of n-term float32 sums). (The Pallas
    kernels in interpret mode take 45-52 s at these sizes on the CPU; they
    are held at the smaller sizes above.)"""
    rng = np.random.default_rng(n)
    K = _spd(rng, 2, n, np_dtype)
    rhs = rng.normal(size=(2, n)).astype(np_dtype)
    L_j = jax.vmap(jl.blocked_cholesky)(jnp.asarray(K))
    x_j = jax.vmap(jl.blocked_cho_solve)(L_j, jnp.asarray(rhs))
    L_t = tk.cholesky(torch.as_tensor(K))
    x_t = tk.cho_solve(L_t, torch.as_tensor(rhs))
    tol = 1e-12 if np_dtype == np.float64 else F32_REL
    assert L_t.dtype == TDT_OF[np_dtype] and x_t.shape == (2, n)
    assert _rel(torch.tril(L_t), np.tril(np.asarray(L_j))) < tol
    assert _rel(x_t, x_j) < tol
    assert float(torch.triu(L_t, diagonal=1).abs().max()) == 0.0


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
                                "gtmv": 0, "cholesky_cluster": 0,
                                "cho_solve_staged": 0}


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
    """One instance's matrix fits a block's 232,448 bytes of shared memory up
    to n = 239: ``fits_chol_smem`` still sets the routing boundary there
    (``kkt="auto"`` sends n >= 240 to the banded KKT when a stage statement
    is given). Past it the factor and the solve keep the matrix in device
    memory: n = 240 and n = 257 (hp = 64 with 4 vehicles) get the large-n
    geometry, with only the vectors in shared memory."""
    assert tk.chol_smem_bytes(81) == 4 * (81 * 81 + 81 + 1)
    assert tk.solve_smem_bytes(80) == 4 * (80 * 81 + 160)
    assert tk.fits_chol_smem(239) and tk.SMEM_LIMIT_BYTES == 232_448
    assert max(tk.chol_smem_bytes(239), tk.solve_smem_bytes(239)) \
        <= tk.SMEM_LIMIT_BYTES
    for n in (240, 257):
        assert not tk.fits_chol_smem(n)
        assert tk.solve_smem_bytes(n) > tk.SMEM_LIMIT_BYTES
        for B in (1, 256, 1024):
            assert tk.chol_geometry(B, n) == (tk.LARGE_THREADS,
                                              tk.chol_large_smem_bytes(n))
            assert tk.solve_geometry(B, n) == (tk.LARGE_THREADS,
                                               tk.solve_large_smem_bytes(n))
    # the limits left: 32-bit indices within an instance, the solve's two
    # vectors in shared memory
    assert tk.solve_geometry(1, 29_056)[1] <= tk.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        tk.solve_geometry(1, 29_057)
    assert tk.chol_geometry(1, 46_340)[1] <= tk.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="64-bit indices"):
        tk.chol_geometry(1, 46_341)


@pytest.mark.parametrize("B", [1, 3, 256, 1024])
def test_cluster_factor_geometry(B):
    """The large-n factor over a thread block cluster (n = 240 .. 600): at
    most 8 CTAs an instance, each rank's carve within a block's 232,448
    bytes, the smallest cluster that holds the stripes, raised toward 8
    while B x C is below the card's 132 SMs, and the stripes covering the
    lower triangle exactly once."""
    limit = tk.SMEM_LIMIT_BYTES
    for n in range(240, 601):
        C, threads, smem, deal = tk.chol_cluster_geometry(B, n)
        assert C in tk.CHOL_CLUSTER_SIZES and C <= 8
        assert threads == tk.LARGE_THREADS
        assert deal == tk.stripe_deal(n, C)
        assert smem == tk.chol_cluster_smem_bytes(n, C, deal[2]) <= limit
        fits = [c for c in tk.CHOL_CLUSTER_SIZES
                if tk.chol_cluster_smem_bytes(n, c, tk.stripe_deal(n, c)[2])
                <= limit]
        assert C == next((c for c in fits if B * c >= tk.CHOL_CLUSTER_SMS),
                         fits[-1])
        if n in (240, 257, 330, 400, 511, 600):
            assert_stripes_cover(n, C)
    # the sizes the records name: one CTA an instance at n = 257 from
    # B = 256, two at n = 400; eight at B = 1
    assert tk.chol_cluster_geometry(256, 257)[0] == 1
    assert tk.chol_cluster_geometry(1024, 400)[0] == 2
    assert tk.chol_cluster_geometry(1, 257)[0] == 8


def test_factor_route():
    """n < 240: the shared-memory factor; from 240 the cluster factor while
    a cluster of 8 holds the stripes; past it the one-CTA kernel with the
    matrix in device memory, which ``variant="device"`` forces at any n;
    ``variant="cluster"`` past the cluster's capacity is refused."""
    cap = max(n for n in range(240, 1200)
              if tk.chol_cluster_geometry(1, n) is not None)
    assert 600 <= cap < 1200
    assert tk.chol_cluster_geometry(1, cap + 1) is None
    for B in (1, 3, 256, 1024):
        assert tk.chol_route(B, 239) == "shared"
        for n in (240, 257, 400, cap):
            assert tk.chol_route(B, n) == "cluster"
            assert tk.chol_route(B, n, "device") == "device"
            assert tk.chol_route(B, n, "cluster") == "cluster"
        assert tk.chol_route(B, cap + 1) == "device"
        assert tk.chol_route(B, 81, "device") == "device"
        with pytest.raises(ValueError, match="does not fit a cluster"):
            tk.chol_route(B, cap + 1, "cluster")
    with pytest.raises(ValueError, match="unknown factor variant"):
        tk.chol_route(1, 257, "global")


@pytest.mark.parametrize("variant", [None, "cluster", "device"])
def test_large_n_variants_take_the_plain_version_on_cpu(variant):
    """Either large-n factor forced on CPU tensors runs the plain version,
    bit for bit the call without the keyword, within F32_REL of scp_tpu's
    ``blocked_cholesky`` at n = 257 (hp = 64 with 4 vehicles), and counts
    no launch."""
    rng = np.random.default_rng(257)
    K = _spd(rng, 2, 257, np.float32)
    L_j = jax.vmap(jl.blocked_cholesky)(jnp.asarray(K))
    tk.reset_launch_counts()
    L_t = tk.cholesky(torch.as_tensor(K), variant=variant)
    assert torch.equal(L_t, tk.cholesky(torch.as_tensor(K)))
    assert _rel(torch.tril(L_t), np.tril(np.asarray(L_j))) < F32_REL
    assert not any(tk.launch_counts.values())


@pytest.mark.parametrize("n", [240, 257, 330, 331])
def test_staged_solve_geometry(n):
    """The staged large-n solve's carve: row r of the lower triangle in a
    16-byte-aligned slot of (r + 7) & ~3 floats, which holds its r + 1
    entries after any of the four alignments a row can have in device
    memory; the slots' offsets in the closed form the kernel computes;
    16-row stripes, one mbarrier each, awaiting each of their rows; the
    whole within a block's 232,448 bytes (at n = 257: mbarriers 36 words,
    1 / diag, the right-hand side, the counts and the row offsets 1,028,
    the triangle 34,308: 141,488 bytes, one CTA an SM)."""
    def closed(r):       # csrc/linalg.cu::staged_row_slot
        t = r & 3
        return r * (r - 1) // 2 + 7 * r - 6 * (r >> 2) - (0, 3, 3, 4)[t]

    slot = [tk.staged_row_slot(r) for r in range(n + 1)]
    assert slot == [closed(r) for r in range(n + 1)]
    for r in range(n):
        width = slot[r + 1] - slot[r]
        assert slot[r] % 4 == 0 and width == (r + 7) & ~3
        assert 3 + r + 1 <= width
    ns = -(-n // 16)
    rows = [min(16, n - 16 * s) for s in range(ns)]
    assert sum(rows) == n and rows[:-1] == [16] * (ns - 1)
    words = -(-2 * ns // 4) * 4 + -(-4 * n // 4) * 4 + slot[n]
    assert tk.solve_staged_smem_bytes(n) == 4 * words <= tk.SMEM_LIMIT_BYTES
    assert 4 * slot[n] >= 4 * n * (n + 1) // 2
    if n == 257:
        assert (-(-2 * ns // 4) * 4, -(-4 * n // 4) * 4, slot[n]) \
            == (36, 1_028, 34_308)
        assert tk.solve_staged_smem_bytes(n) == 141_488
        assert 2 * (141_488 + 1024) > 228 * 1024


@pytest.mark.parametrize("n,want", [(239, "shared"), (240, "staged"),
                                    (257, "staged"), (330, "staged"),
                                    (331, "staged"), (332, "device"),
                                    (400, "device")])
def test_solve_route(n, want):
    """n < 240: the shared-memory solve; from 240 the staged solve while
    the triangle fits one block's shared memory (n <= 331) and the batch is
    one wave of instances (B <= 132), else the one-CTA kernel reading L
    from device memory, which ``variant="device"`` forces at any n and B;
    ``variant="staged"`` past the triangle's capacity is refused, at any
    B it forces the staged kernel."""
    big = tk.SOLVE_STAGED_MAX_BATCH + 1
    assert tk.SOLVE_STAGED_MAX_BATCH == 132
    for B in (1, 16, 132):
        assert tk.solve_route(B, n) == want
    assert tk.solve_route(big, n) == ("shared" if want == "shared"
                                      else "device")
    for B in (1, big):
        assert tk.solve_route(B, n, "device") == "device"
        if tk.solve_staged_smem_bytes(n) <= tk.SMEM_LIMIT_BYTES:
            assert tk.solve_route(B, n, "staged") == "staged"
        else:
            with pytest.raises(ValueError, match="staged solve needs"):
                tk.solve_route(B, n, "staged")
    with pytest.raises(ValueError, match="unknown solve variant"):
        tk.solve_route(1, n, "cluster")


@pytest.mark.parametrize("variant", [None, "staged", "device"])
def test_large_n_solve_variants_take_the_plain_version_on_cpu(variant):
    """Either large-n solve forced on CPU tensors runs the plain version,
    bit for bit the call without the keyword, within F32_REL of scp_tpu's
    ``blocked_cho_solve`` at n = 257 (hp = 64 with 4 vehicles), and counts
    no launch."""
    rng = np.random.default_rng(258)
    K = _spd(rng, 2, 257, np.float32)
    rhs = rng.normal(size=(2, 257)).astype(np.float32)
    L_j = jax.vmap(jl.blocked_cholesky)(jnp.asarray(K))
    x_j = jax.vmap(jl.blocked_cho_solve)(L_j, jnp.asarray(rhs))
    L_t = torch.as_tensor(np.tril(np.asarray(L_j)))
    tk.reset_launch_counts()
    x_t = tk.cho_solve(L_t, torch.as_tensor(rhs), variant=variant)
    assert torch.equal(x_t, tk.cho_solve(L_t, torch.as_tensor(rhs)))
    assert _rel(x_t, x_j) < F32_REL
    assert not any(tk.launch_counts.values())


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


# (SMs, threads per SM, shared-memory bytes per SM) as
# linalg_kernel.sm_resources reads them: an H100 SXM, an H100 PCIe, an A100
GTMV_CARDS = ((132, 2048, 233_472), (114, 2048, 233_472),
              (108, 2048, 167_936))


@pytest.mark.parametrize("kernel,B", [("cholesky", b) for b in
                                      (1, 3, 64, 1023, 1024)]
                         + [("cho_solve", b) for b in
                            (1, 3, 64, 1023, 1024)]
                         + [("gmv", b) for b in (1, 3, 64, 256, 1024)]
                         + [("gtmv", b) for b in (1, 3, 64, 256, 1024)]
                         + [("large_n", b) for b in (1, 3, 256, 1024)])
def test_launch_geometry(kernel, B):
    """The geometry the wrappers hand the launchers: within a block's shared
    memory, every instance, row and column computed exactly once, the
    factor's shared-memory kernels where they were (n = 239 in, n = 240
    out), the large-n kernels past them, and G^T v's CTAs of an instance
    one cluster of at most 8."""
    limit = tk.SMEM_LIMIT_BYTES
    if kernel == "cholesky":
        for n in range(1, 240):             # one CTA per instance
            threads, smem = tk.chol_geometry(B, n)
            assert threads in (128, 256)
            assert smem == tk.chol_smem_bytes(n) <= limit
            # the need the routing predicate checks covers the launch
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
    if kernel == "large_n":
        for n in range(240, 601):           # one CTA per instance
            for geo, smem_of in ((tk.chol_geometry, tk.chol_large_smem_bytes),
                                 (tk.solve_geometry,
                                  tk.solve_large_smem_bytes)):
                threads, smem = geo(B, n)
                assert threads == tk.LARGE_THREADS
                assert smem == smem_of(n) <= limit
                assert n * n <= tk.MAX_INDEX
        return
    stage = (tk.GMV_STAGE_BYTES if kernel == "gmv"
             else tk.GTMV_STAGE_BYTES) // 4 - 3
    shapes = [(120, 81), (81, 81), (900, 65), (45, 31), (1, 1), (3, 20000),
              (3, 60000), (2, stage), (3, stage + 1), (384, 257),
              (9, 8192)] + [(120, n) for n in range(1, 240)] + [
                  (m, 81) for m in range(1, 130)]
    for m, n in shapes:
        if kernel == "gmv":
            rows, cols, smem = tk.gmv_geometry(B, m, n)
            assert 1 <= rows <= m and 1 <= cols <= n
            assert cols == n or rows == 1   # a stage is whole rows or one
            assert smem == tk.gmv_smem_bytes(cols, rows) <= limit
            # the stage holds the tile and up to three floats of alignment
            assert (smem - 16) // 4 >= rows * cols + 3 + cols + rows
            assert _gmv_covered(m, rows) == list(range(m))
            assert _gmv_covered(n, cols) == list(range(n))
            assert B * -(-m // rows) < 2 ** 31
            continue
        for card in GTMV_CARDS:
            sms, sm_threads, sm_smem = card
            tiles, rows, chunk, cols, smem = tk.gtmv_geometry(B, m, n,
                                                              *card)
            threads = tk.GTMV_THREADS
            # a cluster of at most 8 CTAs, none without rows, covering m
            assert 1 <= tiles <= tk.GTMV_MAX_CLUSTER
            assert (tiles - 1) * rows < m <= tiles * rows
            assert 1 <= chunk <= rows and 1 <= cols <= n
            assert cols == n or chunk == 1  # a chunk is whole rows or one
            assert smem == tk.gtmv_smem_bytes(chunk, cols) <= limit
            groups = max(1, threads // cols)
            assert groups * min(cols, threads) <= threads
            # two stages, each the chunk and up to three floats of alignment
            assert (smem - 16) // 4 >= 2 * (chunk * cols + 3 + chunk) \
                + groups * cols
            # every row once: CTAs over the instance, chunks over its rows
            covered = []
            for t in range(tiles):
                first, last = t * rows, min(m, (t + 1) * rows)
                covered += [first + r for r in
                            _gmv_covered(last - first, chunk)]
            assert covered == list(range(m))
            assert _gmv_covered(n, cols) == list(range(n))
            # every column once: a row group's threads over a run's columns,
            # the columns of a run dealt over the cluster's CTAs
            for w in {cols, n - (n - 1) // cols * cols}:
                g_w = max(1, threads // w)
                gw = threads // g_w
                assert sorted(c for j in range(gw) for c in range(j, w, gw)) \
                    == list(range(w))
                assert g_w * w <= groups * cols
                assert sorted(c for rk in range(tiles)
                              for t in range(threads)
                              for c in range(rk * threads + t, w,
                                             tiles * threads)) \
                    == list(range(w))
            assert B * tiles < 2 ** 31
            # enough CTAs where the instance has the rows for them
            if m >= tk.GTMV_MAX_CLUSTER:
                assert B * tiles >= min(tk.GTMV_CTAS_PER_SM * sms,
                                        B * tk.GTMV_MAX_CLUSTER) // 2
            # the whole grid resident at once, unless a chunk is one row
            per_sm = min(sm_threads // threads, -(-B * tiles // sms))
            assert chunk == 1 or \
                sm_smem // (smem + tk.CTA_RESERVED_SMEM) >= per_sm
