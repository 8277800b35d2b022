"""The side-selection controller of the port (scp_tpu_torch/solvers/miqp.py)
against scp_tpu.solvers.miqp on the same numpy-seeded inputs, on the CPU.

The port's controller preprocessing (held against scp_tpu's by
test_torch_engine.py) builds each case's constraint system once; the same
numbers, as numpy arrays, are the JAX side's inputs, so every comparison
below starts from identical operands. Discrete outputs (side indices, the
candidate pick, rounds, IPM iteration counts, flags) must be equal as
integers; float64 values agree to 1e-12 where no QP is solved and to 1e-8
through the adaptive IPM. One float32 case holds the structured route (the
port's plain version of K1) against scp_tpu's Pallas kernel in interpret
mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scp_tpu.ops import constraints as jcon
from scp_tpu.ops import pallas_linalg as pll
from scp_tpu.solvers import miqp as jmiqp
from scp_tpu_torch.ops import constraints as tcon, ipm_kernel
from scp_tpu_torch.scenarios import batch as tbatch
from scp_tpu_torch.sim import engine as tengine
from scp_tpu_torch.solvers import miqp as tmiqp

from torch_parity import assert_close, jit_fast

SMALL = dict(hp=5, hu=5, qp_max_iter=25, controller="side_selection")
CASES = {"frog": {}, "circle": {"n_veh": 3}, "parallel": {"n_veh": 4}}
EXACT = 1e-12


def _tt(a, dtype=torch.float64):
    """numpy -> CPU tensor (integers and booleans keep their kind)."""
    a = np.array(a)
    t = torch.as_tensor(a)
    return t.to(dtype) if t.is_floating_point() else t


def _jsys(sys_t):
    """scp_tpu's ConstraintSystem holding the port system's numbers."""
    return jcon.ConstraintSystem(**{
        k: jnp.asarray(v.numpy()) for k, v in sys_t._asdict().items()})


def _port_case(cfg_t, data_t, seed):
    """The port's controller preprocessing of a batch and the arguments of
    its side-selection solve (the MIQP's raw safety distances, as the
    engines pass them) at a random warm start."""
    carry = tengine.init_carry(cfg_t, data_t)
    _, aux = tengine.controller_pre(cfg_t, data_t, carry)
    sys_t, u_max, ref_pts, x0 = aux[:4]
    iu, ju = sys_t.pair_i[0], sys_t.pair_j[0]
    b = x0.shape[0]
    rng = np.random.default_rng(seed)
    u_init = rng.uniform(-0.02, 0.02, size=(b, cfg_t.n_veh * cfg_t.hu))
    p = data_t.params
    t_args = (sys_t, ref_pts, p.q, p.q_final, p.r, carry.u_prev1, u_max,
              torch.as_tensor(u_init).to(x0.dtype))
    t_kw = dict(dsafe_pair=data_t.dsafe_veh[:, iu, ju],
                dsafe_obst=data_t.dsafe_obst)
    rect_t = tmiqp.rectangle_obstacle_geometry(
        data_t.obstacles, x0[..., 3], p.length, p.width, cfg_t.dt)
    return dict(cfg=cfg_t, data=data_t, t_args=t_args, t_kw=t_kw,
                rect_t=rect_t)


def _build(kind, dtype=torch.float64, seed=11, b=4, over=None, **kw):
    """One randomized batch built by the port, :func:`_port_case` on it, and
    the same arguments as scp_tpu's arrays. (Every scp_tpu function below
    starts from the preprocessed arguments, so scp_tpu's own batch builder,
    which compiles for 1.5-2 s a family, is not needed.)"""
    cfg_t, data_t = tbatch.make_batch(
        kind, b, generator=torch.Generator().manual_seed(seed), dtype=dtype,
        device="cpu", **kw)
    c = _port_case(cfg_t.replace(**{**SMALL, **(over or {})}), data_t, seed)
    c["j_args"] = (_jsys(c["t_args"][0]),) + tuple(
        jnp.asarray(a.numpy()) for a in c["t_args"][1:])
    c["j_kw"] = {k: jnp.asarray(v.numpy()) for k, v in c["t_kw"].items()}
    c["rect_j"] = tuple(jnp.asarray(t.numpy()) for t in c["rect_t"])
    return c


@pytest.fixture(scope="module")
def case():
    """``case(kind)``: :func:`_build`'s batch of a scenario family, built
    once per module."""
    cache = {}

    def get(kind):
        if kind not in cache:
            cache[kind] = _build(kind, **CASES[kind])
        return cache[kind]
    return get


@pytest.fixture(scope="module")
def stacked_ref(case):
    """``stacked_ref(kind)``: scp_tpu's solve_side_selection_stacked on the
    case (adaptive IPM, float64), one jitted run per scenario family."""
    cache = {}

    def get(kind):
        if kind not in cache:
            c = case(kind)
            du = c["cfg"].u_lim
            args = c["j_args"] + (c["j_kw"]["dsafe_pair"],
                                  c["j_kw"]["dsafe_obst"])

            def fn(*a):
                return jmiqp.solve_side_selection_stacked(
                    *a[:-2], du_lim=du, qp_max_iter=25, dsafe_pair=a[-2],
                    dsafe_obst=a[-1])
            cache[kind] = jax.tree_util.tree_map(
                np.asarray, jit_fast(fn, *args)(*args))
        return cache[kind]
    return get


# ---------------------------------------------------------------------------
# discrete rules
# ---------------------------------------------------------------------------

def test_select_sides_matches_scp_tpu():
    """Dominant-axis sides of random displacements and of exact ties
    (|dx| == |dy|, zeros, signed zeros): the index of scp_tpu's one-hot;
    the x side wins a tie."""
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.normal(size=(64, 2)),
                        [[1.0, 1.0], [-1.0, 1.0], [1.0, -1.0], [-2.0, -2.0],
                         [0.0, 0.0], [-0.0, 0.0], [0.0, -0.0], [0.0, 3.0],
                         [0.0, -3.0], [3.0, 0.0], [-3.0, 0.0]]])
    want = np.asarray(jmiqp.select_sides(jnp.asarray(d)))
    assert np.all(want.sum(-1) == 1.0)
    got = tmiqp.select_sides(_tt(d))
    assert_close(got, want.argmax(-1), 0, name="side")
    assert got[64:68].tolist() == [0, 1, 0, 1]


@pytest.mark.parametrize("largest", [True, False])
def test_arg_first_is_jnp_argmax_rule(largest):
    """Ties go to the first index, a row of -inf (or of +inf) to 0, and a
    NaN counts as the extreme, as with jnp.argmax / jnp.argmin."""
    inf, nan = np.inf, np.nan
    x = np.array([[0.5, 2.0, 2.0, 1.0], [-inf] * 4, [inf] * 4,
                  [3.0, 3.0, 3.0, 3.0], [1.0, nan, 2.0, nan],
                  [-inf, -inf, 0.0, -inf], [2.0, inf, inf, -inf],
                  [-1.0, -5.0, -5.0, -1.0]])
    want = (jnp.argmax if largest else jnp.argmin)(jnp.asarray(x), axis=-1)
    got = tmiqp._arg_first(_tt(x), -1, largest=largest)
    assert_close(got, np.asarray(want), 0, name="arg")
    assert got[1] == 0 and got[2] == 0 and got[4] == 1
    # along a leading axis (the candidate pick, the best incumbent)
    got0 = tmiqp._arg_first(_tt(x.T), 0, largest=largest)
    assert_close(got0, np.asarray(want), 0, name="dim 0")


SELECT_MODES = {
    "satisfied_only": dict(),
    "reachable": dict(u_max=True),
    "lat_commit": dict(u_max=True, lat_commit=True),
    "lat_commit_flip": dict(u_max=True, lat_commit="flip"),
    "longitudinal_only": dict(u_max=True, obst_sides=(0, 1)),
    "consistent": dict(consistent_lateral=True),
    "consistent_flip": dict(consistent_lateral="flip"),
    "rect_lat_commit": dict(u_max=True, lat_commit=True, rect=True),
    "rect_consistent_flip": dict(consistent_lateral="flip", rect=True),
}


def _mode_kw(mode, normals, dists, u_max):
    """The selection keywords of a SELECT_MODES entry."""
    kw = dict(SELECT_MODES[mode])
    rect = kw.pop("rect", False)
    return dict(kw, obst_normals=normals if rect else None,
                obst_dists=dists if rect else None,
                u_max=u_max if kw.pop("u_max", False) else None)


def _tie_inputs():
    """Two vehicles, two obstacles, three steps, controls zero: vehicle 0
    on the x axis with obstacle 0 dead ahead (its two lateral faces tie at
    every step) and obstacle 1 on top of it (every face violated: with
    u_max = 0 no face is reachable, a row of -inf); vehicle 1 at (+-1, +-1)
    from vehicle 0 (the pair's axes tie)."""
    k, hu = 3, 3
    rng = np.random.default_rng(3)
    b3 = 0.1 * rng.normal(size=(1, 2, k, 2, hu))
    const3 = np.zeros((1, 2, k, 2))
    const3[0, 0, :, 0] = [0.0, 1.0, 2.0]
    const3[0, 1] = const3[0, 0] + np.array([[1.0, 1.0], [-1.0, 1.0],
                                            [1.0, -1.0]])
    obst = np.zeros((1, 2, k, 2))
    obst[0, 0, :, 0] = const3[0, 0, :, 0] + 5.0
    obst[0, 1] = const3[0, 0]
    iu, ju = np.array([0]), np.array([1])
    arrs = dict(b3=b3, const3=const3, obst_pos=obst,
                dsafe2_pair=np.full((1, 1), 4.0),
                dsafe2_obst=np.full((1, 2, 2), 1.5 ** 2),
                pair_i=iu[None], pair_j=ju[None], pair_mask=np.ones((1, 1)),
                obst_mask=np.ones((1, 2, 2)), b3i=b3[:, iu], b3j=b3[:, ju])
    sys_t = tcon.ConstraintSystem(**{k: _tt(v) for k, v in arrs.items()})
    ones = torch.ones((1, 2), dtype=torch.float64)
    rect_t = tmiqp.rectangle_obstacle_geometry(
        _tt([[[5.0, 0.0, 0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.3, 0.0, 1.0,
                                                1.0]]]), ones, ones, ones,
        0.4)
    return (sys_t, torch.zeros((1, 2 * hu), dtype=torch.float64),
            torch.zeros((1, 2), dtype=torch.float64), rect_t)


@pytest.fixture(scope="module")
def select_ref(case):
    """``select_ref(name)``: the inputs ``(sys, u, u_max, (normals,
    dists))`` of the parallel-4 batch at its random trajectory
    ("parallel") or of the tie system ("ties"), and scp_tpu's selection in
    every mode on them (per instance under vmap, one jitted call)."""
    cache = {}

    def get(name):
        if name not in cache:
            if name == "ties":
                args = _tie_inputs()
            else:
                c = case(name)
                args = (c["t_args"][0], c["t_args"][7], c["t_args"][6],
                        c["rect_t"])
            sys_t, u, u_max, (normals, dists) = args

            def all_modes(s, uu, um, nn, dd):
                return {m: jmiqp._select_from_trajectory(
                    s, uu, **_mode_kw(m, nn, dd, um)) for m in SELECT_MODES}
            j_args = (_jsys(sys_t),) + tuple(
                jnp.asarray(t.numpy()) for t in (u, u_max, normals, dists))
            want = jit_fast(jax.vmap(all_modes), *j_args)(*j_args)
            cache[name] = (args, jax.tree_util.tree_map(np.asarray, want))
        return cache[name]
    return get


def _port_selection(args, mode):
    sys_t, u, u_max, (normals, dists) = args
    return tmiqp._select_from_trajectory(
        sys_t, u, **_mode_kw(mode, normals, dists, u_max))


@pytest.mark.parametrize("mode", list(SELECT_MODES))
def test_select_from_trajectory_matches_scp_tpu(select_ref, mode):
    """Every selection mode on the parallel-4 batch at a random trajectory:
    pair and obstacle sides equal as integers."""
    args, want = select_ref("parallel")
    got = _port_selection(args, mode)
    assert_close(got[0], want[mode][0], 0, name="sel_pair")
    assert_close(got[1], want[mode][1], 0, name="sel_obst")


@pytest.mark.parametrize("mode", list(SELECT_MODES))
def test_select_from_trajectory_ties_and_unreachable_faces(select_ref,
                                                           mode):
    """The tie system: equal selections in every mode; the explicit rule
    shows where the modes are defined by it — the lateral faces' tie goes
    to the first (side 2), and the all-violated obstacle with u_max = 0 (a
    row of -inf) to side 0."""
    args, want = select_ref("ties")
    got = _port_selection(args, mode)
    assert_close(got[0], want[mode][0], 0, name="sel_pair")
    assert_close(got[1], want[mode][1], 0, name="sel_obst")
    assert got[0].tolist() == [[[1, 0, 1]]]          # |dx| == |dy|: x side
    if mode in ("reachable", "lat_commit", "longitudinal_only"):
        assert got[1][0, 0, 1].tolist() == [0, 0, 0]  # all -inf -> side 0
    if mode in ("consistent", "consistent_flip"):
        assert got[1][0, 0, 0].tolist() == [2, 2, 2]  # lateral tie -> 2


# ---------------------------------------------------------------------------
# geometry, cost, rows
# ---------------------------------------------------------------------------

QP_KW = dict(du_lim=0.05, slack_weight=1e5, slack_ub=1e8)


@pytest.fixture(scope="module")
def pieces_ref(case):
    """The parallel-4 batch with a random side assignment, and scp_tpu's
    rectangle geometry of random obstacle tables, rate cost, selection-
    independent QP parts, slabs and dense rows (circle and rectangle
    modes) on it: one jitted call."""
    c = case("parallel")
    sys_t = c["t_args"][0]
    b, v, k = sys_t.b3.shape[:3]
    hu = sys_t.b3.shape[-1]
    rng = np.random.default_rng(5)
    sel = (rng.integers(0, 4, size=(b, sys_t.pair_i.shape[1], k)),
           rng.integers(0, 4, size=(b, v, sys_t.obst_pos.shape[1], k)))
    tables = (np.concatenate([rng.uniform(-5, 5, size=(3, 5, 2)),
                              rng.uniform(-np.pi, np.pi, size=(3, 5, 1)),
                              rng.uniform(0, 3, size=(3, 5, 1)),
                              rng.uniform(0.2, 4, size=(3, 5, 2))], axis=2),
              ) + tuple(rng.uniform(0.5, 5, size=(3, 2)) for _ in range(3))

    def ref(args, dsafe, rect, sel, tables):
        s, _, _, _, r, u0 = args[:6]
        out = {"rect_geometry": jax.vmap(
            lambda o, sp, ln, wd: jmiqp.rectangle_obstacle_geometry(
                o, sp, ln, wd, 0.4))(*tables),
               "rate": jax.vmap(lambda rr, uu: jmiqp.rate_cost_matrices(
                   rr, uu, hu, jnp.float64))(r, u0),
               "assemble": jax.vmap(lambda *a: jmiqp._assemble_qp(
                   *a, dtype=jnp.float64, **QP_KW))(*args[:7])}
        for mode, nd, axes in (("circle", (None, None), (None, None)),
                               ("rect", rect, (0, 0))):
            a = (s,) + sel + dsafe + nd
            ax = (0,) * 5 + axes
            out[mode] = (
                jax.vmap(jmiqp._slabs_from_selection, in_axes=ax)(*a)
                + jax.vmap(jmiqp._rows_from_selection, in_axes=ax)(*a))
        return out
    r_args = (c["j_args"], (c["j_kw"]["dsafe_pair"],
                            c["j_kw"]["dsafe_obst"]),
              c["rect_j"], tuple(map(jnp.asarray, sel)),
              tuple(map(jnp.asarray, tables)))
    want = jit_fast(ref, *r_args)(*r_args)
    return c, sel, tables, jax.tree_util.tree_map(np.asarray, want)


def test_rectangle_obstacle_geometry_matches_scp_tpu(pieces_ref):
    _, _, tables, want = pieces_ref
    got = tmiqp.rectangle_obstacle_geometry(*map(_tt, tables), 0.4)
    assert_close(got[0], want["rect_geometry"][0], EXACT, name="normals")
    assert_close(got[1], want["rect_geometry"][1], EXACT, name="dists")


def test_rate_cost_and_assemble_qp_match_scp_tpu(pieces_ref):
    """The rate cost and every selection-independent QP part; the port
    states P by its blocks, whose dense form is scp_tpu's P."""
    c, _, _, want = pieces_ref
    sys_t, _, _, _, r, u0 = c["t_args"][:6]
    phi_t, psi_t = tmiqp.rate_cost_matrices(r, u0, sys_t.b3.shape[-1],
                                            torch.float64)
    assert_close(phi_t, want["rate"][0], EXACT, name="rate phi")
    assert_close(psi_t, want["rate"][1], EXACT, name="rate psi")
    P_j, q_j, lb_j, ub_j, scol_j, G_rate_j, h_rate_j, phi_j = \
        want["assemble"]
    q_t, lb_t, ub_t, G_rate_t, h_rate_t, phi_t = tmiqp._assemble_qp(
        *c["t_args"][:7], dtype=torch.float64, **QP_KW)
    b = q_t.shape[0]
    assert_close(tmiqp._dense_p(phi_t), P_j, EXACT, name="P")
    for name, g, w in (("q", q_t, q_j), ("lb", lb_t, lb_j),
                       ("ub", ub_t, ub_j), ("h_rate", h_rate_t, h_rate_j),
                       ("phi", phi_t, phi_j),
                       ("G_rate", G_rate_t.expand((b,) + G_rate_t.shape),
                        G_rate_j)):
        assert_close(g, w, EXACT, rtol=EXACT, name=name)
    assert np.all(scol_j == -1.0)


@pytest.mark.parametrize("mode", ["circle", "rect"])
def test_slabs_and_rows_from_selection_match_scp_tpu(pieces_ref, mode):
    """Pair and obstacle slabs and the dense rows of a random assignment,
    axis-aligned circle mode and rotated-rectangle faces."""
    c, sel, _, want = pieces_ref
    args_t = ((c["t_args"][0],) + tuple(map(_tt, sel))
              + (c["t_kw"]["dsafe_pair"], c["t_kw"]["dsafe_obst"])
              + (c["rect_t"] if mode == "rect" else (None, None)))
    got = tmiqp._slabs_from_selection(*args_t) \
        + tmiqp._rows_from_selection(*args_t)
    for name, g, w in zip(("gi", "gj", "gob", "h_pair", "h_obst", "G", "h"),
                          got, want[mode]):
        assert_close(g, w, EXACT, rtol=EXACT, name=name)


# ---------------------------------------------------------------------------
# the solves
# ---------------------------------------------------------------------------

def test_solve_fixed_sides_matches_scp_tpu(case):
    """The enumeration oracle's subproblem (general dense solve_qp,
    adaptive, float64) on the frog batch at the selection its warm start
    induces."""
    c = case("frog")
    sys_t, u_init, u_max = c["t_args"][0], c["t_args"][7], c["t_args"][6]
    sp, so = tmiqp._select_from_trajectory(sys_t, u_init, u_max=u_max,
                                           lat_commit=True)
    kw = dict(du_lim=c["cfg"].u_lim, qp_max_iter=25)
    f_args = (*c["j_args"][:7], jnp.asarray(sp.numpy()),
              jnp.asarray(so.numpy()), c["j_kw"]["dsafe_pair"],
              c["j_kw"]["dsafe_obst"])
    want = jit_fast(jax.vmap(lambda *a: jmiqp.solve_fixed_sides(
        *a[:9], dsafe_pair=a[9], dsafe_obst=a[10], **kw)), *f_args)(*f_args)
    got = tmiqp.solve_fixed_sides(*c["t_args"][:7], sp, so, **c["t_kw"],
                                  **kw)
    assert_close(got[0], np.asarray(want[0]), 1e-8, name="u")
    assert_close(got[1], np.asarray(want[1]), 1e-6, rtol=1e-8, name="obj")
    assert_close(got[3], np.asarray(want[3]), 0, name="converged")
    assert bool(got[3].all())


@pytest.mark.parametrize("kind", list(CASES))
def test_solve_side_selection_stacked_matches_scp_tpu(case, stacked_ref,
                                                      kind):
    """The whole controller, float64, adaptive IPM: frog (candidates and
    obstacles, no pair), circle-3 (pairs, no obstacle: no candidates) and
    parallel-4 (both), hp = hu = 5, B = 4."""
    c, want = case(kind), stacked_ref(kind)
    got = tmiqp.solve_side_selection_stacked(
        *c["t_args"], du_lim=c["cfg"].u_lim, qp_max_iter=25, **c["t_kw"])
    assert_close(got.u, want.u, 1e-8, name="u")
    assert_close(got.obj, want.obj, 1e-6, rtol=1e-8, name="obj")
    assert_close(got.slack, want.slack, 1e-8, name="slack")
    for name in ("feasible", "converged", "rounds", "sides_stable",
                 "qp_iters"):
        assert_close(getattr(got, name), getattr(want, name), 0, name=name)
    assert int(got.qp_iters.min()) > 0


def test_solve_side_selection_is_the_stacked_solve_of_one_instance(
        case, stacked_ref):
    """The unbatched B = 1 view on the parallel batch's instance 2."""
    c, want = case("parallel"), stacked_ref("parallel")
    one = [tcon.ConstraintSystem(*[t[2] for t in c["t_args"][0]])] \
        + [a[2] for a in c["t_args"][1:]]
    got = tmiqp.solve_side_selection(
        *one, du_lim=c["cfg"].u_lim, qp_max_iter=25,
        **{k: v[2] for k, v in c["t_kw"].items()})
    assert tuple(got.u.shape) == (c["cfg"].n_veh * c["cfg"].hu,)
    assert_close(got.u, want.u[2], 1e-8, name="u")
    for name in ("feasible", "rounds", "sides_stable", "qp_iters"):
        assert_close(getattr(got, name), getattr(want, name)[2], 0,
                     name=name)


def test_structured_route_float32_matches_pallas_interpret():
    """float32, 12 fixed IPM iterations, the candidate round (five
    assignments per instance, one 20-wide QP batch): parallel-3 at
    hp = hu = 8, B = 4 — pair and obstacle slabs plus the hard rate rows as
    2V single-block slabs with slack coefficient 0. The port's structured
    route (K1's plain version here) against scp_tpu's Pallas struct kernel
    in interpret mode."""
    c = _build("parallel", torch.float32, seed=2, over=dict(hp=8, hu=8),
               n_veh=3)
    kw = dict(du_lim=c["cfg"].u_lim, qp_fixed_iters=12, qp_tol=1e-6,
              n_rounds=1)
    old = pll.INTERPRET
    pll.INTERPRET = True
    try:
        args = c["j_args"] + (c["j_kw"]["dsafe_pair"],
                              c["j_kw"]["dsafe_obst"])
        want = jit_fast(lambda *a: jmiqp.solve_side_selection_stacked(
            *a[:-2], qp_use_pallas=True, dsafe_pair=a[-2],
            dsafe_obst=a[-1], **kw), *args)(*args)
    finally:
        pll.INTERPRET = old
    got = tmiqp.solve_side_selection_stacked(*c["t_args"], **c["t_kw"],
                                             **kw)
    assert got.u.dtype == torch.float32
    assert_close(got.u, np.asarray(want.u), 1e-3, name="u")
    assert_close(got.feasible, np.asarray(want.feasible), 0, name="feasible")
    # the hard rate rows hold in the fused solution
    u0 = c["t_args"][5].numpy()
    u = got.u.numpy().reshape(4, 3, 8)
    du = np.diff(u, axis=2, prepend=u0[:, :, None])
    assert np.abs(du).max() <= c["cfg"].u_lim + 1e-4


@pytest.mark.parametrize("kind,route", [("parallel", "struct"),
                                        ("frog", "dense")])
def test_fixed_count_routes_and_dense_rows(monkeypatch, kind, route):
    """Fixed-count solves: with a pair the structured kernel (K1, lower-
    triangular slabs, the rate rows hard in its slack column) and NO dense
    scatter of the rows; without one the dense-G kernel (K2), which reads
    the scattered rows. One call per QP: the candidates, then the round."""
    cfg, data = tbatch.make_batch(kind, 4, dtype=torch.float32, device="cpu",
                                  **CASES[kind])
    c = _port_case(cfg.replace(**SMALL), data, seed=4)
    calls = {"scatter": 0, "struct": [], "dense": []}
    real = {n: getattr(m, n) for m, n in (
        (tcon, "scatter_slabs"), (ipm_kernel, "ipm_iterate_struct"),
        (ipm_kernel, "ipm_iterate_dense"))}

    def scatter(*a, **k):
        calls["scatter"] += 1
        return real["scatter_slabs"](*a, **k)

    def spy(name):
        def call(*a, **k):
            calls[name].append((a, k))
            return real[f"ipm_iterate_{name}"](*a, **k)
        return call

    monkeypatch.setattr(tcon, "scatter_slabs", scatter)
    monkeypatch.setattr(ipm_kernel, "ipm_iterate_struct", spy("struct"))
    monkeypatch.setattr(ipm_kernel, "ipm_iterate_dense", spy("dense"))
    res = tmiqp.solve_side_selection_stacked(
        *c["t_args"], du_lim=c["cfg"].u_lim, qp_fixed_iters=12,
        qp_candidate_iters=8, qp_tol=1e-6, **c["t_kw"])
    assert bool(torch.isfinite(res.u).all())
    assert res.qp_iters.tolist() == [5 * 8 + 12] * 4
    b, n = 4, c["cfg"].n_veh * c["cfg"].hu
    launched = calls[route]
    assert [a[0].shape[0] for a, _ in launched] == [5 * b, b]
    assert not calls["dense" if route == "struct" else "struct"]
    if route == "struct":
        assert calls["scatter"] == 0
        for a, k in launched:
            gsl = a[3]
            assert k["lower_tri"] and k["n_iters"] in (8, 12)
            assert bool((gsl[:, -2 * n:] == 0).all())
            assert bool((gsl[:, :-2 * n] < 0).all())
    else:
        assert calls["scatter"] == 2
        for a, k in launched:
            G = a[0]
            assert k["schur_slack"] and k["n_iters"] in (8, 12)
            assert bool((G[:, -2 * n:, -1] == 0).all())
            assert bool((G[:, :-2 * n, -1] < 0).all())


def test_calibrated_parallel11_k1_gate():
    """Parallel-11's side-selection QP (55 pairs, 44 obstacle + 22 rate
    slabs): at hp = 10 one K1 CTA per SM holds it in the shared tier; at
    hp = 16 and 20 its whole carve (329,492 / 481,908 bytes) is past a
    block's shared memory and K1's cluster tier takes it (two CTAs an
    instance, the factor in their shared memory, 171,608 / 227,072 bytes
    each), and the device tier where forced (the factor and the slabs in
    device memory, 109,140 / 139,588 bytes of the rest); past that tier's
    own carve (hp = 32: 239,380 bytes; hp = 64: 567,444) the global tier
    takes it (the vectors in device memory too, before the KKT matrix:
    1,320 bytes a CTA), and the device tier forced there refuses, naming
    the bytes."""
    assert ipm_kernel.smem_bytes(55, 66, 10, 10, 11, lower_tri=True) \
        == 153_668
    assert ipm_kernel.struct_tier(55, 66, 10, 10, 11, True) \
        == ("shared", 153_668, 0, False)
    for hp, whole, rest, rank in ((16, 329_492, 109_140, 171_608),
                                  (20, 481_908, 139_588, 227_072)):
        assert ipm_kernel.smem_bytes(55, 66, hp, hp, 11, True) == whole
        nu = 11 * hp
        assert ipm_kernel.struct_tier(55, 66, hp, hp, 11, lower_tri=True) \
            == ("cluster", rank, 0, False)
        assert ipm_kernel.cluster_geometry(55, 66, hp, hp, 11)[0] == 2
        assert ipm_kernel.struct_tier(55, 66, hp, hp, 11, lower_tri=True,
                                      tier="device") \
            == ("device", rest, nu * ((nu + 31) // 32 * 32), False)
    for hp, rest in ((32, 239_380), (64, 567_444)):
        assert ipm_kernel.smem_bytes(55, 66, hp, hp, 11, True, True) == rest
        g = ipm_kernel.global_geometry(55, 66, hp, hp, 11)
        assert g.smem_bytes == 1_320
        assert ipm_kernel.struct_tier(55, 66, hp, hp, 11, lower_tri=True) \
            == ("global", 1_320, g.workspace_floats, False)
        with pytest.raises(NotImplementedError, match=f"{rest} bytes"):
            ipm_kernel.struct_tier(55, 66, hp, hp, 11, lower_tri=True,
                                   tier="device")