"""The frozen yardsticks: K1's bound at the bench shape, the union of
device intervals, the idle gaps and the percentile."""
import pytest

from harness import yardstick

# the bench shape: circle-4, hp = hu = 20, 6 pairs, 7 iterations, slabs
# lower-triangular; PERF.md's table: 0.0348 / 0.0087 / 0.0022 ms
BENCH_SHAPE = dict(P=6, S=0, hp=20, hu=20, V=4, n_iters=7, n_cor=0,
                   lower_tri=True)


@pytest.mark.parametrize("B, ms", [(1024, 0.0348), (256, 0.0087),
                                   (64, 0.0022)])
def test_k1_bound_at_the_bench_shape(B, ms):
    bound, by = yardstick.bound_of(*yardstick.k1_work(B=B, **BENCH_SHAPE))
    assert round(bound, 4) == ms
    assert by == "operations"


def test_union_is_not_the_sum():
    iv = [(0, 10), (5, 15), (20, 30), (21, 22)]
    assert yardstick.union_seconds(iv) == 25
    assert yardstick.union_seconds([]) == 0.0
    assert yardstick.gaps(iv, 0, 40) == [(15, 20), (30, 40)]
    assert yardstick.gaps(iv, -5, 12) == [(-5, 0)]


def test_percentile_and_rate():
    vals = list(range(1, 101))
    assert yardstick.percentile(vals, 50) == 50.5
    assert yardstick.percentile(vals, 95) == pytest.approx(95.05)
    assert yardstick.percentile([7.0], 95) == 7.0
    assert yardstick.solves_per_s(16384 * 10, 4.0) == 40960.0
