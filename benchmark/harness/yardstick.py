"""Frozen yardsticks of the benchmark: the H100's published peaks and K1's
operation and byte counts (copies of the repository's ``chip_smoke.py``
``k1_work`` / ``bound_of``), the busy time of a profiler trace as the union
of device intervals, and the window arithmetic of a sweep (the port's
``bench.py``: instance-steps over the seconds they took)."""
from __future__ import annotations

# Published peaks of one H100 SXM (dense, no sparsity), at a 700 W limit.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def k1_work(P, S, hp, hu, V, B, n_iters, n_cor, lower_tri):
    """Bytes the fused IPM call must move (each input read once, each
    output written once) and the float32 operations the function needs,
    for B QPs. With ``lower_tri`` slab row k is zero beyond column k, and
    only the non-zero entries are counted. A multiply-add counts as two
    operations."""
    nu = V * hu
    n = nu + 1
    mg = (P + S) * hp
    m = mg + 2 * n
    sides = 2 * P + S                      # slabs (a pair has two)
    state = 7 * n + 3 * mg + 2
    words_in = sides * hp * hu + V * hu * hu + mg + 2 * n + state
    words_out = state
    nz = [min(k + 1, hu) if lower_tri else hu for k in range(hp)]
    row_nz = sum(nz)
    tri_terms = sum(c * (c + 1) // 2 for c in nz)
    sq_terms = sum(c * c for c in nz)
    k_form = (sides * row_nz
              + 2 * (sides * tri_terms + P * sq_terms)
              + V * hu * (hu + 1) // 2
              + 4 * (nu * (nu + 1) // 2))
    chol = nu ** 3 / 3
    solves = (2 + n_cor) * 2 * nu * nu
    slab_mv = 2 * sides * row_nz + 2 * mg
    matvecs = (5 + 2 * n_cor) * slab_mv + 2 * V * hu * hu
    vec = (40 + 25 * n_cor) * m
    flops = n_iters * (k_form + chol + solves + matvecs + vec)
    return 4 * (words_in + words_out) * B, flops * B


def bound_of(nbytes, flops):
    """Least time [ms] the card could take, and whether bytes or
    operations bound it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def union_seconds(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals (any unit)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle gaps ``(start, end)`` between the union of ``intervals``
    inside ``[lo, hi]``."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def solves_per_s(instance_steps: int, seconds: float) -> float:
    """Sweep throughput: instance-steps completed over the window."""
    return instance_steps / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values``, linear between the order
    statistics (``statistics.quantiles``' inclusive method)."""
    vals = sorted(values)
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)
