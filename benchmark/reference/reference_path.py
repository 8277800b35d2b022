"""Frozen copy of ``ops/reference_path.py`` of the PyTorch port, for the benchmark's
plain reference (imports nothing of the port). The port's docstring:

Reference-trajectory projection and equidistant sampling (counterpart of
``scp_tpu/ops/reference_path.py``).

* Project the vehicle position onto the piecewise-linear reference curve:
  the perpendicular (unclamped) projection is accepted when the parameter
  lies inside the segment, and additionally outside it on the first/last
  segment; otherwise the segment endpoint is the candidate. The candidate
  with the smallest absolute distance wins.
* From the projected arc length ``s0``, the Hp sample points sit at
  ``s0 + stepSize * (i+1)`` along the curve, linearly extrapolated beyond
  either end.

Polylines are padded to a static length with the last vertex repeated;
``valid`` marks real vertices. Every function broadcasts over leading axes
(instances, vehicles): ``points (..., P, 2)``, ``valid (..., P)``,
``pos (..., 2)``.
"""
from __future__ import annotations

import torch


def _segment_geometry(points: torch.Tensor, valid: torch.Tensor):
    """Per-segment vectors/lengths/dirs. Segment i joins vertex i and i+1.

    Padding segments (invalid) have zero length and zero direction.
    """
    seg_vec = points[..., 1:, :] - points[..., :-1, :]      # (..., P-1, 2)
    valid_seg = valid[..., 1:] & valid[..., :-1]            # (..., P-1)
    seg_len = torch.linalg.vector_norm(seg_vec, dim=-1)
    seg_len = torch.where(valid_seg, seg_len, torch.zeros_like(seg_len))
    safe_len = torch.where(seg_len > 0, seg_len, torch.ones_like(seg_len))
    seg_dir = seg_vec / safe_len[..., None]
    seg_dir = torch.where(valid_seg[..., None], seg_dir,
                          torch.zeros_like(seg_dir))
    return seg_vec, seg_len, seg_dir, valid_seg


def _cum_lengths(seg_len: torch.Tensor) -> torch.Tensor:
    zero = seg_len.new_zeros(seg_len.shape[:-1] + (1,))
    return torch.cat([zero, torch.cumsum(seg_len, dim=-1)], dim=-1)


def project_to_polyline(points: torch.Tensor, valid: torch.Tensor,
                        pos: torch.Tensor):
    """Project ``pos`` onto the polyline. Returns (arclength, distance),
    each (...); ``distance`` is the signed perpendicular distance (left
    positive)."""
    _, seg_len, seg_dir, valid_seg = _segment_geometry(points, valid)
    n_seg = seg_len.shape[-1]
    n_valid_seg = valid_seg.sum(dim=-1)
    last_idx = n_valid_seg - 1

    rel = pos[..., None, :] - points[..., :-1, :]           # (..., P-1, 2)
    proj = torch.sum(rel * seg_dir, dim=-1)
    perp = seg_dir[..., 0] * rel[..., 1] - seg_dir[..., 1] * rel[..., 0]
    lam = proj / torch.where(seg_len > 0, seg_len, torch.ones_like(seg_len))

    idx = torch.arange(n_seg, device=points.device)
    # Eligibility: (0 < lam or first) and (lam < 1 or last).
    lo_ok = (lam > 0) | (idx == 0)
    hi_ok = (lam < 1) | (idx == last_idx[..., None])
    interior = lo_ok & hi_ok

    cum = _cum_lengths(seg_len)

    # Candidate A: perpendicular projection (possibly extrapolated at ends).
    dist_a = perp.abs()
    arc_a = cum[..., :-1] + lam * seg_len
    # Candidate B: segment end vertex.
    d_end = torch.linalg.vector_norm(
        pos[..., None, :] - points[..., 1:, :], dim=-1)
    arc_b = cum[..., 1:]

    cand_dist = torch.where(interior, dist_a, d_end)
    cand_arc = torch.where(interior, arc_a, arc_b)
    cand_signed = torch.where(interior, perp, torch.sign(perp) * d_end)
    cand_dist = torch.where(valid_seg, cand_dist,
                            torch.full_like(cand_dist, float("inf")))

    best = torch.argmin(cand_dist, dim=-1, keepdim=True)
    return (torch.gather(cand_arc, -1, best)[..., 0],
            torch.gather(cand_signed, -1, best)[..., 0])


def point_at_arclength(points: torch.Tensor, valid: torch.Tensor,
                       s: torch.Tensor):
    """Points on the polyline at arc lengths ``s (..., S)``, linearly
    extrapolated along the first/last segment outside [0, total_length].
    Returns (..., S, 2)."""
    _, seg_len, seg_dir, valid_seg = _segment_geometry(points, valid)
    cum = _cum_lengths(seg_len)
    total = cum[..., -1:]                                   # (..., 1)
    last_idx = valid_seg.sum(dim=-1, keepdim=True) - 1      # (..., 1)

    t = torch.minimum(torch.clamp(s, min=0.0), total)
    # Segment index: number of interior breakpoints <= t (searchsorted
    # side="right" on cum[1:-1]), clipped to the valid segments.
    inner = cum[..., 1:-1]                                  # (..., P-2)
    k = (inner[..., None, :] <= t[..., :, None]).sum(dim=-1)
    k = torch.minimum(torch.clamp(k, min=0), last_idx)      # (..., S)

    def take(a, i):      # a (..., N, 2), i (..., S) -> (..., S, 2)
        return torch.gather(a, -2, i[..., None].expand(i.shape + (2,)))

    cum_k = torch.gather(cum, -1, k)
    base = take(points, k) + (t - cum_k)[..., None] * take(seg_dir, k)
    over = torch.clamp(s - total, min=0.0)
    under = torch.clamp(s, max=0.0)
    dir_last = take(seg_dir, last_idx)                      # (..., 1, 2)
    dir_first = seg_dir[..., 0:1, :]
    return base + over[..., None] * dir_last + under[..., None] * dir_first


def sample_reference(points: torch.Tensor, valid: torch.Tensor,
                     pos: torch.Tensor, step_size: torch.Tensor, hp: int,
                     end_compat: bool = True) -> torch.Tensor:
    """Hp equidistant samples along the curve ahead of ``pos``.
    ``step_size`` is (...); returns (..., hp, 2).

    ``end_compat=True`` reproduces the original controller's end-of-line
    behavior: past the final vertex the walk oscillates between ``end + e``
    and ``end + (h - e)`` instead of extrapolating. ``end_compat=False``
    extrapolates linearly along the final segment.
    """
    s0, _ = project_to_polyline(points, valid, pos)
    h = step_size
    if end_compat:
        _, seg_len, _, _ = _segment_geometry(points, valid)
        s_total = seg_len.sum(dim=-1)
        c = s0
        ss = []
        for _ in range(hp):
            rem = (s_total - c).abs()
            c = torch.where(rem > h, c + h, s_total + (h - rem))
            ss.append(c)
        ss = torch.stack(ss, dim=-1)
    else:
        steps = torch.arange(1, hp + 1, dtype=points.dtype,
                             device=points.device)
        ss = s0[..., None] + h[..., None] * steps
    return point_at_arclength(points, valid, ss)


# The batch axes (instances, vehicles) are leading axes of the same function.
sample_reference_batch = sample_reference
