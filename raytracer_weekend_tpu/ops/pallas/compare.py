"""Agreement check between a closest-hit kernel and its plain op.

Two correct float32 implementations that round differently agree on most
rays to a few ulp, but not on all: a ray tangent to a sphere, or passing
within rounding of a rect's edge, may hit in one and miss in the other, and
the root of an ill-conditioned quadratic (near-tangent rays, or |c|^2 and
r^2 cancelling for the huge ground spheres of the catalog) can move by more
than 1e-5 relative. This module recomputes, in float64 on the host, the
rounding bound of each ray's decision, and accepts a difference only where
the bound explains it:

  * winners agree: |dt| <= max(1e-5 t, bound on t's float32 error);
  * winners differ, or hit/miss differs: the two t are a near tie, or one
    candidate's hit test is a knife edge (its margin within the bound).

`compare_hits` returns the counts; the caller asserts on them.
"""

from __future__ import annotations

import numpy as np

_EPS = float(np.finfo(np.float32).eps)
_SLACK = 16.0          # ulps of slack on each float32 bound
RTOL = 1e-5


def sphere_terms(sp, o, d, time, idx):
    """float64 quadratic of ray i against sphere idx[i], with the float32
    error bounds of the expanded formulation of ops/sphere.py."""
    c0 = np.asarray(sp.c0, np.float64)[idx]
    c1 = np.asarray(sp.c1, np.float64)[idx]
    t0 = np.asarray(sp.t0, np.float64)[idx]
    t1 = np.asarray(sp.t1, np.float64)[idx]
    r = np.asarray(sp.radius, np.float64)[idx]
    w = ((time - t0) / (t1 - t0))[:, None]
    c = c0 + w * (c1 - c0)
    oc = o - c
    a = np.sum(d * d, -1)
    hb = np.sum(d * oc, -1)
    c_term = np.sum(oc * oc, -1) - r * r
    disc = hb * hb - a * c_term
    scale_c = (np.sum(o * o, -1) + 2 * np.abs(np.sum(o * c, -1))
               + np.sum(c * c, -1) + r * r)
    d_disc = _SLACK * _EPS * (hb * hb + a * scale_c)
    sq = np.sqrt(np.maximum(disc, 0.0))
    d_t = d_disc / (2 * a * np.maximum(sq, np.sqrt(d_disc)))
    return disc, d_disc, sq, a, hb, d_t


def _sphere_bounds(sp, o, d, time, idx, t, t_min):
    """(knife_edge, t_error_bound) per ray for winner idx."""
    disc, d_disc, sq, a, hb, d_t = sphere_terms(sp, o, d, time, idx)
    root1 = (-hb - sq) / a
    root2 = (-hb + sq) / a
    d_t = d_t + _SLACK * _EPS * np.abs(np.where(np.isfinite(t), t, 0.0))
    # Tangent rays, and either root within rounding of t_min (a ray that
    # starts on a sphere's surface has a root near 0 whose sign is noise).
    knife = ((np.abs(disc) <= d_disc) | (np.abs(root1 - t_min) <= d_t)
             | (np.abs(root2 - t_min) <= d_t))
    return knife, d_t


def _rect_bounds(rc, o, d, idx, t, t_min):
    axis = np.asarray(rc.axis)[idx]
    rows = np.arange(len(idx))
    a_ax = np.where(axis == 0, 1, 0)
    b_ax = np.where(axis == 2, 1, 2)
    k = np.asarray(rc.k, np.float64)[idx]
    o_f, d_f = o[rows, axis], d[rows, axis]
    tt = (k - o_f) / np.where(d_f == 0, np.inf, d_f)
    d_t = _SLACK * _EPS * (np.abs(tt) + (np.abs(k) + np.abs(o_f))
                           / np.maximum(np.abs(d_f), 1e-30))
    margin = np.inf
    for ax, lo, hi in ((a_ax, rc.a0, rc.a1), (b_ax, rc.b0, rc.b1)):
        lo = np.asarray(lo, np.float64)[idx]
        hi = np.asarray(hi, np.float64)[idx]
        v = o[rows, ax] + tt * d[rows, ax]
        scale = np.abs(o[rows, ax]) + np.abs(tt * d[rows, ax]) + np.abs(v)
        tol = _SLACK * _EPS * scale + np.abs(d[rows, ax]) * d_t
        margin = np.minimum(margin, np.minimum(np.abs(v - lo),
                                               np.abs(v - hi)) - tol)
    knife = (margin <= 0) | (np.abs(tt - t_min) <= d_t)
    return knife, d_t


def compare_hits(family: str, table, rays, t_k, i_k, t_p, i_p,
                 t_min: float) -> dict:
    """Compare kernel (t_k, i_k) with plain (t_p, i_p) for `family`
    ("sphere" or "rect") on `rays` = (o, d[, time]). Returns counts; the
    check passes when `unexplained == 0` and `idx_agree >= 0.9999`."""
    t_k, t_p = np.asarray(t_k, np.float64), np.asarray(t_p, np.float64)
    i_k, i_p = np.asarray(i_k), np.asarray(i_p)
    o = np.asarray(rays[0], np.float64)
    d = np.asarray(rays[1], np.float64)

    def bounds(idx, t):
        if family == "sphere":
            time = np.asarray(rays[2], np.float64)
            return _sphere_bounds(table, o, d, time, idx, t, t_min)
        return _rect_bounds(table, o, d, idx, t, t_min)

    hit_k, hit_p = np.isfinite(t_k), np.isfinite(t_p)
    same = (i_k == i_p) & (hit_k == hit_p)
    both = hit_k & hit_p
    knife_k, dt_k = bounds(i_k, t_k)
    knife_p, dt_p = bounds(i_p, t_p)

    err = np.abs(np.where(both, t_k, 0.0) - np.where(both, t_p, 0.0))
    scale = np.abs(np.where(both, t_p, 0.0))
    agree_ok = err <= np.maximum(RTOL * scale, dt_p)
    near_tie = both & (err <= np.maximum(RTOL * scale,
                                         np.maximum(dt_k, dt_p)))
    differ_ok = near_tie | (hit_k & knife_k) | (hit_p & knife_p)

    bad = np.where(same & both, ~agree_ok, False) | (~same & ~differ_ok)
    rel = err / np.maximum(scale, 1e-30)
    return dict(
        rays=int(t_k.size), hits=int(hit_p.sum()),
        idx_agree=float(same.mean()),
        mismatches=int((~same).sum()),
        mismatch_near_ties=int((~same & near_tie).sum()),
        mismatch_knife_edges=int((~same & ~near_tie & differ_ok).sum()),
        miss_set_differences=int((hit_k != hit_p).sum()),
        max_rel_dt=float(rel[same & both].max(initial=0.0)),
        beyond_rtol=int((same & both & (rel > RTOL)).sum()),
        unexplained=int(bad.sum()),
    )


def passes(stats: dict) -> bool:
    return stats["unexplained"] == 0 and stats["idx_agree"] >= 0.9999
