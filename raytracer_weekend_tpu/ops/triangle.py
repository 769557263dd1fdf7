"""Möller–Trumbore triangle intersection factored into matrix products.

Rebuild of Triangle::hit (triangular.rs:97-138). The reference computes, per
scalar ray and triangle (with ao = o - v0):

    det   = -d . n,          n = (v1-v0) x (v2-v0)
    u*det =  ac . (ao x d)
    v*det = -ab . (ao x d)
    t*det =  ao . n

The pairwise cross product (ao x d) would be a (B,T,3) tensor; instead we
expand with the scalar-triple identity  x.(y x d) = d.(x x y):

    ac . (ao x d) = (o x d).ac - d.(ac x v0)
    ab . (ao x d) = (o x d).ab - d.(ab x v0)
    ao . n        =  o.n - (v0.n)

so with per-ray w = o x d (B,3) and per-triangle precomputed rows
{n, ab, ac, ac x v0, ab x v0, v0.n}, ALL pairwise terms are (B,3)x(3,T)
matrix products (at HIGHEST precision: no TF32), leaving only elementwise
compares and a min-reduce at (B,T).

Barycentric normal/UV interpolation (triangular.rs:126-127, 314-324) happens
in `triangle_record` on winners only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array

from raytracer_weekend_tpu.scene.data import Triangles
from raytracer_weekend_tpu.vecmath import cross, dot, ray_at

_INF = jnp.inf

# Exact f32 products: no TF32 or bf16 passes on any backend.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _tri_rows(tr: Triangles):
    ab = tr.v1 - tr.v0                      # (T,3)
    ac = tr.v2 - tr.v0
    n = cross(ab, ac)                       # unnormalized face normal
    ac_x_v0 = cross(ac, tr.v0)
    ab_x_v0 = cross(ab, tr.v0)
    v0_n = dot(tr.v0, n)                    # (T,)
    return ab, ac, n, ac_x_v0, ab_x_v0, v0_n


def hit_triangles(tr: Triangles, o: Array, d: Array, t_min: float,
                  t_max: Array | float = _INF) -> tuple[Array, Array]:
    """Closest triangle hit per ray -> (t (B,), idx (B,)); +inf on miss."""
    ab, ac, n, ac_x_v0, ab_x_v0, v0_n = _tri_rows(tr)

    w = cross(o, d)                          # (B,3) per-ray

    det = -_mm(d, n.T)                       # (B,T)
    u_num = _mm(w, ac.T) - _mm(d, ac_x_v0.T)
    v_num = -(_mm(w, ab.T) - _mm(d, ab_x_v0.T))
    t_num = _mm(o, n.T) - v0_n[None, :]

    # det == 0 -> parallel ray; guard the division for gradient safety and
    # mask the lane off (the reference's inf/NaN compares also reject it).
    degenerate = det == 0.0
    inv_det = 1.0 / jnp.where(degenerate, 1.0, det)

    u = u_num * inv_det
    v = v_num * inv_det
    t = t_num * inv_det

    hit = (
        (t >= t_min) & (t <= t_max) & (t >= 0.0)      # triangular.rs:120-124
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & ~degenerate
        & tr.valid[None, :]
    )
    t_all = jnp.where(hit, t, _INF)
    idx = jnp.argmin(t_all, axis=-1)
    return jnp.min(t_all, axis=-1), idx


def triangle_record(tr: Triangles, idx: Array, o: Array, d: Array, t: Array):
    """Hit record for winning triangles: recompute (u,v) for one triangle per
    ray (cheap scalar math) and interpolate normals/UVs barycentrically.

    Returns (p, outward_normal, u, v, mat). The interpolated normal is NOT
    normalized, matching the reference (triangular.rs:126: raw barycentric
    mix of vertex normals; face normals are raw cross products).
    """
    v0 = tr.v0[idx]
    v1 = tr.v1[idx]
    v2 = tr.v2[idx]
    ab = v1 - v0
    ac = v2 - v0
    n = cross(ab, ac)
    det = -dot(d, n)
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
    ao = o - v0
    ao_x_d = cross(ao, d)
    u = dot(ac, ao_x_d) * inv_det
    v = -dot(ab, ao_x_d) * inv_det

    w0 = (1.0 - u - v)[:, None]
    wu = u[:, None]
    wv = v[:, None]
    normal = w0 * tr.n0[idx] + wu * tr.n1[idx] + wv * tr.n2[idx]
    uv = w0 * tr.uv0[idx] + wu * tr.uv1[idx] + wv * tr.uv2[idx]

    p = ray_at(o, d, t)
    return p, normal, uv[..., 0], uv[..., 1], tr.mat[idx]
