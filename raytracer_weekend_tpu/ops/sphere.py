"""Sphere intersection as batched matrix products (the plain op).

Rebuild of `hit_sphere` (spherical.rs:18-60) + `MovingSphere::center_at_time`
(spherical.rs:117-123). The reference tests one scalar ray against one sphere;
here B rays meet S spheres at once, and every ray-sphere pairwise dot product
is factored into (B,3)x(3,S) matrix products:

    half_b[b,s] = d_b . (o_b - c_s(t_b)) = (o_b . d_b) - d_b . c_s(t_b)
    c_s(t)      = c0_s + w * (c1_s - c0_s),   w = (t - t0_s)/(t1_s - t0_s)
    d . c(t)    = (D C0^T) + w * (D dC^T)        <- two matmuls
    |c(t)|^2    = |c0|^2 + 2w (c0.dc) + w^2 |dc|^2   <- per-sphere scalars

so the only (B,S)-sized work is elementwise math plus a min-reduce. Static
spheres are just rows with c1 == c0. The products run at HIGHEST precision:
a DEFAULT f32 product may run in TF32 on a GPU, whose 10 mantissa bits flip
near-tangent hits. This op is the reference for the GPU kernel in
ops/pallas/sphere_intersect.py and the path on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array

from raytracer_weekend_tpu.scene.data import Spheres
from raytracer_weekend_tpu.vecmath import dot, ray_at

_INF = jnp.inf
_TWO_PI = 2.0 * jnp.pi

# Exact f32 products: no TF32 or bf16 passes on any backend.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _centers_weight(sp: Spheres, time: Array) -> Array:
    """Motion-blur lerp weight w[b,s] (spherical.rs:117-123)."""
    return (time[:, None] - sp.t0[None, :]) / (sp.t1 - sp.t0)[None, :]


def hit_spheres(sp: Spheres, o: Array, d: Array, time: Array, t_min: float,
                t_max: Array | float = _INF) -> tuple[Array, Array]:
    """Closest sphere hit per ray.

    Args:
      sp: sphere table (S rows, padded rows have valid=False).
      o, d: ray origins/directions (B,3); d unnormalized as in the reference.
      time: per-ray shutter times (B,).
      t_min, t_max: acceptance range (lib.rs:102 uses [1e-3, inf)).

    Returns:
      (t, idx): per-ray hit distance (B,), +inf on miss, and winning row (B,).
    """
    dc = sp.c1 - sp.c0                      # (S,3)
    w = _centers_weight(sp, time)           # (B,S)

    # All pairwise ray-sphere dots as matmuls.
    o_c0 = _mm(o, sp.c0.T)                  # (B,S)
    o_dc = _mm(o, dc.T)
    d_c0 = _mm(d, sp.c0.T)
    d_dc = _mm(d, dc.T)

    a = dot(d, d)[:, None]                  # (B,1)
    o_dot_d = dot(o, d)[:, None]
    o_sq = dot(o, o)[:, None]
    c0_sq = dot(sp.c0, sp.c0)[None, :]      # (1,S)
    c0_dc = dot(sp.c0, dc)[None, :]
    dc_sq = dot(dc, dc)[None, :]

    d_dot_c = d_c0 + w * d_dc
    o_dot_c = o_c0 + w * o_dc
    c_sq = c0_sq + 2.0 * w * c0_dc + w * w * dc_sq

    half_b = o_dot_d - d_dot_c                               # d.(o-c)
    c_term = o_sq - 2.0 * o_dot_c + c_sq - (sp.radius**2)[None, :]

    disc = half_b * half_b - a * c_term
    has_roots = disc > 0.0
    # Grad-safe sqrt: sqrt'(0) is inf, so compute on a guarded operand.
    sqrtd = jnp.sqrt(jnp.where(has_roots, disc, 1.0))

    inv_a = 1.0 / a
    root1 = (-half_b - sqrtd) * inv_a
    root2 = (-half_b + sqrtd) * inv_a
    # Nearest root in range, else the far root (spherical.rs:38-44).
    r1_ok = (root1 >= t_min) & (root1 <= t_max)
    root = jnp.where(r1_ok, root1, root2)
    in_range = (root >= t_min) & (root <= t_max)

    hit = has_roots & in_range & sp.valid[None, :]
    t_all = jnp.where(hit, root, _INF)      # (B,S)

    idx = jnp.argmin(t_all, axis=-1)
    t = jnp.min(t_all, axis=-1)
    return t, idx


def sphere_uv(outward_normal: Array) -> tuple[Array, Array]:
    """Spherical UV of a unit point (spherical.rs:62-77).

    The clip bound is pulled fractionally inside ±1 so arccos' stays finite
    at the poles (backward-pass NaN guard).
    """
    theta = jnp.arccos(jnp.clip(-outward_normal[..., 1], -0.9999999, 0.9999999))
    phi = jnp.arctan2(-outward_normal[..., 2], outward_normal[..., 0]) + jnp.pi
    return phi / _TWO_PI, theta / jnp.pi


def sphere_record(sp: Spheres, idx: Array, o: Array, d: Array, time: Array,
                  t: Array):
    """Reconstruct the hit record for winning sphere rows.

    Returns (p (B,3), outward_normal (B,3), u (B,), v (B,), mat (B,)).
    The outward normal is (p - c)/r (spherical.rs:47): a negative radius
    flips it inward, which is how the reference models hollow glass.
    """
    c0 = sp.c0[idx]
    c1 = sp.c1[idx]
    t0 = sp.t0[idx]
    t1 = sp.t1[idx]
    r = sp.radius[idx]
    w = (time - t0) / (t1 - t0)
    center = c0 + w[:, None] * (c1 - c0)
    p = ray_at(o, d, t)
    outward = (p - center) / r[:, None]
    u, v = sphere_uv(outward)
    return p, outward, u, v, sp.mat[idx]
