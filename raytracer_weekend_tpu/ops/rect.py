"""Axis-aligned rectangle intersection, one-hot matmul formulation.

Rebuild of XY/XZ/YZRectangle::hit (rectangular.rs:27-167). The reference has
three near-identical scalar impls selected by type; here all rects live in one
table with a fixed-coordinate `axis` id, and the per-(ray, rect) coordinate
picks o[axis_r], d[axis_r] are expressed as (B,3)x(3,R) matmuls against
one-hot axis matrices — gathers with zero data-dependent control flow. The
products run at HIGHEST precision: in TF32 a one-hot pick would truncate
the picked coordinate to 10 mantissa bits. This op is the reference for the
GPU kernel in ops/pallas/rect_intersect.py and the path on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array

from raytracer_weekend_tpu.scene.data import Rects
from raytracer_weekend_tpu.vecmath import ray_at

_INF = jnp.inf

# Exact f32 products: no TF32 or bf16 passes on any backend.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def _axis_onehots(r: Rects) -> tuple[Array, Array, Array]:
    """One-hot (R,3) selectors for the fixed axis and the two varying axes.

    Varying-axis order matches the reference's UV order:
      axis 0 (YZ rect): (a,b) = (y,z); axis 1 (XZ): (x,z); axis 2 (XY): (x,y).
    """
    f = jax.nn.one_hot(r.axis, 3, dtype=jnp.float32)
    a_axis = jnp.where(r.axis == 0, 1, 0)
    b_axis = jnp.where(r.axis == 2, 1, 2)
    a = jax.nn.one_hot(a_axis, 3, dtype=jnp.float32)
    b = jax.nn.one_hot(b_axis, 3, dtype=jnp.float32)
    return f, a, b


def hit_rects(rc: Rects, o: Array, d: Array, t_min: float,
              t_max: Array | float = _INF) -> tuple[Array, Array]:
    """Closest rect hit per ray -> (t (B,), idx (B,)); +inf on miss."""
    f, a, b = _axis_onehots(rc)

    o_f = _mm(o, f.T)  # (B,R) — ray origin component along each rect's axis
    d_f = _mm(d, f.T)
    o_a = _mm(o, a.T)
    d_a = _mm(d, a.T)
    o_b = _mm(o, b.T)
    d_b = _mm(d, b.T)

    t = (rc.k[None, :] - o_f) / d_f        # rectangular.rs:33 (÷0 -> ±inf, misses)
    av = o_a + t * d_a
    bv = o_b + t * d_b

    hit = (
        (t >= t_min) & (t <= t_max)
        & (av >= rc.a0[None, :]) & (av <= rc.a1[None, :])
        & (bv >= rc.b0[None, :]) & (bv <= rc.b1[None, :])
        & rc.valid[None, :]
    )
    t_all = jnp.where(hit, t, _INF)
    idx = jnp.argmin(t_all, axis=-1)
    return jnp.min(t_all, axis=-1), idx


def rect_record(rc: Rects, idx: Array, o: Array, d: Array, t: Array):
    """Hit record for winning rect rows.

    Returns (p, outward_normal, u, v, mat). The outward normal is the +unit
    vector of the fixed axis (rectangular.rs:46,101,156); UV is the
    normalized in-plane position.
    """
    axis = rc.axis[idx]                     # (B,)
    a_axis = jnp.where(axis == 0, 1, 0)
    b_axis = jnp.where(axis == 2, 1, 2)

    p = ray_at(o, d, t)
    av = jnp.take_along_axis(p, a_axis[:, None], axis=-1)[..., 0]
    bv = jnp.take_along_axis(p, b_axis[:, None], axis=-1)[..., 0]

    a0 = rc.a0[idx]
    a1 = rc.a1[idx]
    b0 = rc.b0[idx]
    b1 = rc.b1[idx]
    u = (av - a0) / (a1 - a0)
    v = (bv - b0) / (b1 - b0)

    outward = jax.nn.one_hot(axis, 3, dtype=p.dtype)
    return p, outward, u, v, rc.mat[idx]
