"""Axis-aligned rect closest hit as a Pallas kernel on the Triton route.

Same shape as the sphere kernel: one program per block of rays, a
`fori_loop` over chunks of the rect table, the (block x chunk) tile in
registers, the running (t, idx) per ray as the only state. The plain op's
one-hot products pick o[axis] exactly (at HIGHEST precision); here the pick
is a select, which is exact too, so both compute the same t.

The backward is a `custom_vjp` that recomputes the winning rect's t only.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytracer_weekend_tpu.ops.pallas.sphere_intersect import (
    Tiling, _round_up, take_rows)
from raytracer_weekend_tpu.scene.data import Rects

_INF = jnp.inf

# Fastest measured on an H100: one rect per loop step (tools/kernel_tune.py;
# PERF.md).
RECT_TILING = Tiling(chunk=1)


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
            axis_ref, k_ref, a0_ref, a1_ref, b0_ref, b1_ref, valid_ref,
            t_out, idx_out, *, t_min: float, chunk: int):
    def col(ref):
        return ref[...][:, None]

    ox, oy, oz = col(ox_ref), col(oy_ref), col(oz_ref)
    dx, dy, dz = col(dx_ref), col(dy_ref), col(dz_ref)
    n_rays = ox_ref.shape[0]
    n_chunks = k_ref.shape[0] // chunk

    def body(j, carry):
        t_best, i_best = carry
        rows = pl.ds(pl.multiple_of(j * chunk, chunk), chunk)

        def row(ref):
            return ref[rows][None, :]

        axis = row(axis_ref)
        is_x, is_y = axis == 0, axis == 1
        # Fixed axis f, then the varying axes in the reference's UV order:
        # YZ rect (axis 0) -> (y, z); XZ (1) -> (x, z); XY (2) -> (x, y).
        o_f = jnp.where(is_x, ox, jnp.where(is_y, oy, oz))
        d_f = jnp.where(is_x, dx, jnp.where(is_y, dy, dz))
        o_a = jnp.where(is_x, oy, ox)
        d_a = jnp.where(is_x, dy, dx)
        is_xy = axis == 2
        o_b = jnp.where(is_xy, oy, oz)
        d_b = jnp.where(is_xy, dy, dz)

        t = (row(k_ref) - o_f) / d_f
        av = o_a + t * d_a
        bv = o_b + t * d_b
        hit = ((t >= t_min)
               & (av >= row(a0_ref)) & (av <= row(a1_ref))
               & (bv >= row(b0_ref)) & (bv <= row(b1_ref))
               & (row(valid_ref) > 0.0))
        t_all = jnp.where(hit, t, _INF)

        t_c = jnp.min(t_all, axis=1)
        i_c = jnp.argmin(t_all, axis=1).astype(jnp.int32) + j * chunk
        better = t_c < t_best
        return jnp.where(better, t_c, t_best), jnp.where(better, i_c, i_best)

    t, idx = jax.lax.fori_loop(
        0, n_chunks, body,
        (jnp.full((n_rays,), _INF, jnp.float32),
         jnp.zeros((n_rays,), jnp.int32)))
    t_out[...] = t
    idx_out[...] = idx


def _forward(rc: Rects, o: Array, d: Array, t_min: float, interpret: bool,
             tiling: Tiling) -> tuple[Array, Array]:
    B = o.shape[0]
    R = rc.k.shape[0]
    bb, chunk = tiling.block_b, tiling.chunk
    b_pad = _round_up(max(B, 1), bb)
    r_pad = _round_up(max(R, 1), chunk)

    per_ray = [jnp.pad(x.astype(jnp.float32), (0, b_pad - B))
               for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]

    def tab(x, dtype=jnp.float32):
        return jnp.pad(x.astype(dtype), (0, r_pad - R))

    table = [tab(rc.axis, jnp.int32), tab(rc.k), tab(rc.a0), tab(rc.a1),
             tab(rc.b0), tab(rc.b1), tab(rc.valid)]

    ray_spec = pl.BlockSpec((bb,), lambda i: (i,))
    table_spec = pl.BlockSpec((r_pad,), lambda i: (0,))
    t, idx = pl.pallas_call(
        functools.partial(_kernel, t_min=float(t_min), chunk=chunk),
        grid=(b_pad // bb,),
        in_specs=[ray_spec] * len(per_ray) + [table_spec] * len(table),
        out_specs=[ray_spec, ray_spec],
        out_shape=[jax.ShapeDtypeStruct((b_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((b_pad,), jnp.int32)],
        compiler_params=plgpu.CompilerParams(
            num_warps=tiling.num_warps, num_stages=tiling.num_stages),
        interpret=interpret,
        name="hit_rects",
    )(*per_ray, *table)
    return t[:B], idx[:B]


def _winning_t(rc: Rects, o, d, idx):
    axis = rc.axis[idx]
    o_f = jnp.take_along_axis(o, axis[:, None], axis=-1)[..., 0]
    d_f = jnp.take_along_axis(d, axis[:, None], axis=-1)[..., 0]
    return (take_rows(rc.k, idx) - o_f) / jnp.where(d_f == 0.0, 1.0, d_f)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def hit_rects_pallas(rc: Rects, o: Array, d: Array, t_min: float,
                     interpret: bool = False,
                     tiling: Tiling = RECT_TILING) -> tuple[Array, Array]:
    """Same contract as ops.rect.hit_rects: (t (B,), idx (B,)), +inf on
    miss. `interpret=True` runs the Pallas interpreter (tests off the
    card)."""
    return _forward(rc, o, d, t_min, interpret, tiling)


def _fwd(rc, o, d, t_min, interpret, tiling):
    t, idx = _forward(rc, o, d, t_min, interpret, tiling)
    return (t, idx), (rc, o, d, idx, t)


def _bwd(t_min, interpret, tiling, res, cot):
    rc, o, d, idx, t = res
    ct_t, _ = cot
    ct_t = jnp.where(jnp.isfinite(t), ct_t, 0.0)

    def f(rc, o, d):
        return _winning_t(rc, o, d, idx)

    _, vjp = jax.vjp(f, rc, o, d)
    return vjp(ct_t)


hit_rects_pallas.defvjp(_fwd, _bwd)
