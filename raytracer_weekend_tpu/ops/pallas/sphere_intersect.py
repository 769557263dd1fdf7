"""Sphere closest hit as a Pallas kernel on the Triton route.

The plain op (ops/sphere.py) materialises four to six (rays x spheres)
planes in device memory per bounce. Here one program takes a block of rays,
walks the sphere table in chunks with a `fori_loop`, evaluates each
(block x chunk) tile in registers with plain FMA arithmetic, and keeps only
the running (t, idx) per ray. Device memory sees the (B,) inputs and
outputs and the table, nothing of size B*S.

The arithmetic is the plain op's, term for term (the expanded dot products
of ops/sphere.py, with the per-ray and per-sphere scalars computed outside
by the same jnp code), and ties resolve to the first minimum like its
`argmin`, so the two agree up to float rounding.

The backward is a `custom_vjp` that recomputes only the winning sphere's
root per ray: O(B) residuals instead of O(B*S).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytracer_weekend_tpu.scene.data import Spheres
from raytracer_weekend_tpu.vecmath import dot

_INF = jnp.inf


class Tiling(NamedTuple):
    """Launch shape: rays per program, table rows per loop step (both powers
    of two, as Triton requires), and the Triton compiler's warps/stages."""

    block_b: int = 128
    chunk: int = 4
    num_warps: int = 4
    num_stages: int = 1


# Fastest measured on an H100 (tools/kernel_tune.py; PERF.md).
SPHERE_TILING = Tiling(block_b=256)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, time_ref,
            a_ref, od_ref, oo_ref,
            c0x_ref, c0y_ref, c0z_ref, dcx_ref, dcy_ref, dcz_ref,
            t0_ref, dt_ref, c0sq_ref, c0dc_ref, dcsq_ref, r2_ref, valid_ref,
            t_out, idx_out, *, t_min: float, chunk: int):
    def col(ref):                       # (BB,) ray block -> (BB, 1)
        return ref[...][:, None]

    ox, oy, oz = col(ox_ref), col(oy_ref), col(oz_ref)
    dx, dy, dz = col(dx_ref), col(dy_ref), col(dz_ref)
    time, a, o_dot_d, o_sq = col(time_ref), col(a_ref), col(od_ref), col(oo_ref)
    n_rays = ox_ref.shape[0]
    n_chunks = c0x_ref.shape[0] // chunk

    def body(j, carry):
        t_best, i_best = carry
        rows = pl.ds(pl.multiple_of(j * chunk, chunk), chunk)

        def row(ref):                   # (C,) table chunk -> (1, C)
            return ref[rows][None, :]

        c0x, c0y, c0z = row(c0x_ref), row(c0y_ref), row(c0z_ref)
        dcx, dcy, dcz = row(dcx_ref), row(dcy_ref), row(dcz_ref)

        w = (time - row(t0_ref)) / row(dt_ref)
        o_c0 = ox * c0x + oy * c0y + oz * c0z
        o_dc = ox * dcx + oy * dcy + oz * dcz
        d_c0 = dx * c0x + dy * c0y + dz * c0z
        d_dc = dx * dcx + dy * dcy + dz * dcz

        d_dot_c = d_c0 + w * d_dc
        o_dot_c = o_c0 + w * o_dc
        c_sq = row(c0sq_ref) + 2.0 * w * row(c0dc_ref) + w * w * row(dcsq_ref)

        half_b = o_dot_d - d_dot_c
        c_term = o_sq - 2.0 * o_dot_c + c_sq - row(r2_ref)
        disc = half_b * half_b - a * c_term
        has_roots = disc > 0.0
        sqrtd = jnp.sqrt(jnp.where(has_roots, disc, 1.0))
        inv_a = 1.0 / a
        root1 = (-half_b - sqrtd) * inv_a
        root2 = (-half_b + sqrtd) * inv_a
        root = jnp.where(root1 >= t_min, root1, root2)
        hit = has_roots & (root >= t_min) & (row(valid_ref) > 0.0)
        t_all = jnp.where(hit, root, _INF)

        t_c = jnp.min(t_all, axis=1)
        i_c = jnp.argmin(t_all, axis=1).astype(jnp.int32) + j * chunk
        better = t_c < t_best           # strict: earlier chunk wins ties
        return jnp.where(better, t_c, t_best), jnp.where(better, i_c, i_best)

    t, idx = jax.lax.fori_loop(
        0, n_chunks, body,
        (jnp.full((n_rays,), _INF, jnp.float32),
         jnp.zeros((n_rays,), jnp.int32)))
    t_out[...] = t
    idx_out[...] = idx


def _forward(sp: Spheres, o: Array, d: Array, time: Array, t_min: float,
             interpret: bool, tiling: Tiling) -> tuple[Array, Array]:
    B = o.shape[0]
    S = sp.radius.shape[0]
    bb, chunk = tiling.block_b, tiling.chunk
    b_pad = _round_up(max(B, 1), bb)
    s_pad = _round_up(max(S, 1), chunk)

    # Per-ray and per-sphere scalars: the same jnp expressions as the plain
    # op, so both paths start from identical rounded values.
    dc = sp.c1 - sp.c0
    per_ray = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], time,
               dot(d, d), dot(o, d), dot(o, o)]
    per_ray = [jnp.pad(x.astype(jnp.float32), (0, b_pad - B))
               for x in per_ray]

    def tab(x, fill=0.0):
        return jnp.pad(x.astype(jnp.float32), (0, s_pad - S),
                       constant_values=fill)

    table = [tab(sp.c0[:, 0]), tab(sp.c0[:, 1]), tab(sp.c0[:, 2]),
             tab(dc[:, 0]), tab(dc[:, 1]), tab(dc[:, 2]),
             tab(sp.t0), tab(sp.t1 - sp.t0, fill=1.0),
             tab(dot(sp.c0, sp.c0)), tab(dot(sp.c0, dc)), tab(dot(dc, dc)),
             tab(sp.radius ** 2), tab(sp.valid)]

    ray_spec = pl.BlockSpec((bb,), lambda i: (i,))
    table_spec = pl.BlockSpec((s_pad,), lambda i: (0,))
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
        name="hit_spheres",
    )(*per_ray, *table)
    return t[:B], idx[:B]


# Tables of at most this many rows take the transpose of the backward's
# row gather as a one-hot reduction: a scatter-add of every ray into a
# handful of rows serialises on atomics. Measured on an H100 (PERF.md):
# with the scatter, Cornell's 6 rects made fwd+bwd 2.3% slower than the
# plain op.
ONE_HOT_MAX_ROWS = 64


@jax.custom_vjp
def take_rows(table: Array, idx: Array) -> Array:
    """table[idx] along axis 0, with a contention-free transpose for small
    tables (see ONE_HOT_MAX_ROWS)."""
    return table[idx]


def _take_rows_fwd(table, idx):
    return table[idx], (idx, table.shape[0])


def _take_rows_bwd(res, ct):
    idx, rows = res
    if rows <= ONE_HOT_MAX_ROWS:
        onehot = jax.nn.one_hot(idx, rows, dtype=ct.dtype)
        g = jnp.einsum("br,b...->r...", onehot, ct,
                       precision=jax.lax.Precision.HIGHEST)
    else:
        g = jnp.zeros((rows,) + ct.shape[1:], ct.dtype).at[idx].add(ct)
    return g, None


take_rows.defvjp(_take_rows_fwd, _take_rows_bwd)


def _winning_root(sp: Spheres, o, d, time, idx, t_min):
    """Differentiable recompute of the winning sphere's accepted root
    (one gathered sphere per ray; same root selection as the kernel)."""
    c0 = take_rows(sp.c0, idx)
    c1 = take_rows(sp.c1, idx)
    t0 = take_rows(sp.t0, idx)
    w = ((time - t0) / (take_rows(sp.t1, idx) - t0))[:, None]
    c = c0 + w * (c1 - c0)
    r = take_rows(sp.radius, idx)
    oc = o - c
    a = jnp.sum(d * d, -1)
    half_b = jnp.sum(oc * d, -1)
    c_term = jnp.sum(oc * oc, -1) - r * r
    disc = half_b * half_b - a * c_term
    ok = disc > 0.0
    sqrtd = jnp.sqrt(jnp.where(ok, disc, 1.0))
    inv_a = 1.0 / a
    root1 = (-half_b - sqrtd) * inv_a
    root2 = (-half_b + sqrtd) * inv_a
    return jnp.where(root1 >= t_min, root1, root2)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6))
def hit_spheres_pallas(sp: Spheres, o: Array, d: Array, time: Array,
                       t_min: float, interpret: bool = False,
                       tiling: Tiling = SPHERE_TILING
                       ) -> tuple[Array, Array]:
    """Same contract as ops.sphere.hit_spheres: (t (B,), idx (B,)), +inf on
    miss. `interpret=True` runs the kernel in the Pallas interpreter (for
    tests off the card)."""
    return _forward(sp, o, d, time, t_min, interpret, tiling)


def _fwd(sp, o, d, time, t_min, interpret, tiling):
    t, idx = _forward(sp, o, d, time, t_min, interpret, tiling)
    return (t, idx), (sp, o, d, time, idx, t)


def _bwd(t_min, interpret, tiling, res, cot):
    sp, o, d, time, idx, t = res
    ct_t, _ = cot
    ct_t = jnp.where(jnp.isfinite(t), ct_t, 0.0)  # misses carry no gradient

    def f(sp, o, d, time):
        return _winning_root(sp, o, d, time, idx, t_min)

    _, vjp = jax.vjp(f, sp, o, d, time)
    return vjp(ct_t)


hit_spheres_pallas.defvjp(_fwd, _bwd)
