"""Wavefront path-tracing integrator.

Rebuild of the reference render driver (raytracer_weekend_lib/src/lib.rs):

    render()      lib.rs:57-76  — pixel iterator               -> render_image
    sample_pixel  lib.rs:78-95  — spp loop + film jitter       -> ray megabatch
    sample_ray    lib.rs:97-117 — recursive radiance estimate  -> depth lax.scan

The recursion  `emitted + attenuation * sample_ray(scattered, depth-1)`
(lib.rs:116) is re-associated into the iterative wavefront form

    radiance  += throughput * emitted
    throughput *= attenuation

carried through a `lax.scan` over bounce depth with SoA ray state — the
scan-friendly, differentiable formulation. Termination (miss -> background
lib.rs:102-105, light/absorb -> stop) becomes an `alive` mask; the reference's
depth==0 -> black cutoff (lib.rs:98-100) is the scan simply ending with
whatever throughput remains unspent.

Closest-hit search over the heterogeneous world (hittable/mod.rs:56-69's
linear scan) becomes: each primitive family's batched kernel returns its
per-ray closest candidate, and a 4-way min picks the winner.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from raytracer_weekend_tpu import materials as mat_mod
from raytracer_weekend_tpu import rng as rt_rng
from raytracer_weekend_tpu.camera import Camera, get_rays
from raytracer_weekend_tpu.config import RenderConfig
from raytracer_weekend_tpu.ops import (
    hit_rects, hit_spheres, hit_triangles, hit_volumes,
    rect_record, sphere_record, triangle_record, volume_record,
)
from raytracer_weekend_tpu.ops import bvh as bvh_mod
from raytracer_weekend_tpu.ops.pallas import (hit_rects_pallas,
                                              hit_spheres_pallas)
from raytracer_weekend_tpu.scene.data import SceneData, SceneStatic
from raytracer_weekend_tpu.utils.platform import target_platform
from raytracer_weekend_tpu.vecmath import dot

_INF = jnp.inf

# Family ids for the winner select.
_FAM_NONE, _FAM_SPHERE, _FAM_RECT, _FAM_TRI, _FAM_VOL = -1, 0, 1, 2, 3


class HitPaths(NamedTuple):
    """Closest-hit implementation per family: "kernel" (the Triton-route
    Pallas kernel of ops.pallas), "bvh" (stackless traversal of the tree
    build_scene attached) or "plain" (the brute-force jnp op)."""

    sphere: str
    rect: str
    triangle: str


# Largest sphere table the GPU kernel takes even when build_scene attached
# a BVH. Measured on an H100 (PERF.md): at book2's 1,006 spheres the
# kernel renders the frame 2.7x faster than the BVH traversal; linear
# extrapolation of the kernel's per-sphere cost puts the break-even near
# 5k spheres, not measured yet.
GPU_SPHERE_KERNEL_MAX = 4096


def hit_paths(static: SceneStatic, platform: str, *, sphere_bvh: bool,
              triangle_bvh: bool) -> HitPaths:
    """Choose each family's closest-hit path for `platform`.

    On the GPU, spheres (up to GPU_SPHERE_KERNEL_MAX) and rects run as
    kernels that keep the (rays x primitives) tile out of device memory.
    Otherwise a family with a BVH takes it: build_scene attaches one above
    its table-size cut-offs (scene.builder.AUTO_BVH_MIN_*), and
    pad_scene_for_geom may drop the trees under geometry sharding, hence
    the flags come from the scene pytree, not from `static`. Everything
    else runs the plain op. Triangles have no kernel: meshes above 64
    triangles take the BVH, and the brute force below that is cheap.
    """
    gpu = platform == "gpu"
    if gpu and static.n_spheres <= GPU_SPHERE_KERNEL_MAX:
        sphere = "kernel"
    elif static.sphere_bvh and sphere_bvh:
        sphere = "bvh"
    else:
        sphere = "kernel" if gpu else "plain"
    return HitPaths(
        sphere=sphere,
        rect="kernel" if gpu else "plain",
        triangle="bvh" if (static.triangle_bvh and triangle_bvh)
        else "plain",
    )


def _closest_hit(scene: SceneData, static: SceneStatic, o, d, time,
                 seed, ray_id, depth, cfg: RenderConfig,
                 geom_axis: str | None = None):
    """4-family closest hit. Returns (t, fam, idx) per ray.

    With `geom_axis` set (inside a shard_map), the sphere/triangle tables
    are device-sharded slices: local winners carry globalized indices and
    the cross-device winner is found by an all-gather + min over the axis —
    the renderer's tensor-parallel reduction.
    """
    B = o.shape[0]
    t_best = jnp.full((B,), _INF)
    fam = jnp.full((B,), _FAM_NONE, jnp.int32)
    idx = jnp.zeros((B,), jnp.int32)

    if geom_axis is not None:
        my_shard = jax.lax.axis_index(geom_axis)

    def consider(t_new, i_new, fam_id, t_best, fam, idx, sharded=False,
                 local_rows=0):
        i_new = i_new.astype(jnp.int32)
        if geom_axis is not None and sharded:
            i_new = i_new + my_shard * local_rows
        better = t_new < t_best
        return (
            jnp.where(better, t_new, t_best),
            jnp.where(better, fam_id, fam),
            jnp.where(better, i_new, idx),
        )

    paths = hit_paths(static, target_platform(),
                      sphere_bvh=scene.sphere_bvh is not None,
                      triangle_bvh=scene.triangle_bvh is not None)

    if static.n_spheres:
        if paths.sphere == "kernel":
            t_s, i_s = hit_spheres_pallas(scene.spheres, o, d, time,
                                          cfg.t_min)
        elif paths.sphere == "bvh":
            t_s, i_s = bvh_mod.traverse(
                scene.sphere_bvh, o, d, cfg.t_min,
                bvh_mod.sphere_prim_test(scene.spheres, o, d, time, cfg.t_min))
        else:
            t_s, i_s = hit_spheres(scene.spheres, o, d, time, cfg.t_min)
        t_best, fam, idx = consider(t_s, i_s, _FAM_SPHERE, t_best, fam, idx,
                                    sharded=True,
                                    local_rows=scene.spheres.radius.shape[0])
    if static.n_rects:
        if paths.rect == "kernel":
            t_r, i_r = hit_rects_pallas(scene.rects, o, d, cfg.t_min)
        else:
            t_r, i_r = hit_rects(scene.rects, o, d, cfg.t_min)
        t_best, fam, idx = consider(t_r, i_r, _FAM_RECT, t_best, fam, idx)
    if static.n_triangles:
        if paths.triangle == "bvh":
            t_t, i_t = bvh_mod.traverse(
                scene.triangle_bvh, o, d, cfg.t_min,
                bvh_mod.triangle_prim_test(scene.triangles, o, d, cfg.t_min))
        else:
            t_t, i_t = hit_triangles(scene.triangles, o, d, cfg.t_min)
        t_best, fam, idx = consider(t_t, i_t, _FAM_TRI, t_best, fam, idx,
                                    sharded=True,
                                    local_rows=scene.triangles.mat.shape[0])
    if static.n_volumes:
        t_v, i_v = hit_volumes(
            scene.volumes, o, d, cfg.t_min, seed, ray_id, depth,
            use_log10=cfg.use_log10_volume_sampling,
        )
        t_best, fam, idx = consider(t_v, i_v, _FAM_VOL, t_best, fam, idx)

    if geom_axis is not None:
        # Cross-shard winner: gather (t, fam, idx) from every geometry shard
        # and min-combine — one small all-gather per bounce.
        tg = jax.lax.all_gather(t_best, geom_axis)      # (G, B)
        fg = jax.lax.all_gather(fam, geom_axis)
        ig = jax.lax.all_gather(idx, geom_axis)
        k = jnp.argmin(tg, axis=0)                       # (B,)
        lanes = jnp.arange(B)
        t_best = tg[k, lanes]
        fam = fg[k, lanes]
        idx = ig[k, lanes]

    return t_best, fam, idx


def _hit_record(scene: SceneData, static: SceneStatic, o, d, time, t, fam, idx,
                geom_axis: str | None = None):
    """Branchless union of the per-family hit-record reconstructions.

    With `geom_axis` set, sphere/triangle rows live on exactly one geometry
    shard: the owner computes the record and a psum over the axis broadcasts
    it (replicated families contribute from shard 0 only).
    """
    B = o.shape[0]
    p = jnp.zeros((B, 3))
    outward = jnp.zeros((B, 3))
    u = jnp.zeros((B,))
    v = jnp.zeros((B,))
    mat_id = jnp.zeros((B,), jnp.int32)
    wrote = jnp.zeros((B,), bool)

    if geom_axis is not None:
        my_shard = jax.lax.axis_index(geom_axis)
        is_shard0 = my_shard == 0

    def merge(fam_id, rec, p, outward, u, v, mat_id, wrote, mine=None):
        rp, rn, ru, rv, rm = rec
        m = fam == fam_id
        if mine is not None:
            m = m & mine
        m3 = m[:, None]
        return (
            jnp.where(m3, rp, p),
            jnp.where(m3, rn, outward),
            jnp.where(m, ru, u),
            jnp.where(m, rv, v),
            jnp.where(m, rm, mat_id),
            wrote | m,
        )

    # Guard t for padded lanes so records never see inf.
    t_safe = jnp.where(jnp.isfinite(t), t, 0.0)
    repl_mine = None if geom_axis is None else jnp.full((B,), is_shard0)

    if static.n_spheres:
        rows = scene.spheres.radius.shape[0]
        if geom_axis is None:
            local_idx, mine = idx, None
        else:
            local_idx = jnp.clip(idx - my_shard * rows, 0, rows - 1)
            mine = (idx >= my_shard * rows) & (idx < (my_shard + 1) * rows)
        rec = sphere_record(scene.spheres, local_idx, o, d, time, t_safe)
        p, outward, u, v, mat_id, wrote = merge(
            _FAM_SPHERE, rec, p, outward, u, v, mat_id, wrote, mine)
    if static.n_rects:
        rec = rect_record(scene.rects, idx, o, d, t_safe)
        p, outward, u, v, mat_id, wrote = merge(
            _FAM_RECT, rec, p, outward, u, v, mat_id, wrote, repl_mine)
    if static.n_triangles:
        rows = scene.triangles.mat.shape[0]
        if geom_axis is None:
            local_idx, mine = idx, None
        else:
            local_idx = jnp.clip(idx - my_shard * rows, 0, rows - 1)
            mine = (idx >= my_shard * rows) & (idx < (my_shard + 1) * rows)
        rec = triangle_record(scene.triangles, local_idx, o, d, t_safe)
        p, outward, u, v, mat_id, wrote = merge(
            _FAM_TRI, rec, p, outward, u, v, mat_id, wrote, mine)
    if static.n_volumes:
        rec = volume_record(scene.volumes, idx, o, d, t_safe)
        p, outward, u, v, mat_id, wrote = merge(
            _FAM_VOL, rec, p, outward, u, v, mat_id, wrote, repl_mine)

    if geom_axis is not None:
        # Broadcast the owner's record to every geometry shard: exactly one
        # shard wrote each claimed lane, so a masked psum reconstructs the
        # record everywhere.
        p = jax.lax.psum(jnp.where(wrote[:, None], p, 0.0), geom_axis)
        outward = jax.lax.psum(jnp.where(wrote[:, None], outward, 0.0),
                               geom_axis)
        u = jax.lax.psum(jnp.where(wrote, u, 0.0), geom_axis)
        v = jax.lax.psum(jnp.where(wrote, v, 0.0), geom_axis)
        mat_id = jax.lax.psum(jnp.where(wrote, mat_id, 0), geom_axis)

    # Front-face normal flip (hittable/mod.rs:40-45). Volumes fix
    # front_face=True with an arbitrary normal (volumes.rs:66-68); their
    # isotropic phase function never reads either, so the generic flip is safe.
    front_face = dot(d, outward) < 0.0
    is_vol = fam == _FAM_VOL
    front_face = front_face | is_vol
    normal = jnp.where(front_face[:, None], outward, -outward)
    return p, normal, front_face, u, v, mat_id


def trace_rays(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
               o: Array, d: Array, time: Array, ray_id: Array, seed,
               geom_axis: str | None = None,
               return_stats: bool = False) -> Array:
    """Estimate radiance for a megabatch of rays -> (B,3).

    The wavefront analog of sample_ray (lib.rs:97-117): a lax.scan over
    bounce depth carrying {o, d, throughput, radiance, alive}. With
    `geom_axis` (inside shard_map) sphere/triangle tables are shard slices
    and each bounce does one all-gather min-combine + masked-psum record
    broadcast over the axis.
    """
    B = o.shape[0]
    background = scene.background

    init = (
        o, d,
        jnp.ones((B, 3)),            # throughput
        jnp.zeros((B, 3)),           # radiance
        jnp.ones((B,), dtype=bool),  # alive
        jnp.zeros((), jnp.int32),    # traced ray segments (perf counter)
    )

    def bounce(state, depth):
        o, d, throughput, radiance, alive, segments = state
        segments = segments + jnp.sum(alive.astype(jnp.int32))

        t, fam, idx = _closest_hit(scene, static, o, d, time, seed, ray_id,
                                   depth, cfg, geom_axis)
        hit_mask = jnp.isfinite(t)

        # Miss -> background, terminate (lib.rs:102-105).
        miss = alive & ~hit_mask
        radiance = radiance + jnp.where(miss[:, None],
                                        throughput * background, 0.0)

        alive = alive & hit_mask

        p, normal, front_face, u, v, mat_id = _hit_record(
            scene, static, o, d, time, t, fam, idx, geom_axis)

        sc = mat_mod.scatter(
            scene.materials, scene.textures, mat_id, d, p, normal, front_face,
            u, v, seed, ray_id, depth,
            has_noise=static.has_noise, has_image=static.has_image,
        )

        # radiance += throughput * emitted  (lib.rs:109-116)
        radiance = radiance + jnp.where(alive[:, None],
                                        throughput * sc.emitted, 0.0)
        throughput = jnp.where(alive[:, None],
                               throughput * sc.attenuation, throughput)
        alive = alive & sc.alive

        # Continue the path: scattered ray keeps the parent's time
        # (material.rs:50, :82, :136, :159 all pass r_in.time()).
        o = jnp.where(alive[:, None], p, o)
        d = jnp.where(alive[:, None], sc.direction, d)
        return (o, d, throughput, radiance, alive, segments), None

    (o, d, throughput, radiance, alive, segments), _ = jax.lax.scan(
        bounce, init, jnp.arange(cfg.max_depth, dtype=jnp.uint32))
    # Depth exhausted with alive rays -> contribute black (lib.rs:98-100).
    if return_stats:
        return radiance, segments
    return radiance


def _pixel_rays(cam: Camera, cfg: RenderConfig, pixel_ids: Array, seed):
    """Primary rays for (pixel, sample) lanes.

    pixel_ids enumerate pixel*spp + sample lanes. Film jitter matches
    sample_pixel (lib.rs:84-87): u=(col+U)/(w-1), v=(row+U)/(h-1) with row 0
    at the image bottom.
    """
    spp = cfg.samples_per_pixel
    pix = pixel_ids // spp
    col = (pix % cfg.width).astype(jnp.float32)
    row_top = pix // cfg.width
    row = (cfg.height - 1 - row_top).astype(jnp.float32)  # bottom-up rows

    ray_id = pixel_ids.astype(jnp.uint32)
    uj = rt_rng.rand4(seed, ray_id, 0, rt_rng.SALT_PIXEL_JITTER)
    u = (col + uj[..., 0]) / (cfg.width - 1)
    v = (row + uj[..., 1]) / (cfg.height - 1)

    o, d, time = get_rays(cam, u, v, seed, ray_id)
    return o, d, time, ray_id


@functools.partial(jax.jit, static_argnames=("static", "cfg"))
def render_chunk(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
                 cam: Camera, pixel_ids: Array, seed) -> Array:
    """Trace one megabatch of (pixel, sample) lanes -> per-lane radiance (B,3)."""
    o, d, time, ray_id = _pixel_rays(cam, cfg, pixel_ids, seed)
    return trace_rays(scene, static, cfg, o, d, time, ray_id, seed)


def render_image(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
                 cam: Camera, progress=None) -> jnp.ndarray:
    """Full-frame render -> (H, W, 3) accumulated color SUMS over spp.

    Matches the reference's Pixel.color, the un-normalized sum over samples
    (lib.rs:84-95); divide by spp + gamma in utils.image.tone_map.
    """
    n_lanes = cfg.n_rays
    batch = cfg.ray_batch or n_lanes
    seed = jnp.uint32(cfg.seed)

    chunks = []
    for start in range(0, n_lanes, batch):
        size = min(batch, n_lanes - start)
        ids = start + jnp.arange(size, dtype=jnp.int32)
        colors = render_chunk(scene, static, cfg, cam, ids, seed)
        chunks.append(colors)
        if progress is not None:
            progress(start + size, n_lanes)
    lanes = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks)
    # Lanes are ordered pixel*spp + sample: the spp sum is a plain reshape
    # reduction, not a scatter-add.
    acc = lanes.reshape(cfg.n_pixels, cfg.samples_per_pixel, 3).sum(axis=1)
    return acc.reshape(cfg.height, cfg.width, 3)
