"""Sharded rendering + inverse-rendering train step.

The device-parallel replacement for the reference's rayon pixel pool
(lib.rs:58-67), expressed as one `shard_map` over a (rays, spp, geom) mesh:

  * film pixels shard over `rays` (pure data parallelism; no comms)
  * per-pixel samples shard over `spp` and reduce with one psum at the end
  * sphere/triangle tables shard over `geom`; every bounce does one small
    all-gather min-combine + masked-psum record broadcast (see integrator)

Determinism: RNG is counter-based per (pixel, sample) lane, so the image is
bit-stable under every mesh shape — the property the reference only gets
from its seeded serial path (lib.rs:69-75).

Gradients: `train_step` differentiates straight through the shard_map; the
psum transposes ARE the cross-device gradient all-reduce, overlapped with
the backward sweep by XLA's scheduler.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.sharding import PartitionSpec as P

from raytracer_weekend_tpu import rng as rt_rng
from raytracer_weekend_tpu.camera import Camera, get_rays
from raytracer_weekend_tpu.config import RenderConfig
from raytracer_weekend_tpu.integrator import trace_rays
from raytracer_weekend_tpu.parallel.mesh import RenderMesh
from raytracer_weekend_tpu.scene.data import SceneData, SceneStatic


def _pad_to(x: np.ndarray | Array, n: int, axis: int = 0, fill=0):
    size = x.shape[axis]
    if size % n == 0:
        return x
    pad = n - size % n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=fill)


def pad_scene_for_geom(scene: SceneData, n_geom: int) -> SceneData:
    """Pad sphere/triangle tables to a multiple of the geom axis size.

    Padding rows have valid=False so the kernels reject them; every other
    table stays replicated.
    """
    if n_geom == 1:
        return scene
    sp = scene.spheres
    sp = type(sp)(*[
        _pad_to(getattr(sp, f), n_geom,
                fill=(False if f == "valid" else (1 if f in ("radius", "t1") else 0)))
        for f in sp._fields
    ])
    tr = scene.triangles
    tr = type(tr)(*[
        _pad_to(getattr(tr, f), n_geom, fill=(False if f == "valid" else 0))
        for f in tr._fields
    ])
    # Padded degenerate triangles (all-zero vertices) have zero-normal; the
    # hit kernel's det==0 guard plus valid=False rejects them.
    scene = scene._replace(spheres=sp, triangles=tr)

    # Per-shard BVHs: a global tree indexes global rows, but each geometry
    # shard traverses against its LOCAL table slice — so rebuild one tree
    # per shard (local prim indices; `consider(sharded=True)` globalizes
    # the winner), pad every tree to a common node count with never-hit
    # nodes, and stack along axis 0 so the geom PartitionSpec slices out
    # exactly one tree per device. Replaces the round-1 behavior of falling
    # back to brute force under geometry sharding (bvh.rs:101-120 parity
    # now holds on every path).
    if scene.sphere_bvh is not None or scene.triangle_bvh is not None:
        if any(isinstance(leaf, jax.core.Tracer)
               for t in (sp, tr) for leaf in t):
            # Under tracing (train_step differentiates render_sharded, so
            # the tables are JVP/vmap tracers) the host-side BVH build can't
            # run — drop the trees and take the brute-force traversal,
            # which renders the identical image (the with/without-BVH gate
            # in tests/test_bvh.py).
            return scene._replace(sphere_bvh=None, triangle_bvh=None)
        from raytracer_weekend_tpu.scene.builder import _Compiler
        if scene.sphere_bvh is not None:
            scene = scene._replace(sphere_bvh=_stacked_shard_bvhs(
                _Compiler._build_sphere_bvh, sp, n_geom))
        if scene.triangle_bvh is not None:
            scene = scene._replace(triangle_bvh=_stacked_shard_bvhs(
                _Compiler._build_triangle_bvh, tr, n_geom))
    return scene


# (field ids..., n_geom) -> stacked Bvh. Entries hold strong references to
# the key arrays (see below), so an id can't be reused while its entry
# lives; bounded FIFO since render loops (animation frames / SGD steps on a
# fixed scene) otherwise rebuild identical host-side trees every call.
_BVH_CACHE: dict = {}
_BVH_CACHE_MAX = 16


def _stacked_shard_bvhs(build_fn, table, n_geom: int):
    """Build one BVH per geom shard of `table`, pad to a common node count,
    and concatenate -> Bvh arrays of leading dim n_geom * M_max."""
    from raytracer_weekend_tpu.ops.bvh import Bvh

    key = (build_fn.__name__, n_geom, *(id(f) for f in table))
    hit = _BVH_CACHE.get(key)
    if hit is not None:
        return hit[0]

    rows = np.asarray(table[0]).shape[0] // n_geom
    parts = []
    for g in range(n_geom):
        sl = type(table)(*[np.asarray(f)[g * rows:(g + 1) * rows]
                           for f in table])
        parts.append(build_fn(sl))
    m_max = max(int(p.prim.shape[0]) for p in parts)

    def pad(b: "Bvh") -> "Bvh":
        m = int(b.prim.shape[0])
        if m == m_max:
            return b
        # Padding nodes: empty box (min > max) never passes the slab test,
        # so the cursor falls through skip straight to the end.
        extra = m_max - m
        return Bvh(
            jnp.concatenate([b.bmin, jnp.full((extra, 3), jnp.inf)], 0),
            jnp.concatenate([b.bmax, jnp.full((extra, 3), -jnp.inf)], 0),
            jnp.concatenate([b.prim, jnp.full((extra,), -1, jnp.int32)], 0),
            jnp.concatenate([b.skip, jnp.full((extra,), m_max, jnp.int32)],
                            0),
        )

    parts = [pad(p) for p in parts]
    out = Bvh(*[jnp.concatenate([getattr(p, f) for p in parts], axis=0)
                for f in Bvh._fields])
    if len(_BVH_CACHE) >= _BVH_CACHE_MAX:
        _BVH_CACHE.pop(next(iter(_BVH_CACHE)))
    _BVH_CACHE[key] = (out, table)  # keep `table` alive -> ids stay valid
    return out


def _scene_specs(rmesh: RenderMesh, scene: SceneData):
    """PartitionSpec pytree for SceneData: sphere/triangle tables shard over
    the geom axis (leading dim), everything else replicates. BVH fields
    (if built) are per-shard stacked trees (pad_scene_for_geom) and shard
    over geom too."""
    import raytracer_weekend_tpu.scene.data as D
    from raytracer_weekend_tpu.materials import MaterialTable
    from raytracer_weekend_tpu.textures import TextureTable
    from raytracer_weekend_tpu.ops.bvh import Bvh

    geom = rmesh.geom_axis if rmesh.n_geom > 1 else None

    def table_spec(cls, sharded):
        spec = P(geom) if (sharded and geom) else P()
        return cls(*[spec for _ in cls._fields])

    def bvh_spec(b):
        spec = P(geom) if geom else P()
        return None if b is None else Bvh(*[spec for _ in Bvh._fields])

    return SceneData(
        spheres=table_spec(D.Spheres, True),
        rects=table_spec(D.Rects, False),
        triangles=table_spec(D.Triangles, True),
        volumes=table_spec(D.Volumes, False),
        materials=table_spec(MaterialTable, False),
        textures=table_spec(TextureTable, False),
        background=P(),
        sphere_bvh=bvh_spec(scene.sphere_bvh),
        triangle_bvh=bvh_spec(scene.triangle_bvh),
    )


def make_shard_body(static: SceneStatic, cfg: RenderConfig,
                    rmesh: RenderMesh, scene_spec, cam_spec, seed_v):
    """The ONE shard_map render body, shared by render_sharded (single
    process) and multihost.render_multihost (global arrays across hosts).

    Returns a shard_map-wrapped fn (scene, cam, pix_ids, sample_ids) ->
    per-pixel color sums (pix, 3), psum-reduced over the spp axis. Each
    shard runs the staged integrator over its (pixel, sample) lanes.
    """
    n_pix = cfg.n_pixels
    spp = cfg.samples_per_pixel
    geom = rmesh.geom_axis if rmesh.n_geom > 1 else None

    @functools.partial(
        jax.shard_map, mesh=rmesh.mesh,
        in_specs=(scene_spec, cam_spec, P(rmesh.ray_axis), P(rmesh.spp_axis)),
        out_specs=P(rmesh.ray_axis, None),
        check_vma=False,
    )
    def shard_body(scene, cam, pix_local, sample_local):
        Pl = pix_local.shape[0]
        Sl = sample_local.shape[0]
        pix = jnp.repeat(pix_local, Sl)
        smp = jnp.tile(sample_local, Pl)
        lane_valid = (pix < n_pix) & (smp < spp)

        ray_id = (pix * spp + jnp.minimum(smp, spp - 1)).astype(jnp.uint32)
        col = (pix % cfg.width).astype(jnp.float32)
        row = (cfg.height - 1 - pix // cfg.width).astype(jnp.float32)
        uj = rt_rng.rand4(seed_v, ray_id, 0, rt_rng.SALT_PIXEL_JITTER)
        u = (col + uj[..., 0]) / (cfg.width - 1)
        v = (row + uj[..., 1]) / (cfg.height - 1)
        o, d, time = get_rays(cam, u, v, seed_v, ray_id)
        colors = trace_rays(scene, static, cfg, o, d, time, ray_id,
                            seed_v, geom_axis=geom)

        colors = jnp.where(lane_valid[:, None], colors, 0.0)
        sums = colors.reshape(Pl, Sl, 3).sum(axis=1)
        # Reduce the sample shards; geom shards hold identical sums (records
        # are psum-broadcast every bounce), so no geom reduction is needed.
        return jax.lax.psum(sums, rmesh.spp_axis)

    return shard_body


def render_sharded(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
                   cam: Camera, rmesh: RenderMesh,
                   seed: Optional[int] = None) -> Array:
    """Full-frame sharded render -> (H, W, 3) color sums over spp.

    Matches integrator.render_image for any mesh shape: the lanes and their
    RNG streams are the same, only the spp psum reorders the sum.
    """
    seed_v = jnp.uint32(cfg.seed if seed is None else seed)

    scene_padded = pad_scene_for_geom(scene, rmesh.n_geom)
    return _render_sharded_jit(scene_padded, cam, seed_v, static=static,
                               cfg=cfg, rmesh=rmesh)


@functools.partial(jax.jit, static_argnames=("static", "cfg", "rmesh"))
def _render_sharded_jit(scene_padded: SceneData, cam: Camera, seed_v,
                        static: SceneStatic, cfg: RenderConfig,
                        rmesh: RenderMesh) -> Array:
    n_pix = cfg.n_pixels
    spp = cfg.samples_per_pixel
    pix_pad = -(-n_pix // rmesh.n_rays) * rmesh.n_rays
    spp_pad = -(-spp // rmesh.n_spp) * rmesh.n_spp

    pix_ids = jnp.arange(pix_pad, dtype=jnp.int32)
    sample_ids = jnp.arange(spp_pad, dtype=jnp.int32)

    scene_spec = _scene_specs(rmesh, scene_padded)
    cam_spec = type(cam)(*[P() for _ in cam._fields])

    shard_body = make_shard_body(static, cfg, rmesh, scene_spec, cam_spec,
                                 seed_v)
    sums = shard_body(scene_padded, cam, pix_ids, sample_ids)  # (pix_pad, 3)
    return sums[:n_pix].reshape(cfg.height, cfg.width, 3)


def render_image_sharded(scene, static, cfg, cam, rmesh, seed=None):
    """Alias mirroring integrator.render_image's name."""
    return render_sharded(scene, static, cfg, cam, rmesh, seed)


@functools.partial(jax.jit, static_argnames=("static", "cfg", "rmesh", "lr"))
def train_step(scene: SceneData, static: SceneStatic, cfg: RenderConfig,
               cam: Camera, target: Array, rmesh: RenderMesh,
               lr: float = 0.1):
    """One inverse-rendering SGD step: L2(render, target) over the mesh.

    Differentiates through the sharded render; shard_map's psum transposes
    perform the cross-device gradient all-reduce. Jitted as one program, so
    the scene reaches pad_scene_for_geom as tracers and any BVH is dropped
    for brute force (same image).

    Returns (updated_scene, loss).
    """

    def loss_fn(scene):
        sums = render_sharded(scene, static, cfg, cam, rmesh)
        mean_img = sums / cfg.samples_per_pixel
        return jnp.mean((mean_img - target) ** 2)

    # allow_int: type/index tables ride along with float0 cotangents.
    loss, grads = jax.value_and_grad(loss_fn, allow_int=True)(scene)

    # SGD on the continuous leaves (albedo/fuzz/ior/geometry/texels). Integer
    # tables get zero cotangents of float0 dtype — leave them untouched.
    def apply(p, g):
        if g is None or g.dtype == jax.dtypes.float0:
            return p
        return p - lr * g

    new_scene = jax.tree_util.tree_map(apply, scene, grads)
    return new_scene, loss
