"""Multi-host rendering over jax.distributed.

Single-process renders use parallel.shard directly; across hosts the same
shard_map runs over a global mesh, with each process contributing its
addressable slice of the film and the scene replicated everywhere. The
BASELINE.md scaling config (1 host -> >=2 hosts at >=90% efficiency) runs
through exactly this path; tests simulate it with two CPU processes and TCP
collectives (tests/test_multihost.py).

Usage (per host):
    init_multihost(coordinator_address="host0:1234",
                   num_processes=N, process_id=i)
    img = render_multihost(scene, static, cfg, cam)   # full image, all hosts
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from raytracer_weekend_tpu.parallel.mesh import RenderMesh
from raytracer_weekend_tpu.parallel.shard import render_sharded


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, **kw) -> None:
    """Cluster bring-up (SURVEY.md §2.6: absent in the reference — the
    embedded analog is heap/clock/USART init, bin/raytracer.rs:45-51)."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id, **kw)


def global_render_mesh(shape: Optional[tuple[int, int, int]] = None
                       ) -> RenderMesh:
    """A (rays, spp, geom) mesh over every device of every process, rays
    leading so film shards ride hosts (gradients/results cross hosts once)."""
    devices = np.asarray(jax.devices())
    n = devices.size
    if shape is None:
        shape = (n, 1, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} global devices")
    return RenderMesh(mesh=Mesh(devices.reshape(shape),
                                ("rays", "spp", "geom")))


def _replicate(tree, mesh: Mesh):
    """Device-put every leaf as a fully-replicated global array."""
    sharding = NamedSharding(mesh, P())

    def put(x):
        if x is None:
            return None
        x = np.asarray(x)
        return jax.make_array_from_callback(x.shape, sharding, lambda i: x[i])

    return jax.tree_util.tree_map(put, tree)


def render_multihost(scene, static, cfg, cam,
                     rmesh: Optional[RenderMesh] = None,
                     seed: Optional[int] = None) -> np.ndarray:
    """Full-frame render across all processes -> (H, W, 3) color sums,
    identical on every host (and to the single-device render)."""
    from jax.experimental import multihost_utils

    from raytracer_weekend_tpu.parallel import shard as shard_mod

    rmesh = rmesh or global_render_mesh()
    mesh = rmesh.mesh

    scene_padded = shard_mod.pad_scene_for_geom(scene, rmesh.n_geom)
    scene_g = _replicate(scene_padded, mesh)
    cam_g = _replicate(cam, mesh)

    # Global pixel/sample index arrays, sharded like the shard body expects.
    n_pix = cfg.n_pixels
    spp = cfg.samples_per_pixel
    pix_pad = -(-n_pix // rmesh.n_rays) * rmesh.n_rays
    spp_pad = -(-spp // rmesh.n_spp) * rmesh.n_spp

    pix_ids = np.arange(pix_pad, dtype=np.int32)
    sample_ids = np.arange(spp_pad, dtype=np.int32)
    pix_g = jax.make_array_from_callback(
        (pix_pad,), NamedSharding(mesh, P("rays")),
        lambda idx: pix_ids[idx])
    smp_g = jax.make_array_from_callback(
        (spp_pad,), NamedSharding(mesh, P("spp")),
        lambda idx: sample_ids[idx])

    # The SAME shard body as single-process render_sharded, jitted over the
    # global mesh (shard_map partitions across hosts).
    scene_spec = shard_mod._scene_specs(rmesh, scene_g)
    cam_spec = type(cam)(*[P() for _ in cam._fields])
    body = shard_mod.make_shard_body(
        static, cfg, rmesh, scene_spec, cam_spec,
        jnp.uint32(cfg.seed if seed is None else seed))
    sums = jax.jit(body)(scene_g, cam_g, pix_g, smp_g)

    # Bring the film shards to every host.
    local = multihost_utils.process_allgather(sums, tiled=True)
    return np.asarray(local)[:n_pix].reshape(cfg.height, cfg.width, 3)
