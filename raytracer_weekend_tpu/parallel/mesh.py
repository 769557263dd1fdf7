"""Device mesh construction for sharded rendering.

The reference's only parallel axis is a rayon thread pool over pixels
(lib.rs:58-67). Here a mesh has three named axes, the renderer's
counterparts of data/sequence/tensor parallelism:

  rays — pixel tiles: each shard owns a slice of the film; no
         communication until the final gather
  spp  — shards of the per-pixel sample set, reduced with one psum
  geom — primitive tables sharded over devices: each shard intersects the
         full local ray batch against its slice, and a per-bounce
         all-gather + min picks the winner

The cards of one host are joined all to all, so the mesh shape follows the
algorithm only. Multi-host: `jax.distributed.initialize()`, then build the
mesh over all processes' devices with the host dimension leading.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    mesh: Mesh
    ray_axis: str = "rays"
    spp_axis: str = "spp"
    geom_axis: str = "geom"

    @property
    def n_rays(self) -> int:
        return self.mesh.shape[self.ray_axis]

    @property
    def n_spp(self) -> int:
        return self.mesh.shape[self.spp_axis]

    @property
    def n_geom(self) -> int:
        return self.mesh.shape[self.geom_axis]


def make_render_mesh(shape: tuple[int, int, int] | None = None,
                     devices=None) -> RenderMesh:
    """Build a (rays, spp, geom) mesh.

    Default: all devices on the rays axis — the right layout for small
    scenes where the whole scene replicates per device. Pass an explicit
    shape to trade axes (e.g. (1, 2, 2) on 4 devices, or geometry-heavy
    (1, 1, 4) for large meshes).
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if shape is None:
        shape = (n, 1, 1)
    need = int(np.prod(shape))
    if need > n:
        raise ValueError(f"mesh shape {shape} needs {need} devices, "
                         f"have {n}")
    mesh = Mesh(devices.flat[:need].reshape(shape), ("rays", "spp", "geom"))
    return RenderMesh(mesh=mesh)


def distributed_init(**kwargs) -> None:
    """Multi-host bring-up: jax.distributed.initialize passthrough."""
    jax.distributed.initialize(**kwargs)
