"""Render metrics and profiling hooks.

The reference's observability is indicatif progress bars (SURVEY.md §5.1,
§5.5: rate = pixels/s). This rebuild exposes structured counters —
rays/s, ray-segment throughput, wavefront occupancy per bounce — plus a thin
jax.profiler wrapper for Perfetto traces of the actual device timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class RenderStats:
    wall_s: float
    primary_rays: int
    ray_segments: int
    max_depth: int

    @property
    def primary_rays_per_s(self) -> float:
        return self.primary_rays / self.wall_s

    @property
    def segments_per_s(self) -> float:
        return self.ray_segments / self.wall_s

    @property
    def mean_path_length(self) -> float:
        return self.ray_segments / max(self.primary_rays, 1)

    def json_line(self, **extra) -> str:
        d = dict(
            wall_s=round(self.wall_s, 4),
            primary_rays=self.primary_rays,
            ray_segments=self.ray_segments,
            primary_rays_per_s=round(self.primary_rays_per_s, 1),
            segments_per_s=round(self.segments_per_s, 1),
            mean_path_length=round(self.mean_path_length, 3),
            **extra,
        )
        return json.dumps(d)


def measured_render(scene, static, cfg, cam, repeats: int = 1) -> RenderStats:
    """Render with the segment counter on; returns throughput stats."""
    from raytracer_weekend_tpu import integrator

    import functools

    @functools.partial(jax.jit, static_argnames=())
    def chunk(scene, cam, ids, seed):
        o, d, t, ray_id = integrator._pixel_rays(cam, cfg, ids, seed)
        colors, segs = integrator.trace_rays(
            scene, static, cfg, o, d, t, ray_id, seed, return_stats=True)
        return colors, segs

    seed = jnp.uint32(cfg.seed)
    n = cfg.n_rays
    batch = cfg.ray_batch or n
    id_chunks = [jnp.arange(s, min(s + batch, n), dtype=jnp.int32)
                 for s in range(0, n, batch)]

    # Warmup (compile).
    for ids in id_chunks:
        out = chunk(scene, cam, ids, seed)
    jax.block_until_ready(out)

    t0 = time.time()
    total_segments = 0
    for _ in range(repeats):
        total_segments = 0
        for ids in id_chunks:
            _, segs = chunk(scene, cam, ids, seed)
            total_segments += int(segs)
    wall = (time.time() - t0) / repeats
    return RenderStats(wall_s=wall, primary_rays=n,
                       ray_segments=total_segments, max_depth=cfg.max_depth)


def wavefront_occupancy(scene, static, cfg, cam, n_lanes: int = 65536):
    """Hit-recording lane fraction per bounce — the compaction-planning
    metric (SURVEY.md §5.5: 'wavefront occupancy (live rays per pass)').

    Re-runs the staged trace at increasing depth and differences the
    segment counts."""
    from raytracer_weekend_tpu import integrator

    seed = jnp.uint32(cfg.seed)
    n = min(n_lanes, cfg.n_rays)
    ids = jnp.arange(n, dtype=jnp.int32)
    o, d, t, ray_id = integrator._pixel_rays(cam, cfg, ids, seed)
    counts = []
    B = o.shape[0]
    for depth in range(1, cfg.max_depth + 1):
        sub = dataclasses.replace(cfg, max_depth=depth)
        _, segs = integrator.trace_rays(scene, static, sub, o, d, t, ray_id,
                                        seed, return_stats=True)
        counts.append(int(segs))
    per_bounce = np.diff([0] + counts)
    return per_bounce / B


@contextlib.contextmanager
def profiler_trace(log_dir: str = "profile"):
    """Perfetto/TensorBoard device trace around a render
    (ref analog: criterion harness, SURVEY.md §5.1)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
