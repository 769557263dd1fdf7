"""Benchmark: random-spheres forward and fwd+bwd render throughput on one GPU.

Workload = BASELINE.md config 1: the "One Weekend" final random-spheres
scene (jumpy_balls: ~488 spheres incl. moving + hollow glass), 400x225 film,
16 spp, max-depth 8. Prints ONE JSON line:

    {"metric": "rays_per_s_fwd", "value": N, "unit": "rays/s", ...}

`rays_per_s_fwd` counts traced ray SEGMENTS (primary + bounce, i.e. live
lanes summed over wavefront iterations) per second; `primary_rays_per_s`
(camera rays / s) is also reported. `rays_per_s_fwdbwd` is the same
segment count per second of `jax.grad` through 2^18-lane chunks. Every
result names the device it ran on. Without a GPU the script exits non-zero.

    python bench.py [--config random_spheres|book2_criterion]
"""

from __future__ import annotations

import json
import sys
import time


def main() -> int:
    import argparse

    import jax
    import jax.numpy as jnp

    from raytracer_weekend_tpu import integrator
    from raytracer_weekend_tpu.config import RenderConfig
    from raytracer_weekend_tpu.models.scenes import book2_final_scene, jumpy_balls
    from raytracer_weekend_tpu.scene import builder as B
    from raytracer_weekend_tpu.utils.platform import (
        enable_compile_cache, nvidia_smi_name_power, require_gpu)

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", choices=["random_spheres", "book2_criterion"],
                    default="random_spheres",
                    help="random_spheres = BASELINE config 1 (headline); "
                         "book2_criterion = the reference's criterion "
                         "workload, 40x22 x 100 spp "
                         "(basic_benchmark.rs:161-175)")
    args = ap.parse_args()

    enable_compile_cache()
    dev = require_gpu()
    card = nvidia_smi_name_power()
    print(f"# device: {dev.platform} {dev.device_kind} x{len(jax.devices())}"
          f" ({card})", file=sys.stderr)

    if args.config == "random_spheres":
        cfg = RenderConfig(width=400, height=225, samples_per_pixel=16,
                           max_depth=8, seed=0, ray_batch=1 << 20)
        objs, cams, background = jumpy_balls(cfg.aspect_ratio, seed=0)
        cfg_name = "jumpy_balls 400x225x16spp depth8"
    else:
        cfg = RenderConfig(width=40, height=22, samples_per_pixel=100,
                           max_depth=50, seed=1337, ray_batch=1 << 17)
        objs, cams, background = book2_final_scene(cfg.aspect_ratio, seed=1337)
        cfg_name = "book2_final 40x22x100spp depth50 (criterion parity)"
    scene, static = B.build_scene(objs, background=background, seed=cfg.seed)
    cam = cams[0]

    n_lanes = cfg.n_rays
    batch = min(cfg.ray_batch, n_lanes)

    # Segment-counting render chunk (jitted once per shape).
    @jax.jit
    def chunk_with_stats(scene, cam, ids, seed):
        o, d, t, ray_id = integrator._pixel_rays(cam, cfg, ids, seed)
        colors, segments = integrator.trace_rays(
            scene, static, cfg, o, d, t, ray_id, seed, return_stats=True)
        return colors.sum(), segments

    seed = jnp.uint32(cfg.seed)
    starts = list(range(0, n_lanes, batch))
    all_ids = [jnp.arange(s, min(s + batch, n_lanes), dtype=jnp.int32)
               for s in starts]

    def frame_outs():
        return [chunk_with_stats(scene, cam, ids, seed) for ids in all_ids]

    t0 = time.perf_counter()
    jax.block_until_ready(frame_outs())
    print(f"# compile+first frame: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    reps = 10
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = frame_outs()
        jax.block_until_ready(outs)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[reps // 2]
    total_segments = sum(int(segs) for _, segs in outs)

    # Forward+backward: grad of a scalar loss through the staged scan.
    dbatch = min(1 << 18, n_lanes)
    dstarts = list(range(0, n_lanes - dbatch + 1, dbatch))

    @jax.jit
    def diff_chunk(scene, cam, start, seed):
        def loss(scene):
            ids = start + jnp.arange(dbatch, dtype=jnp.int32)
            o, d, t, ray_id = integrator._pixel_rays(cam, cfg, ids, seed)
            return integrator.trace_rays(scene, static, cfg, o, d, t,
                                         ray_id, seed).sum()
        return jax.grad(loss, allow_int=True)(scene)

    jax.block_until_ready(diff_chunk(scene, cam, jnp.int32(0), seed))
    reps_d = 3
    t0 = time.perf_counter()
    for _ in range(reps_d):
        jax.block_until_ready([diff_chunk(scene, cam, jnp.int32(s), seed)
                               for s in dstarts])
    dt_d = (time.perf_counter() - t0) / reps_d
    # Same frame, same seed => same paths; scale segments to covered lanes.
    seg_d = total_segments * (len(dstarts) * dbatch) / n_lanes

    result = {
        "metric": "rays_per_s_fwd",
        "value": total_segments / dt,
        "unit": "rays/s",
        "primary_rays_per_s": n_lanes / dt,
        "segments_per_frame": total_segments,
        "frame_s": dt,
        "rays_per_s_fwdbwd": seg_d / dt_d,
        "config": cfg_name,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
