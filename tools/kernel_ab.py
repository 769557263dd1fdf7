"""Closest-hit kernels against the plain ops, end to end, on one GPU.

For each scene, in one process on one card: the forward render of the full
frame (400x225x16 spp, depth 8, the CLI's ray_batch) and jax.grad through
one 2^18-lane chunk, once with the integrator's GPU path choice ("kernel":
the Triton kernels of ops.pallas) and once with the plain ops ("plain": the
path the integrator picks on the CPU, run here on the GPU). A scene with a
sphere BVH also runs the forward as "bvh": the GPU path with the spheres
on the BVH instead of the sphere kernel. fwd+bwd drops the trees (the BVH
traversal's while_loop has no reverse-mode rule). Timed in turns (kernel,
plain, bvh, bvh, plain, kernel); per variant the median and quartiles of
all timed runs after a warm-up. A variant that runs out of device memory
is reported as "OOM".

    python tools/kernel_ab.py [--scenes jumpy_balls,book2_final_scene,...]

Prints one JSON line per scene.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes",
                    default="jumpy_balls,book2_final_scene,cornell_box")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed runs per turn (4 turns per scene)")
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--spp", type=int, default=16)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from raytracer_weekend_tpu import integrator
    from raytracer_weekend_tpu.config import RenderConfig
    from raytracer_weekend_tpu.models.scenes import generate_scene
    from raytracer_weekend_tpu.utils.platform import (
        enable_compile_cache, nvidia_smi_name_power, require_gpu)

    enable_compile_cache()
    dev = require_gpu()
    card = nvidia_smi_name_power()
    print(f"# {dev.platform} {dev.device_kind}; {card}", flush=True)

    cfg = RenderConfig.from_aspect(width=args.width,
                                   samples_per_pixel=args.spp, max_depth=8,
                                   seed=0, ray_batch=1 << 20)
    dbatch = min(1 << 18, cfg.n_rays)
    seed = jnp.uint32(cfg.seed)

    def build(platform, static, sphere_kernel_max=None):
        """Jitted forward-frame and fwd+bwd-chunk functions, traced with the
        path choice of `platform` (and, if given, that sphere-kernel
        limit)."""
        limit = (integrator.GPU_SPHERE_KERNEL_MAX if sphere_kernel_max is None
                 else sphere_kernel_max)

        @jax.jit
        def fwd_chunk(scene, cam, ids):
            o, d, t, rid = integrator._pixel_rays(cam, cfg, ids, seed)
            colors, segs = integrator.trace_rays(
                scene, static, cfg, o, d, t, rid, seed, return_stats=True)
            return colors.sum(), segs

        @jax.jit
        def grad_chunk(scene, cam, start):
            def loss(scene):
                ids = start + jnp.arange(dbatch, dtype=jnp.int32)
                o, d, t, rid = integrator._pixel_rays(cam, cfg, ids, seed)
                return jnp.mean(integrator.trace_rays(
                    scene, static, cfg, o, d, t, rid, seed) ** 2)
            return jax.grad(loss, allow_int=True)(scene)

        def frame(scene, cam):
            return [fwd_chunk(scene, cam, jnp.arange(
                s, min(s + cfg.ray_batch, cfg.n_rays), dtype=jnp.int32))
                for s in range(0, cfg.n_rays, cfg.ray_batch)]

        def traced(fn):
            def run(*a):
                with mock.patch.object(integrator, "target_platform",
                                       lambda: platform), \
                        mock.patch.object(integrator,
                                          "GPU_SPHERE_KERNEL_MAX", limit):
                    return fn(*a)
            return run

        return traced(frame), traced(grad_chunk)

    for name in args.scenes.split(","):
        scene, static, cams = generate_scene(name, cfg.aspect_ratio,
                                             seed=cfg.seed)
        cam = cams[0]
        no_bvh = scene._replace(sphere_bvh=None, triangle_bvh=None)
        variants = {"kernel": (build("gpu", static), scene),
                    "plain": (build("cpu", static), scene)}
        if scene.sphere_bvh is not None:
            variants["bvh"] = (build("gpu", static, 0), scene)
        row = {"scene": name, "device_kind": dev.device_kind, "card": card,
               "config": f"{cfg.width}x{cfg.height}x{cfg.samples_per_pixel}"
                         f"spp depth 8 ray_batch 2^20; fwd+bwd on {dbatch} "
                         "lanes, BVH dropped"}
        work = {}
        for v, ((frame, grad), sc) in variants.items():
            calls = [("fwd", lambda f=frame, sc=sc: f(sc, cam))]
            if v != "bvh":
                calls.append(("fwdbwd", lambda g=grad: g(no_bvh, cam,
                              jnp.int32(min(1 << 19, cfg.n_rays - dbatch)))))
            for what, call in calls:
                out = None
                try:
                    t0 = time.perf_counter()
                    out = jax.block_until_ready(call())
                    row[f"{what}_{v}_compile_s"] = time.perf_counter() - t0
                    work[(v, what)] = call
                    if what == "fwd":
                        row[f"segments_{v}"] = sum(int(s) for _, s in out)
                except Exception as e:  # noqa: BLE001  (OOM is a result)
                    if "RESOURCE_EXHAUSTED" not in str(e):
                        raise
                    row[f"{what}_{v}_ms"] = "OOM"
                del out
        times = {k: [] for k in work}
        for v in ("kernel", "plain", "bvh", "bvh", "plain", "kernel"):
            for (wv, what), call in work.items():
                if wv != v:
                    continue
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    jax.block_until_ready(call())
                    times[(wv, what)].append(time.perf_counter() - t0)
        for (v, what), ts in times.items():
            q1, med, q3 = np.percentile(ts, [25, 50, 75]) * 1e3
            row[f"{what}_{v}_ms"] = float(med)
            row[f"{what}_{v}_iqr_ms"] = [float(q1), float(q3)]
            row[f"{what}_{v}_runs"] = len(ts)
        row["peak_bytes_in_use"] = int(dev.memory_stats()["peak_bytes_in_use"])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
