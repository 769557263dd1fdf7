"""Time the closest-hit kernels over launch shapes (ops.pallas.Tiling) on one
GPU, at the catalog's real sizes: jumpy_balls' sphere table and
book2_final_scene's rect table against the 1.44M primary rays of a
400x225x16 frame. Every shape must reproduce the default shape's output
exactly (the per-pair arithmetic and the first-minimum rule do not depend on
the shape).

    python tools/kernel_tune.py

Prints one JSON line per (family, tiling).
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CANDIDATES = [  # (block_b, chunk, num_warps, num_stages)
    (128, 8, 4, 1), (128, 4, 4, 1), (128, 2, 4, 1), (128, 1, 4, 1),
    (64, 4, 2, 1), (64, 1, 2, 1), (256, 4, 8, 1), (256, 1, 8, 1),
    (256, 4, 4, 1), (256, 1, 4, 1), (128, 4, 4, 2), (128, 1, 4, 2),
    (128, 16, 4, 1), (512, 4, 8, 1),
]


def main() -> int:
    import jax
    import jax.numpy as jnp

    from raytracer_weekend_tpu import integrator
    from raytracer_weekend_tpu.config import RenderConfig
    from raytracer_weekend_tpu.models.scenes import generate_scene
    from raytracer_weekend_tpu.ops.pallas import (
        RECT_TILING, SPHERE_TILING, Tiling, hit_rects_pallas,
        hit_spheres_pallas)
    from raytracer_weekend_tpu.utils.platform import (
        enable_compile_cache, nvidia_smi_name_power, require_gpu)

    enable_compile_cache()
    dev = require_gpu()
    card = nvidia_smi_name_power()
    cfg = RenderConfig(width=400, height=225, samples_per_pixel=16,
                       max_depth=8, seed=0)
    rows = []
    for family, name in (("sphere", "jumpy_balls"),
                         ("rect", "book2_final_scene")):
        scene, _, cams = generate_scene(name, cfg.aspect_ratio, seed=0)
        ids = jnp.arange(cfg.n_rays, dtype=jnp.int32)
        o, d, tm, _ = jax.jit(lambda c, i: integrator._pixel_rays(
            c, cfg, i, jnp.uint32(0)))(cams[0], ids)

        def run(scene, o, d, tm, tiling):
            if family == "sphere":
                return hit_spheres_pallas(scene.spheres, o, d, tm,
                                          cfg.t_min, False, tiling)
            return hit_rects_pallas(scene.rects, o, d, cfg.t_min, False,
                                    tiling)

        ref = None
        default = SPHERE_TILING if family == "sphere" else RECT_TILING
        for cand in [tuple(default)] + CANDIDATES:
            tiling = Tiling(*cand)
            fn = functools.partial(jax.jit(run, static_argnums=4), scene,
                                   o, d, tm, tiling)
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            compile_s = time.perf_counter() - t0
            ts = []
            for _ in range(7):
                t0 = time.perf_counter()
                jax.block_until_ready(fn())
                ts.append(time.perf_counter() - t0)
            t_, i_ = map(np.asarray, out)
            if ref is None:
                ref = (t_, i_)
            same = bool(np.array_equal(i_, ref[1])
                        and np.array_equal(t_, ref[0]))
            row = dict(family=family, scene=name, rays=int(cfg.n_rays),
                       tiling=list(cand), median_ms=float(np.median(ts)) * 1e3,
                       compile_s=compile_s, same_as_default=same,
                       device_kind=dev.device_kind, card=card)
            print(json.dumps(row), flush=True)
            rows.append(row)
    assert all(r["same_as_default"] for r in rows), "tilings disagree"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
