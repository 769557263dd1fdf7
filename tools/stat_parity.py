"""Renderer-vs-oracle parity over the FULL 13-scene catalog.

The closest available stand-in for parity against the reference's seeded
serial renders (no Rust toolchain here — tests/oracle.py): the
scalar f64 oracle consumes the same counter-based RNG streams, so paths
are lane-exact except at knife-edge decisions, which the oracle flags
(Oracle.render(return_fragile=True)). For every catalog scene this runs a
small deterministic config through both and reports the robust-channel
match fraction + mean-image agreement; paste the table into PARITY.md.

Run on CPU:  python tools/stat_parity.py
"""

from __future__ import annotations

import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from oracle import Oracle
from raytracer_weekend_tpu import integrator
from raytracer_weekend_tpu.config import RenderConfig
from raytracer_weekend_tpu.models.scenes import SCENES
from raytracer_weekend_tpu.scene import builder as B

# Scenes with thousands of primitives get a tinier config: the oracle is a
# deliberate scalar Python loop over every primitive per bounce.
_BIG = {"book2_final_scene", "animated_book2_final_scene",
        "wavefront_cow_obj", "wavefront_suspension_obj",
        "textured_monument"}


def main() -> int:
    print(f"| scene | config | robust px | match | mean|Δ| | time |")
    print(f"|---|---|---|---|---|---|")
    worst = 1.0
    for name in sorted(SCENES):
        t0 = time.time()
        if name in _BIG:
            cfg = RenderConfig(width=10, height=6, samples_per_pixel=2,
                               max_depth=4, seed=13)
        else:
            cfg = RenderConfig(width=16, height=9, samples_per_pixel=4,
                               max_depth=5, seed=13)
        objs, cams, bg = SCENES[name](cfg.aspect_ratio)
        scene, static = B.build_scene(objs, background=bg, seed=13)
        got = np.asarray(integrator.render_image(scene, static, cfg,
                                                 cams[0]))
        expect, fragile = Oracle(scene, static, cfg).render(
            cams[0], cfg, return_fragile=True)
        robust = ~fragile
        close = np.isclose(got[robust], expect[robust], rtol=1e-3, atol=1e-3)
        match = close.mean() if robust.any() else float("nan")
        meand = float(np.abs(got / cfg.samples_per_pixel
                             - expect / cfg.samples_per_pixel).mean())
        cfgs = (f"{cfg.width}x{cfg.height}x{cfg.samples_per_pixel}"
                f"d{cfg.max_depth}")
        print(f"| {name} | {cfgs} | {int(robust.sum())}/{robust.size} "
              f"| {match:.4f} | {meand:.2e} | {time.time()-t0:.0f}s |",
              flush=True)
        worst = min(worst, match)
    print(f"\nworst robust-channel match: {worst:.4f}")
    return 0 if worst >= 0.995 else 1


if __name__ == "__main__":
    sys.exit(main())
