"""Console front-end (rebuild of console_app/src/main.rs).

Same surface as the reference CLI: a scene name plus --width /
--aspect-ratio / --samples-per-pixel (defaults 400 / 16:9 / 100,
main.rs:20-25), rendering every camera of the scene to
render/image_NNNN.png with the reference's tone map. Extras the reference
lacks: --max-depth, --seed, --ray-batch, and --mesh to shard across
devices.

    python -m raytracer_weekend_tpu.utils.cli cornell_box -w 200 -s 50
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from raytracer_weekend_tpu.config import RenderConfig
from raytracer_weekend_tpu.models.scenes import SCENES, generate_scene
from raytracer_weekend_tpu.utils.image import save_png, tone_map


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer_weekend_tpu",
        description="Differentiable wavefront path tracer in JAX "
                    "(scene presets mirror scenes.rs:24-39)")
    p.add_argument("scene", choices=sorted(SCENES), help="scene preset")
    p.add_argument("-w", "--width", type=int, default=400)
    p.add_argument("-a", "--aspect-ratio", type=float, default=16.0 / 9.0)
    p.add_argument("-s", "--samples-per-pixel", type=int, default=100)
    p.add_argument("-d", "--max-depth", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ray-batch", type=int, default=1 << 20,
                   help="rays per wavefront megabatch (0 = all at once)")
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh shape rays,spp,geom e.g. 4,1,1 or 1,2,2")
    p.add_argument("-o", "--out-dir", default="render")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend (tests/debug)")
    p.add_argument("--stream", metavar="PATH", default=None,
                   help="also emit the COBS/postcard pixel stream (the "
                        "reference's UART wire format) to PATH")
    p.add_argument("--resume-dir", metavar="DIR", default=None,
                   help="tile checkpoint dir: resume a partial render")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from raytracer_weekend_tpu.utils.platform import (enable_compile_cache,
                                                      force_cpu)
    if args.cpu:
        force_cpu()
    enable_compile_cache()

    cfg = RenderConfig.from_aspect(
        width=args.width, aspect_ratio=args.aspect_ratio,
        samples_per_pixel=args.samples_per_pixel, max_depth=args.max_depth,
        seed=args.seed, ray_batch=args.ray_batch)

    print(f"building scene {args.scene!r} ...", flush=True)
    scene, static, cams = generate_scene(args.scene, cfg.aspect_ratio,
                                         seed=args.seed)
    print(f"  {static.n_spheres} spheres, {static.n_rects} rects, "
          f"{static.n_triangles} triangles, {static.n_volumes} volumes")

    os.makedirs(args.out_dir, exist_ok=True)

    rmesh = None
    if args.mesh:
        from raytracer_weekend_tpu.parallel import make_render_mesh
        shape = tuple(int(x) for x in args.mesh.split(","))
        rmesh = make_render_mesh(shape)

    # Per-frame render loop (main.rs:48-94); progress like indicatif's bars.
    for frame_no, cam in enumerate(cams):
        t0 = time.time()

        def progress(done, total):
            rate = done / max(time.time() - t0, 1e-9)
            sys.stderr.write(
                f"\rframe {frame_no + 1}/{len(cams)}: {done}/{total} rays "
                f"({rate / 1e6:.2f} Mrays/s)")
            sys.stderr.flush()

        if args.stream is not None:
            from raytracer_weekend_tpu.parallel.stream import stream_render
            with open(args.stream, "ab") as f:
                sums = np.asarray(stream_render(scene, static, cfg, cam,
                                                f.write))
        elif args.resume_dir is not None:
            from raytracer_weekend_tpu.utils.checkpoint import (
                TileStore, render_resumable)
            sums = render_resumable(scene, static, cfg, cam,
                                    TileStore(args.resume_dir),
                                    frame=frame_no)
        elif rmesh is not None:
            from raytracer_weekend_tpu.parallel import render_sharded
            sums = np.asarray(render_sharded(scene, static, cfg, cam, rmesh))
        else:
            from raytracer_weekend_tpu import integrator
            sums = np.asarray(integrator.render_image(
                scene, static, cfg, cam, progress=progress))
        dt = time.time() - t0
        sys.stderr.write("\n")

        img = tone_map(sums, cfg.samples_per_pixel)
        path = os.path.join(args.out_dir, f"image_{frame_no:04d}.png")
        save_png(path, img)
        rays = cfg.n_rays
        print(f"frame {frame_no}: {dt:.2f}s "
              f"({rays / dt / 1e6:.2f} Mrays/s primary) -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
