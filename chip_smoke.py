"""Smoke test of the path tracer on the GPU, through its normal entry points.

    python chip_smoke.py           # one card: device, parity, forward, grad,
                                   # kernel
    python chip_smoke.py --four    # four cards: the sharded render and train
                                   # step against one card, nothing else

One process drives every card it uses. Any failed check raises, so the exit
code is non-zero and the JSON result line is never printed. Without a GPU
the script exits non-zero before any phase. The last line of standard
output is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
and the line before it is the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

PARITY_SCENES = ("jumpy_balls", "cornell_box", "smokey_cornell_box",
                 "wavefront_cow_obj", "two_perlin_spheres",
                 "book2_final_scene")
FORWARD_SCENES = ("jumpy_balls", "book2_final_scene")
CLI_RAY_BATCH = 1 << 20          # utils/cli.py's --ray-batch default

# Monte-Carlo-aware image tolerances (tone-mapped floats): ~1-ulp rounding
# differences between backends send a few percent of lanes onto different,
# equally valid paths, so lane-for-lane equality is not expected.
PIX_ATOL, PIX_FRAC = 0.08, 0.96
MEAN_TOL, SIGNED_TOL = 0.008, 0.004


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int = 5):
    """Median wall time of `reps` calls of fn() (each ends in
    block_until_ready), after one warm-up call. Returns (median_s, out)."""
    import jax

    out = jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def scene_on(name, cfg, device):
    """Build a catalog scene with its arrays on `device`; the render traced
    under jax.default_device(device) then targets that device's platform."""
    import jax

    from raytracer_weekend_tpu.models.scenes import generate_scene

    with jax.default_device(device):
        return generate_scene(name, cfg.aspect_ratio, seed=cfg.seed)


def render_on(name, cfg, device):
    import jax

    from raytracer_weekend_tpu import integrator

    scene, static, cams = scene_on(name, cfg, device)
    with jax.default_device(device):
        sums = integrator.render_image(scene, static, cfg, cams[0])
        return np.asarray(sums), static


def image_diff(a_sums, b_sums, spp):
    from raytracer_weekend_tpu.utils.image import tone_map_f32

    a, b = tone_map_f32(a_sums, spp), tone_map_f32(b_sums, spp)
    d = np.abs(a - b)
    return dict(max=float(d.max()), mean=float(d.mean()),
                signed=float((a - b).mean()),
                frac_ok=float((d.max(axis=-1) <= PIX_ATOL).mean()))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(dev):
    import jax

    from raytracer_weekend_tpu.native import have_native
    from raytracer_weekend_tpu.utils.platform import nvidia_smi_name_power

    card = nvidia_smi_name_power()
    try:
        import PIL  # noqa: F401  (JPEG textures only; no phase needs it)
        pillow = True
    except ImportError:
        pillow = False
    log(f"[device] {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
        f"nvidia-smi: {card}; jax {jax.__version__}; pillow={pillow}; "
        f"native BVH/COBS library={have_native()}")
    return card


def phase_parity(gpu, cpu):
    from raytracer_weekend_tpu.config import RenderConfig
    from raytracer_weekend_tpu.utils.image import tone_map_f32

    cfg = RenderConfig(width=64, height=36, samples_per_pixel=16,
                       max_depth=8, seed=0)
    means = {}
    for name in PARITY_SCENES:
        got, _ = render_on(name, cfg, gpu)
        ref, _ = render_on(name, cfg, cpu)
        m = image_diff(got, ref, cfg.samples_per_pixel)
        ok = (np.isfinite(got).all() and m["frac_ok"] >= PIX_FRAC
              and m["mean"] <= MEAN_TOL and abs(m["signed"]) <= SIGNED_TOL)
        log(f"[parity] {name}: max {m['max']:.4f} mean {m['mean']:.5f} "
            f"signed {m['signed']:+.5f} pixels<= {PIX_ATOL}: "
            f"{m['frac_ok']:.4f} -> {'ok' if ok else 'FAIL'}")
        assert ok, f"parity failed for {name}: {m}"
        means[name] = float(tone_map_f32(ref, cfg.samples_per_pixel).mean())
    return means


def phase_forward(gpu, ref_means):
    import jax
    import jax.numpy as jnp

    from raytracer_weekend_tpu import integrator
    from raytracer_weekend_tpu.config import RenderConfig
    from raytracer_weekend_tpu.utils.image import tone_map_f32

    cfg = RenderConfig(width=400, height=225, samples_per_pixel=16,
                       max_depth=8, seed=0, ray_batch=CLI_RAY_BATCH)
    for name in FORWARD_SCENES:
        scene, static, cams = scene_on(name, cfg, gpu)
        paths = integrator.hit_paths(
            static, "gpu", sphere_bvh=scene.sphere_bvh is not None,
            triangle_bvh=scene.triangle_bvh is not None)

        def frame():
            return integrator.render_image(scene, static, cfg, cams[0])

        t0 = time.perf_counter()
        img = np.asarray(jax.block_until_ready(frame()))
        compile_s = time.perf_counter() - t0
        frame_s, _ = timed(frame)

        @jax.jit
        def segments(scene, cam, ids):
            o, d, t, rid = integrator._pixel_rays(cam, cfg, ids,
                                                  jnp.uint32(cfg.seed))
            return integrator.trace_rays(scene, static, cfg, o, d, t, rid,
                                         jnp.uint32(cfg.seed),
                                         return_stats=True)[1]

        segs = sum(int(segments(scene, cams[0], jnp.arange(
            s, min(s + cfg.ray_batch, cfg.n_rays), dtype=jnp.int32)))
            for s in range(0, cfg.n_rays, cfg.ray_batch))
        mean = float(tone_map_f32(img, cfg.samples_per_pixel).mean())
        rel = abs(mean - ref_means[name]) / ref_means[name]
        log(f"[forward] {name} 400x225x16 depth 8 ray_batch {cfg.ray_batch} "
            f"paths {dict(paths._asdict())}: compile+first {compile_s:.2f} s, "
            f"median frame {frame_s * 1e3:.2f} ms, segments {segs} "
            f"({segs / frame_s / 1e6:.1f} M/s), peak {peak_bytes(gpu)} B, "
            f"tone-mapped mean {mean:.5f} vs parity-size {ref_means[name]:.5f}"
            f" ({rel:.2%})")
        assert np.isfinite(img).all(), f"{name}: non-finite pixels"
        assert rel <= 0.05, f"{name}: mean off by {rel:.2%}"


def _float_leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)
            if np.issubdtype(np.asarray(x).dtype, np.floating)]


def _chunk_grad(scene, static, cfg, cam, start, n):
    """jax.grad of an L2 loss over lanes [start, start+n) of the frame."""
    import jax
    import jax.numpy as jnp

    from raytracer_weekend_tpu import integrator

    @jax.jit
    def grad(scene):
        def loss(scene):
            ids = start + jnp.arange(n, dtype=jnp.int32)
            colors = integrator.render_chunk(scene, static, cfg, cam, ids,
                                             jnp.uint32(cfg.seed))
            return jnp.mean(colors ** 2)
        return jax.grad(loss, allow_int=True)(scene)

    return grad


def phase_grad(gpu, cpu):
    import jax

    from raytracer_weekend_tpu.config import RenderConfig
    from raytracer_weekend_tpu.train import InverseRenderer

    # Real size: a 2^18-lane chunk of the jumpy frame.
    cfg = RenderConfig(width=400, height=225, samples_per_pixel=16,
                       max_depth=8, seed=0)
    scene, static, cams = scene_on("jumpy_balls", cfg, gpu)
    grad = _chunk_grad(scene, static, cfg, cams[0], 1 << 19, 1 << 18)
    t0 = time.perf_counter()
    jax.block_until_ready(grad(scene))
    compile_s = time.perf_counter() - t0
    step_s, g = timed(lambda: grad(scene))
    leaves = _float_leaves(g)
    log(f"[grad] jumpy_balls 2^18 lanes depth 8: compile+first "
        f"{compile_s:.2f} s, median fwd+bwd {step_s * 1e3:.2f} ms, "
        f"peak {peak_bytes(gpu)} B, {len(leaves)} float leaves")
    assert all(np.isfinite(x).all() for x in leaves), "non-finite gradient"

    # Gradient parity, GPU against CPU.
    small = RenderConfig(width=32, height=18, samples_per_pixel=4,
                         max_depth=4, seed=0)
    for name in ("two_spheres", "simple_triangle"):
        grads = []
        for dev in (gpu, cpu):
            scene, static, cams = scene_on(name, small, dev)
            with jax.default_device(dev):
                grads.append(_float_leaves(_chunk_grad(
                    scene, static, small, cams[0], 0, small.n_rays)(scene)))
        worst = 0.0
        for a, b in zip(*grads):
            if np.linalg.norm(b) > 1e-6:
                worst = max(worst, float(np.linalg.norm(a - b)
                                         / np.linalg.norm(b)))
        log(f"[grad] parity {name} 32x18x4 depth 4: worst relative L2 "
            f"{worst:.2e}")
        assert worst <= 5e-2, f"{name}: gradient parity {worst}"

    # Inverse rendering: three Adam steps from a perturbed albedo.
    scene, static, cams = scene_on("two_spheres", small, gpu)
    with jax.default_device(gpu):
        target = InverseRenderer(static, small, cams[0], None)._render(scene)
        start = scene._replace(textures=scene.textures._replace(
            color1=scene.textures.color1 * 0.5))
        ir = InverseRenderer(static, small, cams[0], target,
                             learning_rate=5e-2)
        _, hist = ir.fit(start, steps=3)
    log(f"[grad] InverseRenderer.fit(steps=3) losses {hist}")
    assert np.isfinite(hist).all() and hist[-1] < hist[0], hist


def _bounce_rays(scene, static, cfg, cam):
    """Primary rays of the full frame and their first scattered rays."""
    import jax
    import jax.numpy as jnp

    from raytracer_weekend_tpu import integrator, materials

    @jax.jit
    def rays(scene, cam):
        seed = jnp.uint32(cfg.seed)
        ids = jnp.arange(cfg.n_rays, dtype=jnp.int32)
        o, d, time, rid = integrator._pixel_rays(cam, cfg, ids, seed)
        t, fam, idx = integrator._closest_hit(scene, static, o, d, time,
                                              seed, rid, 0, cfg)
        p, n, ff, u, v, mat = integrator._hit_record(
            scene, static, o, d, time, t, fam, idx)
        sc = materials.scatter(scene.materials, scene.textures, mat, d, p, n,
                               ff, u, v, seed, rid, jnp.uint32(0),
                               has_noise=static.has_noise,
                               has_image=static.has_image)
        hit = jnp.isfinite(t) & sc.alive
        return (o, d, time), (jnp.where(hit[:, None], p, o),
                              jnp.where(hit[:, None], sc.direction, d), time)

    return rays(scene, cam)


def phase_kernel(gpu):
    import jax
    import jax.numpy as jnp
    import pytest

    from raytracer_weekend_tpu.config import RenderConfig
    from raytracer_weekend_tpu.ops import hit_rects, hit_spheres
    from raytracer_weekend_tpu.ops.pallas import (hit_rects_pallas,
                                                  hit_spheres_pallas)
    from raytracer_weekend_tpu.ops.pallas.compare import compare_hits, passes

    cfg = RenderConfig(width=400, height=225, samples_per_pixel=16,
                       max_depth=8, seed=0)
    chunk = 1 << 18   # the plain op's (rays x prims) planes, chunked to fit

    def plain_chunked(fn, rays):
        outs = [fn(*[x[s:s + chunk] for x in rays])
                for s in range(0, rays[0].shape[0], chunk)]
        return (jnp.concatenate([a for a, _ in outs]),
                jnp.concatenate([b for _, b in outs]))

    cases = (("sphere", "jumpy_balls"), ("rect", "book2_final_scene"))
    for fam, name in cases:
        scene, static, cams = scene_on(name, cfg, gpu)
        with jax.default_device(gpu):
            bounces = _bounce_rays(scene, static, cfg, cams[0])
            if fam == "sphere":
                tab = scene.spheres
                kern = jax.jit(lambda o, d, t: hit_spheres_pallas(
                    tab, o, d, t, cfg.t_min))
                plain = jax.jit(lambda o, d, t: hit_spheres(
                    tab, o, d, t, cfg.t_min))
            else:
                tab = scene.rects
                kern = jax.jit(lambda o, d, t: hit_rects_pallas(
                    tab, o, d, cfg.t_min))
                plain = jax.jit(lambda o, d, t: hit_rects(
                    tab, o, d, cfg.t_min))
            for which, rays in zip(("primary", "bounce 1"), bounces):
                k_s, (t_k, i_k) = timed(lambda: kern(*rays))
                p_s, (t_p, i_p) = timed(lambda: plain_chunked(plain, rays))
                st = compare_hits(fam, tab, rays, t_k, i_k, t_p, i_p,
                                  cfg.t_min)
                log(f"[kernel] {fam} {name} {which}: {st}")
                assert passes(st), f"{fam} {name} {which}: {st}"
                log(f"[kernel] {fam} {name} {which}: kernel "
                    f"{k_s * 1e3:.3f} ms, plain (HIGHEST, {chunk}-ray "
                    f"chunks) {p_s * 1e3:.3f} ms, table rows "
                    f"{tab.valid.shape[0]}")

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")])
    log(f"[kernel] pytest -m gpu exit code {int(rc)}")
    assert int(rc) == 0, f"gpu-marked tests failed (exit code {int(rc)})"


def phase_four(devs):
    import jax
    import jax.numpy as jnp

    from raytracer_weekend_tpu import integrator
    from raytracer_weekend_tpu.config import RenderConfig
    from raytracer_weekend_tpu.parallel import (make_render_mesh,
                                                render_sharded, train_step)

    assert len(devs) >= 4, f"--four needs 4 GPUs, JAX found {len(devs)}"
    cfg = RenderConfig(width=200, height=112, samples_per_pixel=16,
                       max_depth=8, seed=0)
    for name in FORWARD_SCENES:
        scene, static, cams = scene_on(name, cfg, devs[0])
        with jax.default_device(devs[0]):
            ref = np.asarray(integrator.render_image(scene, static, cfg,
                                                     cams[0]))
        for shape in ((4, 1, 1), (1, 2, 2), (1, 1, 4)):
            rmesh = make_render_mesh(shape, devices=devs[:4])
            t_s, img = timed(lambda: render_sharded(scene, static, cfg,
                                                    cams[0], rmesh), reps=3)
            img = np.asarray(img)
            err = float(np.max(np.abs(img - ref) / np.maximum(ref, 1e-30)))
            log(f"[four] {name} mesh {shape}: median {t_s * 1e3:.2f} ms, "
                f"max rel diff vs one card {err:.2e}")
            np.testing.assert_allclose(img, ref, rtol=1e-5, atol=0)

    # Gradients of the sharded L2 loss against one card's.
    small = RenderConfig(width=64, height=36, samples_per_pixel=4,
                         max_depth=4, seed=0)
    scene, static, cams = scene_on("jumpy_balls", small, devs[0])
    rmesh = make_render_mesh((1, 2, 2), devices=devs[:4])
    with jax.default_device(devs[0]):
        target = integrator.render_image(scene, static, small,
                                         cams[0]) / small.samples_per_pixel
        start = scene._replace(textures=scene.textures._replace(
            color1=scene.textures.color1 * 0.7))

        def loss_one(s):
            return jnp.mean((integrator.render_image(s, static, small,
                                                     cams[0])
                             / small.samples_per_pixel - target) ** 2)

        g_one = _float_leaves(jax.grad(loss_one, allow_int=True)(start))

    def loss_mesh(s):
        return jnp.mean((render_sharded(s, static, small, cams[0], rmesh)
                         / small.samples_per_pixel - target) ** 2)

    g_mesh = _float_leaves(jax.grad(loss_mesh, allow_int=True)(start))
    worst = 0.0
    for a, b in zip(g_mesh, g_one):
        scale = max(float(np.abs(b).max()), 1e-30)
        worst = max(worst, float(np.abs(a - b).max()) / scale)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale)
    losses = []
    s = start
    for _ in range(3):
        s, loss = train_step(s, static, small, cams[0], target, rmesh, lr=3.0)
        losses.append(float(loss))
    log(f"[four] train_step mesh (1, 2, 2): grad max diff / max |g| "
        f"{worst:.2e}; losses {losses}")
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    from raytracer_weekend_tpu.utils.platform import (enable_compile_cache,
                                                      require_gpu)

    enable_compile_cache()
    gpu = require_gpu()
    t_all = time.perf_counter()
    card = phase_device(gpu)
    if args.four:
        phase_four(jax.devices())
    else:
        cpu = jax.devices("cpu")[0]
        for name, fn in (("parity", lambda: phase_parity(gpu, cpu)),):
            t0 = time.perf_counter()
            means = fn()
            log(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
        for name, fn in (("forward", lambda: phase_forward(gpu, means)),
                         ("grad", lambda: phase_grad(gpu, cpu)),
                         ("kernel", lambda: phase_kernel(gpu))):
            t0 = time.perf_counter()
            fn()
            log(f"[{name}] done in {time.perf_counter() - t0:.1f} s")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
