"""End-to-end integrator tests: analytic cases + scalar-oracle parity.

The oracle (tests/oracle.py) implements the reference's recursive algorithm
(lib.rs:97-117) in scalar numpy while consuming the same counter-based RNG,
so the wavefront scan must reproduce it lane-for-lane.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_weekend_tpu import integrator
from raytracer_weekend_tpu.camera import make_camera
from raytracer_weekend_tpu.config import RenderConfig
from raytracer_weekend_tpu.scene import builder as B

from oracle import Oracle


def _cam(cfg, look_from=(13, 2, 3), look_at=(0, 0, 0), vfov=20.0,
         aperture=0.0):
    return make_camera(look_from, look_at, (0, 1, 0), vfov, cfg.aspect_ratio,
                       aperture, 10.0, 0.0, 1.0)


def test_background_only():
    # No objects: every ray returns the background (lib.rs:102-105).
    scene, static = B.build_scene([], background=(0.25, 0.5, 0.75))
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=2, max_depth=3)
    img = np.asarray(integrator.render_image(scene, static, cfg, _cam(cfg)))
    expect = np.array([0.25, 0.5, 0.75]) * cfg.samples_per_pixel
    np.testing.assert_allclose(img, np.broadcast_to(expect, img.shape),
                               atol=1e-5)


def test_enclosing_light_sphere():
    # Camera inside a giant emissive sphere: radiance == emission everywhere.
    light = B.DiffuseLight((2.0, 3.0, 4.0))
    scene, static = B.build_scene([B.Sphere((0, 0, 0), 100.0, light)],
                                  background=(0, 0, 0))
    cfg = RenderConfig(width=6, height=4, samples_per_pixel=2, max_depth=4)
    img = np.asarray(integrator.render_image(scene, static, cfg, _cam(cfg)))
    expect = np.array([2.0, 3.0, 4.0]) * cfg.samples_per_pixel
    np.testing.assert_allclose(img, np.broadcast_to(expect, img.shape),
                               rtol=1e-5)


def test_furnace_lambertian():
    # Furnace test: lambertian sphere with albedo a in a uniform environment
    # of radiance L converges to L (energy conservation): the path estimator
    # yields L * sum_k a^k (1-a)-weighted... With max_depth D the estimate is
    # L * (a^0 ... picked up at escape). For a=0.5, D large, expectation -> L.
    scene, static = B.build_scene(
        [B.Sphere((0, 0, -3), 1.0, B.Lambertian((0.5, 0.5, 0.5)))],
        background=(1.0, 1.0, 1.0))
    cfg = RenderConfig(width=4, height=4, samples_per_pixel=512, max_depth=30,
                       seed=5)
    cam = make_camera((0, 0, 0), (0, 0, -3), (0, 1, 0), 10.0, 1.0, 0.0, 3.0,
                      0.0, 1.0)
    img = np.asarray(integrator.render_image(scene, static, cfg, cam))
    mean = img.mean() / cfg.samples_per_pixel
    # E[radiance] = sum_k (1/2)^k * P(escape at k) ... for a diffuse furnace
    # with albedo 0.5 the geometric series gives exactly
    # sum_{k>=1} 0.5^k = 1 scaled by escape probabilities; empirically the
    # estimator must land near 0.5/(1-0.5) normalized -> just check it's
    # within Monte Carlo noise of the analytic 1/(2-1)=... use loose bounds.
    assert 0.45 < mean < 0.75


@pytest.mark.parametrize("scene_kind", ["spheres", "mixed", "cornellish"])
def test_wavefront_matches_scalar_oracle(scene_kind):
    if scene_kind == "spheres":
        objs = [
            B.Sphere((0, -100.5, -1), 100.0, B.Lambertian((0.8, 0.8, 0.0))),
            B.Sphere((0, 0, -1), 0.5, B.Lambertian((0.1, 0.2, 0.5))),
            B.Sphere((-1, 0, -1), 0.5, B.Dielectric(1.5)),
            B.Sphere((-1, 0, -1), -0.45, B.Dielectric(1.5)),
            B.Sphere((1, 0, -1), 0.5, B.Metal((0.8, 0.6, 0.2), 0.3)),
        ]
        bg = (0.7, 0.8, 1.0)
        cam = make_camera((0, 0, 1), (0, 0, -1), (0, 1, 0), 45.0, 2.0, 0.0,
                          2.0, 0.0, 1.0)
    elif scene_kind == "mixed":
        objs = [
            B.Sphere((0, -100.5, -1), 100.0,
                     B.Lambertian(B.Checker(B.SolidColor((0.2, 0.3, 0.1)),
                                            B.SolidColor((0.9, 0.9, 0.9)),
                                            10.0))),
            B.MovingSphere((0, 0, -1), 0.0, (0, 0.3, -1), 1.0, 0.4,
                           B.Lambertian((0.7, 0.3, 0.1))),
            B.Triangle.flat_shaded(((-2, 0, -2), (2, 0, -2), (0, 2, -2)),
                                   B.Lambertian(B.UVDebug())),
            B.XYRectangle(-1.0, 1.0, 0.5, 1.5, -1.8,
                          B.DiffuseLight((2.0, 2.0, 2.0))),
        ]
        bg = (0.1, 0.1, 0.15)
        cam = make_camera((0, 0.5, 1.5), (0, 0.3, -1), (0, 1, 0), 60.0, 2.0,
                          0.1, 2.0, 0.0, 1.0)
    else:  # cornellish: rects + rotated cuboid (-> triangles) + smoke volume
        white = B.Lambertian((0.73, 0.73, 0.73))
        objs = [
            B.YZRectangle(0.0, 5.0, 0.0, 5.0, 5.0, B.Lambertian((0.12, 0.45, 0.15))),
            B.YZRectangle(0.0, 5.0, 0.0, 5.0, 0.0, B.Lambertian((0.65, 0.05, 0.05))),
            B.XZRectangle(0.0, 5.0, 0.0, 5.0, 0.0, white),
            B.XZRectangle(0.0, 5.0, 0.0, 5.0, 5.0, white),
            B.XYRectangle(0.0, 5.0, 0.0, 5.0, 5.0, white),
            B.XZRectangle(1.8, 3.2, 1.8, 3.2, 4.99, B.DiffuseLight((7, 7, 7))),
            B.Cuboid((0, 0, 0), (1.5, 3.0, 1.5), white)
             .rotate_y(15.0).translate((2.6, 0.0, 2.9)),
            B.ConstantMedium(
                B.Cuboid((0, 0, 0), (1.5, 1.5, 1.5), white)
                 .rotate_y(-18.0).translate((1.3, 0.0, 0.65)),
                0.2, B.SolidColor((1.0, 1.0, 1.0))),
        ]
        bg = (0.0, 0.0, 0.0)
        cam = make_camera((2.5, 2.5, -6), (2.5, 2.5, 0), (0, 1, 0), 40.0, 1.0,
                          0.0, 10.0, 0.0, 1.0)

    scene, static = B.build_scene(objs, background=bg)
    cfg = RenderConfig(width=6, height=3, samples_per_pixel=2, max_depth=4,
                       seed=11)
    got = np.asarray(integrator.render_image(scene, static, cfg, cam))
    expect, fragile = Oracle(scene, static, cfg).render(cam, cfg,
                                                       return_fragile=True)
    # Identical RNG -> lane-exact paths, EXCEPT where the f64 oracle flags
    # a knife-edge decision (within 3e-4 of a discrete threshold): there
    # the f32 renderer may follow the other, equally valid branch. Robust
    # pixels must match tightly; fragile ones are excluded but bounded.
    robust = ~fragile
    assert robust.mean() > 0.5, f"too many fragile pixels ({fragile.mean():.2f})"
    close = np.isclose(got[robust], expect[robust], rtol=1e-3, atol=1e-3)
    frac = close.mean()
    assert frac >= 0.995, (
        f"only {frac:.4f} of robust channels match the oracle "
        f"({int(robust.sum())} robust / {fragile.size} pixels)")


def test_deterministic_across_chunking():
    objs = [B.Sphere((0, 0, -2), 0.7, B.Lambertian((0.5, 0.2, 0.8)))]
    scene, static = B.build_scene(objs)
    cfg1 = RenderConfig(width=8, height=4, samples_per_pixel=4, max_depth=4)
    cfg2 = RenderConfig(width=8, height=4, samples_per_pixel=4, max_depth=4,
                        ray_batch=16)
    cam = _cam(cfg1, look_from=(0, 0, 1), look_at=(0, 0, -2), vfov=40.0)
    a = np.asarray(integrator.render_image(scene, static, cfg1, cam))
    b = np.asarray(integrator.render_image(scene, static, cfg2, cam))
    np.testing.assert_allclose(a, b, atol=1e-5)


def _mixed_scene():
    """Every family at once: spheres (one moving, glass), a rect light,
    triangles from a rotated cuboid, and a smoke volume."""
    white = B.Lambertian((0.73, 0.73, 0.73))
    objs = [
        B.Sphere((0, -100.5, -1), 100.0, B.Lambertian((0.8, 0.8, 0.0))),
        B.MovingSphere((0, 0, -1), 0.0, (0, 0.2, -1), 1.0, 0.4,
                       B.Lambertian((0.1, 0.2, 0.5))),
        B.Sphere((-1, 0, -1), 0.45, B.Dielectric(1.5)),
        B.XYRectangle(-1.0, 1.0, 0.5, 1.5, -2.0,
                      B.DiffuseLight((3.0, 3.0, 3.0))),
        B.Cuboid((0, 0, 0), (0.5, 0.5, 0.5), white)
         .rotate_y(20.0).translate((0.6, -0.5, -1.5)),
        B.ConstantMedium(B.Sphere((1.2, 0, -1.2), 0.3, white), 0.5,
                         B.SolidColor((1.0, 1.0, 1.0))),
    ]
    scene, static = B.build_scene(objs, background=(0.5, 0.6, 0.8))
    assert static.n_spheres and static.n_rects and static.n_triangles
    assert static.n_volumes
    return scene, static


@pytest.mark.parametrize("ray_batch", [1, 37, 64, 100, 256])
def test_render_invariant_to_ray_batch(ray_batch):
    """Lanes and their RNG streams do not depend on the chunking: any
    ray_batch (including ones that leave a short last chunk) gives the
    single-batch image."""
    scene, static = _mixed_scene()
    cfg = RenderConfig(width=8, height=6, samples_per_pixel=3, max_depth=4,
                       seed=2)
    cam = _cam(cfg, look_from=(0, 0.3, 1.5), look_at=(0, 0, -1), vfov=60.0)
    whole = np.asarray(integrator.render_image(scene, static, cfg, cam))
    chunked = np.asarray(integrator.render_image(
        scene, static, dataclasses.replace(cfg, ray_batch=ray_batch), cam))
    assert whole.mean() > 0
    np.testing.assert_allclose(chunked, whole, rtol=1e-5, atol=1e-6)
