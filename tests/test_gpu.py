"""Tests that need a GPU: the Triton kernels compiled for the card.

They skip elsewhere (the gpu_device fixture decides at run time);
`python chip_smoke.py` runs them on the card with `pytest -m gpu`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_weekend_tpu import integrator
from raytracer_weekend_tpu.config import RenderConfig
from raytracer_weekend_tpu.ops import hit_rects, hit_spheres
from raytracer_weekend_tpu.ops.pallas import (hit_rects_pallas,
                                              hit_spheres_pallas)
from raytracer_weekend_tpu.ops.pallas.compare import (compare_hits, passes,
                                                      sphere_terms)
from raytracer_weekend_tpu.scene import builder as B
from raytracer_weekend_tpu.utils.platform import target_platform

pytestmark = pytest.mark.gpu
T_MIN = 1e-3


def _scene(n_spheres=300, n_rects=200, seed=0):
    rng = np.random.default_rng(seed)
    mat = B.Lambertian((0.5, 0.5, 0.5))
    objs = [B.Sphere(tuple(rng.normal(size=3) * 8), rng.uniform(0.2, 1.5),
                     mat) for _ in range(n_spheres - 1)]
    objs.append(B.MovingSphere((0, 0, -4), 0.0, (1, 0, -4), 1.0, 0.7, mat))
    ctors = [B.XYRectangle, B.XZRectangle, B.YZRectangle]
    for i in range(n_rects):
        a0, b0 = rng.uniform(-8, 6, 2)
        objs.append(ctors[i % 3](a0, a0 + rng.uniform(0.5, 3), b0,
                                 b0 + rng.uniform(0.5, 3),
                                 rng.uniform(-8, 8), mat))
    scene, static = B.build_scene(objs, bvh=False)
    o = jnp.asarray(rng.normal(size=(100_003, 3)) * 10, jnp.float32)
    d = jnp.asarray(rng.normal(size=(100_003, 3)), jnp.float32)
    time = jnp.asarray(rng.uniform(0, 1, 100_003), jnp.float32)
    return scene, static, o, d, time


def _check(family, table, rays, t_k, i_k, t_p, i_p):
    st = compare_hits(family, table, rays, t_k, i_k, t_p, i_p, T_MIN)
    assert passes(st), st


def test_sphere_kernel_on_gpu_matches_plain(gpu_device):
    scene, _, o, d, time = _scene()
    t_k, i_k = jax.jit(lambda *a: hit_spheres_pallas(scene.spheres, *a,
                                                     T_MIN))(o, d, time)
    t_p, i_p = jax.jit(lambda *a: hit_spheres(scene.spheres, *a,
                                              T_MIN))(o, d, time)
    assert np.isfinite(np.asarray(t_p)).mean() > 0.05
    _check("sphere", scene.spheres, (o, d, time), t_k, i_k, t_p, i_p)


def test_rect_kernel_on_gpu_matches_plain(gpu_device):
    scene, _, o, d, _ = _scene()
    t_k, i_k = jax.jit(lambda *a: hit_rects_pallas(scene.rects, *a,
                                                   T_MIN))(o, d)
    t_p, i_p = jax.jit(lambda *a: hit_rects(scene.rects, *a, T_MIN))(o, d)
    assert np.isfinite(np.asarray(t_p)).mean() > 0.05
    _check("rect", scene.rects, (o, d), t_k, i_k, t_p, i_p)


@pytest.mark.parametrize("family", ["sphere", "rect"])
def test_kernel_vjp_on_gpu_matches_plain(gpu_device, family):
    scene, _, o, d, time = _scene(n_spheres=40, n_rects=40)
    o, d, time = o[:4096], d[:4096], time[:4096]

    def loss(o, kernel):
        if family == "sphere":
            fn = hit_spheres_pallas if kernel else hit_spheres
            t, _ = fn(scene.spheres, o, d, time, T_MIN)
        else:
            fn = hit_rects_pallas if kernel else hit_rects
            t, _ = fn(scene.rects, o, d, T_MIN)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    g_k = np.asarray(jax.jit(jax.grad(lambda o: loss(o, True)))(o))
    g_p = np.asarray(jax.jit(jax.grad(lambda o: loss(o, False)))(o))
    assert np.abs(g_p).max() > 0
    ok = np.isclose(g_k, g_p, rtol=1e-3, atol=1e-3).all(axis=1)
    if family == "sphere":
        # dt/do grows like 1/sqrt(disc): near-tangent rays, whose float32
        # disc carries a relative error above 1e-4, may differ more.
        _, i_p = hit_spheres(scene.spheres, o, d, time, T_MIN)
        _, i_k = hit_spheres_pallas(scene.spheres, o, d, time, T_MIN)
        ok |= np.asarray(i_k) != np.asarray(i_p)    # knife-edge winners
        disc, d_disc, *_ = sphere_terms(scene.spheres, np.asarray(o, float),
                                        np.asarray(d, float),
                                        np.asarray(time, float),
                                        np.asarray(i_p))
        ok |= np.abs(d_disc) > 1e-4 * np.abs(disc)
    assert ok.all(), np.flatnonzero(~ok)


def test_integrator_picks_kernels_on_gpu(gpu_device):
    scene, static, o, d, time = _scene(n_spheres=20, n_rects=20)
    assert target_platform() == "gpu"
    paths = integrator.hit_paths(static, target_platform(), sphere_bvh=False,
                                 triangle_bvh=False)
    assert (paths.sphere, paths.rect) == ("kernel", "kernel")
    text = jax.jit(lambda o: integrator._closest_hit(
        scene, static, o, d[:256], time[:256], jnp.uint32(0),
        jnp.arange(256, dtype=jnp.uint32), 0,
        RenderConfig())).lower(o[:256]).as_text()
    assert "xla.gpu.triton" in text
