"""BVH: builder invariants + traversal equivalence with brute force."""

import jax.numpy as jnp
import numpy as np

from raytracer_weekend_tpu import integrator, native
from raytracer_weekend_tpu.camera import make_camera
from raytracer_weekend_tpu.config import RenderConfig
from raytracer_weekend_tpu.ops import bvh as bvh_mod
from raytracer_weekend_tpu.ops import hit_spheres, hit_triangles
from raytracer_weekend_tpu.scene import builder as B


def test_builder_layout_invariants(rng):
    n = 200
    lo = rng.normal(size=(n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
    nb, nx, prim, skip = native.build_bvh(lo, hi)
    m = len(prim)
    # Every primitive appears in exactly one leaf.
    leaves = prim[prim >= 0]
    assert sorted(leaves.tolist()) == list(range(n))
    # Skip links are strictly forward and land inside [i+1, m].
    assert ((skip > np.arange(m)) & (skip <= m)).all()
    # Parent boxes contain their subtree's boxes.
    for i in range(m):
        if prim[i] < 0:
            sub = slice(i + 1, skip[i])
            assert (nb[i] <= nb[sub] + 1e-6).all()
            assert (nx[i] >= nx[sub] - 1e-6).all()


def test_native_matches_numpy_fallback(rng):
    lo = rng.normal(size=(73, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 1.0, (73, 3)).astype(np.float32)
    a = native.build_bvh(lo, hi)
    b = native._build_bvh_numpy(lo, hi)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _tri_scene(rng, n=150, bvh=False):
    tris = []
    for _ in range(n):
        base = rng.normal(size=3) * 3
        v = base + rng.normal(size=(3, 3))
        tris.append(B.Triangle.flat_shaded(v, B.Lambertian((1, 1, 1))))
    return B.build_scene(tris, bvh=bvh)


def test_traversal_matches_brute_force_triangles(rng):
    scene, static = _tri_scene(rng, bvh=True)
    assert static.triangle_bvh
    o = jnp.asarray(rng.normal(size=(256, 3)) * 5, jnp.float32)
    d = jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)
    t_ref, i_ref = hit_triangles(scene.triangles, o, d, 1e-3)
    t_bvh, i_bvh = bvh_mod.traverse(
        scene.triangle_bvh, o, d, 1e-3,
        bvh_mod.triangle_prim_test(scene.triangles, o, d, 1e-3))
    np.testing.assert_allclose(np.asarray(t_bvh), np.asarray(t_ref),
                               rtol=1e-5, atol=1e-6)
    hit = np.isfinite(np.asarray(t_ref))
    np.testing.assert_array_equal(np.asarray(i_bvh)[hit],
                                  np.asarray(i_ref)[hit])


def test_traversal_matches_brute_force_spheres(rng):
    rows = [(tuple(c), r) for c, r in
            zip(rng.normal(size=(600, 3)) * 8, rng.uniform(0.2, 1.0, 600))]
    objs = [B.Sphere(c, r, B.Lambertian((1, 1, 1))) for c, r in rows]
    scene, static = B.build_scene(objs, bvh=True)
    assert static.sphere_bvh
    o = jnp.asarray(rng.normal(size=(256, 3)) * 10, jnp.float32)
    d = jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)
    time = jnp.zeros(256)
    t_ref, i_ref = hit_spheres(scene.spheres, o, d, time, 1e-3)
    t_bvh, i_bvh = bvh_mod.traverse(
        scene.sphere_bvh, o, d, 1e-3,
        bvh_mod.sphere_prim_test(scene.spheres, o, d, time, 1e-3))
    # The matmul-factored brute force and the oc-based leaf test associate the
    # quadratic differently; near-tangent lanes differ at ~1e-4 relative.
    np.testing.assert_allclose(np.asarray(t_bvh), np.asarray(t_ref),
                               rtol=2e-3, atol=1e-4)


def test_render_identical_with_and_without_bvh(rng):
    # The gate from SURVEY.md §7 step 6: identical images with/without BVH.
    objs = []
    for _ in range(100):
        c = rng.normal(size=3) * np.array([4, 1, 4]) + np.array([0, 0, -6])
        objs.append(B.Sphere(tuple(c), 0.4,
                             B.Lambertian(tuple(rng.uniform(0.2, 0.9, 3)))))
    for _ in range(80):
        base = rng.normal(size=3) * np.array([3, 1, 3]) + np.array([0, 1, -6])
        v = base + rng.normal(size=(3, 3)) * 0.6
        objs.append(B.Triangle.flat_shaded(
            v, B.Lambertian(tuple(rng.uniform(0.2, 0.9, 3)))))

    cfg = RenderConfig(width=10, height=5, samples_per_pixel=2, max_depth=3,
                       seed=4)
    cam = make_camera((0, 1, 2), (0, 0, -6), (0, 1, 0), 50.0,
                      cfg.aspect_ratio, 0.0, 6.0, 0.0, 1.0)

    scene_bf, static_bf = B.build_scene(objs, bvh=False)
    scene_bvh, static_bvh = B.build_scene(objs, bvh=True)
    assert static_bvh.sphere_bvh is False or True  # spheres: 100 <= 512 auto
    img_bf = np.asarray(integrator.render_image(scene_bf, static_bf, cfg, cam))
    img_bvh = np.asarray(integrator.render_image(scene_bvh, static_bvh, cfg,
                                                 cam))
    np.testing.assert_allclose(img_bvh, img_bf, rtol=1e-5, atol=1e-5)
