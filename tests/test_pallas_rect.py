"""Rect closest-hit Triton kernel vs the plain jnp op (interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_weekend_tpu.ops import hit_rects
from raytracer_weekend_tpu.ops.pallas import Tiling, hit_rects_pallas
from raytracer_weekend_tpu.scene import builder as B

T_MIN = 1e-3


def _rect_scene(rng, n=30):
    objs = []
    ctors = [B.XYRectangle, B.XZRectangle, B.YZRectangle]
    for i in range(n):
        a0, b0 = rng.uniform(-4, 2, 2)
        k = rng.uniform(-4, 4)
        objs.append(ctors[i % 3](a0, a0 + rng.uniform(0.5, 3),
                                 b0, b0 + rng.uniform(0.5, 3), k,
                                 B.Lambertian((1, 1, 1))))
    scene, _ = B.build_scene(objs)
    return scene.rects


def _rays(rng, n):
    o = jnp.asarray(rng.normal(size=(n, 3)) * 6, jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    return o, d


def _assert_same_hits(t_k, i_k, t_p, i_p):
    t_k, i_k, t_p, i_p = map(np.asarray, (t_k, i_k, t_p, i_p))
    np.testing.assert_array_equal(np.isfinite(t_k), np.isfinite(t_p))
    np.testing.assert_allclose(t_k, t_p, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(i_k, i_p)


def test_rect_kernel_matches_jnp(rng):
    rc = _rect_scene(rng)
    o, d = _rays(rng, 100)
    t_ref, i_ref = hit_rects(rc, o, d, T_MIN)
    t_pl, i_pl = hit_rects_pallas(rc, o, d, T_MIN, True)
    assert np.isfinite(np.asarray(t_ref)).any()
    _assert_same_hits(t_pl, i_pl, t_ref, i_ref)


def test_rect_kernel_custom_vjp(rng):
    rc0 = _rect_scene(rng, n=9)
    o, d = _rays(rng, 32)

    def loss(k, kernel):
        rc = rc0._replace(k=k)
        fn = (lambda *a: hit_rects_pallas(*a, True)) if kernel else hit_rects
        t, _ = fn(rc, o, d, T_MIN)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    g_pl = np.asarray(jax.grad(loss)(rc0.k, True))
    g_ref = np.asarray(jax.grad(loss)(rc0.k, False))
    assert np.abs(g_ref).max() > 0
    np.testing.assert_allclose(g_pl, g_ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n_rays,n_rects", [(1, 3), (129, 9), (300, 17),
                                            (256, 64)])
def test_rect_kernel_partial_blocks_and_chunks(rng, n_rays, n_rects):
    rc = _rect_scene(rng, n=n_rects)
    o, d = _rays(rng, n_rays)
    t_k, i_k = hit_rects_pallas(rc, o, d, T_MIN, True)
    assert t_k.shape == (n_rays,)
    assert int(np.asarray(i_k).max()) < n_rects
    _assert_same_hits(t_k, i_k, *hit_rects(rc, o, d, T_MIN))


@pytest.mark.parametrize("axis_ctor", [B.YZRectangle, B.XZRectangle,
                                       B.XYRectangle])
def test_rect_kernel_each_axis(axis_ctor):
    """One unit rect per axis at k=-2, rays along that axis: t = 2 inside
    the bounds, a miss outside them and for rays parallel to the plane."""
    scene, _ = B.build_scene([axis_ctor(-1, 1, -1, 1, -2.0,
                                        B.Lambertian((1, 1, 1)))])
    rc = scene.rects
    ax = int(np.asarray(rc.axis)[0])
    e = np.eye(3, dtype=np.float32)
    side = e[(ax + 1) % 3]
    o = jnp.asarray(np.stack([np.zeros(3), 3 * side, np.zeros(3)]),
                    jnp.float32)
    d = jnp.asarray(np.stack([-e[ax], -e[ax], side]), jnp.float32)
    t_k, i_k = hit_rects_pallas(rc, o, d, T_MIN, True)
    t_k = np.asarray(t_k)
    assert np.isclose(t_k[0], 2.0) and np.isinf(t_k[1:]).all()
    _assert_same_hits(t_k, i_k, *hit_rects(rc, o, d, T_MIN))


def test_rect_kernel_invalid_rows_and_ties(rng):
    """Duplicate rects tie exactly (lowest valid row wins); rows with
    valid=False never win."""
    objs = [B.XYRectangle(-1, 1, -1, 1, -3.0, B.Lambertian((1, 1, 1)))
            for _ in range(10)]
    scene, _ = B.build_scene(objs)
    rc = scene.rects._replace(valid=jnp.asarray([False] * 5 + [True] * 5))
    o = jnp.zeros((8, 3))
    d = jnp.asarray(rng.normal(size=(8, 3)) * 0.1 + [0, 0, -1], jnp.float32)
    t_k, i_k = hit_rects_pallas(rc, o, d, T_MIN, True,
                                Tiling(block_b=32, chunk=4))
    assert (np.asarray(i_k) == 5).all()
    _assert_same_hits(t_k, i_k, *hit_rects(rc, o, d, T_MIN))


@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "fwd+bwd"])
def test_rect_kernel_lowers_to_triton(rng, grad):
    rc = _rect_scene(rng, n=21)
    o, d = _rays(rng, 300)

    def f(o):
        t, i = hit_rects_pallas(rc, o, d, T_MIN)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0)), i

    fn = jax.grad(lambda o: f(o)[0]) if grad else f
    text = jax.jit(fn).trace(o).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
