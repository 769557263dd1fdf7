"""Sphere closest-hit Triton kernel vs the plain jnp op.

Off the card the kernel runs in the Pallas interpreter (interpret=True):
that checks its arithmetic, chunking, padding, tie-breaking and custom VJP.
The lowering to Triton IR is checked too (lowering for CUDA needs no card);
compiling that IR and running it happen only on the GPU (tests/test_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_weekend_tpu.ops import hit_spheres
from raytracer_weekend_tpu.ops.pallas import Tiling, hit_spheres_pallas
from raytracer_weekend_tpu.scene import builder as B

T_MIN = 1e-3


def _sphere_scene(rng, n=50, moving=True):
    objs = []
    for _ in range(n - 1 if moving else n):
        c = rng.normal(size=3) * 6
        objs.append(B.Sphere(tuple(c), rng.uniform(0.3, 1.2),
                             B.Lambertian((0.5, 0.5, 0.5))))
    if moving:
        objs.append(B.MovingSphere((0, 0, -4), 0.0, (1, 0, -4), 1.0, 0.7,
                                   B.Lambertian((0.5, 0.5, 0.5))))
    scene, _ = B.build_scene(objs, bvh=False)
    return scene.spheres


def _rays(rng, n, spread=8.0):
    o = jnp.asarray(rng.normal(size=(n, 3)) * spread, jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    time = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    return o, d, time


def _assert_same_hits(t_k, i_k, t_p, i_p):
    t_k, i_k, t_p, i_p = map(np.asarray, (t_k, i_k, t_p, i_p))
    np.testing.assert_array_equal(np.isfinite(t_k), np.isfinite(t_p))
    np.testing.assert_allclose(t_k, t_p, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(i_k, i_p)


def test_sphere_kernel_matches_jnp(rng):
    sp = _sphere_scene(rng)
    o, d, time = _rays(rng, 100)
    t_ref, i_ref = hit_spheres(sp, o, d, time, T_MIN)
    t_pl, i_pl = hit_spheres_pallas(sp, o, d, time, T_MIN, True)
    assert np.isfinite(np.asarray(t_ref)).any()
    _assert_same_hits(t_pl, i_pl, t_ref, i_ref)


def test_sphere_kernel_custom_vjp(rng):
    sp0 = _sphere_scene(rng, n=10)
    o, d, _ = _rays(rng, 32, spread=6.0)
    time = jnp.zeros(32)

    def loss(c0, kernel):
        sp = sp0._replace(c0=c0, c1=c0)
        fn = (lambda *a: hit_spheres_pallas(*a, True)) if kernel else hit_spheres
        t, _ = fn(sp, o, d, time, T_MIN)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    g_pl = np.asarray(jax.grad(loss)(sp0.c0, True))
    g_ref = np.asarray(jax.grad(loss)(sp0.c0, False))
    assert np.abs(g_ref).max() > 0
    np.testing.assert_allclose(g_pl, g_ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n_rays", [1, 127, 128, 129, 300])
def test_sphere_kernel_partial_ray_blocks(rng, n_rays):
    """Ray counts that do not fill the last block are padded and sliced."""
    sp = _sphere_scene(rng, n=20)
    o, d, time = _rays(rng, n_rays)
    t_k, i_k = hit_spheres_pallas(sp, o, d, time, T_MIN, True)
    assert t_k.shape == (n_rays,) and i_k.shape == (n_rays,)
    _assert_same_hits(t_k, i_k, *hit_spheres(sp, o, d, time, T_MIN))


@pytest.mark.parametrize("n_spheres", [1, 7, 8, 9, 33])
def test_sphere_kernel_partial_table_chunks(rng, n_spheres):
    """Tables that do not fill the last chunk: padded rows never win."""
    sp = _sphere_scene(rng, n=n_spheres, moving=False)
    o, d, time = _rays(rng, 200, spread=4.0)
    t_k, i_k = hit_spheres_pallas(sp, o, d, time, T_MIN, True)
    assert int(np.asarray(i_k).max()) < n_spheres
    _assert_same_hits(t_k, i_k, *hit_spheres(sp, o, d, time, T_MIN))


@pytest.mark.parametrize("tiling", [Tiling(block_b=32, chunk=4),
                                    Tiling(block_b=64, chunk=16),
                                    Tiling(block_b=256, chunk=1)])
def test_sphere_kernel_tilings_agree(rng, tiling):
    sp = _sphere_scene(rng, n=40)
    o, d, time = _rays(rng, 150)
    t_k, i_k = hit_spheres_pallas(sp, o, d, time, T_MIN, True, tiling)
    _assert_same_hits(t_k, i_k, *hit_spheres(sp, o, d, time, T_MIN))


def test_sphere_kernel_all_miss(rng):
    """Rays pointing away from every sphere: t=inf and idx=0, like argmin
    over an all-inf row."""
    sp = _sphere_scene(rng, n=12, moving=False)
    o = jnp.full((64, 3), 100.0)
    d = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]]), (64, 1))
    time = jnp.zeros(64)
    t_k, i_k = hit_spheres_pallas(sp, o, d, time, T_MIN, True)
    assert np.isinf(np.asarray(t_k)).all()
    assert (np.asarray(i_k) == 0).all()
    _assert_same_hits(t_k, i_k, *hit_spheres(sp, o, d, time, T_MIN))


def test_sphere_kernel_moving_sphere_follows_time():
    """A moving sphere is hit at its time-lerped center."""
    scene, _ = B.build_scene([B.MovingSphere(
        (0, 0, -5), 0.0, (0, 2, -5), 1.0, 0.5, B.Lambertian((1, 1, 1)))])
    o = jnp.zeros((3, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.4, -1.0], [0.0, 0.0, -1.0]])
    time = jnp.asarray([0.0, 1.0, 1.0])
    t_k, i_k = hit_spheres_pallas(scene.spheres, o, d, time, T_MIN, True)
    t_k = np.asarray(t_k)
    assert np.isclose(t_k[0], 4.5, atol=1e-5)
    assert np.isfinite(t_k[1]) and np.isinf(t_k[2])
    _assert_same_hits(t_k, i_k, *hit_spheres(scene.spheres, o, d, time,
                                             T_MIN))


def test_sphere_kernel_skips_invalid_rows(rng):
    """Rows with valid=False (geometry-shard padding) never win, even when
    they are the nearest."""
    sp = _sphere_scene(rng, n=16, moving=False)
    o, d, time = _rays(rng, 128)
    t_all, i_all = hit_spheres(sp, o, d, time, T_MIN)
    winners = np.unique(np.asarray(i_all)[np.isfinite(np.asarray(t_all))])
    valid = np.ones(16, bool)
    valid[winners[: len(winners) // 2]] = False
    sp = sp._replace(valid=jnp.asarray(valid))
    t_k, i_k = hit_spheres_pallas(sp, o, d, time, T_MIN, True)
    hit = np.isfinite(np.asarray(t_k))
    assert valid[np.asarray(i_k)[hit]].all()
    _assert_same_hits(t_k, i_k, *hit_spheres(sp, o, d, time, T_MIN))


def test_sphere_kernel_ties_pick_first_row():
    """Identical spheres tie exactly; the lowest row wins, as with argmin,
    also when the copies sit in different chunks."""
    objs = [B.Sphere((0, 0, -5), 1.0, B.Lambertian((1, 1, 1)))
            for _ in range(12)]
    scene, _ = B.build_scene(objs, bvh=False)
    o = jnp.zeros((4, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.1, 0.0, -1.0],
                     [0.0, 0.1, -1.0], [0.0, 1.0, 0.0]])
    time = jnp.zeros(4)
    t_k, i_k = hit_spheres_pallas(scene.spheres, o, d, time, T_MIN, True,
                                  Tiling(block_b=32, chunk=4))
    np.testing.assert_array_equal(np.asarray(i_k), [0, 0, 0, 0])
    _assert_same_hits(t_k, i_k, *hit_spheres(scene.spheres, o, d, time,
                                             T_MIN))


@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "fwd+bwd"])
def test_sphere_kernel_lowers_to_triton(rng, grad):
    """The kernel (and its custom VJP) lowers to one Triton custom call
    when the target is CUDA — the step before the card's compiler."""
    sp = _sphere_scene(rng, n=20)
    o, d, time = _rays(rng, 300)

    def f(o):
        t, i = hit_spheres_pallas(sp, o, d, time, T_MIN)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0)), i

    fn = jax.grad(lambda o: f(o)[0]) if grad else f
    text = jax.jit(fn).trace(o).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1


def _jumpy_primary(width=32, height=18, spp=2):
    from raytracer_weekend_tpu.config import RenderConfig
    from raytracer_weekend_tpu.integrator import _pixel_rays
    from raytracer_weekend_tpu.models.scenes import generate_scene

    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp)
    scene, _, cams = generate_scene("jumpy_balls", cfg.aspect_ratio)
    ids = jnp.arange(cfg.n_rays, dtype=jnp.int32)
    o, d, time, _ = _pixel_rays(cams[0], cfg, ids, jnp.uint32(0))
    return scene.spheres, (o, d, time)


def test_compare_hits_accepts_rounding_on_catalog_scene():
    """jumpy_balls' ground sphere (r = 1000) makes |c|^2 - r^2 cancel in
    float32: kernel and plain op differ beyond 1e-5 on some rays, and the
    float64 rounding bound explains every difference."""
    from raytracer_weekend_tpu.ops.pallas.compare import compare_hits, passes

    sp, rays = _jumpy_primary()
    t_p, i_p = hit_spheres(sp, *rays, T_MIN)
    t_k, i_k = hit_spheres_pallas(sp, *rays, T_MIN, True)
    st = compare_hits("sphere", sp, rays, t_k, i_k, t_p, i_p, T_MIN)
    assert st["hits"] > 0.5 * st["rays"]
    assert passes(st), st


@pytest.mark.parametrize("fault", ["t", "idx", "miss"])
def test_compare_hits_flags_real_differences(fault):
    from raytracer_weekend_tpu.ops.pallas.compare import compare_hits, passes

    sp, rays = _jumpy_primary(width=16, height=9, spp=1)
    t_p, i_p = map(np.array, hit_spheres(sp, *rays, T_MIN))
    t_k, i_k = t_p.copy(), i_p.copy()
    assert passes(compare_hits("sphere", sp, rays, t_k, i_k, t_p, i_p, T_MIN))
    r = int(np.flatnonzero(np.isfinite(t_p))[0])
    if fault == "t":
        t_k[r] *= 1.01
    elif fault == "idx":
        i_k[r] = (i_p[r] + 1) % len(np.asarray(sp.radius))
        t_k[r] *= 1.5
    else:
        t_k[r] = np.inf
    st = compare_hits("sphere", sp, rays, t_k, i_k, t_p, i_p, T_MIN)
    assert st["unexplained"] == 1 and not passes(st), st


@pytest.mark.parametrize("rows", [1, 6, 64, 65, 500])
@pytest.mark.parametrize("width", [0, 3])
def test_take_rows_transpose_matches_indexing(rows, width):
    """The kernels' backward gathers rows with take_rows: its transpose
    (one-hot reduction for small tables, scatter-add above) equals the
    transpose of plain indexing."""
    from raytracer_weekend_tpu.ops.pallas.sphere_intersect import take_rows

    rng = np.random.default_rng(rows)
    shape = (rows, width) if width else (rows,)
    table = jnp.asarray(rng.normal(size=shape), jnp.float32)
    idx = jnp.asarray(rng.integers(0, rows, 1000), jnp.int32)
    ct = jnp.asarray(rng.normal(size=(1000,) + shape[1:]), jnp.float32)

    out, vjp = jax.vjp(lambda t: take_rows(t, idx), table)
    ref, vjp_ref = jax.vjp(lambda t: t[idx], table)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    np.testing.assert_allclose(np.asarray(vjp(ct)[0]),
                               np.asarray(vjp_ref(ct)[0]), rtol=1e-5,
                               atol=1e-5)
