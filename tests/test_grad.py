"""Differentiability: pixel gradients vs finite differences.

North-star requirement (BASELINE.md): gradients of rendered radiance w.r.t.
material albedo, metal fuzz, dielectric IOR, sphere geometry, triangle
vertices, and image texels must flow through the wavefront scan and match
finite differences.

Design note: with solid-color materials and a constant background, radiance
is *piecewise constant* in geometry — only discontinuity (visibility)
gradients exist and they are zero almost everywhere; autodiff correctly
returns 0 for such scenes. The scenes here therefore put spatially varying
radiance in the light path (UV-dependent textures / sky gradients) so the
continuous gradient that autodiff computes is nonzero and finite-difference
checkable. (The detach-discrete / differentiate-continuous split of
SURVEY.md §7.)
"""

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_weekend_tpu import integrator
from raytracer_weekend_tpu.camera import make_camera
from raytracer_weekend_tpu.config import RenderConfig
from raytracer_weekend_tpu.scene import builder as B



def _mean_radiance(scene, static, cfg, cam):
    ids = jnp.arange(cfg.n_rays, dtype=jnp.int32)
    colors = integrator.render_chunk(scene, static, cfg, cam, ids,
                                     jnp.uint32(cfg.seed))
    return jnp.mean(colors)


def _fd_check(scene, static, cfg, cam, replace, theta0, eps, rtol,
              require_nonzero=True):
    def loss(theta):
        return _mean_radiance(replace(scene, theta), static, cfg, cam)

    g = float(jax.grad(loss)(theta0))
    fd = (float(loss(theta0 + eps)) - float(loss(theta0 - eps))) / (2 * eps)
    assert np.isfinite(g), f"autodiff grad is {g}"
    assert np.isfinite(fd)
    if require_nonzero:
        assert g != 0.0, "gradient unexpectedly zero — degenerate test scene"
    assert abs(g - fd) <= rtol * max(abs(g), abs(fd), 1e-4), (g, fd)
    return g


# A UV-painted ground plane gives every bounce a continuously varying color.
def _uv_ground():
    return B.XZRectangle(-20.0, 20.0, -20.0, 20.0, 0.0,
                         B.Lambertian(B.UVDebug()))


def test_grad_albedo():
    objs = [
        _uv_ground(),
        B.Sphere((0, 1, 0), 1.0, B.Lambertian((0.1, 0.2, 0.5))),
    ]
    scene, static = B.build_scene(objs, background=(0.7, 0.8, 1.0))
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=8, max_depth=4,
                       seed=3)
    cam = make_camera((0, 2, 6), (0, 1, 0), (0, 1, 0), 40.0, 2.0, 0.0, 6.0,
                      0.0, 1.0)

    tex_row = 1  # sphere albedo texture (row 0 is the UVDebug)
    def replace(s, v):
        return s._replace(textures=s.textures._replace(
            color1=s.textures.color1.at[tex_row, 2].set(v)))

    g = _fd_check(scene, static, cfg, cam, replace,
                  scene.textures.color1[tex_row, 2], 1e-2, 0.05)
    assert g > 0


def test_grad_metal_fuzz():
    # Flip-free construction: camera looks straight down at a metal floor;
    # every reflection lands on an oversized emissive UV ceiling that ends
    # the path. Fuzz moves the ceiling hit point -> smooth dependence, and
    # no lane can flip a discrete decision (absorb / silhouette), so the
    # fixed-RNG finite difference is clean.
    objs = [
        B.XZRectangle(-50.0, 50.0, -50.0, 50.0, 0.0,
                      B.Metal((0.9, 0.9, 0.9), 0.3)),
        B.XZRectangle(-100.0, 100.0, -100.0, 100.0, 2.0,
                      B.DiffuseLight(B.UVDebug())),
    ]
    scene, static = B.build_scene(objs, background=(0.0, 0.0, 0.0))
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=8, max_depth=2,
                       seed=2)
    cam = make_camera((0, 1, 0.01), (0, 0, 0), (0, 0, -1), 60.0, 2.0, 0.0,
                      1.0, 0.0, 1.0)

    fuzz_row = int(np.argmax(np.asarray(scene.materials.fuzz) > 0))
    def replace(s, v):
        return s._replace(materials=s.materials._replace(
            fuzz=s.materials.fuzz.at[fuzz_row].set(v)))

    _fd_check(scene, static, cfg, cam, replace, jnp.float32(0.3), 1e-2, 0.1)


def test_grad_ior():
    # Glass sphere refracting an emissive UV backdrop: IOR bends rays ->
    # smooth dependence of the emitted color; paths terminate at the light.
    objs = [
        B.XYRectangle(-40.0, 40.0, -40.0, 40.0, -6.0,
                      B.DiffuseLight(B.UVDebug())),
        B.Sphere((0, 0, 0), 1.0, B.Dielectric(1.5)),
    ]
    scene, static = B.build_scene(objs, background=(0.05, 0.05, 0.05))
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=8, max_depth=4,
                       seed=12)
    cam = make_camera((0, 0, 3), (0, 0, 0), (0, 1, 0), 25.0, 2.0, 0.0, 3.0,
                      0.0, 1.0)

    ior_row = int(np.argmax(np.asarray(scene.materials.ior) > 1.0))
    def replace(s, v):
        return s._replace(materials=s.materials._replace(
            ior=s.materials.ior.at[ior_row].set(v)))

    _fd_check(scene, static, cfg, cam, replace, jnp.float32(1.5), 2e-3, 0.1)


def test_grad_sphere_center():
    # UV-textured sphere: moving the center shifts hit UVs continuously.
    objs = [B.Sphere((0, 0, -3), 1.0, B.Lambertian(B.UVDebug()))]
    scene, static = B.build_scene(objs, background=(0.3, 0.3, 0.3))
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=8, max_depth=2,
                       seed=3)
    cam = make_camera((0, 0, 1), (0, 0, -3), (0, 1, 0), 40.0, 2.0, 0.0, 4.0,
                      0.0, 1.0)

    def replace(s, v):
        return s._replace(spheres=s.spheres._replace(
            c0=s.spheres.c0.at[0, 1].set(v), c1=s.spheres.c1.at[0, 1].set(v)))

    _fd_check(scene, static, cfg, cam, replace, jnp.float32(0.0), 3e-3, 0.25)


def test_grad_triangle_vertex():
    # UVDebug triangle: vertex motion changes barycentric UVs continuously.
    objs = [B.Triangle(
        vertices=((-2, -1, -2), (2, -1, -2), (0, 2, -2)),
        material=B.Lambertian(B.UVDebug()),
        uvs=((0, 0), (1, 0), (0.5, 1)),
    )]
    scene, static = B.build_scene(objs, background=(0.4, 0.4, 0.4))
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=8, max_depth=2,
                       seed=3)
    cam = make_camera((0, 0, 2), (0, 0, -2), (0, 1, 0), 60.0, 2.0, 0.0, 2.0,
                      0.0, 1.0)

    def replace(s, v):
        return s._replace(triangles=s.triangles._replace(
            v2=s.triangles.v2.at[0, 0].set(v)))  # apex x: shears UVs

    _fd_check(scene, static, cfg, cam, replace, jnp.float32(0.0), 3e-3, 0.25)


def test_grad_image_texels_bilinear():
    img = np.linspace(0, 1, 4 * 4 * 3, dtype=np.float32).reshape(4, 4, 3)
    objs = [B.Sphere((0, 0, -2), 1.0, B.Lambertian(B.ImageTexture(data=img)))]
    scene, static = B.build_scene(objs, background=(0.2, 0.2, 0.2))
    cfg = RenderConfig(width=6, height=3, samples_per_pixel=4, max_depth=2,
                       seed=1)
    cam = make_camera((0, 0, 1), (0, 0, -2), (0, 1, 0), 45.0, 2.0, 0.0, 3.0,
                      0.0, 1.0)

    def loss(images):
        s = scene._replace(textures=scene.textures._replace(images=images))
        return _mean_radiance(s, static, cfg, cam)

    g = np.asarray(jax.grad(loss)(scene.textures.images))
    assert np.isfinite(g).all()
    assert (g != 0).any()


def test_grad_no_nan_full_material_mix():
    # Every material type in one scene: the backward pass stays NaN-free.
    objs = [
        _uv_ground(),
        B.Sphere((0, 1, 0), 1.0, B.Lambertian((0.4, 0.5, 0.6))),
        B.Sphere((2.2, 1, 0), 1.0, B.Metal((0.8, 0.7, 0.6), 0.4)),
        B.Sphere((-2.2, 1, 0), 1.0, B.Dielectric(1.5)),
        B.XYRectangle(-1.0, 1.0, 2.5, 3.5, -2.0, B.DiffuseLight((3, 3, 3))),
        B.ConstantMedium(B.Sphere((0, 1, 2), 0.7, B.Lambertian((1, 1, 1))),
                         0.5, B.SolidColor((0.6, 0.7, 0.8))),
    ]
    scene, static = B.build_scene(objs, background=(0.5, 0.6, 0.8))
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=4, max_depth=5,
                       seed=9)
    cam = make_camera((0, 2, 7), (0, 1, 0), (0, 1, 0), 40.0, 2.0, 0.1, 7.0,
                      0.0, 1.0)

    def loss(color1):
        s = scene._replace(textures=scene.textures._replace(color1=color1))
        return _mean_radiance(s, static, cfg, cam)

    g = np.asarray(jax.grad(loss)(scene.textures.color1))
    assert np.isfinite(g).all(), "NaN/inf in texture-color gradients"

    def loss_geom(c0):
        s = scene._replace(spheres=scene.spheres._replace(c0=c0, c1=c0))
        return _mean_radiance(s, static, cfg, cam)

    g2 = np.asarray(jax.grad(loss_geom)(scene.spheres.c0))
    assert np.isfinite(g2).all(), "NaN/inf in sphere-geometry gradients"
