"""The 13-scene catalog (rebuild of console_app/src/scenes.rs).

Each generator returns (objects, cameras, background) exactly mirroring the
reference's `Scene::generate` signature (scenes.rs:41-61): same geometry,
same materials, same camera parameters. Stochastic scene content (random
small spheres, random cuboid heights, random 1000-sphere cluster) uses a
seeded numpy Generator instead of ThreadRng, so scenes are reproducible.

`generate_scene(name, aspect_ratio)` compiles the chosen scene to SoA tables
and returns (scene_data, scene_static, cameras, background_is_in_scene_data).
"""

from __future__ import annotations

import math
import os

import numpy as np

from raytracer_weekend_tpu.camera import Camera, make_camera
from raytracer_weekend_tpu.scene import builder as B
from raytracer_weekend_tpu.scene.objloader import load_wavefront_obj

DEFAULT_BACKGROUND = (0.7, 0.8, 1.0)   # scenes.rs:862
_DIM_SKY = (0.085, 0.1, 0.125)          # scenes.rs "new_const(0.085,0.1,0.125)"

# Model assets vendored in the checkout's models/ dir.
_MODEL_DIRS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "models"),
]


def model_path(name: str) -> str:
    for d in _MODEL_DIRS:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"model asset {name} not found in {_MODEL_DIRS}")


def _cam(look_from, look_at, vfov, aspect, aperture=0.0, focus=10.0,
         t0=0.0, t1=1.0, up=(0, 1, 0)) -> Camera:
    return make_camera(look_from, look_at, up, vfov, aspect, aperture, focus,
                       t0, t1)


_CHECKER_GROUND = None


def _checker():
    return B.Checker(B.SolidColor((0.2, 0.3, 0.1)),
                     B.SolidColor((0.9, 0.9, 0.9)), 10.0)


def jumpy_balls(aspect, seed=0):
    """Book-1 final scene variant with ~480 moving spheres (scenes.rs:63-162)."""
    rng = np.random.default_rng(seed)
    ground = B.Lambertian(_checker())
    glass = B.Dielectric(1.5)
    objs = [
        B.Sphere((0, -1000, 0), 1000.0, ground),
        B.Sphere((-4, 0.2, 0.1), 1.0, B.Lambertian((0.4, 0.2, 0.1))),
        B.Sphere((0, 1, 0), 1.0, glass),
        B.Sphere((0, 1, 0), -0.95, glass),       # hollow shell, scenes.rs:90-94
        B.Sphere((4, 1, 0), 1.0, B.Metal((0.7, 0.6, 0.5), 0.0)),
    ]
    for a in range(-11, 11):
        for b in range(-11, 11):
            center = np.array([a + 0.9 * rng.random(), 0.2,
                               b + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            choose = rng.random()
            if choose < 0.8:
                albedo = tuple(rng.random(3) * rng.random(3))
                mat = B.Lambertian(albedo)
            elif choose < 0.95:
                albedo = tuple(rng.uniform(0.5, 1.0, 3))
                mat = B.Metal(albedo, rng.uniform(0.0, 0.5))
            else:
                mat = B.Dielectric(1.5)
            center2 = center + np.array([0.0, rng.uniform(0.0, 0.5), 0.0])
            objs.append(B.MovingSphere(tuple(center), 0.0, tuple(center2), 1.0,
                                       0.2, mat))
    cam = _cam((13, 2, 3), (0, 0, 0), 20.0, aspect, aperture=0.1)
    return objs, [cam], DEFAULT_BACKGROUND


def two_spheres(aspect, seed=0):
    ground = B.Lambertian(_checker())
    objs = [
        B.Sphere((0, -10, 0), 10.0, ground),
        B.Sphere((0, 10, 0), 10.0, ground),
    ]
    return objs, [_cam((13, 2, 3), (0, 0, 0), 40.0, aspect)], DEFAULT_BACKGROUND


def two_perlin_spheres(aspect, seed=0):
    mat = B.Lambertian(B.NoiseTexture(4.0))
    objs = [
        B.Sphere((0, -1000, 0), 1000.0, mat),
        B.Sphere((0, 2, 0), 2.0, mat),
    ]
    return objs, [_cam((13, 2, 3), (0, 0, 0), 40.0, aspect)], DEFAULT_BACKGROUND


def earth(aspect, seed=0):
    tex = B.ImageTexture(model_path("earthmap.jpg"))
    objs = [B.Sphere((0, 0, 0), 2.0, B.Lambertian(tex))]
    return objs, [_cam((13, 2, 3), (0, 0, 0), 20.0, aspect)], DEFAULT_BACKGROUND


def simple_light(aspect, seed=0):
    emissive = B.DiffuseLight(B.ImageTexture(model_path("earthmap.jpg")))
    ground = B.Lambertian(B.NoiseTexture(4.0))
    objs = [
        B.Sphere((0, -1000, 0), 1000.0, ground),
        B.Sphere((0, 2, 0), 2.0, ground),
        B.XYRectangle(3.0, 5.0, 1.0, 3.0, -2.0, emissive),
        B.Sphere((0, 6, 0), 2.0, emissive),
    ]
    return objs, [_cam((26, 3, 6), (0, 2, 0), 20.0, aspect)], (0.0, 0.0, 0.0)


def _cornell_walls(light_rect):
    red = B.Lambertian((0.65, 0.05, 0.05))
    white = B.Lambertian((0.73, 0.73, 0.73))
    green = B.Lambertian((0.12, 0.45, 0.15))
    return white, [
        B.YZRectangle(0.0, 555.0, 0.0, 555.0, 555.0, green),
        B.YZRectangle(0.0, 555.0, 0.0, 555.0, 0.0, red),
        light_rect,
        B.XZRectangle(0.0, 555.0, 0.0, 555.0, 0.0, white),
        B.XZRectangle(0.0, 555.0, 0.0, 555.0, 555.0, white),
        B.XYRectangle(0.0, 555.0, 0.0, 555.0, 555.0, white),
    ]


def cornell_box(aspect, seed=0):
    """scenes.rs:350-414."""
    light = B.DiffuseLight((15.0, 15.0, 15.0))
    white, objs = _cornell_walls(
        B.XZRectangle(213.0, 343.0, 227.0, 332.0, 554.0, light))
    objs += [
        B.Cuboid((0, 0, 0), (165, 330, 165), white)
         .rotate_y(15.0).translate((265, 0, 295)),
        B.Cuboid((0, 0, 0), (165, 165, 165), white)
         .rotate_y(-18.0).translate((130, 0, 65)),
    ]
    cam = _cam((278, 278, -800), (278, 278, 0), 40.0, aspect)
    return objs, [cam], (0.0, 0.0, 0.0)


def smokey_cornell_box(aspect, seed=0):
    """scenes.rs:416-483: the cuboids become constant-density smoke."""
    light = B.DiffuseLight((7.0, 7.0, 7.0))
    white, objs = _cornell_walls(
        B.XZRectangle(113.0, 443.0, 127.0, 432.0, 554.0, light))
    box1 = (B.Cuboid((0, 0, 0), (165, 330, 165), white)
            .rotate_y(15.0).translate((265, 0, 295)))
    box2 = (B.Cuboid((0, 0, 0), (165, 165, 165), white)
            .rotate_y(-18.0).translate((130, 0, 65)))
    objs += [
        B.ConstantMedium(box1, 0.005, B.SolidColor((0.0, 0.0, 0.0))),
        B.ConstantMedium(box2, 0.005, B.SolidColor((1.0, 1.0, 1.0))),
    ]
    cam = _cam((278, 278, -800), (278, 278, 0), 40.0, aspect)
    return objs, [cam], (0.0, 0.0, 0.0)


def book2_final_scene(aspect, seed=0):
    """scenes.rs:485-620."""
    rng = np.random.default_rng(seed + 2)
    ground = B.Lambertian((0.48, 0.83, 0.53))
    objs = []
    # 20x20 ground cuboids with random heights (scenes.rs:489-509).
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            y1 = rng.uniform(1.0, 101.0)
            objs.append(B.Cuboid((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground))

    objs.append(B.XZRectangle(123.0, 423.0, 147.0, 412.0, 554.0,
                              B.DiffuseLight((7.0, 7.0, 7.0))))
    objs.append(B.MovingSphere((400, 400, 200), 0.0, (430, 400, 200), 1.0,
                               50.0, B.Lambertian((0.7, 0.3, 0.1))))
    objs.append(B.Sphere((260, 150, 45), 50.0, B.Dielectric(1.5)))
    objs.append(B.Sphere((0, 150, 145), 50.0, B.Metal((0.8, 0.8, 0.9), 1.0)))

    boundary = B.Sphere((360, 150, 145), 70.0, B.Dielectric(1.5))
    objs.append(boundary)
    objs.append(B.ConstantMedium(boundary, 0.2, B.SolidColor((0.2, 0.4, 0.9))))
    mist = B.Sphere((0, 0, 0), 5000.0, B.Dielectric(1.5))
    objs.append(B.ConstantMedium(mist, 0.0001, B.SolidColor((1.0, 1.0, 1.0))))

    objs.append(B.Sphere((400, 200, 400), 100.0,
                         B.Lambertian(B.ImageTexture(model_path("earthmap.jpg")))))
    objs.append(B.Sphere((220, 280, 300), 80.0,
                         B.Lambertian(B.NoiseTexture(0.1))))

    # 1000-sphere cluster, rotated + translated (scenes.rs:576-592).
    white = B.Lambertian((0.73, 0.73, 0.73))
    for _ in range(1000):
        c = rng.uniform(0.0, 165.0, 3)
        objs.append(B.Sphere(tuple(c), 10.0, white)
                    .rotate_y(15.0).translate((-100, 270, 395)))

    look_from = (478, 278, -600)
    look_at = (278, 278, 0)
    focus = float(np.linalg.norm(np.subtract(look_at, look_from)))
    cam = _cam(look_from, look_at, 40.0, aspect, focus=focus)
    return objs, [cam], (0.0, 0.0, 0.0)


def animated_book2_final(aspect, seed=0):
    """scenes.rs:622-667: 30 dolly cameras over the book2 world."""
    objs, _, bg = book2_final_scene(aspect, seed)
    look_at = np.array([278.0, 278.0, 278.0])
    frames = int(10.0 * 3.0)
    cams = []
    for frame in range(frames):
        from_x = 478.0 - frame * (2.0 * 478.0) / frames
        look_from = np.array([from_x, 278.0, -600.0])
        focus = float(np.linalg.norm(look_at - look_from))
        cams.append(_cam(tuple(look_from), tuple(look_at), 40.0, aspect,
                         aperture=1.0, focus=focus))
    return objs, cams, bg


def simple_triangle(aspect, seed=0):
    """scenes.rs:669-717."""
    objs = [
        B.Sphere((0, -10, 0), 10.0, B.Lambertian(_checker())),
        B.Triangle.flat_shaded(((-5, 0, 5), (0, 7, 0), (5, 0, -5)),
                               B.Lambertian(B.UVDebug())),
    ]
    return objs, [_cam((13, 2, 3), (0, 2.5, 0), 40.0, aspect)], DEFAULT_BACKGROUND


def wavefront_cow_obj(aspect, seed=0):
    """scenes.rs:719-771: cow-nonormals.obj + light + checker ground."""
    cow = load_wavefront_obj(model_path("cow-nonormals.obj"))
    cow = [t.translate((0.0, 2.5, 0.0)) for t in cow]
    objs = [
        B.Sphere((0, -10.6, 0), 10.0, B.Lambertian(_checker())),
        B.XYRectangle(1.0, 5.0, 1.0, 7.0, 5.0,
                      B.DiffuseLight((1.4, 1.3, 1.3))),
        cow,
    ]
    return objs, [_cam((13, 2, 3), (0, 2.5, 0), 40.0, aspect)], _DIM_SKY


def wavefront_suspension_obj(aspect, seed=0):
    """scenes.rs:773-814: Normals_Try3.obj (vertex normals) + area light."""
    susp = load_wavefront_obj(model_path("Normals_Try3.obj"))
    susp = [t.translate((0.0, 2.5, 0.0)) for t in susp]
    objs = [
        B.XYRectangle(-5.0, 5.0, -7.0, 7.0, 1.0,
                      B.DiffuseLight((1.2, 1.0, 1.0))),
        susp,
    ]
    cam = _cam((0.5, 2.5, 0.8), (-0.1, 2.3, 0.15), 40.0, aspect)
    return objs, [cam], _DIM_SKY


def textured_monument(aspect, seed=0):
    """scenes.rs:816-858: monument OBJ+MTL.

    NB: the monument's diffuse PNG is a stripped large blob in the reference
    checkout (.MISSING_LARGE_BLOBS) — the loader substitutes a neutral gray
    texture for unreadable images instead of panicking.
    """
    monument = load_wavefront_obj(
        model_path("monument_downscaled_polygon_reduced.obj"),
        missing_texture_fallback=(0.6, 0.6, 0.6))
    monument = [t.translate((0.0, 0.0, -19.0)) for t in monument]
    objs = [
        B.XYRectangle(-15.0, 15.0, -17.0, 17.0, 33.0,
                      B.DiffuseLight((1.2, 1.0, 1.0))),
        monument,
    ]
    cam = _cam((-5, -30, 25), (0, 0, 5), 40.0, aspect, up=(1, 0, 0))
    return objs, [cam], _DIM_SKY


SCENES = {
    "jumpy_balls": jumpy_balls,
    "two_spheres": two_spheres,
    "two_perlin_spheres": two_perlin_spheres,
    "earth": earth,
    "simple_light": simple_light,
    "cornell_box": cornell_box,
    "smokey_cornell_box": smokey_cornell_box,
    "book2_final_scene": book2_final_scene,
    "animated_book2_final_scene": animated_book2_final,
    "simple_triangle": simple_triangle,
    "wavefront_cow_obj": wavefront_cow_obj,
    "wavefront_suspension_obj": wavefront_suspension_obj,
    "textured_monument": textured_monument,
}


def generate_scene(name: str, aspect_ratio: float, seed: int = 0):
    """Build a named scene -> (scene_data, scene_static, cameras)."""
    if name not in SCENES:
        raise KeyError(f"unknown scene {name!r}; options: {sorted(SCENES)}")
    objs, cams, background = SCENES[name](aspect_ratio, seed)
    data, static = B.build_scene(objs, background=background, seed=seed)
    return data, static, cams
