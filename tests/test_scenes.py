"""Scene catalog: all 13 reference scenes compile to SoA tables.

Mirrors the component inventory of SURVEY.md §2.2 (scenes.rs:24-39).
"""

import numpy as np
import pytest

from raytracer_weekend_tpu.models.scenes import SCENES, generate_scene
from raytracer_weekend_tpu.scene import builder as B

ASPECT = 16.0 / 9.0

EXPECTATIONS = {
    # name: (min_spheres, min_rects, min_triangles, n_volumes, n_cameras)
    "jumpy_balls": (400, 0, 0, 0, 1),
    "two_spheres": (2, 0, 0, 0, 1),
    "two_perlin_spheres": (2, 0, 0, 0, 1),
    "earth": (1, 0, 0, 0, 1),
    "simple_light": (3, 1, 0, 0, 1),
    "cornell_box": (0, 6, 24, 0, 1),          # 2 rotated cuboids -> 24 tris
    "smokey_cornell_box": (0, 6, 0, 2, 1),
    "book2_final_scene": (1000, 2400, 0, 2, 1),
    "simple_triangle": (1, 0, 1, 0, 1),
    "wavefront_cow_obj": (1, 1, 5804, 0, 1),
}


@pytest.mark.parametrize("name", sorted(EXPECTATIONS))
def test_scene_builds(name):
    min_s, min_r, min_t, n_v, n_cams = EXPECTATIONS[name]
    data, static, cams = generate_scene(name, ASPECT)
    assert static.n_spheres >= min_s
    assert static.n_rects >= min_r
    assert static.n_triangles >= min_t
    assert static.n_volumes == n_v
    assert len(cams) == n_cams
    # Tables are finite.
    assert np.isfinite(np.asarray(data.spheres.c0)).all()
    assert np.isfinite(np.asarray(data.triangles.v0)).all()


def test_animated_scene_has_30_cameras():
    _, _, cams = generate_scene("animated_book2_final_scene", ASPECT)
    assert len(cams) == 30  # scenes.rs:648-650: 3 s x 10 fps


def test_obj_scenes_build():
    for name, tris in [("wavefront_suspension_obj", 8661),
                       ("textured_monument", 7798)]:
        data, static, cams = generate_scene(name, ASPECT)
        assert static.n_triangles >= tris


def test_jumpy_balls_reproducible():
    a, sa, _ = generate_scene("jumpy_balls", ASPECT, seed=3)
    b, sb, _ = generate_scene("jumpy_balls", ASPECT, seed=3)
    assert sa.n_spheres == sb.n_spheres
    np.testing.assert_array_equal(np.asarray(a.spheres.c0),
                                  np.asarray(b.spheres.c0))


def test_transform_baking_translation_keeps_rect():
    r = B.XYRectangle(0, 1, 0, 1, 0, B.Lambertian((1, 1, 1))).translate(
        (2.0, 3.0, 4.0))
    scene, static = B.build_scene([r])
    assert static.n_rects == 1 and static.n_triangles == 0
    np.testing.assert_allclose(np.asarray(scene.rects.k), [4.0])
    np.testing.assert_allclose(np.asarray(scene.rects.a0), [2.0])
    np.testing.assert_allclose(np.asarray(scene.rects.b0), [3.0])


def test_transform_baking_rotation_lowers_to_triangles():
    r = B.XYRectangle(0, 1, 0, 1, 0, B.Lambertian((1, 1, 1))).rotate_y(30.0)
    scene, static = B.build_scene([r])
    assert static.n_rects == 0 and static.n_triangles == 2


def test_rotate_after_translate_composes():
    # rotate_y(90) of a sphere at x=1 lands it at z=-1 (out-rotation,
    # transformations.rs:131-141: z' = -sin*x + cos*z).
    s = B.Sphere((0, 0, 0), 1.0, B.Lambertian((1, 1, 1)))
    moved = s.translate((1.0, 0.0, 0.0)).rotate_y(90.0)
    scene, _ = B.build_scene([moved])
    np.testing.assert_allclose(np.asarray(scene.spheres.c0)[0],
                               [0.0, 0.0, -1.0], atol=1e-6)


def test_model_assets_vendored(monkeypatch):
    """Mesh/texture scenes must build from the checkout's models/ alone
    (triangular.rs:240-260 consumes the same OBJ/MTL/JPG fixture set)."""
    import os
    import raytracer_weekend_tpu.models.scenes as S
    repo_models = os.path.join(os.path.dirname(S.__file__), "..", "..",
                               "models")
    monkeypatch.setattr(S, "_MODEL_DIRS", [repo_models])
    for asset in ("cow-nonormals.obj", "Normals_Try3.obj", "earthmap.jpg",
                  "monument_downscaled_polygon_reduced.obj",
                  "monument_downscaled_polygon_reduced.mtl"):
        assert os.path.exists(S.model_path(asset))
    # earth is the cheapest asset-dependent scene: build it end to end.
    data, static, cams = generate_scene("earth", ASPECT)
    assert static.n_spheres >= 1
