"""Scene representation: SoA primitive tables (the TPU `World`).

The reference's world is `Vec<Box<dyn Hittable>>` — heterogeneous trait
objects behind pointers (hittable/mod.rs:51-118). That is the single biggest
anti-pattern for XLA, so the rebuild replaces it wholesale: a scene is a
pytree of flat arrays, one SoA table per primitive family, plus material and
texture tables. Instancing transforms (Translation/YRotation,
transformations.rs) are *baked into geometry at build time* — spheres and
triangles are closed under rigid transforms, and transformed rects/cuboids
are lowered to triangles — so the hot intersection kernels never see a
transform. Only constant-medium boundaries keep a (rarely used) per-volume
rotation, because an oriented box cannot be baked into an AABB.

Every array here is a differentiable leaf: gradients flow to sphere centers
and radii, triangle vertices, material fuzz/IOR, texture colors and texels.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

from jax import Array

from raytracer_weekend_tpu.materials import MaterialTable
from raytracer_weekend_tpu.textures import TextureTable

# Volume boundary types
VOL_SPHERE = 0
VOL_BOX = 1


class Spheres(NamedTuple):
    """Static + moving spheres in one table (spherical.rs:79-151).

    A static sphere stores c1 == c0 with (t0, t1) = (0, 1); `center_at_time`
    (spherical.rs:117-123) is then constant. Negative radii are legal and
    flip the outward normal — the reference's hollow-glass trick
    (scenes.rs:90-94 uses radius -0.95).
    """

    c0: Array      # (S,3) center at t0
    c1: Array      # (S,3) center at t1
    t0: Array      # (S,)
    t1: Array      # (S,)
    radius: Array  # (S,)
    mat: Array     # (S,) int32
    valid: Array   # (S,) bool — False for padding rows


class Rects(NamedTuple):
    """Axis-aligned rectangles in all three plane pairs (rectangular.rs).

    `axis` is the fixed-coordinate axis: 0 = YZ rect (k on x), 1 = XZ rect
    (k on y), 2 = XY rect (k on z). (a, b) are the two varying coordinates in
    the reference's UV order: YZ -> (y, z), XZ -> (x, z), XY -> (x, y).
    """

    axis: Array  # (R,) int32
    a0: Array    # (R,)
    a1: Array    # (R,)
    b0: Array    # (R,)
    b1: Array    # (R,)
    k: Array     # (R,)
    mat: Array   # (R,) int32
    valid: Array # (R,) bool


class Triangles(NamedTuple):
    """Triangles with per-vertex normals and UVs (triangular.rs:33-94).

    Missing OBJ normals default to the face normal (triangular.rs:48-55) and
    missing UVs to ((0,0),(1,0),(0,1)) (triangular.rs:57-65) — both resolved
    at build time so the kernel always interpolates barycentrically.
    """

    v0: Array   # (T,3)
    v1: Array   # (T,3)
    v2: Array   # (T,3)
    n0: Array   # (T,3)
    n1: Array   # (T,3)
    n2: Array   # (T,3)
    uv0: Array  # (T,2)
    uv1: Array  # (T,2)
    uv2: Array  # (T,2)
    mat: Array  # (T,) int32
    valid: Array  # (T,) bool


class Volumes(NamedTuple):
    """Constant-density participating media (volumes.rs:17-78).

    The boundary is either a sphere or an oriented box (covers every
    reference use: smoke cuboids in SmokeyCornellBox, sphere media in
    Book2Final). Boxes keep the reference's Y-rotation + translation
    (transformations.rs): rays are moved into object space per volume.
    """

    vtype: Array   # (V,) int32 — VOL_SPHERE / VOL_BOX
    center: Array  # (V,3) sphere center
    radius: Array  # (V,)  sphere radius
    bmin: Array    # (V,3) box min (object space)
    bmax: Array    # (V,3) box max (object space)
    cos_t: Array   # (V,)  Y-rotation cos
    sin_t: Array   # (V,)  Y-rotation sin
    offset: Array  # (V,3) translation
    neg_inv_density: Array  # (V,) = -1/density (volumes.rs:26)
    mat: Array     # (V,) int32 — isotropic phase material
    valid: Array   # (V,) bool


class SceneData(NamedTuple):
    """The complete differentiable scene pytree.

    sphere_bvh/triangle_bvh are flat skip-link BVHs (ops.bvh.Bvh) built by
    the native builder when the family is large enough (zero-size arrays
    otherwise); SceneStatic's flags gate which intersection path compiles.
    """

    spheres: Spheres
    rects: Rects
    triangles: Triangles
    volumes: Volumes
    materials: MaterialTable
    textures: TextureTable
    background: Array  # (3,) miss color (lib.rs:104)
    sphere_bvh: object = None    # ops.bvh.Bvh
    triangle_bvh: object = None  # ops.bvh.Bvh


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Static (hashable) facts about a scene, passed as a jit-static arg.

    Lets XLA drop whole code paths: a scene with no triangles compiles no
    triangle kernel, no noise textures compiles no Perlin gathers, etc.
    """

    n_spheres: int
    n_rects: int
    n_triangles: int
    n_volumes: int
    has_noise: bool
    has_image: bool
    # Set when a BVH is attached for the family.
    sphere_bvh: bool = False
    triangle_bvh: bool = False
