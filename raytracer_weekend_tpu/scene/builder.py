"""Scene-construction DSL that compiles to SoA tables.

This is the rebuild of the reference's scene layer: the constructor surface of
scenes.rs (Sphere/MovingSphere/Rect/Cuboid/Triangle/ConstantMedium, materials,
textures, `.rotate_y().translate()` fluent transforms — transformations.rs:155-172)
— but instead of allocating trait objects, `build_scene` *compiles* the object
list into the flat differentiable arrays of scene.data.SceneData.

Bake rules (a design decision: hot kernels never see transforms):
  * spheres are closed under rigid transforms: centers are transformed.
  * triangles: vertices/normals transformed.
  * rects/cuboids with a pure translation stay rects (bounds shifted);
    any rotation lowers them to 2 triangles per rect with exact UVs and
    constant vertex normals, reproducing the reference's rect shading.
  * constant media keep sphere boundaries baked, box boundaries keep the
    (rare) Y-rotation + translation per volume.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import jax.numpy as jnp

from raytracer_weekend_tpu import materials as mat_mod
from raytracer_weekend_tpu import perlin as perlin_mod
from raytracer_weekend_tpu import textures as tex_mod
from raytracer_weekend_tpu.materials import MaterialTable
from raytracer_weekend_tpu.scene.data import (
    VOL_BOX, VOL_SPHERE, Rects, SceneData, SceneStatic, Spheres, Triangles,
    Volumes,
)
from raytracer_weekend_tpu.textures import TextureTable

Vec = tuple[float, float, float]


# ---------------------------------------------------------------------------
# Textures (texture.rs / image_texture.rs constructor surface)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SolidColor:
    color: tuple

    @classmethod
    def rgb(cls, r, g, b):
        return cls((r, g, b))


@dataclasses.dataclass(frozen=True)
class Checker:
    """3D sine-product checker (texture.rs:62-81). Children must be solid
    colors — every reference scene uses solid-color checkers."""
    even: SolidColor
    odd: SolidColor
    frequency: float


@dataclasses.dataclass(frozen=True)
class NoiseTexture:
    """Perlin marble (texture.rs:83-95)."""
    scale: float


class ImageTexture:
    """Bitmap texture (image_texture.rs:22-31). `data` is HxWx3 float in [0,1]."""

    def __init__(self, path: Optional[str] = None, data: Optional[np.ndarray] = None):
        if data is None:
            if path is None:
                raise ValueError("ImageTexture needs a path or an array")
            from PIL import Image

            with Image.open(path) as im:
                data = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
        self.data = np.asarray(data, dtype=np.float32)
        if self.data.ndim != 3 or self.data.shape[-1] != 3:
            raise ValueError(f"image must be (H,W,3), got {self.data.shape}")
        self.path = path


@dataclasses.dataclass(frozen=True)
class UVDebug:
    """(u, v, 0) debug texture (texture.rs:97-104)."""


TextureLike = object  # SolidColor | Checker | NoiseTexture | ImageTexture | UVDebug


def _as_texture(value) -> TextureLike:
    """Accept bare color tuples anywhere a texture is expected."""
    if isinstance(value, (tuple, list)) and len(value) == 3:
        return SolidColor(tuple(float(x) for x in value))
    return value


# ---------------------------------------------------------------------------
# Materials (material.rs / light_source.rs constructor surface)
# ---------------------------------------------------------------------------

class _Material:
    pass


class Lambertian(_Material):
    def __init__(self, albedo):
        self.albedo = _as_texture(albedo)


class Metal(_Material):
    def __init__(self, albedo: Vec, fuzz: float):
        assert fuzz <= 1.0, "fuzz must be <= 1 (material.rs:70-74)"
        self.albedo = _as_texture(albedo)
        self.fuzz = float(fuzz)


class Dielectric(_Material):
    def __init__(self, index_of_refraction: float):
        self.ior = float(index_of_refraction)


class DiffuseLight(_Material):
    def __init__(self, emit):
        self.emit = _as_texture(emit)


class Isotropic(_Material):
    def __init__(self, albedo):
        self.albedo = _as_texture(albedo)


# ---------------------------------------------------------------------------
# Rigid Y-rotation + translation transform (transformations.rs)
# ---------------------------------------------------------------------------

def _rot_y(theta_deg: float, v: np.ndarray) -> np.ndarray:
    """World = R(theta) * object (transformations.rs:131-141 out-rotation)."""
    t = math.radians(theta_deg)
    c, s = math.cos(t), math.sin(t)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([c * x + s * z, y, -s * x + c * z], axis=-1)


class _Transformable:
    """Fluent `.rotate_y(deg).translate(offset)` (transformations.rs:155-172).

    Each geometry object carries one composed rigid transform
    world = R(theta) x + offset.
    """

    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)

    def _with_transform(self, theta, offset):
        clone = dataclasses.replace(self) if dataclasses.is_dataclass(self) else self.__class__.__new__(self.__class__)
        if not dataclasses.is_dataclass(self):
            clone.__dict__.update(self.__dict__)
        object.__setattr__(clone, "theta", theta)
        object.__setattr__(clone, "offset", tuple(offset))
        return clone

    def rotate_y(self, angle_degrees: float):
        new_theta = self.theta + angle_degrees
        new_offset = _rot_y(angle_degrees, np.asarray(self.offset, np.float64))
        return self._with_transform(new_theta, tuple(new_offset))

    def translate(self, offset):
        off = np.asarray(self.offset, np.float64) + np.asarray(offset, np.float64)
        return self._with_transform(self.theta, tuple(off))

    def _apply(self, pts: np.ndarray) -> np.ndarray:
        return _rot_y(self.theta, pts) + np.asarray(self.offset, np.float64)

    def _apply_vec(self, vecs: np.ndarray) -> np.ndarray:
        return _rot_y(self.theta, vecs)


# ---------------------------------------------------------------------------
# Geometry (hittable/* constructor surface)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sphere(_Transformable):
    center: tuple
    radius: float
    material: _Material
    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class MovingSphere(_Transformable):
    """spherical.rs:106-151 — linear center motion over [time0, time1]."""
    center0: tuple
    time0: float
    center1: tuple
    time1: float
    radius: float
    material: _Material
    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class _Rect(_Transformable):
    """axis = fixed coordinate (0=YZ, 1=XZ, 2=XY); (a,b) in reference UV order."""
    axis: int
    a0: float
    a1: float
    b0: float
    b1: float
    k: float
    material: _Material
    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)


def XYRectangle(x0, x1, y0, y1, k, material) -> _Rect:
    return _Rect(2, x0, x1, y0, y1, k, material)


def XZRectangle(x0, x1, z0, z1, k, material) -> _Rect:
    return _Rect(1, x0, x1, z0, z1, k, material)


def YZRectangle(y0, y1, z0, z1, k, material) -> _Rect:
    return _Rect(0, y0, y1, z0, z1, k, material)


@dataclasses.dataclass(frozen=True)
class Cuboid(_Transformable):
    """Axis-aligned box = 6 rects (rectangular.rs:169-245)."""
    p0: tuple
    p1: tuple
    material: _Material
    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)

    def sides(self) -> list[_Rect]:
        x0, y0, z0 = self.p0
        x1, y1, z1 = self.p1
        m = self.material
        rects = [
            XYRectangle(x0, x1, y0, y1, z1, m),
            XYRectangle(x0, x1, y0, y1, z0, m),
            XZRectangle(x0, x1, z0, z1, y1, m),
            XZRectangle(x0, x1, z0, z1, y0, m),
            YZRectangle(y0, y1, z0, z1, x1, m),
            YZRectangle(y0, y1, z0, z1, x0, m),
        ]
        return [r._with_transform(self.theta, self.offset) for r in rects]


@dataclasses.dataclass(frozen=True)
class Triangle(_Transformable):
    """triangular.rs:33-94. normals/uvs entries may be None -> reference
    fallbacks (face normal triangular.rs:48-55; default UVs :57-65)."""
    vertices: tuple  # 3 x (3,)
    material: _Material
    normals: tuple = (None, None, None)
    uvs: tuple = (None, None, None)
    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)

    @classmethod
    def flat_shaded(cls, vertices, material):
        return cls(tuple(tuple(v) for v in vertices), material)


@dataclasses.dataclass(frozen=True)
class ConstantMedium(_Transformable):
    """volumes.rs:17-35. `boundary` must be a Sphere or Cuboid (possibly
    transformed) — the only shapes any reference scene wraps."""
    boundary: object
    density: float
    texture: object
    theta: float = 0.0
    offset: tuple = (0.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

_DEFAULT_UVS = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0))  # triangular.rs:57-65

_RECT_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}  # fixed axis -> (a_axis, b_axis)

# Table sizes from which build_scene(bvh="auto") attaches a BVH; below them
# the family runs brute force. Spheres: jumpy_balls' 486 spheres stay brute
# force, book2's 1,006 get a tree, which the CPU uses (its plain brute force
# writes (rays x spheres) planes) and the GPU skips for its sphere kernel up
# to integrator.GPU_SPHERE_KERNEL_MAX. Triangles: meshes above 64 triangles
# (cow: 5,804) take the tree on every platform, while Cornell-class scenes
# (24 triangles from rotated cuboids) cost little in brute force.
AUTO_BVH_MIN_SPHERES = 513
AUTO_BVH_MIN_TRIANGLES = 65


class SceneBuilder:
    """Collects DSL objects and compiles them into SceneData tables."""

    def __init__(self, background=(0.7, 0.8, 1.0), seed: int = 0):
        self.objects: list = []
        self.background = tuple(background)
        self.seed = seed

    def add(self, *objs):
        self.objects.extend(objs)
        return self

    def build(self) -> tuple[SceneData, SceneStatic]:
        return build_scene(self.objects, background=self.background,
                           seed=self.seed)


def build_scene(objects: Sequence, background=(0.7, 0.8, 1.0),
                seed: int = 0,
                bvh: str | bool = "auto") -> tuple[SceneData, SceneStatic]:
    """Compile DSL objects -> (SceneData pytree, SceneStatic jit-static facts).

    bvh: "auto" builds an acceleration structure for families of at least
    AUTO_BVH_MIN_SPHERES spheres or AUTO_BVH_MIN_TRIANGLES triangles; True
    forces, False disables.
    """
    comp = _Compiler(seed)
    for obj in objects:
        comp.add(obj)
    return comp.finish(background, bvh)


class _Compiler:
    def __init__(self, seed: int):
        self.seed = seed
        # material/texture interning by object identity
        self.mat_ids: dict[int, int] = {}
        self.mats: list[_Material] = []
        self.tex_ids: dict[int, int] = {}
        self.texs: list = []
        # SoA rows
        self.sph: list = []
        self.rect: list = []
        self.tri: list = []
        self.vol: list = []

    # -- interning ---------------------------------------------------------

    def _texture_id(self, tex) -> int:
        tex = _as_texture(tex)
        key = id(tex)
        if key in self.tex_ids:
            return self.tex_ids[key]
        tid = len(self.texs)
        self.texs.append(tex)
        self.tex_ids[key] = tid
        return tid

    def _material_id(self, mat: _Material) -> int:
        key = id(mat)
        if key in self.mat_ids:
            return self.mat_ids[key]
        mid = len(self.mats)
        self.mats.append(mat)
        self.mat_ids[key] = mid
        return mid

    # -- geometry lowering -------------------------------------------------

    def add(self, obj):
        if isinstance(obj, Sphere):
            c = obj._apply(np.asarray(obj.center, np.float64))
            self.sph.append((c, c, 0.0, 1.0, obj.radius,
                             self._material_id(obj.material)))
        elif isinstance(obj, MovingSphere):
            c0 = obj._apply(np.asarray(obj.center0, np.float64))
            c1 = obj._apply(np.asarray(obj.center1, np.float64))
            self.sph.append((c0, c1, obj.time0, obj.time1, obj.radius,
                             self._material_id(obj.material)))
        elif isinstance(obj, _Rect):
            self._add_rect(obj)
        elif isinstance(obj, Cuboid):
            for side in obj.sides():
                self._add_rect(side)
        elif isinstance(obj, Triangle):
            self._add_triangle(obj)
        elif isinstance(obj, ConstantMedium):
            self._add_medium(obj)
        elif isinstance(obj, (list, tuple)):
            for sub in obj:
                self.add(sub)
        else:
            raise TypeError(f"unknown scene object {type(obj)}")

    def _add_rect(self, r: _Rect):
        mid = self._material_id(r.material)
        if r.theta == 0.0:
            # Pure translation keeps the rect axis-aligned: shift bounds.
            off = np.asarray(r.offset, np.float64)
            a_ax, b_ax = _RECT_AXES[r.axis]
            self.rect.append((r.axis, r.a0 + off[a_ax], r.a1 + off[a_ax],
                              r.b0 + off[b_ax], r.b1 + off[b_ax],
                              r.k + off[r.axis], mid))
            return
        # Rotated rect -> 2 triangles with exact UVs + constant normal.
        a_ax, b_ax = _RECT_AXES[r.axis]
        corners_ab = [(r.a0, r.b0), (r.a1, r.b0), (r.a1, r.b1), (r.a0, r.b1)]
        uvs = [(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)]
        pts = []
        for a, b in corners_ab:
            p = np.zeros(3)
            p[a_ax] = a
            p[b_ax] = b
            p[r.axis] = r.k
            pts.append(p)
        pts = r._apply(np.stack(pts))
        normal = np.zeros(3)
        normal[r.axis] = 1.0
        normal = r._apply_vec(normal)
        n3 = (tuple(normal),) * 3
        for ids in ((0, 1, 2), (0, 2, 3)):
            self.tri.append((
                tuple(tuple(pts[i]) for i in ids),
                n3,
                tuple(uvs[i] for i in ids),
                mid,
            ))

    def _add_triangle(self, t: Triangle):
        verts = np.asarray([np.asarray(v, np.float64) for v in t.vertices])
        verts = t._apply(verts)
        face_n = np.cross(verts[1] - verts[0], verts[2] - verts[0])
        normals = []
        for n in t.normals:
            if n is None:
                normals.append(face_n)           # triangular.rs:48-55
            else:
                normals.append(t._apply_vec(np.asarray(n, np.float64)))
        uvs = tuple(
            tuple(uv) if uv is not None else _DEFAULT_UVS[i]   # :57-65
            for i, uv in enumerate(t.uvs)
        )
        self.tri.append((
            tuple(tuple(v) for v in verts),
            tuple(tuple(n) for n in normals),
            uvs,
            self._material_id(t.material),
        ))

    def _add_medium(self, m: ConstantMedium):
        phase = Isotropic(m.texture)
        mid = self._material_id(phase)
        neg_inv_density = -1.0 / m.density    # volumes.rs:26

        b = m.boundary
        # Compose the medium's own transform outside the boundary's:
        # world = Rm(Rb x + tb) + tm.
        if isinstance(b, Sphere):
            theta = m.theta + b.theta
            center = m._apply(b._apply(np.asarray(b.center, np.float64)))
            self.vol.append((VOL_SPHERE, tuple(center), b.radius,
                             (0, 0, 0), (1, 1, 1), 0.0, (0, 0, 0),
                             neg_inv_density, mid))
            del theta
        elif isinstance(b, Cuboid):
            theta = m.theta + b.theta
            offset = m._apply(np.asarray(b.offset, np.float64))
            self.vol.append((VOL_BOX, (0, 0, 0), 1.0,
                             tuple(b.p0), tuple(b.p1), theta, tuple(offset),
                             neg_inv_density, mid))
        else:
            raise TypeError(
                f"ConstantMedium boundary must be Sphere or Cuboid, got {type(b)}")

    # -- table emission ----------------------------------------------------

    @staticmethod
    def _morton_argsort(cent: np.ndarray) -> np.ndarray:
        """Z-order permutation of (N, 3) centroids (10 bits/axis).

        Spatially coherent table order keeps neighbouring rows close in
        space, which the BVH build's splits benefit from. Pure reordering — winner indices
        stay internally consistent, images unchanged (ties measure-zero).
        """
        c = np.asarray(cent, np.float64)
        lo = c.min(axis=0)
        span = c.max(axis=0) - lo
        q = ((c - lo) / np.where(span == 0, 1.0, span) * 1023.0).astype(
            np.uint64)

        def spread(x):
            x = (x | (x << 16)) & 0x030000FF
            x = (x | (x << 8)) & 0x0300F00F
            x = (x | (x << 4)) & 0x030C30C3
            x = (x | (x << 2)) & 0x09249249
            return x

        code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(
            q[:, 2])
        return np.argsort(code, kind="stable")

    def _sort_spatially(self):
        """Morton-order spheres, rects, and triangles (volumes keep their
        order: the RNG stream salts by volume index)."""
        if len(self.sph) > 1:
            cent = np.asarray([(np.asarray(c0) + np.asarray(c1)) / 2
                               for c0, c1, *_ in self.sph])
            self.sph = [self.sph[i] for i in self._morton_argsort(cent)]
        if len(self.rect) > 1:
            cent = []
            for axis, a0, a1, b0, b1, k, _ in self.rect:
                a_ax, b_ax = _RECT_AXES[axis]
                p = np.zeros(3)
                p[a_ax] = (a0 + a1) / 2
                p[b_ax] = (b0 + b1) / 2
                p[axis] = k
                cent.append(p)
            self.rect = [self.rect[i]
                         for i in self._morton_argsort(np.asarray(cent))]
        if len(self.tri) > 1:
            cent = np.asarray([np.mean(np.asarray(v), axis=0)
                               for v, _, _, _ in self.tri])
            self.tri = [self.tri[i] for i in self._morton_argsort(cent)]

    def finish(self, background,
               bvh: str | bool = "auto") -> tuple[SceneData, SceneStatic]:
        self._sort_spatially()
        n_spheres = len(self.sph)
        n_rects = len(self.rect)
        n_tris = len(self.tri)
        n_vols = len(self.vol)

        spheres = self._emit_spheres()
        rects = self._emit_rects()
        tris = self._emit_triangles()
        vols = self._emit_volumes()
        materials, textures, has_noise, has_image = self._emit_shading()

        want_sphere_bvh = (bvh is True) or (
            bvh == "auto" and n_spheres >= AUTO_BVH_MIN_SPHERES)
        want_tri_bvh = (bvh is True) or (
            bvh == "auto" and n_tris >= AUTO_BVH_MIN_TRIANGLES)
        sphere_bvh = self._build_sphere_bvh(spheres) if (
            want_sphere_bvh and n_spheres) else None
        triangle_bvh = self._build_triangle_bvh(tris) if (
            want_tri_bvh and n_tris) else None

        data = SceneData(
            spheres=spheres, rects=rects, triangles=tris, volumes=vols,
            materials=materials, textures=textures,
            background=jnp.asarray(background, jnp.float32),
            sphere_bvh=sphere_bvh, triangle_bvh=triangle_bvh,
        )
        static = SceneStatic(
            n_spheres=n_spheres, n_rects=n_rects, n_triangles=n_tris,
            n_volumes=n_vols, has_noise=has_noise, has_image=has_image,
            sphere_bvh=sphere_bvh is not None,
            triangle_bvh=triangle_bvh is not None,
        )
        return data, static

    @staticmethod
    def _build_sphere_bvh(spheres):
        """AABBs over the full shutter motion (spherical.rs:96-103, 137-150);
        |radius| guards hollow-glass negative radii which would invert the
        reference's box."""
        from raytracer_weekend_tpu.native import build_bvh
        from raytracer_weekend_tpu.ops.bvh import Bvh

        c0 = np.asarray(spheres.c0)
        c1 = np.asarray(spheres.c1)
        r = np.abs(np.asarray(spheres.radius))[:, None]
        lo = np.minimum(c0 - r, c1 - r)
        hi = np.maximum(c0 + r, c1 + r)
        return Bvh(*map(jnp.asarray, build_bvh(lo, hi)))

    @staticmethod
    def _build_triangle_bvh(tris):
        """Triangle AABBs with the reference's thin-extent padding
        (triangular.rs:79-93: +-1e-4 when an axis extent is < 2e-4)."""
        from raytracer_weekend_tpu.native import build_bvh
        from raytracer_weekend_tpu.ops.bvh import Bvh

        v = np.stack([np.asarray(tris.v0), np.asarray(tris.v1),
                      np.asarray(tris.v2)], axis=1)  # (T,3,3)
        lo = v.min(axis=1)
        hi = v.max(axis=1)
        thin = (hi - lo) < 2e-4
        lo = np.where(thin, lo - 1e-4, lo)
        hi = np.where(thin, hi + 1e-4, hi)
        return Bvh(*map(jnp.asarray, build_bvh(lo, hi)))

    def _emit_spheres(self) -> Spheres:
        rows = self.sph or [((0, 1e9, 0), (0, 1e9, 0), 0.0, 1.0, 1.0, 0)]
        pad = not self.sph
        c0 = np.asarray([r[0] for r in rows], np.float32)
        c1 = np.asarray([r[1] for r in rows], np.float32)
        t0 = np.asarray([r[2] for r in rows], np.float32)
        t1 = np.asarray([r[3] for r in rows], np.float32)
        rad = np.asarray([r[4] for r in rows], np.float32)
        mat = np.asarray([r[5] for r in rows], np.int32)
        valid = np.ones(len(rows), bool) if not pad else np.zeros(1, bool)
        return Spheres(*map(jnp.asarray, (c0, c1, t0, t1, rad, mat, valid)))

    def _emit_rects(self) -> Rects:
        rows = self.rect or [(2, 0.0, 1.0, 0.0, 1.0, 0.0, 0)]
        pad = not self.rect
        cols = list(zip(*rows))
        axis = np.asarray(cols[0], np.int32)
        a0, a1, b0, b1, k = (np.asarray(c, np.float32) for c in cols[1:6])
        mat = np.asarray(cols[6], np.int32)
        valid = np.ones(len(rows), bool) if not pad else np.zeros(1, bool)
        return Rects(*map(jnp.asarray, (axis, a0, a1, b0, b1, k, mat, valid)))

    def _emit_triangles(self) -> Triangles:
        rows = self.tri or [
            (((0, 0, 0), (1, 0, 0), (0, 1, 0)),
             ((0, 0, 1),) * 3, _DEFAULT_UVS, 0)
        ]
        pad = not self.tri
        verts = np.asarray([r[0] for r in rows], np.float32)   # (T,3,3)
        norms = np.asarray([r[1] for r in rows], np.float32)
        uvs = np.asarray([r[2] for r in rows], np.float32)      # (T,3,2)
        mat = np.asarray([r[3] for r in rows], np.int32)
        valid = np.ones(len(rows), bool) if not pad else np.zeros(1, bool)
        return Triangles(
            v0=jnp.asarray(verts[:, 0]), v1=jnp.asarray(verts[:, 1]),
            v2=jnp.asarray(verts[:, 2]),
            n0=jnp.asarray(norms[:, 0]), n1=jnp.asarray(norms[:, 1]),
            n2=jnp.asarray(norms[:, 2]),
            uv0=jnp.asarray(uvs[:, 0]), uv1=jnp.asarray(uvs[:, 1]),
            uv2=jnp.asarray(uvs[:, 2]),
            mat=jnp.asarray(mat), valid=jnp.asarray(valid),
        )

    def _emit_volumes(self) -> Volumes:
        rows = self.vol or [
            (VOL_SPHERE, (0, 1e9, 0), 1.0, (0, 0, 0), (1, 1, 1), 0.0,
             (0, 0, 0), -1.0, 0)
        ]
        pad = not self.vol
        cols = list(zip(*rows))
        vtype = np.asarray(cols[0], np.int32)
        center = np.asarray(cols[1], np.float32)
        radius = np.asarray(cols[2], np.float32)
        bmin = np.asarray(cols[3], np.float32)
        bmax = np.asarray(cols[4], np.float32)
        theta = np.asarray(cols[5], np.float64)
        offset = np.asarray(cols[6], np.float32)
        nid = np.asarray(cols[7], np.float32)
        mat = np.asarray(cols[8], np.int32)
        valid = np.ones(len(rows), bool) if not pad else np.zeros(1, bool)
        return Volumes(
            vtype=jnp.asarray(vtype), center=jnp.asarray(center),
            radius=jnp.asarray(radius), bmin=jnp.asarray(bmin),
            bmax=jnp.asarray(bmax),
            cos_t=jnp.asarray(np.cos(np.radians(theta)), jnp.float32),
            sin_t=jnp.asarray(np.sin(np.radians(theta)), jnp.float32),
            offset=jnp.asarray(offset),
            neg_inv_density=jnp.asarray(nid), mat=jnp.asarray(mat),
            valid=jnp.asarray(valid),
        )

    def _emit_shading(self):
        if not self.mats:
            self.mats.append(Lambertian((0.5, 0.5, 0.5)))

        mtypes, texids, fuzz, ior = [], [], [], []
        for m in self.mats:
            if isinstance(m, Lambertian):
                mtypes.append(mat_mod.LAMBERTIAN)
                texids.append(self._texture_id(m.albedo))
                fuzz.append(0.0)
                ior.append(1.0)
            elif isinstance(m, Metal):
                mtypes.append(mat_mod.METAL)
                texids.append(self._texture_id(m.albedo))
                fuzz.append(m.fuzz)
                ior.append(1.0)
            elif isinstance(m, Dielectric):
                mtypes.append(mat_mod.DIELECTRIC)
                texids.append(self._texture_id(SolidColor((1.0, 1.0, 1.0))))
                fuzz.append(0.0)
                ior.append(m.ior)
            elif isinstance(m, DiffuseLight):
                mtypes.append(mat_mod.DIFFUSE_LIGHT)
                texids.append(self._texture_id(m.emit))
                fuzz.append(0.0)
                ior.append(1.0)
            elif isinstance(m, Isotropic):
                mtypes.append(mat_mod.ISOTROPIC)
                texids.append(self._texture_id(m.albedo))
                fuzz.append(0.0)
                ior.append(1.0)
            else:
                raise TypeError(f"unknown material {type(m)}")

        materials = MaterialTable(
            mtype=jnp.asarray(mtypes, jnp.int32),
            tex=jnp.asarray(texids, jnp.int32),
            fuzz=jnp.asarray(fuzz, jnp.float32),
            ior=jnp.asarray(ior, jnp.float32),
        )

        # Texture table. Checker children are folded into color1/color2.
        K = len(self.texs)
        ttype = np.zeros(K, np.int32)
        color1 = np.zeros((K, 3), np.float32)
        color2 = np.zeros((K, 3), np.float32)
        scale = np.zeros(K, np.float32)
        image_id = np.zeros(K, np.int32)
        images: list[np.ndarray] = []
        has_noise = False

        for i, t in enumerate(self.texs):
            if isinstance(t, SolidColor):
                ttype[i] = tex_mod.SOLID
                color1[i] = t.color
            elif isinstance(t, Checker):
                even = _as_texture(t.even)
                odd = _as_texture(t.odd)
                if not (isinstance(even, SolidColor) and isinstance(odd, SolidColor)):
                    raise TypeError("Checker children must be solid colors")
                ttype[i] = tex_mod.CHECKER
                color1[i] = even.color
                color2[i] = odd.color
                scale[i] = t.frequency
            elif isinstance(t, NoiseTexture):
                ttype[i] = tex_mod.NOISE
                scale[i] = t.scale
                has_noise = True
            elif isinstance(t, ImageTexture):
                ttype[i] = tex_mod.IMAGE
                image_id[i] = len(images)
                images.append(t.data)
            elif isinstance(t, UVDebug):
                ttype[i] = tex_mod.UVDEBUG
            else:
                raise TypeError(f"unknown texture {type(t)}")

        has_image = bool(images)
        if images:
            max_h = max(im.shape[0] for im in images)
            max_w = max(im.shape[1] for im in images)
            atlas = np.zeros((len(images), max_h, max_w, 3), np.float32)
            hw = np.zeros((len(images), 2), np.int32)
            for i, im in enumerate(images):
                atlas[i, : im.shape[0], : im.shape[1]] = im
                hw[i] = im.shape[:2]
        else:
            atlas = np.zeros((1, 1, 1, 3), np.float32)
            hw = np.ones((1, 2), np.int32)

        grad, perm = perlin_mod.make_perlin_tables(self.seed)
        textures = TextureTable(
            ttype=jnp.asarray(ttype), color1=jnp.asarray(color1),
            color2=jnp.asarray(color2), scale=jnp.asarray(scale),
            image_id=jnp.asarray(image_id),
            perlin_grad=jnp.asarray(grad), perlin_perm=jnp.asarray(perm),
            images=jnp.asarray(atlas), image_hw=jnp.asarray(hw),
        )
        return materials, textures, has_noise, has_image
