"""Scalar reference oracle.

An intentionally naive numpy implementation of the reference algorithm
(recursive closest-hit search over primitive lists, lib.rs:97-117 +
hittable/*), consuming the SAME counter-based RNG streams as the wavefront
integrator. Because both implementations draw identical uniforms per
(ray, depth, site), their radiance estimates must agree to float tolerance —
this validates the vectorized, matmul-factored ops against obviously-correct
scalar math, playing the role of the reference's seeded serial path
(lib.rs:69-75) which we cannot run (no Rust toolchain in this image).
"""

from __future__ import annotations

import math

import numpy as np

from raytracer_weekend_tpu import rng as rt_rng
from raytracer_weekend_tpu.scene.data import (
    VOL_BOX, VOL_SPHERE, SceneData,
)
from raytracer_weekend_tpu import materials as M
from raytracer_weekend_tpu import textures as TX


def _rand4(seed, ray_id, depth, salt):
    return np.asarray(rt_rng.rand4(seed, np.uint32(ray_id), np.uint32(depth),
                                   salt))


def _unit(v):
    return v / np.linalg.norm(v)


# Relative epsilon for knife-edge detection: a lane is FRAGILE when any
# discrete decision along its path (hit/miss, winner, branch) sits within
# this margin of its threshold in f64 — the f32 renderer may legitimately
# take the other branch there, making the whole lane incomparable. Sized
# to a few ulps of accumulated f32 error (~1e-7/op over tens of ops); at
# mesh scale every path grazes SOME triangle bound, so a generous margin
# would flag every pixel.
_EDGE = 2e-5
_EDGE_SPH = 2e-4


class Oracle:
    def __init__(self, scene: SceneData, static, cfg):
        self.s = jax_to_np(scene)
        self.static = static
        self.cfg = cfg
        self.fragile = False  # set during sample_ray; reset per lane

    def _edge(self, lhs, rhs, scale=1.0, eps=_EDGE):
        """Mark the current lane fragile when |lhs - rhs| is within the
        knife-edge margin (decision boundary too close to call in f32).

        Sphere decisions pass the wider _EDGE_SPH: the renderer evaluates
        its quadratics in matmul-factored form (|o|^2 - 2o.c + k), whose
        cancellation error for a far camera is orders beyond a direct
        |o-c|^2 evaluation's few ulps."""
        if abs(lhs - rhs) < eps * (abs(scale) + 1e-12):
            self.fragile = True

    def _sphere_hit(self, c, r, o, d, t_min, t_max):
        oc = o - c
        a = d @ d
        half_b = oc @ d
        cterm = oc @ oc - r * r
        disc = half_b * half_b - a * cterm
        self._edge(disc, 0.0, half_b * half_b + abs(a * cterm),
                   eps=_EDGE_SPH)
        if disc <= 0:
            return None
        sq = math.sqrt(disc)
        root = (-half_b - sq) / a
        self._edge(root, t_min, 1.0 + abs(root), eps=_EDGE_SPH)
        if t_max < np.inf:
            self._edge(root, t_max, 1.0 + abs(root), eps=_EDGE_SPH)
        if root < t_min or root > t_max:
            root = (-half_b + sq) / a
            self._edge(root, t_min, 1.0 + abs(root), eps=_EDGE_SPH)
            if t_max < np.inf:
                self._edge(root, t_max, 1.0 + abs(root), eps=_EDGE_SPH)
            if root < t_min or root > t_max:
                return None
        return root

    # -- closest hit over all families (linear scan) -----------------------

    def closest_hit(self, o, d, time, seed, ray_id, depth):
        best = None  # (t, record)
        s = self.s
        t_min = self.cfg.t_min

        def better(t):
            if t is not None and best is not None:
                self._edge(t, best[0], 1.0 + abs(t))   # winner tie
            return t is not None and (best is None or t < best[0])

        if self.static.n_spheres:
            for i in range(self.static.n_spheres):
                c0, c1 = s.spheres.c0[i], s.spheres.c1[i]
                w = (time - s.spheres.t0[i]) / (s.spheres.t1[i] - s.spheres.t0[i])
                c = c0 + w * (c1 - c0)
                r = s.spheres.radius[i]
                t = self._sphere_hit(c, r, o, d, t_min,
                                     best[0] if best else np.inf)
                if better(t):
                    p = o + t * d
                    outward = (p - c) / r
                    theta = math.acos(max(-1.0, min(1.0, -outward[1])))
                    phi = math.atan2(-outward[2], outward[0]) + math.pi
                    best = (t, (p, outward, phi / (2 * math.pi),
                                theta / math.pi, int(s.spheres.mat[i]), False))

        if self.static.n_rects:
            for i in range(self.static.n_rects):
                ax = int(s.rects.axis[i])
                a_ax, b_ax = {0: (1, 2), 1: (0, 2), 2: (0, 1)}[ax]
                if d[ax] == 0:
                    continue
                t = (s.rects.k[i] - o[ax]) / d[ax]
                if not np.isfinite(t):
                    continue
                self._edge(t, t_min, 1.0 + abs(t))
                if t < t_min:
                    continue
                av = o[a_ax] + t * d[a_ax]
                bv = o[b_ax] + t * d[b_ax]
                sa = s.rects.a1[i] - s.rects.a0[i]
                sb = s.rects.b1[i] - s.rects.b0[i]
                self._edge(av, s.rects.a0[i], sa)
                self._edge(av, s.rects.a1[i], sa)
                self._edge(bv, s.rects.b0[i], sb)
                self._edge(bv, s.rects.b1[i], sb)
                if av < s.rects.a0[i] or av > s.rects.a1[i]:
                    continue
                if bv < s.rects.b0[i] or bv > s.rects.b1[i]:
                    continue
                if better(t):
                    p = o + t * d
                    outward = np.zeros(3)
                    outward[ax] = 1.0
                    u = (av - s.rects.a0[i]) / (s.rects.a1[i] - s.rects.a0[i])
                    v = (bv - s.rects.b0[i]) / (s.rects.b1[i] - s.rects.b0[i])
                    best = (t, (p, outward, u, v, int(s.rects.mat[i]), False))

        if self.static.n_triangles:
            for i in range(self.static.n_triangles):
                v0, v1, v2 = s.triangles.v0[i], s.triangles.v1[i], s.triangles.v2[i]
                ab, ac = v1 - v0, v2 - v0
                n = np.cross(ab, ac)
                det = -(d @ n)
                if det == 0:
                    continue
                ao = o - v0
                aoxd = np.cross(ao, d)
                u = (ac @ aoxd) / det
                v = -(ab @ aoxd) / det
                t = (ao @ n) / det
                self._edge(t, t_min, 1.0 + abs(t))
                self._edge(u, 0.0)
                self._edge(v, 0.0)
                self._edge(u + v, 1.0)
                if t < t_min or t < 0 or u < 0 or v < 0 or u + v > 1:
                    continue
                if better(t):
                    p = o + t * d
                    nrm = (1 - u - v) * s.triangles.n0[i] + u * s.triangles.n1[i] + v * s.triangles.n2[i]
                    uv = (1 - u - v) * s.triangles.uv0[i] + u * s.triangles.uv1[i] + v * s.triangles.uv2[i]
                    best = (t, (p, nrm, uv[0], uv[1], int(s.triangles.mat[i]), False))

        if self.static.n_volumes:
            for i in range(self.static.n_volumes):
                rec = self._volume_hit(i, o, d, seed, ray_id, depth)
                if rec is not None and better(rec[0]):
                    best = rec

        return best

    def _volume_hit(self, i, o, d, seed, ray_id, depth):
        s = self.s
        c, si = s.volumes.cos_t[i], s.volumes.sin_t[i]
        ot = o - s.volumes.offset[i]
        oo = np.array([c * ot[0] - si * ot[2], ot[1], si * ot[0] + c * ot[2]])
        dd = np.array([c * d[0] - si * d[2], d[1], si * d[0] + c * d[2]])
        if int(s.volumes.vtype[i]) == VOL_SPHERE:
            oc = oo - s.volumes.center[i]
            a = dd @ dd
            half_b = oc @ dd
            cterm = oc @ oc - s.volumes.radius[i] ** 2
            disc = half_b * half_b - a * cterm
            self._edge(disc, 0.0, half_b * half_b + abs(a * cterm))
            if disc <= 0:
                return None
            sq = math.sqrt(disc)
            enter, exit_ = (-half_b - sq) / a, (-half_b + sq) / a
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                t0 = (s.volumes.bmin[i] - oo) / dd
                t1 = (s.volumes.bmax[i] - oo) / dd
            near, far = np.minimum(t0, t1), np.maximum(t0, t1)
            enter, exit_ = np.max(near), np.min(far)
            if np.isfinite(enter) and np.isfinite(exit_):
                self._edge(enter, exit_, 1.0 + abs(enter))
            if not enter < exit_:
                return None
        t1c = max(enter, self.cfg.t_min)
        self._edge(t1c, exit_, 1.0 + abs(exit_))
        if not t1c < exit_:
            return None
        t1c = max(t1c, 0.0)
        ray_len = math.sqrt(d @ d)
        dist_inside = (exit_ - t1c) * ray_len
        salt = (rt_rng.SALT_VOLUME + i) & 0xFFFFFFFF
        u = float(_rand4(seed, ray_id, depth, salt)[0])
        u = min(max(u, 1e-12), 1.0)
        logu = math.log10(u) if self.cfg.use_log10_volume_sampling else math.log(u)
        hit_distance = float(s.volumes.neg_inv_density[i]) * logu
        self._edge(hit_distance, dist_inside, 1.0 + abs(dist_inside))
        if hit_distance > dist_inside:
            return None
        t = t1c + hit_distance / ray_len
        p = o + t * d
        return (t, (p, np.array([1.0, 0.0, 0.0]), 0.0, 0.0,
                    int(s.volumes.mat[i]), True))

    # -- textures ----------------------------------------------------------

    def texture_value(self, tid, u, v, p):
        s = self.s
        tt = int(s.textures.ttype[tid])
        if tt == TX.SOLID:
            return s.textures.color1[tid].copy()
        if tt == TX.CHECKER:
            f = s.textures.scale[tid]
            sines = math.sin(f * p[0]) * math.sin(f * p[1]) * math.sin(f * p[2])
            self._edge(sines, 0.0)
            return (s.textures.color2[tid] if sines < 0 else s.textures.color1[tid]).copy()
        if tt == TX.NOISE:
            from raytracer_weekend_tpu import perlin
            import jax.numpy as jnp
            turb = float(perlin.turbulence(
                jnp.asarray(s.textures.perlin_grad),
                jnp.asarray(s.textures.perlin_perm),
                jnp.asarray(p, jnp.float32), 7))
            val = 0.5 * (1.0 + math.sin(s.textures.scale[tid] * p[2] + 10.0 * turb))
            return np.array([val, val, val])
        if tt == TX.IMAGE:
            img_id = int(s.textures.image_id[tid])
            h, w = s.textures.image_hw[img_id]
            uc = min(max(u, 0.0), 1.0)
            vc = 1.0 - min(max(v, 0.0), 1.0)
            # nearest-texel fetch is discontinuous at texel borders
            self._edge(uc * w, round(uc * w))
            self._edge(vc * h, round(vc * h))
            i = min(int(uc * w), w - 1)
            j = min(int(vc * h), h - 1)
            return s.textures.images[img_id, j, i].copy()
        if tt == TX.UVDEBUG:
            return np.array([u, v, 0.0])
        raise ValueError(tt)

    # -- recursive radiance (lib.rs:97-117) --------------------------------

    def sample_ray(self, o, d, time, seed, ray_id, depth_budget, depth_idx=0):
        if depth_budget == 0:
            return np.zeros(3)
        rec = self.closest_hit(o, d, time, seed, ray_id, depth_idx)
        if rec is None:
            return np.asarray(self.s.background, np.float64).copy()
        t, (p, outward, u, v, mat_id, is_vol) = rec
        dn = float(np.dot(d, outward))
        self._edge(dn, 0.0, np.linalg.norm(d) * np.linalg.norm(outward))
        front = bool(dn < 0.0) or is_vol
        normal = outward if front else -outward

        s = self.s
        mtype = int(s.materials.mtype[mat_id])
        tex = self.texture_value(int(s.materials.tex[mat_id]), u, v, p)

        emitted = tex if mtype == M.DIFFUSE_LIGHT else np.zeros(3)
        if mtype == M.DIFFUSE_LIGHT:
            return emitted

        if mtype == M.LAMBERTIAN:
            ul = _rand4(seed, ray_id, depth_idx, rt_rng.SALT_LAMBERTIAN)
            uv_ = np.asarray(rt_rng.unit_vector_from_uniforms(ul[0], ul[1]))
            nd = normal + uv_
            self._edge(float(np.abs(nd).max()), 1e-8)
            if np.all(np.abs(nd) < 1e-8):
                nd = normal
            att = tex
        elif mtype == M.METAL:
            um = _rand4(seed, ray_id, depth_idx, rt_rng.SALT_METAL)
            ball = np.asarray(
                rt_rng.in_unit_sphere_from_uniforms(um[0], um[1], um[2]))
            ud = _unit(d)
            nd = ud - 2 * (ud @ normal) * normal + s.materials.fuzz[mat_id] * ball
            self._edge(float(nd @ normal), 0.0, np.linalg.norm(nd))
            if nd @ normal <= 0:
                return emitted
            att = tex
        elif mtype == M.DIELECTRIC:
            urand = float(_rand4(seed, ray_id, depth_idx, rt_rng.SALT_DIELECTRIC)[0])
            ior = float(s.materials.ior[mat_id])
            ratio = (1.0 / ior) if front else ior
            ud = _unit(d)
            cos_t = min(-(ud @ normal), 1.0)
            sin_t = math.sqrt(max(0.0, 1 - cos_t * cos_t))
            r0 = ((1 - ratio) / (1 + ratio)) ** 2
            refl = r0 + (1 - r0) * (1 - cos_t) ** 5
            self._edge(ratio * sin_t, 1.0)
            self._edge(refl, urand)
            if ratio * sin_t > 1.0 or refl > urand:
                nd = ud - 2 * (ud @ normal) * normal
            else:
                perp = ratio * (ud + cos_t * normal)
                par = -math.sqrt(abs(1.0 - perp @ perp)) * normal
                nd = perp + par
            att = np.ones(3)
        elif mtype == M.ISOTROPIC:
            ui = _rand4(seed, ray_id, depth_idx, rt_rng.SALT_ISOTROPIC)
            nd = np.asarray(
                rt_rng.in_unit_sphere_from_uniforms(ui[0], ui[1], ui[2]))
            att = tex
        else:
            raise ValueError(mtype)

        rec_color = self.sample_ray(p, np.asarray(nd, np.float64), time, seed,
                                    ray_id, depth_budget - 1, depth_idx + 1)
        return emitted + att * rec_color

    def render(self, cam, cfg, seed=None, return_fragile=False):
        """Full scalar render -> (H,W,3) color sums, mirroring render_image.

        With return_fragile=True also returns an (H,W) bool mask of pixels
        whose paths crossed a knife-edge decision (within _EDGE of a
        discrete threshold in f64): on those, the f32 renderer may follow a
        different — equally valid — path, so per-channel comparison is
        meaningless. Robust pixels must match tightly.
        """
        from raytracer_weekend_tpu.camera import get_rays
        import jax.numpy as jnp

        seed = np.uint32(cfg.seed if seed is None else seed)
        img = np.zeros((cfg.height, cfg.width, 3))
        frag = np.zeros((cfg.height, cfg.width), bool)
        for lane in range(cfg.n_rays):
            pix = lane // cfg.samples_per_pixel
            col = pix % cfg.width
            row_top = pix // cfg.width
            row = cfg.height - 1 - row_top
            uj = _rand4(seed, lane, 0, rt_rng.SALT_PIXEL_JITTER)
            u = (col + uj[0]) / (cfg.width - 1)
            v = (row + uj[1]) / (cfg.height - 1)
            o, d, t = get_rays(cam, jnp.float32(u), jnp.float32(v), seed,
                               jnp.uint32(lane))
            self.fragile = False
            color = self.sample_ray(np.asarray(o, np.float64),
                                    np.asarray(d, np.float64), float(t),
                                    seed, lane, cfg.max_depth)
            img[row_top, col] += color
            frag[row_top, col] |= self.fragile
        if return_fragile:
            return img, frag
        return img


class _NS:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def jax_to_np(tree):
    """Recursively convert a pytree of jnp arrays to numpy attributes."""
    if hasattr(tree, "_fields"):
        return _NS(**{f: jax_to_np(getattr(tree, f)) for f in tree._fields})
    return np.asarray(tree)
