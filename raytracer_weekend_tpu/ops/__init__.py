"""Batched intersection kernels.

Each kernel intersects a megabatch of B rays against a whole SoA primitive
table at once, returning per-ray closest-hit distances (+inf on miss) and
winning primitive indices. The pairwise (ray x primitive) terms are
factored into (B,3)x(3,N) matrix products at HIGHEST precision; see
ops/triangle.py for the Möller–Trumbore factorization. ops/pallas holds the
GPU kernels that replace the sphere and rect brute force there.
"""

from raytracer_weekend_tpu.ops.sphere import hit_spheres, sphere_record
from raytracer_weekend_tpu.ops.rect import hit_rects, rect_record
from raytracer_weekend_tpu.ops.triangle import hit_triangles, triangle_record
from raytracer_weekend_tpu.ops.volume import hit_volumes, volume_record

__all__ = [
    "hit_spheres", "sphere_record",
    "hit_rects", "rect_record",
    "hit_triangles", "triangle_record",
    "hit_volumes", "volume_record",
]
