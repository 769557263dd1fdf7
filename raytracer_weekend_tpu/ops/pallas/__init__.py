"""Closest-hit kernels for the GPU, written in Pallas on the Triton route.

Each replaces a plain brute-force op of ops/ whose (rays x primitives)
intermediates would otherwise round-trip through device memory. The
integrator selects them on the GPU only (integrator.hit_paths); on the CPU
the plain ops run, and tests drive these kernels in interpret mode.
"""

from raytracer_weekend_tpu.ops.pallas.rect_intersect import (
    RECT_TILING, hit_rects_pallas,
)
from raytracer_weekend_tpu.ops.pallas.sphere_intersect import (
    SPHERE_TILING, Tiling, hit_spheres_pallas,
)

__all__ = ["hit_spheres_pallas", "hit_rects_pallas", "Tiling",
           "SPHERE_TILING", "RECT_TILING"]
