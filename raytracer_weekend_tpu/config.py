"""Render configuration.

The reference hard-codes MAX_DEPTH=50 (raytracer_weekend_lib/src/lib.rs:32)
and takes width/aspect/spp from the CLI (console_app/src/main.rs:15-26).
Here everything is one hashable dataclass passed statically into jit.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration of a render (shapes and loop bounds under jit).

    Attributes:
      width: image width in pixels (ref default 400).
      height: image height in pixels (ref: round(width / aspect_ratio)).
      samples_per_pixel: Monte Carlo samples per pixel (ref default 100).
      max_depth: bounce-depth bound; the reference recurses up to 50
        (lib.rs:32). Here it is the length of the wavefront `lax.scan`.
      seed: base seed of the counter-based RNG. The reference's serial path
        uses a fixed SmallRng seed (lib.rs:71); any fixed value here gives a
        deterministic image under any sharding.
      ray_batch: number of rays traced per wavefront megabatch. The full
        (height*width*spp) ray set is processed in chunks of this size;
        0 means "all rays in one batch".
      t_min: minimum hit distance, ref uses 0.001 (lib.rs:102).
      use_log10_volume_sampling: the reference samples constant-medium scatter
        distances with log10 instead of ln (volumes.rs:58) — kept by default
        for parity; set False for the physically conventional exponential.
    """

    width: int = 400
    height: int = 225
    samples_per_pixel: int = 100
    max_depth: int = 50
    seed: int = 0
    ray_batch: int = 0
    t_min: float = 1e-3
    use_log10_volume_sampling: bool = True

    @classmethod
    def from_aspect(cls, width: int = 400, aspect_ratio: float = 16.0 / 9.0,
                    **kw) -> "RenderConfig":
        """Mirror of the reference CLI: height = round(width/aspect)."""
        height = int(round(width / aspect_ratio))
        return cls(width=width, height=height, **kw)

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def n_rays(self) -> int:
        return self.width * self.height * self.samples_per_pixel
