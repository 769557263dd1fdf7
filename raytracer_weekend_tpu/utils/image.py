"""Tone mapping and PNG output.

Reproduces the reference's writeback exactly (console_app/src/main.rs:78-87):
divide the accumulated color sum by spp, gamma-correct with sqrt (gamma 2.0),
clamp to [0, 0.999], scale by 255.999, truncate to u8.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def tone_map(color_sum: np.ndarray, samples_per_pixel: int) -> np.ndarray:
    """(H,W,3) accumulated color sums -> (H,W,3) uint8."""
    c = np.asarray(color_sum, np.float32) / float(samples_per_pixel)
    c = np.sqrt(np.maximum(c, 0.0))
    c = np.clip(c, 0.0, 0.999)
    return (255.999 * c).astype(np.uint8)


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """(H,W,3) uint8 -> PNG bytes: 8-bit RGB, no interlace, filter 0 on
    every row, one zlib stream (stdlib only)."""
    img = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def save_png(path: str, rgb_u8: np.ndarray) -> None:
    # Write-then-rename so a live-reloading viewer (live_view rewrites the
    # PNG in place while tailing a render) never reads a half-written file.
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(encode_png(rgb_u8))
    os.replace(tmp, path)


def tone_map_f32(color_sum: np.ndarray, samples_per_pixel: int) -> np.ndarray:
    """Float variant (no quantization) for allclose comparisons in tests."""
    c = np.asarray(color_sum, np.float32) / float(samples_per_pixel)
    return np.clip(np.sqrt(np.maximum(c, 0.0)), 0.0, 0.999)
