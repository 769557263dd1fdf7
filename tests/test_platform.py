"""Platform plumbing: closest-hit path choice, BVH cut-offs, the target
platform, the compile cache, plain-op precision, the PNG writer, and the
GPU-only entry points refusing to run without a GPU."""

import ast
import os
import struct
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_weekend_tpu import integrator
from raytracer_weekend_tpu.ops import hit_rects, hit_spheres, hit_triangles
from raytracer_weekend_tpu.scene import builder as B
from raytracer_weekend_tpu.scene.data import SceneStatic
from raytracer_weekend_tpu.utils import platform as P
from raytracer_weekend_tpu.utils.image import encode_png, save_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _static(**kw):
    base = dict(n_spheres=4, n_rects=4, n_triangles=4, n_volumes=0,
                has_noise=False, has_image=False)
    base.update(kw)
    return SceneStatic(**base)


_MAX = integrator.GPU_SPHERE_KERNEL_MAX


@pytest.mark.parametrize("platform,n_spheres,bvh,expect", [
    ("gpu", 4, False, ("kernel", "kernel", "plain")),
    ("gpu", 1006, True, ("kernel", "kernel", "bvh")),      # book2's table
    ("gpu", _MAX, True, ("kernel", "kernel", "bvh")),
    ("gpu", _MAX + 1, True, ("bvh", "kernel", "bvh")),
    ("gpu", _MAX + 1, False, ("kernel", "kernel", "plain")),
    ("cpu", 4, False, ("plain", "plain", "plain")),
    ("cpu", 1006, True, ("bvh", "plain", "bvh")),
])
def test_hit_paths(platform, n_spheres, bvh, expect):
    static = _static(n_spheres=n_spheres, sphere_bvh=bvh, triangle_bvh=bvh)
    got = integrator.hit_paths(static, platform, sphere_bvh=bvh,
                               triangle_bvh=bvh)
    assert tuple(got) == expect


def test_hit_paths_dropped_tree_falls_back_to_brute_force():
    """Under geometry sharding of a traced scene the trees are dropped
    (shard.pad_scene_for_geom); the scene pytree decides, not `static`."""
    static = _static(n_spheres=_MAX + 1, sphere_bvh=True, triangle_bvh=True)
    for platform, brute in (("gpu", "kernel"), ("cpu", "plain")):
        got = integrator.hit_paths(static, platform, sphere_bvh=False,
                                   triangle_bvh=False)
        assert tuple(got) == (brute, brute, "plain")


@pytest.mark.parametrize("family,n", [
    ("sphere", B.AUTO_BVH_MIN_SPHERES - 1), ("sphere", B.AUTO_BVH_MIN_SPHERES),
    ("triangle", B.AUTO_BVH_MIN_TRIANGLES - 1),
    ("triangle", B.AUTO_BVH_MIN_TRIANGLES)])
def test_auto_bvh_cutoffs(family, n):
    """build_scene(bvh="auto") attaches a tree exactly from the cut-off on;
    jumpy_balls' 486 spheres stay brute force, Cornell's 24 triangles too."""
    assert B.AUTO_BVH_MIN_SPHERES > 486 and B.AUTO_BVH_MIN_TRIANGLES > 24
    rng = np.random.default_rng(0)
    mat = B.Lambertian((0.5, 0.5, 0.5))
    if family == "sphere":
        objs = [B.Sphere(tuple(rng.normal(size=3) * 20), 0.2, mat)
                for _ in range(n)]
    else:
        objs = [B.Triangle.flat_shaded(
            tuple(map(tuple, rng.normal(size=(3, 3)) * 5)), mat)
            for _ in range(n)]
    _, static = B.build_scene(objs)
    attached = static.sphere_bvh if family == "sphere" else static.triangle_bvh
    limit = (B.AUTO_BVH_MIN_SPHERES if family == "sphere"
             else B.AUTO_BVH_MIN_TRIANGLES)
    assert attached == (n >= limit)


def test_target_platform_follows_default_device():
    assert P.target_platform() == jax.default_backend() == "cpu"
    with jax.default_device(jax.devices("cpu")[0]):
        assert P.target_platform() == "cpu"
    with jax.default_device("cpu"):
        assert P.target_platform() == "cpu"


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        P.require_gpu()


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = P.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_respects_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert P.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for the writer's own format (RGB8, filter 0)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2) and chunks[b"IEND"] == b""
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (36, 64)])
def test_png_round_trip(tmp_path, shape):
    img = np.random.default_rng(3).integers(0, 256, (*shape, 3), np.uint8)
    path = str(tmp_path / "x.png")
    save_png(path, img)
    with open(path, "rb") as f:
        data = f.read()
    assert data == encode_png(img)
    np.testing.assert_array_equal(_decode_png(data), img)
    assert os.listdir(tmp_path) == ["x.png"]   # no temp file left behind


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    found = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    sub = getattr(sub, "jaxpr", sub)   # ClosedJaxpr
                    if hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return found


@pytest.mark.parametrize("op", ["sphere", "rect", "triangle"])
def test_plain_ops_use_highest_precision(op):
    """Every matrix product of the plain ops runs at HIGHEST: a DEFAULT f32
    product may run in TF32 on a GPU (10 mantissa bits)."""
    rng = np.random.default_rng(0)
    mat = B.Lambertian((1, 1, 1))
    o = jnp.asarray(rng.normal(size=(8, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(8, 3)), jnp.float32)
    if op == "sphere":
        scene, _ = B.build_scene([B.Sphere((0, 0, -3), 1.0, mat)])
        fn = lambda o, d: hit_spheres(scene.spheres, o, d, jnp.zeros(8), 1e-3)
    elif op == "rect":
        scene, _ = B.build_scene([B.XYRectangle(0, 1, 0, 1, -2.0, mat)])
        fn = lambda o, d: hit_rects(scene.rects, o, d, 1e-3)
    else:
        scene, _ = B.build_scene([B.Triangle.flat_shaded(
            ((0, 0, -2), (1, 0, -2), (0, 1, -2)), mat)], bvh=False)
        fn = lambda o, d: hit_triangles(scene.triangles, o, d, 1e-3)
    precisions = _dot_precisions(fn, o, d)
    assert len(precisions) >= 4
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in precisions), precisions


def _python_files():
    for base, dirs, files in os.walk(ROOT):
        dirs[:] = [x for x in dirs
                   if not x.startswith(".") and x != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_module_imports_the_mosaic_tpu_backend():
    """No file of the repo imports Pallas's TPU backend (Mosaic TPU)."""
    bad = []
    for path in _python_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            else:
                continue
            bad += [(path, n) for n in names
                    if {"pallas", "tpu"} <= set(n.split("."))]
    assert not bad, bad


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_gpu_scripts_exit_nonzero_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no GPU" in out.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Copied without the package it cannot import it, and fails."""
    script = tmp_path / "chip_smoke.py"
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        script.write_text(f.read())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
