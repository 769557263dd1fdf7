"""True multi-process rendering test: 2 processes x 4 CPU devices over TCP.

Simulates the >=2-host BASELINE config on one machine: each subprocess runs
jax.distributed.initialize with its own 4 virtual CPU devices; the global
8-device mesh spans both, film shards cross the process boundary (the
inter-host link's analog), and the assembled image must match the
single-process render.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1])
port = sys.argv[2]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=pid)
import numpy as np
sys.path.insert(0, os.getcwd())
from raytracer_weekend_tpu.camera import make_camera
from raytracer_weekend_tpu.config import RenderConfig
from raytracer_weekend_tpu.parallel.multihost import (
    global_render_mesh, render_multihost)
from raytracer_weekend_tpu.scene import builder as B

objs = [
    B.Sphere((0, -100.5, -1), 100.0, B.Lambertian((0.8, 0.8, 0.0))),
    B.Sphere((0, 0, -1), 0.5, B.Lambertian((0.1, 0.2, 0.5))),
    B.Sphere((1, 0, -1), 0.5, B.Metal((0.8, 0.6, 0.2), 0.2)),
]
scene, static = B.build_scene(objs, background=(0.6, 0.7, 0.9))
cfg = RenderConfig(width=8, height=4, samples_per_pixel=2, max_depth=3,
                   seed=5)
cam = make_camera((0, 0.2, 1.2), (0, 0, -1), (0, 1, 0), 50.0, 2.0, 0.0,
                  2.0, 0.0, 1.0)
assert len(jax.devices()) == 8, jax.devices()
img = render_multihost(scene, static, cfg, cam)
np.save(sys.argv[3], img)
print("WORKER_OK", pid)
"""


pytestmark = pytest.mark.slow  # heavy: see pytest.ini


@pytest.mark.slow
def test_two_process_render_matches_single(tmp_path):
    port = _free_port()
    outs = [str(tmp_path / f"img{i}.npy") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(i), str(port), outs[i]],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        for i in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        logs.append(out.decode(errors="replace"))
    assert all("WORKER_OK" in log for log in logs), logs[-1][-2000:]

    img0 = np.load(outs[0])
    img1 = np.load(outs[1])
    np.testing.assert_allclose(img0, img1, atol=1e-6)  # hosts agree

    # Single-process reference.
    from raytracer_weekend_tpu import integrator
    from raytracer_weekend_tpu.camera import make_camera
    from raytracer_weekend_tpu.config import RenderConfig
    from raytracer_weekend_tpu.scene import builder as B

    objs = [
        B.Sphere((0, -100.5, -1), 100.0, B.Lambertian((0.8, 0.8, 0.0))),
        B.Sphere((0, 0, -1), 0.5, B.Lambertian((0.1, 0.2, 0.5))),
        B.Sphere((1, 0, -1), 0.5, B.Metal((0.8, 0.6, 0.2), 0.2)),
    ]
    scene, static = B.build_scene(objs, background=(0.6, 0.7, 0.9))
    cfg = RenderConfig(width=8, height=4, samples_per_pixel=2, max_depth=3,
                       seed=5)
    cam = make_camera((0, 0.2, 1.2), (0, 0, -1), (0, 1, 0), 50.0, 2.0, 0.0,
                      2.0, 0.0, 1.0)
    ref = np.asarray(integrator.render_image(scene, static, cfg, cam))
    np.testing.assert_allclose(img0, ref, rtol=2e-5, atol=2e-5)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
