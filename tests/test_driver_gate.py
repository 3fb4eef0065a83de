"""Entry-point tests outside the suite's CPU pin.

The whole test suite runs with JAX_PLATFORMS=cpu (conftest), so bugs keyed
on `jax.default_backend()` would be invisible to it.  These tests close
that hole:

  - a subprocess runs `dryrun_multichip(8)` WITHOUT the conftest platform
    forcing (the default platform resolves to whatever the machine has,
    possibly a GPU; the mesh is the virtual CPU pool; Pallas interpret
    mode must key off the MESH devices);
  - gradients through `backend='wavefront', regenerate='on'` (the custom
    VJP replays on the jax backend and must drop the wavefront-only flag).
"""

import os
import subprocess
import sys

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing import RenderConfig, base_scene, render
from tests.test_api import BASE_CAMERA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_in_driver_environment():
    """The dry run must be green WITHOUT the suite's JAX_PLATFORMS=cpu.

    The subprocess env drops the conftest's platform pin, so JAX resolves
    its real default backend (a GPU where there is one) while the dry run
    builds its CPU mesh.
    """
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # undo the conftest's CPU pin
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(8); print('GATE_OK')"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=560,
    )
    assert proc.returncode == 0, (
        f"dryrun_multichip(8) failed without the CPU pin:\n"
        f"stdout: {proc.stdout[-2000:]}\nstderr: {proc.stderr[-4000:]}"
    )
    assert "GATE_OK" in proc.stdout


def test_grad_through_wavefront_regenerate():
    """jax.grad through the regenerating wavefront engine: the VJP
    backward's jax-backend replay config must drop regenerate='on', which
    RenderConfig rejects for backend='jax'."""
    scene = base_scene()
    cfg = RenderConfig(
        width=16, height=12, spp=2, max_depth=3,
        backend="wavefront", regenerate="on",
    )

    def loss(albedo):
        s = dataclasses.replace(scene, albedo=albedo)
        img = render(s, BASE_CAMERA, cfg, frame_seed=jnp.uint32(3))
        return jnp.mean(img)

    g = jax.grad(loss)(scene.albedo)
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.max(jnp.abs(g))) > 0.0
