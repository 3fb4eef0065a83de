"""Golden-image regression tests (SURVEY §4's CPU-jit anchor).

The whole renderer is a pure function of (scene, camera, seed); these goldens
pin the CPU output so any change to RNG streams, sampling, intersection, or
shading is caught.  They were generated by the same code path they test, so
they are regression (not external-correctness) anchors — correctness comes
from the analytic unit tests; BASELINE.json defines bit-stability against
the CPU jit of *this* code, which is exactly what these assert.

Tolerance note: exact equality holds on the generating XLA version; a
compiler upgrade may legitimately shift borderline hit decisions
(see parallel/sharding.py), so the assertion uses the decision-flip contract
with tight bounds rather than bitwise equality.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing import (
    CameraSettings,
    RenderConfig,
    base_scene,
    one_weekend_scene,
    render,
)
from tests.test_api import BASE_CAMERA
from tests.test_sharding import assert_images_match

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, name))


def test_golden_base_normal():
    cfg = RenderConfig(width=64, height=48, spp=1, integrator="normal")
    img = np.asarray(render(base_scene(), BASE_CAMERA, cfg, frame_seed=jnp.uint32(0)))
    assert_images_match(img, _golden("base_normal_64x48.npy"), flip_frac=0.002, mean_tol=1e-5)


def test_golden_base_path():
    cfg = RenderConfig(width=64, height=48, spp=4, max_depth=8)
    img = np.asarray(render(base_scene(), BASE_CAMERA, cfg, frame_seed=jnp.uint32(42)))
    assert_images_match(img, _golden("base_path_64x48.npy"), flip_frac=0.005, mean_tol=1e-4)


def test_golden_wgsl_parity():
    """The exact reference-quirk stream (seed*seed jitter, rim defocus,
    frame-uniform scatter seeds, depth-exhaustion sky leak)."""
    cfg = RenderConfig(width=48, height=32, spp=2, max_depth=6, rng="wgsl", parity=True)
    img = np.asarray(render(base_scene(), BASE_CAMERA, cfg, frame_seed=jnp.uint32(7)))
    assert_images_match(img, _golden("base_parity_48x32.npy"), flip_frac=0.005, mean_tol=1e-4)


def test_golden_one_weekend():
    scene = one_weekend_scene(jax.random.key(0))
    cfg = RenderConfig(width=48, height=27, spp=2, max_depth=6)
    img = np.asarray(render(scene, CameraSettings.default(), cfg, frame_seed=jnp.uint32(3)))
    assert_images_match(img, _golden("one_weekend_48x27.npy"), flip_frac=0.01, mean_tol=2e-4)


def test_golden_parity_check_cases():
    """The on-chip parity harness's extended cases (nee+mis, sobol, mesh —
    benchmarks/parity_check.py) stay pinned on CPU too: a drift here would
    silently invalidate the on-card correctness check's baseline."""
    from benchmarks.parity_check import _cases

    extended = {"nee_mis_48x36.npy", "sobol_base_48x32.npy",
                "mesh_ico_48x36.npy", "cornell_48x48.npy"}
    seen = set()
    for case in _cases():
        name, fn = case[0], case[1]
        if name not in extended:
            continue
        seen.add(name)
        img = np.asarray(fn("jax"))
        assert_images_match(img, _golden(name), flip_frac=0.005, mean_tol=1e-4)
    assert seen == extended


def test_golden_many_lights_mis():
    """Pins the > 4-light MIS pick-one stream (late r4) from the PALLAS
    backend (scalar pick — the stream the wavefront engine shares and the
    on-chip parity harness gates against; jax picks per lane and is pinned
    statistically in tests/test_tri_lights.py)."""
    from benchmarks.parity_check import _cases

    for case in _cases():
        if case[0] == "many_mis_48x36.npy":
            img = np.asarray(case[1]("pallas"))
            assert_images_match(img, _golden(case[0]), flip_frac=0.005,
                                mean_tol=1e-4)
            return
    raise AssertionError("many_mis case missing from parity_check")


def test_golden_nee_emissive():
    """Pins the NEE + emissive + RR streams (salt layout 2000+37i+7l)."""
    import dataclasses

    from gpu_ray_tracing import make_scene
    from gpu_ray_tracing.models.spheres import EMISSIVE, LAMBERTIAN, make_spheres

    scene = make_scene(make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((0.0, 2.0, -2.0), 0.3, EMISSIVE, (1.0, 0.9, 0.7), 20.0),
        ((0.8, 0.4, -1.5), 0.4, LAMBERTIAN, (0.3, 0.5, 0.8), 0.0),
    ]))
    cfg = RenderConfig(width=48, height=36, spp=4, max_depth=6,
                       sky_intensity=0.0, nee=True, russian_roulette_depth=3)
    img = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(9)))
    assert_images_match(img, _golden("nee_light_48x36.npy"), flip_frac=0.005,
                        mean_tol=1e-4)
