"""Wavefront backend tests: per-bounce row compaction must be invisible —
the engine draws the identical counter-based stream as the megakernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_ray_tracing import (
    CameraSettings,
    RenderConfig,
    base_scene,
    make_scene,
    one_weekend_scene,
    render,
)
from tests.test_api import BASE_CAMERA
from tests.test_sharding import assert_images_match


def _cfg(**kw):
    defaults = dict(width=64, height=48, spp=1, max_depth=6)
    defaults.update(kw)
    return RenderConfig(**defaults)


def test_wavefront_bit_matches_megakernel_base_scene():
    scene = base_scene()
    cfg_w = _cfg(spp=2, backend="wavefront")
    cfg_p = _cfg(spp=2, backend="pallas")
    a = np.asarray(render(scene, BASE_CAMERA, cfg_w, frame_seed=jnp.uint32(7)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg_p, frame_seed=jnp.uint32(7)))
    # Same stream, same arithmetic -> bitwise equal.
    np.testing.assert_array_equal(a, b)


def test_wavefront_odd_resolution_padding():
    scene = base_scene()
    cfg_w = _cfg(width=50, height=31, backend="wavefront")
    cfg_p = _cfg(width=50, height=31, backend="pallas")
    a = np.asarray(render(scene, BASE_CAMERA, cfg_w, frame_seed=jnp.uint32(2)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg_p, frame_seed=jnp.uint32(2)))
    assert a.shape == (31, 50, 3)
    np.testing.assert_array_equal(a, b)


def test_wavefront_one_weekend_with_sphere_bvh_and_rr():
    """With a sphere BVH the tile grouping decides which EXTRA leaves a lane
    evaluates, and the reference's far-root fallback (wgsl:190-196) makes
    borderline root choices depend on the lane's tb history — so compacted
    tiles can flip a few hit decisions vs the megakernel's image tiles (the
    same contract as pallas-vs-jax).  Mesh scans have no far-root fallback
    and stay bitwise equal (test_wavefront_mesh_scene)."""
    scene = make_scene(one_weekend_scene(jax.random.key(0)), sphere_bvh=True)
    assert scene.sphere_bvh is not None
    cam = CameraSettings.default()
    kw = dict(width=64, height=40, max_depth=8, russian_roulette_depth=3)
    a = np.asarray(render(scene, cam, _cfg(backend="wavefront", **kw),
                          frame_seed=jnp.uint32(3)))
    b = np.asarray(render(scene, cam, _cfg(backend="pallas", **kw),
                          frame_seed=jnp.uint32(3)))
    assert np.all(np.isfinite(a))
    assert_images_match(a, b, flip_frac=0.1, mean_tol=5e-3)


def test_wavefront_mesh_scene():
    from gpu_ray_tracing import transform_mesh
    from gpu_ray_tracing.models.mesh import icosphere
    from gpu_ray_tracing.models.spheres import LAMBERTIAN, make_spheres

    spheres = make_spheres(
        [((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)]
    )
    mesh = transform_mesh(
        icosphere(2, albedo=(0.8, 0.4, 0.2), smooth=True),
        scale=0.7, translate=(0.0, 0.7, 0.0),
    )
    scene = make_scene(spheres, mesh)
    cam = CameraSettings(
        look_from=jnp.asarray([0.0, 1.0, 3.0]),
        look_at=jnp.asarray([0.0, 0.5, 0.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(45.0),
        defocus_angle=jnp.float32(0.0),
        focus_distance=jnp.float32(3.0),
    )
    kw = dict(width=64, height=48, max_depth=5)
    a = np.asarray(render(scene, cam, _cfg(backend="wavefront", **kw),
                          frame_seed=jnp.uint32(1)))
    b = np.asarray(render(scene, cam, _cfg(backend="pallas", **kw),
                          frame_seed=jnp.uint32(1)))
    assert np.all(np.isfinite(a))
    np.testing.assert_array_equal(a, b)


def test_wavefront_nee_matches_jax():
    """<=4 lights NEE loops over all lights -> stream-identical to pallas."""
    from gpu_ray_tracing.models.spheres import EMISSIVE, LAMBERTIAN, make_spheres

    scene = make_scene(make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.6, 0.6, 0.6), 0.0),
        ((0.0, 2.0, 0.0), 0.4, EMISSIVE, (1.0, 0.9, 0.8), 5.0),
    ]))
    cam = CameraSettings(
        look_from=jnp.asarray([0.0, 1.0, 4.0]),
        look_at=jnp.asarray([0.0, 0.5, 0.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(45.0),
        defocus_angle=jnp.float32(0.0),
        focus_distance=jnp.float32(4.0),
    )
    kw = dict(width=64, height=32, spp=2, max_depth=4, nee=True, sky_intensity=0.0)
    a = np.asarray(render(scene, cam, _cfg(backend="wavefront", **kw),
                          frame_seed=jnp.uint32(5)))
    b = np.asarray(render(scene, cam, _cfg(backend="pallas", **kw),
                          frame_seed=jnp.uint32(5)))
    np.testing.assert_array_equal(a, b)
    assert a.mean() > 0.01


def test_wavefront_progressive_step():
    from gpu_ray_tracing import init_accum, progressive_step

    scene = base_scene()
    cfg = _cfg(spp=4, backend="wavefront")
    state = init_accum(cfg.height, cfg.width)
    state = progressive_step(state, scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(0))
    assert int(state.count) == 1
    assert np.all(np.isfinite(np.asarray(state.rgb)))


def test_wavefront_is_differentiable():
    import dataclasses

    scene = base_scene()
    cfg = _cfg(width=48, height=32, spp=1, max_depth=4, backend="wavefront")

    def loss(albedo):
        s = dataclasses.replace(scene, albedo=albedo)
        img = render(s, BASE_CAMERA, cfg, frame_seed=jnp.uint32(1))
        return jnp.mean(img ** 2)

    g = jax.grad(loss)(scene.albedo)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.linalg.norm(g)) > 0.0


def test_wavefront_requires_hash_rng():
    with pytest.raises(ValueError):
        RenderConfig(backend="wavefront", rng="threefry")


def test_wavefront_row_shard_offset_matches_full_frame():
    """render_wavefront(y_offset, total_width) must reproduce the matching
    rows of the full-frame render exactly (global pixel ids -> same stream)."""
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

    scene = base_scene()
    w, h = 50, 32
    cam = derive_camera(BASE_CAMERA, w, h)
    kw = dict(max_depth=5, t_min=1e-3, frame_seed=jnp.uint32(9),
              sample_index=jnp.uint32(0))
    full = np.asarray(render_wavefront(scene, cam, width=w, height=h, **kw))
    top = np.asarray(render_wavefront(
        scene, cam, width=w, height=16, y_offset=0, total_width=w, **kw))
    bot = np.asarray(render_wavefront(
        scene, cam, width=w, height=16, y_offset=16, total_width=w, **kw))
    np.testing.assert_array_equal(np.concatenate([top, bot]), full)


def test_wavefront_sharded_render_matches_unsharded():
    """render_sharded with backend='wavefront' over an 8-device mesh equals
    the single-device wavefront render."""
    from gpu_ray_tracing.parallel.mesh import make_mesh
    from gpu_ray_tracing.parallel.sharding import render_sharded

    scene = base_scene()
    cfg = _cfg(width=32, height=32, spp=2, max_depth=4, backend="wavefront")
    mesh = make_mesh(4, 2)
    a = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh,
                                  frame_seed=jnp.uint32(3)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(3)))
    assert_images_match(a, b, flip_frac=0.01, mean_tol=5e-4)


def test_wavefront_compact_threshold_is_invisible():
    """Occupancy-gated compaction (skip the row permutation while most rows
    are live) must not change the image: always / never / default-gated
    renders are bitwise identical on a brute-scan scene."""
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

    scene = base_scene()
    w, h = 48, 32
    cam = derive_camera(BASE_CAMERA, w, h)
    kw = dict(width=w, height=h, max_depth=6, t_min=1e-3,
              frame_seed=jnp.uint32(5), sample_index=jnp.uint32(0))
    always = np.asarray(render_wavefront(scene, cam, compact_threshold=1.1, **kw))
    never = np.asarray(render_wavefront(scene, cam, compact_threshold=0.0, **kw))
    gated = np.asarray(render_wavefront(scene, cam, **kw))
    np.testing.assert_array_equal(always, never)
    np.testing.assert_array_equal(always, gated)


def test_wavefront_sort_modes_are_invisible():
    """Row sort keys (live partition / direction octant / origin-cell x
    octant spatial binning) only permute whole rows between bounces; the
    per-lane streams and elementwise accumulation are untouched, so every
    sort mode renders the bitwise-identical image (the spatial keys are a
    pure scheduling choice)."""
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

    scene = make_scene(one_weekend_scene(jax.random.key(0)), sphere_bvh=True)
    w, h = 64, 36
    cam = derive_camera(CameraSettings.default(), w, h)
    kw = dict(width=w, height=h, max_depth=8, t_min=1e-3, spp=2,
              russian_roulette_depth=4,
              frame_seed=jnp.uint32(3), sample_index=jnp.uint32(0))
    imgs = {s: np.asarray(render_wavefront(scene, cam, sort=s, **kw))
            for s in ("live", "octant", "spatial")}
    np.testing.assert_array_equal(imgs["live"], imgs["octant"])
    np.testing.assert_array_equal(imgs["live"], imgs["spatial"])
    # Regenerating pool: same ray set; accumulation stays in pool order for
    # every sort, and rows move whole, so spatial == octant bitwise too.
    kwr = dict(kw, regenerate=True)
    a = np.asarray(render_wavefront(scene, cam, sort="octant", **kwr))
    b = np.asarray(render_wavefront(scene, cam, sort="spatial", **kwr))
    np.testing.assert_array_equal(a, b)

    with pytest.raises(ValueError, match="sort="):
        render_wavefront(scene, cam, sort="bogus", **kw)


def _assert_regen_matches_plain(scene, cam, tol=3e-5, **kw):
    from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

    a = np.asarray(render_wavefront(scene, cam, **kw))
    b = np.asarray(render_wavefront(scene, cam, regenerate=True, **kw))
    assert np.all(np.isfinite(b))
    # Identical per-ray streams; only the per-pixel ACCUMULATION order
    # differs (pool order vs sample-major), so equality is to float
    # addition-reordering noise, not bitwise.
    np.testing.assert_allclose(a, b, atol=tol, rtol=1e-5)
    return a


def test_wavefront_regen_matches_plain_spp4():
    """Ray regeneration (one persistent pool, dead rows refilled with the
    next sample's primaries) must be invisible to the estimator.  The scene
    has a sphere BVH, so regrouped tiles can flip a few borderline far-root
    decisions (the standard sphere-BVH contract) — compare images, not bits."""
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

    scene = make_scene(one_weekend_scene(jax.random.key(0)), sphere_bvh=True)
    assert scene.sphere_bvh is not None
    w, h = 64, 48
    cam = derive_camera(CameraSettings.default(), w, h)
    kw = dict(width=w, height=h, spp=4, max_depth=8, t_min=1e-3,
              russian_roulette_depth=3, frame_seed=jnp.uint32(7),
              sample_index=jnp.uint32(0))
    a = np.asarray(render_wavefront(scene, cam, **kw))
    b = np.asarray(render_wavefront(scene, cam, regenerate=True, **kw))
    assert np.all(np.isfinite(b))
    assert_images_match(a, b, flip_frac=0.005, mean_tol=5e-4)
    assert a.mean() > 0.05


def test_wavefront_regen_nonzero_sample_base_and_odd_frame():
    """Regeneration carries ABSOLUTE per-lane sample ids: a pool starting at
    sample_index=5 must reproduce the plain engine's samples 5..7; odd
    resolutions exercise the pad lanes born dead at refill."""
    from gpu_ray_tracing.models.camera import derive_camera

    scene = base_scene()
    w, h = 50, 31
    cam = derive_camera(BASE_CAMERA, w, h)
    _assert_regen_matches_plain(
        scene, cam, width=w, height=h, spp=3, max_depth=6, t_min=1e-3,
        frame_seed=jnp.uint32(2), sample_index=jnp.uint32(5),
    )


def test_wavefront_regen_refill_threshold_is_invisible():
    """The refill gate (when to spend the whole-pool raygen pass) is a pure
    scheduling decision; any threshold draws the same streams."""
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

    scene = base_scene()
    w, h = 48, 32
    cam = derive_camera(BASE_CAMERA, w, h)
    kw = dict(width=w, height=h, spp=3, max_depth=6, t_min=1e-3,
              frame_seed=jnp.uint32(5), sample_index=jnp.uint32(0),
              regenerate=True)
    eager = np.asarray(render_wavefront(scene, cam, refill_threshold=0.0, **kw))
    lazy = np.asarray(render_wavefront(scene, cam, refill_threshold=0.9, **kw))
    np.testing.assert_allclose(eager, lazy, atol=3e-5, rtol=1e-5)


def test_wavefront_regen_row_shard_matches_full_frame():
    """Sharded regeneration: global pixel ids keep the stream shard-invariant
    (each shard's pool regenerates independently)."""
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

    scene = base_scene()
    w, h = 50, 32
    cam = derive_camera(BASE_CAMERA, w, h)
    kw = dict(max_depth=5, t_min=1e-3, spp=2, frame_seed=jnp.uint32(9),
              sample_index=jnp.uint32(0), regenerate=True)
    full = np.asarray(render_wavefront(scene, cam, width=w, height=h, **kw))
    top = np.asarray(render_wavefront(
        scene, cam, width=w, height=16, y_offset=0, total_width=w, **kw))
    bot = np.asarray(render_wavefront(
        scene, cam, width=w, height=16, y_offset=16, total_width=w, **kw))
    np.testing.assert_allclose(
        np.concatenate([top, bot]), full, atol=3e-5, rtol=1e-5)


def test_wavefront_regen_many_lights_nee():
    """Regeneration with >4 emissive lights exercises the PER-LANE light
    pick (masked accumulation): rays in a tile mix (sample, bounce),
    but each ray must pick the exact light the scalar-pick engines pick for
    its (sample, bounce)."""
    from gpu_ray_tracing.models.camera import derive_camera
    from tests.test_integrators import _many_lights_fixture

    lights, scene_with = _many_lights_fixture()
    scene = scene_with(lights)
    assert scene.lights.count > 4
    w, h = 48, 32
    cam = derive_camera(CameraSettings(
        look_from=jnp.asarray([0.0, 2.0, 6.0]),
        look_at=jnp.asarray([0.0, 0.5, 0.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(50.0),
        defocus_angle=jnp.float32(0.0),
        focus_distance=jnp.float32(6.0),
    ), w, h)
    a = _assert_regen_matches_plain(
        scene, cam, width=w, height=h, spp=3, max_depth=4, t_min=1e-3,
        nee=True, sky_intensity=0.0, frame_seed=jnp.uint32(5),
        sample_index=jnp.uint32(0),
    )
    assert a.mean() > 0.001


def test_wavefront_regen_mesh_scene():
    """Regeneration through the mesh + BVH leaf-scan path."""
    from gpu_ray_tracing import transform_mesh
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.models.mesh import icosphere
    from gpu_ray_tracing.models.spheres import LAMBERTIAN, make_spheres

    spheres = make_spheres(
        [((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)]
    )
    mesh = transform_mesh(
        icosphere(1, albedo=(0.8, 0.4, 0.2), smooth=True),
        scale=0.7, translate=(0.0, 0.7, 0.0),
    )
    scene = make_scene(spheres, mesh)
    w, h = 48, 32
    cam = derive_camera(CameraSettings(
        look_from=jnp.asarray([0.0, 1.0, 3.0]),
        look_at=jnp.asarray([0.0, 0.5, 0.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(45.0),
        defocus_angle=jnp.float32(0.0),
        focus_distance=jnp.float32(3.0),
    ), w, h)
    _assert_regen_matches_plain(
        scene, cam, width=w, height=h, spp=2, max_depth=5, t_min=1e-3,
        frame_seed=jnp.uint32(1), sample_index=jnp.uint32(0),
    )


def test_wavefront_regen_validates_refill_threshold():
    """refill_threshold outside [0, 1] could stall the pool loop forever;
    it must be rejected at trace time."""
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

    scene = base_scene()
    cam = derive_camera(BASE_CAMERA, 32, 16)
    with pytest.raises(ValueError, match="refill_threshold"):
        render_wavefront(
            scene, cam, width=32, height=16, spp=2, max_depth=4, t_min=1e-3,
            frame_seed=jnp.uint32(0), sample_index=jnp.uint32(0),
            regenerate=True, refill_threshold=1.1,
        )


def test_wavefront_regen_spp1_degenerate_pool():
    """spp=1 regeneration has nothing to refill (the pool IS the stream):
    it must still terminate and match the plain engine."""
    from gpu_ray_tracing.models.camera import derive_camera

    scene = base_scene()
    w, h = 48, 32
    cam = derive_camera(BASE_CAMERA, w, h)
    _assert_regen_matches_plain(
        scene, cam, width=w, height=h, spp=1, max_depth=6, t_min=1e-3,
        frame_seed=jnp.uint32(4), sample_index=jnp.uint32(0),
    )


def test_wavefront_regen_depth_zero_is_black():
    """max_depth=0 renders black on every engine; the pool loop must not
    trace a bounce first."""
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

    scene = base_scene()
    cam = derive_camera(BASE_CAMERA, 32, 16)
    for regen in (False, True):
        img = np.asarray(render_wavefront(
            scene, cam, width=32, height=16, spp=2, max_depth=0, t_min=1e-3,
            frame_seed=jnp.uint32(0), sample_index=jnp.uint32(0),
            regenerate=regen,
        ))
        np.testing.assert_array_equal(img, 0.0)


def test_wavefront_regen_via_config():
    """RenderConfig(regenerate='on'/'auto') routes through api.render."""
    scene = base_scene()
    ref = np.asarray(render(
        scene, BASE_CAMERA, _cfg(spp=2, backend="wavefront"),
        frame_seed=jnp.uint32(7)))
    for mode in ("on", "auto"):
        img = np.asarray(render(
            scene, BASE_CAMERA, _cfg(spp=2, backend="wavefront", regenerate=mode),
            frame_seed=jnp.uint32(7)))
        np.testing.assert_allclose(img, ref, atol=3e-5, rtol=1e-5)


def test_wavefront_many_lights_nee_bit_matches_megakernel():
    """>4 emissive lights takes the pick-one-light NEE branch; the pick is a
    function of (sample, frame seed, bounce) only — never tile/program ids —
    so the wavefront engine (whose tiles are compacted ray groups) must stay
    bitwise identical to the megakernel's image tiles."""
    from tests.test_integrators import _many_lights_fixture

    lights, scene_with = _many_lights_fixture()
    scene = scene_with(lights)  # 7 spheres: brute scan, no sphere BVH
    assert scene.sphere_bvh is None
    cam = CameraSettings(
        look_from=jnp.asarray([0.0, 2.0, 6.0]),
        look_at=jnp.asarray([0.0, 0.5, 0.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(50.0),
        defocus_angle=jnp.float32(0.0),
        focus_distance=jnp.float32(6.0),
    )
    kw = dict(width=64, height=32, spp=2, max_depth=3, nee=True,
              sky_intensity=0.0)
    a = np.asarray(render(scene, cam, _cfg(backend="wavefront", **kw),
                          frame_seed=jnp.uint32(5)))
    b = np.asarray(render(scene, cam, _cfg(backend="pallas", **kw),
                          frame_seed=jnp.uint32(5)))
    assert a.mean() > 0.001  # the lights illuminate the frame
    np.testing.assert_array_equal(a, b)


def test_wavefront_regen_sobol_sampler():
    """The regenerating pool mixes per-lane (sample, bounce) ids; the sobol
    sampler's per-lane index arithmetic must give every ray the identical
    low-discrepancy point it gets in the sample-major loop."""
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

    scene = base_scene()
    w, h = 64, 48
    cam = derive_camera(CameraSettings.default(), w, h)
    kw = dict(width=w, height=h, spp=4, max_depth=6, t_min=1e-3,
              frame_seed=jnp.uint32(9), sample_index=jnp.uint32(0),
              sampler_spec=("sobol", 3))
    _assert_regen_matches_plain(scene, cam, **kw)
