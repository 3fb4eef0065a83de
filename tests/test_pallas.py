"""Megakernel tests: the Pallas backend must agree with the pure-JAX
integrator (same hash RNG stream) in interpret mode on CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_ray_tracing import (
    CameraSettings,
    RenderConfig,
    base_scene,
    one_weekend_scene,
    render,
)
from gpu_ray_tracing.ops.pallas.megakernel import scene_planes
from tests.test_api import BASE_CAMERA
from tests.test_sharding import assert_images_match


def _cfg(**kw):
    defaults = dict(width=64, height=48, spp=1, max_depth=6)
    defaults.update(kw)
    return RenderConfig(**defaults)


def test_scene_planes_layout():
    s = base_scene()
    planes = np.asarray(scene_planes(s))
    assert planes.shape == (16, 3)
    np.testing.assert_allclose(planes[0], np.asarray(s.centers)[:, 0])
    np.testing.assert_allclose(planes[3], np.asarray(s.radii))
    c2r2 = (np.asarray(s.centers) ** 2).sum(-1) - np.asarray(s.radii) ** 2
    np.testing.assert_allclose(planes[4], c2r2, rtol=1e-5)
    assert np.all(planes[10] == 1.0)


def test_pallas_normal_shading_matches_jax():
    scene = base_scene()
    cfg_p = _cfg(integrator="normal", backend="pallas")
    cfg_j = _cfg(integrator="normal", backend="jax")
    a = np.asarray(render(scene, BASE_CAMERA, cfg_p, frame_seed=jnp.uint32(0)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg_j, frame_seed=jnp.uint32(0)))
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_pallas_path_tracer_matches_jax_base_scene():
    scene = base_scene()
    cfg_p = _cfg(backend="pallas")
    cfg_j = _cfg(backend="jax")
    a = np.asarray(render(scene, BASE_CAMERA, cfg_p, frame_seed=jnp.uint32(7)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg_j, frame_seed=jnp.uint32(7)))
    # Same RNG stream; only fp formulation differences (rsqrt vs /norm etc.)
    # and their decision flips may differ.
    assert_images_match(a, b, flip_frac=0.01, mean_tol=2e-4)


def test_pallas_path_tracer_one_weekend():
    scene = one_weekend_scene(jax.random.key(0))
    cfg_p = _cfg(width=64, height=40, max_depth=8, backend="pallas")
    cfg_j = _cfg(width=64, height=40, max_depth=8, backend="jax")
    cam = CameraSettings.default()
    a = np.asarray(render(scene, cam, cfg_p, frame_seed=jnp.uint32(3)))
    b = np.asarray(render(scene, cam, cfg_j, frame_seed=jnp.uint32(3)))
    assert np.all(np.isfinite(a))
    # Tiny image + deep bounces: a handful of decision flips dominates the
    # mean, so the mean tolerance is looser than at full resolution.
    assert_images_match(a, b, flip_frac=0.02, mean_tol=2e-3)


def test_pallas_spp_accumulation():
    """render(spp=4) must equal the mean of the four 1-spp passes it folds
    (sample_index 0..3, same frame seed) — replicated via render_pallas
    directly, which exposes sample_index."""
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops.pallas.megakernel import render_pallas

    scene = base_scene()
    cfg = _cfg(spp=4, backend="pallas")
    img = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(1)))
    assert np.all(np.isfinite(img))

    cam = derive_camera(BASE_CAMERA, cfg.width, cfg.height)
    samples = [
        np.asarray(render_pallas(
            scene, cam, width=cfg.width, height=cfg.height,
            sample_index=jnp.uint32(s), frame_seed=jnp.uint32(1),
            max_depth=cfg.max_depth, t_min=cfg.t_min, t_max=cfg.t_max,
        ))
        for s in range(4)
    ]
    np.testing.assert_allclose(np.mean(samples, axis=0), img, atol=1e-5)


def test_pallas_nee_many_lights_matches_jax_mean():
    """6 emissive lights takes the megakernel's pick-one-per-(sample, bounce)
    NEE branch; its image mean must agree with the jax path's per-lane
    pick-one estimator (both unbiased estimators of the same integral)."""
    from tests.test_integrators import _many_lights_fixture

    lights, scene_with = _many_lights_fixture()
    scene = scene_with(lights)
    cam = CameraSettings(
        look_from=jnp.asarray([0.0, 2.0, 6.0]),
        look_at=jnp.asarray([0.0, 0.5, 0.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(50.0),
        defocus_angle=jnp.float32(0.0),
        focus_distance=jnp.float32(6.0),
    )
    kw = dict(width=64, height=32, spp=8, max_depth=3, nee=True,
              sky_intensity=0.0)
    a = np.asarray(render(scene, cam, _cfg(backend="pallas", **kw),
                          frame_seed=jnp.uint32(5)))
    b = np.asarray(render(scene, cam, _cfg(backend="jax", **kw),
                          frame_seed=jnp.uint32(5)))
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    # Different pick strategies (per sample-bounce vs per lane) -> different
    # streams; compare means, not pixels.
    np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.1)
    assert a.mean() > 0.01  # lights actually illuminate the frame


def test_pallas_non_tile_aligned_resolution():
    """Width*height not a multiple of the pixel block: padding must be
    transparent."""
    scene = base_scene()
    cfg_p = _cfg(width=50, height=31, backend="pallas")
    cfg_j = _cfg(width=50, height=31, backend="jax")
    a = np.asarray(render(scene, BASE_CAMERA, cfg_p, frame_seed=jnp.uint32(2)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg_j, frame_seed=jnp.uint32(2)))
    assert a.shape == (31, 50, 3)
    assert_images_match(a, b, flip_frac=0.02, mean_tol=5e-4)


def test_pallas_requires_hash_rng():
    import pytest

    with pytest.raises(ValueError):
        RenderConfig(backend="pallas", rng="threefry")
    with pytest.raises(ValueError):
        RenderConfig(backend="pallas", rng="wgsl")


def test_pallas_mesh_scene_matches_jax():
    """Tile-coherent in-kernel BVH traversal == the XLA traversal."""
    from gpu_ray_tracing import make_scene, transform_mesh
    from gpu_ray_tracing.models.mesh import icosphere
    from gpu_ray_tracing.models.spheres import LAMBERTIAN, METAL, make_spheres

    spheres = make_spheres(
        [
            ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0),
            ((-1.5, 0.5, -1.0), 0.5, METAL, (0.9, 0.9, 0.9), 0.05),
        ]
    )
    mesh = transform_mesh(
        icosphere(2, albedo=(0.8, 0.4, 0.2)), scale=0.7, translate=(0.0, 0.7, 0.0)
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
    for integ in ("normal", "path"):
        cfg_p = _cfg(width=64, height=48, max_depth=5, integrator=integ, backend="pallas")
        cfg_j = _cfg(width=64, height=48, max_depth=5, integrator=integ, backend="jax")
        a = np.asarray(render(scene, cam, cfg_p, frame_seed=jnp.uint32(1)))
        b = np.asarray(render(scene, cam, cfg_j, frame_seed=jnp.uint32(1)))
        assert np.all(np.isfinite(a)), integ
        assert_images_match(a, b, flip_frac=0.02, mean_tol=2e-3)


def test_pallas_mesh_requires_bvh():
    from gpu_ray_tracing.models.mesh import box
    from gpu_ray_tracing.models.scene import Scene

    scene = Scene(spheres=base_scene(), mesh=box(), bvh=None)
    cfg = _cfg(backend="pallas")
    with pytest.raises(ValueError):
        render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(0))


def test_pallas_sphere_bvh_matches_bruteforce():
    """The culled sphere-BVH kernel must match the brute-force scan.
    sphere_bvh=True forces the BVH (197 spheres sits below the default
    threshold of 256)."""
    from gpu_ray_tracing import make_scene

    spheres = one_weekend_scene(jax.random.key(0))
    scene = make_scene(spheres, sphere_bvh=True)
    assert scene.sphere_bvh is not None
    cam = CameraSettings.default()
    cfg = _cfg(width=64, height=40, max_depth=6, backend="pallas")
    a = np.asarray(render(scene, cam, cfg, frame_seed=jnp.uint32(2)))
    b = np.asarray(render(spheres, cam, cfg, frame_seed=jnp.uint32(2)))
    assert np.all(np.isfinite(a))
    assert_images_match(a, b, flip_frac=0.02, mean_tol=2e-3)


def test_sphere_bvh_structure():
    from gpu_ray_tracing.ops.bvh import build_sphere_bvh, validate_bvh

    spheres = one_weekend_scene(jax.random.key(1)).pad_to_multiple(128)
    reordered, bvh = build_sphere_bvh(spheres)
    n_active = int(np.asarray(spheres.radii > 0).sum())
    validate_bvh(bvh, n_active)
    # Pads stay at the tail, outside all leaves.
    r = np.asarray(reordered.radii)
    assert np.all(r[:n_active] > 0) and np.all(r[n_active:] == 0)


def test_pallas_emissive_matches_jax():
    """Emissive + dark-sky scene agrees across backends."""
    from gpu_ray_tracing.models.spheres import EMISSIVE, LAMBERTIAN, make_spheres

    scene = make_spheres(
        [
            ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
            ((0.0, 1.2, -2.0), 0.6, EMISSIVE, (1.0, 0.8, 0.5), 5.0),
        ]
    )
    cfg_p = _cfg(width=48, height=32, spp=4, max_depth=6, backend="pallas")
    cfg_j = _cfg(width=48, height=32, spp=4, max_depth=6, backend="jax")
    import dataclasses

    cfg_p = dataclasses.replace(cfg_p, sky_intensity=0.0)
    cfg_j = dataclasses.replace(cfg_j, sky_intensity=0.0)
    a = np.asarray(render(scene, BASE_CAMERA, cfg_p, frame_seed=jnp.uint32(3)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg_j, frame_seed=jnp.uint32(3)))
    assert a.max() > 1.0  # the light is visible and HDR
    assert_images_match(a, b, flip_frac=0.02, mean_tol=2e-3)


def test_pallas_smooth_mesh_matches_jax():
    """Smooth vertex normals: interpolation in the triangle-table leaf scan must
    match the jax path's post-hit interpolation."""
    from gpu_ray_tracing import make_scene
    from gpu_ray_tracing.models.mesh import icosphere, transform_mesh
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
        look_at=jnp.asarray([0.0, 0.7, 0.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(40.0),
        defocus_angle=jnp.float32(0.0),
        focus_distance=jnp.float32(3.0),
    )
    for integ in ("normal", "path"):
        cfg_p = _cfg(width=64, height=48, max_depth=4, integrator=integ, backend="pallas")
        cfg_j = _cfg(width=64, height=48, max_depth=4, integrator=integ, backend="jax")
        a = np.asarray(render(scene, cam, cfg_p, frame_seed=jnp.uint32(1)))
        b = np.asarray(render(scene, cam, cfg_j, frame_seed=jnp.uint32(1)))
        assert np.all(np.isfinite(a)), integ
        assert_images_match(a, b, flip_frac=0.02, mean_tol=2e-3)


def test_pallas_backend_is_differentiable():
    """backend='pallas' must support jax.grad: the custom VJP replays the
    jax integrator (identical hash stream) for the backward pass."""
    import dataclasses

    scene = base_scene()
    cfg_p = _cfg(width=48, height=32, spp=2, max_depth=4, backend="pallas")
    cfg_j = _cfg(width=48, height=32, spp=2, max_depth=4, backend="jax")
    target = render(scene, BASE_CAMERA, cfg_j, frame_seed=jnp.uint32(0))

    def loss(albedo, cfg):
        s = dataclasses.replace(scene, albedo=albedo)
        img = render(s, BASE_CAMERA, cfg, frame_seed=jnp.uint32(1))
        return jnp.mean((img - target) ** 2)

    vp, gp = jax.value_and_grad(loss)(scene.albedo, cfg_p)
    vj, gj = jax.value_and_grad(loss)(scene.albedo, cfg_j)
    assert np.isfinite(np.asarray(gp)).all()
    assert float(jnp.linalg.norm(gp)) > 0.0
    # Backward replays the same stream -> gradients match the jax backend.
    np.testing.assert_allclose(np.asarray(gp), np.asarray(gj), rtol=1e-4, atol=1e-9)
    # The forward VALUE comes from the pallas kernel.
    np.testing.assert_allclose(float(vp), float(vj), rtol=1e-4)


def test_stratified_sampler_matches_across_engines():
    """sampler='stratified' is part of the shared counter-RNG stream: the
    megakernel and wavefront engines draw it identically (bitwise), and the
    jax path agrees up to the documented decision-flip contract."""
    scene = base_scene()
    cam = CameraSettings(
        look_from=jnp.asarray([0.0, 0.0, 1.0]),
        look_at=jnp.asarray([0.0, 0.0, -1.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(60.0),
        defocus_angle=jnp.float32(0.3),  # defocus draws ride along unchanged
        focus_distance=jnp.float32(2.0),
    )
    imgs = {}
    for be in ("jax", "pallas", "wavefront"):
        cfg = _cfg(spp=4, max_depth=4, backend=be, sampler="stratified")
        imgs[be] = np.asarray(render(scene, cam, cfg, frame_seed=jnp.uint32(7)))
    np.testing.assert_array_equal(imgs["pallas"], imgs["wavefront"])
    assert_images_match(imgs["jax"], imgs["pallas"], flip_frac=0.01, mean_tol=2e-4)
    # And it actually changes the jitter stream vs the independent sampler.
    cfg_i = _cfg(spp=4, max_depth=4, backend="pallas", sampler="independent")
    img_i = np.asarray(render(scene, cam, cfg_i, frame_seed=jnp.uint32(7)))
    assert not np.array_equal(img_i, imgs["pallas"])


def test_stratified_lens_pair_matches_across_engines():
    """Wide-aperture defocus exercises the stratified lens remap (salt-7
    rotation) in both raygen implementations; engines must stay identical."""
    scene = base_scene()
    cam = CameraSettings(
        look_from=jnp.asarray([0.0, 0.0, 1.0]),
        look_at=jnp.asarray([0.0, 0.0, -1.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(60.0),
        defocus_angle=jnp.float32(12.0),
        focus_distance=jnp.float32(2.0),
    )
    cfg_p = _cfg(spp=4, max_depth=3, backend="pallas", sampler="stratified")
    cfg_j = _cfg(spp=4, max_depth=3, backend="jax", sampler="stratified")
    a = np.asarray(render(scene, cam, cfg_p, frame_seed=jnp.uint32(11)))
    b = np.asarray(render(scene, cam, cfg_j, frame_seed=jnp.uint32(11)))
    assert_images_match(a, b, flip_frac=0.01, mean_tol=2e-4)


def test_stratified_nee_matches_across_engines():
    """NEE + stratified sampler: the first-bounce cone-sample remap (salt
    8+l rotations) must draw identically in the jax integrator and the
    shared Pallas bounce physics."""
    from gpu_ray_tracing import make_scene
    from gpu_ray_tracing.models.spheres import EMISSIVE, LAMBERTIAN, make_spheres

    scene = make_scene(make_spheres(
        [
            ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
            ((-0.6, 0.35, -2.2), 0.35, LAMBERTIAN, (0.8, 0.3, 0.3), 0.0),
            ((0.0, 2.0, -2.0), 1.2, EMISSIVE, (1.0, 0.9, 0.7), 3.0),
        ]
    ))
    imgs = {}
    for be in ("jax", "pallas", "wavefront"):
        cfg = _cfg(
            width=48, height=32, spp=4, max_depth=4, backend=be,
            sampler="stratified", nee=True, sky_intensity=0.0,
        )
        imgs[be] = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(5)))
    # On the CPU interpret path the two engines' NEE term accumulation fuses
    # differently (FMA contraction) and drifts ~1 ULP on this emissive scene —
    # measured identically WITHOUT the stratified remap, so it is not a stream
    # divergence.  Allow float noise
    # only; any stream divergence would be orders of magnitude larger.
    np.testing.assert_allclose(
        imgs["pallas"], imgs["wavefront"], rtol=1e-5, atol=1e-6
    )
    assert_images_match(imgs["jax"], imgs["pallas"], flip_frac=0.02, mean_tol=2e-3)


def test_sobol_sampler_matches_across_engines():
    """sampler='sobol' is elementwise u32 bit math on the shared counter
    stream: the megakernel and wavefront engines draw it identically
    (bitwise), the jax path agrees up to the flip contract, and the mode
    actually changes the stream."""
    scene = base_scene()
    cam = CameraSettings(
        look_from=jnp.asarray([0.0, 0.0, 1.0]),
        look_at=jnp.asarray([0.0, 0.0, -1.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(60.0),
        defocus_angle=jnp.float32(0.3),  # exercises the lens pair too
        focus_distance=jnp.float32(2.0),
    )
    imgs = {}
    for be in ("jax", "pallas", "wavefront"):
        cfg = _cfg(spp=4, max_depth=4, backend=be, sampler="sobol")
        imgs[be] = np.asarray(render(scene, cam, cfg, frame_seed=jnp.uint32(7)))
    np.testing.assert_array_equal(imgs["pallas"], imgs["wavefront"])
    assert_images_match(imgs["jax"], imgs["pallas"], flip_frac=0.01, mean_tol=2e-4)
    for other in ("independent", "stratified"):
        cfg_o = _cfg(spp=4, max_depth=4, backend="pallas", sampler=other)
        img_o = np.asarray(render(scene, cam, cfg_o, frame_seed=jnp.uint32(7)))
        assert not np.array_equal(img_o, imgs["pallas"])


def test_adaptive_prefix_property():
    """With a huge tolerance every tile stops exactly at adaptive_min_spp,
    and because adaptive samples are a PREFIX of the identical stream the
    image equals the fixed render at spp=min_spp bitwise."""
    scene = base_scene()
    cfg_ad = _cfg(spp=16, max_depth=4, backend="pallas",
                  adaptive_tol=1e6, adaptive_min_spp=4)
    cfg_4 = _cfg(spp=4, max_depth=4, backend="pallas")
    a = np.asarray(render(scene, BASE_CAMERA, cfg_ad, frame_seed=jnp.uint32(2)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg_4, frame_seed=jnp.uint32(2)))
    np.testing.assert_array_equal(a, b)


def test_adaptive_spp_map_and_quality():
    """A tight tolerance keeps the image near the full-budget render while
    the per-tile counts actually vary (sky tiles stop before the budget)."""
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops.pallas.megakernel import render_pallas

    scene = one_weekend_scene(jax.random.key(0))
    cam = CameraSettings.default()
    w, h, spp = 128, 96, 32
    full = np.asarray(render(
        scene, cam, _cfg(width=w, height=h, spp=spp, max_depth=6, backend="pallas"),
        frame_seed=jnp.uint32(1)))
    img, smap = render_pallas(
        scene, derive_camera(cam, w, h), width=w, height=h,
        sample_index=jnp.uint32(0), frame_seed=jnp.uint32(1), max_depth=6,
        t_min=1e-3, spp=spp, adaptive_tol=0.03, adaptive_min_spp=4,
        return_spp_map=True)
    img, smap = np.asarray(img), np.asarray(smap)
    assert np.isfinite(img).all()
    assert smap.min() >= 4 and smap.max() <= spp
    assert smap.min() < smap.max()  # counts actually adapt
    # Constant within each pixel block of the kernel.
    from gpu_ray_tracing.ops.pallas import megakernel as mk

    br, bc, _ = mk.block_shape("path")
    for i in range(0, h, br):
        for j in range(0, w, bc):
            assert np.unique(smap[i:i + br, j:j + bc]).size == 1, (i, j)
    rel = np.abs(img - full).mean() / full.mean()
    assert rel < 0.02, rel


def test_adaptive_config_validation():
    import pytest

    with pytest.raises(ValueError, match="adaptive_tol"):
        _cfg(adaptive_tol=-0.1, backend="pallas")
    with pytest.raises(ValueError, match="megakernel"):
        _cfg(adaptive_tol=0.05, backend="jax")
    with pytest.raises(ValueError, match="adaptive_min_spp"):
        _cfg(adaptive_tol=0.05, adaptive_min_spp=1, backend="pallas")


def test_adaptive_rejected_for_progressive_and_sharded():
    import pytest

    from gpu_ray_tracing import init_accum, progressive_step
    from gpu_ray_tracing.parallel.mesh import make_mesh
    from gpu_ray_tracing.parallel.sharding import render_sharded

    scene = base_scene()
    cfg = _cfg(spp=8, backend="pallas", adaptive_tol=0.05)
    st = init_accum(cfg.height, cfg.width)
    with pytest.raises(ValueError, match="adaptive"):
        progressive_step(st, scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(0))
    with pytest.raises(ValueError, match="adaptive"):
        render_sharded(scene, BASE_CAMERA, cfg, make_mesh(4, 2),
                       frame_seed=jnp.uint32(0))


def test_adaptive_progressive_matches_one_shot():
    """Chunked adaptive progressive steps reproduce the one-shot adaptive
    render BITWISE on the same budget: the carried
    Welford state makes the kernel's stopping test identical at every
    absolute sample index, so converged tiles stop at the same sample in
    both runs and the raw sums accumulate in the same order."""
    from gpu_ray_tracing import adaptive_progressive_step, init_adaptive_accum

    scene = one_weekend_scene(jax.random.key(0))
    cam = CameraSettings.default()
    cfg = _cfg(width=128, height=96, spp=32, max_depth=6, backend="pallas",
               adaptive_tol=0.03, adaptive_min_spp=4)
    one_shot = np.asarray(render(scene, cam, cfg, frame_seed=jnp.uint32(1)))

    st = init_adaptive_accum(cfg.height, cfg.width)
    for _ in range(4):  # 4 steps x 8 spp/step = the 32-spp budget
        st = adaptive_progressive_step(
            st, scene, cam, cfg, frame_seed=jnp.uint32(1), spp_per_step=8)
    np.testing.assert_array_equal(np.asarray(st.image), one_shot)
    # Converged tiles genuinely stop early (counts adapt within budget),
    # so later steps relaunch them as immediate exits.
    cnt = np.asarray(st.count)
    assert cnt.min() >= 4 and cnt.max() <= 32 and cnt.min() < cnt.max()
    # Extra steps past the budget are no-ops: every tile is at its stop.
    st2 = adaptive_progressive_step(
        st, scene, cam, cfg, frame_seed=jnp.uint32(1), spp_per_step=8)
    np.testing.assert_array_equal(np.asarray(st2.count), cnt)
    np.testing.assert_array_equal(np.asarray(st2.image), one_shot)


def test_adaptive_progressive_validation():
    from gpu_ray_tracing import adaptive_progressive_step, init_adaptive_accum

    scene = base_scene()
    st = init_adaptive_accum(48, 64)
    with pytest.raises(ValueError, match="adaptive_tol"):
        adaptive_progressive_step(
            st, scene, BASE_CAMERA, _cfg(spp=8, backend="pallas"),
            frame_seed=jnp.uint32(0))
    with pytest.raises(ValueError, match="megakernel"):
        # The config itself rejects adaptive on non-pallas backends.
        _cfg(spp=8, backend="wavefront", adaptive_tol=0.05)
    with pytest.raises(ValueError, match="path integrator"):
        adaptive_progressive_step(
            st, scene, BASE_CAMERA,
            _cfg(spp=8, backend="pallas", adaptive_tol=0.05,
                 integrator="normal"),
            frame_seed=jnp.uint32(0))


def test_mis_matches_across_engines():
    """nee+mis: the MIS weights live in the shared bounce physics; the
    engines must agree (the extra prev_cos plane is appended LAST so the
    mis=False programs are byte-identical to before)."""
    from gpu_ray_tracing import make_scene
    from gpu_ray_tracing.models.spheres import (
        EMISSIVE, LAMBERTIAN, METAL, make_spheres,
    )

    scene = make_scene(make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((-0.6, 0.35, -2.2), 0.35, LAMBERTIAN, (0.8, 0.3, 0.3), 0.0),
        ((0.6, 0.3, -2.0), 0.3, METAL, (0.8, 0.8, 0.9), 0.1),
        ((0.0, 1.6, -2.0), 1.2, EMISSIVE, (1.0, 0.9, 0.7), 2.0),
    ]))
    imgs = {}
    for be in ("jax", "pallas", "wavefront"):
        cfg = _cfg(width=48, height=32, spp=4, max_depth=5, backend=be,
                   nee=True, mis=True, sky_intensity=0.0)
        imgs[be] = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(5)))
        assert np.isfinite(imgs[be]).all(), be
    # 1-ULP tolerance for the CPU interpret path's fusion differences;
    # any estimator divergence
    # would be orders of magnitude larger.
    np.testing.assert_allclose(imgs["pallas"], imgs["wavefront"], rtol=1e-5, atol=1e-6)
    assert_images_match(imgs["jax"], imgs["pallas"], flip_frac=0.02, mean_tol=2e-3)
    # The regenerating pool carries the prev_cos plane through refills too.
    cfg_r = _cfg(width=48, height=32, spp=4, max_depth=5, backend="wavefront",
                 nee=True, mis=True, sky_intensity=0.0, regenerate="on")
    img_r = np.asarray(render(scene, BASE_CAMERA, cfg_r, frame_seed=jnp.uint32(5)))
    np.testing.assert_allclose(img_r, imgs["wavefront"], rtol=1e-5, atol=1e-5)


def test_mis_light_id_planes():
    """The scene's _LIGHTID row: the l-th active emissive sphere in array
    order is light l (the exact order extract_lights emits); everything
    else -1.  This is the identity the MIS weight keys on — no geometric
    tolerance anywhere."""
    from gpu_ray_tracing.models.scene import extract_lights
    from gpu_ray_tracing.models.spheres import (
        EMISSIVE, LAMBERTIAN, METAL, make_spheres,
    )
    from gpu_ray_tracing.ops.pallas.megakernel import _LIGHTID, scene_planes

    spheres = make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((0.0, 2.0, -2.0), 0.5, EMISSIVE, (1.0, 0.9, 0.7), 4.0),
        ((0.6, 0.3, -2.0), 0.3, METAL, (0.8, 0.8, 0.9), 0.1),
        ((3.0, 1.0, -1.0), 0.0, EMISSIVE, (1.0, 1.0, 1.0), 9.0),  # r=0: inactive
        ((-2.0, 1.5, -3.0), 0.4, EMISSIVE, (0.4, 0.6, 1.0), 6.0),
    ])
    lid = np.asarray(scene_planes(spheres)[_LIGHTID])
    np.testing.assert_array_equal(lid, [-1.0, 0.0, -1.0, -1.0, 1.0])
    lights = extract_lights(spheres)
    assert lights.count == 2
    np.testing.assert_array_equal(
        np.asarray(lights.centers), [[0.0, 2.0, -2.0], [-2.0, 1.5, -3.0]]
    )


def test_mis_tangent_lights_exact_identity():
    """Two tangent lights — a small bright sphere whose CENTER sits on a
    big dim light's shell, so every hit on the small light lies within the
    old r3 geometric tolerance of the big one (|d2p - r^2| <= 1e-2 r^2
    would mis-attribute ALL of them).  With identity matching the engines
    must agree and the estimator must stay finite and unbiased in shape."""
    from gpu_ray_tracing import make_scene
    from gpu_ray_tracing.models.spheres import (
        EMISSIVE, LAMBERTIAN, make_spheres,
    )

    # Big light: center (0, 7, -2) r=4.  Small light: center on its shell
    # at (0, 3, -2), r=0.12 — well inside the 1e-2 relative-d2 band.
    scene = make_scene(make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((-0.6, 0.35, -2.2), 0.35, LAMBERTIAN, (0.8, 0.3, 0.3), 0.0),
        ((0.0, 7.0, -2.0), 4.0, EMISSIVE, (1.0, 0.9, 0.7), 0.4),
        ((0.0, 3.0, -2.0), 0.12, EMISSIVE, (1.0, 0.7, 0.3), 60.0),
    ]))
    imgs = {}
    for be in ("jax", "pallas", "wavefront"):
        cfg = _cfg(width=48, height=32, spp=8, max_depth=5, backend=be,
                   nee=True, mis=True, sky_intensity=0.0)
        imgs[be] = np.asarray(render(scene, BASE_CAMERA, cfg,
                                     frame_seed=jnp.uint32(11)))
        assert np.isfinite(imgs[be]).all(), be
        assert imgs[be].mean() > 1e-3, be  # the lights actually contribute
    np.testing.assert_allclose(imgs["pallas"], imgs["wavefront"],
                               rtol=1e-5, atol=1e-6)
    assert_images_match(imgs["jax"], imgs["pallas"], flip_frac=0.02, mean_tol=2e-3)


def test_ray_counters_analytic():
    """In-kernel traced-ray counters against hand-derivable cases: (a) all-sky rays trace exactly spp rays/pixel; (b) a camera
    staring at an infinite diffuse ground traces exactly 2 rays/sample at
    depth 2 (primary + one scattered ray that then misses), and exactly 3
    with one valid NEE light (one driven shadow ray at the diffuse hit)."""
    from gpu_ray_tracing import count_traced_rays, make_scene
    from gpu_ray_tracing.models.camera import CameraSettings
    from gpu_ray_tracing.models.spheres import (
        EMISSIVE, LAMBERTIAN, make_spheres,
    )

    ground = make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0),
    ])
    up = CameraSettings.default().replace(
        look_from=jnp.asarray([0.0, 2.0, 0.0]),
        look_at=jnp.asarray([0.0, 10.0, 0.0]),
        vup=jnp.asarray([0.0, 0.0, 1.0]),
        defocus_angle=jnp.float32(0.0),
    )
    cfg = RenderConfig(width=48, height=32, spp=4, max_depth=6, backend="pallas")
    r = count_traced_rays(ground, up, cfg, frame_seed=jnp.uint32(3))
    assert r["rays_traced"] == r["primary_rays"] == 48 * 32 * 4

    down = CameraSettings.default().replace(
        look_from=jnp.asarray([0.0, 2.0, 0.0]),
        look_at=jnp.asarray([0.0, 0.0, 0.0]),
        vup=jnp.asarray([0.0, 0.0, 1.0]),
        field_of_view=jnp.float32(40.0),
        defocus_angle=jnp.float32(0.0),
    )
    cfg2 = RenderConfig(width=48, height=32, spp=4, max_depth=2, backend="pallas")
    r2 = count_traced_rays(ground, down, cfg2, frame_seed=jnp.uint32(3))
    assert r2["rays_traced"] == 2 * r2["primary_rays"], r2

    lit = make_scene(make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 50.0, 0.0), 5.0, EMISSIVE, (1.0, 1.0, 1.0), 4.0),
    ]))
    cfg3 = RenderConfig(width=48, height=32, spp=4, max_depth=2,
                        backend="pallas", nee=True, sky_intensity=0.0)
    r3 = count_traced_rays(lit, down, cfg3, frame_seed=jnp.uint32(3))
    assert r3["rays_traced"] == 3 * r3["primary_rays"], r3


def _jax_ray_count(scene, cam, w, h, spp, depth, frame_seed, **kw):
    """Independent trace_path counters summed over the same sample stream."""
    from gpu_ray_tracing.ops import rays as rays_ops
    from gpu_ray_tracing.ops.integrators import trace_path

    total = np.zeros((h, w), np.float32)
    for s in range(spp):
        o, d, seeds = rays_ops.generate_rays_hash(
            cam, w, h, jnp.uint32(s), jnp.uint32(frame_seed))
        _, rays = trace_path(
            o, d, scene, depth, 1e-3, 3.4e35, pixel_seeds=seeds,
            count_rays=True, **kw)
        total += np.asarray(rays)
    return total


def test_ray_counters_match_across_engines():
    """Counter agreement across engines.  On a flip-free scene (diffuse
    only, shallow depth) the megakernel's in-kernel counters equal the
    independent trace_path counters EXACTLY per pixel.  On a mixed scene
    (dielectric + NEE + RR, depth 6) megakernel == wavefront stays exact
    (shared bounce physics) while megakernel vs jax may differ per pixel
    through the known CPU-interpret ULP decision flips (the same flips
    assert_images_match tolerates on images) — totals must still agree to
    well under 1%."""
    from gpu_ray_tracing import count_traced_rays, make_scene
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.models.spheres import (
        DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL, make_spheres,
    )
    from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

    w, h, spp = 48, 32, 4
    cam = derive_camera(BASE_CAMERA, w, h)

    # Exact identity: diffuse-only scene, depth 3 (no decision flips).
    simple = make_scene(make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((-0.6, 0.35, -2.2), 0.35, LAMBERTIAN, (0.8, 0.3, 0.3), 0.0),
    ]))
    cfg = RenderConfig(width=w, height=h, spp=spp, max_depth=3,
                       backend="pallas")
    kern = count_traced_rays(simple, cam, cfg, frame_seed=jnp.uint32(7),
                             return_map=True)
    jax_map = _jax_ray_count(simple, cam, w, h, spp, 3, 7)
    np.testing.assert_array_equal(np.asarray(kern["map"]), jax_map)
    assert kern["rays_traced"] == float(jax_map.sum(dtype=np.float64))

    # Mixed scene: megakernel == wavefront exactly; totals vs jax < 1%.
    scene = make_scene(make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((-0.6, 0.35, -2.2), 0.35, LAMBERTIAN, (0.8, 0.3, 0.3), 0.0),
        ((0.6, 0.3, -2.0), 0.3, METAL, (0.8, 0.8, 0.9), 0.1),
        ((0.0, 0.4, -1.2), 0.4, DIELECTRIC, (1, 1, 1), 1.5),
        ((0.0, 1.8, -2.0), 0.7, EMISSIVE, (1.0, 0.9, 0.7), 3.0),
    ]))
    depth = 6
    cfg2 = RenderConfig(width=w, height=h, spp=spp, max_depth=depth,
                        backend="pallas", nee=True, russian_roulette_depth=3)
    kern2 = count_traced_rays(scene, cam, cfg2, frame_seed=jnp.uint32(7),
                              return_map=True)
    _, wf_map = render_wavefront(
        scene, cam, width=w, height=h, sample_index=jnp.uint32(0),
        frame_seed=jnp.uint32(7), max_depth=depth, t_min=cfg2.t_min,
        t_max=cfg2.t_max, russian_roulette_depth=3, nee=True, spp=spp,
        return_ray_count=True)
    np.testing.assert_array_equal(np.asarray(kern2["map"]), np.asarray(wf_map))
    jax_total = float(
        _jax_ray_count(scene, cam, w, h, spp, depth, 7, nee=True,
                       russian_roulette_depth=3).sum(dtype=np.float64)
    )
    assert abs(kern2["rays_traced"] - jax_total) < 0.01 * jax_total
    # Bounce rays strictly exceed primaries on this scene (depth > 1 work).
    assert kern2["rays_traced"] > 1.5 * kern2["primary_rays"]


def test_aov_modes_match_across_engines():
    """integrator='albedo'/'depth' (first-hit AOV guide channels): all
    engines agree (wavefront falls back to the bounce-free megakernel),
    and the values are semantically right — the base scene's center sphere
    (z=-1, r=0.5, camera at z=+1) sits exactly 1.5 units away, and its
    albedo is the material's stored albedo."""
    scene = base_scene()
    for integ in ("albedo", "depth"):
        imgs = {}
        for be in ("jax", "pallas", "wavefront"):
            cfg = _cfg(integrator=integ, backend=be, spp=1)
            imgs[be] = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(0)))
        np.testing.assert_array_equal(imgs["pallas"], imgs["wavefront"])
        np.testing.assert_allclose(imgs["jax"], imgs["pallas"], rtol=1e-5, atol=5e-6)
    d = np.asarray(render(scene, BASE_CAMERA, _cfg(integrator="depth"),
                          frame_seed=jnp.uint32(0)))
    assert abs(d[24, 32, 0] - 1.5) < 0.01, d[24, 32, 0]  # head-on hit
    assert d[0, 0, 0] == 0.0  # sky
    a = np.asarray(render(scene, BASE_CAMERA, _cfg(integrator="albedo"),
                          frame_seed=jnp.uint32(0)))
    np.testing.assert_allclose(
        a[24, 32], np.asarray(scene.albedo)[
            int(np.argmin(np.abs(np.asarray(scene.centers)[:, 2] + 1.0)))
        ], atol=1e-5)


@pytest.mark.parametrize("block", [(8, 32, 2), (16, 32, 4)])
def test_block_shape_is_bitwise_invisible(monkeypatch, block):
    """Every draw is a function of the global pixel id, so on a brute-scan
    scene the pixel block shape (rows x cols, warps) must
    leave a path render BITWISE unchanged — including frames that do not
    divide into whole blocks.  clear_caches between renders: the shape is
    a module constant consumed at trace time, not part of any jit key."""
    from gpu_ray_tracing.ops.pallas import megakernel as mk

    scene = base_scene()
    cfg = _cfg(width=40, height=20, spp=2, max_depth=6, backend="pallas")
    ref = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(3)))
    monkeypatch.setattr(mk, "PATH_BLOCK", block)
    jax.clear_caches()
    img = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(3)))
    jax.clear_caches()
    np.testing.assert_array_equal(ref, img)


@pytest.mark.parametrize("integrator", ["normal", "albedo", "depth"])
def test_aov_block_shape_is_bitwise_invisible(monkeypatch, integrator):
    """The AOV modes have their own block; it too must leave the image
    bitwise unchanged."""
    from gpu_ray_tracing.ops.pallas import megakernel as mk

    scene = base_scene()
    cfg = _cfg(width=40, height=20, spp=2, integrator=integrator, backend="pallas")
    ref = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(3)))
    monkeypatch.setattr(mk, "AOV_BLOCK", (2, 16, 1))
    assert mk.block_shape(integrator) == (2, 16, 1)
    jax.clear_caches()
    img = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(3)))
    jax.clear_caches()
    np.testing.assert_array_equal(ref, img)
