"""Tests for the integrators (wgsl:261-297) and sky shader (wgsl:293-296)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing.models.spheres import (
    DIELECTRIC,
    LAMBERTIAN,
    METAL,
    base_scene,
    make_spheres,
)
from gpu_ray_tracing.ops.integrators import (
    make_bounce_seeds,
    shade_normals,
    sky_color,
    trace_path,
)
from gpu_ray_tracing.ops.rng import wgsl_hash

TMIN, TMAX = 1e-3, 3.4e35


def test_sky_gradient_endpoints():
    up = np.asarray(sky_color(jnp.asarray([[0.0, 1.0, 0.0]])))[0]
    down = np.asarray(sky_color(jnp.asarray([[0.0, -1.0, 0.0]])))[0]
    np.testing.assert_allclose(up, [0.5, 0.7, 1.0], atol=1e-6)
    np.testing.assert_allclose(down, [1.0, 1.0, 1.0], atol=1e-6)
    horiz = np.asarray(sky_color(jnp.asarray([[1.0, 0.0, 0.0]])))[0]
    np.testing.assert_allclose(horiz, [0.75, 0.85, 1.0], atol=1e-6)


def test_sky_ignores_direction_magnitude():
    a = np.asarray(sky_color(jnp.asarray([[0.0, 0.5, 0.5]])))
    b = np.asarray(sky_color(jnp.asarray([[0.0, 5.0, 5.0]])))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_normal_shading_hit_and_miss():
    scene = base_scene()
    origins = jnp.zeros((2, 3), jnp.float32)
    dirs = jnp.asarray([[0, 0, -1], [0, 1, 0]], jnp.float32)
    img = np.asarray(shade_normals(origins, dirs, scene, TMIN, TMAX))
    # Head-on hit of the center sphere: normal (0,0,1) -> color (0.5,0.5,1.0).
    np.testing.assert_allclose(img[0], [0.5, 0.5, 1.0], atol=1e-5)
    np.testing.assert_allclose(img[1], [0.5, 0.7, 1.0], atol=1e-5)  # sky


def _trace(origins, dirs, scene, depth=8, key=None, seeds=None, parity=False):
    return np.asarray(
        trace_path(
            jnp.asarray(origins, jnp.float32),
            jnp.asarray(dirs, jnp.float32),
            scene,
            depth,
            TMIN,
            TMAX,
            key=key,
            bounce_seeds=seeds,
            parity=parity,
        )
    )


def test_miss_returns_sky():
    scene = base_scene()
    out = _trace([[0, 5, 0]], [[0, 1, 0]], scene, key=jax.random.key(0))
    np.testing.assert_allclose(out[0], [0.5, 0.7, 1.0], atol=1e-5)


def test_energy_conservation():
    """Path-traced radiance is bounded by the max sky radiance (all albedos
    <= 1, sky <= 1 per channel)."""
    scene = base_scene()
    rng = np.random.default_rng(1)
    origins = np.tile([0.0, 0.5, 2.0], (256, 1))
    dirs = rng.normal(size=(256, 3))
    out = _trace(origins, dirs, scene, depth=16, key=jax.random.key(2))
    assert np.all(out >= 0.0)
    assert np.all(out <= 1.0 + 1e-5)


def test_lambertian_single_bounce_exact():
    """Depth-1 path on a lambertian floor: color = albedo * sky(bounce dir)
    with the bounce direction fully determined by the RNG draw; use wgsl
    seeds so the draw is reproducible in the test."""
    scene = make_spheres([((0, -100.0, 0), 99.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    seeds = jnp.asarray([123456], jnp.uint32)
    out = _trace([[0, 5, 0]], [[0, -1, 0]], scene, depth=1, seeds=seeds, parity=True)
    # After 1 bounce the ray is live; parity mode adds sky * throughput.
    from gpu_ray_tracing.ops.rng import random_unit_vector

    uv = np.asarray(random_unit_vector(jnp.uint32(123456)))
    bounce_dir = np.array([0.0, 1.0, 0.0]) + uv  # normal + unit vector
    sky = np.asarray(sky_color(jnp.asarray([bounce_dir], jnp.float32)))[0]
    np.testing.assert_allclose(out[0], 0.5 * sky, atol=1e-4)


def test_depth_exhaustion_black_vs_parity_sky():
    """A ray trapped between two mirrors exhausts max_depth: default mode
    yields black (fixed), parity mode leaks sky (wgsl:293-296 quirk)."""
    mirrors = make_spheres(
        [
            ((0, 0, -5.0), 2.0, METAL, (1.0, 1.0, 1.0), 0.0),
            ((0, 0, 5.0), 2.0, METAL, (1.0, 1.0, 1.0), 0.0),
        ]
    )
    o, d = [[0, 0, 0]], [[0, 0, -1]]
    seeds = jnp.zeros((4,), jnp.uint32)
    out_fixed = _trace(o, d, mirrors, depth=4, seeds=seeds, parity=False)
    np.testing.assert_allclose(out_fixed[0], 0.0, atol=1e-6)
    out_parity = _trace(o, d, mirrors, depth=4, seeds=seeds, parity=True)
    assert np.all(out_parity[0] > 0.1)  # sky leaked through the throughput


def test_metal_mirror_reflects_to_sky():
    """Perfect mirror sphere: the bounced ray picks up sky(reflect(d, n))
    computed from the true sphere normal at the hit point."""
    center, radius = np.array([0.0, -1000.0, 0.0]), 999.0
    scene = make_spheres([(tuple(center), radius, METAL, (1.0, 1.0, 1.0), 0.0)])
    o, d = np.array([0.0, 5.0, 0.0]), np.array([1.0, -1.0, 0.0])
    out = _trace([o], [d], scene, depth=2, key=jax.random.key(0))
    # Exact float64 hit + reflection.
    oc = center - o
    a, h, c = d @ d, oc @ d, oc @ oc - radius**2
    t = (h - np.sqrt(h * h - a * c)) / a
    p = o + t * d
    n = (p - center) / radius
    refl = d - 2 * (d @ n) * n
    expected = np.asarray(sky_color(jnp.asarray([refl], jnp.float32)))[0]
    np.testing.assert_allclose(out[0], expected, atol=1e-3)


def test_glass_sphere_mostly_transmits_head_on():
    """Head-on through a glass sphere: exits parallel, hits sky behind."""
    scene = make_spheres([((0, 0, -3.0), 1.0, DIELECTRIC, (1, 1, 1), 1.5)])

    # u_reflect draws come from the key; average over many keys to wash out
    # the stochastic reflect/refract choice (vmapped in one jitted call).
    @jax.jit
    def many(keys):
        return jax.vmap(lambda k: trace_path(
            jnp.asarray([[0, 0, 0]], jnp.float32),
            jnp.asarray([[0, 0, -1]], jnp.float32),
            scene, 8, TMIN, TMAX, key=k,
        )[0])(keys)

    mean = np.asarray(many(jax.random.split(jax.random.key(7), 32))).mean(axis=0)
    horiz_sky = np.asarray(sky_color(jnp.asarray([[0.0, 0.0, -1.0]])))[0]
    np.testing.assert_allclose(mean, horiz_sky, atol=0.05)


def test_make_bounce_seeds_matches_wgsl_chain():
    base = jnp.uint32(777)
    seeds = np.asarray(make_bounce_seeds(base, 5))
    for i in range(5):
        assert int(seeds[i]) == int(wgsl_hash(jnp.uint32(777 + i * 1000)))


def test_trace_requires_exactly_one_rng():
    scene = base_scene()
    o = jnp.zeros((1, 3))
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    try:
        trace_path(o, d, scene, 2, TMIN, TMAX)
        assert False, "expected ValueError"
    except ValueError:
        pass


def test_parity_rim_defocus_quirk():
    """parity=True samples the defocus disk RIM (wgsl:327-331): all lens
    offsets have radius exactly defocus_radius; parity=False fills the disk."""
    from gpu_ray_tracing.models.camera import CameraSettings, derive_camera
    from gpu_ray_tracing.ops.rays import generate_rays_wgsl

    settings = CameraSettings.default()  # defocus_angle 0.6 deg
    cam = derive_camera(settings, 64, 64)
    disk_r = float(jnp.linalg.norm(cam.defocus_disk_u))

    for parity, expect_rim in [(True, True), (False, False)]:
        o, _ = generate_rays_wgsl(cam, 64, 64, jnp.uint32(5), jnp.uint32(9), parity)
        offsets = np.asarray(o) - np.asarray(cam.center)
        radii = np.linalg.norm(offsets, axis=-1)
        if expect_rim:
            np.testing.assert_allclose(radii, disk_r, rtol=1e-3)
        else:
            assert radii.min() < 0.5 * disk_r  # interior points exist
            assert radii.max() <= disk_r * 1.001


def test_emissive_sphere_radiates():
    """A dark scene lit by an emissive sphere: light pixels at the source,
    illuminated floor nearby, black elsewhere."""
    from gpu_ray_tracing.models.spheres import EMISSIVE

    scene = make_spheres(
        [
            ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
            ((0.0, 1.5, -3.0), 0.8, EMISSIVE, (1.0, 0.9, 0.7), 4.0),
        ]
    )
    # Direct hit on the light: exactly albedo * intensity.
    out = _trace([[0, 1.5, 0]], [[0, 0, -1]], scene, depth=4, key=jax.random.key(0))
    np.testing.assert_allclose(out[0], [4.0, 3.6, 2.8], atol=1e-4)
    # Floor below the light picks up bounce light (sky off).
    out2 = trace_path(
        jnp.asarray([[0.0, 3.0, -3.0]], jnp.float32),
        jnp.asarray([[0.3, -1.0, 0.0]], jnp.float32),
        scene, 6, TMIN, TMAX, key=jax.random.key(1), sky_intensity=0.0,
    )
    # Statistically: average many keys; some paths bounce into the light.
    # (vmapped over keys in ONE jitted call — 64 eager calls cost ~90 s.)
    @jax.jit
    def many(keys):
        return jax.vmap(lambda k: trace_path(
            jnp.asarray([[0.0, 3.0, -3.0]], jnp.float32),
            jnp.asarray([[0.3, -1.0, 0.0]], jnp.float32),
            scene, 6, TMIN, TMAX, key=k, sky_intensity=0.0,
        )[0])(keys)

    mean = np.asarray(many(jax.random.split(jax.random.key(0), 64))).mean(
        axis=0)
    assert mean.max() > 0.01  # some illumination reaches the floor
    # A ray pointing away from everything in a skyless scene is black.
    out3 = np.asarray(trace_path(
        jnp.asarray([[0.0, 3.0, 10.0]], jnp.float32),
        jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
        scene, 4, TMIN, TMAX, key=jax.random.key(2), sky_intensity=0.0,
    ))
    np.testing.assert_allclose(out3[0], 0.0, atol=1e-6)


def test_sky_intensity_scales_miss():
    scene = base_scene()
    full = _trace([[0, 5, 0]], [[0, 1, 0]], scene, key=jax.random.key(0))
    half = np.asarray(trace_path(
        jnp.asarray([[0.0, 5.0, 0.0]], jnp.float32),
        jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32),
        scene, 8, TMIN, TMAX, key=jax.random.key(0), sky_intensity=0.5,
    ))
    np.testing.assert_allclose(half[0], full[0] * 0.5, atol=1e-6)


def test_nee_estimator_matches_analytic_irradiance():
    """For a lambertian point directly below an unoccluded spherical light,
    E[outgoing radiance] = Le * albedo * sin^2(theta_max) (the cosine-weighted
    integral over the spherical cap).  Validates the 2(1-cos_max) estimator
    constant end-to-end."""
    import dataclasses

    from gpu_ray_tracing import make_scene
    from gpu_ray_tracing.models.spheres import EMISSIVE, LAMBERTIAN, make_spheres
    from gpu_ray_tracing.ops.integrators import trace_path

    albedo, le, lr, h = 0.6, 5.0, 0.5, 2.0
    scene = make_scene(make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (albedo,) * 3, 0.0),
        ((0.0, h, 0.0), lr, EMISSIVE, (1.0, 1.0, 1.0), le),
    ]))
    # Rays hitting the floor at the origin, straight down from just above.
    n = 4096
    o = jnp.tile(jnp.asarray([[0.0, 0.5, 0.0]], jnp.float32), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32), (n, 1))
    # Depth 1: only the NEE direct term contributes (bounce ray needs depth 2
    # to reach the light, and sky is off).
    seeds = jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(2654435761)
    out = np.asarray(trace_path(
        o, d, scene, 1, 1e-3, 3.4e35, pixel_seeds=seeds, sky_intensity=0.0, nee=True
    ))
    # Light is at height h above the hit point (floor sphere r=1000 apex at
    # y=0, hit at y~0): distance d0 = h, sin^2 = lr^2/d0^2.
    expected = le * albedo * (lr * lr) / (h * h)
    measured = out.mean(axis=0)
    np.testing.assert_allclose(measured, expected, rtol=0.05)


def _many_lights_fixture():
    """A lambertian floor and 6 spherical lights spread over the upper
    hemisphere, positioned so no light occludes another's shadow ray from
    the probe point (the pick-one vs loop-over-all comparison then sees
    identical visibility)."""
    from gpu_ray_tracing import make_scene
    from gpu_ray_tracing.models.spheres import EMISSIVE, LAMBERTIAN, make_spheres

    albedo = 0.7
    lights = [
        ((0.0, 3.0, 0.0), 0.3, 4.0),
        ((2.5, 2.5, 0.0), 0.2, 6.0),
        ((-2.5, 2.5, 0.0), 0.25, 3.0),
        ((0.0, 2.5, 2.5), 0.2, 5.0),
        ((0.0, 2.5, -2.5), 0.3, 2.0),
        ((1.8, 2.8, 1.8), 0.15, 8.0),
    ]
    floor = ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (albedo,) * 3, 0.0)

    def scene_with(light_subset):
        rows = [floor] + [
            (c, r, EMISSIVE, (1.0, 1.0, 1.0), le) for (c, r, le) in light_subset
        ]
        return make_scene(make_spheres(rows))

    return lights, scene_with


def test_nee_pick_one_light_matches_loop_over_all():
    """>4 lights takes the pick-one-light estimator branch (weight = L
    cancels the 1/L pick pdf); its mean must converge to the sum of
    per-light loop-branch estimates (ops/integrators.py:277)."""
    lights, scene_with = _many_lights_fixture()
    n = 16384
    o = jnp.tile(jnp.asarray([[0.0, 0.5, 0.0]], jnp.float32), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32), (n, 1))
    seeds = jnp.arange(n, dtype=jnp.uint32) * jnp.uint32(2654435761)

    def direct(scene):
        # Depth 1 + sky off: only the NEE direct term contributes.
        return np.asarray(trace_path(
            o, d, scene, 1, 1e-3, 3.4e35, pixel_seeds=seeds,
            sky_intensity=0.0, nee=True,
        )).mean(axis=0)

    picked = direct(scene_with(lights))  # 6 lights -> pick-one branch
    looped = sum(direct(scene_with([lt])) for lt in lights)  # loop branch
    np.testing.assert_allclose(picked, looped, rtol=0.08)


def test_trace_path_strata_requires_counter_stream_inputs():
    """The stratified first-bounce scatter remap needs pixel ids + absolute
    sample index + frame seed alongside the pixel seeds."""
    import pytest

    from gpu_ray_tracing import base_scene
    from gpu_ray_tracing.ops import integrators

    o = jnp.zeros((4, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([0.0, 0.0, -1.0], jnp.float32), (4, 1))
    seeds = jnp.arange(4, dtype=jnp.uint32)
    with pytest.raises(ValueError, match="sampler_spec"):
        integrators.trace_path(
            o, d, base_scene(), 2, 1e-3, 3.4e35,
            pixel_seeds=seeds, sampler_spec=("stratified", 2, 2),
        )


def _mis_scene_and_cam(light):
    """Ground + red sphere + one emissive light, camera on the spheres."""
    from gpu_ray_tracing import make_scene
    from gpu_ray_tracing.models.camera import CameraSettings, derive_camera
    from gpu_ray_tracing.models.spheres import LAMBERTIAN, make_spheres

    scene = make_scene(make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((1.2, 0.3, -2.4), 0.3, LAMBERTIAN, (0.8, 0.3, 0.3), 0.0),
        light,
    ]))
    cam = derive_camera(CameraSettings(
        look_from=jnp.asarray([0.0, 0.7, 1.5]),
        look_at=jnp.asarray([0.0, 0.3, -2.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(55.0),
        defocus_angle=jnp.float32(0.0),
        focus_distance=jnp.float32(3.0)), 48, 32)
    return scene, cam


@partial(jax.jit, static_argnames=("nee", "mis", "spp"))
def _render_estimator_jit(scene, cam, frame_seed, nee, mis, spp):
    # module-level jit: a per-call inner closure retraced on EVERY
    # invocation (the old shape cost ~2 min of suite wall time in
    # recompiles across the estimator tests)
    from gpu_ray_tracing.ops import rays as rays_ops

    acc = jnp.zeros((32, 48, 3), jnp.float32)

    def body(s, acc):
        o, d, seeds = rays_ops.generate_rays_hash(
            cam, 48, 32, jnp.uint32(s), frame_seed)
        return acc + trace_path(
            o, d, scene, 5, 1e-3, 3.4e35, pixel_seeds=seeds,
            sky_intensity=0.0, nee=nee, mis=mis)

    return jax.lax.fori_loop(0, spp, body, acc) / spp


def _render_estimator(scene, cam, frame_seed, nee, mis, spp):
    return np.asarray(_render_estimator_jit(
        scene, cam, jnp.uint32(frame_seed), nee, mis, spp))


def test_mis_unbiased_and_reduces_variance_large_light():
    """MIS must estimate the same integral as plain NEE and BSDF-only
    sampling, and beat NEE where cone sampling is weak: a huge light
    hovering just above the ground (near it the cone fills the hemisphere,
    where cosine BSDF rays are the better strategy; measured ~1.2x lower
    MSE at 8 spp)."""
    from gpu_ray_tracing.models.spheres import EMISSIVE

    scene, cam = _mis_scene_and_cam(
        ((0.0, 3.1, -2.0), 3.0, EMISSIVE, (1.0, 0.9, 0.7), 1.0))
    ref = _render_estimator(scene, cam, 0, True, True, 1024)
    means = {}
    mses = {}
    for name, (nee, mis) in {
        "bsdf": (False, False), "nee": (True, False), "mis": (True, True)
    }.items():
        means[name] = _render_estimator(scene, cam, 9, nee, mis, 1024).mean()
        mses[name] = np.mean([
            float(np.mean((_render_estimator(scene, cam, fs, nee, mis, 8) - ref) ** 2))
            for fs in range(1, 7)
        ])
    # Unbiasedness: all three estimators agree at high spp (1024 spp;
    # tolerance sized to the 1/sqrt(spp) noise of the same-seed pairs).
    assert abs(means["mis"] - means["bsdf"]) < 0.015 * means["bsdf"], means
    assert abs(means["mis"] - means["nee"]) < 0.015 * means["nee"], means
    # Variance: MIS beats both single strategies on this scene.
    assert mses["mis"] < 0.95 * mses["nee"], mses
    assert mses["mis"] < 0.5 * mses["bsdf"], mses


def test_mis_equals_nee_for_small_lights():
    """For a small bright light the cone pdf dominates every weight, so MIS
    degrades gracefully to (almost exactly) the plain NEE estimator."""
    from gpu_ray_tracing.models.spheres import EMISSIVE

    scene, cam = _mis_scene_and_cam(
        ((0.8, 2.2, -1.6), 0.15, EMISSIVE, (1.0, 0.9, 0.7), 40.0))
    a = _render_estimator(scene, cam, 3, True, False, 8)
    b = _render_estimator(scene, cam, 3, True, True, 8)
    # The handful of BSDF rays that DO hit the tiny light get weight
    # ~0.999 instead of the binary 0, so a few pixels differ by ~0.1%.
    np.testing.assert_allclose(a, b, rtol=5e-3, atol=3e-4)


def test_mis_validation():
    import pytest

    from gpu_ray_tracing import RenderConfig, base_scene

    with pytest.raises(ValueError, match="mis"):
        RenderConfig(mis=True)  # requires nee
    o = jnp.zeros((4, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([0.0, 0.0, -1.0], jnp.float32), (4, 1))
    seeds = jnp.arange(4, dtype=jnp.uint32)
    with pytest.raises(ValueError, match="mis"):
        trace_path(
            o, d, base_scene(), 2, 1e-3, 3.4e35, pixel_seeds=seeds, mis=True)


def test_mis_no_depth_truncation_bias():
    """The last bounce's NEE term keeps weight 1 (its BSDF counterpart ray
    is never traced), so shallow-depth MIS must not render darker than
    plain NEE — with the naive weight the huge-light scene lost ~tens of
    percent of the final vertex's direct light at depth 2."""
    from gpu_ray_tracing.models.spheres import EMISSIVE
    from gpu_ray_tracing.ops import rays as rays_ops

    scene, cam = _mis_scene_and_cam(
        ((0.0, 3.1, -2.0), 3.0, EMISSIVE, (1.0, 0.9, 0.7), 1.0))

    @partial(jax.jit, static_argnames=("mis",))
    def mean_at_depth2(mis):
        # one jitted device loop (64 eager trace_path calls took ~6 min
        # of the suite; the fori_loop form is the production shape)
        def body(s, acc):
            o, d, seeds = rays_ops.generate_rays_hash(
                cam, 48, 32, jnp.uint32(s), jnp.uint32(0))
            return acc + trace_path(
                o, d, scene, 2, 1e-3, 3.4e35, pixel_seeds=seeds,
                sky_intensity=0.0, nee=True, mis=mis).mean()

        return jax.lax.fori_loop(0, 64, body, jnp.float32(0.0)) / 64

    m_nee = float(mean_at_depth2(False))
    m_mis = float(mean_at_depth2(True))
    assert abs(m_mis - m_nee) < 0.02 * m_nee, (m_mis, m_nee)


def test_nee_distant_light_no_underflow():
    """1 - cos_max computed in the cancellation-free form: a small light
    ~5000 radii away must still illuminate diffuse surfaces under NEE (the
    naive 1 - sqrt(1 - r^2/d^2) underflows to 0 there, deleting the light's
    whole contribution while BSDF-hit emission stays suppressed)."""
    from gpu_ray_tracing.models.spheres import EMISSIVE
    from gpu_ray_tracing.ops import rays as rays_ops

    # r=0.15 at distance ~750 -> r^2/d^2 ~ 4e-8 < f32 ulp of 1.0.
    scene, cam = _mis_scene_and_cam(
        ((300.0, 650.0, -200.0), 0.15, EMISSIVE, (1.0, 1.0, 1.0), 4e8))
    o, d, seeds = rays_ops.generate_rays_hash(cam, 48, 32, jnp.uint32(0), jnp.uint32(3))
    img_nee = np.asarray(trace_path(
        o, d, scene, 3, 1e-3, 3.4e35, pixel_seeds=seeds,
        sky_intensity=0.0, nee=True))
    assert np.isfinite(img_nee).all()
    assert img_nee.mean() > 1e-3, img_nee.mean()  # the sun actually shines


def test_mis_gradients_finite_with_overlapping_light():
    """grad through nee+mis with a diffuse sphere OVERLAPPING the light
    volume (vertices inside the light exercise the guarded sqrt in the
    cone-width computation; the naive clip->sqrt chain emitted NaN
    cotangents there)."""
    import dataclasses

    from gpu_ray_tracing import make_scene
    from gpu_ray_tracing.models.camera import CameraSettings, derive_camera
    from gpu_ray_tracing.models.spheres import EMISSIVE, make_spheres
    from gpu_ray_tracing.ops import rays as rays_ops

    scene = make_scene(make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((-0.6, 0.35, -2.2), 0.35, LAMBERTIAN, (0.8, 0.3, 0.3), 0.0),
        ((0.0, 1.6, -2.0), 1.2, EMISSIVE, (1.0, 0.9, 0.7), 2.0),  # overlaps
    ]))
    cam = derive_camera(CameraSettings(
        look_from=jnp.asarray([0.0, 0.6, 1.0]),
        look_at=jnp.asarray([0.0, 0.4, -2.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(55.0),
        defocus_angle=jnp.float32(0.0),
        focus_distance=jnp.float32(3.0)), 32, 24)

    def loss(albedo):
        s = dataclasses.replace(
            scene, spheres=dataclasses.replace(scene.spheres, albedo=albedo))
        o, d, seeds = rays_ops.generate_rays_hash(cam, 32, 24, jnp.uint32(0), jnp.uint32(1))
        img = trace_path(o, d, s, 4, 1e-3, 3.4e35, pixel_seeds=seeds,
                         sky_intensity=0.0, nee=True, mis=True)
        return jnp.mean(img)

    g = np.asarray(jax.grad(loss)(scene.spheres.albedo))
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0.0
