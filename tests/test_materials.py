"""Tests for material scatter (wgsl:84-141)."""

import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing.models.spheres import DIELECTRIC, LAMBERTIAN, METAL
from gpu_ray_tracing.ops.materials import reflect, reflectance, refract, scatter


def _scatter_one(kind, ray_dir, normal, front_face=True, albedo=(0.5, 0.5, 0.5),
                 param=0.0, unit_vec=(0.0, 0.0, 1.0), u_reflect=0.5):
    d, a, ok = scatter(
        jnp.asarray([ray_dir], jnp.float32),
        jnp.asarray([normal], jnp.float32),
        jnp.asarray([front_face]),
        jnp.asarray([albedo], jnp.float32),
        jnp.asarray([kind], jnp.int32),
        jnp.asarray([param], jnp.float32),
        jnp.asarray([unit_vec], jnp.float32),
        jnp.asarray([u_reflect], jnp.float32),
    )
    return np.asarray(d[0]), np.asarray(a[0]), bool(ok[0])


def test_reflect_formula():
    v = jnp.asarray([[1.0, -1.0, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    np.testing.assert_allclose(np.asarray(reflect(v, n))[0], [1, 1, 0], atol=1e-6)


def test_refract_straight_through():
    v = jnp.asarray([[0.0, -1.0, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    out = np.asarray(refract(v, n, jnp.asarray([[1.0]])))[0]
    np.testing.assert_allclose(out, [0, -1, 0], atol=1e-6)


def test_refract_snell_angle():
    """30-degree incidence air->glass (ior 1.5): sin(theta_t) = sin(30)/1.5."""
    theta_i = np.radians(30.0)
    v = jnp.asarray([[np.sin(theta_i), -np.cos(theta_i), 0.0]], jnp.float32)
    n = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    out = np.asarray(refract(v, n, jnp.asarray([[1.0 / 1.5]], jnp.float32)))[0]
    sin_t = out[0] / np.linalg.norm(out)
    np.testing.assert_allclose(sin_t, np.sin(theta_i) / 1.5, atol=1e-5)


def test_reflectance_limits():
    """Schlick: normal incidence -> r0; grazing -> 1 (wgsl:137-141)."""
    r0 = float(reflectance(jnp.float32(1.0), jnp.float32(1.5)))
    np.testing.assert_allclose(r0, ((1 - 1.5) / (1 + 1.5)) ** 2, atol=1e-6)
    grazing = float(reflectance(jnp.float32(0.0), jnp.float32(1.5)))
    np.testing.assert_allclose(grazing, 1.0, atol=1e-6)


def test_lambertian_scatter_direction_and_albedo():
    d, a, ok = _scatter_one(
        LAMBERTIAN, [0, 0, -1], [0, 0, 1], albedo=(0.2, 0.4, 0.6),
        unit_vec=(1.0, 0.0, 0.0),
    )
    assert ok
    np.testing.assert_allclose(d, [1, 0, 1], atol=1e-6)  # normal + unit_vec
    np.testing.assert_allclose(a, [0.2, 0.4, 0.6], atol=1e-6)


def test_lambertian_degenerate_falls_back_to_normal():
    """unit_vec == -normal gives a near-zero direction -> use the normal
    (wgsl:87-89)."""
    d, _, ok = _scatter_one(LAMBERTIAN, [0, 0, -1], [0, 0, 1], unit_vec=(0, 0, -1))
    assert ok
    np.testing.assert_allclose(d, [0, 0, 1], atol=1e-6)


def test_metal_mirror_reflection():
    d, a, ok = _scatter_one(
        METAL, [1, -1, 0], [0, 1, 0], albedo=(0.7, 0.6, 0.5),
        param=0.0, unit_vec=(0, 0, 1),
    )
    assert ok
    np.testing.assert_allclose(d, np.array([1, 1, 0]) / np.sqrt(2), atol=1e-6)
    np.testing.assert_allclose(a, [0.7, 0.6, 0.5], atol=1e-6)


def test_metal_absorbs_below_surface():
    """Fuzz pushing the reflection below the surface absorbs the ray
    (dot(reflected, normal) <= 0, wgsl:99)."""
    _, _, ok = _scatter_one(
        METAL, [1, -0.01, 0], [0, 1, 0], param=1.0, unit_vec=(0, -1, 0)
    )
    assert not ok


def test_dielectric_attenuation_is_one():
    _, a, ok = _scatter_one(
        DIELECTRIC, [0, -1, 0], [0, 1, 0], albedo=(0.9, 0.1, 0.1), param=1.5,
        u_reflect=0.99,
    )
    assert ok
    np.testing.assert_allclose(a, [1, 1, 1], atol=1e-6)


def test_dielectric_total_internal_reflection():
    """Glass->air beyond the critical angle must reflect (wgsl:119).
    Critical angle for ior 1.5 is ~41.8deg; use 60deg from inside."""
    theta = np.radians(60.0)
    d_in = [np.sin(theta), -np.cos(theta), 0.0]
    d, _, ok = _scatter_one(
        DIELECTRIC, d_in, [0, 1, 0], front_face=False, param=1.5, u_reflect=1.0
    )
    assert ok
    # Reflected: y component flips.
    np.testing.assert_allclose(d, [np.sin(theta), np.cos(theta), 0.0], atol=1e-5)


def test_dielectric_refracts_at_normal_incidence_with_high_u():
    d, _, _ = _scatter_one(
        DIELECTRIC, [0, -1, 0], [0, 1, 0], front_face=True, param=1.5, u_reflect=0.9
    )
    np.testing.assert_allclose(d, [0, -1, 0], atol=1e-5)


def test_dielectric_schlick_stochastic_reflection():
    """u below the Schlick reflectance forces reflection."""
    theta = np.radians(80.0)  # grazing: high reflectance
    d_in = [np.sin(theta), -np.cos(theta), 0.0]
    d, _, _ = _scatter_one(
        DIELECTRIC, d_in, [0, 1, 0], front_face=True, param=1.5, u_reflect=0.0
    )
    # u=0 < reflectance -> reflect: y flips sign.
    assert d[1] > 0
