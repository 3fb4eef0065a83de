"""Materials: lambertian / metal / dielectric scatter, branchless.

Reference mapping (compute_shader.wgsl):
  - `scatter`      <- lambertian_scatter (wgsl:84-93), metal_scatter
                      (wgsl:95-100), dielectric_scatter (wgsl:102-135),
                      dispatched on material kind.  The reference branches on
                      albedo.w thresholds (wgsl:272-284); here all three
                      BSDFs are evaluated for every lane and the result is
                      selected with `jnp.where` on mat_kind — no divergence.
  - `reflectance`  <- Schlick approximation (wgsl:137-141)

Conventions kept from the reference:
  - lambertian scatter direction is NOT normalized (normal + unit vector,
    wgsl:85-90); metal and dielectric directions ARE normalized (wgsl:97,132).
  - metal absorbs the ray when the fuzzed reflection goes below the surface
    (dot(reflected, normal) <= 0, wgsl:99).
  - dielectric attenuation is exactly 1 (wgsl:104).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpu_ray_tracing.models.spheres import DIELECTRIC, LAMBERTIAN, METAL

Array = jax.Array


def reflect(v: Array, n: Array) -> Array:
    """Mirror reflection: v - 2 dot(v, n) n (the WGSL built-in)."""
    return v - 2.0 * jnp.sum(v * n, axis=-1, keepdims=True) * n


def refract(unit_v: Array, n: Array, eta_ratio: Array) -> Array:
    """Snell refraction of a unit direction about unit normal n.

    Matches WGSL's `refract` for the non-TIR case (TIR is excluded by the
    caller's cannot_refract test, wgsl:119).
    """
    cos_theta = jnp.minimum(jnp.sum(-unit_v * n, axis=-1, keepdims=True), 1.0)
    r_perp = eta_ratio * (unit_v + cos_theta * n)
    k = 1.0 - jnp.sum(r_perp * r_perp, axis=-1, keepdims=True)
    k_pos = k > 0.0
    sqrt_k = jnp.where(k_pos, jnp.sqrt(jnp.where(k_pos, k, 1.0)), 0.0)
    r_parallel = -sqrt_k * n
    return r_perp + r_parallel


def reflectance(cos_theta: Array, refractive_index: Array) -> Array:
    """Schlick's approximation (wgsl:137-141)."""
    r0 = (1.0 - refractive_index) / (1.0 + refractive_index)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * jnp.power(1.0 - cos_theta, 5.0)


def _normalize(v: Array) -> Array:
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def scatter(
    ray_dir: Array,  # (..., 3) incoming ray direction (not necessarily unit)
    normal: Array,  # (..., 3) face normal (already flipped toward the ray)
    front_face: Array,  # (...,) bool
    albedo: Array,  # (..., 3) surface color of the hit sphere
    mat_kind: Array,  # (...,) i32
    mat_param: Array,  # (...,) f32 fuzz (metal) or ior (dielectric)
    unit_vec: Array,  # (..., 3) random unit vector (lambertian + metal fuzz)
    u_reflect: Array,  # (...,) U[0,1] draw for the dielectric reflect choice
) -> tuple[Array, Array, Array]:
    """Evaluate all three BSDFs and select by mat_kind.

    Returns (scattered_dir, attenuation, ok) where ok=False means the ray was
    absorbed (metal scattering below the surface, wgsl:99) and contributes
    black (wgsl:274,278,282).
    """
    # --- lambertian (wgsl:84-93) ---
    lam_dir = normal + unit_vec
    degenerate = jnp.sum(lam_dir * lam_dir, axis=-1, keepdims=True) < 1e-6
    lam_dir = jnp.where(degenerate, normal, lam_dir)

    # --- metal (wgsl:95-100) ---
    fuzz = mat_param[..., None]
    reflected = _normalize(reflect(ray_dir, normal)) + fuzz * unit_vec
    metal_dir = _normalize(reflected)
    metal_ok = jnp.sum(reflected * normal, axis=-1) > 0.0

    # --- dielectric (wgsl:102-135) ---
    # Sanitize ior on non-dielectric lanes (their mat_param is fuzz, possibly
    # 0): 1/0 = inf would poison gradients through the final jnp.where.
    ior = jnp.where(mat_kind == DIELECTRIC, mat_param, 1.5)
    eta_ratio = jnp.where(front_face, 1.0 / ior, ior)[..., None]
    unit_d = _normalize(ray_dir)
    cos_theta = jnp.minimum(jnp.sum(-unit_d * normal, axis=-1), 1.0)
    sin2 = 1.0 - cos_theta * cos_theta
    sin2_pos = sin2 > 0.0
    sin_theta = jnp.where(sin2_pos, jnp.sqrt(jnp.where(sin2_pos, sin2, 1.0)), 0.0)
    cannot_refract = eta_ratio[..., 0] * sin_theta > 1.0
    should_reflect = cannot_refract | (
        reflectance(cos_theta, eta_ratio[..., 0]) > u_reflect
    )
    diel_dir = jnp.where(
        should_reflect[..., None],
        reflect(unit_d, normal),
        refract(unit_d, normal, eta_ratio),
    )
    diel_dir = _normalize(diel_dir)

    # --- select by kind ---
    kind = mat_kind[..., None]
    out_dir = jnp.where(
        kind == LAMBERTIAN, lam_dir, jnp.where(kind == METAL, metal_dir, diel_dir)
    )
    attenuation = jnp.where(kind == DIELECTRIC, jnp.ones_like(albedo), albedo)
    ok = jnp.where(mat_kind == METAL, metal_ok, True)
    return out_dir, attenuation, ok
