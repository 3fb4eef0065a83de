"""Sphere scene model: struct-of-arrays scene, material codec, generators.

Reference mapping:
  - `Spheres` SoA      <- scene/sphere.rs:16-33 (`GpuMaterial`/`GpuSphere`/
                          `SphereCollection`), re-laid-out struct-of-arrays for
                          vector lanes instead of the reference's 32-byte AoS.
  - material codec     <- the albedo.w packing convention (sphere.rs:53,96,105
                          comments; decoded by the shader at wgsl:77-79,272-284):
                          w < -1 -> lambertian, -1 <= w <= 1 -> metal (w=fuzz),
                          w > 1 -> dielectric (then albedo.x = ior).
                          Here materials are explicit fields (kind/albedo/param);
                          pack/unpack exist for parity tests.
  - generators         <- sphere.rs:45-153 `create_default_spheres` (the "One
                          Weekend" final scene) with an explicit PRNG key in
                          place of rand::random() global state.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

# Material kinds (explicit enum instead of albedo.w thresholds).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
# Extension beyond the reference (its shader has exactly three BSDFs,
# wgsl:272-284): emissive surfaces radiate albedo * mat_param and terminate
# the path — area lights for dark scenes (see RenderConfig.sky_intensity).
EMISSIVE = 3


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["centers", "radii", "albedo", "mat_kind", "mat_param"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Spheres:
    """Struct-of-arrays sphere scene.

    centers   (N, 3) f32   sphere centers
    radii     (N,)   f32   radii; radius <= 0 marks an inactive pad slot
    albedo    (N, 3) f32   surface color (dielectric ignores it; kept 1.0)
    mat_kind  (N,)   i32   LAMBERTIAN / METAL / DIELECTRIC / EMISSIVE
    mat_param (N,)   f32   metal fuzz, dielectric ior, or emission intensity

    The SoA layout means the intersection kernel reads dense (N,) lanes and the
    closest-hit reduction is a masked argmin — there is no per-sphere struct
    traffic.  At the reference's ~194 spheres this is ~7 KB.
    """

    centers: Array
    radii: Array
    albedo: Array
    mat_kind: Array
    mat_param: Array

    @property
    def count(self) -> int:
        return self.centers.shape[0]

    def pad_to(self, n: int) -> "Spheres":
        """Pad with inactive (radius 0) spheres up to n slots.

        The reference pads to MAX_SPHERES=100 (sphere.rs:11,142-150) but its
        scene overflows that cap and the pad loop never runs (SURVEY H10
        quirk).  Here padding exists to give the compiled kernel a static,
        lane-aligned sphere count; inactive slots are masked by radius <= 0.
        """
        k = n - self.count
        if k < 0:
            raise ValueError(f"cannot pad {self.count} spheres down to {n}")
        if k == 0:
            return self
        return Spheres(
            centers=jnp.concatenate([self.centers, jnp.zeros((k, 3), jnp.float32)]),
            radii=jnp.concatenate([self.radii, jnp.zeros((k,), jnp.float32)]),
            albedo=jnp.concatenate([self.albedo, jnp.zeros((k, 3), jnp.float32)]),
            mat_kind=jnp.concatenate([self.mat_kind, jnp.zeros((k,), jnp.int32)]),
            mat_param=jnp.concatenate([self.mat_param, jnp.zeros((k,), jnp.float32)]),
        )

    def pad_to_multiple(self, m: int = 128) -> "Spheres":
        """Pad N up to a multiple of m (128 by default)."""
        n = ((self.count + m - 1) // m) * m
        return self.pad_to(max(n, m))


def make_spheres(entries) -> Spheres:
    """Build a Spheres SoA from (center, radius, kind, albedo, param) tuples."""
    if not entries:
        # A zero-sphere SoA dies later with an opaque shape error (the
        # closest-hit argmin has no candidates); fail at the boundary
        # instead.  A sky-only frame is `integrator='normal'`-free anyway —
        # put one sphere behind the camera if the sky gradient is the goal.
        raise ValueError("make_spheres needs at least one sphere entry")
    centers = jnp.asarray([e[0] for e in entries], jnp.float32).reshape(-1, 3)
    radii = jnp.asarray([e[1] for e in entries], jnp.float32)
    kinds = jnp.asarray([e[2] for e in entries], jnp.int32)
    albedo = jnp.asarray([e[3] for e in entries], jnp.float32).reshape(-1, 3)
    params = jnp.asarray([e[4] for e in entries], jnp.float32)
    return Spheres(centers=centers, radii=radii, albedo=albedo, mat_kind=kinds, mat_param=params)


# ---------------------------------------------------------------------------
# Packed-material codec (parity with the reference's albedo.w convention).
# ---------------------------------------------------------------------------


def pack_materials(spheres: Spheres) -> np.ndarray:
    """Spheres SoA -> (N, 4) packed albedo.w materials (sphere.rs convention).

    lambertian -> (r, g, b, -2.0)           sphere.rs:53,81,126
    metal      -> (r, g, b, fuzz)           sphere.rs:96,134
    dielectric -> (ior, 0, 0, 2.0)          sphere.rs:105,118

    EMISSIVE has no encoding in the reference convention and is rejected.
    """
    if bool(np.any(np.asarray(spheres.mat_kind) == EMISSIVE)):
        raise ValueError("the reference albedo.w codec cannot express EMISSIVE")
    albedo = np.asarray(spheres.albedo)
    kind = np.asarray(spheres.mat_kind)
    param = np.asarray(spheres.mat_param)
    metal_fuzz = param[kind == METAL]
    if metal_fuzz.size and bool(
        np.any((metal_fuzz < -1.0) | (metal_fuzz > 1.0))
    ):
        # w in (-inf,-1) decodes as lambertian and w in (1, 2] as
        # dielectric (wgsl:276-281): out-of-range fuzz would silently
        # re-type the sphere on the unpack side.
        raise ValueError(
            "metal fuzz must be within [-1, 1] to round-trip the albedo.w "
            f"codec; got {metal_fuzz.min()}..{metal_fuzz.max()}"
        )
    out = np.zeros((albedo.shape[0], 4), np.float32)
    out[:, :3] = albedo
    out[kind == LAMBERTIAN, 3] = -2.0
    out[kind == METAL, 3] = param[kind == METAL]
    out[kind == DIELECTRIC, 0] = param[kind == DIELECTRIC]
    out[kind == DIELECTRIC, 1:3] = 0.0
    out[kind == DIELECTRIC, 3] = 2.0
    return out


def unpack_materials(centers, radii, packed) -> Spheres:
    """(N,4) packed albedo.w -> Spheres SoA (decode of wgsl:77-79,272-284)."""
    packed = np.asarray(packed, np.float32)
    w = packed[:, 3]
    kind = np.where(w < -1.0, LAMBERTIAN, np.where(w <= 1.0, METAL, DIELECTRIC))
    param = np.where(kind == METAL, w, np.where(kind == DIELECTRIC, packed[:, 0], 0.0))
    albedo = packed[:, :3].copy()
    # Dielectrics carry ior in x; their attenuation is identically 1 (wgsl:104).
    albedo[kind == DIELECTRIC] = 1.0
    return Spheres(
        centers=jnp.asarray(centers, jnp.float32).reshape(-1, 3),
        radii=jnp.asarray(radii, jnp.float32),
        albedo=jnp.asarray(albedo),
        mat_kind=jnp.asarray(kind, jnp.int32),
        mat_param=jnp.asarray(param, jnp.float32),
    )


# ---------------------------------------------------------------------------
# Scene generators.
# ---------------------------------------------------------------------------


def base_scene() -> Spheres:
    """BASELINE config-1 scene: two unit-ish spheres + ground + sky.

    Not present verbatim in the reference; it is the standard early "One
    Weekend" test scene the baseline names for the normal-shading integrator.
    """
    return make_spheres(
        [
            ((0.0, 0.0, -1.0), 0.5, LAMBERTIAN, (0.1, 0.2, 0.5), 0.0),
            ((-1.0, 0.0, -1.0), 0.5, METAL, (0.8, 0.8, 0.8), 0.1),
            ((0.0, -100.5, -1.0), 100.0, LAMBERTIAN, (0.8, 0.8, 0.0), 0.0),
        ]
    )


def one_weekend_scene(key: jax.Array, grid_min: int = -7, grid_max: int = 7) -> Spheres:
    """The reference's default scene generator (sphere.rs:45-153).

    Ground sphere r=1000 at (0,-1000,0) with grey diffuse (sphere.rs:49-55);
    a grid of r=0.2 spheres at (a + 0.9*rand, 0.2, b + 0.9*rand) for
    a,b in [grid_min, grid_max), skipped when within 0.9 of (4, 0.2, 0)
    (sphere.rs:59-69); material roll: p<0.8 diffuse with albedo rand*rand per
    channel, p<0.95 metal with albedo 0.5*(1+rand) and fuzz 0.5*rand, else
    glass ior 1.5 (sphere.rs:70-108); three hero spheres r=1: glass at (0,1,0),
    diffuse(0.4,0.2,0.1) at (-4,1,0), metal(0.7,0.6,0.5; fuzz 0) at (4,1,0)
    (sphere.rs:114-136).

    The reference uses rand::random() global state; here the PRNG key is
    explicit so scenes are reproducible.  Pass grid_min=-11, grid_max=11 for
    the book's full ~480-sphere variant (BASELINE config 3).
    """
    entries = [((0.0, -1000.0, 0.0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)]

    # Host-side generation with numpy randomness derived from the JAX key:
    # scene construction is setup code, not kernel code.  Mix EVERY key
    # word into the numpy seed — using only the last word dropped half the
    # key's entropy (keys differing in the high bits generated identical
    # "random" scenes).  key(0) still maps to seed 0, so all existing
    # golden scenes are unchanged.
    words = np.asarray(jax.random.key_data(key)).ravel().astype(np.uint64)
    seed = 0
    for w in words:
        seed = int((np.uint64(seed) * np.uint64(0x100000001B3) ^ w) & np.uint64(0xFFFFFFFFFFFFFFFF))
    rng = np.random.default_rng(seed)

    for a in range(grid_min, grid_max):
        for b in range(grid_min, grid_max):
            choose_mat = rng.random()
            center = np.array(
                [a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random()], np.float32
            )
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if choose_mat < 0.8:
                albedo = rng.random(3) * rng.random(3)
                entries.append((tuple(center), 0.2, LAMBERTIAN, tuple(albedo), 0.0))
            elif choose_mat < 0.95:
                albedo = 0.5 * (1.0 + rng.random(3))
                fuzz = 0.5 * rng.random()
                entries.append((tuple(center), 0.2, METAL, tuple(albedo), float(fuzz)))
            else:
                entries.append((tuple(center), 0.2, DIELECTRIC, (1.0, 1.0, 1.0), 1.5))

    entries += [
        ((0.0, 1.0, 0.0), 1.0, DIELECTRIC, (1.0, 1.0, 1.0), 1.5),
        ((-4.0, 1.0, 0.0), 1.0, LAMBERTIAN, (0.4, 0.2, 0.1), 0.0),
        ((4.0, 1.0, 0.0), 1.0, METAL, (0.7, 0.6, 0.5), 0.0),
    ]
    return make_spheres(entries)
