"""Random number generation: WGSL-parity integer hash + threefry helpers.

Reference mapping (compute_shader.wgsl:50-63 and friends):
  - `wgsl_hash`            <- wgsl:50-59 (xor 2747636419; then 3 rounds of
                              *2654435769, ^ >>16 between rounds)
  - `wgsl_random_float`    <- wgsl:61-63  hash(v) / 4294967295.0
  - `random_unit_vector`   <- wgsl:234-243 (z in [-1,1], angle in [0,2pi))
  - `seed_from_f32`        <- the u32(camera.random_seed * 4294967295.0)
                              expansion at wgsl:311,353

The WGSL hash chains exist for bit-parity golden tests (the reference's
sampler defects are reproduced only behind `parity=True` — SURVEY D2/D4/D7
quirks).  The DEFAULT RNG is the counter-based "hash" mode below: the same
integer hash core with proper per-(pixel, sample, salt) seed derivation,
position-equivariant so sharding/tiling cannot change the stream.
jax.random/threefry remains available as a third mode.

All functions are shape-polymorphic and work on uint32 arrays of any shape;
uint32 arithmetic in JAX wraps, matching WGSL semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

_U32_MAX_F = 4294967295.0
# numpy scalars (not jnp arrays): they embed as literals, so kernels that
# close over these helpers (Pallas) don't capture device constants.
_XOR_SEED = np.uint32(2747636419)
_MUL = np.uint32(2654435769)


def wgsl_hash(value: Array) -> Array:
    """Exact re-implementation of the WGSL integer hash (wgsl:50-59)."""
    state = jnp.asarray(value, jnp.uint32)
    state = state ^ _XOR_SEED
    state = state * _MUL
    state = state ^ (state >> 16)
    state = state * _MUL
    state = state ^ (state >> 16)
    state = state * _MUL
    return state


def wgsl_random_float(value: Array) -> Array:
    """hash(value) / 4294967295.0 -> f32 in [0, 1] (wgsl:61-63)."""
    return wgsl_hash(value).astype(jnp.float32) / jnp.float32(_U32_MAX_F)


def seed_from_f32(seed01: Array) -> Array:
    """u32(seed * 4294967295.0) with WGSL's saturating f32->u32 cast
    (wgsl:311,353).  f32 cannot represent 2^32-1, so the product for seeds
    within ~1 ulp of 1.0 rounds to 2^32, which WGSL saturates to
    u32::MAX = 4294967295; replicate that explicitly (XLA's out-of-range
    float->uint cast is platform-dependent, so it can't be relied on)."""
    x = jnp.maximum(jnp.asarray(seed01, jnp.float32) * jnp.float32(_U32_MAX_F), 0.0)
    # NaN would fall through every comparison below into the very
    # platform-dependent float->uint cast this function exists to avoid.
    x = jnp.where(jnp.isnan(x), 0.0, x)
    return jnp.where(
        x >= jnp.float32(4294967296.0),
        jnp.uint32(0xFFFFFFFF),
        # Below 2^32 the largest representable f32 is 4294967040, which
        # converts exactly.
        jnp.minimum(x, jnp.float32(4294967040.0)).astype(jnp.uint32),
    )


def random_unit_vector(seed: Array) -> Array:
    """Uniform point on the unit sphere from two hash draws (wgsl:234-243).
    Returns shape seed.shape + (3,).  One sphere-sampling formula exists
    (unit_vector_from_uniforms); this composes it with the hash stream —
    the two 2*pi literals round to the same f32, so this is bit-identical
    to the previous inline form."""
    seed = jnp.asarray(seed, jnp.uint32)
    return unit_vector_from_uniforms(
        wgsl_random_float(seed), wgsl_random_float(seed + jnp.uint32(1))
    )


def unit_vector_from_uniforms(u1: Array, u2: Array) -> Array:
    """Uniform unit vector from two U[0,1) draws (threefry path)."""
    z = 2.0 * u1 - 1.0
    a = u2 * jnp.float32(2.0 * jnp.pi)
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([r * jnp.cos(a), r * jnp.sin(a), z], axis=-1)


# ---------------------------------------------------------------------------
# Counter-based per-pixel RNG ("hash" mode — the default).
#
# Every draw is a pure function of (global pixel id, sample index, frame seed,
# salt).  This makes the whole renderer position-equivariant: a pixel's
# randomness does not depend on batch shape or device placement, so a render
# sharded over a mesh is bit-identical to the unsharded render, and the Pallas
# megakernel can derive the very same stream per tile.  (jax.random/threefry
# draws depend on the requested array shape, which breaks that.)
# ---------------------------------------------------------------------------

_SALT_MUL = np.uint32(0x68E31DA4)
_PIX_MUL = np.uint32(2654435761)
_SAMPLE_MUL = np.uint32(0x85EBCA6B)


def hash2(seed: Array, salt) -> Array:
    """Derive an independent stream from (seed, salt): hash(seed + salt*C)."""
    return wgsl_hash(
        jnp.asarray(seed, jnp.uint32) + jnp.asarray(salt, jnp.uint32) * _SALT_MUL
    )


def uniform_hash(seed: Array, salt) -> Array:
    """U[0,1) f32 from (seed, salt): top 24 bits / 2^24.

    The 24-bit construction (rather than full/2^32-1) keeps every value
    exactly representable in f32 AND avoids a uint32->float32 cast inside the
    Pallas kernels — the Pallas megakernel
    shares this exact function, so both backends draw the identical stream.
    """
    bits = hash2(seed, salt) >> np.uint32(8)  # < 2^24
    ibits = jax.lax.bitcast_convert_type(bits, jnp.int32)
    return ibits.astype(jnp.float32) * np.float32(1.0 / (1 << 24))


#: Salts of the stratified sampler's per-(pixel, frame) stratum rotations,
#: drawn on the SAMPLE-0 pixel seed (raygen owns salts 1-4, scatter starts
#: at 16 — see the salt map in CLAUDE.md).  The AA jitter and the
#: first-bounce scatter direction stratify over the same grid but with
#: INDEPENDENT rotations, so their strata are uncorrelated (padded
#: stratification, the standard sampler construction).
_STRATUM_ROT_SALT = np.uint32(5)
_SCATTER_ROT_SALT = np.uint32(6)
_LENS_ROT_SALT = np.uint32(7)
# NEE light l (the <= 4-light deterministic loop) rotates at 8 + l; the
# > 4-lights picked-light path stays unstratified (its light id varies per
# (sample, bounce), so strata have no meaning there).
_NEE_ROT_SALT_BASE = 8


def strata_shape(spp: int) -> tuple[int, int]:
    """Factor an spp budget into a (kx, ky) stratification grid, kx*ky == spp.

    kx is the largest divisor of spp at most sqrt(spp), so the grid is as
    square as the budget allows (16 -> 4x4, 8 -> 2x4, primes -> 1xK: still
    fully stratified along y).
    """
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    kx = max(1, int(spp**0.5))
    while spp % kx:
        kx -= 1
    return kx, spp // kx


def stratified_uniforms(
    u1: Array,
    u2: Array,
    pixel_ids: Array,
    sample_index: Array,
    frame_seed_u32: Array,
    strata: tuple[int, int],
    rot_salt=_STRATUM_ROT_SALT,
) -> tuple[Array, Array]:
    """Remap two U[0,1) draws into sample s's stratum of a kx*ky grid,
    returning stratified U[0,1) pairs.

    Sample s lands in stratum `(s + rot(pixel, frame)) mod K` of the grid,
    uniformly jittered inside it by the SAME (u1, u2) draws the independent
    sampler uses — so over any K consecutive samples every pixel covers each
    stratum exactly once (variance drops vs independent draws), and any
    SINGLE sample is still marginally uniform because the per-(pixel, frame)
    rotation is (Cranley-Patterson on the stratum index — no bias at partial
    accumulation counts).  Distinct `rot_salt`s give independently rotated
    grids for different draw pairs (AA jitter salt 5, first-bounce scatter
    salt 6), keeping their strata uncorrelated.

    Pure function of (pixel id, sample, frame seed, salt), like every other
    draw: sharding, tiling, and ray compaction cannot change the stream, and
    the Pallas engines share this exact function.  Elementwise (the
    u32->f32 paths go through modular astype, matching the megakernel's
    scalar loads); `sample_index` may be a scalar or a per-lane
    array (the regenerating wavefront pool).
    """
    kx, ky = strata
    k_total = kx * ky
    if k_total == 1:
        return u1, u2
    rot_u = uniform_hash(
        hash_pixel_seeds(pixel_ids, jnp.uint32(0), frame_seed_u32),
        rot_salt,
    )
    # floor(u * K) < K for every 24-bit u (the product sits more than half an
    # ulp below K unless K is a power of two, where it is exact); the min is
    # belt and braces.
    rot = jnp.minimum(
        jnp.floor(rot_u * jnp.float32(k_total)), jnp.float32(k_total - 1)
    )
    s_mod = jnp.asarray(sample_index, jnp.uint32) % jnp.uint32(k_total)
    # u32 -> i32 astype is modular/bit-preserving and works on SCALARS
    # too (sample_index is a scalar in the megakernel), where the bitcast
    # trick uniform_hash uses is vector-only; s_mod < K so the i32
    # value is exact.
    s_f = s_mod.astype(jnp.int32).astype(jnp.float32)
    stratum = rot + s_f
    stratum = jnp.where(
        stratum >= k_total, stratum - jnp.float32(k_total), stratum
    )
    # Exact for K <= 2^23: representable quotients divide exactly and
    # non-exact ones sit > half an ulp below the next integer.
    cy = jnp.floor(stratum / jnp.float32(kx))
    cx = stratum - cy * jnp.float32(kx)
    return (cx + u1) / jnp.float32(kx), (cy + u2) / jnp.float32(ky)


# ---------------------------------------------------------------------------
# Owen-scrambled Sobol (0,2)-sequence sampler ("sobol" mode).
#
# Each stratified dimension PAIR (AA jitter, thin-lens point, first-bounce
# scatter, first-bounce NEE cone) gets the 2D Sobol point of its absolute
# sample index, Owen-scrambled per (pixel, frame, pair) with the hash-based
# nested-uniform scramble (Laine-Karras 2011 as used by Burley,
# "Practical Hash-based Owen Scrambling", JCGT 2020).  Properties:
#   - any 2^k prefix of one pixel's samples is a (0,2)-net in the pair:
#     every elementary binary rectangle of area 2^-k holds exactly one
#     point — strictly better stratification than the kx*ky jittered grid,
#     at ANY power-of-two prefix simultaneously (progressive-friendly);
#   - the per-(pixel, frame, pair) scramble makes every single point
#     marginally uniform (no bias at partial accumulation counts) and
#     decorrelates pixels and pairs (padded Sobol, the standard
#     construction);
#   - pure elementwise u32 bit arithmetic on (pixel id, sample, frame seed,
#     salt) — the same counter-stream contract as every other draw, so
#     sharding, tiling and wavefront ray compaction cannot change the
#     stream, and the Pallas engines share these exact functions
#     (shifts/xor/mul on u32 vectors or scalars; the one bitcast
#     applies to an always-vector value).
# ---------------------------------------------------------------------------

#: Direction numbers of Sobol dimension 1 (dimension 0 is the bit-reversed
#: index): v_0 = 2^31, v_{b+1} = v_b ^ (v_b >> 1) — the standard recurrence
#: for the primitive polynomial x+1.  numpy constants embed as literals in
#: Pallas kernels (no captured device arrays).
def _sobol_dim1_directions() -> np.ndarray:
    v = np.uint32(0x80000000)
    out = np.empty(32, np.uint32)
    for b in range(32):
        out[b] = v
        v = v ^ (v >> np.uint32(1))
    return out


_SOBOL_DIM1 = _sobol_dim1_directions()


def sobol_nbits(spp: int) -> int:
    """Static loop bound for the dimension-1 direction-number XOR: bits
    covering every sample index an spp budget can reach.

    Indexes beyond 2^nbits would silently REUSE lower samples' dimension-1
    values, so this covers not just spp-1 but the largest index the
    progressive straddle window can produce (a checkpoint resumed at a
    misaligned count folds a batch reaching index spp + spp_per_step - 2
    < 2*spp - 1; the overshoot samples carry zero fold weight, but keep
    their points distinct anyway).  In-budget indices never set the extra
    bit, so results are unchanged — it costs one XOR step.
    """
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")
    return max(1, (2 * spp - 2).bit_length())


def _reverse_bits32(x: Array) -> Array:
    """Bitwise reversal of u32 lanes (5 swap rounds; scalar-safe too)."""
    x = jnp.asarray(x, jnp.uint32)
    x = (x >> np.uint32(16)) | (x << np.uint32(16))
    x = ((x & np.uint32(0x00FF00FF)) << np.uint32(8)) | (
        (x >> np.uint32(8)) & np.uint32(0x00FF00FF)
    )
    x = ((x & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | (
        (x >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
    )
    x = ((x & np.uint32(0x33333333)) << np.uint32(2)) | (
        (x >> np.uint32(2)) & np.uint32(0x33333333)
    )
    x = ((x & np.uint32(0x55555555)) << np.uint32(1)) | (
        (x >> np.uint32(1)) & np.uint32(0x55555555)
    )
    return x


def _laine_karras(x: Array, seed: Array) -> Array:
    """Laine-Karras hash permutation: every output bit depends only on input
    bits at or BELOW it (adds/multiplies carry upward only), so wrapped in
    bit reversals it is a valid nested-uniform (Owen) scramble of the unit
    interval.  Constants from Burley (JCGT 2020)."""
    x = jnp.asarray(x, jnp.uint32) + jnp.asarray(seed, jnp.uint32)
    x = x ^ (x * np.uint32(0x6C50B47C))
    x = x ^ (x * np.uint32(0xB82F1E52))
    x = x ^ (x * np.uint32(0xC7AFE638))
    x = x ^ (x * np.uint32(0x8D22F6E6))
    return x


def _u32_msb_to_f32(bits: Array) -> Array:
    """Top 24 bits of an MSB-first fraction -> f32 in [0, 1) (the same
    24-bit construction as uniform_hash; the bitcast input is always a
    vector here because the scramble seed is per-pixel)."""
    top = bits >> np.uint32(8)
    ibits = jax.lax.bitcast_convert_type(top, jnp.int32)
    return ibits.astype(jnp.float32) * np.float32(1.0 / (1 << 24))


def sobol02_uniforms(
    pixel_ids: Array,
    sample_index: Array,
    frame_seed_u32: Array,
    nbits: int,
    rot_salt=_STRATUM_ROT_SALT,
) -> tuple[Array, Array]:
    """Owen-scrambled 2D Sobol point of `sample_index` for one dimension
    pair, scrambled per (pixel, frame, pair).

    `rot_salt` identifies the pair (same salt map as the stratified
    rotations: 5 AA, 6 scatter, 7 lens, 8+l NEE); the x/y scramble keys are
    chained hashes of the sample-0 pixel seed under that salt.  `nbits`
    bounds the index (sample_index < 2^nbits, i.e. the spp budget) so the
    dimension-1 XOR unrolls to nbits steps instead of 32.  `sample_index`
    may be a scalar or a per-lane array (the regenerating wavefront pool).
    """
    s = jnp.asarray(sample_index, jnp.uint32)
    base = hash_pixel_seeds(pixel_ids, jnp.uint32(0), frame_seed_u32)
    seed_x = hash2(base, rot_salt)
    seed_y = wgsl_hash(seed_x)
    # Dimension 0 is the bit-reversed index, so its scramble's inner
    # reversal cancels: owen(reverse(s)) = reverse(LK(s)).
    x = _reverse_bits32(_laine_karras(s, seed_x))
    y1 = jnp.zeros_like(s)
    for b in range(nbits):
        y1 = y1 ^ (((s >> np.uint32(b)) & np.uint32(1)) * _SOBOL_DIM1[b])
    y = _reverse_bits32(_laine_karras(_reverse_bits32(y1), seed_y))
    return _u32_msb_to_f32(x), _u32_msb_to_f32(y)


def sampler_uniforms(
    u1: Array,
    u2: Array,
    pixel_ids: Array,
    sample_index: Array,
    frame_seed_u32: Array,
    spec: tuple | None,
    rot_salt=_STRATUM_ROT_SALT,
) -> tuple[Array, Array]:
    """Dispatch one dimension pair through the configured sampler.

    `spec` is RenderConfig.sampler_spec: None passes the independent (u1, u2)
    draws through; ('stratified', kx, ky) remaps them into sample s's
    stratum; ('sobol', nbits) REPLACES them with the Owen-scrambled Sobol
    point (the independent draws go unused and are dead-code-eliminated).
    `rot_salt` identifies the pair — distinct salts give independently
    rotated grids / independently scrambled Sobol pairs.
    """
    if spec is None:
        return u1, u2
    if spec[0] == "stratified":
        return stratified_uniforms(
            u1, u2, pixel_ids, sample_index, frame_seed_u32, spec[1:],
            rot_salt=rot_salt,
        )
    if spec[0] == "sobol":
        return sobol02_uniforms(
            pixel_ids, sample_index, frame_seed_u32, spec[1], rot_salt=rot_salt
        )
    raise ValueError(f"unknown sampler spec {spec!r}")


def sampler_jitter(
    u1: Array,
    u2: Array,
    pixel_ids: Array,
    sample_index: Array,
    frame_seed_u32: Array,
    spec: tuple | None,
) -> tuple[Array, Array]:
    """AA pixel-jitter pair in [-0.5, 0.5) under the configured sampler
    (sampler_uniforms shifted to be jitter-centered)."""
    su1, su2 = sampler_uniforms(
        u1, u2, pixel_ids, sample_index, frame_seed_u32, spec
    )
    return su1 - 0.5, su2 - 0.5


def hash_pixel_seeds(pixel_ids: Array, sample_index: Array, frame_seed_u32: Array) -> Array:
    """Per-pixel base seed from global pixel id + sample index + frame seed."""
    return wgsl_hash(
        jnp.asarray(pixel_ids, jnp.uint32) * _PIX_MUL
        ^ wgsl_hash(
            jnp.asarray(sample_index, jnp.uint32) * _SAMPLE_MUL
            + jnp.asarray(frame_seed_u32, jnp.uint32)
        )
    )


def pixel_seeds(
    width: int,
    height: int,
    sample_index: Array,
    frame_seed_u32: Array,
    y_offset: Array | int = 0,
) -> Array:
    """Per-pixel base seed grid, matching get_ray's derivation (wgsl:309-311):
    hash(hash(x*73) ^ hash(y*51) ^ (sample_index*25 + frame_seed)).

    Returns a (height, width) uint32 array.  `y_offset` shifts the global row
    index (used when rendering a row shard of a larger frame).
    """
    x = jax.lax.broadcasted_iota(jnp.uint32, (height, width), 1)
    y = jax.lax.broadcasted_iota(jnp.uint32, (height, width), 0) + jnp.uint32(y_offset)
    mixed = (
        wgsl_hash(x * jnp.uint32(73))
        ^ wgsl_hash(y * jnp.uint32(51))
        ^ (
            jnp.asarray(sample_index, jnp.uint32) * jnp.uint32(25)
            + jnp.asarray(frame_seed_u32, jnp.uint32)
        )
    )
    return wgsl_hash(mixed)
