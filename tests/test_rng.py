"""Tests for the WGSL-parity RNG (compute_shader.wgsl:50-63)."""

import jax.numpy as jnp
import numpy as np
import pytest

from gpu_ray_tracing.ops import rng


def _hash_py(value: int) -> int:
    """Independent Python-int reimplementation of wgsl:50-59."""
    m = (1 << 32) - 1
    state = value & m
    state ^= 2747636419
    state = (state * 2654435769) & m
    state ^= state >> 16
    state = (state * 2654435769) & m
    state ^= state >> 16
    state = (state * 2654435769) & m
    return state


@pytest.mark.parametrize("value", [0, 1, 2, 73, 51 * 7, 2**31, 2**32 - 1, 123456789])
def test_wgsl_hash_matches_scalar_reference(value):
    got = int(rng.wgsl_hash(jnp.uint32(value)))
    assert got == _hash_py(value)


def test_wgsl_hash_vectorized():
    vals = np.array([0, 1, 999, 2**32 - 1], np.uint32)
    got = np.asarray(rng.wgsl_hash(jnp.asarray(vals)))
    expected = np.array([_hash_py(int(v)) for v in vals], np.uint32)
    np.testing.assert_array_equal(got, expected)


def test_random_float_range_and_value():
    vals = jnp.arange(0, 10000, dtype=jnp.uint32)
    f = np.asarray(rng.wgsl_random_float(vals))
    assert f.min() >= 0.0 and f.max() <= 1.0
    # Exact value check against the scalar reference for one input.
    expected = np.float32(_hash_py(42)) / np.float32(4294967295.0)
    assert np.float32(rng.wgsl_random_float(jnp.uint32(42))) == expected


def test_random_float_roughly_uniform():
    vals = jnp.arange(0, 100000, dtype=jnp.uint32)
    f = np.asarray(rng.wgsl_random_float(vals))
    assert abs(f.mean() - 0.5) < 0.01
    hist, _ = np.histogram(f, bins=10, range=(0, 1))
    assert hist.min() > 8000  # no empty decile

def test_random_unit_vector_is_unit_and_uniform():
    seeds = jnp.arange(0, 20000, 2, dtype=jnp.uint32)
    v = np.asarray(rng.random_unit_vector(seeds))
    norms = np.linalg.norm(v, axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    # Mean should be near the origin for a uniform sphere distribution.
    assert np.all(np.abs(v.mean(axis=0)) < 0.05)


def test_unit_vector_from_uniforms():
    u1 = jnp.linspace(0.01, 0.99, 512)
    u2 = jnp.linspace(0.0, 1.0, 512)
    v = np.asarray(rng.unit_vector_from_uniforms(u1, u2))
    np.testing.assert_allclose(np.linalg.norm(v, axis=-1), 1.0, atol=1e-5)


def test_seed_from_f32_saturates():
    assert int(rng.seed_from_f32(jnp.float32(0.0))) == 0
    # 1.0 * 4294967295.0 rounds to 2^32 in f32; WGSL's u32() saturates that
    # to u32::MAX (not to the largest representable f32 below 2^32).
    assert int(rng.seed_from_f32(jnp.float32(1.0))) == 4294967295
    # Just below the rounding threshold, the cast is exact.
    assert int(rng.seed_from_f32(jnp.float32(0.99999988))) == 4294966784
    mid = int(rng.seed_from_f32(jnp.float32(0.5)))
    assert abs(mid - 2**31) < 2**10


def test_pixel_seeds_match_get_ray_derivation():
    """pixel_seeds must equal hash(hash(x*73) ^ hash(y*51) ^ (s*25 + fs))
    per wgsl:309-311."""
    width, height = 7, 5
    sample_index, frame_seed = 11, 98765
    seeds = np.asarray(rng.pixel_seeds(width, height, jnp.uint32(sample_index), jnp.uint32(frame_seed)))
    m = (1 << 32) - 1
    for y in range(height):
        for x in range(width):
            mixed = (
                _hash_py((x * 73) & m)
                ^ _hash_py((y * 51) & m)
                ^ ((sample_index * 25 + frame_seed) & m)
            ) & m
            assert int(seeds[y, x]) == _hash_py(mixed), (x, y)


def test_uniform_hash_24bit_construction():
    """uniform_hash = (hash2 >> 8) / 2^24 — exactly representable f32s."""
    from gpu_ray_tracing.ops.rng import hash2, uniform_hash

    seeds = jnp.arange(0, 4096, dtype=jnp.uint32)
    u = np.asarray(uniform_hash(seeds, 3))
    bits = np.asarray(hash2(seeds, 3)) >> 8
    np.testing.assert_array_equal(u, bits.astype(np.float32) / (1 << 24))
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.02


def test_uniform_hash_salts_decorrelated():
    from gpu_ray_tracing.ops.rng import uniform_hash

    seeds = jnp.arange(0, 10000, dtype=jnp.uint32)
    a = np.asarray(uniform_hash(seeds, 1))
    b = np.asarray(uniform_hash(seeds, 2))
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.05


# --------------------------------------------------------------------------
# Stratified sampler (ops/rng.strata_shape + sampler_jitter)
# --------------------------------------------------------------------------


def test_strata_shape_factors_exactly():
    for spp, want in [(1, (1, 1)), (2, (1, 2)), (7, (1, 7)), (8, (2, 4)),
                      (12, (3, 4)), (16, (4, 4)), (500, (20, 25))]:
        kx, ky = rng.strata_shape(spp)
        assert (kx, ky) == want
        assert kx * ky == spp
    with pytest.raises(ValueError):
        rng.strata_shape(0)


def test_stratified_jitter_covers_every_stratum_once():
    """Over K consecutive samples, each pixel visits every stratum of the
    (kx, ky) grid exactly once (the variance-reduction contract)."""
    kx, ky = rng.strata_shape(12)
    k_total = kx * ky
    pid = jnp.arange(97, dtype=jnp.uint32) * jnp.uint32(13)  # arbitrary ids
    u_mid = jnp.full(pid.shape, 0.5, jnp.float32)
    cells = []
    for s in range(k_total):
        jx, jy = rng.sampler_jitter(
            u_mid, u_mid, pid, jnp.uint32(s), jnp.uint32(3),
            ("stratified", kx, ky),
        )
        assert float(jnp.min(jx)) >= -0.5 and float(jnp.max(jx)) < 0.5
        assert float(jnp.min(jy)) >= -0.5 and float(jnp.max(jy)) < 0.5
        cx = np.floor((np.asarray(jx) + 0.5) * kx)
        cy = np.floor((np.asarray(jy) + 0.5) * ky)
        cells.append((cy * kx + cx).astype(np.int64))
    cells = np.stack(cells)  # (K, pixels)
    for p in range(cells.shape[1]):
        assert sorted(cells[:, p]) == list(range(k_total))


def test_stratified_jitter_single_sample_marginally_uniform():
    """Any ONE sample is uniform over the pixel across the pixel/seed
    population (the per-(pixel, frame) stratum rotation is Cranley-
    Patterson), so partial accumulation stays unbiased."""
    pid = jnp.arange(1 << 14, dtype=jnp.uint32)
    seeds = rng.hash_pixel_seeds(pid, jnp.uint32(0), jnp.uint32(9))
    u1 = rng.uniform_hash(seeds, 1)
    u2 = rng.uniform_hash(seeds, 2)
    jx, jy = rng.sampler_jitter(u1, u2, pid, jnp.uint32(0), jnp.uint32(9), ("stratified", 4, 4))
    for j in (np.asarray(jx), np.asarray(jy)):
        assert abs(j.mean()) < 5e-3
        # Uniform on [-0.5, 0.5): variance 1/12, each quartile ~25%.
        assert abs(j.var() - 1.0 / 12.0) < 2e-3
        hist, _ = np.histogram(j, bins=4, range=(-0.5, 0.5))
        assert np.all(np.abs(hist / j.size - 0.25) < 0.02)


def test_stratified_jitter_spp1_equals_independent():
    pid = jnp.arange(64, dtype=jnp.uint32)
    seeds = rng.hash_pixel_seeds(pid, jnp.uint32(2), jnp.uint32(5))
    u1 = rng.uniform_hash(seeds, 1)
    u2 = rng.uniform_hash(seeds, 2)
    jx, jy = rng.sampler_jitter(u1, u2, pid, jnp.uint32(2), jnp.uint32(5), ("stratified", 1, 1))
    np.testing.assert_array_equal(np.asarray(jx), np.asarray(u1) - 0.5)
    np.testing.assert_array_equal(np.asarray(jy), np.asarray(u2) - 0.5)


# ---------------------------------------------------------------------------
# Owen-scrambled Sobol sampler (ops/rng.sobol02_uniforms + dispatchers)
# ---------------------------------------------------------------------------


def test_sobol_nbits():
    # Covers the largest index the progressive straddle window can reach
    # (< 2*spp - 1), not just spp - 1 — see the docstring.
    assert rng.sobol_nbits(1) == 1
    assert rng.sobol_nbits(2) == 2
    assert rng.sobol_nbits(16) == 5
    assert rng.sobol_nbits(17) == 6
    with pytest.raises(ValueError):
        rng.sobol_nbits(0)


def test_sobol02_prefixes_are_02_nets():
    """Owen scrambling preserves the (0,2)-net property: for any 2^k prefix
    of one pixel's samples, every elementary binary rectangle of area 2^-k
    holds exactly one point — for every split of k between the axes."""
    pid = jnp.full((1,), 12345, jnp.uint32)
    for nbits, n in ((4, 16), (5, 32)):
        pts = np.array([
            [float(v[0]) for v in rng.sobol02_uniforms(
                pid, jnp.uint32(s), jnp.uint32(77), nbits)]
            for s in range(n)
        ])
        k = n.bit_length() - 1
        for a in range(k + 1):
            b = k - a
            cells = (
                np.floor(pts[:, 0] * (1 << a)).astype(int) * (1 << b)
                + np.floor(pts[:, 1] * (1 << b)).astype(int)
            )
            counts = np.bincount(cells, minlength=n)
            assert (counts == 1).all(), (n, a, b, counts)


def test_sobol02_single_sample_marginally_uniform():
    """The per-(pixel, frame, pair) scramble makes any single sample index
    marginally uniform over pixels — no bias at partial accumulation."""
    pids = jnp.arange(200000, dtype=jnp.uint32)
    for s in (0, 3):
        x, y = rng.sobol02_uniforms(pids, jnp.uint32(s), jnp.uint32(3), 4)
        for v in (np.asarray(x), np.asarray(y)):
            assert abs(v.mean() - 0.5) < 2e-3
            hist, _ = np.histogram(v, bins=16, range=(0, 1))
            assert np.all(np.abs(hist / v.size - 1 / 16) < 4e-3)


def test_sobol02_pairs_decorrelated():
    """Distinct rot_salts (dimension-pair ids) give independently scrambled
    points: the AA and lens pairs of the same sample must not correlate."""
    pids = jnp.arange(100000, dtype=jnp.uint32)
    x1, _ = rng.sobol02_uniforms(pids, jnp.uint32(0), jnp.uint32(3), 4)
    x2, _ = rng.sobol02_uniforms(
        pids, jnp.uint32(0), jnp.uint32(3), 4, rot_salt=rng._LENS_ROT_SALT
    )
    c = np.corrcoef(np.asarray(x1), np.asarray(x2))[0, 1]
    assert abs(c) < 0.01, c


def test_sampler_uniforms_dispatch():
    pid = jnp.arange(64, dtype=jnp.uint32)
    seeds = rng.hash_pixel_seeds(pid, jnp.uint32(2), jnp.uint32(5))
    u1 = rng.uniform_hash(seeds, 1)
    u2 = rng.uniform_hash(seeds, 2)
    a1, a2 = rng.sampler_uniforms(u1, u2, pid, jnp.uint32(2), jnp.uint32(5), None)
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(u1))
    np.testing.assert_array_equal(np.asarray(a2), np.asarray(u2))
    s1, s2 = rng.sampler_uniforms(
        u1, u2, pid, jnp.uint32(2), jnp.uint32(5), ("stratified", 2, 2)
    )
    e1, e2 = rng.stratified_uniforms(u1, u2, pid, jnp.uint32(2), jnp.uint32(5), (2, 2))
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(e1))
    np.testing.assert_array_equal(np.asarray(s2), np.asarray(e2))
    q1, q2 = rng.sampler_uniforms(
        u1, u2, pid, jnp.uint32(2), jnp.uint32(5), ("sobol", 4)
    )
    b1, b2 = rng.sobol02_uniforms(pid, jnp.uint32(2), jnp.uint32(5), 4)
    np.testing.assert_array_equal(np.asarray(q1), np.asarray(b1))
    np.testing.assert_array_equal(np.asarray(q2), np.asarray(b2))
    with pytest.raises(ValueError, match="sampler spec"):
        rng.sampler_uniforms(u1, u2, pid, jnp.uint32(2), jnp.uint32(5), ("bogus",))
