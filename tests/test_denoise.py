"""Tests for the AOV-guided a-trous denoiser (ops/denoise.py).

The reference has no denoiser (it converges by accumulation alone,
compute_shader.wgsl:352-358); these tests pin the filter's contract: a
partition of unity (constants pass through), noise genuinely reduced
against a converged reference, guide edges respected, and the whole path
jittable + differentiable.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing.api import render, render_denoised
from gpu_ray_tracing.models.camera import CameraSettings
from gpu_ray_tracing.models.spheres import base_scene
from gpu_ray_tracing.ops.denoise import atrous_denoise, decode_normal_aov
from gpu_ray_tracing.utils.config import RenderConfig


def _noisy_step_image(key, h=48, w=64, noise=0.25):
    """A two-region step image + per-pixel noise, with clean AOV guides."""
    left = jnp.asarray([0.9, 0.2, 0.1], jnp.float32)
    right = jnp.asarray([0.1, 0.3, 0.9], jnp.float32)
    mask = (jnp.arange(w) >= w // 2).astype(jnp.float32)[None, :, None]
    clean = left * (1.0 - mask) + right * mask
    clean = jnp.broadcast_to(clean, (h, w, 3))
    noisy = clean + noise * jax.random.normal(key, (h, w, 3))
    albedo = clean
    normal = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (h, w, 3)
    )
    depth = 1.0 + 4.0 * mask[..., 0] * jnp.ones((h, w), jnp.float32)
    return clean, noisy, albedo, normal, depth


def test_identity_at_zero_iterations():
    key = jax.random.key(0)
    _, noisy, albedo, normal, depth = _noisy_step_image(key)
    out = atrous_denoise(
        noisy, albedo=albedo, normal=normal, depth=depth, iterations=0
    )
    np.testing.assert_allclose(np.asarray(out), np.asarray(noisy), atol=1e-6)


def test_constant_image_is_fixed_point():
    # The weights form a partition of unity over valid taps: a constant
    # signal must pass through every iteration unchanged (no gain, no
    # edge darkening), with or without guides.
    img = jnp.full((40, 56, 3), 0.37, jnp.float32)
    out = atrous_denoise(img, iterations=4)
    np.testing.assert_allclose(np.asarray(out), 0.37, atol=1e-5)
    out_guided = atrous_denoise(
        img,
        albedo=jnp.full_like(img, 0.5),
        normal=jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), img.shape),
        depth=jnp.ones(img.shape[:2]),
        iterations=4,
    )
    np.testing.assert_allclose(np.asarray(out_guided), 0.37, atol=1e-5)


def test_reduces_noise_and_preserves_guide_edges():
    clean, noisy, albedo, normal, depth = _noisy_step_image(jax.random.key(3))
    out = atrous_denoise(
        noisy, albedo=albedo, normal=normal, depth=depth, iterations=4
    )
    mse_before = float(jnp.mean((noisy - clean) ** 2))
    mse_after = float(jnp.mean((out - clean) ** 2))
    assert mse_after < 0.25 * mse_before, (mse_before, mse_after)
    # The albedo/depth step at w//2 must survive: region means stay put.
    out_np = np.asarray(out)
    clean_np = np.asarray(clean)
    w = out_np.shape[1]
    left_err = abs(out_np[:, : w // 2].mean() - clean_np[:, : w // 2].mean())
    right_err = abs(out_np[:, w // 2 :].mean() - clean_np[:, w // 2 :].mean())
    assert left_err < 0.02 and right_err < 0.02, (left_err, right_err)
    # Edge contrast retained (not smeared to the midpoint): compare the two
    # columns adjacent to the edge.
    edge_gap = np.abs(
        out_np[:, w // 2] - out_np[:, w // 2 - 1]
    ).mean()
    clean_gap = np.abs(clean_np[:, w // 2] - clean_np[:, w // 2 - 1]).mean()
    assert edge_gap > 0.6 * clean_gap, (edge_gap, clean_gap)


def test_unguided_filter_smooths():
    clean, noisy, *_ = _noisy_step_image(jax.random.key(5), noise=0.1)
    out = atrous_denoise(noisy, iterations=3, sigma_color=1.0)
    assert float(jnp.mean((out - clean) ** 2)) < float(
        jnp.mean((noisy - clean) ** 2)
    )


def test_differentiable_and_jittable():
    clean, noisy, albedo, normal, depth = _noisy_step_image(jax.random.key(7))

    @jax.jit
    def loss(img):
        out = atrous_denoise(
            img, albedo=albedo, normal=normal, depth=depth, iterations=2
        )
        return jnp.mean((out - clean) ** 2)

    g = jax.grad(loss)(noisy)
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.max(jnp.abs(g))) > 0.0


def test_decode_normal_aov_roundtrip():
    n = jnp.asarray([[[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]], jnp.float32)
    enc = 0.5 * (n + 1.0)
    np.testing.assert_allclose(np.asarray(decode_normal_aov(enc)), np.asarray(n), atol=1e-6)


def test_render_denoised_end_to_end_beats_noisy_render():
    scene = base_scene()
    settings = CameraSettings.default()
    lo = RenderConfig(width=64, height=48, spp=1, max_depth=6)
    hi = dataclasses.replace(lo, spp=256)
    ref = render(scene, settings, hi, frame_seed=jnp.uint32(9))
    noisy = render(scene, settings, lo, frame_seed=jnp.uint32(9))
    out, beauty, aovs = render_denoised(
        scene, settings, lo, frame_seed=jnp.uint32(9), return_aovs=True
    )
    assert out.shape == (48, 64, 3)
    np.testing.assert_allclose(np.asarray(beauty), np.asarray(noisy), atol=1e-6)
    assert set(aovs) == {"albedo", "normal", "depth"}
    mse_noisy = float(jnp.mean((noisy - ref) ** 2))
    mse_out = float(jnp.mean((out - ref) ** 2))
    # ~0.63 measured; the floor is 1-spp ALIASING at geometric edges, which
    # the guides correctly stop the filter from touching (a denoiser is not
    # an anti-aliaser) — at this tiny resolution edge pixels dominate.  The
    # synthetic-image tests above pin the strong (4x+) smoothing behavior.
    assert mse_out < 0.75 * mse_noisy, (mse_noisy, mse_out)


def test_render_denoised_rejects_aov_integrators():
    scene = base_scene()
    cfg = RenderConfig(width=16, height=16, spp=1, integrator="albedo")
    try:
        render_denoised(scene, CameraSettings.default(), cfg)
    except ValueError as e:
        assert "beauty pass" in str(e)
    else:
        raise AssertionError("expected ValueError for integrator='albedo'")


def test_invalid_inputs_rejected():
    img = jnp.zeros((8, 8, 3), jnp.float32)
    try:
        atrous_denoise(jnp.zeros((8, 8)), iterations=1)
    except ValueError:
        pass
    else:
        raise AssertionError("expected ValueError for non-(H,W,3) color")
    try:
        atrous_denoise(img, iterations=-1)
    except ValueError:
        pass
    else:
        raise AssertionError("expected ValueError for negative iterations")
