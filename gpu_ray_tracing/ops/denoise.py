"""AOV-guided denoiser: edge-avoiding a-trous wavelet filter.

The reference has no denoiser (it converges by progressive accumulation
alone, compute_shader.wgsl:352-358); this is the offline companion to the
framework's AOV integrator modes (`integrator='albedo'|'depth'|'normal'`),
whose stated purpose is to feed exactly this kind of filter.  Design is the
standard production recipe:

  - Edge-avoiding a-trous wavelet decomposition (Dammertz et al., HPG 2010):
    `iterations` passes of a 5x5 B3-spline kernel whose taps spread by 2^i,
    giving a large effective footprint for 25 taps/pass.
  - SVGF-style guide weights (Schied et al., HPG 2017): luminance, normal
    and relative-depth edge-stopping functions multiply the spline weight,
    so smoothing never crosses geometry or shading edges.
  - Albedo demodulation: the filter runs on irradiance (color / albedo) and
    re-modulates afterwards, so texture detail is untouched.

Device mapping: everything is elementwise arithmetic plus static `jnp.roll`
shifts over the row/lane axes — XLA fuses each pass into a handful of HBM
sweeps; there is nothing here that wants a Pallas kernel.  The filter is
pure, jittable, vmappable, and differentiable (it is plain arithmetic), so
it composes with the framework's gradient path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

# 1D B3-spline; the 5x5 kernel is its outer product (Dammertz et al. eq. 1).
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)

_LUMA = (0.2126, 0.7152, 0.0722)


def _luminance(rgb: Array) -> Array:
    return (
        _LUMA[0] * rgb[..., 0] + _LUMA[1] * rgb[..., 1] + _LUMA[2] * rgb[..., 2]
    )


def _shifted(x: Array, dy: int, dx: int) -> Array:
    """Value at pixel p + (dy, dx), positionally aligned with p.

    jnp.roll wraps; out-of-frame taps are killed by the validity mask the
    caller multiplies into the weight (clamp/extend edge handling would
    also be fine — zero-weight is simplest and keeps the filter a true
    partition of unity over valid taps).
    """
    return jnp.roll(x, (-dy, -dx), axis=(0, 1))


def _valid_mask(h: int, w: int, dy: int, dx: int) -> Array:
    rows = jnp.arange(h) + dy
    cols = jnp.arange(w) + dx
    ok_r = (rows >= 0) & (rows < h)
    ok_c = (cols >= 0) & (cols < w)
    return (ok_r[:, None] & ok_c[None, :]).astype(jnp.float32)


def atrous_denoise(
    color: Array,
    *,
    albedo: Array | None = None,
    normal: Array | None = None,
    depth: Array | None = None,
    iterations: int = 4,
    sigma_color: float = 0.45,
    sigma_normal: float = 64.0,
    sigma_depth: float = 2.0,
    demodulate: bool = True,
    eps: float = 1e-4,
) -> Array:
    """Denoise a linear-RGB (H, W, 3) render using optional AOV guides.

    Args:
      color:  the noisy beauty pass, (H, W, 3) float32 linear RGB.
      albedo: first-hit albedo AOV (H, W, 3) — used to demodulate texture
              detail out of the filtered signal (`demodulate=True`).
      normal: decoded shading normals (H, W, 3), unit-ish; miss pixels may
              hold anything (the depth guide separates them).
      depth:  first-hit metric distance (H, W), 0 on miss.
      iterations: a-trous passes; effective radius ~ 2 * 2^iterations.
      sigma_color:  luminance edge-stop scale (bigger = smoother).
      sigma_normal: exponent on max(0, n_p . n_q) (bigger = stricter edges).
      sigma_depth:  depth edge-stop scale, gradient-normalized (SVGF eq. 3):
                    exp(-|z_p - z_q| / (sigma_depth * |grad z . (q - p)| + e)),
                    where grad z is the screen-space depth gradient at p —
                    so a plane seen at grazing incidence (large but
                    PREDICTED per-pixel depth change, e.g. the ground)
                    filters freely while true silhouettes stop the filter.
                    The epsilon is scene-scale relative (1e-2 * z_p), so
                    the weight is invariant to scene units and miss pixels
                    (z = 0 everywhere) form one flat region.
      demodulate: filter irradiance = color / max(albedo, eps) and
                  re-modulate, preserving albedo texture exactly.

    Each guide is optional: with none given this degrades to the classic
    color-edge-stopping a-trous filter; with iterations=0 it is the
    identity.  Pure function of its inputs — safe under jit/vmap/grad.
    """
    if color.ndim != 3 or color.shape[-1] != 3:
        raise ValueError(f"color must be (H, W, 3), got {color.shape}")
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    if sigma_color <= 0.0:
        raise ValueError(f"sigma_color must be > 0, got {sigma_color}")
    if sigma_depth <= 0.0:
        raise ValueError(f"sigma_depth must be > 0, got {sigma_depth}")
    if sigma_normal < 0.0:
        raise ValueError(f"sigma_normal must be >= 0, got {sigma_normal}")
    h, w = color.shape[0], color.shape[1]
    color = color.astype(jnp.float32)

    if albedo is not None and demodulate:
        alb = jnp.maximum(albedo.astype(jnp.float32), eps)
        signal = color / alb
    else:
        alb = None
        signal = color

    if depth is not None:
        z = depth.astype(jnp.float32)
        if z.ndim == 3:  # the depth AOV broadcasts distance to 3 channels
            z = z[..., 0]
        # Screen-space depth gradient (central differences, edge-replicated)
        # for the SVGF depth weight: |z_p - z_q| is compared against the
        # change the LOCAL SURFACE predicts over the tap offset, not an
        # absolute scale — grazing planes filter, silhouettes stop.
        zp = jnp.pad(z, 1, mode="edge")
        dzdy = 0.5 * (zp[2:, 1:-1] - zp[:-2, 1:-1])
        dzdx = 0.5 * (zp[1:-1, 2:] - zp[1:-1, :-2])
    else:
        z = None
    if normal is not None:
        n = normal.astype(jnp.float32)
        n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
    else:
        n = None

    # Per-offset validity masks are shared across iterations via the scaled
    # offset; precompute nothing — XLA constant-folds the iota compares.
    for it in range(iterations):
        step = 1 << it
        lum = _luminance(signal)
        num = jnp.zeros_like(signal)
        den = jnp.zeros((h, w), jnp.float32)
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                wk = jnp.float32(_B3[ky] * _B3[kx])
                s_q = _shifted(signal, dy, dx)
                wgt = wk * _valid_mask(h, w, dy, dx)
                # Luminance edge stop on the CURRENT (partially filtered)
                # signal, SVGF-style: later, wider passes see a cleaner
                # signal and stop on real edges rather than noise.
                l_q = _shifted(lum, dy, dx)
                wgt = wgt * jnp.exp(-jnp.abs(lum - l_q) / jnp.float32(sigma_color))
                if n is not None:
                    n_q = _shifted(n, dy, dx)
                    ndot = jnp.maximum(jnp.sum(n * n_q, axis=-1), 0.0)
                    wgt = wgt * ndot ** jnp.float32(sigma_normal)
                if z is not None:
                    z_q = _shifted(z, dy, dx)
                    predicted = jnp.abs(dzdy * dy + dzdx * dx)
                    rel = jnp.abs(z - z_q) / (
                        jnp.float32(sigma_depth) * predicted
                        + 1e-2 * z
                        + jnp.float32(eps)
                    )
                    wgt = wgt * jnp.exp(-rel)
                num = num + wgt[..., None] * s_q
                den = den + wgt
        # The center tap's weight is wk * ndot^sigma > 0 for any unit-ish
        # center normal, but a user-supplied ZERO normal (the norm clamp
        # leaves n = 0, so ndot = 0) kills every tap — such pixels keep
        # their current value instead of producing NaN via 0/0.
        dead = den <= 1e-12
        signal = jnp.where(
            dead[..., None], signal, num / jnp.maximum(den, 1e-12)[..., None]
        )

    if alb is not None:
        signal = signal * alb
    return signal


def decode_normal_aov(aov: Array) -> Array:
    """Invert the normal integrator's 0.5*(n+1) encoding back to vectors.

    Miss pixels hold the sky gradient and decode to garbage directions;
    pair this guide with the depth AOV (0 on miss) so the depth edge-stop
    isolates them.
    """
    return 2.0 * aov - 1.0
