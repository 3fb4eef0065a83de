"""Progressive accumulation: the resumable render state.

Reference mapping (compute_shader.wgsl `update`, wgsl:333-364):
  - rgb  = running mean color      <- the texel's rgb (wgsl:339-341)
  - count = samples accumulated    <- the texel's alpha channel (wgsl:341)
  - reset-on-camera-move           <- camera_has_moved flag (wgsl:345-350);
                                      here reset is an explicit argument, not
                                      a hidden flag smuggled through a uniform
  - freeze at the spp target       <- `samples < samples_per_pixel` gate
                                      (wgsl:352)
  - incremental mean               <- c += (x - c) / (n + 1) (wgsl:356)

The state is a plain pytree, so it is trivially serializable (np.save/orbax)
— a 1024-spp progressive render is checkpoint/resumable for free, which the
reference only gets within a single process lifetime (SURVEY §5).

The sample count is a scalar: the reference stores it per-pixel in alpha, but
resets are global and every pixel always holds the same count, so a scalar is
the same state without the redundant (H, W) plane.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rgb", "count"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class AccumState:
    """Progressive accumulation state: rgb = running mean, count = samples."""

    rgb: Array  # (H, W, 3) f32 running mean in linear space
    count: Array  # () i32 samples accumulated so far


def init_accum(height: int, width: int) -> AccumState:
    """Zero state — the `init` kernel entry point (wgsl:65-70)."""
    return AccumState(
        rgb=jnp.zeros((height, width, 3), jnp.float32),
        count=jnp.zeros((), jnp.int32),
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rgb_sum", "count", "mlum", "m2"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class AdaptiveAccumState:
    """Adaptive progressive accumulation state (megakernel adaptive mode).

    Unlike AccumState (scalar count, running mean), adaptive sampling stops
    per TILE on a data-dependent test, so the state carries per-pixel RAW
    SUMS plus the in-kernel Welford statistics (per-pixel luminance mean and
    M2).  Carrying the Welford state is what makes a chunked progressive
    run take EXACTLY the samples the one-shot adaptive render takes: the
    kernel resumes its convergence test mid-stream, so stopping decisions —
    evaluated at the same absolute sample indices with the same statistics
    — are identical, and the final sums are bitwise equal (a fold of means
    would round differently and could not reproduce the stopping rule at
    all).

    `count` is per-pixel f32 (constant within each kernel tile); `image`
    is the current estimate.
    """

    rgb_sum: Array  # (H, W, 3) f32 raw radiance sums
    count: Array  # (H, W) f32 samples taken per pixel (tile-constant)
    mlum: Array  # (H, W) f32 Welford running luminance mean
    m2: Array  # (H, W) f32 Welford running luminance M2

    @property
    def image(self) -> Array:
        """Current per-pixel mean estimate (zeros where count == 0)."""
        return self.rgb_sum / jnp.maximum(self.count, 1.0)[..., None]


def init_adaptive_accum(height: int, width: int) -> AdaptiveAccumState:
    """Zero adaptive accumulation state."""
    z = jnp.zeros((height, width), jnp.float32)
    return AdaptiveAccumState(
        rgb_sum=jnp.zeros((height, width, 3), jnp.float32),
        count=z, mlum=z, m2=z,
    )


def fold_sample(
    state: AccumState,
    sample_rgb: Array,
    spp_target: int,
    reset,
    num_samples: int = 1,
) -> AccumState:
    """Fold a render into the running mean (wgsl:345-358).

    `sample_rgb` is the MEAN of `num_samples` fresh samples (1 = the
    reference's frame-at-a-time update; >1 = a batched step, which is how
    the wavefront regeneration engine amortizes deep-bounce tails across
    samples).  The weighted incremental mean
    `c += (x - c) * k / (n + k)` reduces to the reference's
    `c += (x - c) / (n + 1)` at k=1.

    reset: traced bool — clears the state first (camera moved).
    The update freezes once count reaches spp_target (wgsl:352).  A batched
    step that straddles the target (possible despite progressive_step's
    static divisibility check when a checkpoint is resumed at a count that
    is not a multiple of the step size) folds only its TAKEN fraction: the
    batch mean is weighted as spp_target - count samples, so the count
    freezes exactly at the target.  Each sample in the batch mean is an
    unbiased estimate of the pixel value, so down-weighting the batch keeps
    the estimator unbiased — only the effective per-sample weights differ
    from the aligned case.
    """
    reset = jnp.asarray(reset, bool)
    rgb = jnp.where(reset, 0.0, state.rgb)
    count = jnp.where(reset, 0, state.count)

    converged = count >= spp_target
    if num_samples == 1:
        # Keep the reference's exact arithmetic (one rounding via the
        # division) so 1-spp progressive accumulation stays bit-stable
        # against the goldens.
        new_rgb = rgb + (sample_rgb - rgb) / jnp.float32(count + 1)
        new_count = count + 1
    else:
        take = jnp.clip(spp_target - count, 0, num_samples)
        k = take.astype(jnp.float32)
        denom = jnp.maximum(count.astype(jnp.float32) + k, 1.0)
        new_rgb = rgb + (sample_rgb - rgb) * (k / denom)
        new_count = count + take
    return AccumState(
        rgb=jnp.where(converged, rgb, new_rgb),
        count=jnp.where(converged, count, new_count),
    )
