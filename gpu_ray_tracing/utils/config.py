"""Render configuration.

The reference hard-codes every knob as a compile-time constant (resolution and
workgroup size at lib.rs:24-26, camera defaults at camera.rs:30-46, movement
speeds at camera.rs:116-122) so changing anything means recompiling the Rust
binary.  Here the same knobs live in one frozen (hashable) dataclass that is
passed as a *static* argument to the jitted render functions: XLA re-traces per
distinct config, and everything that shapes the program (resolution, spp,
depth, integrator) stays a Python-level constant inside the trace.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (jit-static; hashable).

    Mirrors, as explicit config, the reference's scattered constants:
      - width/height       <- SIZE = (1280, 720), lib.rs:24-25
      - spp                <- CameraSettings.samples_per_pixel = 500, camera.rs:33
      - max_depth          <- CameraSettings.max_depth = 30, camera.rs:34
      - t_min/t_max        <- the (0.001, 3.4e35) interval, compute_shader.wgsl:266
    """

    width: int = 1280
    height: int = 720
    spp: int = 1
    max_depth: int = 30

    # 'path'   = full lambertian/metal/dielectric path tracer (wgsl ray_color)
    # 'normal' = normal-shading debug integrator (BASELINE config 1)
    # 'albedo' = first-hit material albedo AOV (denoiser guide channel)
    # 'depth'  = first-hit metric distance AOV (0 on miss), 3 equal channels
    integrator: Literal["path", "normal", "albedo", "depth"] = "path"

    # 'jax'       = pure-JAX/XLA integrator (reference path; runs anywhere)
    # 'pallas'    = fused Pallas megakernel (ops/pallas/megakernel.py),
    #               compiled through Triton on the GPU; requires rng='hash'
    #               and parity=False.  Interprets on the CPU (tests).
    # 'wavefront' = per-bounce ray compaction between Pallas bounce kernels
    #               (ops/pallas/wavefront.py); same image as 'pallas'
    #               (identical RNG stream), wins on deep-bounce path tracing
    #               where most lanes die early.  'normal' integrator renders
    #               fall back to the megakernel (single bounce).
    backend: Literal["jax", "pallas", "wavefront"] = "jax"

    # 'hash'     = counter-based per-pixel hash RNG (default): every draw is
    #              a pure function of (global pixel id, sample, frame seed,
    #              salt), so renders are bit-identical under any sharding or
    #              tiling, and the Pallas kernel derives the same stream.
    # 'threefry' = jax.random streams (shape-dependent; not shard-invariant)
    # 'wgsl'     = bit-exact re-implementation of the reference hash chains
    #              (compute_shader.wgsl:50-63) for golden parity tests
    rng: Literal["hash", "threefry", "wgsl"] = "hash"

    # parity=True reproduces the reference's sampler quirks exactly:
    #   - defocus samples the disk RIM (wgsl:327-331)
    #   - sample_square uses seed*seed for y (wgsl:299-303)
    #   - depth-exhausted rays still get sky * throughput (wgsl:293-296)
    # parity=False fixes all three (uniform disk, independent jitter,
    # exhausted rays -> black).
    parity: bool = False

    # Sky (miss shader) brightness multiplier: 1.0 is the reference's
    # white->blue gradient (wgsl:293-296); 0.0 gives a black background for
    # scenes lit purely by EMISSIVE surfaces.
    sky_intensity: float = 1.0

    # Next-event estimation: sample lights directly with shadow rays at
    # every diffuse bounce (massively less noise in scenes lit by small
    # lights; ~2x per-bounce cost).  Emissive SPHERES (cone-sampled) and
    # emissive MESH FACES (area-sampled triangle lights) share one ordinal
    # space; up to 4 total lights loop deterministically, above that one
    # ordinal is picked per bounce (weight = total cancels the pick pdf) —
    # so arbitrarily large emissive meshes work.  Requires a Scene built
    # via make_scene (the static light lists).  Off by default: the
    # reference is a pure BSDF-sampling tracer.
    nee: bool = False

    # Multiple importance sampling (requires nee=True): instead of dropping
    # BSDF-ray emission hits after a diffuse vertex, weight them against the
    # same vertex's NEE sample of the hit light with the power heuristic
    # (beta=2), and weight the NEE term symmetrically.  Under the > 4-light
    # picked-light estimator both ratios carry the pick pdf (x total on the
    # NEE side, /total on the BSDF side), so any light count works.  Same
    # integral, lower variance where the light is large/close (the regime
    # where cone sampling is noisier than cosine BSDF rays); with <= 4
    # lights never worse than the better single strategy.  Above 4 the
    # 1/total pick density is what the heuristic weighs, so weight shifts
    # toward BSDF-ray hits — still unbiased, but scenes of MANY SMALL
    # lights can see more speckle than plain nee (whose binary exclusion
    # keeps the full-weight NEE sample).  Costs one extra carried plane.
    mis: bool = False

    # Sample-generation strategy for the four stratifiable dimension pairs
    # (AA jitter, thin-lens point, first-bounce scatter, first-bounce NEE):
    #   'independent' = one independent uniform draw per sample per pair
    #                   (the reference's sample_square, wgsl:299-303)
    #   'stratified'  = jittered stratification of the spp budget over a
    #                   near-square (kx, ky) grid per pair, each pair under
    #                   an independent per-(pixel, frame) rotation of the
    #                   stratum order (ops/rng.stratified_uniforms): lower
    #                   variance at equal spp, unbiased at any partial
    #                   accumulation count, zero per-sample cost.
    #   'sobol'       = Owen-scrambled Sobol (0,2)-sequence per pair
    #                   (ops/rng.sobol02_uniforms), scrambled per
    #                   (pixel, frame, pair): every power-of-two prefix of
    #                   a pixel's samples is a (0,2)-net — strictly finer
    #                   stratification than the grid, best at
    #                   power-of-two spp.
    # Both non-default modes require rng='hash' (pairs are addressed by
    # absolute sample index, which threefry keys and the wgsl parity chain
    # don't carry).
    sampler: Literal["independent", "stratified", "sobol"] = "independent"

    # Wavefront ray regeneration (backend='wavefront' only): keep ONE
    # persistent ray pool across the spp samples, refilling ray rows whose
    # 128 rays have all died with the next sample's primary rays, so the
    # deep-bounce tail of one sample overlaps the cheap early bounces of the
    # next.  Identical per-ray streams (the counter RNG carries absolute
    # sample ids per lane); per-pixel sums can differ in the last float bits
    # only through accumulation order.  'auto' turns it on when spp > 1;
    # 'off' (default) keeps the sample-major loop, whose sums are bitwise
    # identical to the megakernel's.
    regenerate: Literal["auto", "on", "off"] = "off"

    # Adaptive sampling (backend='pallas' one-shot renders only): > 0 makes
    # spp a per-tile BUDGET — each pixel block's in-kernel sample
    # loop exits once the tile-mean relative standard error of its estimate
    # (Welford-tracked per-pixel luminance variance) drops below this
    # tolerance, after adaptive_min_spp samples.  Converged regions (sky,
    # flat diffuse) stop early; noisy ones (penumbras, glass) spend the
    # full budget.  Samples are a prefix of the identical stream, but the
    # stopping rule is data-dependent, so early-stopped tiles are mildly
    # biased (the standard adaptive-sampling caveat) — keep the tolerance
    # at or below the visible noise floor, and note gradients replay the
    # jax path at full spp (exact for non-adaptive renders, approximate
    # under adaptive).  Composes with `api.adaptive_progressive_step`
    # (per-pixel count plane; bitwise equal to the one-shot render) and
    # with ROW-sharded `render_sharded` meshes (spp axis must be 1);
    # fold-based `progressive_step` and spp-axis shards need exact
    # per-sample counts and still reject adaptive configs.
    adaptive_tol: float = 0.0
    adaptive_min_spp: int = 8

    # Per-SAMPLE max-component radiance clamp (firefly control): 0 = off.
    # Each sample's rgb is scaled so its largest channel is at most this
    # value, hue-preserving, BEFORE accumulation - progressive steps, spp
    # batches and one-shot renders of one budget stay identical, and all
    # engines share the arithmetic (ops/integrators.clamp_radiance).
    # Biased (removes energy from rare bright paths - the standard
    # production trade); path integrator only; incompatible with the
    # regenerating wavefront pool (no per-sample total exists there).
    clamp: float = 0.0

    # Russian-roulette path termination: 0 disables (the reference always
    # runs to max_depth); k > 0 stochastically kills low-throughput paths
    # from bounce k on, dividing surviving throughput by the survival
    # probability (unbiased).  Large speedups at high max_depth.
    russian_roulette_depth: int = 0

    t_min: float = 1.0e-3
    t_max: float = 3.4e35

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"invalid resolution {self.width}x{self.height}")
        if self.spp <= 0:
            raise ValueError(f"spp must be positive, got {self.spp}")
        if self.max_depth <= 0:
            raise ValueError(f"max_depth must be positive, got {self.max_depth}")
        if self.parity and self.rng != "wgsl":
            raise ValueError("parity=True requires rng='wgsl'")
        if self.backend in ("pallas", "wavefront") and self.rng != "hash":
            raise ValueError(f"backend={self.backend!r} requires rng='hash'")
        if self.sampler != "independent" and self.rng != "hash":
            raise ValueError(
                f"sampler={self.sampler!r} requires rng='hash' (sample "
                "points are addressed by absolute sample index, which "
                "threefry keys and the wgsl parity chain don't carry)"
            )
        if self.mis and not self.nee:
            raise ValueError("mis=True is a weighting of NEE; it requires nee=True")
        if self.clamp < 0.0:
            raise ValueError(f"clamp must be >= 0, got {self.clamp}")
        if self.clamp > 0.0 and self.integrator != "path":
            raise ValueError(
                f"clamp is a path-integrator knob; integrator="
                f"{self.integrator!r} ignores it"
            )
        if self.clamp > 0.0 and self.regenerate != "off":
            raise ValueError(
                "clamp > 0 is unsupported with ray regeneration (the pool "
                "accumulates per-bounce deltas; no per-sample total exists)"
            )
        if self.adaptive_tol < 0.0:
            raise ValueError(f"adaptive_tol must be >= 0, got {self.adaptive_tol}")
        if self.adaptive_tol > 0.0 and self.backend != "pallas":
            # Only the megakernel runs the spp loop in-kernel per tile;
            # silently ignoring the request would render the wrong budget.
            raise ValueError(
                f"adaptive_tol={self.adaptive_tol} is a megakernel mode; "
                f"backend={self.backend!r} ignores it — set backend='pallas' "
                "or adaptive_tol=0"
            )
        if self.adaptive_tol > 0.0 and self.adaptive_min_spp < 2:
            # Welford variance of < 2 samples is undefined.  (Inert when
            # adaptive sampling is off — don't reject a no-effect field.)
            raise ValueError(
                f"adaptive_min_spp must be >= 2, got {self.adaptive_min_spp}"
            )
        if self.regenerate != "off" and self.backend != "wavefront":
            # Silently ignoring the request would benchmark the wrong engine.
            raise ValueError(
                f"regenerate={self.regenerate!r} is a wavefront-engine mode; "
                f"backend={self.backend!r} ignores it — set "
                "backend='wavefront' or regenerate='off'"
            )

    @property
    def sampler_spec(self) -> tuple | None:
        """Static spec threaded to ops/rng.sampler_uniforms: None for the
        independent sampler, ('stratified', kx, ky) or ('sobol', nbits).

        Derived from the spp BUDGET (config.spp), not any per-call batch
        size, so progressive steps and spp-axis shards of the same target
        draw the identical stream.
        """
        if self.sampler == "stratified":
            from gpu_ray_tracing.ops.rng import strata_shape

            return ("stratified", *strata_shape(self.spp))
        if self.sampler == "sobol":
            from gpu_ray_tracing.ops.rng import sobol_nbits

            return ("sobol", sobol_nbits(self.spp))
        return None

    @property
    def resolution(self) -> tuple[int, int]:
        return (self.width, self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


#: Reference defaults: 1280x720 window (lib.rs:24-25), 500-spp target
#: (camera.rs:33), 30-bounce depth (camera.rs:34).
REFERENCE_CONFIG = RenderConfig(
    width=1280, height=720, spp=500, max_depth=30, integrator="path"
)
