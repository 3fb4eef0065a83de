"""Public rendering API: pure, jittable, vmappable, differentiable.

This module replaces the reference's entire L2/L3 machinery — bind-group
layouts, extract/prepare systems, the render-graph node and its Loading/Init/
Update state machine (lib.rs:113-422) — with three pure functions:

  render(spheres, camera, config, key=...)            one converged frame
  progressive_step(state, spheres, camera, config)    one 1-spp accumulation
  render_animation(spheres, settings_track, config)   a camera fly-through

XLA owns buffers and scheduling; there is nothing to extract, prepare, or
ping-pong.  The reference's per-frame re-upload of static sphere data
(lib.rs:177-207, a perf anti-pattern SURVEY flags) has no equivalent here:
the scene pytree is device-resident across calls by construction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from gpu_ray_tracing import platform
from gpu_ray_tracing.models.camera import Camera, CameraSettings, derive_camera
from gpu_ray_tracing.models.scene import Scene, as_scene
from gpu_ray_tracing.models.spheres import Spheres
from gpu_ray_tracing.ops import integrators, rays
from gpu_ray_tracing.ops.accumulate import (
    AccumState,
    fold_sample,
    init_accum,
)
from gpu_ray_tracing.utils.config import RenderConfig

Array = jax.Array

def _scene_width(scene) -> int:
    """Primitive count driving the (pixels x primitives) block budget."""
    sc = as_scene(scene)
    n = sc.spheres.count
    if sc.mesh is not None and sc.bvh is None:
        n += sc.mesh.num_triangles  # brute-force triangle path materializes (P, F)
    return n


def _trace_block_size(num_pixels: int, num_spheres: int) -> int:
    per = max(1, platform.block_budget() // max(num_spheres, 1))
    if per >= num_pixels:
        return num_pixels
    best = 1
    d = 1
    while d * d <= num_pixels:
        if num_pixels % d == 0:
            if d <= per:
                best = max(best, d)
            if num_pixels // d <= per:
                best = max(best, num_pixels // d)
        d += 1
    return best


def _trace_chunked(
    origins: Array,
    dirs: Array,
    spheres: Spheres,
    config: RenderConfig,
    pixel_seeds: Array | None = None,
    pixel_ids: Array | None = None,
    sample_index: Array | None = None,
    frame_seed: Array | None = None,
    **rng_kw,
) -> Array:
    """Run the integrator over the framebuffer in memory-bounded pixel blocks.

    `pixel_ids`/`sample_index`/`frame_seed` feed the stratified/sobol
    sampler's first-bounce remaps (config.sampler != 'independent'; hash
    stream only) — `pixel_ids` chunks alongside the seeds, the other two
    are scalars.
    """
    h, w = origins.shape[0], origins.shape[1]
    p = h * w
    block = _trace_block_size(p, _scene_width(spheres))
    spec = config.sampler_spec if pixel_seeds is not None else None

    def trace(o, d, seeds, ids=None, **extra):
        if config.integrator != "path":
            aov = {
                "normal": integrators.shade_normals,
                "albedo": integrators.shade_albedo,
                "depth": integrators.shade_depth,
            }[config.integrator]
            return aov(o, d, spheres, config.t_min, config.t_max)
        img = integrators.trace_path(
            o, d, spheres, config.max_depth, config.t_min, config.t_max,
            parity=config.parity, pixel_seeds=seeds,
            russian_roulette_depth=config.russian_roulette_depth,
            sky_intensity=config.sky_intensity, nee=config.nee,
            mis=config.mis,
            pixel_ids=ids, sample_index=sample_index,
            frame_seed_u32=frame_seed,
            sampler_spec=spec if ids is not None else None,
            **rng_kw, **extra,
        )
        if config.clamp > 0.0:
            img = integrators.clamp_radiance(img, config.clamp)
        return img

    if block == p:
        return trace(origins, dirs, pixel_seeds, pixel_ids if spec else None)
    o = origins.reshape(p // block, block, 3)
    d = dirs.reshape(p // block, block, 3)
    if pixel_seeds is None:
        key = rng_kw.pop("key", None)
        if key is not None:
            # Threefry draws are shape-keyed, so one key shared by every
            # block would give all blocks bit-identical scatter/RR/NEE
            # streams — tiled correlated noise whose pattern silently
            # depends on the platform-chosen block size.  Fold the block
            # index in for an independent stream per block.
            keys = jax.vmap(jax.random.fold_in, (None, 0))(
                key, jnp.arange(p // block)
            )
            out = jax.lax.map(
                lambda odk: trace(odk[0], odk[1], None, key=odk[2]),
                (o, d, keys),
            )
        else:
            out = jax.lax.map(lambda od: trace(od[0], od[1], None), (o, d))
    else:
        s = pixel_seeds.reshape(p // block, block)
        if spec is not None:
            ids = pixel_ids.reshape(p // block, block)
            out = jax.lax.map(
                lambda odsi: trace(odsi[0], odsi[1], odsi[2], odsi[3]),
                (o, d, s, ids),
            )
        else:
            out = jax.lax.map(lambda ods: trace(ods[0], ods[1], ods[2]), (o, d, s))
    return out.reshape(h, w, 3)


def _dispatch_kernel_render(
    spheres,
    camera,
    config: RenderConfig,
    *,
    sample_index: Array,
    frame_seed: Array,
    spp: int = 1,
    height: int | None = None,
    y_offset: Array | int = 0,
    total_width: int | None = None,
    interpret: bool | None = None,
    row_stride: Array | int = 1,
    adaptive: bool = False,
) -> Array:
    """Route a hash-stream render to the configured Pallas engine.

    `adaptive=True` engages config.adaptive_tol on the megakernel: one-shot
    full-budget renders, including row-sharded ones (parallel.sharding
    dispatches this per row shard — disjoint pixels compose).  The
    fold-based progressive steps never set it (they need exact per-sample
    counts; adaptive_progressive_step carries the kernel's own state
    instead).

    The single dispatch point for backend='pallas'/'wavefront' — used by the
    per-sample path, the full-frame kernel path, and the sharded renderer —
    so every engine kwarg stays in sync across entry points.  `height`/
    `y_offset`/`total_width` address a row shard of a larger frame; the
    default renders the full config frame.  `interpret` forces/disables
    Pallas interpret mode; the sharded renderer passes the platform module's
    answer for the mesh it is compiling for, everything else defaults to
    the current device's.
    """
    w = config.width
    h = config.height if height is None else height
    if config.backend == "wavefront" and config.integrator == "path":
        from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

        return render_wavefront(
            spheres, camera, width=w, height=h,
            sample_index=sample_index, frame_seed=frame_seed,
            max_depth=config.max_depth, t_min=config.t_min,
            t_max=config.t_max,
            russian_roulette_depth=config.russian_roulette_depth,
            sky_intensity=config.sky_intensity, nee=config.nee,
            mis=config.mis, clamp=config.clamp,
            spp=spp, y_offset=y_offset, total_width=total_width,
            interpret=interpret, row_stride=row_stride,
            regenerate=(
                config.regenerate == "on"
                or (config.regenerate == "auto" and spp > 1)
            ),
            sampler_spec=config.sampler_spec,
        )
    from gpu_ray_tracing.ops.pallas.megakernel import render_pallas

    # render_pallas's `width` is the REAL frame width (global pixel ids);
    # row sharding keeps rows whole, so width == total width always.
    return render_pallas(
        spheres, camera, width=w, height=h,
        sample_index=sample_index, frame_seed=frame_seed,
        max_depth=config.max_depth, t_min=config.t_min,
        t_max=config.t_max,
        mode=config.integrator,
        russian_roulette_depth=config.russian_roulette_depth,
        sky_intensity=config.sky_intensity, nee=config.nee,
        mis=config.mis, clamp=config.clamp,
        spp=spp, y_offset=y_offset, interpret=interpret,
        row_stride=row_stride, sampler_spec=config.sampler_spec,
        adaptive_tol=config.adaptive_tol if adaptive else 0.0,
        adaptive_min_spp=config.adaptive_min_spp,
    )


def _render_one_sample(
    spheres: Spheres,
    camera: Camera,
    config: RenderConfig,
    *,
    key: Array | None,
    sample_index: Array | None,
    frame_seed: Array | None,
) -> Array:
    """One 1-spp pass over the framebuffer: ray gen + integrate."""
    w, h = config.width, config.height
    if config.rng == "threefry":
        k_ray, k_trace = jax.random.split(key)
        origins, dirs = rays.generate_rays_threefry(camera, w, h, k_ray)
        return _trace_chunked(origins, dirs, spheres, config, key=k_trace)

    if config.rng == "hash":
        if config.backend in ("pallas", "wavefront"):
            return _dispatch_kernel_render(
                spheres, camera, config,
                sample_index=sample_index, frame_seed=frame_seed,
            )
        origins, dirs, seeds = rays.generate_rays_hash(
            camera, w, h, sample_index, frame_seed,
            sampler_spec=config.sampler_spec,
        )
        return _trace_chunked(
            origins, dirs, spheres, config, pixel_seeds=seeds,
            pixel_ids=rays.hash_pixel_ids(w, h),
            sample_index=sample_index, frame_seed=frame_seed,
        )

    # WGSL stream: update()'s scalar seed = 1 + samples_until_now + frame_seed
    # (wgsl:353); get_ray uses it per pixel, ray_color gets seed+1 (wgsl:355).
    sample_seed = (
        jnp.uint32(1) + jnp.asarray(sample_index, jnp.uint32) + jnp.asarray(frame_seed, jnp.uint32)
    )
    origins, dirs = rays.generate_rays_wgsl(
        camera, w, h, sample_seed, jnp.asarray(frame_seed, jnp.uint32), config.parity
    )
    bounce_seeds = integrators.make_bounce_seeds(sample_seed + jnp.uint32(1), config.max_depth)
    return _trace_chunked(origins, dirs, spheres, config, bounce_seeds=bounce_seeds)


def _resolve_rng(config: RenderConfig, key, frame_seed):
    """Normalize (key, frame_seed) for the configured RNG mode.

    'threefry' needs a key.  'hash'/'wgsl' need a uint32 frame seed — given
    directly, derived from a key if one was passed instead, else 0.
    """
    if config.rng == "threefry":
        if key is None:
            raise ValueError("config.rng='threefry' requires key=")
        return key, None
    if frame_seed is None:
        if key is not None:
            frame_seed = jax.random.key_data(key).ravel()[-1].astype(jnp.uint32)
        else:
            frame_seed = jnp.uint32(0)
    return None, jnp.asarray(frame_seed, jnp.uint32)


@partial(jax.jit, static_argnames=("config",))
def render(
    spheres: Spheres,
    camera: Camera | CameraSettings,
    config: RenderConfig,
    *,
    key: Array | None = None,
    frame_seed: Array | None = None,
) -> Array:
    """Render one frame at config.spp samples per pixel.

    Returns linear-RGB f32 of shape (height, width, 3).

    RNG selection follows config.rng:
      - 'threefry': pass `key` (a jax.random key); per-pixel independent
        streams.
      - 'wgsl':     pass `frame_seed` (uint32 scalar, defaults to 0) — the
        explicit version of the reference's per-frame rand::random() seed
        (camera.rs:346); sample s uses the exact update() seed chain.

    Unlike the reference — which reaches spp only by accumulating 1 spp per
    displayed frame (wgsl:352-358) — this renders all spp in one call; use
    `progressive_step` for the frame-at-a-time behavior.
    """
    if isinstance(camera, CameraSettings):
        camera = derive_camera(camera, config.width, config.height)
    key, frame_seed = _resolve_rng(config, key, frame_seed)

    if config.backend in ("pallas", "wavefront") and config.rng == "hash":
        return _render_kernel_frame(spheres, camera, config, frame_seed)
    return _render_spp_jax(spheres, camera, config, key, frame_seed)


def _render_spp_jax(spheres, camera, config, key, frame_seed):
    """The spp accumulation loop over the jax-backend integrator."""

    def body(s, acc):
        sample = _render_one_sample(
            spheres, camera, config,
            key=jax.random.fold_in(key, s) if key is not None else None,
            sample_index=s,
            frame_seed=frame_seed,
        )
        return acc + sample

    total = jax.lax.fori_loop(
        0, config.spp, body, jnp.zeros((config.height, config.width, 3), jnp.float32)
    )
    return total / jnp.float32(config.spp)


@partial(jax.custom_vjp, nondiff_argnums=(2,))
def _render_kernel_frame(spheres, camera, config: RenderConfig, frame_seed):
    """One full config.spp frame on a Pallas engine — the megakernel (spp
    loop in-kernel: one launch + one HBM image write per frame) or, for
    backend='wavefront' path tracing, the per-bounce compaction engine.
    Both draw the same stream sample-for-sample as the jax path.

    Differentiable: `pallas_call` has no VJP, so the backward pass replays
    the jax-backend integrator — which draws the IDENTICAL hash RNG stream —
    and takes its VJP (forward stays on the fast engine; the one extra
    jax-path forward runs only when gradients are requested).
    """
    return _dispatch_kernel_render(
        spheres, camera, config,
        sample_index=jnp.uint32(0), frame_seed=frame_seed, spp=config.spp,
        adaptive=True,
    )


def _render_kernel_frame_fwd(spheres, camera, config, frame_seed):
    return (
        _render_kernel_frame(spheres, camera, config, frame_seed),
        (spheres, camera, frame_seed),
    )


def _render_kernel_frame_bwd(config, residuals, g):
    import dataclasses

    import numpy as np

    spheres, camera, frame_seed = residuals
    # regenerate is a wavefront-engine mode; the jax-backend replay config
    # must drop it or RenderConfig.__post_init__ rejects the combination
    # (grad through backend='wavefront', regenerate='on' crashed otherwise).
    jax_config = dataclasses.replace(config, backend="jax", regenerate="off")

    def replay(s, c):
        return _render_spp_jax(s, c, jax_config, None, frame_seed)

    _, vjp = jax.vjp(replay, spheres, camera)
    d_spheres, d_camera = vjp(g)
    # uint32 seeds live in a zero tangent space (float0).
    d_seed = np.zeros(jnp.shape(frame_seed), dtype=jax.dtypes.float0)
    return d_spheres, d_camera, d_seed


_render_kernel_frame.defvjp(_render_kernel_frame_fwd, _render_kernel_frame_bwd)


@partial(jax.jit, static_argnames=("config", "spp_per_step"))
def progressive_step(
    state: AccumState,
    spheres: Spheres,
    camera: Camera | CameraSettings,
    config: RenderConfig,
    *,
    key: Array | None = None,
    frame_seed: Array | None = None,
    reset: Array | bool = False,
    spp_per_step: int = 1,
) -> AccumState:
    """One progressive frame: trace spp_per_step samples and fold the batch
    into the running mean.

    This is the reference's `update` dispatch (wgsl:333-364) as a pure
    (state, inputs) -> state step: `reset` is the explicit camera_has_moved
    flag; the state freezes once config.spp samples have accumulated.

    spp_per_step=1 is the reference's interactive frame-at-a-time contract
    (bit-stable against it).  spp_per_step>1 batches samples per fold — the
    offline-accumulation shape, and what lets the wavefront regeneration
    engine (config.regenerate) overlap one sample's deep-bounce tail with
    the next sample's primaries.  The sample STREAM is identical either
    way: batch b covers absolute sample indices count..count+k-1, exactly
    the samples k single steps would draw.
    """
    if spp_per_step < 1:
        raise ValueError(f"spp_per_step must be >= 1, got {spp_per_step}")
    if config.adaptive_tol > 0.0:
        # The fold weights each batch by its exact sample count; adaptive
        # tiles take data-dependent counts the fold cannot see.  The
        # composable form is adaptive_progressive_step, which carries the
        # kernel's Welford state instead of folding means.
        raise ValueError(
            "adaptive_tol > 0 does not compose with fold-based "
            "progressive_step; use adaptive_progressive_step (exact "
            "in-kernel resume) or a one-shot render()"
        )
    if spp_per_step > 1 and config.spp % spp_per_step != 0:
        # Eager misconfiguration guard; a straddling batch that the static
        # check cannot see (a resumed checkpoint whose count is not a
        # multiple of spp_per_step) is handled by fold_sample, which folds
        # only the taken fraction so the count still freezes at the target.
        raise ValueError(
            f"spp_per_step={spp_per_step} must divide config.spp="
            f"{config.spp} so accumulation freezes exactly at the target"
        )
    if isinstance(camera, CameraSettings):
        camera = derive_camera(camera, config.width, config.height)
    key, frame_seed = _resolve_rng(config, key, frame_seed)

    count = jnp.where(jnp.asarray(reset, bool), 0, state.count)
    if spp_per_step == 1:
        sample = _render_one_sample(
            spheres,
            camera,
            config,
            # fold_in(key, 0) keeps progressive_step(key=k) sample-identical
            # to render(spp=1, key=k); pass a distinct key per frame.
            key=jax.random.fold_in(key, 0) if key is not None else None,
            sample_index=count,
            frame_seed=frame_seed,
        )
    elif config.backend in ("pallas", "wavefront") and config.rng == "hash":
        sample = _dispatch_kernel_render(
            spheres, camera, config,
            sample_index=count.astype(jnp.uint32), frame_seed=frame_seed,
            spp=spp_per_step,
        )
    else:
        if config.rng == "threefry":
            raise ValueError(
                "spp_per_step > 1 requires a counter-based rng "
                "('hash'/'wgsl'): threefry cannot address absolute sample "
                "indices from a running count"
            )

        def body(s, acc):
            return acc + _render_one_sample(
                spheres, camera, config, key=None,
                sample_index=(count + s).astype(jnp.uint32),
                frame_seed=frame_seed,
            )

        total = jax.lax.fori_loop(
            0, spp_per_step, body,
            jnp.zeros((config.height, config.width, 3), jnp.float32),
        )
        sample = total / jnp.float32(spp_per_step)
    return fold_sample(state, sample, config.spp, reset, num_samples=spp_per_step)


def render_progressive(
    spheres: Spheres,
    camera: Camera | CameraSettings,
    config: RenderConfig,
    *,
    key: Array | None = None,
    frame_seed: Array | None = None,
    num_frames: int | None = None,
) -> AccumState:
    """Run progressive accumulation for num_frames (default: to convergence).

    Equivalent to the reference's steady-state frame loop with a static
    camera.  Sample decorrelation comes from the accumulated count acting as
    the sample index inside progressive_step (hash/wgsl modes) or from
    fold_in(key, frame) (threefry) — the explicit version of the reference's
    fresh rand::random() per frame (camera.rs:346).
    """
    frames = config.spp if num_frames is None else num_frames
    state = init_accum(config.height, config.width)
    key, frame_seed = _resolve_rng(config, key, frame_seed)

    def body(f, st):
        return progressive_step(
            st, spheres, camera, config,
            key=jax.random.fold_in(key, f) if key is not None else None,
            frame_seed=frame_seed,
            reset=False,
        )

    return jax.lax.fori_loop(0, frames, body, state)


@partial(jax.jit, static_argnames=("config",))
def render_animation(
    spheres: Spheres,
    settings_track: CameraSettings,
    config: RenderConfig,
    *,
    key: Array | None = None,
    frame_seeds: Array | None = None,
) -> Array:
    """Render a camera fly-through: settings_track is a CameraSettings pytree
    with a leading frame axis (build one with `stack_camera_track`).

    Returns (frames, height, width, 3).  The reference has no offline
    animation path — its camera motion is interactive keyboard state
    (camera.rs:125-253); here camera paths are data and the frame loop is a
    sequential lax.map (memory-bounded), each frame a full config.spp render.
    """
    num_frames = jax.tree_util.tree_leaves(settings_track)[0].shape[0]
    if frame_seeds is not None and frame_seeds.shape[0] != num_frames:
        # A short array would be CLAMP-gathered inside the loop: the last
        # seed would silently repeat (frozen noise) for the tail frames.
        raise ValueError(
            f"frame_seeds has {frame_seeds.shape[0]} entries for "
            f"{num_frames} track frames"
        )

    def one(f):
        settings = jax.tree.map(lambda x: x[f], settings_track)
        cam = derive_camera(settings, config.width, config.height)
        return render(
            spheres, cam, config,
            key=jax.random.fold_in(key, f) if key is not None else None,
            frame_seed=frame_seeds[f] if frame_seeds is not None else None,
        )

    return jax.lax.map(one, jnp.arange(num_frames))


def stack_camera_track(settings_list: list[CameraSettings]) -> CameraSettings:
    """Stack per-frame CameraSettings into a single track pytree."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *settings_list)


@partial(jax.jit, static_argnames=("config", "spp_per_step"))
def adaptive_progressive_step(
    state,
    spheres: Spheres,
    camera: Camera | CameraSettings,
    config: RenderConfig,
    *,
    frame_seed: Array | None = None,
    spp_per_step: int = 8,
):
    """One adaptive progressive step: resume the megakernel's in-kernel
    adaptive convergence loop from `state` (an AdaptiveAccumState,
    ops/accumulate.init_adaptive_accum to start) and take at most
    `spp_per_step` more samples per tile, stopping tiles that converge.

    Composes adaptive sampling with progressive accumulation: the carried Welford statistics make the kernel's stopping test
    identical to the one-shot adaptive render's at every absolute sample
    index, so running ceil(spp / spp_per_step) steps produces a state whose
    `.image` is BITWISE equal to `render()` with the same adaptive config —
    converged tiles take zero samples in later steps (their launch exits
    immediately).  Requires backend='pallas', rng='hash',
    integrator='path', adaptive_tol > 0.
    """
    from gpu_ray_tracing.ops.accumulate import AdaptiveAccumState
    from gpu_ray_tracing.ops.pallas.megakernel import render_pallas

    if config.adaptive_tol <= 0.0:
        raise ValueError(
            "adaptive_progressive_step requires adaptive_tol > 0 (use "
            "progressive_step for fixed-spp accumulation)"
        )
    if config.backend != "pallas" or config.rng != "hash":
        raise ValueError(
            "adaptive_progressive_step is a megakernel mode: backend="
            f"'pallas', rng='hash' (got {config.backend!r}/{config.rng!r})"
        )
    if config.integrator != "path":
        raise ValueError("adaptive sampling applies to the path integrator")
    if spp_per_step < 1:
        raise ValueError(f"spp_per_step must be >= 1, got {spp_per_step}")
    if isinstance(camera, CameraSettings):
        camera = derive_camera(camera, config.width, config.height)
    _, frame_seed = _resolve_rng(config, None, frame_seed)

    outs = render_pallas(
        spheres, camera, width=config.width, height=config.height,
        sample_index=jnp.uint32(0), frame_seed=frame_seed,
        max_depth=config.max_depth, t_min=config.t_min, t_max=config.t_max,
        russian_roulette_depth=config.russian_roulette_depth,
        sky_intensity=config.sky_intensity, nee=config.nee, mis=config.mis,
        clamp=config.clamp, spp=config.spp,
        sampler_spec=config.sampler_spec,
        adaptive_tol=config.adaptive_tol,
        adaptive_min_spp=config.adaptive_min_spp,
        adaptive_chunk=spp_per_step,
        adaptive_state=(
            state.rgb_sum[..., 0], state.rgb_sum[..., 1],
            state.rgb_sum[..., 2], state.count, state.mlum, state.m2,
        ),
    )
    return AdaptiveAccumState(
        rgb_sum=jnp.stack(outs[:3], axis=-1),
        count=outs[3], mlum=outs[4], m2=outs[5],
    )


@partial(jax.jit, static_argnames=("c",))
def _count_ray_map(spheres, camera, c, frame_seed):
    # Module-level so repeated count_traced_rays calls (one per benchmark
    # frame) hit the jit trace cache instead of retracing the megakernel.
    from gpu_ray_tracing.ops.pallas.megakernel import render_pallas

    out = render_pallas(
        spheres, camera, width=c.width, height=c.height,
        sample_index=jnp.uint32(0), frame_seed=frame_seed,
        max_depth=c.max_depth, t_min=c.t_min, t_max=c.t_max,
        mode=c.integrator,
        russian_roulette_depth=c.russian_roulette_depth,
        sky_intensity=c.sky_intensity, nee=c.nee, mis=c.mis,
        clamp=c.clamp, spp=c.spp, sampler_spec=c.sampler_spec,
        adaptive_tol=c.adaptive_tol, adaptive_min_spp=c.adaptive_min_spp,
        return_ray_count=True,
    )
    return out[-1]


def count_traced_rays(
    spheres: Spheres,
    camera: Camera | CameraSettings,
    config: RenderConfig,
    *,
    frame_seed: Array | None = None,
    return_map: bool = False,
):
    """Count the rays a render of `config` actually traces (measured, not
    inferred): closest-hit walks per live bounce plus NEE shadow rays whose
    occlusion walk is driven, summed over all spp.

    Runs the megakernel's in-kernel counters (render_pallas
    return_ray_count).  The count is ENGINE-INVARIANT: every engine draws
    the identical counter-based stream, so live masks — and therefore the
    traced-ray set — are the same for the jax, pallas, and wavefront
    backends (tests/test_pallas.py::test_ray_counters_match_jax verifies
    the megakernel count against the independent trace_path counters
    bitwise).  Requires rng='hash'; AOV integrators trace exactly spp
    primary rays per pixel.

    Returns a dict with `rays_traced` (float total), `primary_rays`
    (width*height*spp, the r3 metric being superseded), and with
    `return_map=True` also `map`, the (H, W) per-pixel count plane: the
    measured basis for honest bounce-ray Mrays/s.
    """
    import dataclasses

    if config.rng != "hash":
        raise ValueError(
            "count_traced_rays requires rng='hash' (the counter stream is "
            "what makes the count engine-invariant)"
        )
    if isinstance(camera, CameraSettings):
        camera = derive_camera(camera, config.width, config.height)
    _, frame_seed = _resolve_rng(config, None, frame_seed)
    # Route through the megakernel regardless of config.backend (counts are
    # engine-invariant; the wavefront scheduler traces the same ray set).
    cfg = dataclasses.replace(config, backend="pallas", regenerate="off")

    import numpy as np

    ray_map = _count_ray_map(spheres, camera, cfg, frame_seed)
    # Host-side f64 sum: per-pixel counts are small exact f32 integers, but
    # a frame total can exceed f32's 2^24 exact-integer range.
    result = {
        "rays_traced": float(np.sum(np.asarray(ray_map), dtype=np.float64)),
        "primary_rays": config.width * config.height * config.spp,
        "width": config.width,
        "height": config.height,
        "spp": config.spp,
    }
    if return_map:
        result["map"] = ray_map
    return result


@partial(
    jax.jit,
    static_argnames=(
        "config", "iterations", "sigma_color", "sigma_normal", "sigma_depth",
        "return_aovs",
    ),
)
def render_denoised(
    spheres: Spheres,
    camera: Camera | CameraSettings,
    config: RenderConfig,
    *,
    key: Array | None = None,
    frame_seed: Array | None = None,
    iterations: int = 4,
    sigma_color: float = 0.45,
    sigma_normal: float = 64.0,
    sigma_depth: float = 2.0,
    return_aovs: bool = False,
):
    """Render one frame and denoise it with the AOV-guided a-trous filter.

    Renders the beauty pass with `config` as-is, then three cheap first-hit
    guide passes (albedo / normal / depth AOVs — anti-aliased with the same
    sampler and spp so guide edges match beauty edges), and runs
    `ops.denoise.atrous_denoise` with albedo demodulation.  The reference
    has no denoiser; this is the offline complement to its progressive
    convergence loop (compute_shader.wgsl:352-358) — a handful of denoised
    spp replaces hundreds of accumulated ones for preview-quality output.

    Returns the denoised (H, W, 3) image, or (denoised, beauty, aovs-dict)
    when return_aovs=True.  Fully jitted; differentiable end to end (the
    filter is plain arithmetic and the beauty pass has a VJP).
    """
    import dataclasses

    from gpu_ray_tracing.ops import denoise as denoise_ops

    if config.integrator != "path":
        raise ValueError(
            "render_denoised denoises the path integrator's beauty pass; "
            f"got integrator={config.integrator!r}"
        )
    beauty = render(spheres, camera, config, key=key, frame_seed=frame_seed)

    def guide_cfg(integrator: str) -> RenderConfig:
        # Drop every path-only knob the AOV integrators reject or ignore.
        return dataclasses.replace(
            config, integrator=integrator, nee=False, mis=False,
            clamp=0.0, adaptive_tol=0.0, regenerate="off",
        )

    aov_kw = dict(key=key, frame_seed=frame_seed)
    albedo = render(spheres, camera, guide_cfg("albedo"), **aov_kw)
    normal_aov = render(spheres, camera, guide_cfg("normal"), **aov_kw)
    depth = render(spheres, camera, guide_cfg("depth"), **aov_kw)

    out = denoise_ops.atrous_denoise(
        beauty,
        albedo=albedo,
        normal=denoise_ops.decode_normal_aov(normal_aov),
        depth=depth[..., 0],
        iterations=iterations,
        sigma_color=sigma_color,
        sigma_normal=sigma_normal,
        sigma_depth=sigma_depth,
    )
    if return_aovs:
        return out, beauty, {"albedo": albedo, "normal": normal_aov, "depth": depth}
    return out
