"""Multi-card rendering: framebuffer and sample sharding over a device mesh.

The reference is strictly single-GPU (SURVEY §2c); this module supplies the
multi-card scaling path it lacks:

  - rows of the framebuffer shard across mesh axis 'x' (pure data parallelism
    — rays are independent, so there are no halos and no row-axis collectives)
  - samples-per-pixel shard across mesh axis 's'; the per-card partial sums
    combine with one `psum` (the framework's only collective), which XLA
    hands to NCCL over NVLink

Because the default RNG is counter-based on GLOBAL pixel ids
(ops/rng.py "hash" mode), every device derives exactly the rays and scatter
draws the full-frame render would for its rows/samples — the Monte Carlo
estimator is the same function of the same random stream.  The 'wgsl' parity
stream is position-based too and shards equally well; 'threefry' is
shape-dependent and is rejected here.

Equality caveat (SURVEY §7 hard part 3): XLA makes fusion/FMA rounding
choices per compiled shape, so the sharded and unsharded programs can differ
by ~1 ulp in the intersection quadratic; a path tracer amplifies a flipped
hit decision into an O(1) change for that sample.  In practice a small
fraction of a percent of pixels differ visibly at one sample; the images are
statistically identical and converge together.  Tests assert that contract
(tests/test_sharding.py::assert_images_match) rather than bitwise equality.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gpu_ray_tracing import platform
from gpu_ray_tracing.api import _dispatch_kernel_render, _trace_chunked
from gpu_ray_tracing.models.camera import Camera, CameraSettings, derive_camera
from gpu_ray_tracing.models.spheres import Spheres
from gpu_ray_tracing.ops import integrators, rays
from gpu_ray_tracing.ops.accumulate import AccumState, fold_sample
from gpu_ray_tracing.parallel.mesh import ROW_AXIS, SPP_AXIS
from gpu_ray_tracing.utils.config import RenderConfig

Array = jax.Array


def _check(config: RenderConfig, mesh: Mesh, row_partition: str = "contiguous",
           allow_adaptive: bool = False):
    if row_partition not in ("contiguous", "interleaved"):
        raise ValueError(
            f"row_partition={row_partition!r}; expected 'contiguous' or "
            "'interleaved'"
        )
    if row_partition == "interleaved" and config.rng != "hash":
        # The wgsl parity stream's seed derivation has no strided-row form;
        # interleaving exists for load balance, which parity runs don't need.
        raise ValueError("row_partition='interleaved' requires config.rng='hash'")
    if config.rng == "threefry":
        raise ValueError(
            "sharded rendering requires a position-equivariant RNG; use "
            "config.rng='hash' (default) or 'wgsl', not 'threefry'"
        )
    if config.adaptive_tol > 0.0:
        # Row shards own disjoint pixels, so adaptive per-tile sample counts
        # compose with row sharding (render_sharded dispatches the
        # megakernel's one-shot in-kernel convergence loop per shard).  The
        # spp-axis psum, by contrast, weights every shard's batch by an
        # assumed equal sample count, and the fold-based progressive step
        # needs exact per-sample counts — both stay rejected.
        if not allow_adaptive:
            raise ValueError(
                "adaptive_tol > 0 does not compose with the fold-based "
                "sharded progressive step; use render_sharded (row-sharded "
                "one-shot adaptive) or the unsharded "
                "adaptive_progressive_step"
            )
        if mesh.shape.get(SPP_AXIS, 1) != 1:
            raise ValueError(
                "adaptive_tol > 0 shards over ROWS only (disjoint pixels); "
                "the spp-axis psum assumes equal per-shard sample counts — "
                f"got spp axis of size {mesh.shape.get(SPP_AXIS)}"
            )
        if config.rng != "hash":
            raise ValueError(
                "sharded adaptive rendering is an in-kernel megakernel mode "
                "and requires config.rng='hash'"
            )
    missing = [a for a in (ROW_AXIS, SPP_AXIS) if a not in mesh.shape]
    if missing:
        # The shard_map bodies take axis_index/psum over BOTH axes; a mesh
        # without one would fail deep in tracing with an unbound-axis error.
        raise ValueError(
            f"mesh is missing axis(es) {missing}: sharded rendering needs a "
            f"('{ROW_AXIS}', '{SPP_AXIS}') mesh (size-1 axes are fine — use "
            f"parallel.mesh.make_mesh); got axes {tuple(mesh.shape)}"
        )
    n_rows = mesh.shape[ROW_AXIS]
    n_spp = mesh.shape[SPP_AXIS]
    if config.height % n_rows != 0:
        raise ValueError(f"height {config.height} not divisible by mesh rows {n_rows}")
    if config.spp % n_spp != 0:
        raise ValueError(f"spp {config.spp} not divisible by mesh spp axis {n_spp}")
    return n_rows, n_spp


def _local_sample(spheres, camera, config: RenderConfig, sample_index, frame_seed, y0, local_h,
                  interpret: bool, row_stride=1):
    """Trace one 1-spp pass for this shard's rows of the global frame:
    local row r = global row y0 + r * row_stride (stride 1 = contiguous
    band, stride n_rows = the interleaved partition)."""
    w = config.width
    if config.rng == "hash":
        if config.backend in ("pallas", "wavefront"):
            return _dispatch_kernel_render(
                spheres, camera, config,  # spheres may be a Scene
                sample_index=sample_index, frame_seed=frame_seed,
                height=local_h, y_offset=y0, total_width=w,
                interpret=interpret, row_stride=row_stride,
            )
        origins, dirs, seeds = rays.generate_rays_hash(
            camera, w, local_h, sample_index, frame_seed,
            y_offset=y0, total_width=w, row_stride=row_stride,
            sampler_spec=config.sampler_spec,
        )
        return _trace_chunked(
            origins, dirs, spheres, config, pixel_seeds=seeds,
            pixel_ids=rays.hash_pixel_ids(
                w, local_h, y_offset=y0, total_width=w, row_stride=row_stride
            ),
            sample_index=sample_index, frame_seed=frame_seed,
        )
    # wgsl stream (see api._render_one_sample for the seed chain mapping)
    sample_seed = (
        jnp.uint32(1) + jnp.asarray(sample_index, jnp.uint32) + jnp.asarray(frame_seed, jnp.uint32)
    )
    origins, dirs = rays.generate_rays_wgsl(
        camera, w, local_h, sample_seed, jnp.asarray(frame_seed, jnp.uint32),
        config.parity, y_offset=y0,
    )
    bounce_seeds = integrators.make_bounce_seeds(sample_seed + jnp.uint32(1), config.max_depth)
    return _trace_chunked(origins, dirs, spheres, config, bounce_seeds=bounce_seeds)


def _partition_params(row_partition: str, xi, local_h, n_rows):
    """Shard xi's (y_offset, row_stride) for its chosen row partition."""
    if row_partition == "interleaved":
        return xi, n_rows
    return xi * local_h, 1


def deinterleave_rows(img: Array, n_rows: int) -> Array:
    """Undo the interleaved partition's shard-major row order.

    With `row_partition='interleaved'`, shard xi computes global rows
    {xi, xi + n, xi + 2n, ...}; the P('x') output therefore holds image
    row (r*n + xi) at array row (xi*local_h + r).  This transpose restores
    image order.  On one device it is a cheap row shuffle; across a real
    mesh XLA lowers it to the one unavoidable all-to-all — which is why
    render_sharded applies it ONCE per frame at the end, and sharded
    progressive state stays in partition order until `accum_image`.
    """
    h = img.shape[0]
    local_h = h // n_rows
    return (
        img.reshape(n_rows, local_h, *img.shape[1:])
        .swapaxes(0, 1)
        .reshape(img.shape)
    )


def accum_image(state: AccumState, mesh: Mesh, row_partition: str = "contiguous") -> Array:
    """The accumulated image in IMAGE row order (identity for contiguous)."""
    if row_partition == "interleaved":
        return deinterleave_rows(state.rgb, mesh.shape[ROW_AXIS])
    return state.rgb


@partial(jax.jit, static_argnames=("config", "mesh", "row_partition"))
def render_sharded(
    spheres: Spheres,
    camera: Camera | CameraSettings,
    config: RenderConfig,
    mesh: Mesh,
    *,
    frame_seed: Array | None = None,
    row_partition: str = "contiguous",
) -> Array:
    """Render one frame with rows sharded over mesh axis 'x' and spp over 's'.

    Returns the (height, width, 3) image in image row order, sharded across
    the mesh.  Draw-for-draw the same sample stream as the unsharded
    `render` (global pixel-id RNG); the images are statistically identical
    but NOT bitwise equal in general — per-shape XLA rounding and the
    spp-axis psum's addition order differ (see the module-header equality
    caveat and tests/test_sharding.py::assert_images_match).

    row_partition:
      - 'contiguous' (default): shard xi renders band [xi*H/n, (xi+1)*H/n).
      - 'interleaved': shard xi renders rows {xi, xi+n, ...} — the
        load-balanced partition.  Contiguous bands of a real scene differ
        up to ~6x in path-trace cost (sky rows vs scene rows; measured
        2.8-16.4 ms across the 8 bands of the 1080p One-Weekend frame),
        capping contiguous 8-way row scaling at ~71% parallel efficiency;
        interleaving gives every shard a cost-representative row sample.
        The per-frame price is one row de-interleave of the final image.
        The RNG is keyed on global pixel ids, so the estimator is
        unchanged under either partition.

    Adaptive sampling (config.adaptive_tol > 0) composes with ROW sharding:
    each shard runs the megakernel's in-kernel convergence loop on its own
    rows (spp axis must be size 1 — per-tile sample counts are
    data-dependent, so the equal-weight spp psum cannot apply).  When shard
    bands align with the unsharded frame's 32-row tiles, the result matches
    the unsharded adaptive render; interleaved partitions evaluate tile
    statistics over strided rows and may allocate samples differently
    (every pixel still gets >= adaptive_min_spp of the same stream).
    """
    if isinstance(camera, CameraSettings):
        camera = derive_camera(camera, config.width, config.height)
    adaptive = config.adaptive_tol > 0.0
    n_rows, n_spp = _check(config, mesh, row_partition, allow_adaptive=True)
    local_h = config.height // n_rows
    spp_local = config.spp // n_spp
    interpret = platform.interpret(mesh.devices.flat)
    if frame_seed is None:
        frame_seed = jnp.uint32(0)
    frame_seed = jnp.asarray(frame_seed, jnp.uint32)

    def body(spheres, camera, frame_seed):
        xi = jax.lax.axis_index(ROW_AXIS)
        si = jax.lax.axis_index(SPP_AXIS)
        y0, stride = _partition_params(row_partition, xi, local_h, n_rows)

        if adaptive:
            # Row shards own disjoint pixels, so each shard runs the
            # megakernel's one-shot in-kernel adaptive convergence loop on
            # its own rows (spp axis is size 1 — _check).  Tile statistics
            # are windows over the shard's LOCAL tiling: when the shard
            # band aligns with the unsharded frame's 32-row tiles the
            # per-tile exits (and the image) match the unsharded adaptive
            # render; an interleaved partition's tiles hold strided rows,
            # so its exits may allocate samples differently — every pixel
            # still gets >= adaptive_min_spp of the same unbiased stream.
            return _dispatch_kernel_render(
                spheres, camera, config,
                sample_index=jnp.uint32(0), frame_seed=frame_seed,
                spp=config.spp, height=local_h, y_offset=y0,
                total_width=config.width, interpret=interpret,
                row_stride=stride, adaptive=True,
            )

        def sample_body(j, acc):
            s_global = si * spp_local + j
            return acc + _local_sample(
                spheres, camera, config, s_global, frame_seed, y0, local_h,
                interpret, stride,
            )

        acc = jax.lax.fori_loop(
            0, spp_local, sample_body, jnp.zeros((local_h, config.width, 3), jnp.float32)
        )
        # The framework's single collective: mean over the spp axis.
        total = jax.lax.psum(acc, SPP_AXIS)
        return total / jnp.float32(config.spp)

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(ROW_AXIS, None, None),
        check_vma=False,
    )
    img = sharded(spheres, camera, frame_seed)
    if row_partition == "interleaved":
        img = deinterleave_rows(img, n_rows)
    return img


@partial(jax.jit, static_argnames=("config", "mesh", "row_partition"))
def progressive_step_sharded(
    state: AccumState,
    spheres: Spheres,
    camera: Camera | CameraSettings,
    config: RenderConfig,
    mesh: Mesh,
    *,
    frame_seed: Array | None = None,
    reset: Array | bool = False,
    row_partition: str = "contiguous",
) -> AccumState:
    """Sharded progressive accumulation step (one spp-axis batch per call).

    The accumulation state rgb stays row-sharded across the mesh for its whole
    lifetime; with an 's' axis of size k, each step folds k samples (weighted
    incremental mean), so convergence needs spp/k steps.

    With row_partition='interleaved' the state's rows live in PARTITION
    order (shard-major) for the whole accumulation — folding is elementwise
    so no step ever pays a reorder; call `accum_image(state, mesh,
    'interleaved')` once at the end to materialize image row order.
    """
    if isinstance(camera, CameraSettings):
        camera = derive_camera(camera, config.width, config.height)
    n_rows, n_spp = _check(config, mesh, row_partition)
    local_h = config.height // n_rows
    interpret = platform.interpret(mesh.devices.flat)
    if frame_seed is None:
        frame_seed = jnp.uint32(0)
    frame_seed = jnp.asarray(frame_seed, jnp.uint32)
    reset = jnp.asarray(reset, bool)

    def body(rgb_local, count, spheres, camera, frame_seed, reset):
        xi = jax.lax.axis_index(ROW_AXIS)
        si = jax.lax.axis_index(SPP_AXIS)
        y0, stride = _partition_params(row_partition, xi, local_h, n_rows)

        # Reset BEFORE deriving sample indices (s_global must restart at 0).
        rgb_local = jnp.where(reset, 0.0, rgb_local)
        count = jnp.where(reset, 0, count)

        s_global = count + si
        sample = _local_sample(spheres, camera, config, s_global, frame_seed, y0, local_h,
                               interpret, stride)
        batch = jax.lax.psum(sample, SPP_AXIS)  # sum of n_spp fresh samples

        # One canonical fold (ops/accumulate.fold_sample): the mean of the
        # n_spp fresh samples folds with weight n_spp; n_spp=1 keeps the
        # reference's exact single-rounding arithmetic.  (_check enforces
        # spp % n_spp == 0; a straddle can still arise from a checkpoint
        # resumed at a misaligned count — fold_sample folds only the taken
        # fraction so the count freezes exactly at the target.)
        mean = batch / jnp.float32(n_spp) if n_spp > 1 else batch
        st = fold_sample(
            AccumState(rgb=rgb_local, count=count), mean, config.spp,
            False, num_samples=n_spp,
        )
        return st.rgb, st.count

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(ROW_AXIS, None, None), P(), P(), P(), P(), P()),
        out_specs=(P(ROW_AXIS, None, None), P()),
        check_vma=False,
    )
    rgb, count = sharded(state.rgb, state.count, spheres, camera, frame_seed, reset)
    return AccumState(rgb=rgb, count=count)


def shard_accum_state(state: AccumState, mesh: Mesh) -> AccumState:
    """Place an accumulation state with rows sharded across the mesh."""
    rgb = jax.device_put(state.rgb, NamedSharding(mesh, P(ROW_AXIS, None, None)))
    count = jax.device_put(state.count, NamedSharding(mesh, P()))
    return AccumState(rgb=rgb, count=count)
