"""Wavefront path tracing: compact-and-restart between bounces.

The megakernel traces a pixel block to termination in one launch: one live
lane drags its whole block through every remaining bounce.  Deep in a path
few rays are alive, yet many blocks still hold one.

This engine restructures the loop the wavefront way (Laine et al.'s
megakernel-vs-wavefront argument, PAPERS.md):

  per bounce:   [bounce kernel over DENSE ray blocks]
                -> accumulate radiance deltas in ray order
                -> stable-partition rays live-first (two cumsums, no sort)
                -> the next bounce's all-dead tail blocks exit at a
                   `pl.when` passthrough

Compaction moves whole 128-ray rows (one gather of the row-major state
planes per bounce), and live rows additionally sort by the octant of their
mean bounce direction (`sort='octant'`, the default): directionally similar
rows share kernel blocks, so the block-coherent BVH cursor descends tighter
subtrees.  Compaction runs only once the live-row fraction falls below
`compact_threshold`.

Correctness falls out of the RNG design: every draw is a counter hash of
(GLOBAL pixel id, sample, frame seed, salt) (ops/rng.py), so compaction
cannot change any ray's random stream — this engine is draw-for-draw
identical to the megakernel and the pure-JAX integrator.  Pixel ids ride
along as an i32 plane; per-bounce seeds are re-derived in-kernel.

The reference has no analogue of any of this (single WGSL kernel,
compute_shader.wgsl:261-297); it is the wavefront scheduler the
ray-tracing literature uses for the same problem.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from gpu_ray_tracing import platform
from gpu_ray_tracing.ops import rng as rng_ops
from gpu_ray_tracing.ops.pallas import megakernel as mk
from gpu_ray_tracing.ops.pallas.megakernel import (
    _SCENE_ROWS,
    _path_bounce,
    bvh_planes,
    lights_planes,
    mesh_table,
    scene_planes,
    tri_lights_planes,
)

Array = jax.Array


def _wf_kernel(
    ints_ref,  # (1, 4) i32: [sample_index, frame_seed, bounce, 0] bits
    scene_ref,
    *rest,
    n_spheres: int,
    has_mesh: bool,
    has_sphere_bvh: bool,
    t_min: float,
    t_max: float,
    rr_depth: int,
    sky_intensity: float,
    num_lights: int,
    mesh_smooth: bool,
    num_tri_lights: int = 0,
    regen: bool = False,
    sampler_spec: tuple | None = None,
    mis: bool = False,
    max_depth: int = 0,  # only read under mis (last-bounce NEE exemption)
    count_rays: bool = False,
):
    """One path bounce over a block of whole 128-ray rows of compacted rays.

    `count_rays=True` adds one output plane after the radiance deltas: the
    bounce's per-lane rays-traced delta (see _path_bounce) — the wavefront
    engine's in-kernel counters.

    `regen=False`: every ray in the launch is at the same (sample, bounce),
    carried as scalars.  `regen=True` (the regenerating engine): rays
    in a tile mix (sample, bounce), carried as two extra i32 lane planes;
    seeds, salts and the NEE light pick all go per-lane — same per-ray
    stream either way (see `_path_bounce`).
    """
    rest = list(rest)
    mesh_refs = None
    sphere_bvh_refs = None
    lights_ref = None
    if has_mesh:
        mesh_refs = tuple(rest[:3])
        rest = rest[3:]
    if has_sphere_bvh:
        sphere_bvh_refs = tuple(rest[:2])
        rest = rest[2:]
    if num_lights > 0:
        lights_ref = rest[0]
        rest = rest[1:]
    tri_lights_ref = None
    if num_tri_lights > 0:
        tri_lights_ref = rest[0]
        rest = rest[1:]
    if regen:
        pid_ref, smp_ref, bnc_ref = rest[:3]
        rest = rest[3:]
    else:
        pid_ref = rest[0]
        rest = rest[1:]
    n_state = 12 if mis else 11  # MIS appends prev_cos LAST (stable indices)
    state_refs = rest[:n_state]
    (oxr, oyr, ozr, dxr, dyr, dzr, trr, tgr, tbr, pdr, lvr) = state_refs[:11]
    outs = rest[n_state:]  # n_state state outs + 3 radiance deltas

    live_f = lvr[:]

    # Default: passthrough state, zero radiance.  After live-first
    # compaction the dead tail is contiguous, so these blocks cost only the
    # copies below.
    for o, r in zip(outs[:n_state], state_refs):
        o[:] = r[:]
    zero = jnp.zeros(live_f.shape, jnp.float32)
    for o in outs[n_state:]:
        o[:] = zero

    frame_seed_u32 = ints_ref[0, 1].astype(jnp.uint32)
    if regen:
        s_u32 = smp_ref[:].astype(jnp.uint32)
        i_b = bnc_ref[:]
    else:
        s_u32 = ints_ref[0, 0].astype(jnp.uint32)
        i_b = ints_ref[0, 2]

    @pl.when(jnp.max(live_f) > 0.5)
    def _():
        pid_u32 = pid_ref[:].astype(jnp.uint32)
        seeds = rng_ops.hash_pixel_seeds(pid_u32, s_u32, frame_seed_u32)
        carry = (
            oxr[:], oyr[:], ozr[:], dxr[:], dyr[:], dzr[:],
            trr[:], tgr[:], tbr[:],
            zero, zero, zero,  # radiance starts at 0 -> outputs are deltas
            live_f, pdr[:],
        )
        if mis:
            carry = carry + (state_refs[11][:],)  # prev_cos
        out = _path_bounce(
            i_b, carry,
            seeds=seeds, scene_ref=scene_ref, lights_ref=lights_ref,
            mesh_refs=mesh_refs, sphere_bvh_refs=sphere_bvh_refs,
            pick_seed=s_u32 ^ rng_ops.wgsl_hash(frame_seed_u32),
            n_spheres=n_spheres, t_min=t_min, t_max=t_max,
            mesh_smooth=mesh_smooth, sky_intensity=sky_intensity,
            num_lights=num_lights, rr_depth=rr_depth,
            tri_lights_ref=tri_lights_ref, num_tri_lights=num_tri_lights,
            pid=pid_u32, s_u32=s_u32, frame_seed_u32=frame_seed_u32,
            sampler_spec=sampler_spec, mis=mis, max_depth=max_depth,
            count_rays=count_rays,
        )
        # out: ox..dz, tr..tb, rad r/g/b, live_f, pd_f[, pc_f][, rays]
        vals = (out[0], out[1], out[2], out[3], out[4], out[5],
                out[6], out[7], out[8], out[13], out[12])
        if mis:
            vals = vals + (out[14],)
        vals = vals + (out[9], out[10], out[11])
        if count_rays:
            vals = vals + (out[-1],)
        for o, v in zip(outs, vals):
            o[:] = v


def _global_pids(local: Array, *, p: int, width: int, height: int,
                 y_offset, total_width: int, row_stride=1) -> Array:
    """GLOBAL pixel ids for local flat indices of a (padded) row shard.

    Local row r maps to global row `y_offset + r * row_stride` (stride 1 =
    contiguous band; stride n = the interleaved partition).  Pad slots
    (local >= p) get ids just past the shard's own range — unique WITHIN
    the shard and sorting after all its real ids, which is all the
    shard-local un-permute and regen bookkeeping need; their lanes are
    born dead."""
    y_off = jnp.asarray(y_offset, jnp.int32)
    stride = jnp.asarray(row_stride, jnp.int32)
    return jnp.where(
        local < p,
        (local // width * stride + y_off) * total_width + local % width,
        (y_off + height * stride) * total_width + (local - p),
    )


def _partition_live(live: Array) -> Array:
    """Gather permutation placing live entries first, order-stable (two
    cumsums, no sort)."""
    p = live.shape[0]
    lv = live > 0.5
    n_live = jnp.sum(lv.astype(jnp.int32))
    pos_live = jnp.cumsum(lv.astype(jnp.int32)) - 1
    pos_dead = n_live + jnp.cumsum((~lv).astype(jnp.int32)) - 1
    dest = jnp.where(lv, pos_live, pos_dead)
    return jnp.zeros((p,), jnp.int32).at[dest].set(jnp.arange(p, dtype=jnp.int32))


#: Per-axis cell count of the spatial sort's origin grid (sort='spatial'):
#: rows are binned by mean-origin cell of a SORT_CELLS^3 grid over the
#: live rows' origin AABB, then by direction octant within each cell.
SORT_CELLS = 4


def _sort_rows_octant(live_rows: Array, dx, dy, dz, bounce_rows=None,
                      origins=None, cells: int = SORT_CELLS) -> Array:
    """Gather permutation: live rows first, grouped by the octant of each
    row's mean bounce direction (dead rows last).  Groups directionally
    similar rows into the same kernel block so the block-coherent BVH cursor
    descends tighter subtrees.

    `bounce_rows` (regeneration pools, where rows mix bounce depths but each
    row's 128 rays bounce in lockstep) additionally groups rows by a capped
    bounce bucket BEFORE the octant: fresh primary rows are directionally
    tight and should not share blocks with deep diffuse rows, whose wide
    subtree unions would otherwise tax every tile they touch.

    `origins` (sort='spatial'; the (ox, oy, oz) planes) additionally bins
    rows by the cell of their mean ray ORIGIN on a `cells`^3 grid spanning
    the live rows' origin bounding box (recomputed per bounce — the live
    footprint shrinks as paths die), binning coarse-to-fine: bounce bucket,
    then cell, then octant.  After the first diffuse bounce, rays that
    share a direction octant still START all over the scene, so each
    block's BVH subtree union stays near-total; origin
    binning groups rays whose traversal actually touches the same
    neighbourhood."""
    key = (
        (jnp.mean(dx, axis=1) > 0).astype(jnp.int32) * 4
        + (jnp.mean(dy, axis=1) > 0).astype(jnp.int32) * 2
        + (jnp.mean(dz, axis=1) > 0).astype(jnp.int32)
    )
    n_keys = 8
    if origins is not None:
        live_m = live_rows > 0.5
        big = jnp.float32(3.4e38)
        cell = jnp.zeros(key.shape, jnp.int32)
        for plane in origins:
            m = jnp.mean(plane, axis=1)
            lo = jnp.min(jnp.where(live_m, m, big))
            hi = jnp.max(jnp.where(live_m, m, -big))
            step = jnp.maximum(hi - lo, 1e-6) / cells
            c = jnp.clip(((m - lo) / step).astype(jnp.int32), 0, cells - 1)
            cell = cell * cells + c
        key = key + n_keys * cell
        n_keys *= cells ** 3
    if bounce_rows is not None:
        key = key + n_keys * jnp.clip(bounce_rows, 0, 3)
        n_keys *= 4
    key = jnp.where(live_rows > 0.5, key, jnp.int32(n_keys))
    return jnp.argsort(key, stable=True).astype(jnp.int32)


def render_wavefront(
    scene_or_spheres,
    camera,
    *,
    width: int,
    height: int,
    sample_index: Array,
    frame_seed: Array,
    max_depth: int,
    t_min: float,
    t_max: float = 3.4e35,
    russian_roulette_depth: int = 0,
    sky_intensity: float = 1.0,
    nee: bool = False,
    spp: int = 1,
    interpret: bool | None = None,
    sort: str = "octant",  # 'octant' (default) | 'live'
    compact_threshold: float = 0.9,
    y_offset: Array | int = 0,
    total_width: int | None = None,
    row_stride: Array | int = 1,
    regenerate: bool = False,
    refill_threshold: float = 0.25,
    sampler_spec: tuple | None = None,
    mis: bool = False,
    clamp: float = 0.0,
    return_ray_count: bool = False,
) -> Array:
    """Path-trace spp samples with per-bounce ray compaction; returns the
    (height, width, 3) RGB mean.  Draw-for-draw the same image as the
    megakernel / jax backends (same counter-based stream).

    `return_ray_count=True` additionally returns the (height, width)
    per-pixel count of rays traced across all samples (in-kernel counters,
    same definition as the megakernel's — the counts agree exactly because
    the engines trace the identical ray set).  Unsupported with
    regenerate=True (the pool's per-bounce deltas have no per-sample
    total); the megakernel counter covers that case by stream invariance.

    Ray generation and compaction run in XLA; each bounce is one Pallas
    launch over the compacted ray array.  `y_offset`/`total_width` address a
    row shard of a larger frame (the sharded renderer passes the shard's
    global row offset): pixel ids — and therefore the RNG stream — are
    global, so sharded output equals the unsharded render's rows.

    `regenerate=True` (ray regeneration; only meaningful for spp > 1) keeps
    ONE persistent ray pool across all spp samples instead of tracing each
    sample to termination: whenever at least `refill_threshold` of the
    pool's rows have fully died, dead rows are refilled with the next
    sample's primary rays, so the deep-bounce tail of sample s overlaps the
    cheap early bounces of sample s+1.  Rays of different (sample, bounce)
    then share kernel tiles, carried as two extra i32 lane planes; every
    per-ray draw is the same counter hash as the other engines, so the
    estimator is unchanged — per-pixel sums may differ in the last float
    bits only because radiance deltas accumulate in pool order rather than
    sample-major order.
    """
    from gpu_ray_tracing.models.scene import as_scene, resolve_mesh_has_emissive
    from gpu_ray_tracing.ops import rays as rays_ops

    if sort not in ("octant", "octant-flat", "spatial", "live"):
        raise ValueError(
            f"sort={sort!r}; expected 'octant', 'octant-flat', 'spatial' "
            "or 'live'"
        )
    if regenerate and not 0.0 <= refill_threshold <= 1.0:
        # > 1.0 would never refill while stream blocks remain -> the pool
        # loop could spin forever with zero live rays.
        raise ValueError(
            f"refill_threshold={refill_threshold} must be within [0, 1]"
        )
    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")  # avoids img/0 NaN
    if mis and not nee:
        raise ValueError("mis=True is a weighting of NEE; it requires nee=True")
    if clamp > 0.0 and regenerate:
        # The regenerating pool scatter-adds per-BOUNCE radiance deltas
        # straight into the image accumulator; a per-sample clamp has no
        # per-sample total to act on there.
        raise ValueError("clamp > 0 is unsupported with ray regeneration")
    if return_ray_count and regenerate:
        raise ValueError(
            "return_ray_count is unsupported with ray regeneration; use "
            "the megakernel counter (count_traced_rays) — the count is "
            "engine-invariant"
        )
    sc = as_scene(scene_or_spheres)
    spheres = sc.spheres
    if sc.mesh is not None and sc.bvh is None:
        raise ValueError("wavefront mesh rendering requires a BVH (make_scene)")

    if interpret is None:
        interpret = platform.interpret()

    # A block is whole 128-ray rows (the compaction unit) and at least one
    # megakernel path block; its warps scale with it, so a thread holds as
    # many rays as a megakernel thread does.
    block_rows, block_cols, block_warps = mk.block_shape("path")
    block_px = block_rows * block_cols
    tile_rows = max(1, block_px // 128)
    wf_tile = tile_rows * 128
    num_warps = block_warps * wf_tile // block_px
    p = width * height
    p_pad = -(-p // wf_tile) * wf_tile
    rows = p_pad // 128
    grid = (rows // tile_rows,)

    scene_arr = scene_planes(spheres)
    n = spheres.count
    # Whole-array operands, read by scalar loads only.
    whole = lambda shape: pl.BlockSpec(shape, lambda i: (0, 0))
    tile = pl.BlockSpec((tile_rows, 128), lambda i: (i, 0))

    in_specs = [whole((1, 4)), whole((_SCENE_ROWS, n))]
    static_args = [scene_arr]
    has_mesh = sc.mesh is not None
    has_sphere_bvh = sc.sphere_bvh is not None
    if has_mesh:
        tri_lids = None
        if nee and sc.tri_lights is not None:
            # Global light ordinals per face (sphere lights first) for the
            # table's _TLID slot — the MIS light-id plane for mesh wins.
            from gpu_ray_tracing.models.scene import tri_light_id_per_face

            base_lid = tri_light_id_per_face(sc.mesh, sc.tri_lights)
            n_sl0 = 0 if sc.lights is None else sc.lights.count
            tri_lids = jnp.where(base_lid >= 0, base_lid + n_sl0, -1)
        tbl = mesh_table(sc.mesh, tri_light_ids=tri_lids)
        in_specs += [
            whole(tbl.shape),
            whole((8, sc.bvh.num_nodes)),
            whole((4, sc.bvh.num_nodes)),
        ]
        bvhf, bvhi = bvh_planes(sc.bvh)
        static_args += [tbl, bvhf, bvhi]
    if has_sphere_bvh:
        sbf, sbi = bvh_planes(sc.sphere_bvh)
        in_specs += [whole((8, sc.sphere_bvh.num_nodes)),
                     whole((4, sc.sphere_bvh.num_nodes))]
        static_args += [sbf, sbi]
    num_lights = 0
    num_tri_lights = 0
    if nee:
        n_sl = 0 if sc.lights is None else sc.lights.count
        n_tl = 0 if sc.tri_lights is None else sc.tri_lights.count
        if n_sl + n_tl == 0:
            raise ValueError("nee=True needs a Scene with emissive lights")
        if resolve_mesh_has_emissive(sc) and sc.tri_lights is None:
            raise ValueError(
                "nee=True with EMISSIVE mesh faces needs the triangle "
                "light list; build the Scene via make_scene (it extracts "
                "tri_lights)"
            )
        num_lights, num_tri_lights = n_sl, n_tl
        if num_lights > 0:
            in_specs += [whole((8, num_lights))]
            static_args += [lights_planes(sc.lights)]
        if num_tri_lights > 0:
            in_specs += [whole((16, num_tri_lights))]
            static_args += [tri_lights_planes(sc.tri_lights)]
    mis = mis and (num_lights + num_tri_lights) > 0
    n_state = 12 if mis else 11  # prev_cos appended last under MIS
    n_tail = 4 if return_ray_count else 3  # radiance deltas [+ ray count]
    in_specs += [tile] * (n_state + (3 if regenerate else 1))
    out_specs = tuple([tile] * (n_state + n_tail))
    plane = jax.ShapeDtypeStruct((rows, 128), jnp.float32)
    out_shape = tuple([plane] * (n_state + n_tail))

    kernel = functools.partial(
        _wf_kernel,
        n_spheres=n, has_mesh=has_mesh, has_sphere_bvh=has_sphere_bvh,
        t_min=float(t_min), t_max=float(t_max),
        rr_depth=russian_roulette_depth, sky_intensity=float(sky_intensity),
        num_lights=num_lights, mesh_smooth=has_mesh and sc.mesh.smooth,
        num_tri_lights=num_tri_lights,
        regen=regenerate, sampler_spec=sampler_spec, mis=mis,
        max_depth=max_depth, count_rays=return_ray_count,
    )
    bounce_call = pl.pallas_call(
        kernel, grid=grid, in_specs=in_specs, out_specs=out_specs,
        out_shape=out_shape, interpret=interpret,
        compiler_params=mk.compiler_params(num_warps), name="wavefront_bounce",
    )

    # GLOBAL pixel ids (row-shard aware); pad ids stay unique so the final
    # row un-permute has no collisions — their lanes are dead from the start.
    tw = width if total_width is None else total_width
    pid0 = _global_pids(
        jnp.arange(p_pad, dtype=jnp.int32), p=p, width=width, height=height,
        y_offset=y_offset, total_width=tw, row_stride=row_stride,
    ).reshape(rows, 128)
    pad_live = jnp.concatenate(
        [jnp.ones((p,), jnp.float32), jnp.zeros((p_pad - p,), jnp.float32)]
    ).reshape(rows, 128)

    def pad_plane(v):
        return jnp.concatenate(
            [v.reshape(-1), jnp.zeros((p_pad - p,), jnp.float32)]
        ).reshape(rows, 128)

    frame_seed = jnp.asarray(frame_seed, jnp.uint32)
    sample_index = jnp.asarray(sample_index, jnp.uint32)

    if regenerate:
        return _run_regen(
            bounce_call, static_args, camera,
            width=width, height=height, rows=rows, p=p, spp=spp,
            max_depth=max_depth, sample_index=sample_index,
            frame_seed=frame_seed, sort=sort,
            compact_threshold=compact_threshold,
            refill_threshold=refill_threshold,
            y_offset=y_offset, total_width=tw, row_stride=row_stride,
            sampler_spec=sampler_spec, mis=mis,
        )

    def one_sample(s_u32):
        origins, dirs, _ = rays_ops.generate_rays_hash(
            camera, width, height, s_u32, frame_seed,
            y_offset=y_offset, total_width=tw, row_stride=row_stride,
            sampler_spec=sampler_spec,
        )
        state = (
            pid0,
            pad_plane(origins[..., 0]), pad_plane(origins[..., 1]),
            pad_plane(origins[..., 2]),
            pad_plane(dirs[..., 0]), pad_plane(dirs[..., 1]),
            pad_plane(dirs[..., 2]),
            pad_plane(jnp.ones((height, width), jnp.float32)),  # throughput
            pad_plane(jnp.ones((height, width), jnp.float32)),
            pad_plane(jnp.ones((height, width), jnp.float32)),
            jnp.zeros((rows, 128), jnp.float32),  # prev_diffuse
            pad_live,
        )
        if mis:
            state = state + (jnp.zeros((rows, 128), jnp.float32),)  # prev_cos
        rad = (jnp.zeros((rows, 128), jnp.float32),) * n_tail

        def cond(c):
            i_b, n_live = c[0], c[1]
            return (i_b < max_depth) & (n_live > 0)

        def body(c):
            i_b, _, state, rad = c
            ints = jax.lax.bitcast_convert_type(
                jnp.stack([s_u32, frame_seed,
                           jnp.asarray(i_b, jnp.uint32), jnp.uint32(0)]),
                jnp.int32,
            ).reshape(1, 4)
            res = bounce_call(ints, *static_args, *state)
            new_state = (state[0],) + tuple(res[:n_state])
            # Radiance rides in permuted ray order (elementwise add, fused);
            # one row un-permute at sample end puts it back in image order.
            rad = tuple(r + d for r, d in zip(rad, res[n_state:]))
            # Live-first compaction at ROW granularity (128 rays).  The next
            # bounce's all-dead tail blocks exit at the kernel's pl.when.
            # Gated on occupancy: permuting the state buys nothing while
            # nearly every row is still live (the first bounces of a
            # typical path trace) — skip it until the live-row fraction
            # drops below `compact_threshold`.
            live_rows = jnp.max(new_state[11], axis=1)
            frac_live = jnp.mean((live_rows > 0.5).astype(jnp.float32))

            def compact(args):
                state, rad = args
                if sort in ("octant", "octant-flat"):
                    # No bounce key: in the sample-major loop every row is
                    # at the same depth anyway.
                    perm = _sort_rows_octant(live_rows, state[4], state[5], state[6])
                elif sort == "spatial":
                    perm = _sort_rows_octant(
                        live_rows, state[4], state[5], state[6],
                        origins=(state[1], state[2], state[3]),
                    )
                else:
                    perm = _partition_live(live_rows)
                return tuple(s[perm] for s in state), tuple(r[perm] for r in rad)

            new_state, rad = jax.lax.cond(
                frac_live < compact_threshold, compact, lambda a: a,
                (new_state, rad),
            )
            n_live = jnp.sum((new_state[11] > 0.5).astype(jnp.int32))
            return i_b + 1, n_live, new_state, rad

        _, _, state, rad = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.int32(p), state, rad)
        )
        # Invert the accumulated row permutation: rows moved as units and
        # pids are strictly increasing along the shard's original layout, so
        # argsort of each row's first pid IS the original-order gather.
        inv = jnp.argsort(state[0][:, 0]).astype(jnp.int32)
        if clamp > 0.0:
            # Per-sample max-component radiance clamp (elementwise - each
            # lane is one pixel's sample - so permutation order is moot);
            # same arithmetic as the megakernel and clamp_radiance.  The
            # ray-count plane (rad[3:], when present) is never scaled.
            m = jnp.maximum(rad[0], jnp.maximum(rad[1], rad[2]))
            scale = jnp.minimum(
                1.0, jnp.float32(clamp) / jnp.maximum(m, 1e-12)
            )
            rad = tuple(r * scale for r in rad[:3]) + rad[3:]
        return tuple(r[inv] for r in rad)

    def spp_body(k, acc):
        rad = one_sample(sample_index + jnp.asarray(k, jnp.uint32))
        return tuple(a + r for a, r in zip(acc, rad))

    z = jnp.zeros((rows, 128), jnp.float32)
    rad = jax.lax.fori_loop(0, spp, spp_body, (z,) * n_tail)
    img = jnp.stack(
        [r.reshape(-1)[:p].reshape(height, width) for r in rad[:3]], axis=-1
    ) / jnp.float32(spp)
    if return_ray_count:
        return img, rad[3].reshape(-1)[:p].reshape(height, width)
    return img


def _run_regen(
    bounce_call,
    static_args,
    camera,
    *,
    width: int,
    height: int,
    rows: int,
    p: int,
    spp: int,
    max_depth: int,
    sample_index: Array,
    frame_seed: Array,
    sort: str,
    compact_threshold: float,
    refill_threshold: float,
    y_offset: Array | int,
    total_width: int,
    row_stride: Array | int = 1,
    sampler_spec: tuple | None = None,
    mis: bool = False,
) -> Array:
    """Ray-regeneration wavefront loop: one persistent pool over all samples.

    The sample stream is `spp * rows` row blocks of 128 rays (sample-major,
    each block = one 128-pixel slice of the padded frame).  The pool holds
    `rows` rows; one `while_loop` iteration = one bounce of every pooled ray.
    When at least `refill_threshold` of the rows have fully died (and stream
    blocks remain), dead rows are refilled in stream order with fresh primary
    rays — the classic wavefront "path regeneration" step, at row
    granularity.  Radiance deltas scatter-add into a (rows, 128) image
    accumulator by each row's block id — a whole-row scatter, same cost class
    as the compaction gathers.

    Correctness: a ray's every draw is hash(pixel id, ABSOLUTE sample, frame
    seed, bounce salt), carried per lane, so each of the spp*p rays traces
    the identical path it would in any other engine; only the per-pixel
    float accumulation ORDER differs (pool order, not sample-major order).
    """
    from gpu_ray_tracing.ops import rays as rays_ops

    if max_depth <= 0:
        # Every engine returns black at zero depth (the bounce loop never
        # runs); the pool loop would otherwise trace one bounce first.
        return jnp.zeros((height, width, 3), jnp.float32)
    # Blocks per frame counts only 128-pixel blocks that contain at least
    # one REAL pixel — the pool is still `rows` slots (a tile-multiple),
    # but issuing the padded frame's pure-pad tail blocks would spend
    # refill slots and bounce iterations on rows that are born dead (59%
    # of the stream at 50x31).
    bpf = -(-p // 128)
    total_blocks = spp * bpf
    lane = jax.lax.broadcasted_iota(jnp.int32, (rows, 128), 1)
    s0 = jnp.asarray(sample_index, jnp.int32)
    ints = jax.lax.bitcast_convert_type(
        jnp.stack([jnp.uint32(0), frame_seed, jnp.uint32(0), jnp.uint32(0)]),
        jnp.int32,
    ).reshape(1, 4)

    def fresh(blk):
        """Primary-ray state for per-row stream block ids (i32 (rows,), -1 =
        empty slot; empty/pad lanes are born dead)."""
        local = (blk % bpf)[:, None] * 128 + lane
        in_frame = local < p
        pid = _global_pids(
            local, p=p, width=width, height=height,
            y_offset=y_offset, total_width=total_width,
            row_stride=row_stride,
        )
        smp = jnp.broadcast_to((s0 + blk // bpf)[:, None], (rows, 128))
        o, d, _ = rays_ops.generate_rays_for_ids(
            camera, pid, smp.astype(jnp.uint32), frame_seed,
            total_width=total_width, sampler_spec=sampler_spec,
        )
        one = jnp.ones((rows, 128), jnp.float32)
        zero = jnp.zeros((rows, 128), jnp.float32)
        live = (in_frame & (blk >= 0)[:, None]).astype(jnp.float32)
        state = (
            o[..., 0], o[..., 1], o[..., 2],
            d[..., 0], d[..., 1], d[..., 2],
            one, one, one, zero, live,
        )
        if mis:
            state = state + (zero,)  # prev_cos (appended last)
        return pid, smp, jnp.zeros((rows, 128), jnp.int32), state

    row_ids = jnp.arange(rows, dtype=jnp.int32)
    blk0 = jnp.where(row_ids < total_blocks, row_ids, jnp.int32(-1))
    pid0, smp0, bnc0, state0 = fresh(blk0)
    next0 = jnp.minimum(jnp.int32(rows), jnp.int32(total_blocks))
    img0 = (jnp.zeros((bpf, 128), jnp.float32),) * 3

    def cond(c):
        return (c[0] < total_blocks) | (c[1] > 0)

    def body(c):
        nxt, _, pid, smp, bnc, state, blk, img = c
        n_state = 12 if mis else 11
        res = bounce_call(ints, *static_args, pid, smp, bnc, *state)
        state = tuple(res[:n_state])
        # Pool-order radiance accumulation: one whole-row scatter-add per
        # bounce into the image-order accumulator (dead/empty rows emit
        # zeros; emptied slots scatter out of bounds and are dropped).
        idx = jnp.where(blk >= 0, blk % bpf, bpf)
        img = tuple(a.at[idx].add(d, mode="drop") for a, d in zip(img, res[n_state:]))
        bnc = bnc + 1
        live_pl = jnp.where(bnc >= max_depth, 0.0, state[10])
        state = state[:10] + (live_pl,) + state[11:]
        live_rows = jnp.max(live_pl, axis=1)
        frac_live = jnp.mean((live_rows > 0.5).astype(jnp.float32))

        def compact(args):
            pid, smp, bnc, state, blk = args
            if sort == "octant":
                # Rows bounce in lockstep, so bnc[:, 0] is the row's depth;
                # group by (bounce bucket, octant) to keep fresh coherent
                # rows out of deep incoherent rows' tiles.
                perm = _sort_rows_octant(
                    live_rows, state[3], state[4], state[5],
                    bounce_rows=bnc[:, 0],
                )
            elif sort == "spatial":
                perm = _sort_rows_octant(
                    live_rows, state[3], state[4], state[5],
                    bounce_rows=bnc[:, 0],
                    origins=(state[0], state[1], state[2]),
                )
            elif sort == "octant-flat":
                perm = _sort_rows_octant(live_rows, state[3], state[4], state[5])
            else:
                perm = _partition_live(live_rows)
            return (
                pid[perm], smp[perm], bnc[perm],
                tuple(s[perm] for s in state), blk[perm],
            )

        pid, smp, bnc, state, blk = jax.lax.cond(
            frac_live < compact_threshold, compact, lambda a: a,
            (pid, smp, bnc, state, blk),
        )

        live_row = jnp.max(state[10], axis=1) > 0.5
        blk = jnp.where(live_row, blk, jnp.int32(-1))
        dead = ~live_row
        rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
        avail = total_blocks - nxt
        take = dead & (rank < avail)
        k = jnp.minimum(jnp.sum(dead.astype(jnp.int32)), avail)
        frac_dead = jnp.mean(dead.astype(jnp.float32))
        # Refill when enough rows died to amortize the whole-pool raygen
        # pass, or unconditionally near stream end (so the stream drains).
        do_refill = (k > 0) & (
            (frac_dead >= refill_threshold) | (avail <= rows)
        )

        def refill(args):
            pid, smp, bnc, state, blk = args
            new_blk = jnp.where(take, nxt + rank, blk)
            f_pid, f_smp, f_bnc, f_state = fresh(new_blk)
            tm = take[:, None]
            return (
                jnp.where(tm, f_pid, pid),
                jnp.where(tm, f_smp, smp),
                jnp.where(tm, f_bnc, bnc),
                tuple(jnp.where(tm, f, s) for f, s in zip(f_state, state)),
                new_blk,
                nxt + k,
            )

        pid, smp, bnc, state, blk, nxt = jax.lax.cond(
            do_refill, refill,
            lambda args: args + (nxt,),
            (pid, smp, bnc, state, blk),
        )
        n_live = jnp.sum((state[10] > 0.5).astype(jnp.int32))
        return nxt, n_live, pid, smp, bnc, state, blk, img

    carry = (next0, jnp.int32(1), pid0, smp0, bnc0, state0, blk0, img0)
    _, _, _, _, _, _, _, img = jax.lax.while_loop(cond, body, carry)
    out = jnp.stack(
        [r.reshape(-1)[:p].reshape(height, width) for r in img], axis=-1
    )
    return out / jnp.float32(spp)
