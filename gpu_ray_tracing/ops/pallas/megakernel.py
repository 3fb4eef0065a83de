"""Fused Pallas megakernel: the WGSL compute shader's GPU counterpart.

This is the framework's device kernel — the counterpart of the reference's
entire `compute_shader.wgsl` (ray trace at wgsl:261-297, closest hit at
wgsl:164-221, materials at wgsl:84-141, update dispatch at wgsl:333-364) —
compiled for NVIDIA GPUs through Pallas's Triton route:

  - Pixels tile onto small power-of-two blocks (`block_shape`), one
    Triton program per block; within a block each plane is spread over the
    program's warps, so a lane is a thread as in the reference's 8x8
    workgroups.
  - The scene lives in device memory as a (16, N) plane (SoA); the sphere
    scan broadcasts one sphere's scalars against the whole pixel block per
    step — the reference's per-thread linear scan (wgsl:169-179) with its
    shrinking closest-so-far window.
  - The closest-hit carry tracks (t_best, index, and the hit sphere's
    attributes) so no gather is needed after the scan.
  - The bounce loop runs entirely in registers: no (pixels x spheres) or
    per-bounce intermediates ever touch device memory, which is what limits
    the plain jax path.  Dead lanes are masked; the loop exits once every
    ray in the block has terminated (the block analogue of the reference's
    per-thread `break`, wgsl:289).
  - RNG is the framework's counter-based hash stream (ops/rng.py), seeded
    per pixel — draw-for-draw identical to the pure-JAX 'hash' integrator,
    so the two backends produce the same image up to fp rounding.  (One
    exception: NEE with more than 4 lights picks the sampled light once per
    (sample, bounce) here vs per lane in the jax path — same estimator,
    different noise pattern.  The pick never involves block ids, so the
    megakernel, the wavefront engine, and all shardings draw it
    identically.)

Ray generation (the reference's get_ray, wgsl:305-331) is fused into the
kernel too: a 2D grid of pixel blocks derives pixel ids from program ids,
draws jitter/defocus from the hash stream, and builds rays from ~20 camera
scalars.  Per frame the kernel reads ~200 bytes + the scene and writes only
the image — there is no per-ray device-memory traffic at all.  All vector
math is on separate x/y/z component planes (component-of-arrays).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from gpu_ray_tracing import platform
from gpu_ray_tracing.models.spheres import Spheres
from gpu_ray_tracing.ops import rng as rng_ops
from gpu_ray_tracing.ops.integrators import _one_minus_cos_max

Array = jax.Array


# Scene plane rows (first axis of the (16, N) scene array).
_CX, _CY, _CZ, _RAD, _C2R2, _ALR, _ALG, _ALB, _KIND, _PARAM, _ACTIVE = range(11)
_LIGHTID = 11  # NEE light index of active emissive spheres; -1 otherwise
_SCENE_ROWS = 16

# Pixel block of one Triton program and its warp count, (rows, cols, warps),
# chosen by the block sweep on the card (PERF.md, "Block shape").  Powers of
# two, as Triton requires.  Paths want one warp over 32 pixels: the
# per-block BVH cursor (_traverse_bvh) stays as coherent as a warp-level
# packet and the bounce loop's few dozen carried planes stay in registers.
# The AOV modes (normal, albedo, depth) trace one coherent primary ray per
# pixel and want larger blocks.
PATH_BLOCK = (2, 16, 1)
AOV_BLOCK = (8, 16, 4)


def block_shape(mode: str) -> tuple[int, int, int]:
    """(rows, cols, warps) of one megakernel program for `mode`."""
    return PATH_BLOCK if mode == "path" else AOV_BLOCK


def compiler_params(num_warps: int):
    """Triton compiler parameters of a pallas_call in this package."""
    return plt.CompilerParams(num_warps=num_warps, num_stages=1)


def scene_planes(spheres: Spheres) -> Array:
    """Pack a Spheres SoA into the (16, N) f32 scene layout."""
    n = spheres.count
    planes = jnp.zeros((_SCENE_ROWS, n), jnp.float32)
    c = spheres.centers
    r = spheres.radii
    planes = planes.at[_CX].set(c[:, 0])
    planes = planes.at[_CY].set(c[:, 1])
    planes = planes.at[_CZ].set(c[:, 2])
    planes = planes.at[_RAD].set(r)
    planes = planes.at[_C2R2].set(jnp.sum(c * c, axis=-1) - r * r)
    planes = planes.at[_ALR].set(spheres.albedo[:, 0])
    planes = planes.at[_ALG].set(spheres.albedo[:, 1])
    planes = planes.at[_ALB].set(spheres.albedo[:, 2])
    planes = planes.at[_KIND].set(spheres.mat_kind.astype(jnp.float32))
    planes = planes.at[_PARAM].set(spheres.mat_param)
    planes = planes.at[_ACTIVE].set((r > 0.0).astype(jnp.float32))
    # Light index = ordinal of the active emissive sphere in array order —
    # the exact order models.scene.extract_lights emits, so the MIS weight
    # can identify "which light did this BSDF ray hit" by IDENTITY instead
    # of the r3 geometric tolerance.  -1 for non-lights.
    from gpu_ray_tracing.models.spheres import EMISSIVE

    is_em = (spheres.mat_kind == EMISSIVE) & (r > 0.0)
    lid = jnp.where(is_em, jnp.cumsum(is_em.astype(jnp.int32)) - 1, -1)
    planes = planes.at[_LIGHTID].set(lid.astype(jnp.float32))
    return planes


# Triangle table: one (32,) f32 row per triangle (128 B), in device memory
# (~10.5 MB at 81,920 triangles).  The leaf scan reads each attribute with
# a scalar load, broadcast over the pixel block.
_TRI_SLOTS = 32
# Slot offsets inside a triangle's row.
_TV0, _TE1, _TE2 = 0, 3, 6
_TN0, _TN1, _TN2 = 9, 12, 15  # corner normals (n0 alone when flat-shaded)
_TALB, _TKIND, _TPARAM = 18, 21, 22
_TLID = 23  # global NEE light ordinal of emissive faces; -1 otherwise

# BVH node plane rows: f32 (8, M) bounds; i32 (4, M) links.
_BMINX, _BMINY, _BMINZ, _BMAXX, _BMAXY, _BMAXZ = range(6)
_LMISS, _LSTART, _LCOUNT = range(3)


def mesh_table(mesh, tri_light_ids=None) -> Array:
    """Pack a TriangleMesh into the (F, 32) f32 triangle table.

    `tri_light_ids` ((F,) i32, optional): GLOBAL NEE light ordinal per face
    (-1 for non-lights) — slot _TLID, read by the closest-hit light-id
    plane under MIS.  Packed as -1 everywhere when absent.
    """
    f = mesh.num_triangles
    if mesh.smooth:
        n0, n1, n2 = mesh.n0, mesh.n1, mesh.n2
    else:
        n0 = n1 = n2 = mesh.normals
    if tri_light_ids is None:
        lid_col = jnp.full((f, 1), -1.0, jnp.float32)
    else:
        lid_col = jnp.asarray(tri_light_ids, jnp.float32)[:, None]
    return jnp.concatenate(
        [
            mesh.v0, mesh.e1, mesh.e2, n0, n1, n2, mesh.albedo,
            mesh.mat_kind.astype(jnp.float32)[:, None],
            mesh.mat_param[:, None],
            lid_col,
            jnp.zeros((f, _TRI_SLOTS - 24), jnp.float32),
        ],
        axis=1,
    )


def lights_planes(lights) -> Array:
    """Pack a Lights list into the (8, L) f32 layout:
    rows cx, cy, cz, radius, emission r/g/b, pad."""
    m = lights.count
    planes = jnp.zeros((8, m), jnp.float32)
    planes = planes.at[0].set(lights.centers[:, 0])
    planes = planes.at[1].set(lights.centers[:, 1])
    planes = planes.at[2].set(lights.centers[:, 2])
    planes = planes.at[3].set(lights.radii)
    planes = planes.at[4].set(lights.emission[:, 0])
    planes = planes.at[5].set(lights.emission[:, 1])
    planes = planes.at[6].set(lights.emission[:, 2])
    return planes


def tri_lights_planes(tri_lights) -> Array:
    """Pack a TriLights list into the (16, T) f32 layout: rows
    v0.xyz 0-2, e1.xyz 3-5, e2.xyz 6-8, unit normal 9-11, area 12,
    emission r/g/b 13-15."""
    t = tri_lights.count
    planes = jnp.zeros((16, t), jnp.float32)
    for k in range(3):
        planes = planes.at[0 + k].set(tri_lights.v0[:, k])
        planes = planes.at[3 + k].set(tri_lights.e1[:, k])
        planes = planes.at[6 + k].set(tri_lights.e2[:, k])
        planes = planes.at[9 + k].set(tri_lights.normal[:, k])
        planes = planes.at[13 + k].set(tri_lights.emission[:, k])
    planes = planes.at[12].set(tri_lights.area)
    return planes


def bvh_planes(bvh) -> tuple[Array, Array]:
    """Pack a threaded BVH into ((8, M) f32 bounds, (4, M) i32 links)."""
    m = bvh.num_nodes
    fplanes = jnp.zeros((8, m), jnp.float32)
    fplanes = fplanes.at[_BMINX].set(bvh.bbox_min[:, 0])
    fplanes = fplanes.at[_BMINY].set(bvh.bbox_min[:, 1])
    fplanes = fplanes.at[_BMINZ].set(bvh.bbox_min[:, 2])
    fplanes = fplanes.at[_BMAXX].set(bvh.bbox_max[:, 0])
    fplanes = fplanes.at[_BMAXY].set(bvh.bbox_max[:, 1])
    fplanes = fplanes.at[_BMAXZ].set(bvh.bbox_max[:, 2])
    iplanes = jnp.zeros((4, m), jnp.int32)
    iplanes = iplanes.at[_LMISS].set(bvh.miss_link)
    iplanes = iplanes.at[_LSTART].set(bvh.leaf_start)
    iplanes = iplanes.at[_LCOUNT].set(bvh.leaf_count)
    return fplanes, iplanes


def _traverse_bvh(bvhf_ref, bvhi_ref, t_min, ox, oy, oz, dx, dy, dz, carry, leaf_scan):
    """Tile-coherent stackless BVH traversal (generic over the leaf scan).

    One SCALAR cursor per tile walks the threaded BVH (ops/bvh.py layout):
    the tile descends when ANY lane's slab test overlaps its shrinking
    closest-hit window (carry[0] must be the per-lane window tb); leaves run
    `leaf_scan(leaf_start, leaf_count, carry)`.  Coherent tiles (primary
    rays) visit only their frustum's subtree; the worst case degrades to the
    brute-force scan, never worse than the reference's O(N) per ray.
    """
    safe = lambda v: jnp.where(jnp.abs(v) < 1e-20, jnp.float32(1e-20), v)
    ivx, ivy, ivz = 1.0 / safe(dx), 1.0 / safe(dy), 1.0 / safe(dz)

    def cond(state):
        return state[0] >= 0

    def body(state):
        cursor, carry = state
        tb = carry[0]
        bnx = bvhf_ref[_BMINX, cursor]
        bny = bvhf_ref[_BMINY, cursor]
        bnz = bvhf_ref[_BMINZ, cursor]
        bxx = bvhf_ref[_BMAXX, cursor]
        bxy = bvhf_ref[_BMAXY, cursor]
        bxz = bvhf_ref[_BMAXZ, cursor]
        # Slab test per lane against the shrinking window.
        t0x, t1x = (bnx - ox) * ivx, (bxx - ox) * ivx
        t0y, t1y = (bny - oy) * ivy, (bxy - oy) * ivy
        t0z, t1z = (bnz - oz) * ivz, (bxz - oz) * ivz
        tn = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z),
        )
        tf = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z),
        )
        # Entry test as interval overlap of (t_min, tb) with [tn, tf], with
        # tn clamped to t_min FIRST: an empty window (tb <= t_min — dead or
        # occlusion-resolved lanes) then fails even for boxes straddling
        # the ray origin (tn < 0), so inert lanes can never drive descent.
        # For live windows (tb > t_min) the decisions are identical to the
        # unclamped form.
        tn_eff = jnp.maximum(tn, jnp.float32(t_min))
        lane_hit = (tf >= tn_eff) & (tn_eff < tb)
        enter = jnp.max(lane_hit.astype(jnp.float32)) > 0.5  # any() as scalar

        ls = bvhi_ref[_LSTART, cursor]
        lc = bvhi_ref[_LCOUNT, cursor]
        is_leaf = ls >= 0
        trip = jnp.where(enter & is_leaf, lc, 0)
        carry = leaf_scan(ls, trip, carry)

        descend = enter & ~is_leaf
        cursor = jnp.where(descend, cursor + 1, bvhi_ref[_LMISS, cursor])
        return cursor, carry

    _, carry = jax.lax.while_loop(cond, body, (jnp.int32(0), carry))
    return carry


def _mesh_leaf_scan(tbl_ref, ls, trip, carry, tri_test):
    """Run `tri_test(at, carry)` over the triangles [ls, ls+trip) of a
    leaf; `at(slot)` is a scalar load of that triangle's table slot."""

    def body(k, carry):
        t = ls + k
        return tri_test(lambda slot: tbl_ref[t, slot], carry)

    return jax.lax.fori_loop(0, trip, body, carry)


def _tri_intersect(at, ox, oy, oz, dx, dy, dz, t_min, tb):
    """Moller-Trumbore against one table triangle (`at(slot)` loads its
    scalars), broadcast over the pixel block.

    Returns (t, u, v, better): candidate distance, hit barycentrics, and
    the valid-and-strictly-closer mask vs the shrinking window `tb`.  The
    ONE copy of the triangle test — closest-hit attribute resolution and
    the t-only shadow scan both build on it, so epsilons and window
    semantics cannot drift apart.
    """
    v0x, v0y, v0z = at(_TV0), at(_TV0 + 1), at(_TV0 + 2)
    e1x, e1y, e1z = at(_TE1), at(_TE1 + 1), at(_TE1 + 2)
    e2x, e2y, e2z = at(_TE2), at(_TE2 + 1), at(_TE2 + 2)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok_det = jnp.abs(det) > 1e-12
    inv_det = 1.0 / jnp.where(ok_det, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    better = (
        ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > t_min) & (t < tb)
    )
    return t, u, v, better


def _traverse_mesh(
    tbl_ref, bvhf_ref, bvhi_ref,
    t_min, ox, oy, oz, dx, dy, dz,
    carry,
    smooth: bool = False,
):
    """Mesh BVH traversal: triangle-table Moller-Trumbore leaf scan.

    `carry` is (tb, nxp, nyp, nzp, ar, ag, ab, kp, pp): the shared closest-
    hit state, with OUTWARD normals in the n-planes; sphere results already
    folded in by the caller.  An optional 10th plane is the light-id (MIS):
    a triangle win takes the face's _TLID slot — the global NEE ordinal of
    emissive faces, -1 otherwise — giving mesh lights the same exact
    identity sphere lights have.  With `smooth`, corner normals
    interpolate at the hit barycentrics — UNNORMALIZED (the caller
    renormalizes once after traversal instead of per candidate).
    """
    with_lid = len(carry) == 10

    def tri_test(at, carry):
        if with_lid:
            tb, nxp, nyp, nzp, ar, ag, ab, kp, pp, lidp = carry
        else:
            tb, nxp, nyp, nzp, ar, ag, ab, kp, pp = carry
        t, u, v, better = _tri_intersect(
            at, ox, oy, oz, dx, dy, dz, t_min, tb
        )
        if smooth:
            w0 = 1.0 - u - v
            snx = w0 * at(_TN0) + u * at(_TN1) + v * at(_TN2)
            sny = w0 * at(_TN0 + 1) + u * at(_TN1 + 1) + v * at(_TN2 + 1)
            snz = w0 * at(_TN0 + 2) + u * at(_TN1 + 2) + v * at(_TN2 + 2)
        else:
            snx, sny, snz = at(_TN0), at(_TN0 + 1), at(_TN0 + 2)
        tb = jnp.where(better, t, tb)
        nxp = jnp.where(better, snx, nxp)
        nyp = jnp.where(better, sny, nyp)
        nzp = jnp.where(better, snz, nzp)
        ar = jnp.where(better, at(_TALB), ar)
        ag = jnp.where(better, at(_TALB + 1), ag)
        ab = jnp.where(better, at(_TALB + 2), ab)
        kp = jnp.where(better, at(_TKIND), kp)
        pp = jnp.where(better, at(_TPARAM), pp)
        if with_lid:
            lidp = jnp.where(better, at(_TLID), lidp)
            return tb, nxp, nyp, nzp, ar, ag, ab, kp, pp, lidp
        return tb, nxp, nyp, nzp, ar, ag, ab, kp, pp

    def leaf_scan(ls, trip, carry):
        return _mesh_leaf_scan(tbl_ref, ls, trip, carry, tri_test)

    return _traverse_bvh(
        bvhf_ref, bvhi_ref, t_min, ox, oy, oz, dx, dy, dz, carry, leaf_scan
    )


def _sphere_root(scene_ref, j, a, inv_a, od, oo, ox, oy, oz, dx, dy, dz, t_min, tb):
    """Shrinking-window sphere test for scene column j (wgsl:167-221 root
    selection incl. the far-root fallback).  Returns (cx, cy, cz, root,
    better) — the ONE copy of the quadratic; closest-hit and the t-only
    shadow scan both build on it so the root semantics cannot drift."""
    cx = scene_ref[_CX, j]
    cy = scene_ref[_CY, j]
    cz = scene_ref[_CZ, j]
    c2r2 = scene_ref[_C2R2, j]
    active = scene_ref[_ACTIVE, j]
    h = cx * dx + cy * dy + cz * dz - od  # dot(center-origin, d)
    cc = c2r2 - 2.0 * (cx * ox + cy * oy + cz * oz) + oo
    disc = h * h - a * cc
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    rn = (h - sq) * inv_a
    rf = (h + sq) * inv_a
    # Shrinking window: tb is the current closest (wgsl:167,174).
    nok = (rn > t_min) & (rn < tb)
    fok = (rf > t_min) & (rf < tb)
    root = jnp.where(nok, rn, rf)
    better = (disc >= 0.0) & (nok | fok) & (active > 0.0)
    return cx, cy, cz, root, better


def _occluded(
    scene_ref, n_spheres, t_min, ox, oy, oz, dx, dy, dz, window,
    mesh_refs=None, sphere_bvh_refs=None,
):
    """Any-hit occlusion query: blocked mask for per-lane shadow rays.

    `window` is each lane's search-interval end — the NEE light distance,
    pre-shrunk by the caller, and ZERO for lanes whose NEE sample is
    already invalid for scan-independent reasons (non-diffuse hit, facing
    away, inside the light).  The carry is the remaining window: finding
    ANY primitive inside (t_min, window) collapses it to 0, which both
    marks the lane blocked and prunes it from every later node and
    primitive test (the `t < tb` window check fails at tb=0).  When every
    lane's window is closed the BVH walk drains through miss links in
    O(depth) steps — distance-bounded, any-hit, early-exiting, with no
    extra control flow.

    vs a closest-hit shadow scan: no true-
    nearest bookkeeping, nodes beyond the light are never entered, invalid
    lanes never drive traversal, and the first blocker retires a lane.
    Estimator-invariant: NEE validity consumed only the boolean
    `nearest < light distance`, which equals `any hit < light distance`.
    """
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz

    def sphere_body(j, tb):
        _, _, _, _, better = _sphere_root(
            scene_ref, j, a, inv_a, od, oo, ox, oy, oz, dx, dy, dz, t_min, tb
        )
        return jnp.where(better, jnp.float32(0.0), tb)

    if sphere_bvh_refs is None:
        tb = jax.lax.fori_loop(0, n_spheres, sphere_body, window)
    else:
        def leaf_scan_s(ls, trip, carry):
            tb = jax.lax.fori_loop(0, trip, lambda k, t: sphere_body(ls + k, t), carry[0])
            return (tb,)

        (tb,) = _traverse_bvh(
            sphere_bvh_refs[0], sphere_bvh_refs[1], t_min,
            ox, oy, oz, dx, dy, dz, (window,), leaf_scan_s,
        )

    if mesh_refs is not None:
        tbl_ref, bvhf_ref, bvhi_ref = mesh_refs

        def tri_test(at, carry):
            (tb,) = carry
            _, _, _, better = _tri_intersect(
                at, ox, oy, oz, dx, dy, dz, t_min, tb
            )
            return (jnp.where(better, jnp.float32(0.0), tb),)

        def leaf_scan_m(ls, trip, carry):
            return _mesh_leaf_scan(tbl_ref, ls, trip, carry, tri_test)

        (tb,) = _traverse_bvh(
            bvhf_ref, bvhi_ref, t_min, ox, oy, oz, dx, dy, dz, (tb,),
            leaf_scan_m,
        )

    return tb < window


def _closest_hit(
    scene_ref, n_spheres, t_min, t_max, ox, oy, oz, dx, dy, dz,
    mesh_refs=None,
    sphere_bvh_refs=None,
    mesh_smooth: bool = False,
    live_f=None,
    want_light_id: bool = False,
):
    """Vectorized shrinking-window sphere scan (wgsl:164-221), plus the
    block-coherent mesh BVH traversal when `mesh_refs` is given.

    `live_f` (f32 mask plane, optional): DEAD lanes get an empty closest-
    hit window (tb = t_min), so their stale rays are excluded from every
    BVH descent decision and primitive window test — a block's traversal
    unions only its LIVE lanes' subtrees.  Without this, a deep-bounce
    block with one live lane re-walked whatever its dead lanes last
    looked at.  Dead lanes' returned planes (including `hit`, which reads
    True at the unmoved tb = t_min) are garbage by contract: every
    consumer masks by `live`, which `_path_bounce` always did.  Live
    lanes' results are bitwise unchanged — a node a live lane's window
    overlaps is entered either way, and a skipped leaf can only contain
    candidates at t >= that lane's window.

    Returns (t, hit, px, py, pz, nx, ny, nz (face normal), front, alr, alg,
    alb, kind, param) as pixel-block planes; `want_light_id=True` (MIS)
    appends the winning primitive's NEE light index (scene _LIGHTID row;
    -1 for non-lights and mesh wins) as a 15th plane.
    """
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz

    big = jnp.float32(t_max)
    t0 = jnp.full(ox.shape, big, jnp.float32)
    if live_f is not None:
        t0 = jnp.where(live_f > 0.5, t0, jnp.float32(t_min))
    zero = jnp.zeros(ox.shape, jnp.float32)

    def body(j, carry):
        if want_light_id:
            tb, cxp, cyp, czp, rp, ar, ag, ab, kp, pp, lidp = carry
        else:
            tb, cxp, cyp, czp, rp, ar, ag, ab, kp, pp = carry
        cx, cy, cz, root, better = _sphere_root(
            scene_ref, j, a, inv_a, od, oo, ox, oy, oz, dx, dy, dz, t_min, tb
        )

        tb = jnp.where(better, root, tb)
        cxp = jnp.where(better, cx, cxp)
        cyp = jnp.where(better, cy, cyp)
        czp = jnp.where(better, cz, czp)
        rp = jnp.where(better, scene_ref[_RAD, j], rp)
        ar = jnp.where(better, scene_ref[_ALR, j], ar)
        ag = jnp.where(better, scene_ref[_ALG, j], ag)
        ab = jnp.where(better, scene_ref[_ALB, j], ab)
        kp = jnp.where(better, scene_ref[_KIND, j], kp)
        pp = jnp.where(better, scene_ref[_PARAM, j], pp)
        if want_light_id:
            lidp = jnp.where(better, scene_ref[_LIGHTID, j], lidp)
            return tb, cxp, cyp, czp, rp, ar, ag, ab, kp, pp, lidp
        return tb, cxp, cyp, czp, rp, ar, ag, ab, kp, pp

    init = (t0, zero, zero, zero, zero, zero, zero, zero, zero, zero)
    if want_light_id:
        init = init + (jnp.full(ox.shape, -1.0, jnp.float32),)
    if sphere_bvh_refs is None:
        carry10 = jax.lax.fori_loop(0, n_spheres, body, init)
    else:
        # Sphere BVH: same block-coherent traversal, leaf scan = the sphere
        # body over the leaf's contiguous range.
        def leaf_scan(ls, trip, carry):
            return jax.lax.fori_loop(0, trip, lambda k, c: body(ls + k, c), carry)

        carry10 = _traverse_bvh(
            sphere_bvh_refs[0], sphere_bvh_refs[1], t_min,
            ox, oy, oz, dx, dy, dz, init, leaf_scan,
        )
    if want_light_id:
        tb, cxp, cyp, czp, rp, ar, ag, ab, kp, pp, lidp = carry10
    else:
        tb, cxp, cyp, czp, rp, ar, ag, ab, kp, pp = carry10

    # Sphere OUTWARD normals at the sphere-stage t (valid wherever a sphere
    # currently holds the window; mesh hits below overwrite closer lanes).
    ts = jnp.where(tb < big, tb, 1.0)
    inv_r = 1.0 / jnp.where(rp != 0.0, rp, 1.0)
    nx = (ox + ts * dx - cxp) * inv_r
    ny = (oy + ts * dy - cyp) * inv_r
    nz = (oz + ts * dz - czp) * inv_r

    if mesh_refs is not None:
        mesh_carry = (tb, nx, ny, nz, ar, ag, ab, kp, pp)
        if want_light_id:
            mesh_carry = mesh_carry + (lidp,)
        mesh_carry = _traverse_mesh(
            *mesh_refs, t_min, ox, oy, oz, dx, dy, dz, mesh_carry,
            smooth=mesh_smooth,
        )
        if want_light_id:
            tb, nx, ny, nz, ar, ag, ab, kp, pp, lidp = mesh_carry
        else:
            tb, nx, ny, nz, ar, ag, ab, kp, pp = mesh_carry
        if mesh_smooth:
            # Interpolated normals fold unnormalized; one renormalize here
            # replaces a per-candidate one (identity for sphere-won lanes,
            # whose normals are already unit).
            nx, ny, nz = _normalize3(nx, ny, nz)

    hit = tb < big
    t = jnp.where(hit, tb, 1.0)  # benign t for misses (no 1e35 overflow)
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    front = dx * nx + dy * ny + dz * nz < 0.0  # (wgsl:159)
    sign = jnp.where(front, 1.0, -1.0)
    nx, ny, nz = nx * sign, ny * sign, nz * sign  # flip toward ray (wgsl:160)
    out = (t, hit, px, py, pz, nx, ny, nz, front, ar, ag, ab, kp, pp)
    if want_light_id:
        out = out + (lidp,)
    return out


def _sky(dx, dy, dz):
    """Vertical white->blue gradient (wgsl:293-296)."""
    inv_len = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
    a = 0.5 * (dy * inv_len + 1.0)
    return 1.0 - 0.5 * a, 1.0 - 0.3 * a, jnp.ones_like(a)  # lerp to (.5,.7,1)


def _normalize3(x, y, z):
    inv = jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, 1e-20))
    return x * inv, y * inv, z * inv


def _uniform(seeds, salt):
    return rng_ops.uniform_hash(seeds, salt)


def _scatter(
    dx, dy, dz, nx, ny, nz, front, ar, ag, ab, kp, pp, seeds, salt_base,
    *, pid=None, s_u32=None, frame_seed_u32=None, i_b=None,
    sampler_spec=None,
):
    """Branchless three-material scatter on component planes (wgsl:84-141).

    Draw-for-draw identical to ops/materials.scatter under the hash stream.
    With `sampler_spec` (the stratified/sobol sampler), bounce 0's (u1, u2)
    become the sampler's points for the salt-6 pair — identical to the jax
    path's first-bounce remap in ops/integrators.trace_path.
    Returns (sx, sy, sz, attr, attg, attb, ok).
    """
    # Shared random unit vector (salts match ops/integrators.trace_path).
    u1 = _uniform(seeds, salt_base)
    u2 = _uniform(seeds, salt_base + jnp.uint32(1))
    u_reflect = _uniform(seeds, salt_base + jnp.uint32(2))
    if sampler_spec is not None:
        su1, su2 = rng_ops.sampler_uniforms(
            u1, u2, pid, s_u32, frame_seed_u32, sampler_spec,
            rot_salt=rng_ops._SCATTER_ROT_SALT,
        )
        # i_b is a scalar (megakernel / plain wavefront) or a per-lane i32
        # plane (the regenerating pool); either broadcasts against the
        # uniform planes.
        first = jnp.asarray(i_b, jnp.int32) == 0
        u1 = jnp.where(first, su1, u1)
        u2 = jnp.where(first, su2, u2)
    z = 2.0 * u1 - 1.0
    ang = u2 * jnp.float32(2.0 * jnp.pi)
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    ux, uy, uz = r * jnp.cos(ang), r * jnp.sin(ang), z

    # lambertian (wgsl:84-93)
    lx, ly, lz = nx + ux, ny + uy, nz + uz
    degen = lx * lx + ly * ly + lz * lz < 1e-6
    lx = jnp.where(degen, nx, lx)
    ly = jnp.where(degen, ny, ly)
    lz = jnp.where(degen, nz, lz)

    # metal (wgsl:95-100)
    rx, ry, rz = _normalize3(*_reflect(dx, dy, dz, nx, ny, nz))
    rx, ry, rz = rx + pp * ux, ry + pp * uy, rz + pp * uz
    mx, my, mz = _normalize3(rx, ry, rz)
    metal_ok = rx * nx + ry * ny + rz * nz > 0.0

    # dielectric (wgsl:102-135); pp is ior on dielectric lanes
    ior = jnp.where(kp > 1.5, pp, 1.5)
    eta = jnp.where(front, 1.0 / ior, ior)
    udx, udy, udz = _normalize3(dx, dy, dz)
    cos_t = jnp.minimum(-(udx * nx + udy * ny + udz * nz), 1.0)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    cannot = eta * sin_t > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    # pow(1-cos, 5) via squarings (wgsl:140)
    om = 1.0 - cos_t
    om2 = om * om
    schlick = r0 + (1.0 - r0) * (om2 * om2 * om)
    refl_p = cannot | (schlick > u_reflect)
    # refract (book formulation; equals WGSL refract off-TIR)
    rpx = eta * (udx + cos_t * nx)
    rpy = eta * (udy + cos_t * ny)
    rpz = eta * (udz + cos_t * nz)
    k = jnp.maximum(1.0 - (rpx * rpx + rpy * rpy + rpz * rpz), 0.0)
    sk = jnp.sqrt(k)
    fx, fy, fz = rpx - sk * nx, rpy - sk * ny, rpz - sk * nz
    ex, ey, ez = _reflect(udx, udy, udz, nx, ny, nz)
    gx = jnp.where(refl_p, ex, fx)
    gy = jnp.where(refl_p, ey, fy)
    gz = jnp.where(refl_p, ez, fz)
    gx, gy, gz = _normalize3(gx, gy, gz)

    # select by kind: 0 lambertian, 1 metal, 2 dielectric
    is_lam = kp < 0.5
    is_metal = (kp >= 0.5) & (kp < 1.5)
    sx = jnp.where(is_lam, lx, jnp.where(is_metal, mx, gx))
    sy = jnp.where(is_lam, ly, jnp.where(is_metal, my, gy))
    sz = jnp.where(is_lam, lz, jnp.where(is_metal, mz, gz))
    is_diel = kp >= 1.5
    attr = jnp.where(is_diel, 1.0, ar)
    attg = jnp.where(is_diel, 1.0, ag)
    attb = jnp.where(is_diel, 1.0, ab)
    ok = (~is_metal) | metal_ok
    return sx, sy, sz, attr, attg, attb, ok


def _reflect(dx, dy, dz, nx, ny, nz):
    dn = dx * nx + dy * ny + dz * nz
    return dx - 2.0 * dn * nx, dy - 2.0 * dn * ny, dz - 2.0 * dn * nz


def _path_bounce(
    i_b,
    carry,
    *,
    seeds,
    scene_ref,
    lights_ref,
    mesh_refs,
    sphere_bvh_refs,
    pick_seed,
    n_spheres,
    t_min,
    t_max,
    mesh_smooth,
    sky_intensity,
    num_lights,
    rr_depth,
    tri_lights_ref=None,
    num_tri_lights=0,
    pid=None,
    s_u32=None,
    frame_seed_u32=None,
    sampler_spec=None,
    mis: bool = False,
    max_depth: int = 0,  # only read under mis (last-bounce NEE exemption)
    count_rays: bool = False,
):
    """One path-tracing bounce over a block of lanes.

    `count_rays=True` appends ONE extra output plane (after everything
    else, so indices stay stable): the number of rays this bounce actually
    traced per lane — 1 for a live closest-hit walk plus 1 per NEE shadow
    ray whose occlusion walk was genuinely driven (`prevalid`; inert lanes
    cost nothing by construction, see _occluded).  Statically gated: the
    count_rays=False program is byte-identical to before.

    The shared physics of the megakernel and the wavefront kernel: closest
    hit, BSDF scatter, sky/emissive accumulation, optional NEE, optional
    Russian roulette.  `carry` is the 14-plane ray state
    (o.xyz, d.xyz, throughput.rgb, radiance.rgb, live_f, prev_diffuse_f);
    all RNG draws are functions of (per-PIXEL seeds, bounce salt), so the
    stream is identical no matter how rays are tiled or compacted.
    `pick_seed` drives the >4-lights NEE pick; it must be a function of
    (sample, frame seed) ONLY — never of tile/program ids — so the pick is
    identical across the megakernel, the wavefront engine (whose tiles are
    compacted ray groups, not image tiles), and any row sharding.

    `i_b` (and `pick_seed`) may be scalars — the megakernel / plain
    wavefront case, where every lane in a launch is at the same bounce — or
    per-lane block arrays — the regenerating wavefront engine, where a
    tile mixes rays at different (sample, bounce).  Every consumer of the
    bounce index (salts, RR gate, light pick) is elementwise, so both give
    each ray the identical stream.
    """
    # live/prev-diffuse are carried as f32 masks.  With MIS the
    # carry gains ONE plane (appended last, so indices are stable): pc_f =
    # cos(scatter dir, normal) at the previous diffuse vertex, whose BSDF
    # pdf the emission weight needs.
    if mis:
        (ox, oy, oz, dx, dy, dz, tr, tg, tb_, rr, rg, rb, live_f, pd_f,
         pc_f) = carry
    else:
        (ox, oy, oz, dx, dy, dz, tr, tg, tb_, rr, rg, rb, live_f, pd_f) = carry
    live = live_f > 0.5
    prev_diffuse = pd_f > 0.5
    ch = _closest_hit(
        scene_ref, n_spheres, t_min, t_max, ox, oy, oz, dx, dy, dz,
        mesh_refs=mesh_refs, sphere_bvh_refs=sphere_bvh_refs,
        mesh_smooth=mesh_smooth, live_f=live_f, want_light_id=mis,
    )
    (_, hit, px, py, pz, nx, ny, nz, front, ar, ag, ab, kp, pp) = ch[:14]
    lidp = ch[14] if mis else None
    # Rays traced this bounce: the closest-hit walk for each live lane;
    # NEE shadow rays append below as their walks are issued.
    rays_cast = (live_f > 0.5).astype(jnp.float32) if count_rays else None
    salt_base = jnp.uint32(16) + jnp.uint32(3) * jnp.asarray(i_b, jnp.uint32)
    sx, sy, sz, attr, attg, attb, ok = _scatter(
        dx, dy, dz, nx, ny, nz, front, ar, ag, ab, kp, pp, seeds, salt_base,
        pid=pid, s_u32=s_u32, frame_seed_u32=frame_seed_u32, i_b=i_b,
        sampler_spec=sampler_spec,
    )

    missed = live & ~hit
    skr, skg, skb = _sky(dx, dy, dz)
    sky_s = jnp.float32(sky_intensity)
    rr = jnp.where(missed, rr + tr * skr * sky_s, rr)
    rg = jnp.where(missed, rg + tg * skg * sky_s, rg)
    rb = jnp.where(missed, rb + tb_ * skb * sky_s, rb)

    # Emissive surfaces radiate albedo * param and end the path.  Under
    # NEE a BSDF ray from a diffuse surface must not re-count emission —
    # unless MIS is on, where it counts at the power-heuristic weight
    # against the same vertex's NEE cone sample instead (matches
    # ops/integrators.trace_path; w_b = 1 / (1 + r^2),
    # r = 1 / (2 (1 - cos_max) prev_cos), cone width from the prev vertex
    # = the ray origin).
    is_emis = kp >= 2.5
    emis = live & hit & is_emis
    w_emis = 1.0
    total_lights = num_lights + num_tri_lights
    if total_lights > 0 and mis:
        # Exact light identity from the closest-hit's light-id plane
        # (scene _LIGHTID row for sphere wins, triangle-table _TLID slot
        # for mesh wins; replaces the r3 geometric tolerance, which could
        # mis-match near-concentric/shell-adjacent lights and silently
        # break the power heuristic's sum-to-1 property).  r_ratio =
        # p_nee / p_b per lane.
        one_minus_cm = jnp.zeros_like(pc_f)
        for l_mis in range(num_lights):
            lcx = lights_ref[0, l_mis]
            lcy = lights_ref[1, l_mis]
            lcz = lights_ref[2, l_mis]
            lr = lights_ref[3, l_mis]
            is_l = jnp.abs(lidp - jnp.float32(l_mis)) < 0.5
            dox, doy, doz = ox - lcx, oy - lcy, oz - lcz
            d2o = jnp.maximum(dox * dox + doy * doy + doz * doz, 1e-12)
            one_minus_cm = jnp.where(
                is_l, _one_minus_cos_max(lr * lr, d2o), one_minus_cm
            )
        r_ratio = 1.0 / jnp.maximum(2.0 * one_minus_cm * pc_f, 1e-12)
        if num_tri_lights > 0:
            # Triangle lights: p_nee = d^3/(|n_l . delta| * area) with
            # delta = hit point - prev vertex (pure point arithmetic, no
            # direction normalization), p_b = prev_cos/pi ->
            # r = pi d^3 / (|n_l . delta| * area * prev_cos).  Matches
            # ops/integrators.trace_path.
            dhx, dhy, dhz = px - ox, py - oy, pz - oz
            d2h = jnp.maximum(dhx * dhx + dhy * dhy + dhz * dhz, 1e-12)
            d3h = d2h * jnp.sqrt(d2h)
            for j_mis in range(num_tri_lights):
                g = num_lights + j_mis
                tnx = tri_lights_ref[9, j_mis]
                tny = tri_lights_ref[10, j_mis]
                tnz = tri_lights_ref[11, j_mis]
                t_area = tri_lights_ref[12, j_mis]
                ndot = jnp.abs(dhx * tnx + dhy * tny + dhz * tnz)
                r_tri = (jnp.float32(jnp.pi) * d3h) / jnp.maximum(
                    ndot * t_area * pc_f, 1e-12
                )
                is_l = jnp.abs(lidp - jnp.float32(g)) < 0.5
                r_ratio = jnp.where(is_l, r_tri, r_ratio)
        if total_lights > 4:
            # Picked-light NEE (> 4 lights): each light is sampled with
            # pdf/total, so the BSDF ray's competing NEE density shrinks by
            # the pick probability; the NEE side scales its ratio by total
            # symmetrically.  Matches trace_path (exact division, not a
            # rounded reciprocal, so the weight pair sums to 1 exactly).
            r_ratio = r_ratio / jnp.float32(total_lights)
        # Every emissive hit carries a light id by construction (active
        # emissive spheres and non-degenerate emissive faces ARE the light
        # list); the exclusion branch is a defensive never-double-count
        # fallback, not a tolerance gap.
        w_emis = jnp.where(
            prev_diffuse,
            jnp.where(lidp > -0.5, 1.0 / (1.0 + r_ratio * r_ratio), 0.0),
            1.0,
        )
    elif total_lights > 0:
        emis = emis & ~prev_diffuse
    rr = jnp.where(emis, rr + tr * ar * (pp * w_emis), rr)
    rg = jnp.where(emis, rg + tg * ag * (pp * w_emis), rg)
    rb = jnp.where(emis, rb + tb_ * ab * (pp * w_emis), rb)

    if total_lights > 0:
        # Next-event estimation.  Light parameters are scalar loads shared
        # by the block, so for small light counts we loop over ALL lights (deterministic, lowest variance,
        # no tile artifacts); above the cap we pick ONE light per bounce
        # for the whole frame (unbiased; the xL factor cancels the pick
        # pdf).  The pick is a function of (sample, frame seed, bounce)
        # only — not of tile ids — so every engine/sharding draws it
        # identically; samples average the picks back out.  Triangle
        # lights extend the same ordinal/salt space after the sphere
        # lights.
        i_u = jnp.asarray(i_b, jnp.uint32)
        is_lam = kp < 0.5
        # Shading points inside any light's radius fall back to BSDF
        # sampling (matches ops/integrators.py; avoids the dark ring
        # around embedded lights).
        # Checked over ALL lights in every branch (scalar loads are
        # cheap): a point inside a light whose NEE sample is invalidated
        # while its BSDF-hit emission is suppressed via prev_diffuse
        # would otherwise lose that light entirely (matches
        # ops/integrators.py, which guards for any light count).
        inside_any = jnp.zeros(live.shape, dtype=bool)
        for l_chk in range(num_lights):
            dxc = lights_ref[0, l_chk] - px
            dyc = lights_ref[1, l_chk] - py
            dzc = lights_ref[2, l_chk] - pz
            r_chk = lights_ref[3, l_chk]
            inside_any = inside_any | (
                dxc * dxc + dyc * dyc + dzc * dzc <= r_chk * r_chk * 1.0001
            )
        nee_base = live & hit & is_lam & ~inside_any
        rays_box = [rays_cast]  # shadow-ray counts fold in per light term

        def _sphere_cand(lcx, lcy, lcz, lrad, u1n, u2n):
            """Cone-sample candidate toward a sphere light: returns
            (omx, omy, omz, t_l, prevalid, wgt0), where wgt0 = cos_i *
            2(1-cos_max) is both the estimator weight and the MIS
            p_b/p_nee ratio.  ONE copy of the cone math, shared by the
            <= 4 loop, the sphere pick, and the combined pick."""
            dcx, dcy, dcz = lcx - px, lcy - py, lcz - pz
            d2 = dcx * dcx + dcy * dcy + dcz * dcz
            d2s = jnp.maximum(d2, 1e-12)
            inv_dl = jax.lax.rsqrt(d2s)
            wlx, wly, wlz = dcx * inv_dl, dcy * inv_dl, dcz * inv_dl
            omc = _one_minus_cos_max(lrad * lrad, d2s)
            cos_t = 1.0 - u1n * omc
            sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
            phi = u2n * jnp.float32(2.0 * jnp.pi)
            # Orthonormal basis around wl; cross(a, wl), a = (axx, axy, 0).
            pickx = jnp.abs(wlx) > 0.9
            axx = jnp.where(pickx, 0.0, 1.0)
            axy = jnp.where(pickx, 1.0, 0.0)
            uax = axy * wlz
            uay = -axx * wlz
            uaz = axx * wly - axy * wlx
            uinv = jax.lax.rsqrt(jnp.maximum(uax * uax + uay * uay + uaz * uaz, 1e-12))
            uax, uay, uaz = uax * uinv, uay * uinv, uaz * uinv
            vax = wly * uaz - wlz * uay
            vay = wlz * uax - wlx * uaz
            vaz = wlx * uay - wly * uax
            cp, sp = jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t
            omx = uax * cp + vax * sp + wlx * cos_t
            omy = uay * cp + vay * sp + wly * cos_t
            omz = uaz * cp + vaz * sp + wlz * cos_t
            cos_i = nx * omx + ny * omy + nz * omz
            h_l = dcx * omx + dcy * omy + dcz * omz
            disc_l = h_l * h_l - (d2 - lrad * lrad)
            t_l = h_l - jnp.sqrt(jnp.maximum(disc_l, 0.0))
            inside = d2 <= lrad * lrad * 1.0001
            prevalid = nee_base & (cos_i > 0.0) & ~inside & (disc_l > 0.0)
            wgt0 = cos_i * 2.0 * omc
            return omx, omy, omz, t_l, prevalid, wgt0

        def light_contribution(li, pick_weight, salt_off, rr, rg, rb,
                               rot_salt=None):
            if jnp.ndim(li) == 0:
                # Scalar pick: a dynamic scalar load per parameter.
                lcx, lcy, lcz = lights_ref[0, li], lights_ref[1, li], lights_ref[2, li]
                lrad = lights_ref[3, li]
                ler, leg, leb = lights_ref[4, li], lights_ref[5, li], lights_ref[6, li]
            else:
                # Per-LANE pick (the regeneration engine, where sample/bounce
                # vary per lane so the >4-lights pick does too): select the
                # picked light's parameters by masked accumulation over all
                # lights — num_lights scalar loads plus vector selects.
                # The picked INDEX per (sample, bounce) is the same value the
                # scalar path computes, so the estimator is engine-invariant.
                sel = [jnp.zeros(li.shape, jnp.float32) for _ in range(7)]
                for l_s in range(num_lights):
                    m = li == l_s
                    for k_s in range(7):
                        sel[k_s] = jnp.where(m, lights_ref[k_s, l_s], sel[k_s])
                lcx, lcy, lcz, lrad, ler, leg, leb = sel

            # Salt layout 2000 + 37*bounce + 7*light + {1,2}: collision-
            # free across (bounce, light, channel); matches the jax path.
            salt2 = jnp.uint32(2000) + jnp.uint32(37) * i_u + jnp.uint32(salt_off)
            u1n = _uniform(seeds, salt2 + jnp.uint32(1))
            u2n = _uniform(seeds, salt2 + jnp.uint32(2))
            if sampler_spec is not None and rot_salt is not None:
                # First-bounce NEE cone sample (<= 4-light loop only;
                # rot_salt is per light) — matches trace_path.
                sn1, sn2 = rng_ops.sampler_uniforms(
                    u1n, u2n, pid, s_u32, frame_seed_u32, sampler_spec,
                    rot_salt=rot_salt,
                )
                first_b = jnp.asarray(i_b, jnp.int32) == 0
                u1n = jnp.where(first_b, sn1, u1n)
                u2n = jnp.where(first_b, sn2, u2n)

            omx, omy, omz, t_l, prevalid, wgt0 = _sphere_cand(
                lcx, lcy, lcz, lrad, u1n, u2n
            )
            # Every scan-independent validity term is known BEFORE the
            # shadow scan; folding them into the occlusion window (0 =
            # lane inert) means only genuinely samplable lambertian lanes
            # drive the any-hit walk — metal/glass/miss lanes cost nothing.
            if count_rays:
                # One shadow ray per lane whose occlusion walk is driven.
                rays_box[0] = rays_box[0] + prevalid.astype(jnp.float32)
            win = jnp.where(
                prevalid, jnp.maximum(t_l, 0.0) * (1.0 - 1e-3), 0.0
            )
            blocked = _occluded(
                scene_ref, n_spheres, t_min, px, py, pz, omx, omy, omz, win,
                mesh_refs=mesh_refs, sphere_bvh_refs=sphere_bvh_refs,
            )
            valid = prevalid & ~blocked
            wgt = wgt0 * jnp.float32(pick_weight)
            if mis:
                # w_nee = p_nee^2 / (p_nee^2 + p_b^2) = 1 / (1 + r^2) with
                # r = p_b/p_nee = the fully-scaled estimator weight:
                # 2 cos_i (1 - cos_max) in the deterministic loop
                # (pick_weight 1), times the light count under the picked-
                # light estimator (the 1/L pick pdf shrinks p_nee too).
                # Matches the BSDF-hit weight above so the pair sums to 1
                # per light identity.  The LAST bounce keeps w_nee = 1: its
                # BSDF counterpart is never traced (depth-truncation bias
                # otherwise); matches trace_path.
                ratio = wgt
                last = jnp.asarray(i_b, jnp.int32) == max_depth - 1
                wgt = jnp.where(last, wgt, wgt / (1.0 + ratio * ratio))
            rr = jnp.where(valid, rr + tr * ar * (ler * wgt), rr)
            rg = jnp.where(valid, rg + tg * ag * (leg * wgt), rg)
            rb = jnp.where(valid, rb + tb_ * ab * (leb * wgt), rb)
            return rr, rg, rb

        def _tri_cand(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
                      tnx, tny, tnz, t_area, u1n, u2n):
            """Uniform-area candidate toward an emissive triangle:
            returns (omx, omy, omz, dist, prevalid, wgt0), where wgt0 =
            cos_i * cos_l * area / (pi d^2) is both the estimator weight
            and the MIS p_b/p_nee ratio.  Two-sided (|cos_l|).  ONE copy
            of the area math, shared by the <= 4 loop and the combined
            pick; matches trace_path's _nee_tri_term arithmetic."""
            su = jnp.sqrt(u1n)
            b1 = 1.0 - su
            b2 = u2n * su
            lpx = v0x + b1 * e1x + b2 * e2x
            lpy = v0y + b1 * e1y + b2 * e2y
            lpz = v0z + b1 * e1z + b2 * e2z
            dcx, dcy, dcz = lpx - px, lpy - py, lpz - pz
            d2 = dcx * dcx + dcy * dcy + dcz * dcz
            d2s = jnp.maximum(d2, 1e-12)
            inv_dl = jax.lax.rsqrt(d2s)
            dist = d2s * inv_dl  # = sqrt(d2s)
            omx, omy, omz = dcx * inv_dl, dcy * inv_dl, dcz * inv_dl
            cos_i = nx * omx + ny * omy + nz * omz
            cos_l = jnp.abs(tnx * omx + tny * omy + tnz * omz)
            prevalid = (
                nee_base & (cos_i > 0.0) & (cos_l > 1e-7) & (d2 > 1e-12)
            )
            wgt0 = cos_i * cos_l * t_area / (jnp.float32(jnp.pi) * d2s)
            return omx, omy, omz, dist, prevalid, wgt0

        def _tri_params(j):
            """The 16 scalars of triangle light j (static or traced)."""
            return tuple(tri_lights_ref[k, j] for k in range(16))

        def tri_light_contribution(j, rr, rg, rb):
            """Triangle-light NEE: uniform-area sample on emissive face j
            (STATIC — all parameters are scalar loads), area-to-solid-
            angle pdf.  contribution = Le * albedo * cos_i * cos_l * area
            / (pi d^2).  Matches trace_path's _nee_tri_term salts."""
            g = num_lights + j  # global ordinal -> salt/rotation ids
            salt2 = jnp.uint32(2000) + jnp.uint32(37) * i_u + jnp.uint32(7 * g)
            u1n = _uniform(seeds, salt2 + jnp.uint32(1))
            u2n = _uniform(seeds, salt2 + jnp.uint32(2))
            if sampler_spec is not None:
                sn1, sn2 = rng_ops.sampler_uniforms(
                    u1n, u2n, pid, s_u32, frame_seed_u32, sampler_spec,
                    rot_salt=rng_ops._NEE_ROT_SALT_BASE + g,
                )
                first_b = jnp.asarray(i_b, jnp.int32) == 0
                u1n = jnp.where(first_b, sn1, u1n)
                u2n = jnp.where(first_b, sn2, u2n)

            p = _tri_params(j)
            ler, leg, leb = p[13], p[14], p[15]
            omx, omy, omz, dist, prevalid, wgt0 = _tri_cand(
                *p[:13], u1n, u2n
            )
            if count_rays:
                rays_box[0] = rays_box[0] + prevalid.astype(jnp.float32)
            # The sampled face itself sits at t == dist: the pre-shrunk
            # window excludes it, so only genuine blockers close a lane
            # (same 1e-3 relative slack as the sphere term).
            win = jnp.where(prevalid, dist * (1.0 - 1e-3), 0.0)
            blocked = _occluded(
                scene_ref, n_spheres, t_min, px, py, pz, omx, omy, omz, win,
                mesh_refs=mesh_refs, sphere_bvh_refs=sphere_bvh_refs,
            )
            valid = prevalid & ~blocked
            wgt = wgt0
            if mis:
                # ratio = p_b / p_nee == wgt0; last bounce keeps weight 1
                # (no BSDF counterpart is traced).  Matches trace_path.
                ratio = wgt0
                last = jnp.asarray(i_b, jnp.int32) == max_depth - 1
                wgt = jnp.where(last, wgt, wgt / (1.0 + ratio * ratio))
            rr = jnp.where(valid, rr + tr * ar * (ler * wgt), rr)
            rg = jnp.where(valid, rg + tg * ag * (leg * wgt), rg)
            rb = jnp.where(valid, rb + tb_ * ab * (leb * wgt), rb)
            return rr, rg, rb

        def combined_pick_contribution(g, rr, rg, rb):
            """> 4 total lights with triangle lights present: ONE picked
            ordinal from the combined space (weight = total cancels the
            uniform pick pdf).  Both candidates are built and lane-selected
            BEFORE the single occlusion walk — the walk dominates the cost.
            Scalar g (one-shot/wavefront) = dynamic scalar loads;
            per-lane g (the regeneration engine) = masked accumulation over
            all lights.
            Under mis=True the power-heuristic ratio is the same scaled
            weight (the pick pdf shrinks p_nee by 1/total, growing
            p_b/p_nee by total), mirroring the BSDF side's 1/total."""
            total = num_lights + num_tri_lights
            salt2 = jnp.uint32(2000) + jnp.uint32(37) * i_u
            u1n = _uniform(seeds, salt2 + jnp.uint32(1))
            u2n = _uniform(seeds, salt2 + jnp.uint32(2))
            per_lane = jnp.ndim(g) > 0
            zero = jnp.zeros(live.shape, jnp.float32)
            false_ = jnp.zeros(live.shape, dtype=bool)

            if num_lights > 0:
                if per_lane:
                    sel = [jnp.zeros(g.shape, jnp.float32) for _ in range(7)]
                    for l_s in range(num_lights):
                        m = g == l_s
                        for k_s in range(7):
                            sel[k_s] = jnp.where(m, lights_ref[k_s, l_s], sel[k_s])
                    lcx, lcy, lcz, lrad, sler, sleg, sleb = sel
                else:
                    ls = jnp.minimum(g, num_lights - 1)
                    lcx, lcy, lcz = (lights_ref[0, ls], lights_ref[1, ls],
                                     lights_ref[2, ls])
                    lrad = lights_ref[3, ls]
                    sler, sleg, sleb = (lights_ref[4, ls], lights_ref[5, ls],
                                        lights_ref[6, ls])
                s_omx, s_omy, s_omz, s_tl, s_pre, s_w = _sphere_cand(
                    lcx, lcy, lcz, lrad, u1n, u2n
                )
            else:
                s_omx = s_omy = s_omz = s_tl = s_w = zero
                s_pre, sler, sleg, sleb = false_, zero, zero, zero

            if per_lane:
                tp = [jnp.zeros(g.shape, jnp.float32) for _ in range(16)]
                for j_s in range(num_tri_lights):
                    m = g == num_lights + j_s
                    for k_s in range(16):
                        tp[k_s] = jnp.where(m, tri_lights_ref[k_s, j_s], tp[k_s])
            else:
                jt = jnp.clip(g - num_lights, 0, num_tri_lights - 1)
                tp = _tri_params(jt)
            tler, tleg, tleb = tp[13], tp[14], tp[15]
            t_omx, t_omy, t_omz, t_dist, t_pre, t_w = _tri_cand(
                *tp[:13], u1n, u2n
            )

            is_sph = g < num_lights
            omx = jnp.where(is_sph, s_omx, t_omx)
            omy = jnp.where(is_sph, s_omy, t_omy)
            omz = jnp.where(is_sph, s_omz, t_omz)
            maxt = jnp.where(is_sph, jnp.maximum(s_tl, 0.0), t_dist)
            prevalid = (is_sph & s_pre) | (~is_sph & t_pre)
            wgt0 = jnp.where(is_sph, s_w, t_w)
            ler = jnp.where(is_sph, sler, tler)
            leg = jnp.where(is_sph, sleg, tleg)
            leb = jnp.where(is_sph, sleb, tleb)
            if count_rays:
                rays_box[0] = rays_box[0] + prevalid.astype(jnp.float32)
            win = jnp.where(prevalid, maxt * (1.0 - 1e-3), 0.0)
            blocked = _occluded(
                scene_ref, n_spheres, t_min, px, py, pz, omx, omy, omz, win,
                mesh_refs=mesh_refs, sphere_bvh_refs=sphere_bvh_refs,
            )
            valid = prevalid & ~blocked
            wgt = wgt0 * jnp.float32(total)
            if mis:
                # Same form as light_contribution; last bounce keeps
                # weight 1 (no BSDF counterpart).  Matches trace_path.
                ratio = wgt
                last = jnp.asarray(i_b, jnp.int32) == max_depth - 1
                wgt = jnp.where(last, wgt, wgt / (1.0 + ratio * ratio))
            rr = jnp.where(valid, rr + tr * ar * (ler * wgt), rr)
            rg = jnp.where(valid, rg + tg * ag * (leg * wgt), rg)
            rb = jnp.where(valid, rb + tb_ * ab * (leb * wgt), rb)
            return rr, rg, rb

        # total <= 4 (== num_lights <= 4 for sphere-only scenes, so the
        # stream is unchanged there): deterministic loop over ALL lights,
        # both kinds.  Above 4, pick one ordinal per (sample, bounce) —
        # per LANE on the regeneration engine, where pick_seed/i_b vary
        # per lane.
        if total_lights <= 4:
            for l_static in range(num_lights):
                rr, rg, rb = light_contribution(
                    jnp.int32(l_static), 1.0, 7 * l_static, rr, rg, rb,
                    rot_salt=rng_ops._NEE_ROT_SALT_BASE + l_static,
                )
            for j_static in range(num_tri_lights):
                rr, rg, rb = tri_light_contribution(j_static, rr, rg, rb)
        elif num_tri_lights == 0:
            bounce_seed = rng_ops.hash2(pick_seed, jnp.uint32(3000) + i_u)
            li = (rng_ops.hash2(bounce_seed, 0) % jnp.uint32(num_lights)).astype(jnp.int32)
            rr, rg, rb = light_contribution(li, num_lights, 0, rr, rg, rb)
        else:
            bounce_seed = rng_ops.hash2(pick_seed, jnp.uint32(3000) + i_u)
            g = (rng_ops.hash2(bounce_seed, 0) % jnp.uint32(total_lights)).astype(jnp.int32)
            rr, rg, rb = combined_pick_contribution(g, rr, rg, rb)
        if count_rays:
            rays_cast = rays_box[0]

    scattered = live & hit & ok & ~is_emis
    if num_lights > 0:
        new_pd = scattered & (kp < 0.5) & ~inside_any
    else:
        new_pd = scattered & (kp < 0.5)
    if mis:
        # Lambertian scatter dir = normal + unit vector (unnormalized); its
        # cosine against the normal feeds the next bounce's w_b.
        sd2 = jnp.maximum(sx * sx + sy * sy + sz * sz, 1e-20)
        cos_s = (sx * nx + sy * ny + sz * nz) * jax.lax.rsqrt(sd2)
        pc_out = jnp.where(new_pd, jnp.maximum(cos_s, 0.0), 0.0)
    tr = jnp.where(scattered, tr * attr, tr)
    tg = jnp.where(scattered, tg * attg, tg)
    tb_ = jnp.where(scattered, tb_ * attb, tb_)
    ox = jnp.where(scattered, px, ox)
    oy = jnp.where(scattered, py, oy)
    oz = jnp.where(scattered, pz, oz)
    dx = jnp.where(scattered, sx, dx)
    dy = jnp.where(scattered, sy, dy)
    dz = jnp.where(scattered, sz, dz)
    live_out = scattered
    if rr_depth > 0:
        # Russian roulette (matches ops/integrators salt space 1000+i).
        u_rr = _uniform(seeds, jnp.uint32(1000) + jnp.asarray(i_b, jnp.uint32))
        pmax = jnp.clip(jnp.maximum(tr, jnp.maximum(tg, tb_)), 0.05, 1.0)
        apply_f = (i_b >= rr_depth).astype(jnp.float32)
        survive = (u_rr < pmax) | (apply_f < 0.5)
        inv_p = 1.0 + apply_f * (1.0 / pmax - 1.0)
        keep = live_out & survive
        tr = jnp.where(keep, tr * inv_p, tr)
        tg = jnp.where(keep, tg * inv_p, tg)
        tb_ = jnp.where(keep, tb_ * inv_p, tb_)
        live_out = keep
    out = (
        ox, oy, oz, dx, dy, dz, tr, tg, tb_, rr, rg, rb,
        live_out.astype(jnp.float32), new_pd.astype(jnp.float32),
    )
    if mis:
        out = out + (pc_out,)
    if count_rays:
        out = out + (rays_cast,)
    return out


def _kernel(
    cam_ref,  # (1, 24) f32 camera scalars
    ints_ref,  # (1, 4) u32: [sample_index, frame_seed, y_offset, row_stride]
    scene_ref,  # (16, N) f32 scene
    *rest,  # [mesh+bvh refs] + [sphere-bvh refs] + out refs (see has_* flags)
    width: int,
    height: int,
    n_spheres: int,
    has_mesh: bool,
    has_sphere_bvh: bool,
    max_depth: int,
    t_min: float,
    t_max: float,
    mode: str,
    rr_depth: int = 0,
    sky_intensity: float = 1.0,
    num_lights: int = 0,  # sphere lights; > 0 enables in-kernel NEE
    num_tri_lights: int = 0,  # emissive mesh faces (same ordinal space)
    mesh_smooth: bool = False,
    spp: int = 1,
    sampler_spec: tuple | None = None,
    adaptive_tol: float = 0.0,
    adaptive_min_spp: int = 8,
    mis: bool = False,
    clamp: float = 0.0,
    return_spp_map: bool = False,
    count_rays: bool = False,
    adaptive_resume: bool = False,
    adaptive_chunk: int = 0,
):
    """One pixel block: ray gen -> trace -> write.

    `adaptive_resume` (adaptive progressive accumulation): 6 extra INPUT
    planes — prior rgb raw sums, per-pixel count, Welford mlum/m2 — and the
    6 outputs are the updated state instead of a mean image.  The in-kernel
    convergence loop continues at the absolute sample index `count[0,0]`
    (block-constant), takes at most `adaptive_chunk` more samples, and
    evaluates the SAME stopping test at the same absolute indices as the
    one-shot adaptive loop — so a chunked run is bitwise identical to one
    shot on the same budget.

    Fuses the reference's get_ray (wgsl:305-331) into the trace kernel so no
    per-ray data ever reaches device memory: inputs are ~200 bytes of
    scalars, the output is the block's RGB.
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
    adapt_in = None
    if adaptive_resume:
        adapt_in = rest[:6]  # sum_r, sum_g, sum_b, count, mlum, m2
        rest = rest[6:]
    outr_ref, outg_ref, outb_ref = rest[:3]

    i = pl.program_id(0)
    j = pl.program_id(1)
    shape = (outr_ref.shape[0], outr_ref.shape[1])

    y_local = i * shape[0] + jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    y = y_local
    x = j * shape[1] + jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    # Global row = local row * stride + offset: stride 1 renders a
    # contiguous band, stride n the interleaved row partition (both are
    # dynamic scalars — one compiled kernel serves every sharding).
    y = y * ints_ref[0, 3] + ints_ref[0, 2]
    # Global pixel id uses the REAL frame width so the stream matches the
    # pure-JAX 'hash' integrator exactly (ops/rays.generate_rays_hash).
    # i32 -> u32 astype is modular (bit-preserving).
    pid = (y * width + x).astype(jnp.uint32)
    frame_seed_u32 = ints_ref[0, 1].astype(jnp.uint32)
    base_sample = ints_ref[0, 0].astype(jnp.uint32)

    def one_sample(s_u32):
        """Ray gen + full trace of one sample; returns (r, g, b) planes."""
        seeds = rng_ops.hash_pixel_seeds(pid, s_u32, frame_seed_u32)

        # Jittered pixel center (wgsl:314-317); salts match generate_rays_hash.
        u1 = _uniform(seeds, 1)
        u2 = _uniform(seeds, 2)
        # AA jitter under the configured sampler — the same shared
        # function (and stream) as ops/rays.generate_rays_for_ids,
        # elementwise.
        jx, jy = rng_ops.sampler_jitter(
            u1, u2, pid, s_u32, frame_seed_u32, sampler_spec
        )
        fx = x.astype(jnp.float32) + 0.5 + jx
        fy = y.astype(jnp.float32) + 0.5 + jy

        def cam(k):
            return cam_ref[0, k]

        # rows: center 0-2, upper_left 3-5, pdu 6-8, pdv 9-11, disk_u 12-14,
        # disk_v 15-17, defocus_angle 18
        pcx = cam(3) + cam(6) * fx + cam(9) * fy
        pcy = cam(4) + cam(7) * fx + cam(10) * fy
        pcz = cam(5) + cam(8) * fx + cam(11) * fy

        # Uniform-disk thin-lens origin (defocus off -> mask 0, stays pinhole).
        u3 = _uniform(seeds, 3)
        u4 = _uniform(seeds, 4)
        # Thin-lens point — same salt-7 pair as generate_rays_for_ids.
        u3, u4 = rng_ops.sampler_uniforms(
            u3, u4, pid, s_u32, frame_seed_u32, sampler_spec,
            rot_salt=rng_ops._LENS_ROT_SALT,
        )
        radius = jnp.sqrt(u3)
        ang = u4 * jnp.float32(2.0 * jnp.pi)
        pxd = radius * jnp.cos(ang)
        pyd = radius * jnp.sin(ang)
        lens = (cam(18) > 0.0).astype(jnp.float32)
        ox = cam(0) + lens * (pxd * cam(12) + pyd * cam(15))
        oy = cam(1) + lens * (pxd * cam(13) + pyd * cam(16))
        oz = cam(2) + lens * (pxd * cam(14) + pyd * cam(17))
        dx, dy, dz = pcx - ox, pcy - oy, pcz - oz  # not normalized (wgsl:322)

        if mode != "path":
            # Bounce-free AOV modes share one closest-hit: 'normal' shading
            # (BASELINE config 1), first-hit 'albedo' and metric 'depth'
            # (denoiser guide channels; matches ops/integrators.shade_*).
            t_hit, hit, _, _, _, nx, ny, nz, _, ar, ag, ab, _, _ = _closest_hit(
                scene_ref, n_spheres, t_min, t_max, ox, oy, oz, dx, dy, dz,
                mesh_refs=mesh_refs, sphere_bvh_refs=sphere_bvh_refs,
                mesh_smooth=mesh_smooth,
            )
            skr, skg, skb = _sky(dx, dy, dz)
            one_ray = (jnp.ones(shape, jnp.float32),) if count_rays else ()
            if mode == "albedo":
                return (
                    jnp.where(hit, ar, skr),
                    jnp.where(hit, ag, skg),
                    jnp.where(hit, ab, skb),
                ) + one_ray
            if mode == "depth":
                dist = jnp.where(
                    hit, t_hit * jnp.sqrt(dx * dx + dy * dy + dz * dz), 0.0
                )
                return (dist, dist, dist) + one_ray
            return (
                jnp.where(hit, 0.5 * (nx + 1.0), skr),
                jnp.where(hit, 0.5 * (ny + 1.0), skg),
                jnp.where(hit, 0.5 * (nz + 1.0), skb),
            ) + one_ray

        body = functools.partial(
            _path_bounce,
            seeds=seeds, scene_ref=scene_ref, lights_ref=lights_ref,
            mesh_refs=mesh_refs, sphere_bvh_refs=sphere_bvh_refs,
            pick_seed=s_u32 ^ rng_ops.wgsl_hash(frame_seed_u32),
            n_spheres=n_spheres, t_min=t_min, t_max=t_max,
            mesh_smooth=mesh_smooth, sky_intensity=sky_intensity,
            num_lights=num_lights, rr_depth=rr_depth,
            tri_lights_ref=tri_lights_ref, num_tri_lights=num_tri_lights,
            pid=pid, s_u32=s_u32, frame_seed_u32=frame_seed_u32,
            sampler_spec=sampler_spec, mis=mis, max_depth=max_depth,
            count_rays=count_rays,
        )

        ones = jnp.ones(shape, jnp.float32)
        zeros = jnp.zeros(shape, jnp.float32)
        carry = (
            jnp.int32(0),
            ox, oy, oz, dx, dy, dz, ones, ones, ones, zeros, zeros, zeros, ones,
            zeros,
        )
        if mis:
            carry = carry + (zeros,)  # prev_cos (appended last; indices stable)
        if count_rays:
            carry = carry + (zeros,)  # accumulated rays-traced plane

        def cond(c):
            # Block-level early exit: stop as soon as every ray in the block
            # has terminated — the block analogue of the per-thread break
            # (wgsl:289).  Sky blocks finish after one bounce instead of
            # max_depth; only the block's deepest path sets its trip count.
            return (c[0] < max_depth) & (jnp.max(c[13]) > 0.5)

        if count_rays:
            # The last carry plane accumulates each bounce's rays-cast
            # delta (the bounce's own last output plane); the bounce state
            # proper excludes it.
            def one_step(c):
                out = body(c[0], c[1:-1])
                return (c[0] + jnp.int32(1),) + out[:-1] + (c[-1] + out[-1],)
        else:
            def one_step(c):
                out = body(c[0], c[1:])
                return (c[0] + jnp.int32(1),) + out

        carry = jax.lax.while_loop(cond, one_step, carry)
        # Exhausted rays contribute black (the fixed semantics; the reference's
        # sky-leak quirk wgsl:293-296 exists only in the pure-JAX parity path).
        r_s, g_s, b_s = carry[10], carry[11], carry[12]
        if clamp > 0.0:
            # Per-sample max-component radiance clamp — the component-plane
            # form of ops/integrators.clamp_radiance (same arithmetic).
            m = jnp.maximum(r_s, jnp.maximum(g_s, b_s))
            scale = jnp.minimum(
                1.0, jnp.float32(clamp) / jnp.maximum(m, 1e-12)
            )
            r_s, g_s, b_s = r_s * scale, g_s * scale, b_s * scale
        if count_rays:
            return r_s, g_s, b_s, carry[-1]
        return r_s, g_s, b_s

    def _adaptive_tools():
        """Welford update + stopping test, shared VERBATIM by the one-shot
        adaptive loop and the adaptive_resume progressive branch: the
        documented bitwise resume == one-shot guarantee holds only because
        both run exactly these operations in this order."""
        min_spp = min(max(2, adaptive_min_spp), spp)
        # Boundary tiles: only IN-FRAME lanes may drive the stopping
        # decision — the pad lanes render off-frame rays whose statistics
        # must not stop (or prolong) the visible pixels' sampling.
        valid_f = (
            (y_local < jnp.int32(height)) & (x < jnp.int32(width))
        ).astype(jnp.float32)
        n_valid = jnp.maximum(jnp.sum(valid_f), 1.0)

        def tile_mean(plane):
            return jnp.sum(plane * valid_f) / n_valid

        def welford(k, r, g, b, mlum, m2):
            k1f = jnp.asarray(k + 1, jnp.float32)
            lum = (r + g + b) * jnp.float32(1.0 / 3.0)
            d = lum - mlum
            mlum = mlum + d / k1f
            m2 = m2 + d * (lum - mlum)
            return mlum, m2

        def wants_more(k, mlum, m2):
            kf = jnp.asarray(k, jnp.float32)
            # Per-pixel stderr^2 of the running mean = var / k; compare the
            # tile-mean stderr against (tol * tile-mean luminance + eps) —
            # the eps is a fixed absolute floor so black tiles terminate —
            # in squared form (no per-pixel sqrt on the hot exit test).
            stderr2 = tile_mean(m2) / jnp.maximum(kf - 1.0, 1.0) / kf
            scale = tile_mean(mlum) * jnp.float32(adaptive_tol) + jnp.float32(
                1e-4
            )
            return (k < min_spp) | ((k < spp) & (stderr2 > scale * scale))

        return welford, wants_more

    if adaptive_resume:
        # Adaptive PROGRESSIVE step: continue the one-shot adaptive loop
        # from the carried Welford state.  Same body, same stopping test at
        # the same absolute sample indices — plus the chunk bound — so a
        # chunked run to the same budget is bitwise equal to one shot.
        welford, wants_more = _adaptive_tools()

        sr0, sg0, sb0 = adapt_in[0][:], adapt_in[1][:], adapt_in[2][:]
        ml0, m20 = adapt_in[4][:], adapt_in[5][:]
        # Block-constant by construction: one scalar load of the count.
        k0 = adapt_in[3][0, 0].astype(jnp.int32)

        def ad_body(c):
            k, sr, sg, sb, mlum, m2 = c
            r, g, b = one_sample(base_sample + jnp.asarray(k, jnp.uint32))[:3]
            mlum, m2 = welford(k, r, g, b, mlum, m2)
            return (k + jnp.int32(1), sr + r, sg + g, sb + b, mlum, m2)

        def ad_cond(c):
            k, _, _, _, mlum, m2 = c
            return wants_more(k, mlum, m2) & (
                k < k0 + jnp.int32(adaptive_chunk)
            )

        k, sr, sg, sb, mlum, m2 = jax.lax.while_loop(
            ad_cond, ad_body, (k0, sr0, sg0, sb0, ml0, m20)
        )
        outr_ref[:] = sr
        outg_ref[:] = sg
        outb_ref[:] = sb
        rest[3][:] = jnp.broadcast_to(jnp.asarray(k, jnp.float32), shape)
        rest[4][:] = mlum
        rest[5][:] = m2
        return

    # In-kernel spp loop: one launch renders (and averages) all samples,
    # instead of one launch + one full image write per sample.
    # `cnt` (count_rays) totals rays traced per pixel ACROSS samples — a
    # sum, never averaged.
    cnt = jnp.zeros(shape, jnp.float32)
    if spp == 1:
        out1 = one_sample(base_sample)
        r, g, b = out1[:3]
        if count_rays:
            cnt = out1[3]
        n_taken = jnp.float32(1.0)
    elif adaptive_tol > 0.0:
        # Adaptive sampling: the spp loop exits per TILE once the tile's
        # estimate has converged — the spp-axis analogue of the bounce
        # loop's tile early-exit above.  Welford-tracked per-pixel
        # luminance variance gives the tile's mean relative standard
        # error; tiles stop when it drops below adaptive_tol (sky tiles
        # take adaptive_min_spp samples, penumbra tiles run to spp).
        # Samples taken are a PREFIX of the identical sample stream, so
        # the draws are unchanged — only the per-tile count varies.
        welford, wants_more = _adaptive_tools()
        z = jnp.zeros(shape, jnp.float32)

        def ad_body(c):
            k, sr, sg, sb, sc, mlum, m2 = c
            outk = one_sample(base_sample + jnp.asarray(k, jnp.uint32))
            r, g, b = outk[:3]
            if count_rays:
                sc = sc + outk[3]
            mlum, m2 = welford(k, r, g, b, mlum, m2)
            return (k + jnp.int32(1), sr + r, sg + g, sb + b, sc, mlum, m2)

        def ad_cond(c):
            k, _, _, _, _, mlum, m2 = c
            return wants_more(k, mlum, m2)

        k, r, g, b, cnt, _, _ = jax.lax.while_loop(
            ad_cond, ad_body, (jnp.int32(0), z, z, z, z, z, z)
        )
        n_taken = jnp.asarray(k, jnp.float32)
        r, g, b = r / n_taken, g / n_taken, b / n_taken
    else:
        def spp_body(k, acc):
            outk = one_sample(base_sample + jnp.asarray(k, jnp.uint32))
            acc2 = (acc[0] + outk[0], acc[1] + outk[1], acc[2] + outk[2])
            if count_rays:
                acc2 = acc2 + (acc[3] + outk[3],)
            return acc2

        z = jnp.zeros(shape, jnp.float32)
        acc0 = (z, z, z) + ((z,) if count_rays else ())
        acc = jax.lax.fori_loop(0, spp, spp_body, acc0)
        inv = jnp.float32(spp)
        r, g, b = acc[0] / inv, acc[1] / inv, acc[2] / inv
        if count_rays:
            cnt = acc[3]
        n_taken = jnp.float32(spp)
    outr_ref[:] = r
    outg_ref[:] = g
    outb_ref[:] = b
    extra = rest[3:]
    if return_spp_map:  # per-pixel sample-count plane
        extra[0][:] = jnp.broadcast_to(n_taken, shape)
        extra = extra[1:]
    if count_rays:  # per-pixel rays-traced plane (sum over samples)
        extra[0][:] = cnt


def camera_vector(camera) -> Array:
    """Pack the derived Camera pytree into the (1, 24) scalar layout."""
    return jnp.concatenate(
        [
            jnp.asarray(camera.center, jnp.float32).reshape(3),
            jnp.asarray(camera.viewport_upper_left, jnp.float32).reshape(3),
            jnp.asarray(camera.pixel_delta_u, jnp.float32).reshape(3),
            jnp.asarray(camera.pixel_delta_v, jnp.float32).reshape(3),
            jnp.asarray(camera.defocus_disk_u, jnp.float32).reshape(3),
            jnp.asarray(camera.defocus_disk_v, jnp.float32).reshape(3),
            jnp.asarray(camera.defocus_angle, jnp.float32).reshape(1),
            jnp.zeros((5,), jnp.float32),
        ]
    ).reshape(1, 24)


def render_pallas(
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
    mode: str = "path",  # 'path' | 'normal' | 'albedo' | 'depth'
    russian_roulette_depth: int = 0,
    sky_intensity: float = 1.0,
    nee: bool = False,
    y_offset: Array | int = 0,
    interpret: bool | None = None,
    spp: int = 1,
    row_stride: Array | int = 1,
    sampler_spec: tuple | None = None,
    adaptive_tol: float = 0.0,
    adaptive_min_spp: int = 8,
    return_spp_map: bool = False,
    return_ray_count: bool = False,
    mis: bool = False,
    clamp: float = 0.0,
    adaptive_state: tuple | None = None,
    adaptive_chunk: int = 0,
) -> Array:
    """Render spp samples in one kernel launch; returns the (height, width,
    3) RGB mean.  Sample s of the call uses stream index `sample_index + s`,
    so one spp=k call equals the mean of k consecutive 1-spp calls (one
    launch and one image write instead of k).

    `adaptive_tol > 0` makes spp a BUDGET: each pixel block's in-kernel
    sample loop exits once the block-mean relative standard error of its estimate drops
    below the tolerance (after `adaptive_min_spp` samples), so converged
    regions (sky, flat diffuse) stop early while noisy regions (penumbras,
    caustic-ish glass) spend the full budget.  Samples are a prefix of the
    identical stream.  Stopping is data-dependent, so the estimator is
    mildly biased where it stops early (standard adaptive-sampling caveat);
    keep tol at or below the noise floor you can see.  `return_spp_map=True`
    additionally returns the (height, width) per-pixel sample counts
    (constant within each block).  `return_ray_count=True` additionally
    returns the (height, width) per-pixel count of rays the kernel actually
    traced across all samples — live closest-hit walks per bounce plus NEE
    shadow rays whose occlusion walk was driven (in-kernel counters, the
    measured basis for honest bounce-ray throughput; appended after the
    spp map when both are requested).

    `adaptive_state` (adaptive PROGRESSIVE accumulation; requires
    adaptive_tol > 0, mode='path', adaptive_chunk > 0, and no other extra
    outputs): a tuple of six (height, width) f32 arrays — rgb raw sums
    r/g/b, per-pixel count (block-constant), Welford mlum, m2 — as produced
    by a previous call (zeros to start).  The kernel resumes the adaptive
    loop at the carried absolute sample index, takes at most
    adaptive_chunk more samples per block, and returns the updated 6-tuple;
    chunked runs are bitwise identical to the one-shot adaptive render of
    the same budget (see ops/accumulate.AdaptiveAccumState).

    The only device-memory traffic is the scene and the output image: ray
    generation, the sphere
    scan, the mesh BVH traversal, materials, and the bounce loop all run
    inside one kernel.  `y_offset`/`width` address a row shard of a larger
    frame (the sharded renderer passes the shard's global row offset);
    local row r maps to global row `y_offset + r * row_stride` (stride n =
    the interleaved partition, parallel/sharding.py).

    Accepts a Spheres SoA or a Scene; mesh scenes must have a BVH.

    `interpret` defaults to the platform module's answer for the current
    device (interpret mode on the CPU, Triton on the GPU); the sharded
    renderer passes its mesh's answer.
    """
    from gpu_ray_tracing.models.scene import as_scene, resolve_mesh_has_emissive

    if spp < 1:
        raise ValueError(f"spp must be >= 1, got {spp}")  # avoids 0/0 NaN
    if mis and not nee:
        raise ValueError("mis=True is a weighting of NEE; it requires nee=True")
    sc = as_scene(scene_or_spheres)
    spheres = sc.spheres
    if sc.mesh is not None:
        if sc.bvh is None:
            raise ValueError("pallas mesh rendering requires a BVH (make_scene builds one)")

    block_rows, block_cols, num_warps = block_shape(mode)
    h_pad = -(-height // block_rows) * block_rows
    w_pad = -(-width // block_cols) * block_cols
    grid = (h_pad // block_rows, w_pad // block_cols)

    cam_vec = camera_vector(camera)
    # int32 bit-patterns; the kernel astypes back to uint32.
    ints = jax.lax.bitcast_convert_type(
        jnp.stack(
            [
                jnp.asarray(sample_index, jnp.uint32),
                jnp.asarray(frame_seed, jnp.uint32),
                jnp.asarray(y_offset, jnp.uint32),
                jnp.asarray(row_stride, jnp.uint32),
            ]
        ),
        jnp.int32,
    ).reshape(1, 4)
    scene = scene_planes(spheres)
    n = spheres.count

    if interpret is None:
        interpret = platform.interpret()

    tile_spec = pl.BlockSpec((block_rows, block_cols), lambda i, j: (i, j))
    # Whole-array operands, read by scalar loads only.
    whole = lambda shape: pl.BlockSpec(shape, lambda i, j: (0, 0))
    out_shape = jax.ShapeDtypeStruct((h_pad, w_pad), jnp.float32)

    has_mesh = sc.mesh is not None
    has_sphere_bvh = sc.sphere_bvh is not None
    in_specs = [whole((1, 24)), whole((1, 4)), whole((_SCENE_ROWS, n))]
    args = [cam_vec, ints, scene]
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
        bvhf, bvhi = bvh_planes(sc.bvh)
        in_specs += [
            whole(tbl.shape),
            whole((8, sc.bvh.num_nodes)),
            whole((4, sc.bvh.num_nodes)),
        ]
        args += [tbl, bvhf, bvhi]
    if has_sphere_bvh:
        sbf, sbi = bvh_planes(sc.sphere_bvh)
        in_specs += [
            whole((8, sc.sphere_bvh.num_nodes)),
            whole((4, sc.sphere_bvh.num_nodes)),
        ]
        args += [sbf, sbi]

    num_lights = 0
    num_tri_lights = 0
    if nee:
        n_sl = 0 if sc.lights is None else sc.lights.count
        n_tl = 0 if sc.tri_lights is None else sc.tri_lights.count
        if n_sl + n_tl == 0:
            raise ValueError(
                "nee=True needs a Scene with emissive lights (make_scene)"
            )
        # Static metadata check (this runs under jit with a traced scene;
        # make_scene records the flag host-side).
        if resolve_mesh_has_emissive(sc) and sc.tri_lights is None:
            raise ValueError(
                "nee=True with EMISSIVE mesh faces needs the triangle "
                "light list; build the Scene via make_scene (it extracts "
                "tri_lights)"
            )
        num_lights, num_tri_lights = n_sl, n_tl
        if num_lights > 0:
            in_specs += [whole((8, num_lights))]
            args += [lights_planes(sc.lights)]
        if num_tri_lights > 0:
            in_specs += [whole((16, num_tri_lights))]
            args += [tri_lights_planes(sc.tri_lights)]

    if adaptive_state is not None:
        if adaptive_tol <= 0.0 or mode != "path" or adaptive_chunk <= 0:
            raise ValueError(
                "adaptive_state requires adaptive_tol > 0, mode='path' and "
                "adaptive_chunk > 0"
            )
        if return_spp_map or return_ray_count:
            raise ValueError(
                "adaptive_state already returns the per-pixel count plane; "
                "return_spp_map/return_ray_count do not compose with it"
            )
        if len(adaptive_state) != 6:
            raise ValueError(
                f"adaptive_state must be a 6-tuple, got {len(adaptive_state)}"
            )
        for st in adaptive_state:
            pad = jnp.zeros((h_pad, w_pad), jnp.float32)
            pad = pad.at[:height, :width].set(jnp.asarray(st, jnp.float32))
            in_specs.append(tile_spec)
            args.append(pad)

    kernel = functools.partial(
        _kernel, width=width, height=height, n_spheres=n, has_mesh=has_mesh,
        has_sphere_bvh=has_sphere_bvh,
        max_depth=max_depth, t_min=float(t_min), t_max=float(t_max), mode=mode,
        rr_depth=russian_roulette_depth, sky_intensity=float(sky_intensity),
        num_lights=num_lights,
        num_tri_lights=num_tri_lights,
        mesh_smooth=has_mesh and sc.mesh.smooth,
        spp=spp,
        sampler_spec=sampler_spec,
        adaptive_tol=float(adaptive_tol),
        adaptive_min_spp=adaptive_min_spp,
        mis=mis and (num_lights + num_tri_lights) > 0,
        clamp=float(clamp),
        return_spp_map=return_spp_map,
        count_rays=return_ray_count,
        adaptive_resume=adaptive_state is not None,
        adaptive_chunk=adaptive_chunk,
    )
    out_specs = [tile_spec, tile_spec, tile_spec]
    out_shapes = [out_shape, out_shape, out_shape]
    n_extra_out = (
        3 if adaptive_state is not None
        else int(return_spp_map) + int(return_ray_count)
    )
    for _ in range(n_extra_out):
        out_specs.append(tile_spec)
        out_shapes.append(out_shape)
    outs = pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=in_specs,
        out_specs=tuple(out_specs),
        out_shape=tuple(out_shapes),
        interpret=interpret,
        compiler_params=compiler_params(num_warps),
        name="megakernel",
    )(*args)

    if adaptive_state is not None:
        # Updated state: (sum_r, sum_g, sum_b, count, mlum, m2).
        return tuple(o[:height, :width] for o in outs)
    img = jnp.stack([o[:height, :width] for o in outs[:3]], axis=-1)
    extras = tuple(o[:height, :width] for o in outs[3:])
    if extras:
        return (img,) + extras
    return img
