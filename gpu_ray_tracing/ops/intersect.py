"""Intersection: spheres, triangles (Moller-Trumbore), and BVH traversal.

Reference mapping (compute_shader.wgsl):
  - `intersect_spheres` <- sphere_list_hit (wgsl:164-180) + sphere_hit
                           (wgsl:182-221) + hit_record_set_face_normal
                           (wgsl:158-162).

Design: the reference scans spheres sequentially per thread keeping
`closest_so_far` (O(N) serial per ray).  Here the quadratic's ray-sphere terms
are factored so the two O(P*N) inner products become batched matmuls —

    h  = dot(oc, d)        = (D @ C^T) - (o . d)
    |oc|^2                 = |c|^2 - 2 (O @ C^T) + |o|^2

— and the closest hit is a masked argmin over the sphere axis.
Picking each sphere's nearest valid root in (t_min, t_max) and then taking the
global argmin yields the same closest hit as the reference's sequential
shrinking-window scan (a sphere whose near root fails only because it is
beyond the current closest cannot win the final minimum).

Rays are NOT assumed normalized (the reference never normalizes primary ray
directions, wgsl:322); the quadratic uses a = dot(d, d).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from gpu_ray_tracing.models.spheres import Spheres

Array = jax.Array


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["t", "idx", "hit", "point", "normal", "front_face"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Hit:
    """Vectorized HitRecord (wgsl:143-149), material looked up by `idx`."""

    t: Array  # (...,)   f32, ray parameter of the closest hit (t_max if none)
    idx: Array  # (...,) i32, index of the hit sphere (0 if none; see `hit`)
    hit: Array  # (...,) bool
    point: Array  # (..., 3)
    normal: Array  # (..., 3) face normal, flipped toward the incoming ray
    front_face: Array  # (...,) bool


def _sphere_roots(o, d, spheres: Spheres, t_min: float, t_max: float):
    """All-spheres quadratic for flat rays (P, 3): returns ((P, N) root,
    (P, N) valid) with the reference's near-then-far root pick.

    The ONE copy of the XLA-backend sphere quadratic — closest-hit and the
    t-only shadow scan both build on it so epsilons and interval semantics
    cannot drift (the Pallas kernels share theirs the same way).
    """
    c = spheres.centers  # (N, 3)
    r = spheres.radii  # (N,)
    active = r > 0.0

    # Inner products as (P,3) @ (3,N) matmuls.  Precision HIGHEST is
    # load-bearing: without it an f32 matmul on the GPU runs in TF32 (about
    # three decimal digits), which perturbs the quadratic enough to flip
    # hits on most sphere silhouettes against the CPU goldens
    # (benchmarks/parity_check.py).
    dc = jnp.dot(
        d, c.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (P, N) = d . c
    oc_dot_c = jnp.dot(
        o, c.T, preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (P, N) = o . c

    od = jnp.sum(o * d, axis=-1, keepdims=True)  # (P, 1)
    oo = jnp.sum(o * o, axis=-1, keepdims=True)  # (P, 1)
    a = jnp.sum(d * d, axis=-1, keepdims=True)  # (P, 1)
    c2 = jnp.sum(c * c, axis=-1)  # (N,)

    h = dc - od  # dot(center - origin, d)   (wgsl:185)
    cc = (c2 - r * r)[None, :] - 2.0 * oc_dot_c + oo  # |oc|^2 - r^2  (wgsl:186)
    disc = h * h - a * cc  # (wgsl:187)

    # Safe sqrt: double-where so misses (disc <= 0) contribute a zero
    # gradient instead of inf * 0 = NaN through the select.
    disc_pos = disc > 0.0
    sqrt_disc = jnp.where(disc_pos, jnp.sqrt(jnp.where(disc_pos, disc, 1.0)), 0.0)
    inv_a = 1.0 / a
    root_near = (h - sqrt_disc) * inv_a  # (wgsl:195)
    root_far = (h + sqrt_disc) * inv_a  # (wgsl:197)

    # Open-interval validity, matching `root <= tmin || tmax <= root` rejection
    # (wgsl:196-200).
    def _valid(root):
        return (root > t_min) & (root < t_max)

    near_ok = _valid(root_near)
    far_ok = _valid(root_far)
    root = jnp.where(near_ok, root_near, root_far)
    valid = (disc >= 0.0) & (near_ok | far_ok) & active[None, :]
    return root, valid


def intersect_spheres(
    origins: Array,
    dirs: Array,
    spheres: Spheres,
    t_min: float,
    t_max: float,
) -> Hit:
    """Closest sphere hit for a batch of rays.

    origins, dirs: (..., 3) f32.  Returns a Hit with batch shape (...).
    Inactive pad spheres (radius <= 0) never hit.
    """
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    c = spheres.centers  # (N, 3)
    r = spheres.radii  # (N,)

    root, valid = _sphere_roots(o, d, spheres, t_min, t_max)
    t_cand = jnp.where(valid, root, jnp.float32(jnp.inf))
    idx = jnp.argmin(t_cand, axis=-1)  # (P,)
    # min == the argmin element bitwise (no NaNs in t_cand) without the
    # per-ray element gather take_along_axis pays at (P, N) scale.
    t_best = jnp.min(t_cand, axis=-1)
    hit = jnp.isfinite(t_best)
    t_best = jnp.where(hit, t_best, jnp.float32(t_max))

    center_best = c[idx]  # (P, 3)
    radius_best = r[idx]  # (P,)
    # Misses keep t = t_max in the record but must not produce a ~1e35 point:
    # downstream material math would overflow f32 (inf/NaN poison through
    # jnp.where, both in the forward under debug_nans and in gradients).
    t_point = jnp.where(hit, t_best, 0.0)
    point = o + t_point[:, None] * d
    # Outward normal = (p - center) / radius (wgsl:206); guard pad radius 0.
    outward = (point - center_best) / jnp.where(radius_best != 0.0, radius_best, 1.0)[:, None]
    front_face = jnp.sum(d * outward, axis=-1) < 0.0  # (wgsl:159)
    normal = jnp.where(front_face[:, None], outward, -outward)  # (wgsl:160)

    return Hit(
        t=t_best.reshape(batch_shape),
        idx=idx.astype(jnp.int32).reshape(batch_shape),
        hit=hit.reshape(batch_shape),
        point=point.reshape(*batch_shape, 3),
        normal=normal.reshape(*batch_shape, 3),
        front_face=front_face.reshape(batch_shape),
    )


# ---------------------------------------------------------------------------
# Triangles.  The reference supports only spheres (sphere.rs:21-26); triangle
# meshes + BVH are the BASELINE config-4 extension (same "Next Week" lineage
# the reference README points to, README.md:67-73).
# ---------------------------------------------------------------------------


def _moller_trumbore(o, d, v0, e1, e2, t_min, t_max):
    """Batched Moller-Trumbore: rays (P, 3) against per-ray triangles (P, 3).

    Returns (t, hit) with the (t_min, t_max) open-interval test; t_max may be
    a (P,) array (shrinking closest-so-far window).
    """
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    near_parallel = jnp.abs(det) < 1e-12
    inv_det = 1.0 / jnp.where(near_parallel, 1.0, det)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (
        ~near_parallel
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return t, hit


def intersect_triangles(origins: Array, dirs: Array, mesh, t_min: float, t_max: float) -> Hit:
    """Brute-force closest hit over every triangle (reference path for tests
    and small meshes; BVH below for real scenes)."""
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)

    # (P, F) via broadcasting, chunk-free (caller controls P).
    t, hit = _moller_trumbore(
        o[:, None, :], d[:, None, :],
        mesh.v0[None, :, :], mesh.e1[None, :, :], mesh.e2[None, :, :],
        t_min, t_max,
    )
    t_cand = jnp.where(hit, t, jnp.float32(jnp.inf))
    idx = jnp.argmin(t_cand, axis=-1)
    t_best = jnp.min(t_cand, axis=-1)
    any_hit = jnp.isfinite(t_best)
    t_best = jnp.where(any_hit, t_best, jnp.float32(t_max))
    return _mesh_hit_record(o, d, mesh, t_best, idx.astype(jnp.int32), any_hit, batch_shape)


def _mesh_hit_record(o, d, mesh, t_best, idx, any_hit, batch_shape) -> Hit:
    t_point = jnp.where(any_hit, t_best, 0.0)
    point = o + t_point[:, None] * d
    if mesh.smooth:
        # Recompute the winner's barycentrics (cheaper than carrying u, v
        # through the traversal) and interpolate the corner normals.
        v0, e1, e2 = mesh.v0[idx], mesh.e1[idx], mesh.e2[idx]
        pvec = jnp.cross(d, e2)
        det = jnp.sum(e1 * pvec, axis=-1)
        inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
        tvec = o - v0
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        v = jnp.sum(d * jnp.cross(tvec, e1), axis=-1) * inv_det
        outward = (
            (1.0 - u - v)[:, None] * mesh.n0[idx]
            + u[:, None] * mesh.n1[idx]
            + v[:, None] * mesh.n2[idx]
        )
        outward = outward / jnp.maximum(
            jnp.linalg.norm(outward, axis=-1, keepdims=True), 1e-20
        )
    else:
        outward = mesh.normals[idx]
    front_face = jnp.sum(d * outward, axis=-1) < 0.0
    normal = jnp.where(front_face[:, None], outward, -outward)
    return Hit(
        t=t_best.reshape(batch_shape),
        idx=idx.reshape(batch_shape),
        hit=any_hit.reshape(batch_shape),
        point=point.reshape(*batch_shape, 3),
        normal=normal.reshape(*batch_shape, 3),
        front_face=front_face.reshape(batch_shape),
    )


def intersect_bvh(
    origins: Array,
    dirs: Array,
    mesh,
    bvh,
    t_min: float,
    t_max: float,
    leaf_size: int | None = None,
) -> Hit:
    """Stackless threaded-BVH closest hit (see ops/bvh.py for the layout).

    Every ray carries one integer cursor; inner-node hit advances to node+1
    (depth-first layout), miss or finished leaf follows the precomputed miss
    link.  A lax.while_loop runs until every lane's cursor hits the sentinel;
    there is no per-lane stack, so the traversal state is O(1) per ray —
    the shape a vector machine wants.

    `leaf_size` defaults to the BVH's own build-time value (bvh.leaf_size);
    an explicit smaller value would silently skip triangles in large leaves.

    Differentiability (straight-through): lax.while_loop has no reverse-mode
    rule, and the traversal's outputs are DISCRETE anyway (which triangle
    won).  The walk therefore runs on stop_gradient inputs — fixing the hit
    decision, exactly SURVEY §7 hard part 4's straight-through policy — and
    the winner's t is recomputed OUTSIDE the loop with one differentiable
    Moller-Trumbore on the gathered triangle (bitwise the same value: same
    function of the same inputs), so d(image)/d(vertices, materials) flows
    through mesh+BVH scenes (tests/test_gradients.py).
    """
    if leaf_size is None:
        leaf_size = bvh.leaf_size
    batch_shape = origins.shape[:-1]
    o_diff = origins.reshape(-1, 3)
    d_diff = dirs.reshape(-1, 3)
    mesh_diff = mesh
    sg = jax.lax.stop_gradient
    o, d, mesh, bvh = sg(o_diff), sg(d_diff), jax.tree.map(sg, mesh), jax.tree.map(sg, bvh)
    p = o.shape[0]

    safe_d = jnp.where(jnp.abs(d) < 1e-20, jnp.float32(1e-20), d)
    inv_d = 1.0 / safe_d

    def cond(carry):
        node = carry[0]
        return jnp.any(node >= 0)

    def body(carry):
        node, t_best, idx_best = carry
        valid = node >= 0
        nidx = jnp.where(valid, node, 0)

        bmin = bvh.bbox_min[nidx]  # (P, 3) gather
        bmax = bvh.bbox_max[nidx]
        t0 = (bmin - o) * inv_d
        t1 = (bmax - o) * inv_d
        tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
        tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
        # Enter the node only if the slab interval overlaps (t_min, t_best):
        # the shrinking window culls subtrees behind the closest hit so far.
        box_hit = valid & (tf >= jnp.maximum(tn, jnp.float32(t_min))) & (tn < t_best)

        ls = bvh.leaf_start[nidx]
        lc = bvh.leaf_count[nidx]
        is_leaf = ls >= 0
        in_leaf = box_hit & is_leaf

        for k in range(leaf_size):
            tri = ls + k
            m = in_leaf & (k < lc)
            tri_safe = jnp.where(m, tri, 0)
            t, hit = _moller_trumbore(
                o, d,
                mesh.v0[tri_safe], mesh.e1[tri_safe], mesh.e2[tri_safe],
                t_min, t_best,
            )
            take = m & hit
            t_best = jnp.where(take, t, t_best)
            idx_best = jnp.where(take, tri_safe, idx_best)

        descend = box_hit & ~is_leaf
        next_node = jnp.where(descend, node + 1, bvh.miss_link[nidx])
        next_node = jnp.where(valid, next_node, jnp.int32(SENTINEL_NODE))
        return next_node, t_best, idx_best

    node0 = jnp.zeros((p,), jnp.int32)
    t0_ = jnp.full((p,), jnp.float32(t_max))
    idx0 = jnp.full((p,), -1, jnp.int32)
    _, t_best, idx_best = jax.lax.while_loop(cond, body, (node0, t0_, idx0))

    any_hit = idx_best >= 0
    idx = jnp.where(any_hit, idx_best, 0)
    # Differentiable recompute of the winner's t (the traversal above is
    # gradient-opaque by construction).  Same triangle, same formula ->
    # bitwise the same primal value; misses keep t_max.
    t_re, _ = _moller_trumbore(
        o_diff, d_diff,
        mesh_diff.v0[idx], mesh_diff.e1[idx], mesh_diff.e2[idx],
        t_min, t_max,
    )
    t_best = jnp.where(any_hit, t_re, jnp.float32(t_max))
    return _mesh_hit_record(o_diff, d_diff, mesh_diff, t_best, idx, any_hit,
                            batch_shape)


SENTINEL_NODE = -1


def nearest_t_spheres(origins: Array, dirs: Array, spheres: Spheres, t_min: float, t_max: float) -> Array:
    """Shadow-ray variant of intersect_spheres: nearest valid t only (t_max
    when nothing hits).  Skips the winner gather and hit-record construction
    occlusion tests discard."""
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    root, valid = _sphere_roots(o, d, spheres, t_min, t_max)
    t = jnp.min(jnp.where(valid, root, jnp.float32(t_max)), axis=-1)
    return t.reshape(batch_shape)
