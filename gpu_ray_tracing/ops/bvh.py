"""BVH build: threaded (stackless) flat layout for vector-machine traversal.

The reference has no acceleration structure at all — its kernel linearly
scans every sphere per ray-bounce (wgsl:164-180; SURVEY flags the O(N) scan
as the dominant cost).  BASELINE config 4 requires BVH-accelerated triangle
meshes, and large sphere scenes want the same.

Design: classic BVH traversal keeps a per-ray STACK, which maps badly
onto vectorized code (per-lane dynamic memory).  We instead emit a
*threaded* BVH in depth-first order with precomputed miss links:

  - nodes are laid out depth-first, so the "hit" successor of an inner node
    is simply `node + 1` (no pointer stored);
  - every node stores `miss_link`: the node to visit when its AABB is missed
    (or after a leaf is processed) — the DFS escape edge;
  - traversal is a single per-lane integer cursor advanced in a while loop:
    no stack, no dynamic memory, bounded state.  This is the layout both the
    pure-JAX traversal (ops/intersect.intersect_bvh) and the Pallas kernel
    consume.

The builder itself is host-side numpy (median split on the longest centroid
axis); scene builds are setup code.  `native/` provides an optional C++
builder (binned SAH) behind the same array contract for large meshes.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing.models.mesh import TriangleMesh

Array = jax.Array

SENTINEL = -1  # cursor value meaning "traversal finished"


def _round_out_f32(vals, up: bool) -> np.ndarray:
    """Narrow to float32 rounding OUTWARD (toward ±inf), so a float32 AABB
    never shrinks below the (possibly float64) extent it covers."""
    v64 = np.asarray(vals, np.float64)
    v32 = np.asarray(v64, np.float32)
    if up:
        return np.where(v32.astype(np.float64) < v64,
                        np.nextafter(v32, np.float32(np.inf)), v32)
    return np.where(v32.astype(np.float64) > v64,
                    np.nextafter(v32, np.float32(-np.inf)), v32)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["bbox_min", "bbox_max", "miss_link", "leaf_start", "leaf_count"],
    meta_fields=["leaf_size"],
)
@dataclasses.dataclass(frozen=True)
class BVH:
    """Threaded flat BVH over a reordered primitive array.

    bbox_min/max (M, 3) f32   node bounds
    miss_link    (M,)   i32   next node on AABB miss / after a leaf; -1 ends
    leaf_start   (M,)   i32   first primitive (in BVH order) for leaves, -1
                              for inner nodes
    leaf_count   (M,)   i32   primitives in the leaf (0 for inner nodes)
    leaf_size    int          STATIC build-time cap on leaf_count — the
                              traversal's unrolled leaf scan must cover at
                              least this many slots, so it rides with the
                              structure instead of being re-threaded by
                              every caller (a smaller guess silently skips
                              triangles).

    Invariant: the hit-successor of inner node i is i+1 (depth-first layout).
    """

    bbox_min: Array
    bbox_max: Array
    miss_link: Array
    leaf_start: Array
    leaf_count: Array
    leaf_size: int = 4

    @property
    def num_nodes(self) -> int:
        return self.bbox_min.shape[0]


def build_bvh(
    centroids: np.ndarray,
    bounds_min: np.ndarray,
    bounds_max: np.ndarray,
    leaf_size: int = 4,
    method: str = "auto",
) -> tuple[BVH, np.ndarray]:
    """BVH over arbitrary primitives.

    centroids/bounds_*: (F, 3) per-primitive.  Returns (bvh, order) where
    `order` is the permutation that reorders primitives into leaf-contiguous
    BVH order (apply it to your primitive arrays before traversal).

    method: 'native' (C++ binned SAH, gpu_ray_tracing/native/),
    'numpy' (median split below), or 'auto' (native when it compiled).
    Both emit the identical threaded-layout contract.
    """
    if method not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown BVH build method {method!r}")
    if leaf_size < 1:
        raise ValueError(f"leaf_size must be >= 1, got {leaf_size}")
    if np.shape(centroids)[0] == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    # Narrow the (possibly float64) primitive bounds to f32 by rounding
    # OUTWARD: round-to-nearest could shrink a box below the true extent by
    # half an ulp and cull a genuine grazing hit in the f32 slab test.
    bounds_min = _round_out_f32(bounds_min, up=False)
    bounds_max = _round_out_f32(bounds_max, up=True)
    if method != "numpy":
        from gpu_ray_tracing import native

        if native.available():
            nb, nx, miss, ls, lc, order = native.build_bvh_sah(
                np.asarray(centroids, np.float32),
                np.asarray(bounds_min, np.float32),
                np.asarray(bounds_max, np.float32),
                leaf_size,
            )
            return (
                BVH(
                    bbox_min=jnp.asarray(nb),
                    bbox_max=jnp.asarray(nx),
                    miss_link=jnp.asarray(miss),
                    leaf_start=jnp.asarray(ls),
                    leaf_count=jnp.asarray(lc),
                    leaf_size=leaf_size,
                ),
                order,
            )
        if method == "native":
            raise RuntimeError(f"native BVH builder unavailable: {native.build_error()}")
    centroids = np.asarray(centroids, np.float64)
    bounds_min = np.asarray(bounds_min, np.float64)
    bounds_max = np.asarray(bounds_max, np.float64)
    f = centroids.shape[0]

    order: list[int] = []
    nodes_min: list[np.ndarray] = []
    nodes_max: list[np.ndarray] = []
    miss: list[int] = []
    leaf_start: list[int] = []
    leaf_count: list[int] = []

    def subtree_nodes(k: int) -> int:
        """Node count of a median-split subtree over k primitives (needed to
        know where a right subtree will land before emitting the left)."""
        return 1 if k <= leaf_size else 1 + subtree_nodes(k // 2) + subtree_nodes(k - k // 2)

    # Iterative DFS with explicit escape targets (the miss links).
    stack: list[tuple[np.ndarray, int]] = [(np.arange(f), SENTINEL)]
    while stack:
        indices, escape = stack.pop()
        nodes_min.append(bounds_min[indices].min(axis=0))
        nodes_max.append(bounds_max[indices].max(axis=0))
        miss.append(escape)
        if len(indices) <= leaf_size:
            leaf_start.append(len(order))
            leaf_count.append(len(indices))
            order.extend(int(i) for i in indices)
            continue
        leaf_start.append(SENTINEL)
        leaf_count.append(0)
        c = centroids[indices]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        part = indices[np.argsort(c[:, axis], kind="stable")]
        mid = len(indices) // 2
        left, right = part[:mid], part[mid:]
        # DFS order: left is emitted next (hit-successor = this+1).  Left's
        # escape is the right subtree's root, whose index is known up front
        # because median-split subtree sizes are deterministic.
        right_root = len(nodes_min) + subtree_nodes(len(left))
        stack.append((right, escape))
        stack.append((left, right_root))

    bvh = BVH(
        bbox_min=jnp.asarray(np.asarray(nodes_min, np.float32)),
        bbox_max=jnp.asarray(np.asarray(nodes_max, np.float32)),
        miss_link=jnp.asarray(np.asarray(miss, np.int32)),
        leaf_start=jnp.asarray(np.asarray(leaf_start, np.int32)),
        leaf_count=jnp.asarray(np.asarray(leaf_count, np.int32)),
        leaf_size=leaf_size,
    )
    return bvh, np.asarray(order, np.int64)


def build_mesh_bvh(
    mesh: TriangleMesh, leaf_size: int = 4, method: str = "auto"
) -> tuple[TriangleMesh, BVH]:
    """Build a BVH over a mesh; returns (reordered mesh, bvh)."""
    v0 = np.asarray(mesh.v0, np.float64)
    v1 = v0 + np.asarray(mesh.e1, np.float64)
    v2 = v0 + np.asarray(mesh.e2, np.float64)
    bmin = np.minimum(np.minimum(v0, v1), v2)
    bmax = np.maximum(np.maximum(v0, v1), v2)
    centroids = (v0 + v1 + v2) / 3.0
    bvh, order = build_bvh(centroids, bmin, bmax, leaf_size, method)
    # Pytree map applies the permutation to EVERY per-triangle array (None
    # leaves — the optional corner normals — are skipped automatically), so
    # a future field cannot silently desynchronize from the leaf ranges.
    reordered = jax.tree_util.tree_map(lambda a: a[order], mesh)
    return reordered, bvh


def build_sphere_bvh(spheres, leaf_size: int = 16, method: str = "auto"):
    """BVH over the ACTIVE spheres of a Spheres SoA.

    Returns (reordered spheres, bvh): active spheres permuted into
    leaf-contiguous order with any inactive pad slots (radius <= 0) kept at
    the tail, outside every leaf range.  Accelerates the megakernel's sphere
    scan for large scenes (the reference's linear wgsl:164-180 scan is the
    equivalent being replaced).
    """
    radii = np.asarray(spheres.radii)
    active = np.flatnonzero(radii > 0.0)
    inactive = np.flatnonzero(radii <= 0.0)
    if active.size == 0:
        raise ValueError("no active spheres to build a BVH over")
    centers = np.asarray(spheres.centers, np.float64)[active]
    r = radii[active][:, None].astype(np.float64)
    bvh, order = build_bvh(centers, centers - r, centers + r, leaf_size, method)
    perm = np.concatenate([active[order], inactive])
    reordered = jax.tree_util.tree_map(lambda a: a[perm], spheres)
    return reordered, bvh


def validate_bvh(bvh: BVH, num_primitives: int) -> None:
    """Structural sanity checks (tests + debugging aid)."""
    m = bvh.num_nodes
    miss = np.asarray(bvh.miss_link)
    start = np.asarray(bvh.leaf_start)
    count = np.asarray(bvh.leaf_count)
    assert np.all((miss >= -1) & (miss < m)), "miss link out of range"
    leaves = start >= 0
    assert np.all(count[leaves] > 0)
    assert np.all(count[~leaves] == 0)
    covered = np.zeros(num_primitives, bool)
    for s, c in zip(start[leaves], count[leaves]):
        assert not covered[s : s + c].any(), "leaf ranges overlap"
        covered[s : s + c] = True
    assert covered.all(), "leaves do not cover all primitives"
    # Every miss link must point forward (DFS order) or end traversal.
    idx = np.arange(m)
    assert np.all((miss == -1) | (miss > idx)), "miss links must go forward"
