"""Tests for triangle meshes (models/mesh.py) and Moller-Trumbore."""

import os

import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing.models.mesh import (
    box,
    icosphere,
    load_obj,
    make_mesh,
    torus,
    transform_mesh,
)
from gpu_ray_tracing.ops.intersect import intersect_triangles

TMIN, TMAX = 1e-3, 3.4e35


def _single_tri(z=-2.0):
    return make_mesh(
        np.asarray([[-1, -1, z], [1, -1, z], [0, 1, z]]),
        np.asarray([[0, 1, 2]]),
    )


def _hit(o, d, mesh, tmin=TMIN, tmax=TMAX):
    return intersect_triangles(
        jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32), mesh, tmin, tmax
    )


def test_triangle_head_on():
    h = _hit([[0, 0, 0]], [[0, 0, -1]], _single_tri())
    assert bool(h.hit[0])
    assert abs(float(h.t[0]) - 2.0) < 1e-5
    np.testing.assert_allclose(np.abs(np.asarray(h.normal[0])), [0, 0, 1], atol=1e-6)
    assert bool(h.front_face[0])


def test_triangle_edge_and_outside():
    mesh = _single_tri()
    assert bool(_hit([[0, 0.5, 0]], [[0, 0, -1]], mesh).hit[0])  # inside
    assert not bool(_hit([[2, 0, 0]], [[0, 0, -1]], mesh).hit[0])  # outside
    assert not bool(_hit([[0, 0, 0]], [[0, 0, 1]], mesh).hit[0])  # behind


def test_triangle_parallel_ray_misses():
    h = _hit([[0, 0, 0]], [[1, 0, 0]], _single_tri())
    assert not bool(h.hit[0])


def test_back_face_flips_normal():
    h = _hit([[0, 0, -4]], [[0, 0, 1]], _single_tri())
    assert bool(h.hit[0])
    assert not bool(h.front_face[0]) or bool(h.front_face[0])  # defined either way
    # Normal must oppose the ray direction.
    assert float(np.asarray(h.normal[0]) @ np.asarray([0, 0, 1.0])) < 0


def test_closest_of_two_triangles():
    mesh = make_mesh(
        np.asarray([[-1, -1, -2], [1, -1, -2], [0, 1, -2],
                    [-1, -1, -5], [1, -1, -5], [0, 1, -5]]),
        np.asarray([[3, 4, 5], [0, 1, 2]]),  # far triangle listed first
    )
    h = _hit([[0, 0, 0]], [[0, 0, -1]], mesh)
    assert abs(float(h.t[0]) - 2.0) < 1e-5
    assert int(h.idx[0]) == 1


def test_icosphere_geometry():
    m = icosphere(2)
    assert m.num_triangles == 20 * 16
    # All vertices on the unit sphere -> ray from origin hits at t=1.
    h = _hit([[0, 0, 0]], [[0, 0, -1]], m)
    assert bool(h.hit[0])
    assert abs(float(h.t[0]) - 1.0) < 5e-3  # chord vs sphere surface


def test_box_and_torus_counts():
    assert box().num_triangles == 12
    assert torus(nu=16, nv=8).num_triangles == 2 * 16 * 8


def test_transform_mesh():
    m = transform_mesh(icosphere(1), scale=2.0, translate=(0, 0, -5))
    h = _hit([[0, 0, 0]], [[0, 0, -1]], m)
    assert abs(float(h.t[0]) - 3.0) < 2e-2  # surface at z = -5 + 2


def test_obj_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "tri.obj")
    with open(path, "w") as f:
        f.write("v -1 -1 -2\nv 1 -1 -2\nv 0 1 -2\nf 1 2 3\n")
    m = load_obj(path)
    assert m.num_triangles == 1
    h = _hit([[0, 0, 0]], [[0, 0, -1]], m)
    assert bool(h.hit[0]) and abs(float(h.t[0]) - 2.0) < 1e-5


def test_obj_quad_fan_and_negative_indices(tmp_path):
    path = os.path.join(tmp_path, "quad.obj")
    with open(path, "w") as f:
        f.write("v -1 -1 -2\nv 1 -1 -2\nv 1 1 -2\nv -1 1 -2\nf -4/-4 -3/-3 -2/-2 -1/-1\n")
    m = load_obj(path)
    assert m.num_triangles == 2


def test_merge_meshes_and_render():
    from gpu_ray_tracing import make_scene, merge_meshes, transform_mesh
    from gpu_ray_tracing.models.spheres import METAL, base_scene
    from gpu_ray_tracing.ops.bvh import validate_bvh

    a = transform_mesh(box(), translate=(-1.0, 0.0, -2.0))
    b = transform_mesh(icosphere(1, albedo=(0.9, 0.2, 0.2), mat_kind=METAL),
                       scale=0.5, translate=(1.0, 0.0, -2.0))
    merged = merge_meshes(a, b)
    assert merged.num_triangles == a.num_triangles + b.num_triangles
    scene = make_scene(base_scene(), merged)
    validate_bvh(scene.bvh, merged.num_triangles)
    # Rays hit each part.
    h1 = intersect_triangles(jnp.asarray([[-1.0, 0.0, 0.0]]), jnp.asarray([[0.0, 0.0, -1.0]]), merged, TMIN, TMAX)
    h2 = intersect_triangles(jnp.asarray([[1.0, 0.0, 0.0]]), jnp.asarray([[0.0, 0.0, -1.0]]), merged, TMIN, TMAX)
    assert bool(h1.hit[0]) and bool(h2.hit[0])


def test_triangle_fuzz_vs_float64_model():
    """Batched Moller-Trumbore vs an independent float64 scalar model on
    random rays and triangles."""
    rng = np.random.default_rng(5)
    n = 300
    v0 = rng.uniform(-2, 2, (n, 3))
    v1 = v0 + rng.normal(scale=1.0, size=(n, 3))
    v2 = v0 + rng.normal(scale=1.0, size=(n, 3))
    faces = np.stack([np.arange(n) * 3, np.arange(n) * 3 + 1, np.arange(n) * 3 + 2], -1)
    verts = np.empty((3 * n, 3))
    verts[0::3], verts[1::3], verts[2::3] = v0, v1, v2
    mesh = make_mesh(verts, faces)

    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    h = intersect_triangles(jnp.asarray(o), jnp.asarray(d), mesh, TMIN, TMAX)

    # Float64 reference for each (ray, all triangles).
    for r in range(0, n, 7):  # subsample rays for speed
        best_t, best_hit = TMAX, False
        for f in range(n):
            e1 = (verts[3 * f + 1] - verts[3 * f]).astype(float)
            e2 = (verts[3 * f + 2] - verts[3 * f]).astype(float)
            pvec = np.cross(d[r].astype(float), e2)
            det = e1 @ pvec
            if abs(det) < 1e-12:
                continue
            tvec = o[r].astype(float) - verts[3 * f]
            u = (tvec @ pvec) / det
            qvec = np.cross(tvec, e1)
            v = (d[r].astype(float) @ qvec) / det
            t = (e2 @ qvec) / det
            if u >= 0 and v >= 0 and u + v <= 1 and TMIN < t < best_t:
                best_t, best_hit = t, True
        assert bool(h.hit[r]) == best_hit, r
        if best_hit:
            np.testing.assert_allclose(float(h.t[r]), best_t, rtol=5e-3, atol=1e-4)


def test_smooth_vertex_normals_icosphere():
    """On a unit icosphere, the area-weighted vertex normal equals the vertex
    direction (by symmetry), and interpolation removes faceting."""
    from gpu_ray_tracing.models.mesh import icosphere

    mesh = icosphere(2, smooth=True)
    assert mesh.smooth
    # Corner normal ~ corner position (unit sphere): v1 = v0 + e1.
    v1 = np.asarray(mesh.v0 + mesh.e1)
    n1 = np.asarray(mesh.n1)
    np.testing.assert_allclose(n1, v1 / np.linalg.norm(v1, axis=-1, keepdims=True),
                               atol=0.03)
    # Flat meshes carry no corner normals.
    assert not icosphere(2).smooth


def test_smooth_normals_through_bvh_and_merge():
    from gpu_ray_tracing.models.mesh import box, icosphere, merge_meshes
    from gpu_ray_tracing.ops.bvh import build_mesh_bvh

    merged = merge_meshes(icosphere(1, smooth=True), box())
    assert merged.smooth  # flat part degraded to n0=n1=n2=face normal
    reordered, bvh = build_mesh_bvh(merged)
    assert reordered.smooth
    # Reorder keeps corner normals aligned with their faces.  Box faces are
    # axis-aligned (exactly one nonzero normal component) — no icosphere(1)
    # face is — so they identify the flat part after the BVH permutation;
    # there n0 = n1 = n2 = face normal must survive the reorder EXACTLY
    # (a permutation that misaligned corner normals with their faces would
    # break this).
    normals = np.asarray(reordered.normals)
    box_rows = np.sum(normals != 0.0, axis=-1) == 1
    assert box_rows.sum() == 12  # both box triangles per face, none missed
    for corner in (reordered.n0, reordered.n1, reordered.n2):
        np.testing.assert_array_equal(np.asarray(corner)[box_rows], normals[box_rows])
    # Smooth part: corner normals stay in their face's hemisphere.
    dots = np.sum(np.asarray(reordered.n0) * normals, axis=-1)
    assert np.all(dots > 0.0)


def test_smooth_normal_interpolation_jax_path():
    """A ray hitting a smooth icosphere returns the interpolated (near-
    spherical) normal, not the face normal."""
    from gpu_ray_tracing.models.mesh import icosphere
    from gpu_ray_tracing.ops.bvh import build_mesh_bvh
    from gpu_ray_tracing.ops.intersect import intersect_bvh

    mesh, bvh = build_mesh_bvh(icosphere(2, smooth=True))
    o = jnp.asarray([[0.0, 0.0, 3.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    h = intersect_bvh(o, d, mesh, bvh, TMIN, TMAX)
    assert bool(h.hit[0])
    # Interpolated normal at the silhouette center points back at the ray
    # almost exactly (the flat face normal would be off by the facet tilt).
    np.testing.assert_allclose(np.asarray(h.normal[0]), [0.0, 0.0, 1.0], atol=5e-3)


def test_trefoil_generator():
    """Trefoil tube: right counts, watertight (every edge shared by exactly
    two faces), and smooth corner normals roughly radial to the tube."""
    from collections import Counter

    from gpu_ray_tracing.models.mesh import trefoil

    nu, nv = 64, 12
    mesh = trefoil(nu=nu, nv=nv, smooth=True)
    assert mesh.num_triangles == 2 * nu * nv
    assert mesh.smooth
    v0 = np.asarray(mesh.v0)
    v1 = v0 + np.asarray(mesh.e1)
    v2 = v0 + np.asarray(mesh.e2)
    verts = np.concatenate([v0, v1, v2])
    # Dedup by distance (f32 storage can straddle any fixed rounding grid).
    uniq, inv = np.unique(np.round(verts / 1e-4) * 1e-4, axis=0, return_inverse=True)
    if len(uniq) != nu * nv:  # grid straddle: merge near-duplicates
        # Chunked O(n^2) distance pass (n = 4608) — no extra dependencies.
        v32 = verts.astype(np.float32)  # pragma: no cover
        canon = np.empty(len(v32), np.int64)  # pragma: no cover
        for s in range(0, len(v32), 512):  # pragma: no cover
            d2 = np.sum((v32[s:s + 512, None, :] - v32[None, :, :]) ** 2, axis=-1)
            canon[s:s + 512] = np.argmax(d2 < 1e-6, axis=1)  # first within 1e-3
        _, inv = np.unique(canon, return_inverse=True)  # pragma: no cover
        uniq = np.unique(canon)  # pragma: no cover
    assert len(uniq) == nu * nv  # shared vertices, wrap-closed both ways
    f = inv.reshape(3, -1).T
    edges = Counter()
    for a, b, c in f:
        for e in ((a, b), (b, c), (c, a)):
            edges[tuple(sorted(e))] += 1
    assert set(edges.values()) == {2}  # watertight manifold
    # Smooth normals point outward from the tube: dot(corner normal,
    # geometric normal) > 0 everywhere.
    dots = np.sum(np.asarray(mesh.n0) * np.asarray(mesh.normals), axis=-1)
    assert np.all(dots > 0.2)
