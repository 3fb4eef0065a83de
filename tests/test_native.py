"""Tests for the native C++ binned-SAH BVH builder."""

import numpy as np
import pytest

from gpu_ray_tracing import native
from gpu_ray_tracing.models.mesh import icosphere, torus
from gpu_ray_tracing.ops.bvh import build_mesh_bvh, validate_bvh
from gpu_ray_tracing.ops.intersect import intersect_bvh

import jax.numpy as jnp

TMIN, TMAX = 1e-3, 3.4e35

native_only = pytest.mark.skipif(
    not native.available(), reason=f"native builder unavailable: {native.build_error()}"
)


@native_only
def test_native_builder_compiles_and_loads():
    assert native.available()


@native_only
def test_native_bvh_structure_valid():
    for mesh in [icosphere(2), torus(nu=12, nv=6)]:
        _, bvh = build_mesh_bvh(mesh, method="native")
        validate_bvh(bvh, mesh.num_triangles)


@native_only
def test_native_and_numpy_traversals_agree():
    """Different trees (SAH vs median) must produce identical closest hits."""
    mesh = icosphere(3)
    rm_n, bvh_n = build_mesh_bvh(mesh, method="native")
    rm_p, bvh_p = build_mesh_bvh(mesh, method="numpy")
    rng = np.random.default_rng(0)
    o = rng.uniform(-3, 3, (400, 3)).astype(np.float32)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    a = intersect_bvh(jnp.asarray(o), jnp.asarray(d), rm_n, bvh_n, TMIN, TMAX)
    b = intersect_bvh(jnp.asarray(o), jnp.asarray(d), rm_p, bvh_p, TMIN, TMAX)
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    hits = np.asarray(a.hit)
    np.testing.assert_allclose(np.asarray(a.t)[hits], np.asarray(b.t)[hits], rtol=1e-5)
    # Hit points must coincide (face indices may differ across shared edges).
    np.testing.assert_allclose(
        np.asarray(a.point)[hits], np.asarray(b.point)[hits], rtol=1e-4, atol=1e-5
    )


@native_only
def test_native_sah_produces_fewer_node_visits():
    """SAH trees should bound the mesh at least as tightly: check the total
    surface area of nodes is no larger than the median-split tree's (a proxy
    for traversal cost)."""
    mesh = torus(nu=32, nv=16)
    _, bvh_n = build_mesh_bvh(mesh, method="native")
    _, bvh_p = build_mesh_bvh(mesh, method="numpy")

    def total_area(b):
        ext = np.maximum(np.asarray(b.bbox_max) - np.asarray(b.bbox_min), 0)
        return float(
            (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]).sum()
        )

    assert total_area(bvh_n) <= total_area(bvh_p) * 1.1


@native_only
def test_native_single_primitive():
    from gpu_ray_tracing.ops.bvh import build_bvh

    bvh, order = build_bvh(
        np.zeros((1, 3)), np.zeros((1, 3)) - 1, np.zeros((1, 3)) + 1, method="native"
    )
    validate_bvh(bvh, 1)
    assert list(order) == [0]


def test_numpy_fallback_always_works():
    mesh = icosphere(1)
    _, bvh = build_mesh_bvh(mesh, method="numpy")
    validate_bvh(bvh, mesh.num_triangles)


def test_native_adversarial_depth_no_stack_overflow():
    """Exponentially skewed centroid spacing makes SAH peel a handful of
    primitives per level -> O(n)-depth trees; the builder must survive
    (iterative job stack, not C recursion) and emit a valid layout."""
    from gpu_ray_tracing.ops.bvh import build_bvh

    n = 20000
    x = np.linspace(0, 1, n) ** 8 * 1e12
    c = np.stack([x, np.zeros(n), np.zeros(n)], -1)
    bvh, order = build_bvh(c, c - 0.1, c + 0.1, leaf_size=1, method="native")
    validate_bvh(bvh, n)
    assert bvh.num_nodes == 2 * n - 1  # every leaf holds one primitive


def test_build_bvh_validates_inputs():
    import pytest

    from gpu_ray_tracing.ops.bvh import build_bvh

    z = np.zeros((0, 3))
    with pytest.raises(ValueError, match="zero primitives"):
        build_bvh(z, z, z)
    c = np.zeros((4, 3))
    with pytest.raises(ValueError, match="leaf_size"):
        build_bvh(c, c - 1, c + 1, leaf_size=0)


def test_f32_bounds_round_outward():
    """Narrowing float64 primitive bounds to f32 must round outward so no
    node box shrinks below the extent it covers (a grazing hit culled by a
    half-ulp-short box is a BVH-vs-brute mismatch)."""
    from gpu_ray_tracing.ops.bvh import build_bvh

    # Values chosen to NOT be f32-representable.
    hi = 1.0 + 1e-9
    lo = -1.0 - 1e-9
    c = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    bvh, _ = build_bvh(c, np.full((2, 3), lo), np.full((2, 3), hi),
                       method="numpy")
    root_min = np.asarray(bvh.bbox_min)[0].astype(np.float64)
    root_max = np.asarray(bvh.bbox_max)[0].astype(np.float64)
    assert np.all(root_min <= lo) and np.all(root_max >= hi)


def test_transform_mesh_rejects_negative_scale():
    import pytest

    from gpu_ray_tracing.models.mesh import transform_mesh

    with pytest.raises(ValueError, match="scale"):
        transform_mesh(icosphere(1), scale=-1.0)
