"""Tests for the threaded BVH build (ops/bvh.py) and stackless traversal."""

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing.models.mesh import box, icosphere, torus, transform_mesh
from gpu_ray_tracing.models.scene import intersect_scene, make_scene
from gpu_ray_tracing.models.spheres import LAMBERTIAN, METAL, base_scene, make_spheres
from gpu_ray_tracing.ops.bvh import build_mesh_bvh, validate_bvh
from gpu_ray_tracing.ops.intersect import intersect_bvh, intersect_triangles

TMIN, TMAX = 1e-3, 3.4e35


def test_bvh_structure_valid():
    for mesh in [box(), icosphere(2), torus(nu=12, nv=6)]:
        reordered, bvh = build_mesh_bvh(mesh, leaf_size=4)
        validate_bvh(bvh, mesh.num_triangles)
        assert reordered.num_triangles == mesh.num_triangles


def test_bvh_root_bounds_contain_mesh():
    mesh = icosphere(2)
    _, bvh = build_mesh_bvh(mesh)
    bmin = np.asarray(bvh.bbox_min[0])
    bmax = np.asarray(bvh.bbox_max[0])
    np.testing.assert_array_compare(np.less_equal, bmin, [-1, -1, -1] + np.ones(3) * 1e-5)
    assert np.all(bmax >= 1.0 - 1e-5)


def test_bvh_traversal_matches_bruteforce():
    """The BVH closest hit must EXACTLY match the brute-force triangle scan
    on random rays (same t, same face, same normal)."""
    mesh = icosphere(2)
    reordered, bvh = build_mesh_bvh(mesh, leaf_size=4)
    rng = np.random.default_rng(0)
    origins = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    dirs = rng.normal(size=(500, 3)).astype(np.float32)

    a = intersect_bvh(jnp.asarray(origins), jnp.asarray(dirs), reordered, bvh, TMIN, TMAX)
    b = intersect_triangles(jnp.asarray(origins), jnp.asarray(dirs), reordered, TMIN, TMAX)
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    hits = np.asarray(a.hit)
    np.testing.assert_allclose(
        np.asarray(a.t)[hits], np.asarray(b.t)[hits], rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(a.idx)[hits], np.asarray(b.idx)[hits])


def test_bvh_rays_from_inside():
    mesh = icosphere(3)
    reordered, bvh = build_mesh_bvh(mesh)
    rng = np.random.default_rng(1)
    dirs = rng.normal(size=(100, 3)).astype(np.float32)
    origins = np.zeros((100, 3), np.float32)
    h = intersect_bvh(jnp.asarray(origins), jnp.asarray(dirs), reordered, bvh, TMIN, TMAX)
    assert np.asarray(h.hit).all()  # closed surface: every inside ray hits
    np.testing.assert_allclose(np.asarray(h.t) * np.linalg.norm(dirs, axis=-1), 1.0, atol=5e-3)
    assert not np.asarray(h.front_face).any()  # inside -> back faces


def test_bvh_axis_aligned_rays_hit_box():
    """Rays exactly parallel to box faces (zero direction components) must
    not break the slab test."""
    mesh = transform_mesh(box(), translate=(0, 0, -3))
    reordered, bvh = build_mesh_bvh(mesh)
    h = intersect_bvh(
        jnp.asarray([[0.0, 0.0, 0.0]]), jnp.asarray([[0.0, 0.0, -1.0]]),
        reordered, bvh, TMIN, TMAX,
    )
    assert bool(h.hit[0])
    assert abs(float(h.t[0]) - 2.5) < 1e-5


def test_scene_union_sphere_and_mesh():
    """Closest-hit race between a sphere and a mesh is decided per ray."""
    spheres = make_spheres([((0, 0, -2.0), 0.5, METAL, (1, 1, 1), 0.0)])
    mesh = transform_mesh(box(size=(1, 1, 1)), translate=(0, 0, -5))
    scene = make_scene(spheres, mesh)
    o = jnp.asarray([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], jnp.float32)
    hit, albedo, kind, param = intersect_scene(o, d, scene, TMIN, TMAX)
    # Ray 0: sphere (t=1.5) in front of box (t=4.5).
    assert bool(hit.hit[0]) and abs(float(hit.t[0]) - 1.5) < 1e-5
    assert int(kind[0]) == METAL
    # Ray 1: misses both.
    assert not bool(hit.hit[1])


def test_scene_union_mesh_wins():
    spheres = make_spheres([((0, 0, -9.0), 0.5, METAL, (1, 1, 1), 0.0)])
    mesh = transform_mesh(box(size=(2, 2, 2)), translate=(0, 0, -5))
    scene = make_scene(spheres, mesh)
    o = jnp.asarray([[0.0, 0.0, 0.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    hit, albedo, kind, param = intersect_scene(o, d, scene, TMIN, TMAX)
    assert bool(hit.hit[0]) and abs(float(hit.t[0]) - 4.0) < 1e-5
    assert int(kind[0]) == LAMBERTIAN  # box default material


def test_render_mesh_scene_end_to_end():
    """BASELINE config-4 slice: render a BVH mesh scene through the API."""
    import gpu_ray_tracing as rt

    spheres = base_scene()
    mesh = transform_mesh(icosphere(2, albedo=(0.8, 0.4, 0.2)), scale=0.4,
                          translate=(0.6, 0.0, -1.0))
    scene = make_scene(spheres, mesh)
    cam = rt.CameraSettings(
        look_from=jnp.asarray([0.0, 0.0, 1.0]),
        look_at=jnp.asarray([0.0, 0.0, -1.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(60.0),
        defocus_angle=jnp.float32(0.0),
        focus_distance=jnp.float32(2.0),
    )
    cfg = rt.RenderConfig(width=48, height=36, spp=2, max_depth=5)
    img = np.asarray(rt.render(scene, cam, cfg, frame_seed=jnp.uint32(0)))
    assert img.shape == (36, 48, 3)
    assert np.all(np.isfinite(img))
    # Normal integrator too.
    cfgn = rt.RenderConfig(width=48, height=36, spp=1, integrator="normal")
    imgn = np.asarray(rt.render(scene, cam, cfgn, frame_seed=jnp.uint32(0)))
    assert np.all(np.isfinite(imgn))
    # The orange mesh must be visible: some pixels differ from the
    # spheres-only render.
    imgs = np.asarray(rt.render(base_scene(), cam, cfgn, frame_seed=jnp.uint32(0)))
    assert np.abs(imgn - imgs).max() > 0.1


def test_pallas_backend_renders_mesh():
    """Mesh scenes run through the megakernel's in-kernel BVH traversal."""
    import gpu_ray_tracing as rt

    scene = make_scene(base_scene(), transform_mesh(box(), translate=(0.5, 0.0, -1.0)))
    cfg = rt.RenderConfig(width=32, height=16, spp=1, max_depth=3, backend="pallas")
    img = np.asarray(
        rt.render(scene, rt.CameraSettings.default(), cfg, frame_seed=jnp.uint32(0))
    )
    assert img.shape == (16, 32, 3)
    assert np.all(np.isfinite(img))
