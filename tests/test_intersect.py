"""Tests for sphere intersection (wgsl:164-221, 158-162)."""

import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing.models.spheres import LAMBERTIAN, make_spheres
from gpu_ray_tracing.ops.intersect import intersect_spheres

TMIN, TMAX = 1e-3, 3.4e35


def _unit_sphere(center=(0.0, 0.0, -3.0), radius=1.0):
    return make_spheres([(center, radius, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])


def _hit(origins, dirs, spheres, tmin=TMIN, tmax=TMAX):
    return intersect_spheres(
        jnp.asarray(origins, jnp.float32), jnp.asarray(dirs, jnp.float32), spheres, tmin, tmax
    )


def test_head_on_hit():
    h = _hit([[0, 0, 0]], [[0, 0, -1]], _unit_sphere())
    assert bool(h.hit[0])
    assert abs(float(h.t[0]) - 2.0) < 1e-5
    np.testing.assert_allclose(np.asarray(h.point[0]), [0, 0, -2], atol=1e-5)
    np.testing.assert_allclose(np.asarray(h.normal[0]), [0, 0, 1], atol=1e-5)
    assert bool(h.front_face[0])


def test_non_unit_direction_same_geometry():
    """Directions are not normalized (wgsl:322): t scales, geometry doesn't."""
    h = _hit([[0, 0, 0]], [[0, 0, -4]], _unit_sphere())
    assert bool(h.hit[0])
    assert abs(float(h.t[0]) - 0.5) < 1e-5  # t in units of |d|=4
    np.testing.assert_allclose(np.asarray(h.point[0]), [0, 0, -2], atol=1e-5)


def test_miss():
    h = _hit([[0, 0, 0]], [[0, 1, 0]], _unit_sphere())
    assert not bool(h.hit[0])
    assert float(h.t[0]) == np.float32(TMAX)


def test_tangent_grazing():
    # Ray along x at y=1 grazes the unit sphere at origin-centered z... use
    # sphere at (0,0,-3): ray from (1, 0, 0) dir (0,0,-1) passes at distance 1.
    h = _hit([[1, 0, 0]], [[0, 0, -1]], _unit_sphere())
    # Tangent: discriminant == 0, both roots equal; near root t=3 valid.
    assert bool(h.hit[0])
    assert abs(float(h.t[0]) - 3.0) < 1e-2


def test_inside_sphere_uses_far_root_and_back_face():
    """Origin inside the sphere: near root < tmin is rejected, far root wins
    (wgsl:195-200); the outward normal is flipped (wgsl:158-162)."""
    h = _hit([[0, 0, -3]], [[0, 0, -1]], _unit_sphere())
    assert bool(h.hit[0])
    assert abs(float(h.t[0]) - 1.0) < 1e-5
    assert not bool(h.front_face[0])
    # Outward normal at (0,0,-4) is (0,0,-1); flipped toward the ray: (0,0,1).
    np.testing.assert_allclose(np.asarray(h.normal[0]), [0, 0, 1], atol=1e-5)


def test_tmin_guard_rejects_self_intersection():
    """A ray starting exactly on the surface must not re-hit at t=0."""
    h = _hit([[0, 0, -2]], [[0, 0, -1]], _unit_sphere())
    assert bool(h.hit[0])
    # It should hit the far side at t=2, not itself at t=0.
    assert abs(float(h.t[0]) - 2.0) < 1e-4


def test_closest_of_many_spheres():
    spheres = make_spheres(
        [
            ((0, 0, -10), 1.0, LAMBERTIAN, (1, 0, 0), 0.0),
            ((0, 0, -5), 1.0, LAMBERTIAN, (0, 1, 0), 0.0),
            ((0, 0, -20), 1.0, LAMBERTIAN, (0, 0, 1), 0.0),
        ]
    )
    h = _hit([[0, 0, 0]], [[0, 0, -1]], spheres)
    assert int(h.idx[0]) == 1
    assert abs(float(h.t[0]) - 4.0) < 1e-5


def test_matches_bruteforce_reference_scan():
    """Vectorized masked-argmin closest hit == sequential shrinking-window scan
    (the wgsl:164-180 algorithm) on random rays and spheres."""
    rng = np.random.default_rng(0)
    n_spheres, n_rays = 40, 200
    centers = rng.uniform(-5, 5, (n_spheres, 3)).astype(np.float32)
    radii = rng.uniform(0.2, 1.5, n_spheres).astype(np.float32)
    spheres = make_spheres(
        [
            (tuple(centers[i]), float(radii[i]), LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)
            for i in range(n_spheres)
        ]
    )
    origins = rng.uniform(-8, 8, (n_rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(n_rays, 3)).astype(np.float32)

    h = _hit(origins, dirs, spheres)

    # Sequential scan in float64 (reference semantics, tighter arithmetic).
    for r in range(n_rays):
        closest = TMAX
        hit_any = False
        for i in range(n_spheres):
            oc = centers[i].astype(float) - origins[r].astype(float)
            d = dirs[r].astype(float)
            a = d @ d
            hh = oc @ d
            c = oc @ oc - float(radii[i]) ** 2
            disc = hh * hh - a * c
            if disc < 0:
                continue
            sq = np.sqrt(disc)
            root = (hh - sq) / a
            if root <= TMIN or closest <= root:
                root = (hh + sq) / a
                if root <= TMIN or closest <= root:
                    continue
            closest = root
            hit_any = True
        assert bool(h.hit[r]) == hit_any, r
        if hit_any:
            np.testing.assert_allclose(float(h.t[r]), closest, rtol=2e-3, atol=1e-4)


def test_padded_spheres_are_inert():
    s = _unit_sphere().pad_to(64)
    assert s.count == 64
    h_pad = _hit([[0, 0, 0]], [[0, 0, -1]], s)
    h_ref = _hit([[0, 0, 0]], [[0, 0, -1]], _unit_sphere())
    assert bool(h_pad.hit[0]) and abs(float(h_pad.t[0]) - float(h_ref.t[0])) < 1e-6
    # A ray through the pad spheres' location (origin) must not hit them.
    h_miss = _hit([[5, 5, 5]], [[-1, -1, -1]], s, tmin=1e-3, tmax=0.5)
    assert not bool(h_miss.hit[0])


def test_batch_shape_preserved():
    h = _hit(np.zeros((4, 6, 3), np.float32), np.tile([0, 0, -1.0], (4, 6, 1)), _unit_sphere())
    assert h.t.shape == (4, 6)
    assert h.normal.shape == (4, 6, 3)
    assert bool(jnp.all(h.hit))
