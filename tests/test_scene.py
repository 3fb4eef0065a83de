"""Tests for the scene model and generators (sphere.rs:45-153)."""

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing.models.spheres import (
    DIELECTRIC,
    LAMBERTIAN,
    METAL,
    base_scene,
    make_spheres,
    one_weekend_scene,
    pack_materials,
    unpack_materials,
)


def test_base_scene_layout():
    s = base_scene()
    assert s.count == 3
    assert s.centers.shape == (3, 3)
    assert int(jnp.sum(s.mat_kind == METAL)) == 1


def test_one_weekend_scene_structure():
    s = one_weekend_scene(jax.random.key(0))
    # Ground + up-to-196 grid + 3 heroes; exclusion zone removes a few.
    assert 150 <= s.count <= 200
    c = np.asarray(s.centers)
    r = np.asarray(s.radii)
    k = np.asarray(s.mat_kind)
    # Ground sphere first (sphere.rs:49-55).
    np.testing.assert_allclose(c[0], [0, -1000, 0], atol=1e-6)
    assert r[0] == 1000.0
    # Hero spheres last (sphere.rs:114-136).
    np.testing.assert_allclose(c[-3], [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(c[-2], [-4, 1, 0], atol=1e-6)
    np.testing.assert_allclose(c[-1], [4, 1, 0], atol=1e-6)
    assert k[-3] == DIELECTRIC and k[-2] == LAMBERTIAN and k[-1] == METAL
    # All grid spheres have r=0.2 and sit at y=0.2 (sphere.rs:62-66).
    np.testing.assert_allclose(r[1:-3], 0.2, atol=1e-6)
    np.testing.assert_allclose(c[1:-3, 1], 0.2, atol=1e-6)


def test_one_weekend_exclusion_zone():
    """Grid spheres within 0.9 of (4, 0.2, 0) are skipped (sphere.rs:69)."""
    s = one_weekend_scene(jax.random.key(3))
    c = np.asarray(s.centers)[1:-3]
    dist = np.linalg.norm(c - np.array([4.0, 0.2, 0.0]), axis=-1)
    assert np.all(dist > 0.9)


def test_one_weekend_material_mix():
    """Material roll: ~80% diffuse, ~15% metal, ~5% glass (sphere.rs:70-108)."""
    counts = {LAMBERTIAN: 0, METAL: 0, DIELECTRIC: 0}
    total = 0
    for seed in range(5):
        s = one_weekend_scene(jax.random.key(seed))
        k = np.asarray(s.mat_kind)[1:-3]
        for kind in counts:
            counts[kind] += int(np.sum(k == kind))
        total += len(k)
    assert abs(counts[LAMBERTIAN] / total - 0.80) < 0.08
    assert abs(counts[METAL] / total - 0.15) < 0.07
    assert abs(counts[DIELECTRIC] / total - 0.05) < 0.05
    # Metal fuzz in [0, 0.5) (sphere.rs:91); glass ior 1.5 (sphere.rs:105).
    s = one_weekend_scene(jax.random.key(0))
    p = np.asarray(s.mat_param)
    k = np.asarray(s.mat_kind)
    assert np.all(p[k == METAL] < 0.5) and np.all(p[k == METAL] >= 0.0)
    np.testing.assert_allclose(p[k == DIELECTRIC], 1.5)


def test_one_weekend_reproducible():
    a = one_weekend_scene(jax.random.key(7))
    b = one_weekend_scene(jax.random.key(7))
    np.testing.assert_array_equal(np.asarray(a.centers), np.asarray(b.centers))
    c = one_weekend_scene(jax.random.key(8))
    assert not np.array_equal(np.asarray(a.centers), np.asarray(c.centers))


def test_full_book_scene_size():
    """grid_min/max = -11..11 gives the ~480-sphere BASELINE config-3 scene."""
    s = one_weekend_scene(jax.random.key(0), grid_min=-11, grid_max=11)
    assert 400 <= s.count <= 488


def test_material_pack_unpack_roundtrip():
    """pack/unpack must invert each other through the albedo.w convention
    (sphere.rs:53,96,105 / wgsl:77-79)."""
    s = make_spheres(
        [
            ((0, 0, 0), 1.0, LAMBERTIAN, (0.1, 0.2, 0.3), 0.0),
            ((1, 0, 0), 1.0, METAL, (0.9, 0.8, 0.7), 0.25),
            ((2, 0, 0), 1.0, DIELECTRIC, (1.0, 1.0, 1.0), 1.5),
        ]
    )
    packed = pack_materials(s)
    np.testing.assert_allclose(packed[0], [0.1, 0.2, 0.3, -2.0], atol=1e-6)
    np.testing.assert_allclose(packed[1], [0.9, 0.8, 0.7, 0.25], atol=1e-6)
    np.testing.assert_allclose(packed[2], [1.5, 0.0, 0.0, 2.0], atol=1e-6)

    s2 = unpack_materials(np.asarray(s.centers), np.asarray(s.radii), packed)
    np.testing.assert_array_equal(np.asarray(s2.mat_kind), np.asarray(s.mat_kind))
    np.testing.assert_allclose(np.asarray(s2.mat_param), np.asarray(s.mat_param))
    np.testing.assert_allclose(np.asarray(s2.albedo), np.asarray(s.albedo))


def test_make_spheres_rejects_empty():
    """A zero-sphere SoA would die deep in the closest-hit argmin with an
    opaque shape error; the boundary rejects it eagerly."""
    import pytest

    with pytest.raises(ValueError, match="at least one sphere"):
        make_spheres([])


def test_pad_to_multiple():
    s = base_scene().pad_to_multiple(128)
    assert s.count == 128
    assert float(jnp.sum(s.radii > 0)) == 3


def test_nee_mesh_scene_renders_under_jit():
    """NEE with a non-emissive mesh + sphere lights must work through the
    jitted public API: the emissive-mesh-face rejection is STATIC metadata
    (make_scene's mesh_has_emissive flag), not a traced-array inspection —
    inspecting the traced mat_kind raised TracerArrayConversionError on
    every such render (review-confirmed crash)."""
    import pytest

    from gpu_ray_tracing import (
        CameraSettings,
        RenderConfig,
        icosphere,
        make_scene,
        render,
        transform_mesh,
    )
    from gpu_ray_tracing.models.spheres import EMISSIVE, LAMBERTIAN, make_spheres

    ground = make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 3.0, 0.0), 0.5, EMISSIVE, (1.0, 0.9, 0.8), 5.0),
    ])
    mesh = transform_mesh(icosphere(1, albedo=(0.7, 0.5, 0.3)),
                          scale=0.6, translate=(0.0, 0.6, 0.0))
    scene = make_scene(ground, mesh)
    assert scene.mesh_has_emissive is False
    cam = CameraSettings(
        look_from=jnp.asarray([0.0, 1.0, 4.0]),
        look_at=jnp.asarray([0.0, 0.5, 0.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]),
        field_of_view=jnp.float32(45.0),
        defocus_angle=jnp.float32(0.0),
        focus_distance=jnp.float32(4.0),
    )
    for backend in ("jax", "pallas"):
        cfg = RenderConfig(width=32, height=24, spp=1, max_depth=4, nee=True,
                           sky_intensity=0.0, backend=backend)
        img = np.asarray(render(scene, cam, cfg, frame_seed=jnp.uint32(1)))
        assert np.isfinite(img).all()

    # An emissive mesh with MORE lights than the <= 4-total static NEE
    # loop supports takes the combined pick-one estimator (r4: emissive
    # faces JOIN the light list — this 80-face icosphere plus the sphere
    # light makes 81 ordinals; see test_tri_lights.py for estimator
    # validation).
    em_mesh = transform_mesh(
        icosphere(1, albedo=(1.0, 0.9, 0.8), mat_kind=EMISSIVE, mat_param=4.0),
        scale=0.6, translate=(0.0, 0.6, 0.0))
    em_scene = make_scene(ground, em_mesh)
    assert em_scene.mesh_has_emissive is True
    assert em_scene.tri_lights.count == 80
    cfg = RenderConfig(width=32, height=24, spp=1, max_depth=4, nee=True,
                       sky_intensity=0.0)
    img = np.asarray(render(em_scene, cam, cfg, frame_seed=jnp.uint32(1)))
    assert np.isfinite(img).all() and img.mean() > 1e-3

    # A DIRECTLY-constructed Scene (bypassing make_scene) with a CONCRETE
    # mesh derives the flag in __post_init__ (advisor finding r2 + review
    # refinement r3); a non-emissive direct Scene keeps working even when
    # the caller wraps render in their own jit (the flag rides along as
    # static pytree metadata, so tracing never needs to inspect the mesh).
    import dataclasses

    direct = dataclasses.replace(em_scene, mesh_has_emissive=None)
    assert direct.mesh_has_emissive is True  # re-derived at construction
    # A hand-built emissive-mesh Scene that SKIPPED tri-light extraction
    # must refuse (it would silently drop the mesh lights from NEE).
    no_tl = dataclasses.replace(em_scene, tri_lights=None)
    with pytest.raises(ValueError, match="tri_lights"):
        render(no_tl, cam, cfg, frame_seed=jnp.uint32(1))

    from gpu_ray_tracing.models.scene import Scene

    plain = Scene(spheres=scene.spheres, mesh=scene.mesh, bvh=scene.bvh,
                  lights=scene.lights, bvh_leaf_size=scene.bvh_leaf_size)
    assert plain.mesh_has_emissive is False  # derived, not guessed
    cfg_j = RenderConfig(width=32, height=24, spp=1, max_depth=4, nee=True,
                         sky_intensity=0.0)
    jitted = jax.jit(lambda s: render(s, cam, cfg_j, frame_seed=jnp.uint32(1)))
    assert np.isfinite(np.asarray(jitted(plain))).all()

    # Only a Scene whose mat_kind is ALREADY traced at construction (built
    # inside someone else's jit with the flag unset) still refuses to
    # guess at the nee guard.
    def build_traced_kind(mk):
        traced_mesh = dataclasses.replace(scene.mesh, mat_kind=mk)
        s = Scene(spheres=scene.spheres, mesh=traced_mesh, bvh=scene.bvh,
                  lights=scene.lights, bvh_leaf_size=scene.bvh_leaf_size,
                  mesh_has_emissive=None)
        return render(s, cam, cfg_j, frame_seed=jnp.uint32(1))

    with pytest.raises(ValueError, match="make_scene"):
        jax.jit(build_traced_kind)(scene.mesh.mat_kind)


def test_pallas_spp_zero_rejected():
    import pytest

    from gpu_ray_tracing import CameraSettings, base_scene
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops.pallas.megakernel import render_pallas

    cam = derive_camera(CameraSettings.default(), 16, 8)
    with pytest.raises(ValueError, match="spp"):
        render_pallas(base_scene(), cam, width=16, height=8,
                      sample_index=jnp.uint32(0), frame_seed=jnp.uint32(0),
                      max_depth=3, t_min=1e-3, spp=0)
