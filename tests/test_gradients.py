"""Finite-difference gradient correctness for the r4 estimator surface.

Inverse rendering is an advertised capability (examples/inverse_rendering.py,
api.py custom VJP); the newest estimator terms — the triangle-light NEE+MIS
pdf and the > 4-light combined-pick scaling — previously had only
finiteness tests.  These tests check d(loss)/d(albedo, emission) against
central finite differences on the SAME deterministic sample stream (the
counter-based hash RNG makes the loss an exact deterministic function of
its parameters, so FD is noise-free up to f32 rounding), on both the jax
path and the Pallas custom-VJP route (api.py: the backward pass replays
the jax integrator on the identical stream).

Perturbation discipline: emission lives in TWO places by design —
the BSDF-hit side reads albedo * mat_param at the hit, the NEE side reads
the extracted Lights/TriLights.emission (make_scene extracts them
host-side because light counts must be static).  A differentiable loss
must scale both consistently; `_scaled_scene` is the one place that does.

Non-differentiable corners (documented, by construction): hit decisions,
the MIS light-id match, and the > 4-light pick index are discrete —
gradients hold them fixed (straight-through estimator, SURVEY §7 hard
part 4).  Perturbing emission or albedo moves no geometry, so FD and
autodiff see the same fixed decisions here.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing import RenderConfig, make_scene, render
from gpu_ray_tracing.models.camera import derive_camera
from gpu_ray_tracing.models.mesh import make_mesh
from gpu_ray_tracing.models.spheres import (
    EMISSIVE,
    LAMBERTIAN,
    make_spheres,
)
from gpu_ray_tracing.ops import rays as rays_ops
from gpu_ray_tracing.ops.integrators import trace_path
from tests.test_api import BASE_CAMERA

W, H = 24, 16


def _quad_light(y, half, le):
    verts = np.array(
        [[-half, y, -2.0 - half], [half, y, -2.0 - half],
         [half, y, -2.0 + half], [-half, y, -2.0 + half]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return make_mesh(verts, faces, albedo=(1.0, 0.9, 0.8),
                     mat_kind=EMISSIVE, mat_param=le)


def _tri_light_scene():
    spheres = make_spheres([
        ((0.0, -1000.0, 0.0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((0.3, 0.4, -2.0), 0.4, LAMBERTIAN, (0.4, 0.5, 0.8), 0.0),
    ])
    return make_scene(spheres, _quad_light(1.8, 0.7, 6.0))


def _many_lights_scene():
    from benchmarks.parity_check import _many_lights_scene as build

    return build()


def _scaled_scene(scene, s, a):
    """Scale every emission source by `s` and set the floor albedo's red
    channel to `a` — consistently across the BSDF-hit fields (albedo /
    mat_param) and the extracted NEE light lists."""
    sp = scene.spheres
    emis_sp = sp.mat_kind == EMISSIVE
    albedo = sp.albedo.at[0, 0].set(a)  # sphere 0 = the floor (no reorder
    # happens below the sphere-BVH threshold; asserted in the tests)
    sp = dataclasses.replace(
        sp, albedo=albedo,
        mat_param=jnp.where(emis_sp, sp.mat_param * s, sp.mat_param))
    out = dataclasses.replace(scene, spheres=sp)
    if scene.lights is not None:
        out = dataclasses.replace(
            out, lights=dataclasses.replace(
                scene.lights, emission=scene.lights.emission * s))
    if scene.mesh is not None:
        emis_f = scene.mesh.mat_kind == EMISSIVE
        out = dataclasses.replace(
            out, mesh=dataclasses.replace(
                scene.mesh,
                mat_param=jnp.where(emis_f, scene.mesh.mat_param * s,
                                    scene.mesh.mat_param)))
    if scene.tri_lights is not None:
        out = dataclasses.replace(
            out, tri_lights=dataclasses.replace(
                scene.tri_lights, emission=scene.tri_lights.emission * s))
    return out


def _make_loss(scene, spp=2, depth=3, mis=True):
    cam = derive_camera(BASE_CAMERA, W, H)
    wkey = jax.random.key(5)
    weights = jax.random.uniform(wkey, (H, W, 3))

    @partial(jax.jit, static_argnames=())
    def loss(s, a):
        sc = _scaled_scene(scene, s, a)

        def body(k, acc):
            o, d, seeds = rays_ops.generate_rays_hash(
                cam, W, H, jnp.uint32(k), jnp.uint32(3))
            return acc + trace_path(
                o, d, sc, depth, 1e-3, 3.4e35, pixel_seeds=seeds,
                sky_intensity=0.0, nee=True, mis=mis)

        img = jax.lax.fori_loop(0, spp, body,
                                jnp.zeros((H, W, 3), jnp.float32)) / spp
        return jnp.sum(img * weights)

    return loss


def _fd_check(loss, s0=1.0, a0=0.7, eps=2e-2, rtol=0.05):
    gs, ga = jax.grad(loss, argnums=(0, 1))(jnp.float32(s0), jnp.float32(a0))
    fd_s = (loss(jnp.float32(s0 + eps), jnp.float32(a0))
            - loss(jnp.float32(s0 - eps), jnp.float32(a0))) / (2 * eps)
    fd_a = (loss(jnp.float32(s0), jnp.float32(a0 + eps))
            - loss(jnp.float32(s0), jnp.float32(a0 - eps))) / (2 * eps)
    gs, ga, fd_s, fd_a = map(float, (gs, ga, fd_s, fd_a))
    assert abs(gs) > 1e-6 and abs(ga) > 1e-6, (gs, ga)  # non-trivial
    assert abs(gs - fd_s) <= rtol * abs(fd_s), ("emission", gs, fd_s)
    assert abs(ga - fd_a) <= rtol * abs(fd_a), ("albedo", ga, fd_a)
    return gs, ga


def test_fd_tri_light_nee_mis():
    """d(image)/d(emission, albedo) through triangle-light NEE+MIS (the r4
    tri-light pdf terms) agrees with central finite differences."""
    scene = _tri_light_scene()
    assert scene.tri_lights is not None and scene.tri_lights.count == 2
    assert scene.sphere_bvh is None  # sphere 0 stays the floor
    _fd_check(_make_loss(scene))


def test_fd_tri_light_nee_only():
    """Same scene without MIS (plain tri-light NEE area sampling)."""
    scene = _tri_light_scene()
    _fd_check(_make_loss(scene, mis=False))


def test_fd_combined_pick_mis():
    """d/d(emission, albedo) through the > 4-light combined pick-one
    estimator (81 ordinals: sphere + triangle lights, pick-pdf-scaled MIS
    weights) agrees with finite differences — the pick INDEX stream is
    parameter-independent, so the estimator is differentiable through the
    picked terms."""
    scene = _many_lights_scene()
    assert scene.lights is not None and scene.tri_lights is not None
    assert scene.lights.count + scene.tri_lights.count > 4
    assert scene.sphere_bvh is None
    _fd_check(_make_loss(scene, spp=2, depth=3))


def test_pallas_vjp_matches_jax_grad():
    """The Pallas custom-VJP route (api.py: backward replays the jax
    integrator on the identical stream) produces the jax backend's
    gradients for a tri-light NEE+MIS render — d(loss)/d(scene) down to
    the light-list leaves."""
    scene = _tri_light_scene()
    cfg_kw = dict(width=W, height=H, spp=2, max_depth=3, sky_intensity=0.0,
                  nee=True, mis=True)
    weights = jax.random.uniform(jax.random.key(5), (H, W, 3))

    grads = {}
    for be in ("jax", "pallas"):
        cfg = RenderConfig(backend=be, **cfg_kw)

        def loss(sc, cfg=cfg):
            img = render(sc, BASE_CAMERA, cfg, frame_seed=jnp.uint32(3))
            return jnp.sum(img * weights)

        # allow_int: the Scene pytree carries i32 leaves (mat_kind,
        # BVH links, face_ids) whose cotangents are float0.
        grads[be] = jax.grad(loss, allow_int=True)(scene)

    for leaf_j, leaf_p, path in zip(
            jax.tree.leaves(grads["jax"]), jax.tree.leaves(grads["pallas"]),
            jax.tree_util.tree_flatten_with_path(grads["jax"])[0]):
        if leaf_j.dtype == jax.dtypes.float0:
            continue
        np.testing.assert_allclose(
            np.asarray(leaf_j), np.asarray(leaf_p), rtol=1e-5, atol=1e-7,
            err_msg=str(path[0]))
    # and the gradients are non-trivially informative
    assert float(jnp.abs(grads["pallas"].spheres.albedo).sum()) > 0
    assert float(jnp.abs(grads["pallas"].tri_lights.emission).sum()) > 0
