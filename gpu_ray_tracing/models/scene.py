"""Scene: the union of sphere and triangle-mesh geometry.

The reference's whole scene model is a single sphere list
(`SphereCollection`, sphere.rs:30-33); this Scene generalizes it to spheres +
an optional BVH-accelerated triangle mesh (BASELINE config 4) behind one
closest-hit interface that also resolves the hit's material — the decoded
form of the reference's albedo.w dispatch (wgsl:272-284).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from gpu_ray_tracing.models.mesh import TriangleMesh
from gpu_ray_tracing.models.spheres import EMISSIVE, Spheres
from gpu_ray_tracing.ops.bvh import BVH, build_mesh_bvh
from gpu_ray_tracing.ops.intersect import (
    Hit,
    intersect_bvh,
    intersect_spheres,
    intersect_triangles,
    nearest_t_spheres,
)

Array = jax.Array


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["centers", "radii", "emission"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Lights:
    """Emissive-sphere light list for next-event estimation.

    Extracted host-side by make_scene (light count must be static under
    jit).  emission = albedo * mat_param per light.
    """

    centers: Array  # (L, 3)
    radii: Array  # (L,)
    emission: Array  # (L, 3)

    @property
    def count(self) -> int:
        return self.centers.shape[0]


def extract_lights(spheres: Spheres) -> Lights | None:
    """Collect the active emissive spheres (None if there are none)."""
    import numpy as np

    kind = np.asarray(spheres.mat_kind)
    radii = np.asarray(spheres.radii)
    idx = np.flatnonzero((kind == EMISSIVE) & (radii > 0))
    if idx.size == 0:
        return None
    return Lights(
        centers=spheres.centers[idx],
        radii=spheres.radii[idx],
        emission=spheres.albedo[idx] * spheres.mat_param[idx][:, None],
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["v0", "e1", "e2", "normal", "area", "emission", "face_ids"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class TriLights:
    """Emissive mesh-triangle light list for next-event estimation.

    Extracted host-side by make_scene AFTER BVH face reordering, so
    `face_ids` index the mesh the render actually traverses.  Light
    ordinals continue after the sphere lights: the j-th triangle light is
    global light `sphere_count + j` — one ordinal space drives the RNG
    salts, the MIS identity planes, and the kernels' light tables.  Emission
    is two-sided (matching BSDF-hit emission of mesh faces, which ignores
    front_face); `normal` is the unit geometric normal, used for the
    area-to-solid-angle pdf only.
    """

    v0: Array  # (T, 3)
    e1: Array  # (T, 3)
    e2: Array  # (T, 3)
    normal: Array  # (T, 3) unit geometric normals
    area: Array  # (T,)
    emission: Array  # (T, 3)
    face_ids: Array  # (T,) i32 indices into the (reordered) mesh faces

    @property
    def count(self) -> int:
        return self.v0.shape[0]


def extract_tri_lights(mesh) -> TriLights | None:
    """Collect the emissive, non-degenerate mesh faces (None if none).

    Zero-area faces are excluded from the light list: Moller-Trumbore's
    determinant test rejects them so they can never radiate via a BSDF
    hit either — the identity space stays consistent.
    """
    import numpy as np

    from gpu_ray_tracing.models.spheres import EMISSIVE as _EM

    kind = np.asarray(mesh.mat_kind)
    e1 = np.asarray(mesh.e1, np.float64)
    e2 = np.asarray(mesh.e2, np.float64)
    cross = np.cross(e1, e2)
    area2 = np.linalg.norm(cross, axis=-1)  # = 2 * area
    idx = np.flatnonzero((kind == _EM) & (area2 > 1e-12))
    if idx.size == 0:
        return None
    return TriLights(
        v0=mesh.v0[idx],
        e1=mesh.e1[idx],
        e2=mesh.e2[idx],
        normal=jnp.asarray(
            cross[idx] / area2[idx][:, None], jnp.float32
        ),
        area=jnp.asarray(0.5 * area2[idx], jnp.float32),
        emission=mesh.albedo[idx] * mesh.mat_param[idx][:, None],
        face_ids=jnp.asarray(idx, jnp.int32),
    )


def tri_light_id_per_face(mesh, tri_lights: TriLights | None):
    """(F,) i32 TRI-LIGHT ordinal per mesh face (-1 for non-lights).

    The j-th entry of tri_lights maps to global ordinal sphere_count + j;
    the OFFSET is added by the consumer (it needs the scene's sphere light
    count).  This array is what gives MIS exact light identity for mesh
    hits — the triangle table and the jax gather both read it.  Pure jnp
    scatter: it must also work under jit, where face_ids is traced.
    """
    f = int(mesh.num_triangles)
    lid = jnp.full((f,), -1, jnp.int32)
    if tri_lights is not None:
        lid = lid.at[tri_lights.face_ids].set(
            jnp.arange(tri_lights.count, dtype=jnp.int32)
        )
    return lid


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["spheres", "mesh", "bvh", "sphere_bvh", "lights",
                 "tri_lights"],
    meta_fields=["bvh_leaf_size", "mesh_has_emissive"],
)
@dataclasses.dataclass(frozen=True)
class Scene:
    """Sphere geometry plus an optional triangle mesh with its BVH.

    `mesh`/`bvh` are None for sphere-only scenes (the reference's entire
    repertoire); `sphere_bvh` (spheres reordered leaf-contiguously) lets the
    megakernel cull the sphere scan on large scenes; `bvh_leaf_size` is
    static metadata for the traversal loop.  `tri_lights` is the emissive-
    mesh-face light list (extracted by make_scene after BVH reordering);
    NEE samples it alongside the sphere `lights` in one ordinal space.
    `mesh_has_emissive` is a STATIC flag recorded by make_scene — nee=True
    with an emissive mesh requires `tri_lights` to be present (a directly-
    constructed Scene that skipped extraction must be rejected, and the
    check must be host-side metadata, not a traced-array inspection, or it
    explodes under jit).  Its default None means "unknown" — a directly-
    constructed Scene resolves it lazily at the nee=True guard via
    `resolve_mesh_has_emissive`, which inspects the mesh when concrete and
    refuses to guess when traced, so a hand-built emissive-mesh scene can
    never silently render a biased NEE image.
    """

    spheres: Spheres
    mesh: TriangleMesh | None = None
    bvh: BVH | None = None
    sphere_bvh: BVH | None = None
    lights: Lights | None = None
    tri_lights: TriLights | None = None
    bvh_leaf_size: int = 4
    mesh_has_emissive: bool | None = None

    def __post_init__(self):
        # Derive the static flag at construction when the mesh is concrete:
        # a directly-built Scene then carries it as pytree metadata through
        # any later jit/vmap (meta fields survive tracing), so only Scenes
        # whose mesh was ALREADY traced at construction hit the nee=True
        # guard's refuse-to-guess error.  Tracers subclass jax.Array, hence
        # the explicit exclusion; unflattening with sentinel leaves (shape
        # probes) falls through the isinstance checks and stays None.
        if self.mesh is not None and self.mesh_has_emissive is None:
            import numpy as np

            mk = self.mesh.mat_kind
            concrete = isinstance(mk, np.ndarray) or (
                isinstance(mk, jax.Array) and not isinstance(mk, jax.core.Tracer)
            )
            if concrete:
                object.__setattr__(
                    self, "mesh_has_emissive",
                    bool((np.asarray(mk) == EMISSIVE).any()),
                )


#: Sphere count above which make_scene builds a sphere BVH by default.
#: The benchmark's One-Weekend scenes straddle it: config 3 (487 spheres)
#: gets a BVH, the smaller scenes scan every sphere.  The crossover has not
#: been measured on the GPU yet (PERF.md, open questions).  Force with
#: make_scene(sphere_bvh=True/False) for atypical workloads.
SPHERE_BVH_THRESHOLD = 256


def make_scene(
    spheres: Spheres,
    mesh: TriangleMesh | None = None,
    *,
    bvh_leaf_size: int = 4,
    use_bvh: bool = True,
    sphere_bvh: bool | None = None,
) -> Scene:
    """Assemble a scene; builds BVHs host-side.

    sphere_bvh: True/False forces; None builds one when the active sphere
    count exceeds SPHERE_BVH_THRESHOLD (reordering the spheres).
    """
    from gpu_ray_tracing.ops.bvh import build_sphere_bvh

    s_bvh = None
    if sphere_bvh is None:
        sphere_bvh = use_bvh and int((spheres.radii > 0).sum()) > SPHERE_BVH_THRESHOLD
    if sphere_bvh:
        spheres, s_bvh = build_sphere_bvh(spheres)
    lights = extract_lights(spheres)

    if mesh is None:
        return Scene(spheres=spheres, sphere_bvh=s_bvh, lights=lights)
    import numpy as np

    from gpu_ray_tracing.models.spheres import EMISSIVE

    mesh_has_emissive = bool(np.any(np.asarray(mesh.mat_kind) == EMISSIVE))
    if use_bvh:
        mesh, bvh = build_mesh_bvh(mesh, leaf_size=bvh_leaf_size)
        # Extract AFTER BVH reordering so tri-light face ids index the mesh
        # the render actually traverses.
        return Scene(
            spheres=spheres, mesh=mesh, bvh=bvh, sphere_bvh=s_bvh,
            lights=lights, tri_lights=extract_tri_lights(mesh),
            bvh_leaf_size=bvh_leaf_size,
            mesh_has_emissive=mesh_has_emissive,
        )
    return Scene(spheres=spheres, mesh=mesh, bvh=None, sphere_bvh=s_bvh,
                 lights=lights, tri_lights=extract_tri_lights(mesh),
                 mesh_has_emissive=mesh_has_emissive)


def as_scene(scene_or_spheres) -> Scene:
    return scene_or_spheres if isinstance(scene_or_spheres, Scene) else Scene(spheres=scene_or_spheres)


def resolve_mesh_has_emissive(scene: Scene) -> bool:
    """Static answer to "does the mesh carry EMISSIVE faces?" for the
    nee=True guards.

    make_scene records the flag; a directly-constructed Scene leaves it
    None, in which case the mesh is inspected host-side when concrete.  A
    TRACED mesh with an unresolved flag is an error: guessing False would
    let an emissive-mesh scene pass the guard and silently render a biased
    image (NEE's light list covers spheres only and suppresses BSDF-hit
    emission behind diffuse bounces)."""
    if scene.mesh is None:
        return False
    if scene.mesh_has_emissive is not None:
        return scene.mesh_has_emissive
    import numpy as np

    mk = scene.mesh.mat_kind
    if isinstance(mk, jax.core.Tracer):
        raise ValueError(
            "nee=True with a mesh needs static mesh_has_emissive metadata; "
            "build the Scene via make_scene (or pass mesh_has_emissive "
            "explicitly) — it cannot be derived from a traced mesh"
        )
    return bool(np.any(np.asarray(mk) == EMISSIVE))


def intersect_scene(
    origins: Array,
    dirs: Array,
    scene: Scene,
    t_min: float,
    t_max: float,
    *,
    want_mesh_wins: bool = False,
) -> tuple:
    """Closest hit across all geometry; returns (hit, albedo, kind, param).

    The material arrays are per-ray, resolved from whichever primitive won
    the closest-hit race — trace loops never index geometry arrays again.
    `want_mesh_wins=True` appends a boolean "the mesh won this lane" plane:
    hit.idx is a sphere index OR a face index depending on the winner, and
    MIS light identity needs to know which table to gather from.
    """
    s_hit = intersect_spheres(origins, dirs, scene.spheres, t_min, t_max)
    albedo = scene.spheres.albedo[s_hit.idx]
    kind = scene.spheres.mat_kind[s_hit.idx]
    param = scene.spheres.mat_param[s_hit.idx]

    if scene.mesh is None:
        if want_mesh_wins:
            return s_hit, albedo, kind, param, jnp.zeros(
                s_hit.t.shape, dtype=bool
            )
        return s_hit, albedo, kind, param

    if scene.bvh is not None:
        m_hit = intersect_bvh(
            origins, dirs, scene.mesh, scene.bvh, t_min, t_max,
            leaf_size=scene.bvh_leaf_size,
        )
    else:
        m_hit = intersect_triangles(origins, dirs, scene.mesh, t_min, t_max)

    mesh_wins = m_hit.hit & (~s_hit.hit | (m_hit.t < s_hit.t))
    w = mesh_wins[..., None]
    hit = Hit(
        t=jnp.where(mesh_wins, m_hit.t, s_hit.t),
        idx=jnp.where(mesh_wins, m_hit.idx, s_hit.idx),
        hit=s_hit.hit | m_hit.hit,
        point=jnp.where(w, m_hit.point, s_hit.point),
        normal=jnp.where(w, m_hit.normal, s_hit.normal),
        front_face=jnp.where(mesh_wins, m_hit.front_face, s_hit.front_face),
    )
    albedo = jnp.where(w, scene.mesh.albedo[m_hit.idx], albedo)
    kind = jnp.where(mesh_wins, scene.mesh.mat_kind[m_hit.idx], kind)
    param = jnp.where(mesh_wins, scene.mesh.mat_param[m_hit.idx], param)
    if want_mesh_wins:
        return hit, albedo, kind, param, mesh_wins
    return hit, albedo, kind, param


def nearest_t_scene(
    origins: Array,
    dirs: Array,
    scene: Scene,
    t_min: float,
    t_max: float,
) -> Array:
    """Shadow-ray query: nearest hit t across all geometry (t_max on miss).

    Cheaper than intersect_scene — no material resolution, no hit-record
    construction; occlusion testing only needs the distance.
    """
    t = nearest_t_spheres(origins, dirs, scene.spheres, t_min, t_max)
    if scene.mesh is None:
        return t
    if scene.bvh is not None:
        m_hit = intersect_bvh(
            origins, dirs, scene.mesh, scene.bvh, t_min, t_max,
            leaf_size=scene.bvh_leaf_size,
        )
    else:
        m_hit = intersect_triangles(origins, dirs, scene.mesh, t_min, t_max)
    return jnp.minimum(t, jnp.where(m_hit.hit, m_hit.t, jnp.float32(t_max)))
