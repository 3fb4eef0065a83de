"""Integrators: iterative path tracer and normal-shading debug integrator.

Reference mapping (compute_shader.wgsl):
  - `sky_color`     <- the miss shader's vertical gradient (wgsl:293-296)
  - `trace_path`    <- ray_color (wgsl:261-297): iterative stackless bounce
                       loop to max_depth with multiplicative throughput;
                       absorbed scatter returns black (wgsl:274,278,282);
                       miss breaks to the sky gradient.
  - `shade_normals` <- not in the reference; the BASELINE config-1 debug
                       integrator from the same "One Weekend" lineage
                       (0.5 * (normal + 1) on hit, sky on miss).

The reference quirk at wgsl:293-296 — a ray that exhausts all bounces without
missing still receives sky * throughput instead of black — is reproduced only
when parity=True.

Control-flow note: under XLA every lane runs the full max_depth trip count; dead
rays (missed / absorbed) are carried with live=False masks instead of breaking,
which is exactly how a vector machine wants the reference's per-thread `break`
expressed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gpu_ray_tracing.models.spheres import EMISSIVE, Spheres
from gpu_ray_tracing.ops import rng as rng_ops
from gpu_ray_tracing.ops.materials import scatter

Array = jax.Array


def sky_color(dirs: Array) -> Array:
    """Vertical white->blue gradient on the unit direction (wgsl:293-296)."""
    unit = dirs / jnp.maximum(jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-20)
    a = 0.5 * (unit[..., 1:2] + 1.0)
    white = jnp.asarray([1.0, 1.0, 1.0], jnp.float32)
    blue = jnp.asarray([0.5, 0.7, 1.0], jnp.float32)
    return (1.0 - a) * white + a * blue


def shade_normals(
    origins: Array,
    dirs: Array,
    scene,
    t_min: float,
    t_max: float,
) -> Array:
    """Normal-shading integrator (BASELINE config 1): 0.5*(n+1) or sky."""
    from gpu_ray_tracing.models.scene import as_scene, intersect_scene

    hit, _, _, _ = intersect_scene(origins, dirs, as_scene(scene), t_min, t_max)
    lit = 0.5 * (hit.normal + 1.0)
    return jnp.where(hit.hit[..., None], lit, sky_color(dirs))


def shade_albedo(
    origins: Array,
    dirs: Array,
    scene,
    t_min: float,
    t_max: float,
) -> Array:
    """First-hit albedo AOV (denoiser guide channel): the hit material's
    stored albedo, or the sky color on miss (so the AOV matches the beauty
    pass's background)."""
    from gpu_ray_tracing.models.scene import as_scene, intersect_scene

    hit, albedo, _, _ = intersect_scene(origins, dirs, as_scene(scene), t_min, t_max)
    return jnp.where(hit.hit[..., None], albedo, sky_color(dirs))


def shade_depth(
    origins: Array,
    dirs: Array,
    scene,
    t_min: float,
    t_max: float,
) -> Array:
    """First-hit METRIC distance AOV, broadcast to 3 channels; 0 on miss.

    Ray directions are unnormalized (wgsl:322 convention), so the ray
    parameter t is scaled by |d| to give scene-unit distance."""
    from gpu_ray_tracing.models.scene import as_scene, intersect_scene

    hit, _, _, _ = intersect_scene(origins, dirs, as_scene(scene), t_min, t_max)
    dist = jnp.where(hit.hit, hit.t * jnp.linalg.norm(dirs, axis=-1), 0.0)
    return jnp.broadcast_to(dist[..., None], (*dist.shape, 3))


def clamp_radiance(rgb: Array, clamp: float) -> Array:
    """Per-SAMPLE max-component radiance clamp (firefly control).

    Scales the sample's rgb so its largest channel is at most `clamp`,
    preserving hue.  Biased (it removes energy from rare bright paths -
    the standard production trade), so it is opt-in and applies per
    sample BEFORE accumulation: progressive steps, spp batches and
    one-shot renders of the same budget stay identical, and all engines
    share the same arithmetic.
    """
    m = jnp.max(rgb, axis=-1, keepdims=True)
    return rgb * jnp.minimum(1.0, jnp.float32(clamp) / jnp.maximum(m, 1e-12))


def _one_minus_cos_max(r2, d2):
    """1 - cos(half-angle) of the cone a radius^2-r2 sphere subtends at
    squared distance d2, in the cancellation-free form
    (r2/d2) / (1 + sqrt(1 - r2/d2)).

    The naive 1 - sqrt(1 - r2/d2) underflows to exactly 0 once r2/d2 drops
    below ~1 ulp (a light further than ~4000 radii), silently deleting the
    light's whole NEE contribution; this form degrades gracefully to
    r2/(2 d2).  The sqrt argument is floored at a tiny positive value so
    the clip->sqrt chain cannot emit NaN GRADIENTS for lanes whose vertex
    sits inside the sphere (0 * inf through the sqrt VJP; such lanes are
    masked by value, but masking alone does not stop NaN cotangents).
    """
    q = r2 / d2
    # min with 1: inside the sphere (q > 1) the cone is undefined and every
    # consumer masks such lanes by value — keep the plane in the old [0, 1]
    # range rather than letting q blow up near d2 ~ 0.
    return jnp.minimum(q / (1.0 + jnp.sqrt(jnp.clip(1.0 - q, 1e-12, 1.0))), 1.0)


def trace_path(
    origins: Array,
    dirs: Array,
    scene,
    max_depth: int,
    t_min: float,
    t_max: float,
    *,
    key: Array | None = None,
    bounce_seeds: Array | None = None,
    pixel_seeds: Array | None = None,
    parity: bool = False,
    russian_roulette_depth: int = 0,
    sky_intensity: float = 1.0,
    nee: bool = False,
    mis: bool = False,
    pixel_ids: Array | None = None,
    sample_index: Array | None = None,
    frame_seed_u32: Array | None = None,
    sampler_spec: tuple | None = None,
    count_rays: bool = False,
) -> Array:
    """Path-trace a batch of rays; returns linear RGB of shape dirs.shape.

    `count_rays=True` returns (rgb, rays) instead, where rays is a per-ray
    f32 count of rays traced: one closest-hit walk per live bounce plus one
    per NEE shadow ray whose occlusion result is consumed (pre-visibility
    validity — the same definition as the megakernel's in-kernel counters,
    so the two agree exactly; used to verify them and to publish honest
    bounce-ray throughput).

    RNG: pass exactly one of
      - pixel_seeds:  (batch,) uint32 per-pixel counter seeds (from
                      generate_rays_hash); draws are pure functions of
                      (pixel seed, bounce, salt) — position-equivariant, so
                      results are independent of sharding/tiling.  The
                      default.
      - key:          threefry; independent per-pixel draws per bounce.
      - bounce_seeds: (max_depth,) uint32 scalar seeds, the WGSL stream.
                      NOTE the reference derives ONE scalar scatter seed per
                      bounce for the whole frame (ray_color receives the
                      frame-uniform `seed+1`, wgsl:355, then hashes
                      seed + i*1000 per bounce, wgsl:268) — so scatter
                      randomness is perfectly correlated across pixels.  We
                      reproduce that faithfully here since it IS the WGSL
                      stream; the threefry path decorrelates pixels.
    """
    n_rng = sum(x is not None for x in (key, bounce_seeds, pixel_seeds))
    if n_rng != 1:
        raise ValueError("pass exactly one of key=, bounce_seeds=, or pixel_seeds=")
    if sampler_spec is not None and (
        pixel_seeds is None
        or pixel_ids is None
        or sample_index is None
        or frame_seed_u32 is None
    ):
        raise ValueError(
            "sampler_spec= (the stratified/sobol sampler's first-bounce "
            "remap) requires the counter stream: pixel_seeds=, pixel_ids=, "
            "sample_index= and frame_seed_u32="
        )

    from gpu_ray_tracing.models.scene import (
        as_scene,
        intersect_scene,
        resolve_mesh_has_emissive,
    )
    from gpu_ray_tracing.models.spheres import LAMBERTIAN

    scene = as_scene(scene)
    # One light ORDINAL space: sphere lights 0..S-1, then triangle lights
    # S..S+T-1 — it drives the NEE salts, the MIS identity planes, and the
    # kernels' light tables identically.
    n_slights = 0 if scene.lights is None else scene.lights.count
    n_tlights = 0 if scene.tri_lights is None else scene.tri_lights.count
    total_lights = n_slights + n_tlights
    if mis and not nee:
        raise ValueError("mis=True is a weighting of NEE; it requires nee=True")
    if nee and total_lights == 0:
        raise ValueError(
            "nee=True needs a Scene with emissive lights; build it with "
            "make_scene so the light list is extracted"
        )
    # Static metadata check (never inspect traced arrays here — this runs
    # inside jit with a dynamic scene; make_scene records the flag, and
    # resolve_mesh_has_emissive covers directly-constructed Scenes).
    if nee and resolve_mesh_has_emissive(scene) and scene.tri_lights is None:
        raise ValueError(
            "nee=True with EMISSIVE mesh faces needs the triangle light "
            "list; build the Scene via make_scene (it extracts tri_lights)"
        )

    batch_shape = dirs.shape[:-1]
    throughput = jnp.ones((*batch_shape, 3), jnp.float32)
    result = jnp.zeros((*batch_shape, 3), jnp.float32)
    live = jnp.ones(batch_shape, dtype=bool)
    prev_diffuse0 = jnp.zeros(batch_shape, dtype=bool)

    if mis:
        # Per-sphere light index (exact identity for the MIS weight): the
        # l-th active emissive sphere in array order is light l — the same
        # order extract_lights emits, so indices line up with scene.lights.
        # Non-lights hold -1.  Replaces the r3 geometric |d2-r2| tolerance,
        # which could mis-match near-concentric/shell-adjacent lights and
        # silently break the power heuristic's sum-to-1 property.
        _is_em = (scene.spheres.mat_kind == EMISSIVE) & (scene.spheres.radii > 0.0)
        _lid_per_sphere = jnp.where(
            _is_em, jnp.cumsum(_is_em.astype(jnp.int32)) - 1, -1
        )
        if n_tlights > 0:
            # Per-face GLOBAL ordinal (sphere lights first): gathered by
            # the winning face index when the mesh wins the closest hit.
            from gpu_ray_tracing.models.scene import tri_light_id_per_face

            _lid_base = tri_light_id_per_face(scene.mesh, scene.tri_lights)
            _lid_per_tri = jnp.where(_lid_base >= 0, _lid_base + n_slights, -1)

    def body(i, carry):
        if count_rays:
            carry, rays = carry[:-1], carry[-1]
        if mis:
            # prev_cos = cos(scatter dir, normal) at the previous DIFFUSE
            # vertex (0 elsewhere): the BSDF pdf there is prev_cos / pi,
            # which the MIS weight below needs in ratio form only.
            o, d, throughput, result, live, prev_diffuse, prev_cos = carry
        else:
            o, d, throughput, result, live, prev_diffuse = carry
        if count_rays:
            # One closest-hit walk per live lane this bounce.
            rays = rays + live.astype(jnp.float32)
        if mis and scene.mesh is not None:
            hit, albedo, kind, param, mesh_won = intersect_scene(
                o, d, scene, t_min, t_max, want_mesh_wins=True
            )
        else:
            hit, albedo, kind, param = intersect_scene(o, d, scene, t_min, t_max)
            mesh_won = None

        if pixel_seeds is not None:
            # Salts 16+3i..18+3i: three independent draws per bounce.
            base = jnp.uint32(16) + jnp.uint32(3) * jnp.asarray(i, jnp.uint32)
            u1 = rng_ops.uniform_hash(pixel_seeds, base)
            u2 = rng_ops.uniform_hash(pixel_seeds, base + jnp.uint32(1))
            if sampler_spec is not None:
                # FIRST-bounce scatter direction (the sampler's second
                # dimension pair, salt-6 pair id): bounce 0's (u1, u2) become
                # sample points in (z, phi) of the unit vector, i.e.
                # equal-area strata of the scatter sphere.  Later bounces
                # stay independent (their noise decorrelates too fast for
                # stratification to matter).
                su1, su2 = rng_ops.sampler_uniforms(
                    u1, u2, pixel_ids, sample_index, frame_seed_u32,
                    sampler_spec, rot_salt=rng_ops._SCATTER_ROT_SALT,
                )
                first = jnp.asarray(i, jnp.int32) == 0
                u1 = jnp.where(first, su1, u1)
                u2 = jnp.where(first, su2, u2)
            unit_vec = rng_ops.unit_vector_from_uniforms(u1, u2)
            u_reflect = rng_ops.uniform_hash(pixel_seeds, base + jnp.uint32(2))
        elif key is not None:
            k = jax.random.fold_in(key, i)
            k_uv, k_refl = jax.random.split(k)
            u = jax.random.uniform(k_uv, (2, *batch_shape), jnp.float32)
            unit_vec = rng_ops.unit_vector_from_uniforms(u[0], u[1])
            u_reflect = jax.random.uniform(k_refl, batch_shape, jnp.float32)
        else:
            # Frame-uniform scalar seed per bounce: hash(seed + i*1000)
            # (wgsl:268), shared by every pixel.
            s = bounce_seeds[i]
            unit_vec = jnp.broadcast_to(
                rng_ops.random_unit_vector(s), (*batch_shape, 3)
            )
            u_reflect = jnp.broadcast_to(rng_ops.wgsl_random_float(s), batch_shape)

        new_dir, attenuation, ok = scatter(
            d, hit.normal, hit.front_face, albedo, kind, param, unit_vec, u_reflect
        )

        missed = live & ~hit.hit
        result = jnp.where(
            missed[..., None],
            result + throughput * sky_color(d) * jnp.float32(sky_intensity),
            result,
        )
        # Emissive surfaces radiate albedo * param and end the path
        # (extension beyond the reference's three BSDFs).  Under NEE, a
        # BSDF ray leaving a DIFFUSE surface must not count emission again —
        # the shadow ray already sampled that light directly.
        emissive = live & hit.hit & (kind == EMISSIVE)
        if nee and mis:
            # Multiple importance sampling (power heuristic, beta=2): a BSDF
            # ray from a diffuse vertex that hits light l is weighted
            # against the NEE cone sample of the SAME vertex instead of
            # being dropped.  w_b = p_b^2 / (p_b^2 + p_nee,l^2) with
            # p_b = prev_cos/pi and p_nee,l = 1/(2 pi (1 - cos_max)) as
            # seen from the prev vertex (= the ray origin o) — in ratio
            # form w_b = 1 / (1 + r^2), r = 1 / (2 (1-cos_max) prev_cos).
            # Specular/miss-regenerated lanes (prev_diffuse False) keep
            # weight 1, exactly the non-MIS accounting.
            # Exact light identity from the closest-hit index: a sphere win
            # gathers the per-sphere light ordinal, a mesh win (mesh_won)
            # the per-face one — hit.idx addresses whichever table won, so
            # the two gathers are disambiguated by the winner plane.  Lanes
            # clipped out of range are never EMISSIVE, so `emissive` masks
            # them out.
            hit_lid = _lid_per_sphere[
                jnp.clip(hit.idx, 0, scene.spheres.count - 1)
            ]
            if n_tlights > 0:
                hit_lid = jnp.where(
                    mesh_won,
                    _lid_per_tri[
                        jnp.clip(hit.idx, 0, scene.mesh.num_triangles - 1)
                    ],
                    hit_lid,
                )
            elif mesh_won is not None:
                # Non-emissive mesh: a mesh win is never a light.
                hit_lid = jnp.where(mesh_won, -1, hit_lid)
            one_minus_cm = jnp.zeros(batch_shape, jnp.float32)
            matched = emissive & (hit_lid >= 0)
            for l_static in range(n_slights):
                c_l = scene.lights.centers[l_static]
                r_l = scene.lights.radii[l_static]
                is_l = hit_lid == l_static
                d2o = jnp.maximum(jnp.sum((o - c_l) ** 2, axis=-1), 1e-12)
                one_minus_cm = jnp.where(
                    is_l, _one_minus_cos_max(r_l * r_l, d2o), one_minus_cm
                )
            # r_ratio = p_nee / p_b per lane.  Sphere lights:
            # (1/(2 pi (1-cos_max))) / (prev_cos/pi) = 1/(2 (1-cos_max) pc).
            r_ratio = 1.0 / jnp.maximum(
                2.0 * one_minus_cm * prev_cos, 1e-12
            )
            if n_tlights > 0:
                # Triangle lights: p_nee = d^2/(cos_l * area) with
                # cos_l = |n_l . delta| / d  ->  p_nee = d^3/(|n_l.delta| A),
                # so r = pi d^3 / (|n_l.delta| * area * prev_cos).  Pure
                # point arithmetic (hit point minus prev vertex) — no
                # direction normalization needed.
                delta = hit.point - o
                d2h = jnp.maximum(jnp.sum(delta * delta, axis=-1), 1e-12)
                d3h = d2h * jnp.sqrt(d2h)
                for j_static in range(n_tlights):
                    g = n_slights + j_static
                    nl = scene.tri_lights.normal[j_static]
                    a_l = scene.tri_lights.area[j_static]
                    ndot = jnp.abs(jnp.sum(delta * nl, axis=-1))
                    r_tri = (jnp.float32(jnp.pi) * d3h) / jnp.maximum(
                        ndot * a_l * prev_cos, 1e-12
                    )
                    r_ratio = jnp.where(hit_lid == g, r_tri, r_ratio)
            if total_lights > 4:
                # Picked-light NEE (> 4 lights): each light is sampled with
                # pdf/total, so the BSDF ray's competing NEE density shrinks
                # by the pick probability.  The NEE side scales its ratio by
                # total symmetrically (ratio = the full estimator weight),
                # keeping each light-id pair's power-heuristic weights
                # summing to 1.  Divide by the exact integer total (not a
                # rounded reciprocal) so the two sides are exact mirrors.
                r_ratio = r_ratio / jnp.float32(total_lights)
            # `matched` is every emissive hit by construction (active
            # emissive spheres ARE the light list); the exclusion branch is
            # a defensive never-double-count fallback, not a tolerance gap.
            w_emis = jnp.where(
                prev_diffuse,
                jnp.where(matched, 1.0 / (1.0 + r_ratio * r_ratio), 0.0),
                1.0,
            )
            result = jnp.where(
                emissive[..., None],
                result + throughput * albedo * (param * w_emis)[..., None],
                result,
            )
        else:
            emissive_counted = emissive & ~prev_diffuse if nee else emissive
            result = jnp.where(
                emissive_counted[..., None],
                result + throughput * albedo * param[..., None],
                result,
            )

        if nee:
            # Next-event estimation: from each diffuse hit, sample emissive
            # spheres by uniform cone (solid-angle) sampling and cast shadow
            # rays.  Estimator: Le * (albedo/pi) * cos_i / pdf with
            # pdf = 1 / (2 pi (1 - cos_max)) [times the pick pdf] ->
            # contribution = Le * albedo * cos_i * 2 (1 - cos_max) * weight.
            # Small light counts loop over ALL lights (weight 1, lowest
            # variance; salts match the megakernel); larger counts pick one
            # per lane (weight L).
            lights = scene.lights
            num_l = n_slights

            def _nee_draws(salt_off, n_draws=3):
                # Salt layout: 2000 + 37*bounce + 7*light + {0,1,2}.  Strides
                # 37/7 keep every (bounce, light, channel) triple distinct for
                # depth < ~1000 and <= 5 lights (7*l + c < 37), so no draw is
                # ever reused across a path.
                salt2 = (
                    jnp.uint32(2000)
                    + jnp.uint32(37) * jnp.asarray(i, jnp.uint32)
                    + jnp.uint32(salt_off)
                )
                if pixel_seeds is not None:
                    return tuple(
                        rng_ops.uniform_hash(pixel_seeds, salt2 + jnp.uint32(k))
                        for k in range(n_draws)
                    )
                if key is not None:
                    kn = jax.random.fold_in(
                        jax.random.fold_in(key, 2000 + salt_off), i
                    )
                    un = jax.random.uniform(kn, (n_draws, *batch_shape), jnp.float32)
                    return tuple(un[k] for k in range(n_draws))
                sN = rng_ops.wgsl_hash(
                    bounce_seeds[i] + jnp.uint32(4241) + jnp.uint32(salt_off)
                )
                return tuple(
                    jnp.broadcast_to(rng_ops.uniform_hash(sN, k), batch_shape)
                    for k in range(n_draws)
                )

            pnt = hit.point
            diffuse_hit = live & hit.hit & (kind == LAMBERTIAN)

            # A shading point inside any light's radius cannot cone-sample
            # that light; such lanes fall back to pure BSDF sampling (their
            # prev_diffuse stays False below so BSDF-hit emission counts) —
            # unbiased either way, no dark ring around embedded lights.
            # (Sphere lights only: a point can't be "inside" a 2D triangle
            # light, so tri lights never invalidate a lane this way.)
            if num_l > 0:
                all_d2 = jnp.sum(
                    (lights.centers[None, :, :] - pnt[..., None, :]) ** 2,
                    axis=-1,
                )
                inside_any = jnp.any(
                    all_d2 <= (lights.radii[None, :] ** 2) * 1.0001, axis=-1
                )
            else:
                inside_any = jnp.zeros(batch_shape, dtype=bool)
            nee_ok = diffuse_hit & ~inside_any
            rays_box = [jnp.zeros(batch_shape, jnp.float32)]

            def _nee_light_term(weight, u1n, u2n, result, lc, lr, le):
                dc = lc - pnt
                d2 = jnp.sum(dc * dc, axis=-1)
                d2s = jnp.maximum(d2, 1e-12)
                inside = d2 <= lr * lr * 1.0001
                omc = _one_minus_cos_max(lr * lr, d2s)
                cos_t = 1.0 - u1n * omc
                sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
                phi = u2n * jnp.float32(2.0 * jnp.pi)
                wl = dc / jnp.sqrt(d2s)[..., None]
                pick = jnp.abs(wl[..., 0:1]) > 0.9
                a_ax = jnp.where(
                    pick,
                    jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
                    jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
                )
                u_ax = jnp.cross(a_ax, wl)
                u_ax = u_ax / jnp.maximum(
                    jnp.linalg.norm(u_ax, axis=-1, keepdims=True), 1e-12
                )
                v_ax = jnp.cross(wl, u_ax)
                omega = (
                    u_ax * (jnp.cos(phi) * sin_t)[..., None]
                    + v_ax * (jnp.sin(phi) * sin_t)[..., None]
                    + wl * cos_t[..., None]
                )
                cos_i = jnp.sum(hit.normal * omega, axis=-1)
                h_l = jnp.sum(dc * omega, axis=-1)
                disc_l = h_l * h_l - (d2 - lr * lr)
                t_l = h_l - jnp.sqrt(jnp.maximum(disc_l, 0.0))

                from gpu_ray_tracing.models.scene import nearest_t_scene

                shadow_t = nearest_t_scene(pnt, omega, scene, t_min, t_max)
                visible = shadow_t >= t_l * (1.0 - 1e-3)

                if count_rays:
                    # One shadow ray per lane whose occlusion result is
                    # consumed (pre-visibility validity; matches the
                    # megakernel's driven-walk count).
                    prevalid = nee_ok & (cos_i > 0.0) & ~inside & (disc_l > 0.0)
                    rays_box[0] = rays_box[0] + prevalid.astype(jnp.float32)
                valid = nee_ok & (cos_i > 0.0) & ~inside & (disc_l > 0.0) & visible
                wgt = cos_i * 2.0 * omc * jnp.float32(weight)
                if mis:
                    # Counterpart of the BSDF-hit weight above:
                    # w_nee = p_nee^2 / (p_nee^2 + p_b^2)
                    #       = 1 / (1 + (p_b/p_nee)^2), and p_b/p_nee is
                    # exactly the scaled estimator weight: 2 cos_i (1-cos_max)
                    # in the deterministic loop (weight 1), times the light
                    # count under the picked-light estimator (weight L
                    # cancels the 1/L pick pdf in the density too).
                    # The LAST bounce keeps w_nee = 1: its BSDF counterpart
                    # ray is never traced (exhausted rays contribute black),
                    # so down-weighting it would lose that fraction of the
                    # vertex's direct light (depth-truncation bias).
                    ratio = wgt
                    last = jnp.asarray(i, jnp.int32) == max_depth - 1
                    wgt = jnp.where(last, wgt, wgt / (1.0 + ratio * ratio))
                wgt = wgt[..., None]
                return jnp.where(
                    valid[..., None], result + throughput * albedo * le * wgt, result
                )

            def _nee_tri_term(j, u1n, u2n, result):
                """Triangle-light NEE: uniform-area sample on emissive face
                j (static), area-to-solid-angle pdf.  Estimator:
                Le * (albedo/pi) * cos_i / pdf_w with
                pdf_w = d^2 / (cos_l * area)  ->
                contribution = Le * albedo * cos_i * cos_l * area/(pi d^2).
                Two-sided (|cos_l|), matching BSDF-hit emission of mesh
                faces, which ignores front_face."""
                tl = scene.tri_lights
                su = jnp.sqrt(u1n)
                b1 = 1.0 - su
                b2 = u2n * su
                p = (
                    tl.v0[j]
                    + b1[..., None] * tl.e1[j]
                    + b2[..., None] * tl.e2[j]
                )
                dc = p - pnt
                d2 = jnp.sum(dc * dc, axis=-1)
                d2s = jnp.maximum(d2, 1e-12)
                dist = jnp.sqrt(d2s)
                omega = dc / dist[..., None]
                cos_i = jnp.sum(hit.normal * omega, axis=-1)
                cos_l = jnp.abs(jnp.sum(tl.normal[j] * omega, axis=-1))

                from gpu_ray_tracing.models.scene import nearest_t_scene

                shadow_t = nearest_t_scene(pnt, omega, scene, t_min, t_max)
                # The sampled face itself sits at t == dist and must not
                # count as a blocker (same 1e-3 relative slack as spheres).
                visible = shadow_t >= dist * (1.0 - 1e-3)
                prevalid = (
                    nee_ok & (cos_i > 0.0) & (cos_l > 1e-7) & (d2 > 1e-12)
                )
                if count_rays:
                    rays_box[0] = rays_box[0] + prevalid.astype(jnp.float32)
                valid = prevalid & visible
                wgt = cos_i * cos_l * tl.area[j] / (jnp.float32(jnp.pi) * d2s)
                if mis:
                    # ratio = p_b / p_nee = cos_i cos_l area / (pi d^2)
                    # == wgt, the same identity the sphere term uses; last
                    # bounce keeps weight 1 (no BSDF counterpart is traced).
                    ratio = wgt
                    last = jnp.asarray(i, jnp.int32) == max_depth - 1
                    wgt = jnp.where(last, wgt, wgt / (1.0 + ratio * ratio))
                wgt = wgt[..., None]
                le = tl.emission[j]
                return jnp.where(
                    valid[..., None],
                    result + throughput * albedo * le * wgt,
                    result,
                )

            def _nee_combined_pick(gi, u1n, u2n, result):
                """Pick-one-light NEE over the COMBINED ordinal space
                (> 4 total lights with triangle lights present): build the
                sphere-cone and triangle-area candidates from the picked
                ordinal, select per lane by its kind, and drive ONE shadow
                walk with the selected direction — the walk dominates the
                cost, the duplicated candidate math does not.  Weight =
                total_lights cancels the uniform pick pdf; under mis=True
                the power-heuristic ratio is the same scaled weight (the
                pick pdf shrinks the NEE density by 1/total, growing
                p_b/p_nee by total), mirroring the BSDF side's 1/total."""
                is_sph = gi < num_l
                zero3 = jnp.zeros((*batch_shape, 3), jnp.float32)
                zero = jnp.zeros(batch_shape, jnp.float32)
                # Sphere-cone candidate, params gathered by the pick.
                if num_l > 0:
                    li = jnp.clip(gi, 0, num_l - 1)
                    lc = lights.centers[li]
                    lr = lights.radii[li]
                    le_s = lights.emission[li]
                    dc = lc - pnt
                    d2 = jnp.sum(dc * dc, axis=-1)
                    d2s = jnp.maximum(d2, 1e-12)
                    inside = d2 <= lr * lr * 1.0001
                    omc = _one_minus_cos_max(lr * lr, d2s)
                    cos_t = 1.0 - u1n * omc
                    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
                    phi = u2n * jnp.float32(2.0 * jnp.pi)
                    wl = dc / jnp.sqrt(d2s)[..., None]
                    pick = jnp.abs(wl[..., 0:1]) > 0.9
                    a_ax = jnp.where(
                        pick,
                        jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
                        jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
                    )
                    u_ax = jnp.cross(a_ax, wl)
                    u_ax = u_ax / jnp.maximum(
                        jnp.linalg.norm(u_ax, axis=-1, keepdims=True), 1e-12
                    )
                    v_ax = jnp.cross(wl, u_ax)
                    omega_s = (
                        u_ax * (jnp.cos(phi) * sin_t)[..., None]
                        + v_ax * (jnp.sin(phi) * sin_t)[..., None]
                        + wl * cos_t[..., None]
                    )
                    cos_i_s = jnp.sum(hit.normal * omega_s, axis=-1)
                    h_l = jnp.sum(dc * omega_s, axis=-1)
                    disc_l = h_l * h_l - (d2 - lr * lr)
                    t_s = h_l - jnp.sqrt(jnp.maximum(disc_l, 0.0))
                    prevalid_s = (
                        nee_ok & (cos_i_s > 0.0) & ~inside & (disc_l > 0.0)
                    )
                    wgt_s = cos_i_s * 2.0 * omc
                else:
                    omega_s, t_s, wgt_s, le_s = zero3, zero, zero, zero3
                    prevalid_s = jnp.zeros(batch_shape, dtype=bool)
                # Triangle-area candidate, params gathered by the pick.
                tl = scene.tri_lights
                ji = jnp.clip(gi - num_l, 0, n_tlights - 1)
                su = jnp.sqrt(u1n)
                b1 = 1.0 - su
                b2 = u2n * su
                p = (
                    tl.v0[ji]
                    + b1[..., None] * tl.e1[ji]
                    + b2[..., None] * tl.e2[ji]
                )
                dct = p - pnt
                d2t = jnp.sum(dct * dct, axis=-1)
                d2ts = jnp.maximum(d2t, 1e-12)
                dist_t = jnp.sqrt(d2ts)
                omega_t = dct / dist_t[..., None]
                cos_i_t = jnp.sum(hit.normal * omega_t, axis=-1)
                cos_l = jnp.abs(jnp.sum(tl.normal[ji] * omega_t, axis=-1))
                prevalid_t = (
                    nee_ok & (cos_i_t > 0.0) & (cos_l > 1e-7) & (d2t > 1e-12)
                )
                wgt_t = (
                    cos_i_t * cos_l * tl.area[ji]
                    / (jnp.float32(jnp.pi) * d2ts)
                )
                le_t = tl.emission[ji]
                # Lane-wise select, ONE walk, accumulate.
                omega = jnp.where(is_sph[..., None], omega_s, omega_t)
                maxt = jnp.where(is_sph, t_s, dist_t)
                prevalid = jnp.where(is_sph, prevalid_s, prevalid_t)
                if count_rays:
                    rays_box[0] = rays_box[0] + prevalid.astype(jnp.float32)

                from gpu_ray_tracing.models.scene import nearest_t_scene

                shadow_t = nearest_t_scene(pnt, omega, scene, t_min, t_max)
                visible = shadow_t >= maxt * (1.0 - 1e-3)
                valid = prevalid & visible
                wgt = (
                    jnp.where(is_sph, wgt_s, wgt_t)
                    * jnp.float32(total_lights)
                )
                if mis:
                    # Same power-heuristic form as _nee_light_term; the
                    # last bounce keeps weight 1 (no BSDF counterpart).
                    ratio = wgt
                    last = jnp.asarray(i, jnp.int32) == max_depth - 1
                    wgt = jnp.where(last, wgt, wgt / (1.0 + ratio * ratio))
                le = jnp.where(is_sph[..., None], le_s, le_t)
                return jnp.where(
                    valid[..., None],
                    result + throughput * albedo * le * wgt[..., None],
                    result,
                )

            # total <= 4 (== num_l <= 4 for sphere-only scenes, so the
            # stream is unchanged there): deterministic loop over ALL
            # lights, both kinds.  Above 4, pick one ordinal per lane.
            if total_lights <= 4:
                for l_static in range(num_l):
                    u1n, u2n = _nee_draws(7 * l_static + 1, n_draws=2)
                    if sampler_spec is not None and pixel_seeds is not None:
                        # First-bounce NEE cone sample: points in (u1n, u2n)
                        # are equal-solid-angle strata of light l's cone,
                        # pair id salt 8+l (per-light, so lights' points are
                        # uncorrelated).  Matches the megakernel.
                        sn1, sn2 = rng_ops.sampler_uniforms(
                            u1n, u2n, pixel_ids, sample_index, frame_seed_u32,
                            sampler_spec,
                            rot_salt=rng_ops._NEE_ROT_SALT_BASE + l_static,
                        )
                        first_b = jnp.asarray(i, jnp.int32) == 0
                        u1n = jnp.where(first_b, sn1, u1n)
                        u2n = jnp.where(first_b, sn2, u2n)
                    result = _nee_light_term(
                        1.0, u1n, u2n, result,
                        jnp.broadcast_to(lights.centers[l_static], (*batch_shape, 3)),
                        jnp.broadcast_to(lights.radii[l_static], batch_shape),
                        jnp.broadcast_to(lights.emission[l_static], (*batch_shape, 3)),
                    )
            elif n_tlights == 0:
                u_l, u1n, u2n = _nee_draws(0)
                li = jnp.clip((u_l * num_l).astype(jnp.int32), 0, num_l - 1)
                result = _nee_light_term(
                    num_l, u1n, u2n, result,
                    lights.centers[li], lights.radii[li], lights.emission[li],
                )
            else:
                # > 4 lights INCLUDING triangle lights: pick ONE ordinal
                # per lane from the combined space (weight = total cancels
                # the 1/total pick pdf), build both candidate samples, and
                # select lane-wise BEFORE the single shadow walk — the walk
                # is the expensive part, the candidate math is not.
                u_l, u1n, u2n = _nee_draws(0)
                gi = jnp.clip(
                    (u_l * total_lights).astype(jnp.int32), 0,
                    total_lights - 1,
                )
                result = _nee_combined_pick(gi, u1n, u2n, result)
            # Triangle lights extend the SAME ordinal/salt space after the
            # sphere lights (the <= 4-total static loop; larger counts take
            # the combined pick above).
            if total_lights <= 4:
                for j_static in range(n_tlights):
                    g = num_l + j_static
                    u1n, u2n = _nee_draws(7 * g + 1, n_draws=2)
                    if sampler_spec is not None and pixel_seeds is not None:
                        # First-bounce area sample: (u1n, u2n) stratify the
                        # triangle's barycentric square, pair id salt 8+g.
                        sn1, sn2 = rng_ops.sampler_uniforms(
                            u1n, u2n, pixel_ids, sample_index, frame_seed_u32,
                            sampler_spec,
                            rot_salt=rng_ops._NEE_ROT_SALT_BASE + g,
                        )
                        first_b = jnp.asarray(i, jnp.int32) == 0
                        u1n = jnp.where(first_b, sn1, u1n)
                        u2n = jnp.where(first_b, sn2, u2n)
                    result = _nee_tri_term(j_static, u1n, u2n, result)
        if nee and count_rays:
            rays = rays + rays_box[0]
        # Absorbed rays (metal below surface) contribute black (wgsl:278).
        scattered = live & hit.hit & ok & (kind != EMISSIVE)
        throughput = jnp.where(scattered[..., None], throughput * attenuation, throughput)
        o = jnp.where(scattered[..., None], hit.point, o)
        d = jnp.where(scattered[..., None], new_dir, d)
        live = scattered
        if nee:
            # Only lanes that actually ran NEE suppress BSDF-hit emission.
            prev_diffuse = scattered & (kind == LAMBERTIAN) & ~inside_any
        else:
            prev_diffuse = scattered & (kind == LAMBERTIAN)
        if mis:
            # Lambertian scatter dir is normal + unit vector (unnormalized);
            # its cosine against the normal feeds the next bounce's w_b.
            nd2 = jnp.maximum(jnp.sum(new_dir * new_dir, axis=-1), 1e-20)
            cos_s = jnp.sum(new_dir * hit.normal, axis=-1) * jax.lax.rsqrt(nd2)
            prev_cos = jnp.where(prev_diffuse, jnp.maximum(cos_s, 0.0), 0.0)

        if russian_roulette_depth > 0:
            # Unbiased stochastic termination: survive with p = max channel
            # throughput (clamped), divide by p on survival.  Salt space
            # 1000+i is disjoint from the scatter salts (16+3i) for
            # max_depth <= 328 — far beyond any practical depth — so
            # enabling RR does not perturb the base sample stream.
            if pixel_seeds is not None:
                u_rr = rng_ops.uniform_hash(pixel_seeds, jnp.uint32(1000) + jnp.asarray(i, jnp.uint32))
            elif key is not None:
                u_rr = jax.random.uniform(
                    jax.random.fold_in(jax.random.fold_in(key, 1000), i), batch_shape
                )
            else:
                u_rr = jnp.broadcast_to(
                    rng_ops.wgsl_random_float(bounce_seeds[i] + jnp.uint32(977)), batch_shape
                )
            p = jnp.clip(jnp.max(throughput, axis=-1), 0.05, 1.0)
            apply_rr = i >= russian_roulette_depth
            survive = (~apply_rr) | (u_rr < p)
            scale = jnp.where(apply_rr, 1.0 / p, 1.0)
            throughput = jnp.where(
                (live & survive)[..., None], throughput * scale[..., None], throughput
            )
            live = live & survive
        out = (o, d, throughput, result, live, prev_diffuse)
        if mis:
            out = out + (prev_cos,)
        if count_rays:
            out = out + (rays,)
        return out

    carry0 = (origins, dirs, throughput, result, live, prev_diffuse0)
    if mis:
        carry0 = carry0 + (jnp.zeros(batch_shape, jnp.float32),)
    if count_rays:
        carry0 = carry0 + (jnp.zeros(batch_shape, jnp.float32),)
    out = jax.lax.fori_loop(0, max_depth, body, carry0)
    o, d, throughput, result, live = out[0], out[1], out[2], out[3], out[4]

    if parity:
        # Reference quirk: depth-exhausted rays still get sky * throughput
        # (no exhaustion test after the loop, wgsl:293-296).
        result = jnp.where(
            live[..., None],
            result + throughput * sky_color(d) * jnp.float32(sky_intensity),
            result,
        )
    if count_rays:
        return result, out[-1]
    return result


def make_bounce_seeds(color_seed_u32: Array, max_depth: int) -> Array:
    """The per-bounce scalar seeds of ray_color: hash(seed + i*1000)
    (wgsl:268), where `color_seed_u32` is the frame-uniform value the
    reference passes as ray_color's seed (update's seed+1, wgsl:355)."""
    i = jnp.arange(max_depth, dtype=jnp.uint32)
    return rng_ops.wgsl_hash(jnp.asarray(color_seed_u32, jnp.uint32) + i * jnp.uint32(1000))
