"""Smoke test of the path tracer on NVIDIA GPUs, through its public entry points.

Run from the repository root on a machine with a GPU:

  python chip_smoke.py               # one card
  python chip_smoke.py --four-cards  # the sharded renderers on four cards

One card, one process, in phases (none is caught; the first failure ends
the run with a traceback and no result line):

  1. device: JAX's first device must be a GPU; prints the card's name and
     power limit as nvidia-smi reports them;
  2. main path: the One-Weekend final scene (487 spheres, sphere BVH) at
     1280x720, depth 50, through `render` with each Pallas engine
     (megakernel, wavefront) and the plain `jax` reference; then a few
     `progressive_step` frames, a camera move with reset (the count must
     restart at 1);
  3. the config-4 mesh (icosphere(6), 81,920 smooth triangles, BVH) at
     640x480, depth 8, and the Cornell box with NEE+MIS, each engine
     against the reference;
  4. the in-kernel ray counters (`count_traced_rays`) against the
     reference integrator's counters, and one `jax.value_and_grad` through
     `render` with respect to the sphere albedos;
  5. compile report: every program is compiled ahead of time; its compile
     seconds and `memory_analysis()` are printed, and every Pallas program
     must hold the Triton kernel (never the interpreter).

Comparisons run under `jax.default_matmul_precision("highest")`.  Both
sides draw the same counter-based random stream, so images agree except
where float rounding flips a decision (a hit, a refraction, a material
branch) and sends one pixel's path elsewhere.  A pixel "flips" when it
differs by more than 1e-3.  Every comparison holds three bounds:

  - at most FLIP_FRAC of the pixels flip (tests/test_sharding.py's bound);
  - the pixels that did not flip agree to UNFLIPPED_TOL in mean — the
    rounding-level agreement of the same arithmetic;
  - the mean over all pixels stays below a per-case bound.  Sharded and
    unsharded renders run the same engine, and keep MEAN_TOL = 1e-4.
    An engine against the `jax` reference keeps PATH_MEAN_TOL = 1e-3: the
    two compute the same quadratic in another order (XLA's matmul form
    against the kernel's per-sphere broadcast), so sub-ulp differences
    arise, and on these specular scenes a flipped pixel carries a whole
    other path, ~0.15 from the reference on average at depth 8 and 50
    alike (measured in interpret mode on the One-Weekend scene, where the
    flips are 0.7% of the pixels and the unflipped ones agree to ~3e-6).
    So the all-pixel mean is about FLIP_FRAC x 0.1, not a rounding error.

Where samples are averaged (spp > 1) each sample flips independently, so
the flip bound scales with the samples a pixel folds: the Cornell box at 4
spp behind a glass lens and a 15x lamp, and three progressive steps, allow
3%.

`--four-cards` runs only `render_sharded` and `progressive_step_sharded` on
meshes of (4 row shards x 1) and (2 x 2) over four GPUs, each compared
with the one-card render of the same stream.

Every line before the last is a JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

TRITON_CALL = "__gpu$xla.gpu.triton"
FLIP_FRAC = 0.01
UNFLIPPED_TOL = 1e-5
MEAN_TOL = 1e-4
PATH_MEAN_TOL = 1e-3

CARD = None  # "name, power limit" from nvidia-smi, stamped on every record


def log(**rec) -> None:
    print(json.dumps({**rec, "card": CARD}), flush=True)


def check_device(count: int):
    """Phase 1: a GPU (`count` of them), and its name and power limit."""
    global CARD
    import jax

    from gpu_ray_tracing import platform
    from gpu_ray_tracing.utils.profiling import nvidia_smi

    devs = jax.devices()
    if platform.target(devs) != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {devs[0].platform}")
    if len(devs) < count:
        raise SystemExit(f"needs {count} GPUs; JAX found {len(devs)}")
    CARD = nvidia_smi()
    if CARD is None:
        raise SystemExit("nvidia-smi did not report the card")
    print(CARD, flush=True)
    log(phase="device", platform=devs[0].platform, kind=devs[0].device_kind,
        count=len(devs), xla_flags=os.environ.get("XLA_FLAGS", ""))
    return devs


def check_route(name: str, lowered_text: str, kernel: bool) -> int:
    """A Pallas program must hold the Triton kernel, the reference none.
    Interpret mode lowers a kernel to plain HLO; the compiled Triton route
    leaves one custom call per pallas_call."""
    triton = lowered_text.count(TRITON_CALL)
    if kernel:
        assert triton >= 1, f"{name}: no Triton kernel"
    else:
        assert triton == 0, f"{name}: the reference must not call a kernel"
    return triton


def compile_program(name: str, fn, *args, kernel: bool):
    """Phase 5, per program: compile ahead of time, report, check route."""
    import jax

    lowered = jax.jit(fn).lower(*args)
    t0 = time.perf_counter()
    exe = lowered.compile()
    compile_s = time.perf_counter() - t0
    mem = exe.memory_analysis()
    log(phase="compile", program=name, compile_s=compile_s,
        triton_calls=lowered.as_text().count(TRITON_CALL),
        temp_bytes=mem.temp_size_in_bytes,
        argument_bytes=mem.argument_size_in_bytes,
        output_bytes=mem.output_size_in_bytes)
    check_route(name, lowered.as_text(), kernel)
    if kernel:
        assert "triton" in exe.as_text(), f"{name}: no Triton kernel compiled"
    return exe


def run(name: str, exe, *args):
    import jax
    import numpy as np

    t0 = time.perf_counter()
    out = jax.block_until_ready(exe(*args))
    log(phase="run", program=name, seconds=time.perf_counter() - t0)
    return np.asarray(out)


def compare(name: str, got, want, flip_frac=FLIP_FRAC, mean_tol=MEAN_TOL) -> bool:
    """Log one comparison against its bounds; True if it holds them."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    d = np.abs(got - want)
    flipped = d.max(axis=-1) > 1e-3
    flip = float(flipped.mean())
    unflipped = float(d[~flipped].mean()) if (~flipped).any() else 0.0
    mean = float(d.mean())
    finite = bool(np.isfinite(got).all())
    ok = finite and flip <= flip_frac and unflipped < UNFLIPPED_TOL and mean < mean_tol
    log(phase="compare", case=name, ok=ok, shape=list(got.shape), flip_frac=flip,
        unflipped_mean_abs=unflipped, mean_abs=mean, max_abs=float(d.max()),
        finite=finite, limits={"flip_frac": flip_frac,
                               "unflipped_mean_abs": UNFLIPPED_TOL,
                               "mean_abs": mean_tol})
    return ok


def holds(phase: str, oks) -> None:
    """End of a phase: every comparison logged above must have held."""
    oks = list(oks)
    assert all(oks), f"{phase}: {oks.count(False)} comparison(s) out of bounds (see the log)"


def engines_vs_reference(name, scene, camera, cfg, seed=1, flip_frac=FLIP_FRAC):
    """Render with the reference and each Pallas engine; compare.  Returns
    one flag per engine."""
    import jax.numpy as jnp

    from gpu_ray_tracing import render

    imgs = {}
    for backend in ("jax", "pallas", "wavefront"):
        c = dataclasses.replace(cfg, backend=backend)
        fn = lambda s, cam, c=c: render(s, cam, c, frame_seed=jnp.uint32(seed))
        exe = compile_program(f"{name}/{backend}", fn, scene, camera,
                              kernel=backend != "jax")
        imgs[backend] = run(f"{name}/{backend}", exe, scene, camera)
    return [compare(f"{name}/{backend}", imgs[backend], imgs["jax"],
                    flip_frac=flip_frac, mean_tol=PATH_MEAN_TOL)
            for backend in ("pallas", "wavefront")]


def main_path():
    """Phase 2: One-Weekend 1280x720 depth 50, then progressive steps."""
    import jax
    import jax.numpy as jnp

    from gpu_ray_tracing import (
        CameraSettings, RenderConfig, init_accum, make_scene, one_weekend_scene,
        progressive_step, render,
    )
    from gpu_ray_tracing.models.camera import orbit_yaw

    scene = make_scene(one_weekend_scene(jax.random.key(0), grid_min=-11, grid_max=11))
    cam = CameraSettings.default()
    cfg = RenderConfig(width=1280, height=720, spp=1, max_depth=50)
    assert scene.sphere_bvh is not None
    oks = engines_vs_reference("one_weekend_1280x720_d50", scene, cam, cfg)

    # Progressive: three steps per engine, then a camera move with reset.
    pcfg = dataclasses.replace(cfg, spp=64)
    step = jax.jit(
        lambda st, s, c, reset, cfg: progressive_step(
            st, s, c, cfg, frame_seed=jnp.uint32(5), reset=reset),
        static_argnames="cfg")
    states = {}
    for backend in ("jax", "pallas"):
        c = dataclasses.replace(pcfg, backend=backend)
        st = init_accum(cfg.height, cfg.width)
        for _ in range(3):
            st = step(st, scene, cam, False, c)
        assert int(st.count) == 3, int(st.count)
        states[backend] = st
    oks.append(compare("progressive_3_steps/pallas", states["pallas"].rgb,
                       states["jax"].rgb, flip_frac=3 * FLIP_FRAC,
                       mean_tol=PATH_MEAN_TOL))

    c = dataclasses.replace(pcfg, backend="pallas")
    moved = orbit_yaw(cam, 0.2)
    st = step(states["pallas"], scene, moved, True, c)
    assert int(st.count) == 1, f"reset must restart the count, got {int(st.count)}"
    first = render(scene, moved, dataclasses.replace(c, spp=1), frame_seed=jnp.uint32(5))
    oks.append(compare("progressive_reset/pallas", st.rgb, first))
    st = step(st, scene, moved, False, c)
    assert int(st.count) == 2
    log(phase="progressive", counts=[3, 1, 2])
    holds("main path", oks)


def mesh_and_lights():
    """Phase 3: the config-4 mesh and the Cornell box with NEE+MIS."""
    import jax.numpy as jnp

    from gpu_ray_tracing import (
        CameraSettings, RenderConfig, cornell_box_scene, cornell_camera, icosphere,
        make_scene, transform_mesh,
    )
    from gpu_ray_tracing.models.spheres import LAMBERTIAN, make_spheres

    ground = make_spheres([((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    mesh = transform_mesh(icosphere(6, albedo=(0.75, 0.6, 0.45), smooth=True),
                          scale=0.8, translate=(0.0, 0.8, 0.0))
    scene = make_scene(ground, mesh)
    assert scene.mesh.num_triangles == 81920
    cam = CameraSettings(
        look_from=jnp.asarray([0.0, 1.2, 3.0]), look_at=jnp.asarray([0.0, 0.7, 0.0]),
        vup=jnp.asarray([0.0, 1.0, 0.0]), field_of_view=jnp.float32(50.0),
        defocus_angle=jnp.float32(0.0), focus_distance=jnp.float32(3.0))
    oks = engines_vs_reference("mesh_81920_640x480_d8", scene, cam,
                               RenderConfig(width=640, height=480, spp=1, max_depth=8))
    oks += engines_vs_reference(
        "cornell_nee_mis_512x512_d8", cornell_box_scene(), cornell_camera(),
        RenderConfig(width=512, height=512, spp=4, max_depth=8, nee=True,
                     mis=True, sky_intensity=0.0),
        flip_frac=3 * FLIP_FRAC)
    holds("mesh and lights", oks)


def counters_and_gradient():
    """Phase 4: kernel ray counters vs the reference's; one gradient."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpu_ray_tracing import (
        CameraSettings, RenderConfig, count_traced_rays, make_scene,
        one_weekend_scene, render,
    )
    from gpu_ray_tracing.models.camera import derive_camera
    from gpu_ray_tracing.ops import rays as rays_ops
    from gpu_ray_tracing.ops.integrators import trace_path

    scene = make_scene(one_weekend_scene(jax.random.key(0), grid_min=-11, grid_max=11))
    cfg = RenderConfig(width=1280, height=720, spp=1, max_depth=50, backend="pallas")
    cam = derive_camera(CameraSettings.default(), cfg.width, cfg.height)
    kern = count_traced_rays(scene, cam, cfg, frame_seed=jnp.uint32(7), return_map=True)

    @jax.jit
    def reference_counts(scene, cam):
        o, d, seeds = rays_ops.generate_rays_hash(
            cam, cfg.width, cfg.height, jnp.uint32(0), jnp.uint32(7))
        return trace_path(o, d, scene, cfg.max_depth, cfg.t_min, cfg.t_max,
                          pixel_seeds=seeds, count_rays=True)[1]

    ref = np.asarray(reference_counts(scene, cam))
    got = np.asarray(kern["map"])
    differ = float((got != ref).mean())
    total_ref = float(ref.sum(dtype=np.float64))
    rel = abs(kern["rays_traced"] - total_ref) / total_ref
    log(phase="counters", rays_traced=kern["rays_traced"], reference=total_ref,
        rel_diff=rel, pixels_differing=differ, limit=FLIP_FRAC)
    counters_ok = differ <= FLIP_FRAC and rel <= FLIP_FRAC

    small = RenderConfig(width=320, height=180, spp=2, max_depth=8, backend="pallas")

    def loss(albedo):
        s = dataclasses.replace(scene, spheres=dataclasses.replace(scene.spheres, albedo=albedo))
        return jnp.mean(render(s, CameraSettings.default(), small, frame_seed=jnp.uint32(2)))

    t0 = time.perf_counter()
    value, grad = jax.value_and_grad(loss)(scene.spheres.albedo)
    grad = np.asarray(grad)
    log(phase="gradient", seconds=time.perf_counter() - t0, loss=float(value),
        grad_abs_max=float(np.abs(grad).max()), finite=bool(np.isfinite(grad).all()))
    assert np.isfinite(float(value)) and np.isfinite(grad).all()
    assert float(np.abs(grad).max()) > 0.0
    assert counters_ok, "ray counters differ from the reference's beyond the bound"


def four_cards():
    """The sharded renderers on four cards vs the one-card render (same
    engine, same stream: the sharding bound of tests/test_sharding.py)."""
    import jax
    import jax.numpy as jnp

    from gpu_ray_tracing import (
        CameraSettings, RenderConfig, init_accum, make_scene, one_weekend_scene,
        progressive_step, render,
    )
    from gpu_ray_tracing.parallel.mesh import make_mesh
    from gpu_ray_tracing.parallel.sharding import (
        progressive_step_sharded, render_sharded, shard_accum_state,
    )

    scene = make_scene(one_weekend_scene(jax.random.key(0), grid_min=-11, grid_max=11))
    cam = CameraSettings.default()
    oks = []
    for backend in ("pallas", "jax"):
        cfg = RenderConfig(width=1280, height=720, spp=4, max_depth=50, backend=backend)
        one = render(scene, cam, cfg, frame_seed=jnp.uint32(3))
        pcfg = dataclasses.replace(cfg, spp=64)
        st1 = init_accum(cfg.height, cfg.width)
        for _ in range(4):
            st1 = progressive_step(st1, scene, cam, pcfg, frame_seed=jnp.uint32(3))
        for rows, spp_shards in ((4, 1), (2, 2)):
            mesh = make_mesh(rows, spp_shards)
            tag = f"{backend}/mesh_{rows}x{spp_shards}"
            lowered = render_sharded.lower(scene, cam, cfg, mesh, frame_seed=jnp.uint32(3))
            check_route(tag, lowered.as_text(), kernel=backend == "pallas")
            t0 = time.perf_counter()
            img = jax.block_until_ready(
                render_sharded(scene, cam, cfg, mesh, frame_seed=jnp.uint32(3)))
            log(phase="run", program=f"render_sharded/{tag}",
                seconds=time.perf_counter() - t0)
            oks.append(compare(f"render_sharded/{tag}", img, one))
            st = shard_accum_state(init_accum(cfg.height, cfg.width), mesh)
            for _ in range(4 // spp_shards):
                st = progressive_step_sharded(st, scene, cam, pcfg, mesh,
                                              frame_seed=jnp.uint32(3))
            assert int(st.count) == 4, int(st.count)
            oks.append(compare(f"progressive_step_sharded/{tag}", st.rgb, st1.rgb))
    holds("four cards", oks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded renderers on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from gpu_ray_tracing import platform

    platform.use_compile_cache()
    devs = check_device(4 if args.four_cards else 1)
    with jax.default_matmul_precision("highest"):
        if args.four_cards:
            four_cards()
        else:
            main_path()
            mesh_and_lights()
            counters_and_gradient()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
