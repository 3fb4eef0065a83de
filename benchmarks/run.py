"""Benchmark harness: configs 1-5 on one GPU, each engine in turns.

Run:  python benchmarks/run.py [--configs 1,2,3,4,5]
                               [--engines jax,pallas,wavefront]
                               [--repeats 3] [--out FILE.jsonl]
                               [--block 8x32:2,16x16:4]
                               [--quick]

  1. base scene, 800x600, 1 spp, normal shading           (primary rays)
  2. animated fly-through, 6 frames x 16 spp, depth 16     (frame loop)
  3. One-Weekend final scene (487 spheres, sphere BVH), 1280x720, depth 50
  4. icosphere(6) mesh (81,920 smooth triangles, BVH), 640x480, depth 8
  5. progressive 1080p, One-Weekend default grid, depth 20 + RR, 1 spp/step

Each (config, engine) is one jitted window of `n` frames (a device-side
loop), compiled ahead of time so compile seconds and
`memory_analysis()` are listed apart from run time.  The windows of all
engines then run in turns (engine A, B, C, A, B, C, ...) and each record
reports the median; on the GPU `block_until_ready` returns only once the
device has finished, so a window's wall time is its device time plus one
dispatch.  Traced rays per frame come from the engine-invariant in-kernel
counters (count_traced_rays).

`--block RxC:W` sweeps the megakernel's pixel block and warp count: each
value is one more engine, `pallas[RxC:W]`, run in the same turns.  Every
record carries the device, its power limit and XLA_FLAGS.  A full run
needs a GPU; `--quick` shrinks every shape for a rehearsal on the CPU
(interpret mode), which compiles and runs every window once and times
nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpu_ray_tracing import (  # noqa: E402
    CameraSettings,
    RenderConfig,
    base_scene,
    count_traced_rays,
    icosphere,
    init_accum,
    make_scene,
    one_weekend_scene,
    platform,
    progressive_step,
    render,
    render_animation,
    stack_camera_track,
    transform_mesh,
)
from gpu_ray_tracing.models.camera import orbit_yaw  # noqa: E402
from gpu_ray_tracing.ops.pallas import megakernel as mk  # noqa: E402
from gpu_ray_tracing.utils.profiling import check_plausible, device_record  # noqa: E402

#: The custom call a Pallas kernel compiled through Triton lowers to.
TRITON_CALL = "__gpu$xla.gpu.triton"

BASE_CAMERA = CameraSettings(
    look_from=jnp.asarray([0.0, 0.5, 2.0]),
    look_at=jnp.asarray([0.0, 0.0, -1.0]),
    vup=jnp.asarray([0.0, 1.0, 0.0]),
    field_of_view=jnp.float32(50.0),
    defocus_angle=jnp.float32(0.0),
    focus_distance=jnp.float32(3.0),
)


@dataclasses.dataclass
class Cell:
    """One benchmark configuration: `kind` is 'render', 'animation' or
    'progressive'; `n` frames (or steps, or tracks) per timed window."""

    name: str
    kind: str
    scene: object
    camera: object
    cfg: RenderConfig
    n: int
    info: dict


def cells(quick: bool) -> dict:
    def res(full, small):
        return small if quick else full

    out = {}
    w, h = res((800, 600), (64, 48))
    out["1"] = lambda: Cell(
        "1_base_normal_800x600", "render", base_scene(), BASE_CAMERA,
        RenderConfig(width=w, height=h, spp=1, integrator="normal"), 50, {})

    def c2():
        frames = res(6, 2)
        w, h = res((640, 480), (48, 32))
        track = stack_camera_track(
            [orbit_yaw(BASE_CAMERA, 0.15 * f) for f in range(frames)])
        return Cell("2_flythrough_16spp", "animation", base_scene(), track,
                    RenderConfig(width=w, height=h, spp=res(16, 2),
                                 max_depth=res(16, 4)),
                    1, {"track_frames": frames})

    def c3():
        scene = make_scene(one_weekend_scene(jax.random.key(0), grid_min=-11, grid_max=11))
        w, h = res((1280, 720), (64, 36))
        return Cell("3_one_weekend_487sph_d50", "render", scene,
                    CameraSettings.default(),
                    RenderConfig(width=w, height=h, spp=1, max_depth=res(50, 6)),
                    10, {"spheres": scene.spheres.count})

    def c4():
        from gpu_ray_tracing.models.spheres import LAMBERTIAN, make_spheres

        ground = make_spheres([((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
        raw = icosphere(res(6, 2), albedo=(0.75, 0.6, 0.45), smooth=True)
        mesh = transform_mesh(raw, scale=0.8, translate=(0.0, 0.8, 0.0))
        scene = make_scene(ground, mesh)
        cam = BASE_CAMERA.replace(
            look_from=jnp.asarray([0.0, 1.2, 3.0]), look_at=jnp.asarray([0.0, 0.7, 0.0]))
        w, h = res((640, 480), (48, 32))
        return Cell("4_mesh_bvh", "render", scene, cam,
                    RenderConfig(width=w, height=h, spp=1, max_depth=res(8, 4)),
                    10, {"triangles": scene.mesh.num_triangles,
                        "bvh_nodes": scene.bvh.num_nodes})

    def c5():
        scene = make_scene(one_weekend_scene(jax.random.key(0)))
        w, h = res((1920, 1080), (48, 27))
        return Cell("5_progressive_1080p", "progressive", scene,
                    CameraSettings.default(),
                    RenderConfig(width=w, height=h, spp=1024, max_depth=res(20, 4),
                                 russian_roulette_depth=5),
                    16, {"spheres": scene.spheres.count})

    out.update({"2": c2, "3": c3, "4": c4, "5": c5})
    return out


def make_window(cell: Cell, cfg: RenderConfig):
    """A jitted window of cell.n frames and its example arguments."""
    scene, cam = cell.scene, cell.camera
    if cell.kind == "render":
        def window(seed0):
            def body(i, acc):
                img = render(scene, cam, cfg, frame_seed=seed0 + i.astype(jnp.uint32))
                return acc + jnp.sum(img)
            return jax.lax.fori_loop(0, cell.n, body, jnp.float32(0))
        return jax.jit(window), (jnp.uint32(1),)
    if cell.kind == "animation":
        frames = jax.tree_util.tree_leaves(cam)[0].shape[0]

        def window(seed0):
            imgs = render_animation(scene, cam, cfg,
                                    frame_seeds=jnp.full((frames,), seed0, jnp.uint32))
            return jnp.sum(imgs)
        return jax.jit(window), (jnp.uint32(1),)

    def window(state):
        def body(_, st):
            return progressive_step(st, scene, cam, cfg, frame_seed=jnp.uint32(0))
        st = jax.lax.fori_loop(0, cell.n, body, state)
        return st
    return jax.jit(window), (init_accum(cfg.height, cfg.width),)


def variants(engines, blocks):
    """(label, backend, block) for every engine to run."""
    out = []
    for e in engines:
        if e != "pallas" or not blocks:
            out.append((e, e, None))
            continue
        for r, c, w in blocks:
            out.append((f"pallas[{r}x{c}:{w}]", e, (r, c, w)))
    return out


def set_blocks(path_block, aov_block):
    """Point the Pallas engines at block shapes (module constants are
    read at trace time; caches are dropped so the next trace sees them)."""
    mk.PATH_BLOCK, mk.AOV_BLOCK = path_block, aov_block
    jax.clear_caches()


def run_cell(cell: Cell, runs, repeats: int, emit) -> None:
    default = (mk.PATH_BLOCK, mk.AOV_BLOCK)
    compiled = {}
    for label, backend, block in runs:
        if backend == "wavefront" and cell.cfg.integrator != "path":
            continue  # the wavefront engine traces paths only
        set_blocks(*((block, block) if block else default))
        cfg = dataclasses.replace(cell.cfg, backend=backend)
        fn, args = make_window(cell, cfg)
        t0 = time.perf_counter()
        lowered = fn.lower(*args)
        exe = lowered.compile()
        compile_s = time.perf_counter() - t0
        mem = exe.memory_analysis()
        triton_calls = lowered.as_text().count(TRITON_CALL)
        t0 = time.perf_counter()
        out = jax.block_until_ready(exe(*args))  # first run, untimed
        first_s = time.perf_counter() - t0
        compiled[label] = (exe, args, compile_s, first_s, mem, out)
        emit({"event": "compiled", "config": cell.name, "engine": label,
              "compile_s": compile_s, "first_run_s": first_s,
              "triton_calls": triton_calls,
              "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
              "argument_bytes": getattr(mem, "argument_size_in_bytes", None),
              "output_bytes": getattr(mem, "output_size_in_bytes", None)})
    set_blocks(*default)
    if platform.target() != "gpu":
        return  # a CPU rehearsal checks that every window runs; it times nothing

    times = {k: [] for k in compiled}
    for _ in range(repeats):
        for label, (exe, args, *_rest) in compiled.items():
            t0 = time.perf_counter()
            jax.block_until_ready(exe(*args))
            times[label].append(time.perf_counter() - t0)

    rays = None
    if cell.kind != "animation":
        rays = count_traced_rays(cell.scene, cell.camera,
                                 dataclasses.replace(cell.cfg, spp=1),
                                 frame_seed=jnp.uint32(1))["rays_traced"]
    dev = device_record()
    for label, (_, _, compile_s, first_s, _, out) in compiled.items():
        ws = sorted(times[label])
        med = ws[len(ws) // 2]
        unit = med / cell.n
        rec = {"event": "timed", "config": cell.name, "engine": label,
               "ms_per_frame": unit * 1e3, "windows_s": times[label],
               "frames_per_window": cell.n, "compile_s": compile_s,
               "first_run_s": first_s, **cell.info, **dev}
        if rays:
            rec["rays_traced_per_frame"] = rays
            rec["true_mrays_per_sec"] = rays / unit / 1e6
            check_plausible(rec["true_mrays_per_sec"], dev["device_kind"])
        emit(rec)


def _parse_blocks(text):
    out = []
    for item in filter(None, text.split(",")):
        shape, warps = item.split(":")
        r, c = shape.split("x")
        out.append((int(r), int(c), int(warps)))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--engines", default="jax,pallas,wavefront")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--block", default="", help="megakernel sweep, e.g. 8x32:2,16x16:4")
    ap.add_argument("--out", default=None, help="append JSON lines here")
    ap.add_argument("--quick", action="store_true", help="tiny shapes (CPU rehearsal)")
    args = ap.parse_args(argv)

    platform.use_compile_cache()
    if platform.target() != "gpu" and not args.quick:
        raise SystemExit("benchmarks/run.py measures a GPU; use --quick to rehearse on the CPU")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    emit({"event": "device", **device_record()})
    runs = variants(args.engines.split(","), _parse_blocks(args.block))
    table = cells(args.quick)
    for cid in args.configs.split(","):
        run_cell(table[cid.strip()](), runs, args.repeats, emit)


if __name__ == "__main__":
    main()
