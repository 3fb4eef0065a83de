"""Headline benchmark: the megakernel's throughput on one GPU.

Prints ONE JSON line:
  {"metric": "primary_ray_throughput_1080p", "value": N, "unit": "Mrays/sec",
   "ms_per_frame": N, "path_metric": {...}, "device": {...}}

  - primary: config 1's scene (two spheres + ground) at 1920x1080, 1 spp,
    normal shading — one primary ray per pixel;
  - path_metric: the One-Weekend final scene (487 spheres, sphere BVH) at
    1280x720, depth 50, with the rays traced per frame counted by the
    in-kernel counters (`count_traced_rays`), not the primary-ray proxy.

Both run on the Pallas megakernel compiled through Triton, the engine the
benchmark measured fastest (PERF.md).  Each timed window is one jitted
device-side loop of frames; `block_until_ready` returns once the card has
finished, and the median of five windows is reported.  Compile seconds are
set-up and reported apart.  The record names the device, its power limit
and XLA_FLAGS.  Needs a GPU: the CPU has no number to report here.

Run `python benchmarks/run.py` for the five-config suite.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _time(cell, repeats: int = 5) -> dict:
    """Compile the cell's window, then time `repeats` windows of it."""
    import jax

    from benchmarks.run import make_window

    fn, args = make_window(cell, cell.cfg)
    t0 = time.perf_counter()
    exe = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(exe(*args))
    windows = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(exe(*args))
        windows.append(time.perf_counter() - t0)
    med = sorted(windows)[len(windows) // 2]
    return {"ms_per_frame": med / cell.n * 1e3, "windows_s": windows,
            "frames_per_window": cell.n, "compile_s": compile_s}


def main() -> None:
    import jax
    import jax.numpy as jnp

    from benchmarks.run import BASE_CAMERA, Cell
    from gpu_ray_tracing import (
        CameraSettings, RenderConfig, base_scene, count_traced_rays, make_scene,
        one_weekend_scene, platform,
    )
    from gpu_ray_tracing.utils.profiling import check_plausible, device_record

    platform.use_compile_cache()
    if platform.target() != "gpu":
        raise SystemExit("bench.py measures a GPU and found none")
    dev = device_record()

    primary = Cell("primary_1080p", "render", base_scene(), BASE_CAMERA,
                   RenderConfig(width=1920, height=1080, spp=1,
                                integrator="normal", backend="pallas"),
                   200, {})
    p = _time(primary)
    mrays = 1920 * 1080 / (p["ms_per_frame"] * 1e-3) / 1e6
    check_plausible(mrays, dev["device_kind"])

    scene = make_scene(one_weekend_scene(jax.random.key(0), grid_min=-11, grid_max=11))
    path = Cell("one_weekend_d50_720p", "render", scene, CameraSettings.default(),
                RenderConfig(width=1280, height=720, spp=1, max_depth=50,
                             backend="pallas"),
                5, {})
    q = _time(path)
    rays = count_traced_rays(path.scene, path.camera, path.cfg,
                             frame_seed=jnp.uint32(1))["rays_traced"]
    q["rays_traced_per_frame"] = rays
    q["true_mrays_per_sec"] = rays / (q["ms_per_frame"] * 1e-3) / 1e6
    check_plausible(q["true_mrays_per_sec"], dev["device_kind"])

    print(json.dumps({
        "metric": "primary_ray_throughput_1080p",
        "value": mrays,
        "unit": "Mrays/sec",
        **p,
        "path_metric": {"metric": "one_weekend_d50_720p_path", **q},
        "device": dev,
    }))


if __name__ == "__main__":
    main()
