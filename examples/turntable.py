"""Turntable animation: orbit the camera around a scene and write a GIF.

The offline equivalent of the reference's interactive arrow-key orbit
(camera.rs:170-206): the camera path is data (`stack_camera_track`), the
whole track renders in one jitted `render_animation` call, and the frames
encode to an animated GIF.

Run:  python examples/turntable.py --frames 36 --out turntable.gif
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing import platform

platform.use_compile_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--out", default="turntable.gif")
    ap.add_argument("--fps", type=int, default=12)
    args = ap.parse_args(argv)

    import gpu_ray_tracing as rt
    from gpu_ray_tracing.models.camera import orbit_yaw
    from gpu_ray_tracing.utils.image import to_uint8, tonemap

    scene = rt.make_scene(rt.one_weekend_scene(jax.random.key(0)))
    backend = "pallas" if rt.platform.target() == "gpu" else "jax"
    cfg = rt.RenderConfig(
        width=args.width, height=args.height, spp=args.spp, max_depth=args.depth,
        backend=backend, russian_roulette_depth=4,
    )
    step = 2.0 * np.pi / args.frames
    track = rt.stack_camera_track(
        [orbit_yaw(rt.CameraSettings.default(), step * f) for f in range(args.frames)]
    )
    frames = np.asarray(
        rt.render_animation(
            scene, track, cfg,
            frame_seeds=jnp.arange(args.frames, dtype=jnp.uint32),
        )
    )
    imgs = [to_uint8(tonemap(f)) for f in frames]
    try:
        from PIL import Image
    except ImportError:
        from gpu_ray_tracing.utils.image import write_ppm

        os.makedirs("turntable_frames", exist_ok=True)
        for i, f in enumerate(frames):
            write_ppm(f"turntable_frames/frame_{i:04d}.ppm", f)
        print("PIL unavailable; wrote PPM frames to turntable_frames/")
        return 0
    pil = [Image.fromarray(f) for f in imgs]
    pil[0].save(
        args.out, save_all=True, append_images=pil[1:],
        duration=int(1000 / args.fps), loop=0,
    )
    print(f"wrote {args.out} ({args.frames} frames, {cfg.width}x{cfg.height}, "
          f"{cfg.spp} spp, backend={backend})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
