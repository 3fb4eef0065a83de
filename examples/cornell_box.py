"""The Cornell box: triangle lights + NEE/MIS on the canonical scene.

An enclosed box lit by one small ceiling quad is the worst case for the
reference's pure BSDF sampling (compute_shader.wgsl:236-291): a random
cosine bounce almost never finds the lamp, so images stay black-noisy for
thousands of samples.  The round-4 triangle-light extension samples the
lamp's area directly at every diffuse vertex (Scene.tri_lights; docs/
ARCHITECTURE.md "Light sampling"), and MIS keeps the mirror/glass spheres'
view of the lamp unbiased.  Compare for yourself with --no-nee.

Run:  python examples/cornell_box.py [--spp 64] [--out cornell.png]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing import (
    RenderConfig,
    cornell_box_scene,
    cornell_camera,
    render,
)
from gpu_ray_tracing import platform
from gpu_ray_tracing.utils.image import write_image

platform.use_compile_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--light", type=float, default=15.0,
                    help="lamp emission scale")
    ap.add_argument("--no-nee", action="store_true",
                    help="the reference's estimator: BSDF sampling only "
                         "(watch the noise)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "jax", "pallas", "wavefront"])
    ap.add_argument("--out", default="cornell.png")
    args = ap.parse_args(argv)

    backend = args.backend
    if backend == "auto":
        backend = "pallas" if platform.target() == "gpu" else "jax"
    scene = cornell_box_scene(light_intensity=args.light)
    cfg = RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        max_depth=args.max_depth, backend=backend,
        nee=not args.no_nee, mis=not args.no_nee, sky_intensity=0.0,
    )
    t0 = time.perf_counter()
    img = np.asarray(render(scene, cornell_camera(), cfg,
                            frame_seed=jnp.uint32(0)))
    dt = time.perf_counter() - t0
    print(f"{args.width}x{args.height} @ {args.spp} spp, depth "
          f"{args.max_depth}, backend={backend}, "
          f"nee={'off' if args.no_nee else 'on+mis'}: {dt:.1f}s "
          f"(incl. compile)")
    write_image(args.out, img)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
