"""Offline high-spp accumulation: batched steps + checkpoints.

The production shape for converging a frame to hundreds of samples when no
one is watching frame-by-frame (the reference can only accumulate 1 spp per
displayed frame, compute_shader.wgsl:352-358):

  - `progressive_step(spp_per_step=k)` folds k samples per step (weighted
    incremental mean), cutting per-step dispatch overhead by k; on the GPU
    each step is one megakernel launch;
  - the accumulation state checkpoints to .npz every few windows, so a
    multi-hour render survives preemption and resumes exactly (the state is
    the running mean + count; the counter-based RNG draws sample `count`
    identically on resume).

Run:  python examples/offline_accumulate.py --spp 256 --out render.png
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

from gpu_ray_tracing import platform

platform.use_compile_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=256, help="total samples to reach")
    ap.add_argument("--spp-per-step", type=int, default=8)
    ap.add_argument("--depth", type=int, default=20)
    ap.add_argument("--rr", type=int, default=5, metavar="DEPTH",
                    help="russian-roulette start depth (0 = off)")
    ap.add_argument("--checkpoint", default="accum.npz")
    ap.add_argument("--checkpoint-every", type=int, default=4,
                    help="checkpoint every N batched steps")
    ap.add_argument("--preview-every", type=int, default=0, metavar="N",
                    help="also write <out>_preview every N steps (0 = off), "
                         "independent of --checkpoint-every")
    ap.add_argument("--out", default="render.png")
    args = ap.parse_args(argv)

    import gpu_ray_tracing as rt
    from gpu_ray_tracing.utils.checkpoint import (
        load_accum,
        render_fingerprint,
        save_accum,
    )
    from gpu_ray_tracing.utils.image import write_image

    scene = jax.device_put(rt.make_scene(rt.one_weekend_scene(jax.random.key(0))))
    backend = "pallas" if rt.platform.target() == "gpu" else "jax"
    cfg = rt.RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        max_depth=args.depth, backend=backend,
        russian_roulette_depth=args.rr,
    )
    cam = rt.CameraSettings.default()

    # Stamp checkpoints with the render identity so a resume against a
    # mismatched scene/seed/config fails loudly instead of folding garbage.
    fingerprint = render_fingerprint(scene, cfg, frame_seed=jnp.uint32(0))
    if os.path.exists(args.checkpoint):
        state = load_accum(args.checkpoint, expect_fingerprint=fingerprint)
        print(f"resumed {args.checkpoint} at {int(state.count)} spp")
    else:
        state = rt.init_accum(cfg.height, cfg.width)

    t0 = time.time()
    step = 0
    while int(state.count) < args.spp:
        state = rt.progressive_step(
            state, scene, cam, cfg, frame_seed=jnp.uint32(0),
            spp_per_step=args.spp_per_step,
        )
        step += 1
        if step % args.checkpoint_every == 0:
            jax.block_until_ready(state.rgb)
            save_accum(args.checkpoint, state, fingerprint=fingerprint)
            n = int(state.count)
            print(f"{n}/{args.spp} spp  ({n / max(time.time() - t0, 1e-9):.1f} spp/s)")
        if args.preview_every and step % args.preview_every == 0:
            # Inspectable mid-run snapshot (the offline answer to the
            # reference's live progressive window, lib.rs:96-102).  Own
            # cadence — previews must not gate on the checkpoint interval.
            root, ext = os.path.splitext(args.out)
            written = write_image(
                f"{root}_preview{ext or '.png'}", np.asarray(state.rgb)
            )
            print(f"preview -> {written}")

    save_accum(args.checkpoint, state, fingerprint=fingerprint)
    written = write_image(args.out, np.asarray(state.rgb))
    print(f"wrote {written} at {int(state.count)} spp")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
