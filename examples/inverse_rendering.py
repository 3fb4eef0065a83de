"""Inverse rendering: recover scene albedos from a target image by gradient
descent through the renderer.

The north-star property (BASELINE.json) is a differentiable-by-default
renderer; this example exercises it end-to-end: render a target with the
true albedos, scramble them, and optimize d(image)/d(albedo) until the
render matches.  Discrete hit decisions use straight-through selection
(SURVEY §7 hard part 4), which is exact for albedo gradients.

Run:  python examples/inverse_rendering.py [--steps 200] [--out recovered.png]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing import CameraSettings, RenderConfig, base_scene, platform, render
from gpu_ray_tracing.utils.image import write_image

CAMERA = CameraSettings(
    look_from=jnp.asarray([0.0, 0.3, 1.5]),
    look_at=jnp.asarray([0.0, 0.0, -1.0]),
    vup=jnp.asarray([0.0, 1.0, 0.0]),
    field_of_view=jnp.float32(55.0),
    defocus_angle=jnp.float32(0.0),
    focus_distance=jnp.float32(2.5),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=72)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--backend", default="auto", choices=["auto", "jax", "pallas"],
                    help="forward engine; pallas is differentiable too (its "
                         "custom VJP replays the jax integrator)")
    args = ap.parse_args(argv)

    import optax

    backend = args.backend
    if backend == "auto":
        backend = "pallas" if platform.target() == "gpu" else "jax"
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=6, backend=backend)
    scene = base_scene()
    true_albedo = scene.albedo
    target = render(scene, CAMERA, cfg, frame_seed=jnp.uint32(0))

    opt = optax.adam(args.lr)

    @jax.jit
    def step(albedo, opt_state, i):
        def loss_fn(a):
            s = dataclasses.replace(scene, albedo=a)
            # Fresh sample stream per step: the stochastic gradient averages
            # over the sampler, like SGD over minibatches.
            img = render(s, CAMERA, cfg, frame_seed=jnp.uint32(1) + i)
            return jnp.mean((img - target) ** 2)

        loss, grad = jax.value_and_grad(loss_fn)(albedo)
        updates, opt_state = opt.update(grad, opt_state)
        albedo = jnp.clip(optax.apply_updates(albedo, updates), 0.0, 1.0)
        return albedo, opt_state, loss

    key = jax.random.key(123)
    albedo = jax.random.uniform(key, true_albedo.shape, jnp.float32)
    opt_state = opt.init(albedo)
    print(f"initial albedo error: {float(jnp.abs(albedo - true_albedo).max()):.3f}")

    for i in range(args.steps):
        albedo, opt_state, loss = step(albedo, opt_state, jnp.uint32(i))
        if i % max(1, args.steps // 10) == 0:
            err = float(jnp.abs(albedo - true_albedo).max())
            print(f"step {i:4d}  loss {float(loss):.6f}  max albedo error {err:.4f}")

    err = float(jnp.abs(albedo - true_albedo).max())
    print(f"final max albedo error: {err:.4f}")
    print("true    :", np.asarray(true_albedo).round(3).tolist())
    print("recovered:", np.asarray(albedo).round(3).tolist())

    if args.out:
        s = dataclasses.replace(scene, albedo=albedo)
        write_image(args.out, np.asarray(render(s, CAMERA, cfg, frame_seed=jnp.uint32(0))))
        print(f"wrote {args.out}")
    # Stochastic noise floor at default spp leaves ~0.1 residual on the
    # metal albedo; tighter runs want more spp/steps.
    return 0 if err < 0.15 else 1


if __name__ == "__main__":
    sys.exit(main())
