"""Frame-correlated > 4-light NEE pick: variance A/B at 32 lights.

Run:  JAX_PLATFORMS=cpu python benchmarks/light_pick_variance.py [--json f]

Above 4 lights the megakernel (and the non-regen wavefront engine) picks
ONE light ordinal per (sample, bounce) for the whole frame — a scalar
pick, read by scalar loads shared by the whole block — while the jax path
and the regenerating pool pick per lane.  Same
estimator, but at spp=s with L lights every pixel shares the same
s x depth light choices: structured, frame-correlated noise.  r3 measured
the gap at 6 lights (~0.3% at 1 spp, nil by 8 spp); this script measures
the scaling case: ~32 lights,
variance-vs-spp curves at EQUAL sample cost, plus MIS on top.

Method: 64x48, depth 4, black sky, a 31-emissive-sphere ring + floor +
diffuse hero.  For each spp in {1, 4, 16}: render N independent frames
(different frame seeds) with (a) backend='jax' (per-lane pick) and
(b) backend='pallas' in interpret mode (the scalar shared-pick stream —
the same stream the compiled engine draws), and report mean MSE against a
converged per-lane reference (jax, 2048 spp).  Equal cost: both engines
trace exactly spp samples through the identical path stream; only the
pick index stream differs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")

from gpu_ray_tracing import RenderConfig, make_scene, render
from gpu_ray_tracing.models.camera import CameraSettings
from gpu_ray_tracing.models.spheres import (
    EMISSIVE,
    LAMBERTIAN,
    make_spheres,
)

W, H = 64, 48

CAM = CameraSettings(
    look_from=jnp.asarray([0.0, 1.2, 4.0]),
    look_at=jnp.asarray([0.0, 0.6, -1.0]),
    vup=jnp.asarray([0.0, 1.0, 0.0]),
    field_of_view=jnp.float32(55.0),
    defocus_angle=jnp.float32(0.0),
    focus_distance=jnp.float32(4.0),
)


def scene_32_lights():
    """Floor + diffuse hero + 31 small emissive spheres on a ring above —
    32 sphere-light ordinals, forcing the picked-light estimator with a
    pick space wide enough that per-frame sharing could plausibly show."""
    rows = [
        ((0.0, -1000.0, 0.0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((0.0, 0.6, -1.0), 0.6, LAMBERTIAN, (0.5, 0.3, 0.3), 0.0),
    ]
    rng = np.random.default_rng(4)
    for k in range(31):
        ang = 2 * np.pi * k / 31
        r = 2.2 + 0.5 * rng.random()
        rows.append((
            (r * np.cos(ang), 1.6 + 0.8 * rng.random(), -1.0 + r * np.sin(ang)),
            0.12,
            EMISSIVE,
            tuple(0.6 + 0.4 * rng.random(3)),
            6.0,
        ))
    sc = make_scene(make_spheres(rows))
    assert sc.lights is not None and sc.lights.count == 31
    return sc


def measure(scene, mis, spps=(1, 4, 16), frames=24):
    ref_cfg = RenderConfig(width=W, height=H, spp=2048, max_depth=4,
                           sky_intensity=0.0, nee=True, mis=mis,
                           backend="jax")
    print(f"reference render (2048 spp, jax, mis={mis})...", flush=True)
    ref = np.asarray(render(scene, CAM, ref_cfg, frame_seed=jnp.uint32(999)))

    out = []
    for spp in spps:
        mses = {"jax": [], "pallas": []}
        for be in ("jax", "pallas"):
            cfg = RenderConfig(width=W, height=H, spp=spp, max_depth=4,
                               sky_intensity=0.0, nee=True, mis=mis,
                               backend=be)
            for f in range(frames):
                img = np.asarray(render(scene, CAM, cfg,
                                        frame_seed=jnp.uint32(f)))
                mses[be].append(float(((img - ref) ** 2).mean()))
        row = {
            "spp": spp, "mis": mis,
            "mse_per_lane_jax": float(np.mean(mses["jax"])),
            "mse_shared_pick_pallas": float(np.mean(mses["pallas"])),
        }
        row["ratio"] = row["mse_shared_pick_pallas"] / row["mse_per_lane_jax"]
        out.append(row)
        print(f"spp {spp:3d}  per-lane {row['mse_per_lane_jax']:.5g}  "
              f"shared-pick {row['mse_shared_pick_pallas']:.5g}  "
              f"ratio {row['ratio']:.3f}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", default=None)
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args(argv)

    scene = scene_32_lights()
    results = {"lights": 31, "resolution": f"{W}x{H}", "depth": 4,
               "frames": args.frames}
    results["nee"] = measure(scene, mis=False, frames=args.frames)
    results["nee_mis"] = measure(scene, mis=True, frames=args.frames)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
