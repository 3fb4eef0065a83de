"""Command-line interface: offline renders, animations, progressive sessions.

The reference's only entry point is an interactive window (`run()`,
lib.rs:28, driven by keyboard state camera.rs:125-253).  A batch renderer
is headless, so the interaction model becomes explicit commands:

  python -m gpu_ray_tracing render   --scene one-weekend --out img.png
  python -m gpu_ray_tracing animate  --frames 24 --out-dir frames/
  python -m gpu_ray_tracing progressive --steps 64 --checkpoint c.npz
  python -m gpu_ray_tracing bench    --quick

`progressive` resumes from its checkpoint file if present — the durable
version of the reference's in-texture accumulation (wgsl:339-363).
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np



def _nonneg_int(text: str):
    v = int(text)
    if v < 0:
        raise argparse.ArgumentTypeError(f"expected >= 0, got {text!r}")
    return v


def _vec3(text: str):
    parts = [float(x) for x in text.split(",")]
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"expected x,y,z got {text!r}")
    return jnp.asarray(parts, jnp.float32)


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--scene", default="one-weekend",
                    choices=["base", "one-weekend", "one-weekend-full", "mesh",
                             "night", "cornell"])
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=30)
    ap.add_argument("--integrator", default="path",
                    choices=["path", "normal", "albedo", "depth"],
                    help="albedo/depth render first-hit AOV guide "
                         "channels (e.g. for external denoisers)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "jax", "pallas", "wavefront"])
    ap.add_argument("--rng", default="hash", choices=["hash", "wgsl", "threefry"])
    ap.add_argument("--sampler", default="independent",
                    choices=["independent", "stratified", "sobol"],
                    help="sample generator; 'stratified' (jittered grid) and "
                         "'sobol' (Owen-scrambled (0,2)-sequence, best at "
                         "power-of-two spp) lower variance at equal spp "
                         "(both require --rng hash)")
    ap.add_argument("--regenerate", default="off", choices=["auto", "on", "off"],
                    help="wavefront ray regeneration: refill dead ray rows "
                         "with the next sample's primaries (spp > 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nee", action="store_true",
                    help="next-event estimation (needs emissive lights)")
    ap.add_argument("--mis", action="store_true",
                    help="multiple importance sampling of NEE vs BSDF rays "
                         "(requires --nee; lower variance for large/close "
                         "lights; any light count)")
    ap.add_argument("--sky-intensity", type=float, default=1.0)
    ap.add_argument("--russian-roulette", type=int, default=0, metavar="DEPTH",
                    help="RR termination from this bounce (0 = off)")
    ap.add_argument("--clamp", type=float, default=0.0,
                    help="per-sample radiance clamp (firefly control; "
                         "0 = off; biased, try 5-50)")
    ap.add_argument("--adaptive-tol", type=float, default=0.0,
                    help="adaptive sampling tolerance (render command only; "
                         "megakernel): > 0 makes --spp a per-tile budget — "
                         "tiles stop sampling once their relative standard "
                         "error drops below this (try 0.01-0.05)")
    ap.add_argument("--adaptive-min-spp", type=int, default=8,
                    help="samples every tile takes before the adaptive "
                         "convergence test may stop it")
    ap.add_argument("--scene-seed", type=int, default=0)
    ap.add_argument("--obj", default=None, help="OBJ file for --scene mesh")
    ap.add_argument("--look-from", type=_vec3, default=None)
    ap.add_argument("--look-at", type=_vec3, default=None)
    ap.add_argument("--fov", type=float, default=None)
    ap.add_argument("--defocus-angle", type=float, default=None)
    ap.add_argument("--focus-distance", type=float, default=None)
    ap.add_argument("--gamma", type=float, default=2.2)


def _build_scene(args):
    import gpu_ray_tracing as rt

    key = jax.random.key(args.scene_seed)
    if args.scene == "base":
        return rt.base_scene()
    if args.scene == "one-weekend":
        return rt.one_weekend_scene(key).pad_to_multiple(128)
    if args.scene == "one-weekend-full":
        return rt.one_weekend_scene(key, grid_min=-11, grid_max=11).pad_to_multiple(128)
    if args.scene == "night":
        from gpu_ray_tracing.models.spheres import (
            DIELECTRIC, EMISSIVE, LAMBERTIAN, METAL, make_spheres,
        )

        return rt.make_scene(make_spheres([
            ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.65, 0.65, 0.65), 0.0),
            ((0.0, 2.6, -1.0), 0.7, EMISSIVE, (1.0, 0.85, 0.6), 8.0),
            ((-2.4, 0.5, -0.5), 0.5, METAL, (0.9, 0.9, 0.95), 0.03),
            ((2.0, 0.5, -1.0), 0.5, DIELECTRIC, (1, 1, 1), 1.5),
            ((0.0, 0.5, -1.0), 0.5, LAMBERTIAN, (0.2, 0.4, 0.8), 0.0),
            ((-4.5, 1.2, -4.0), 0.8, EMISSIVE, (0.4, 0.6, 1.0), 6.0),
        ]))
    if args.scene == "cornell":
        # Triangle lights end to end (pair with --nee --mis
        # --sky-intensity 0; the box is closed, all light is the lamp).
        return rt.cornell_box_scene()
    # mesh scene: ground + mesh object (OBJ or bunny stand-in)
    from gpu_ray_tracing.models.mesh import bunny_stand_in, load_obj
    from gpu_ray_tracing.models.spheres import LAMBERTIAN, make_spheres

    ground = make_spheres([((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    mesh = load_obj(args.obj) if args.obj else bunny_stand_in(albedo=(0.75, 0.6, 0.45))
    mesh = rt.transform_mesh(mesh, scale=0.8, translate=(0.0, 0.8, 0.0))
    return rt.make_scene(ground, mesh)


def _build_camera(args):
    import gpu_ray_tracing as rt

    cam = rt.CameraSettings.default()
    if args.scene == "night" and args.look_from is None:
        cam = cam.replace(
            look_from=jnp.asarray([0.0, 1.3, 4.0]),
            look_at=jnp.asarray([0.0, 0.7, -1.0]),
            field_of_view=jnp.float32(45.0),
            defocus_angle=jnp.float32(0.0),
        )
    if args.scene == "mesh" and args.look_from is None:
        cam = cam.replace(
            look_from=jnp.asarray([0.0, 1.2, 3.0]),
            look_at=jnp.asarray([0.0, 0.7, 0.0]),
            field_of_view=jnp.float32(50.0),
            defocus_angle=jnp.float32(0.0),
        )
    if args.scene == "cornell" and args.look_from is None:
        cam = rt.cornell_camera()
    if args.look_from is not None:
        cam = cam.replace(look_from=args.look_from)
    if args.look_at is not None:
        cam = cam.replace(look_at=args.look_at)
    if args.fov is not None:
        cam = cam.replace(field_of_view=jnp.float32(args.fov))
    if args.defocus_angle is not None:
        cam = cam.replace(defocus_angle=jnp.float32(args.defocus_angle))
    if args.focus_distance is not None:
        cam = cam.replace(focus_distance=jnp.float32(args.focus_distance))
    # Catch degenerate poses HERE, eagerly — the render path derives the
    # camera under jit where the values are traced and the check skips.
    from gpu_ray_tracing.models.camera import validate_camera

    validate_camera(cam)
    return cam


def _rng_kwargs(args, offset: int = 0) -> dict:
    """Map --rng/--seed to render()'s RNG arguments: threefry takes a PRNG
    key, hash/wgsl take a uint32 frame seed."""
    if args.rng == "threefry":
        return {"key": jax.random.key(args.seed + offset)}
    return {"frame_seed": jnp.uint32(args.seed + offset)}


def _build_config(args, spp=None):
    import gpu_ray_tracing as rt

    backend = args.backend
    if backend == "auto":
        backend = (
            "pallas"
            if rt.platform.target() == "gpu" and args.rng == "hash"
            else "jax"
        )
        # Ray regeneration is a wavefront-engine mode; an explicit
        # --regenerate with auto backend selects the engine that honors it
        # on EVERY host (the CPU resolves auto to 'jax', which
        # RenderConfig would reject with regenerate != 'off' — the
        # wavefront engine interprets fine on CPU).
        if args.regenerate != "off":
            backend = "wavefront"
        # Adaptive sampling is a megakernel mode; an explicit --adaptive-tol
        # with auto backend selects the engine that honors it on every host.
        elif getattr(args, "adaptive_tol", 0.0) > 0.0:
            backend = "pallas"
    return rt.RenderConfig(
        width=args.width, height=args.height, spp=spp or args.spp,
        max_depth=args.depth, integrator=args.integrator, backend=backend,
        rng=args.rng, nee=args.nee, mis=getattr(args, "mis", False),
        clamp=getattr(args, "clamp", 0.0),
        sky_intensity=args.sky_intensity,
        russian_roulette_depth=args.russian_roulette,
        regenerate=args.regenerate,
        sampler=args.sampler,
        adaptive_tol=getattr(args, "adaptive_tol", 0.0),
        adaptive_min_spp=getattr(args, "adaptive_min_spp", 8),
    )


def cmd_render(args) -> int:
    import gpu_ray_tracing as rt
    from gpu_ray_tracing.utils.image import write_image
    from gpu_ray_tracing.utils.profiling import time_frames

    scene, cam, cfg = _build_scene(args), _build_camera(args), _build_config(args)
    if args.denoise:
        if cfg.integrator != "path":
            print("error: --denoise filters the path integrator's beauty "
                  "pass; drop --integrator or --denoise", file=sys.stderr)
            return 2
        img = rt.render_denoised(
            scene, cam, cfg, iterations=args.denoise, **_rng_kwargs(args)
        )
    else:
        img = rt.render(scene, cam, cfg, **_rng_kwargs(args))
    out_path = write_image(args.out, np.asarray(img), args.gamma)
    # Time what was written: with --denoise the beauty pass plus the three
    # guide passes and the filter, not just rt.render.
    if args.denoise:
        frame_fn = lambda i: rt.render_denoised(
            scene, cam, cfg, iterations=args.denoise, **_rng_kwargs(args, i)
        )
    else:
        frame_fn = lambda i: rt.render(scene, cam, cfg, **_rng_kwargs(args, i))
    stats = time_frames(
        frame_fn,
        width=cfg.width, height=cfg.height, spp=cfg.spp,
        frames=args.bench_frames, warmup=0,
    ) if args.bench_frames else None
    print(f"wrote {out_path} ({cfg.width}x{cfg.height}, {cfg.spp} spp, "
          f"backend={cfg.backend})" + (f" {stats}" if stats else ""))
    return 0


def cmd_animate(args) -> int:
    import gpu_ray_tracing as rt
    from gpu_ray_tracing.models.camera import orbit_yaw
    from gpu_ray_tracing.utils.image import write_image

    scene, cam = _build_scene(args), _build_camera(args)
    cfg = _build_config(args)
    track = rt.stack_camera_track(
        [orbit_yaw(cam, args.orbit_step * f) for f in range(args.frames)]
    )
    if args.rng == "threefry":
        anim_kwargs = {"key": jax.random.key(args.seed)}
    else:
        anim_kwargs = {
            "frame_seeds": jnp.arange(
                args.seed, args.seed + args.frames, dtype=jnp.uint32
            )
        }
    frames = rt.render_animation(scene, track, cfg, **anim_kwargs)
    os.makedirs(args.out_dir, exist_ok=True)
    frames = np.asarray(frames)
    for f in range(args.frames):
        write_image(os.path.join(args.out_dir, f"frame_{f:04d}.png"), frames[f], args.gamma)
    print(f"wrote {args.frames} frames to {args.out_dir}")
    return 0


def cmd_progressive(args) -> int:
    import gpu_ray_tracing as rt
    from gpu_ray_tracing.utils.checkpoint import (
        checkpoint_path,
        load_accum,
        render_fingerprint,
        save_accum,
    )
    from gpu_ray_tracing.utils.image import write_image

    if args.adaptive_tol > 0.0:
        # Reject at the CLI boundary with a clean message instead of a raw
        # ValueError traceback from progressive_step mid-run.
        print(
            "error: --adaptive-tol is a one-shot `render` mode; progressive "
            "accumulation needs exact per-sample counts",
            file=sys.stderr,
        )
        return 2
    scene, cam, cfg = _build_scene(args), _build_camera(args), _build_config(args)
    # The fingerprint covers scene contents, seed, and every stream-relevant
    # config field (NOT the resolution-independent backend choice) — so a
    # resume against mismatched flags fails loudly instead of folding
    # garbage samples.  threefry seeds per-STEP keys from --seed, so the
    # seed integer itself is the identity either way.
    fingerprint = render_fingerprint(
        scene, cfg, frame_seed=jnp.uint32(args.seed)
    )
    if args.checkpoint and os.path.exists(checkpoint_path(args.checkpoint)):
        try:
            state = load_accum(args.checkpoint, expect_fingerprint=fingerprint)
        except ValueError as e:
            raise SystemExit(str(e))
        if state.rgb.shape != (cfg.height, cfg.width, 3):
            raise SystemExit(
                f"checkpoint {args.checkpoint} is {state.rgb.shape[1]}x"
                f"{state.rgb.shape[0]}, but --width/--height request "
                f"{cfg.width}x{cfg.height}; the state cannot be resumed at a "
                "different resolution"
            )
        print(f"resumed from {args.checkpoint} at {int(state.count)} spp")
    else:
        state = rt.init_accum(cfg.height, cfg.width)
    resumed = int(state.count)
    preview_base = args.out or "progressive.png"
    for step in range(args.steps):
        # hash/wgsl: constant frame seed — the accumulated count is the
        # sample index, matching render(). threefry ignores sample_index, so
        # it needs a fresh key per step — offset by the RESUMED count, or a
        # resumed session re-draws the first session's exact keys and folds
        # duplicate samples.
        kw = _rng_kwargs(args, resumed + step if args.rng == "threefry" else 0)
        state = rt.progressive_step(state, scene, cam, cfg, **kw)
        if args.preview_every and (step + 1) % args.preview_every == 0:
            # Periodic snapshot: the offline answer to the reference's live
            # progressive view (lib.rs:96-102) — a long render is
            # inspectable (and cheaply abortable) while it accumulates.
            state = jax.block_until_ready(state)
            root, ext = os.path.splitext(preview_base)
            p = write_image(f"{root}_preview{ext or '.png'}",
                            np.asarray(state.rgb), args.gamma)
            print(f"preview at {int(state.count)} spp -> {p}", flush=True)
    state = jax.block_until_ready(state)
    if args.checkpoint:
        save_accum(args.checkpoint, state, fingerprint=fingerprint)
    if args.out:
        write_image(args.out, np.asarray(state.rgb), args.gamma)
    print(f"{int(state.count)}/{cfg.spp} spp accumulated"
          + (f"; wrote {args.out}" if args.out else ""))
    return 0


class _RawKeys:
    """Non-blocking single-key reads from a tty, restored on exit.

    Outside a tty (tests, pipes, --no-input) it is inert and `poll()`
    yields only the injected test keys."""

    def __init__(self, enabled: bool, inject: list[str] | None = None):
        self._enabled = enabled and sys.stdin.isatty()
        self._saved = None
        self._inject = list(inject or [])

    def __enter__(self):
        if self._enabled:
            import termios
            import tty

            self._saved = termios.tcgetattr(sys.stdin.fileno())
            tty.setcbreak(sys.stdin.fileno())
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios

            termios.tcsetattr(
                sys.stdin.fileno(), termios.TCSADRAIN, self._saved
            )
        return False

    def poll(self) -> str:
        """All pending input (may include escape sequences), without
        blocking; one injected batch per call in test mode."""
        out = self._inject.pop(0) if self._inject else ""
        if not self._enabled:
            return out
        import select

        # Read the raw fd, not sys.stdin: TextIOWrapper.read(1) slurps a
        # whole escape sequence into its Python-side buffer while returning
        # one char, after which select() on the fd sees nothing pending —
        # tearing "\x1b[A" into a bare ESC now and an orphaned "[A" on the
        # next keypress.  os.read keeps the unread bytes on the fd where
        # select() can see them.
        fd = sys.stdin.fileno()
        while select.select([fd], [], [], 0)[0]:
            chunk = os.read(fd, 64)
            if not chunk:
                break
            out += chunk.decode("utf-8", errors="ignore")
        return out


#: view-command key bindings -> (camera op, signed step scale).  The map
#: mirrors the reference's keyboard systems: W/S dolly (camera.rs:140-147),
#: A/D strafe (camera.rs:150-157), arrows/R-F elevate (camera.rs:160-166),
#: arrows/J-L orbit yaw (camera.rs:170-187), 1/2 pitch with the 0.95 flip
#: guard (camera.rs:209-242), +/- the FOV zoom the reference wrote but
#: never registered (camera.rs:48, 57-68).
def _view_key_ops():
    from gpu_ray_tracing.models import camera as cam_ops

    move, turn, fovs = 0.4, 0.08, 2.0
    return {
        "w": (cam_ops.dolly, -move), "s": (cam_ops.dolly, move),
        "a": (cam_ops.strafe, -move), "d": (cam_ops.strafe, move),
        "r": (cam_ops.elevate, move), "f": (cam_ops.elevate, -move),
        "\x1b[A": (cam_ops.elevate, move), "\x1b[B": (cam_ops.elevate, -move),
        "j": (cam_ops.orbit_yaw, turn), "l": (cam_ops.orbit_yaw, -turn),
        "\x1b[D": (cam_ops.orbit_yaw, turn), "\x1b[C": (cam_ops.orbit_yaw, -turn),
        "1": (cam_ops.orbit_pitch, turn), "2": (cam_ops.orbit_pitch, -turn),
        "+": (cam_ops.zoom, -fovs), "-": (cam_ops.zoom, fovs),
    }


def cmd_view(args) -> int:
    """Live progressive viewer in the terminal — the runtime equivalent of
    the reference's interactive window (sprite presentation lib.rs:79-87,
    per-frame accumulation you watch converge wgsl:352-358, keyboard camera
    camera.rs:125-253).  Camera keys apply the pure motion ops and RESET
    the accumulation, exactly the reference's camera_has_moved semantics;
    the camera is a traced argument of the jitted progressive step, so
    moving it never recompiles."""
    import time

    import gpu_ray_tracing as rt
    from gpu_ray_tracing.models.camera import validate_camera
    from gpu_ray_tracing.utils.ansi import (
        CLEAR_SCREEN,
        CURSOR_HOME,
        HIDE_CURSOR,
        SHOW_CURSOR,
        image_to_ansi,
    )

    if args.adaptive_tol > 0.0:
        print("error: --adaptive-tol does not compose with the viewer's "
              "progressive accumulation; use `render`", file=sys.stderr)
        return 2
    scene, cam, cfg = _build_scene(args), _build_camera(args), _build_config(args)
    if args.spp_per_step == 0:
        # Auto-batch: every dispatch costs a fixed host round trip, so a
        # 1-spp step is dispatch-bound at
        # viewer resolutions.  Batch device-side samples per repaint —
        # the key poll runs between batches, so input latency is one
        # batch, not one accumulation.
        args.spp_per_step = next(k for k in (8, 6, 5, 4, 3, 2, 1)
                                 if cfg.spp % k == 0)
    if args.spp_per_step > 1 and cfg.spp % args.spp_per_step != 0:
        print(f"error: --spp-per-step {args.spp_per_step} must divide "
              f"--spp {cfg.spp}", file=sys.stderr)
        return 2
    if args.cols is None:
        import shutil

        args.cols = min(shutil.get_terminal_size((80, 24)).columns, cfg.width)
    key_ops = _view_key_ops()
    inject = args.inject_keys.split(",") if args.inject_keys else None
    state = rt.init_accum(cfg.height, cfg.width)
    reset = False
    step = 0
    quit_key = False
    interactive = not args.no_input
    sys.stdout.write(CLEAR_SCREEN + (HIDE_CURSOR if interactive else ""))
    try:
        with _RawKeys(interactive, inject) as keys:
            while (args.max_steps == 0 or step < args.max_steps) and not quit_key:
                kw = _rng_kwargs(
                    args, step if args.rng == "threefry" else 0
                )
                t0 = time.perf_counter()
                state = jax.block_until_ready(rt.progressive_step(
                    state, scene, cam, cfg, reset=reset,
                    spp_per_step=args.spp_per_step, **kw,
                ))
                # The displayed ms/step includes a readback that depends
                # on the step.
                count = int(state.count)
                dt = time.perf_counter() - t0
                reset = False
                frame = image_to_ansi(np.asarray(state.rgb), args.cols,
                                      args.gamma)
                pos = np.asarray(cam.look_from)
                status = (
                    f"{count}/{cfg.spp} spp | {dt * 1e3:6.1f} ms/step "
                    f"({args.spp_per_step} spp/step = "
                    f"{args.spp_per_step / max(dt, 1e-9):5.1f} spp/s) | "
                    f"cam ({pos[0]:.2f}, {pos[1]:.2f}, {pos[2]:.2f}) "
                    f"fov {float(cam.field_of_view):.0f}"
                )
                help_line = ("[wasd] move  [rf/arrows] up/down  [jl/arrows] "
                             "orbit  [12] pitch  [+-] zoom  [0] re-center  "
                             "[x] quit") if interactive else ""
                sys.stdout.write(
                    CURSOR_HOME + frame + "\n" + status + "\x1b[K\n"
                    + help_line + "\x1b[K")
                sys.stdout.flush()
                pressed = keys.poll()
                moved = False
                i = 0
                while i < len(pressed):
                    tok = pressed[i]
                    if tok == "\x1b" and pressed[i:i + 3] in key_ops:
                        tok = pressed[i:i + 3]
                    i += len(tok)
                    if tok in ("x", "\x1b"):
                        quit_key = tok == "x"  # bare ESC = dropped seq tail
                        if quit_key:
                            break
                        continue
                    if tok == "0":  # re-center on the scene origin
                        cam = cam.replace(
                            look_at=jnp.zeros(3, jnp.float32))
                        moved = True
                        continue
                    op = key_ops.get(tok)
                    if op is None:
                        continue
                    fn, amount = op
                    cam = fn(cam, amount)
                    moved = True
                if moved:
                    validate_camera(cam)
                    # The reference's camera_has_moved contract: motion
                    # restarts the accumulation (wgsl:352-358).
                    reset = True
                step += 1
    finally:
        if interactive:
            sys.stdout.write(SHOW_CURSOR)
        sys.stdout.write("\n")
        sys.stdout.flush()
    if args.out:
        from gpu_ray_tracing.utils.image import write_image

        p = write_image(args.out, np.asarray(state.rgb), args.gamma)
        print(f"wrote {p}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gpu_ray_tracing", description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render one frame to an image file")
    _add_common(p)
    p.add_argument("--out", default="render.png")
    p.add_argument("--bench-frames", type=int, default=0,
                   help="also time this many frames and print throughput")
    p.add_argument("--denoise", type=_nonneg_int, default=0, metavar="ITERS",
                   help="AOV-guided a-trous denoise of the beauty pass with "
                        "this many passes (0 = off; try 3-5 at low --spp)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("animate", help="render an orbiting camera track")
    _add_common(p)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--orbit-step", type=float, default=0.1, help="radians per frame")
    p.add_argument("--out-dir", default="frames")
    p.set_defaults(fn=cmd_animate)

    p = sub.add_parser("progressive", help="progressive accumulation with checkpoint/resume")
    _add_common(p)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--preview-every", type=int, default=0, metavar="N",
                   help="write a <out>_preview image snapshot every N steps "
                        "(0 = off) so long renders are inspectable mid-run")
    p.set_defaults(fn=cmd_progressive)

    p = sub.add_parser(
        "view",
        help="live progressive viewer in the terminal (ANSI truecolor "
             "half-blocks) with interactive keyboard camera",
    )
    _add_common(p)
    p.add_argument("--cols", type=int, default=None,
                   help="frame width in terminal columns (default: fit)")
    p.add_argument("--max-steps", type=int, default=0,
                   help="stop after N steps (0 = run until [x])")
    p.add_argument("--spp-per-step", type=int, default=0,
                   help="samples folded per repaint (must divide --spp); "
                   "0 = auto: the largest divisor of --spp up to 8, so the "
                   "fixed per-dispatch cost amortizes "
                   "over device-side samples instead of bounding the "
                   "interactive rate (keys are polled between batches)")
    p.add_argument("--no-input", action="store_true",
                   help="disable keyboard handling (non-tty/CI runs)")
    p.add_argument("--out", default=None,
                   help="write the final accumulation to this image on exit")
    p.add_argument("--inject-keys", default=None, help=argparse.SUPPRESS)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("bench", help="run the 5-config benchmark suite")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--configs", default="1,2,3,4,5")
    def _bench(args):
        from benchmarks.run import main as bench_main

        argv2 = []
        if args.quick:
            argv2.append("--quick")
        if args.out:
            argv2 += ["--out", args.out]
        argv2 += ["--configs", args.configs]
        bench_main(argv2)
        return 0
    p.set_defaults(fn=_bench)

    args = ap.parse_args(argv)
    from gpu_ray_tracing import platform

    platform.use_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
