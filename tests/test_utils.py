"""Tests for image IO, profiling, checkpoint/resume, and the CLI."""

import json
import os

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing import (
    CameraSettings,
    RenderConfig,
    base_scene,
    init_accum,
    progressive_step,
)
from gpu_ray_tracing.utils.checkpoint import load_accum, save_accum
from gpu_ray_tracing.utils.image import read_ppm, tonemap, to_uint8, write_image, write_ppm
from gpu_ray_tracing.utils.profiling import FrameStats, time_frames
from tests.test_api import BASE_CAMERA


def test_tonemap_gamma():
    np.testing.assert_allclose(tonemap([0.0, 1.0, 2.0]), [0.0, 1.0, 1.0], atol=1e-6)
    mid = float(tonemap(np.asarray([0.5]), gamma=2.0)[0])
    assert abs(mid - 0.5**0.5) < 1e-6


def test_to_uint8_rounds():
    np.testing.assert_array_equal(to_uint8([0.0, 0.5, 1.0]), [0, 128, 255])


def test_ppm_roundtrip(tmp_path):
    img = np.random.default_rng(0).random((7, 9, 3)).astype(np.float32)
    path = os.path.join(tmp_path, "x.ppm")
    write_ppm(path, img, gamma=1.0)
    back = read_ppm(path)
    assert back.shape == (7, 9, 3)
    np.testing.assert_allclose(back / 255.0, np.clip(img, 0, 1), atol=1.0 / 255)


def test_write_image_png(tmp_path):
    path = os.path.join(tmp_path, "x.png")
    write_image(path, np.zeros((4, 4, 3), np.float32))
    assert os.path.exists(path)


def test_frame_stats_math():
    s = FrameStats(frames=10, seconds=2.0, width=100, height=100, spp=2)
    assert s.ms_per_frame == 200.0
    assert s.mrays_per_sec == 100 * 100 * 2 * 10 / 2.0 / 1e6
    assert s.spp_per_sec == 10.0
    json.loads(str(s))


def test_time_frames_runs():
    f = jax.jit(lambda i: jnp.full((8, 8), i, jnp.float32))
    stats = time_frames(lambda i: f(i), width=8, height=8, spp=1, frames=3)
    assert stats.frames == 3 and stats.seconds > 0


def test_checkpoint_roundtrip(tmp_path):
    scene = base_scene()
    cfg = RenderConfig(width=32, height=24, spp=8, max_depth=4)
    state = init_accum(cfg.height, cfg.width)
    for _ in range(3):
        state = progressive_step(state, scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(1))
    path = os.path.join(tmp_path, "ckpt.npz")
    save_accum(path, state)
    restored = load_accum(path)
    assert int(restored.count) == 3
    np.testing.assert_array_equal(np.asarray(restored.rgb), np.asarray(state.rgb))
    # Resume produces the identical continuation.
    a = progressive_step(state, scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(1))
    b = progressive_step(restored, scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(1))
    np.testing.assert_array_equal(np.asarray(a.rgb), np.asarray(b.rgb))


def test_checkpoint_extensionless_path_roundtrips(tmp_path):
    """np.savez appends '.npz' to bare paths: save/load/exists must agree
    on the on-disk name or extension-less --checkpoint paths save fine but
    silently never resume."""
    import pytest

    from gpu_ray_tracing.utils.checkpoint import checkpoint_path

    state = init_accum(8, 16)
    bare = os.path.join(tmp_path, "ck")
    save_accum(bare, state)
    assert os.path.exists(checkpoint_path(bare))
    restored = load_accum(bare)
    assert restored.rgb.shape == (8, 16, 3)
    # No stray temp file left behind by the atomic write.
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    # A foreign .npz fails with the format diagnostic, not a KeyError.
    foreign = os.path.join(tmp_path, "foreign.npz")
    np.savez(foreign, stuff=np.zeros(3))
    with pytest.raises(ValueError, match="not a save_accum checkpoint"):
        load_accum(foreign)


def test_checkpoint_fingerprint(tmp_path):
    """A checkpoint stamped with a render fingerprint refuses to resume
    against a different scene/seed/config (the silent-garbage failure
    checkpointing exists to prevent); matching renders round-trip, and
    legacy unstamped files still load."""
    import dataclasses

    import pytest

    from gpu_ray_tracing.utils.checkpoint import render_fingerprint

    scene = base_scene()
    cfg = RenderConfig(width=32, height=24, spp=8, max_depth=4)
    fp = render_fingerprint(scene, cfg, frame_seed=jnp.uint32(1))
    # Deterministic and sensitive to each identity component.
    assert fp == render_fingerprint(scene, cfg, frame_seed=jnp.uint32(1))
    assert fp != render_fingerprint(scene, cfg, frame_seed=jnp.uint32(2))
    assert fp != render_fingerprint(
        scene, dataclasses.replace(cfg, sampler="stratified"),
        frame_seed=jnp.uint32(1),
    )
    from gpu_ray_tracing import one_weekend_scene

    other = one_weekend_scene(jax.random.key(0)).pad_to_multiple(128)
    assert fp != render_fingerprint(other, cfg, frame_seed=jnp.uint32(1))
    # Scheduler-only knobs don't change the stream — same fingerprint, so
    # a checkpoint written by one engine resumes on another.
    assert fp == render_fingerprint(
        scene, dataclasses.replace(cfg, backend="pallas"),
        frame_seed=jnp.uint32(1),
    )
    # Extending the spp BUDGET is the core resume workflow and doesn't move
    # the stream for budget-independent samplers: independent and sobol
    # (index-addressed, prefix-stable) keep their fingerprint; stratified
    # derives its strata grid from the budget, so extension is refused.
    assert fp == render_fingerprint(
        scene, dataclasses.replace(cfg, spp=32), frame_seed=jnp.uint32(1)
    )
    sobol = dataclasses.replace(cfg, sampler="sobol")
    fp_sobol = render_fingerprint(scene, sobol, frame_seed=jnp.uint32(1))
    assert fp_sobol == render_fingerprint(
        scene, dataclasses.replace(sobol, spp=64), frame_seed=jnp.uint32(1)
    )
    strat = dataclasses.replace(cfg, sampler="stratified")
    fp_strat = render_fingerprint(scene, strat, frame_seed=jnp.uint32(1))
    assert fp_strat != render_fingerprint(
        scene, dataclasses.replace(strat, spp=32), frame_seed=jnp.uint32(1)
    )

    state = init_accum(cfg.height, cfg.width)
    path = os.path.join(tmp_path, "fp.npz")
    save_accum(path, state, fingerprint=fp)
    restored = load_accum(path, expect_fingerprint=fp)
    assert restored.rgb.shape == (24, 32, 3)
    with pytest.raises(ValueError, match="different render"):
        load_accum(path, expect_fingerprint="deadbeef")
    # Legacy checkpoints (no stamp) load unchecked.
    legacy = os.path.join(tmp_path, "legacy.npz")
    save_accum(legacy, state)
    load_accum(legacy, expect_fingerprint=fp)


def test_cli_progressive_fingerprint_mismatch(tmp_path):
    """Resuming a CLI progressive session with a different seed exits with
    a clean fingerprint-mismatch message instead of folding garbage."""
    import pytest

    from gpu_ray_tracing.cli import main

    ckpt = os.path.join(tmp_path, "sess.npz")
    base_args = [
        "progressive", "--scene", "base", "--width", "32", "--height", "24",
        "--spp", "8", "--depth", "3", "--steps", "1", "--checkpoint", ckpt,
    ]
    assert main(base_args + ["--seed", "1"]) == 0
    assert main(base_args + ["--seed", "1"]) == 0  # matching resume is fine
    with pytest.raises(SystemExit, match="different render"):
        main(base_args + ["--seed", "2"])


def test_cli_render(tmp_path):
    from gpu_ray_tracing.cli import main

    out = os.path.join(tmp_path, "img.png")
    rc = main([
        "render", "--scene", "base", "--width", "48", "--height", "36",
        "--spp", "2", "--depth", "4", "--out", out,
    ])
    assert rc == 0 and os.path.exists(out)


def test_cli_render_denoise(tmp_path):
    from gpu_ray_tracing.cli import main

    out = os.path.join(tmp_path, "dn.png")
    rc = main([
        "render", "--scene", "base", "--width", "48", "--height", "36",
        "--spp", "2", "--depth", "4", "--denoise", "3", "--out", out,
    ])
    assert rc == 0 and os.path.exists(out)
    # --denoise filters the beauty pass; an AOV integrator is a usage error
    # reported at the CLI boundary (rc 2), not a traceback.
    rc = main([
        "render", "--scene", "base", "--width", "16", "--height", "16",
        "--spp", "1", "--denoise", "2", "--integrator", "depth",
        "--out", os.path.join(tmp_path, "bad.png"),
    ])
    assert rc == 2


def test_cli_regenerate_with_auto_backend(tmp_path):
    """--backend auto + --regenerate on must select the wavefront engine on
    ANY host (on the CPU auto resolves to 'jax', which RenderConfig rejects
    with regenerate != 'off')."""
    from gpu_ray_tracing.cli import main

    out = os.path.join(tmp_path, "regen.png")
    rc = main([
        "render", "--scene", "base", "--width", "48", "--height", "36",
        "--spp", "2", "--depth", "4", "--regenerate", "on", "--out", out,
    ])
    assert rc == 0 and os.path.exists(out)


def test_cli_progressive_preview_every(tmp_path):
    """--preview-every N writes inspectable snapshots mid-accumulation
    (long renders must not be a black box)."""
    from gpu_ray_tracing.cli import main

    out = os.path.join(tmp_path, "prog.png")
    rc = main([
        "progressive", "--scene", "base", "--width", "32", "--height", "24",
        "--spp", "4", "--depth", "3", "--steps", "4", "--preview-every", "2",
        "--out", out,
    ])
    assert rc == 0 and os.path.exists(out)
    assert os.path.exists(os.path.join(tmp_path, "prog_preview.png"))


def test_cli_progressive_resume(tmp_path):
    from gpu_ray_tracing.cli import main

    ckpt = os.path.join(tmp_path, "c.npz")
    out = os.path.join(tmp_path, "p.png")
    common = [
        "progressive", "--scene", "base", "--width", "32", "--height", "24",
        "--spp", "64", "--depth", "4", "--steps", "2", "--checkpoint", ckpt,
    ]
    assert main(common) == 0
    st = load_accum(ckpt)
    assert int(st.count) == 2
    assert main(common + ["--out", out]) == 0
    st = load_accum(ckpt)
    assert int(st.count) == 4  # resumed, not restarted
    assert os.path.exists(out)


def test_cli_animate(tmp_path):
    from gpu_ray_tracing.cli import main

    out_dir = os.path.join(tmp_path, "frames")
    rc = main([
        "animate", "--scene", "base", "--width", "32", "--height", "24",
        "--spp", "1", "--depth", "3", "--frames", "2", "--out-dir", out_dir,
    ])
    assert rc == 0
    assert len(os.listdir(out_dir)) == 2


def test_cli_mesh_scene(tmp_path):
    from gpu_ray_tracing.cli import main

    out = os.path.join(tmp_path, "mesh.png")
    rc = main([
        "render", "--scene", "mesh", "--width", "40", "--height", "30",
        "--spp", "1", "--depth", "3", "--integrator", "normal", "--out", out,
    ])
    assert rc == 0 and os.path.exists(out)


def test_inverse_rendering_example_converges():
    """examples/inverse_rendering.py: gradients actually recover albedos
    (tiny budget; full run in the example itself)."""
    import importlib.util, os, sys

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "inverse_rendering.py")
    spec = importlib.util.spec_from_file_location("inverse_rendering", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main(["--steps", "40", "--width", "48", "--height", "36", "--spp", "2", "--lr", "0.1"])
    assert rc in (0, 1)  # ran end to end; convergence quality covered by example


def test_accum_state_orbax_compatible(tmp_path):
    """AccumState is an ordinary pytree: orbax checkpointing round-trips it."""
    orbax = pytest.importorskip("orbax.checkpoint")
    scene = base_scene()
    cfg = RenderConfig(width=16, height=12, spp=4, max_depth=3)
    state = init_accum(cfg.height, cfg.width)
    state = progressive_step(state, scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(2))
    path = os.path.join(tmp_path, "orbax_ckpt")
    ckptr = orbax.PyTreeCheckpointer()
    ckptr.save(path, state)
    restored = ckptr.restore(path, item=state)
    assert int(restored.count) == 1
    np.testing.assert_array_equal(np.asarray(restored.rgb), np.asarray(state.rgb))


def test_offline_example_preview_cadence(tmp_path):
    """examples/offline_accumulate.py --preview-every N must write previews
    every N steps on its OWN cadence — not only when the step also lands on
    a checkpoint boundary (review finding r3: nested under checkpoint-every,
    previews fired at the LCM and a short run wrote none)."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "offline_accumulate.py")
    spec = importlib.util.spec_from_file_location("offline_accumulate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = os.path.join(tmp_path, "r.png")
    ck = os.path.join(tmp_path, "ck.npz")
    rc = mod.main([
        "--width", "32", "--height", "24", "--spp", "2", "--spp-per-step", "1",
        "--depth", "3", "--rr", "0", "--out", out, "--checkpoint", ck,
        "--checkpoint-every", "1000", "--preview-every", "1",
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(tmp_path, "r_preview.png"))


def test_ansi_downsample_and_frame():
    """The terminal presentation layer: box-mean downsampling is exact on
    aligned grids, and image_to_ansi emits one truecolor half-block cell
    per (2-pixel column) with the top/bottom rows as fg/bg."""
    from gpu_ray_tracing.utils.ansi import downsample_mean, image_to_ansi

    img = np.zeros((4, 8, 3), np.float32)
    img[:2] = [1.0, 0.0, 0.0]  # top half red
    img[2:] = [0.0, 1.0, 0.0]  # bottom half green
    small = downsample_mean(img, 2, 4)
    assert small.shape == (2, 4, 3)
    np.testing.assert_allclose(small[0], [[1, 0, 0]] * 4)
    np.testing.assert_allclose(small[1], [[0, 1, 0]] * 4)
    # Ragged bins still average correctly (5 -> 2 columns).
    ragged = downsample_mean(np.ones((2, 5, 3), np.float32), 1, 2)
    np.testing.assert_allclose(ragged, np.ones((1, 2, 3)))

    s = image_to_ansi(img, cols=8, gamma=1.0)
    lines = s.split("\n")
    assert len(lines) == 2  # full width: 4 pixel rows -> 2 half-block lines
    assert lines[0].count("▀") == 8
    assert "38;2;255;0;0m" in lines[0] and "48;2;255;0;0m" in lines[0]
    assert "38;2;0;255;0m" in lines[1] and "48;2;0;255;0m" in lines[1]
    # Aspect preservation: halving the columns halves the pixel rows, so
    # the red top row becomes the fg and the green bottom the bg of ONE line.
    one = image_to_ansi(img, cols=4, gamma=1.0)
    assert "\n" not in one
    assert "38;2;255;0;0m" in one and "48;2;0;255;0m" in one
    # Non-finite radiance renders black rather than poisoning the frame.
    bad = np.full((2, 2, 3), np.nan, np.float32)
    assert "38;2;0;0;0m" in image_to_ansi(bad, cols=2)


def test_cli_view_progressive_and_reset(tmp_path, capsys):
    """The `view` command: progressive repaints accumulate; an injected
    camera key applies the motion op and RESETS the accumulation (the
    reference's camera_has_moved contract); [x] quits."""
    from gpu_ray_tracing.cli import main

    out = os.path.join(tmp_path, "view.png")
    rc = main([
        "view", "--scene", "base", "--width", "48", "--height", "36",
        "--spp", "8", "--depth", "3", "--max-steps", "4", "--no-input",
        "--cols", "24", "--out", out, "--spp-per-step", "1",
        # step 1 poll: dolly forward (resets count); step 3 poll: quit.
        "--inject-keys", "w,,x",
    ])
    captured = capsys.readouterr().out
    assert rc == 0
    assert os.path.exists(out)
    assert "▀" in captured
    # Step 1 reaches 1 spp; the 'w' reset restarts the count, so the last
    # repaint before [x] shows 2/8 spp (not 3/8).
    assert "1/8 spp" in captured
    assert "2/8 spp" in captured
    assert "3/8 spp" not in captured


def test_cli_view_auto_batches_steps(capsys):
    """Default --spp-per-step 0 auto-batches device-side samples per
    repaint (the largest divisor of --spp up to 8), so the viewer's
    interactive rate is render-, not dispatch-, bound; the status line reports honest spp/s."""
    from gpu_ray_tracing.cli import main

    rc = main([
        "view", "--scene", "base", "--width", "48", "--height", "36",
        "--spp", "12", "--depth", "3", "--max-steps", "2", "--no-input",
        "--cols", "24",
    ])
    captured = capsys.readouterr().out
    assert rc == 0
    # 12 spp -> auto batch 6: repaints land on 6/12 then 12/12.
    assert "6/12 spp" in captured
    assert "12/12 spp" in captured
    assert "6 spp/step" in captured and "spp/s" in captured


def test_rawkeys_keeps_escape_sequences_whole(monkeypatch):
    """_RawKeys.poll must return a pending arrow-key escape sequence in ONE
    call.  Regression: reading via buffered sys.stdin.read(1) let
    TextIOWrapper slurp the sequence tail into its Python-side buffer where
    select() on the fd can't see it — poll returned a bare ESC (discarded
    as a dropped tail) and arrow keys were silently dead in the viewer."""
    import pty
    import sys as _sys
    import time

    from gpu_ray_tracing.cli import _RawKeys

    master, slave = pty.openpty()
    sin = os.fdopen(slave, "r")
    try:
        monkeypatch.setattr(_sys, "stdin", sin)
        with _RawKeys(True) as keys:
            os.write(master, b"\x1b[Aw")  # Up arrow + a following key
            for _ in range(100):  # wait for the pty to make bytes readable
                time.sleep(0.01)
                got = keys.poll()
                if got:
                    break
            assert got == "\x1b[Aw"
    finally:
        os.close(master)
        sin.close()


def test_cli_view_rejects_adaptive(capsys):
    from gpu_ray_tracing.cli import main

    rc = main([
        "view", "--scene", "base", "--width", "48", "--height", "36",
        "--spp", "8", "--max-steps", "1", "--no-input",
        "--adaptive-tol", "0.05",
    ])
    assert rc == 2
