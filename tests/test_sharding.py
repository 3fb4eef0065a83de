"""Multi-chip sharding tests on 8 simulated host devices (SURVEY §4).

The invariant under test: sharded rendering draws exactly the same random
stream as single-device rendering (counter-based RNG on global pixel ids), so
the images agree except where XLA's per-shape fusion/FMA rounding flips a
borderline hit decision (~0.1% of pixel-samples; see parallel/sharding.py).
`assert_images_match` encodes that contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_ray_tracing import (
    CameraSettings,
    RenderConfig,
    base_scene,
    init_accum,
    one_weekend_scene,
    render,
)
from gpu_ray_tracing.parallel.mesh import ROW_AXIS, make_mesh
from gpu_ray_tracing.parallel.sharding import (
    progressive_step_sharded,
    render_sharded,
    shard_accum_state,
)
from tests.test_api import BASE_CAMERA


def assert_images_match(a, b, flip_frac=0.01, mean_tol=1e-4):
    """Images from the same RNG stream: identical everywhere except a tiny
    fraction of compiler-rounding decision flips."""
    a, b = np.asarray(a), np.asarray(b)
    d = np.abs(a - b).max(axis=-1)
    assert d.size > 0
    frac = float((d > 1e-3).sum()) / d.size
    assert frac <= flip_frac, f"{frac:.4%} of pixels differ materially"
    assert float(np.abs(a - b).mean()) < mean_tol


def _cfg(**kw):
    defaults = dict(width=64, height=48, spp=1, max_depth=6)
    defaults.update(kw)
    return RenderConfig(**defaults)


@pytest.fixture(scope="module")
def scene():
    return base_scene()


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_row_sharded_render_matches_unsharded(scene):
    mesh = make_mesh(8, 1)
    cfg = _cfg()
    a = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh, frame_seed=jnp.uint32(5)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(5)))
    assert_images_match(a, b)


def test_row_sharded_render_wgsl_stream(scene):
    mesh = make_mesh(8, 1)
    cfg = _cfg(rng="wgsl")
    a = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh, frame_seed=jnp.uint32(9)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(9)))
    assert_images_match(a, b)


def test_spp_sharded_render_matches_unsharded(scene):
    mesh = make_mesh(4, 2)
    cfg = _cfg(spp=4)
    a = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh, frame_seed=jnp.uint32(1)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(1)))
    # Same sample set; reduction order and fusion rounding may differ.
    assert_images_match(a, b)


def test_sharded_output_is_row_sharded(scene):
    mesh = make_mesh(8, 1)
    img = render_sharded(scene, BASE_CAMERA, _cfg(), mesh, frame_seed=jnp.uint32(0))
    spec = img.sharding.spec
    assert spec[0] == ROW_AXIS


def test_sharded_one_weekend_scene():
    """Bigger scene through the sharded path (BASELINE config-5 shape)."""
    scene = one_weekend_scene(jax.random.key(0))
    mesh = make_mesh(8, 1)
    cfg = _cfg(width=64, height=40, spp=1, max_depth=8)
    a = np.asarray(render_sharded(scene, CameraSettings.default(), cfg, mesh,
                                  frame_seed=jnp.uint32(3)))
    b = np.asarray(render(scene, CameraSettings.default(), cfg,
                          frame_seed=jnp.uint32(3)))
    assert_images_match(a, b)


def test_progressive_sharded_matches_batch(scene):
    """spp/k sharded progressive steps == the full batch render."""
    mesh = make_mesh(4, 2)
    cfg = _cfg(spp=4)
    fs = jnp.uint32(11)
    state = shard_accum_state(init_accum(cfg.height, cfg.width), mesh)
    for _ in range(2):  # 2 steps x 2 spp-shards = 4 samples
        state = progressive_step_sharded(state, scene, BASE_CAMERA, cfg, mesh, frame_seed=fs)
    assert int(state.count) == 4
    batch = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=fs))
    assert_images_match(np.asarray(state.rgb), batch)


def test_progressive_sharded_freeze_and_reset(scene):
    mesh = make_mesh(8, 1)
    cfg = _cfg(spp=2)
    state = shard_accum_state(init_accum(cfg.height, cfg.width), mesh)
    for _ in range(4):
        state = progressive_step_sharded(state, scene, BASE_CAMERA, cfg, mesh)
    assert int(state.count) == 2  # frozen at target
    state = progressive_step_sharded(state, scene, BASE_CAMERA, cfg, mesh, reset=True)
    assert int(state.count) == 1


def test_progressive_sharded_resumed_straddle_freezes_at_target(scene):
    """A checkpoint resumed at a count misaligned to the spp-axis batch
    straddles the target; fold_sample folds only the taken fraction so the
    sharded step freezes exactly at config.spp (r3 review finding)."""
    from gpu_ray_tracing.ops.accumulate import AccumState

    mesh = make_mesh(4, 2)  # 2-sample batches
    cfg = _cfg(spp=4)
    # Simulate a resume at count=3 (e.g. saved from 3 single unsharded steps).
    resumed = AccumState(
        rgb=jnp.full((cfg.height, cfg.width, 3), 0.25, jnp.float32),
        count=jnp.int32(3),
    )
    state = shard_accum_state(resumed, mesh)
    state = progressive_step_sharded(state, scene, BASE_CAMERA, cfg, mesh,
                                     frame_seed=jnp.uint32(5))
    assert int(state.count) == 4  # 3 + take(1), not 3 + 2
    state = progressive_step_sharded(state, scene, BASE_CAMERA, cfg, mesh,
                                     frame_seed=jnp.uint32(5))
    assert int(state.count) == 4  # frozen
    assert np.isfinite(np.asarray(state.rgb)).all()


def test_threefry_rejected_for_sharding(scene):
    mesh = make_mesh(8, 1)
    with pytest.raises(ValueError):
        render_sharded(scene, BASE_CAMERA, _cfg(rng="threefry"), mesh)


def test_indivisible_height_rejected(scene):
    mesh = make_mesh(8, 1)
    with pytest.raises(ValueError):
        render_sharded(scene, BASE_CAMERA, _cfg(height=50), mesh)


def test_sharded_pallas_backend(scene):
    """The sharded path drives the megakernel per shard (interpret on CPU),
    with the row-shard y_offset keeping the global RNG stream."""
    mesh = make_mesh(4, 1)
    cfg = _cfg(backend="pallas")
    a = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh, frame_seed=jnp.uint32(5)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(5)))
    assert_images_match(a, b)


def test_progressive_sharded_pallas(scene):
    """Sharded progressive accumulation through the megakernel."""
    mesh = make_mesh(4, 1)
    cfg = _cfg(spp=4, backend="pallas")
    state = shard_accum_state(init_accum(cfg.height, cfg.width), mesh)
    for _ in range(2):
        state = progressive_step_sharded(
            state, scene, BASE_CAMERA, cfg, mesh, frame_seed=jnp.uint32(3)
        )
    assert int(state.count) == 2
    assert np.all(np.isfinite(np.asarray(state.rgb)))


def test_interleaved_row_partition_matches_unsharded(scene):
    """row_partition='interleaved' (shard xi owns rows {xi, xi+n, ...}, the
    load-balanced partition) must produce the SAME image as the unsharded
    render after the de-interleave render_sharded applies internally — the
    RNG is keyed on global pixel ids, so the partition is invisible to the
    estimator."""
    mesh = make_mesh(8, 1)
    cfg = _cfg()
    a = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh,
                                  frame_seed=jnp.uint32(5),
                                  row_partition="interleaved"))
    b = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(5)))
    assert_images_match(a, b)
    # And against the contiguous partition (same sample stream either way).
    c = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh,
                                  frame_seed=jnp.uint32(5)))
    assert_images_match(a, c)


def test_interleaved_kernel_backends(scene):
    """Interleaved rows through both Pallas engines (strided global pixel
    ids in-kernel)."""
    mesh = make_mesh(4, 2)
    for backend in ("pallas", "wavefront"):
        cfg = _cfg(spp=2, backend=backend)
        a = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh,
                                      frame_seed=jnp.uint32(7),
                                      row_partition="interleaved"))
        b = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(7)))
        assert_images_match(a, b)


def test_interleaved_progressive_accum_image(scene):
    """Sharded progressive state stays in partition order; accum_image
    restores image order at materialization."""
    from gpu_ray_tracing.parallel.sharding import accum_image

    mesh = make_mesh(8, 1)
    cfg = _cfg(spp=2)
    fs = jnp.uint32(3)
    state = shard_accum_state(init_accum(cfg.height, cfg.width), mesh)
    for _ in range(2):
        state = progressive_step_sharded(state, scene, BASE_CAMERA, cfg, mesh,
                                         frame_seed=fs,
                                         row_partition="interleaved")
    assert int(state.count) == 2
    img = np.asarray(accum_image(state, mesh, "interleaved"))
    ref = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=fs))
    assert_images_match(img, ref)


def test_interleaved_rejects_wgsl(scene):
    mesh = make_mesh(8, 1)
    with pytest.raises(ValueError, match="interleaved"):
        render_sharded(scene, BASE_CAMERA, _cfg(rng="wgsl"), mesh,
                       row_partition="interleaved")


def test_sharded_stratified_sampler_matches_unsharded(scene):
    """Strata are addressed by (global pixel id, absolute sample index), so
    row x spp sharding cannot change the stratified stream."""
    mesh = make_mesh(4, 2)
    cfg = _cfg(spp=4, max_depth=4, sampler="stratified")
    a = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh, frame_seed=jnp.uint32(5)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(5)))
    assert_images_match(a, b)


def test_sharded_sobol_sampler_matches_unsharded(scene):
    """Sobol points are functions of (global pixel id, absolute sample
    index), so row x spp sharding cannot change the sobol stream."""
    mesh = make_mesh(4, 2)
    cfg = _cfg(spp=4, max_depth=4, sampler="sobol")
    a = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh, frame_seed=jnp.uint32(5)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(5)))
    assert_images_match(a, b)


def test_sharded_mis_matches_unsharded():
    """nee+mis under row x spp sharding: the MIS weights are elementwise
    functions of per-lane state carried within each shard, so the sharded
    image must match the unsharded render."""
    from gpu_ray_tracing import make_scene
    from gpu_ray_tracing.models.spheres import EMISSIVE, LAMBERTIAN, make_spheres

    sc = make_scene(make_spheres([
        ((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((-0.6, 0.35, -2.2), 0.35, LAMBERTIAN, (0.8, 0.3, 0.3), 0.0),
        ((0.0, 1.6, -2.0), 1.2, EMISSIVE, (1.0, 0.9, 0.7), 2.0),
    ]))
    mesh = make_mesh(4, 2)
    cfg = _cfg(spp=4, max_depth=4, nee=True, mis=True, sky_intensity=0.0)
    a = np.asarray(render_sharded(sc, BASE_CAMERA, cfg, mesh, frame_seed=jnp.uint32(5)))
    b = np.asarray(render(sc, BASE_CAMERA, cfg, frame_seed=jnp.uint32(5)))
    assert_images_match(a, b)


def test_adaptive_row_sharded_prefix_property(scene):
    """Row-sharded adaptive rendering (r4): with a huge tolerance every
    tile of every shard stops exactly at adaptive_min_spp, and because
    adaptive samples are a PREFIX of the identical global-pixel-id stream
    the image matches the unsharded fixed render at spp=min_spp."""
    mesh = make_mesh(4, 1)
    cfg_ad = _cfg(width=64, height=128, spp=16, max_depth=4,
                  backend="pallas", adaptive_tol=1e6, adaptive_min_spp=4)
    cfg_4 = _cfg(width=64, height=128, spp=4, max_depth=4, backend="pallas")
    a = np.asarray(render_sharded(scene, BASE_CAMERA, cfg_ad, mesh,
                                  frame_seed=jnp.uint32(2)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg_4, frame_seed=jnp.uint32(2)))
    assert_images_match(a, b)
    # Adaptivity engaged: the early-exit image is NOT the full 16-spp one.
    full = np.asarray(render(
        scene, BASE_CAMERA,
        _cfg(width=64, height=128, spp=16, max_depth=4, backend="pallas"),
        frame_seed=jnp.uint32(2)))
    assert not np.array_equal(a, full)


def test_adaptive_row_sharded_matches_unsharded(scene):
    """With block-aligned contiguous bands (32 rows) each shard sees exactly
    the blocks the unsharded frame has (same pixels, same draws), so the
    per-tile Welford exits match and the sharded adaptive image agrees
    with the unsharded adaptive render up to per-shape rounding."""
    mesh = make_mesh(4, 1)
    cfg = _cfg(width=64, height=128, spp=8, max_depth=4, backend="pallas",
               adaptive_tol=0.05, adaptive_min_spp=2)
    a = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh,
                                  frame_seed=jnp.uint32(3)))
    b = np.asarray(render(scene, BASE_CAMERA, cfg, frame_seed=jnp.uint32(3)))
    assert_images_match(a, b)


def test_adaptive_sharded_interleaved_is_valid(scene):
    """Interleaved adaptive shards evaluate tile statistics over strided
    rows, so sample ALLOCATION may differ from the contiguous partition —
    but every pixel still accumulates a prefix of the same unbiased
    stream, so the estimates agree to MC-noise level."""
    mesh = make_mesh(4, 1)
    cfg = _cfg(width=64, height=128, spp=8, max_depth=4, backend="pallas",
               adaptive_tol=0.05, adaptive_min_spp=2)
    a = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh,
                                  frame_seed=jnp.uint32(3),
                                  row_partition="interleaved"))
    b = np.asarray(render_sharded(scene, BASE_CAMERA, cfg, mesh,
                                  frame_seed=jnp.uint32(3)))
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    assert abs(float(a.mean()) - float(b.mean())) < 0.02


def test_adaptive_sharded_rejections(scene):
    """adaptive_tol shards over rows only; spp-axis meshes and the
    fold-based progressive step stay rejected with actionable messages."""
    import pytest

    cfg = _cfg(width=64, height=128, spp=8, backend="pallas",
               adaptive_tol=0.05, adaptive_min_spp=2)
    with pytest.raises(ValueError, match="ROWS only"):
        render_sharded(scene, BASE_CAMERA, cfg, make_mesh(4, 2),
                       frame_seed=jnp.uint32(0))
    st = shard_accum_state(init_accum(cfg.height, cfg.width), make_mesh(4, 1))
    with pytest.raises(ValueError, match="does not compose"):
        progressive_step_sharded(st, scene, BASE_CAMERA, cfg, make_mesh(4, 1),
                                 frame_seed=jnp.uint32(0))
