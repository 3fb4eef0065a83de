"""The platform module, the compile-cache helper, the peak table, and the
Pallas kernels' CUDA lowering.

The lowering tests lower every kernel variant for CUDA through Triton on
this CPU host (`.lower(lowering_platforms=("cuda",))` needs no card) and
check that each `pallas_call` became one Triton custom call: what the
Triton route cannot express fails here, before any chip time is spent.
Tests marked `gpu` run only where JAX finds a GPU.
"""

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_ray_tracing import (
    CameraSettings,
    RenderConfig,
    base_scene,
    make_scene,
    one_weekend_scene,
    platform,
    render,
)
from gpu_ray_tracing.models.camera import derive_camera
from gpu_ray_tracing.ops.pallas import megakernel as mk
from gpu_ray_tracing.utils import profiling
from tests.test_api import BASE_CAMERA

TRITON_CALL = "__gpu$xla.gpu.triton"


def _devices(name):
    return [SimpleNamespace(platform=name)]


# --- platform module ------------------------------------------------------


def test_target_is_cpu_in_the_test_suite():
    assert platform.target() == "cpu"
    assert platform.interpret() is True


@pytest.mark.parametrize("name,want", [("gpu", "gpu"), ("cuda", "gpu"), ("cpu", "cpu")])
def test_target_of_devices(name, want):
    assert platform.target(_devices(name)) == want
    assert platform.interpret(_devices(name)) is (want == "cpu")


@pytest.mark.parametrize("name", ["rocm", "metal", "neuron"])
def test_unknown_platform_raises(name):
    with pytest.raises(ValueError, match="unsupported platform"):
        platform.target(_devices(name))
    with pytest.raises(ValueError):
        platform.interpret(_devices(name))


def test_default_device_scope_string_and_device():
    """jax.default_device accepts platform-name strings as well as Device
    objects; both decide the target without touching other backends."""
    with jax.default_device("cpu"):
        assert platform.target() == "cpu"
    with jax.default_device(jax.devices("cpu")[0]):
        assert platform.target() == "cpu"


def test_mesh_devices_decide_the_target():
    from gpu_ray_tracing.parallel.mesh import make_mesh

    mesh = make_mesh(2, 1)
    assert platform.interpret(mesh.devices.flat) is True


def test_block_budget_per_target():
    assert platform.block_budget() == 1 << 22
    assert platform.block_budget(_devices("gpu")) == 1 << 27
    with pytest.raises(ValueError):
        platform.block_budget(_devices("rocm"))


def test_wrapper_chooses_triton_on_gpu(monkeypatch):
    """render_pallas asks the platform module; a GPU answer must give the
    compiled Triton kernel, never the interpreter."""
    calls = {}
    real = mk.pl.pallas_call

    def spy(*args, **kwargs):
        calls.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(platform, "target", lambda devices=None: "gpu")
    monkeypatch.setattr(mk.pl, "pallas_call", spy)
    cam = derive_camera(BASE_CAMERA, 32, 16)
    f = jax.jit(lambda s: mk.render_pallas(
        s, cam, width=32, height=16, sample_index=jnp.uint32(0),
        frame_seed=jnp.uint32(1), max_depth=2, t_min=1e-3))
    f.trace(base_scene()).lower(lowering_platforms=("cuda",))
    assert calls["interpret"] is False
    assert calls["compiler_params"].num_warps == mk.block_shape("path")[2]


# --- compile cache --------------------------------------------------------


def test_compile_cache_honours_env(monkeypatch):
    updates = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/cache")
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    assert platform.use_compile_cache() == "/somewhere/cache"
    assert updates == []


def test_compile_cache_defaults_to_checkout(monkeypatch):
    updates = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    path = platform.use_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert updates == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# --- peak table -----------------------------------------------------------


def test_peak_table_has_its_source():
    p = profiling.peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_sec"] == 3.35e12
    assert p["fp32_flops_per_sec"] == 67e12
    assert "data sheet" in p["source"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-40GB", ""])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        profiling.peaks(kind)


def test_check_plausible_uses_the_table():
    kind = "NVIDIA H100 80GB HBM3"
    ceiling = 3.35e12 / profiling.MIN_BYTES_PER_RAY / 1e6
    profiling.check_plausible(0.9 * ceiling, kind)
    with pytest.raises(RuntimeError, match="device-memory ceiling"):
        profiling.check_plausible(1.1 * ceiling, kind)
    profiling.check_plausible(1.1 * ceiling, kind, n_devices=2)
    with pytest.raises(ValueError):
        profiling.check_plausible(1.0, "cpu")


def test_device_record_names_the_device():
    rec = profiling.device_record()
    assert rec["platform"] == "cpu" and rec["device_count"] >= 1
    assert {"device_kind", "nvidia_smi_name_power_limit", "xla_flags"} <= set(rec)


# --- CUDA lowering of every kernel variant --------------------------------


def _lights_scene(n_lights):
    from gpu_ray_tracing.models.spheres import EMISSIVE, LAMBERTIAN, make_spheres

    rows = [((0, -1000.0, 0), 1000.0, LAMBERTIAN, (0.6, 0.6, 0.6), 0.0),
            ((0.0, 0.5, -1.0), 0.5, LAMBERTIAN, (0.7, 0.3, 0.3), 0.0)]
    rows += [((-2.0 + k, 2.5, -1.0), 0.2, EMISSIVE, (1.0, 0.9, 0.8), 4.0)
             for k in range(n_lights)]
    return make_scene(make_spheres(rows))


def _tri_light_scene():
    from gpu_ray_tracing.models.mesh import make_mesh
    from gpu_ray_tracing.models.spheres import EMISSIVE

    quad = make_mesh(
        np.array([[-1.0, 2.0, -3.0], [1.0, 2.0, -3.0],
                  [1.0, 2.0, -1.0], [-1.0, 2.0, -1.0]], np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int64),
        mat_kind=EMISSIVE, mat_param=4.0,
    )
    return make_scene(base_scene(), quad)


def _mesh_scene(smooth):
    from gpu_ray_tracing.models.mesh import icosphere

    return make_scene(base_scene(), icosphere(1, smooth=smooth))


W, H = 32, 16


def _state():
    z = jnp.zeros((H, W), jnp.float32)
    return (z, z, z, z, z, z)


LOWERING_VARIANTS = {
    "path": (base_scene, dict(max_depth=3)),
    "normal": (base_scene, dict(mode="normal")),
    "albedo": (base_scene, dict(mode="albedo")),
    "depth": (base_scene, dict(mode="depth")),
    "sphere_bvh": (lambda: make_scene(one_weekend_scene(jax.random.key(0)), sphere_bvh=True),
                   dict(max_depth=3)),
    "flat_mesh": (lambda: _mesh_scene(False), dict(max_depth=2)),
    "smooth_mesh": (lambda: _mesh_scene(True), dict(max_depth=2)),
    "nee_4_lights": (lambda: _lights_scene(4), dict(nee=True, max_depth=2)),
    "nee_6_lights": (lambda: _lights_scene(6), dict(nee=True, max_depth=2)),
    "mis": (lambda: _lights_scene(2), dict(nee=True, mis=True, max_depth=2)),
    "tri_lights_mis": (_tri_light_scene, dict(nee=True, mis=True, max_depth=2)),
    "adaptive": (base_scene, dict(spp=4, adaptive_tol=0.05, adaptive_min_spp=2,
                                  return_spp_map=True, max_depth=2)),
    "adaptive_resume": (base_scene, dict(spp=4, adaptive_tol=0.05, adaptive_min_spp=2,
                                         adaptive_chunk=2, max_depth=2,
                                         adaptive_state="zeros")),
    "ray_counters": (base_scene, dict(return_ray_count=True, max_depth=3, spp=2)),
    "stratified": (base_scene, dict(sampler="stratified", spp=4, max_depth=2)),
    "sobol": (base_scene, dict(sampler="sobol", spp=4, max_depth=2)),
    "row_shard": (base_scene, dict(y_offset=3, row_stride=2, max_depth=2)),
}


def _kernel_kwargs(kw):
    kw = dict(kw)
    sampler = kw.pop("sampler", None)
    if sampler:
        kw["sampler_spec"] = RenderConfig(width=W, height=H, spp=kw["spp"],
                                          sampler=sampler).sampler_spec
    if kw.get("adaptive_state") == "zeros":
        kw["adaptive_state"] = _state()
    return kw


def _lower_for_cuda(fn, *args):
    return jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("variant", sorted(LOWERING_VARIANTS))
def test_megakernel_lowers_through_triton(variant):
    make, kw = LOWERING_VARIANTS[variant]
    scene = make()
    cam = derive_camera(CameraSettings.default(), W, H)
    kw = _kernel_kwargs(kw)

    def fn(s):
        return mk.render_pallas(
            s, cam, width=W, height=H, sample_index=jnp.uint32(0),
            frame_seed=jnp.uint32(1), t_min=1e-3, interpret=False,
            **{"max_depth": 1, **kw})

    text = _lower_for_cuda(fn, scene)
    assert text.count(TRITON_CALL) == 1
    assert f"num_warps = {mk.block_shape(kw.get('mode', 'path'))[2]}" in text


@pytest.mark.parametrize("regenerate", [False, True])
def test_wavefront_lowers_through_triton(regenerate):
    from gpu_ray_tracing.ops.pallas.wavefront import render_wavefront

    cam = derive_camera(CameraSettings.default(), W, H)
    scene = _lights_scene(2)

    def fn(s):
        return render_wavefront(
            s, cam, width=W, height=H, sample_index=jnp.uint32(0),
            frame_seed=jnp.uint32(1), max_depth=3, t_min=1e-3, nee=True,
            spp=2, regenerate=regenerate, interpret=False)

    text = _lower_for_cuda(fn, scene)
    assert text.count(TRITON_CALL) == 1
    # Whole 128-ray rows, with as many rays per thread as the megakernel.
    rows, cols, warps = mk.block_shape("path")
    assert f"num_warps = {warps * max(128, rows * cols) // (rows * cols)}" in text


# --- on the card ----------------------------------------------------------


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python -m pytest tests -m gpu` on the card")


@pytest.mark.gpu
def test_render_compiles_the_triton_kernel(gpu):
    cfg = RenderConfig(width=64, height=48, spp=2, max_depth=4, backend="pallas")
    low = jax.jit(lambda s: render(s, BASE_CAMERA, cfg, frame_seed=jnp.uint32(1))).lower(base_scene())
    assert TRITON_CALL in low.as_text()
    ref = dataclasses.replace(cfg, backend="jax")
    with jax.default_matmul_precision("highest"):
        a = np.asarray(low.compile()(base_scene()))
        b = np.asarray(render(base_scene(), BASE_CAMERA, ref, frame_seed=jnp.uint32(1)))
    from tests.test_sharding import assert_images_match

    assert_images_match(a, b)
