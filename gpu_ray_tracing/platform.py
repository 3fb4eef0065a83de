"""Where a computation runs, decided in one place.

Every platform-dependent choice of the package reads `target()`:

  - 'gpu': the Pallas engines compile through Triton (`interpret=False`);
  - 'cpu': the Pallas engines run in interpret mode — the test suite's
    route, never a fallback for an accelerator;
  - any other platform raises.

The target is the platform of the devices the computation runs on: the
mesh's devices where there is one, else a `jax.default_device` scope
(which never initializes another backend, so CPU-pinned gates stay
hermetic), else the process's default backend.
"""

from __future__ import annotations

import os

import jax

_KNOWN = {"gpu": "gpu", "cuda": "gpu", "cpu": "cpu"}

#: Element budget of one (pixels x primitives) block of the plain jax
#: path's brute intersection test (api._trace_chunked).  XLA:CPU test runs
#: stay small; the card's 80 GB take large blocks so a frame is not
#: serialized into many small dispatches.
_BLOCK_BUDGET = {"cpu": 1 << 22, "gpu": 1 << 27}


def _scoped_platform() -> str | None:
    dev = jax.config.jax_default_device
    platform = getattr(dev, "platform", None)
    if platform is None and isinstance(dev, str):
        # jax.default_device also accepts platform-name strings ('cpu:0').
        platform = dev.split(":", 1)[0]
    return platform


def target(devices=None) -> str:
    """'gpu' or 'cpu' for `devices` (an iterable of jax Devices, e.g. a
    mesh's `devices.flat`), else for the current default device; raises
    ValueError for any other platform."""
    if devices is not None:
        platform = next(iter(devices)).platform
    else:
        platform = _scoped_platform() or jax.default_backend()
    try:
        return _KNOWN[platform]
    except KeyError:
        raise ValueError(
            f"unsupported platform {platform!r}: the Pallas engines compile "
            "for NVIDIA GPUs through Triton and run in interpret mode on "
            "the CPU only"
        ) from None


def interpret(devices=None) -> bool:
    """Pallas interpret-mode flag: True exactly when the target is the CPU."""
    return target(devices) == "cpu"


def block_budget(devices=None) -> int:
    """Element budget of one brute-force (pixels x primitives) block."""
    return _BLOCK_BUDGET[target(devices)]


def checkout_root() -> str:
    """The directory that holds the package (the repository checkout)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def use_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    `JAX_COMPILATION_CACHE_DIR`, when set, is honoured as JAX reads it and
    nothing is set here; otherwise the cache lives at `<checkout>/.jax_cache`
    (git-ignored).  A fixed path matters: the path is part of the cache key.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(checkout_root(), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
