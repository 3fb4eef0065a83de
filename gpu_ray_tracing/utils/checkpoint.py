"""Checkpoint / resume for progressive renders.

The reference has no cross-run persistence; within a run its accumulation
texture IS the resumable state (rgb = running mean, alpha = sample count,
wgsl:339-341,362 — SURVEY §5).  Here that state is the AccumState pytree, so
checkpointing is a plain .npz round-trip: a 1024-spp progressive render
(BASELINE config 5) survives process restarts.  For orbax users,
AccumState is an ordinary pytree and works with orbax.checkpoint directly.

Sharded states: `progressive_step_sharded(..., row_partition='interleaved')`
keeps state.rgb in PARTITION (shard-major) row order for its whole lifetime
(parallel/sharding.py).  This module stores bytes, not partition metadata —
resume such a checkpoint with the SAME mesh shape and row_partition, or
save `accum_image(state, mesh, partition)` (image order) instead.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing.ops.accumulate import AccumState

_FORMAT_VERSION = 1


def render_fingerprint(scene, config, *, frame_seed=None, key=None) -> str:
    """Stable hash of everything that determines a render's sample stream.

    Covers the sample-relevant STATIC config fields, the scene's full array
    contents (geometry, materials, BVH reorderings), and the RNG seed.
    Deliberately excludes scheduler-only choices — backend / regenerate /
    adaptive knobs — whose streams are engine-invariant, so a checkpoint
    written by one engine resumes on another.

    Used by save_accum/load_accum to refuse resuming a progressive render
    against a mismatched scene/seed/sampler — the silent-garbage failure
    (mismatched samples folded into the mean) that checkpointing exists to
    prevent (cli.py resume path).
    """
    import hashlib

    from gpu_ray_tracing.models.scene import as_scene

    # The spp BUDGET is deliberately NOT hashed raw: extending a finished
    # 64-spp render to 256 spp is the core resume workflow, and the sample
    # stream does not depend on the budget for the independent / threefry /
    # wgsl samplers (every draw is f(pixel id, sample index, frame seed,
    # salt)).  It leaks in only through the sampler: stratified derives its
    # (kx, ky) grid from the budget (sample i's stratum moves when the
    # budget does -> refuse), while sobol points are addressed by absolute
    # sample index and are prefix-stable across budgets (rng.sobol_nbits is
    # a static loop bound, not a stream parameter -> don't refuse).
    if config.sampler == "stratified":
        sampler_id: tuple = config.sampler_spec
    else:
        sampler_id = (config.sampler,)
    sc = as_scene(scene)
    h = hashlib.sha256()
    h.update(
        repr((
            "v2",
            config.width, config.height, config.max_depth,
            config.integrator, config.rng, sampler_id, config.parity,
            config.nee, config.mis, config.clamp, config.sky_intensity,
            config.russian_roulette_depth, config.t_min, config.t_max,
        )).encode()
    )
    if frame_seed is not None:
        h.update(b"seed" + np.asarray(frame_seed, np.uint32).tobytes())
    if key is not None:
        h.update(b"key" + np.asarray(jax.random.key_data(key)).tobytes())
    for leaf in jax.tree_util.tree_leaves(sc):
        a = np.asarray(leaf)
        h.update(f"{a.shape}{a.dtype}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def checkpoint_path(path: str) -> str:
    """The on-disk filename for `path`: np.savez appends '.npz' to bare
    paths, so save/load/exists must all normalize the same way (an
    extension-less --checkpoint otherwise saves fine but never resumes)."""
    return path if path.endswith(".npz") else path + ".npz"


def save_accum(path: str, state: AccumState, fingerprint: str | None = None) -> None:
    """Serialize an accumulation state to .npz — atomically.

    Writes a sibling temp file and os.replace()s it over the target: a
    save interrupted mid-write (OOM kill, timeout) must not destroy the
    previous checkpoint, which is the only copy of the accumulated
    samples — the exact failure checkpointing exists to survive.

    `fingerprint` (from render_fingerprint) stamps the checkpoint with the
    render it belongs to; load_accum verifies it.
    """
    path = checkpoint_path(path)
    tmp = path + ".tmp.npz"  # .npz suffix so np.savez doesn't append one
    extra = {} if fingerprint is None else {"fingerprint": np.str_(fingerprint)}
    np.savez(
        tmp,
        version=np.int32(_FORMAT_VERSION),
        rgb=np.asarray(state.rgb, np.float32),
        count=np.asarray(state.count, np.int32),
        **extra,
    )
    os.replace(tmp, path)


def load_accum(path: str, expect_fingerprint: str | None = None) -> AccumState:
    """Restore an accumulation state saved by save_accum.

    `expect_fingerprint` (from render_fingerprint): refuse a checkpoint
    stamped with a DIFFERENT fingerprint — resuming against a mismatched
    scene/seed/config would silently fold garbage into the running mean.
    A legacy checkpoint with no stamp loads unchecked (shape validation
    still applies at the caller).
    """
    with np.load(checkpoint_path(path)) as data:
        if "version" not in data or "rgb" not in data or "count" not in data:
            raise ValueError(
                f"{checkpoint_path(path)} is not a save_accum checkpoint "
                f"(keys: {sorted(data.files)})"
            )
        version = int(data["version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        if expect_fingerprint is not None and "fingerprint" in data:
            found = str(data["fingerprint"])
            if found != expect_fingerprint:
                raise ValueError(
                    f"{checkpoint_path(path)} was written for a different "
                    "render (scene/seed/config fingerprint "
                    f"{found[:12]}… != expected {expect_fingerprint[:12]}…); "
                    "resuming would fold mismatched samples — delete the "
                    "checkpoint or restore the original flags"
                )
        rgb = np.asarray(data["rgb"], np.float32)
        if rgb.ndim != 3 or rgb.shape[-1] != 3:
            raise ValueError(
                f"checkpoint rgb has shape {rgb.shape}; expected (H, W, 3)"
            )
        return AccumState(
            rgb=jnp.asarray(rgb, jnp.float32),
            count=jnp.asarray(data["count"], jnp.int32),
        )
