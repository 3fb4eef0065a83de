"""Device mesh helpers.

The reference has no multi-device story at all (single wgpu device, no
collectives — SURVEY §2c); pixel and sample parallelism across the cards
of one host is this framework's scaling model:

  - axis 'x': framebuffer rows (data parallel over pixels; halo-free since
    rays never interact)
  - axis 's': samples-per-pixel batches (temporal axis of the reference's
    progressive accumulation, wgsl:352-358, spread over cards instead of
    frames), combined with a mean over the axis — the only collective in the
    whole framework, an NCCL all-reduce over NVLink.

Every card of a host reaches every other at the same rate, so the mesh
takes `jax.devices()` in order and no topology-aware shape applies.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

ROW_AXIS = "x"
SPP_AXIS = "s"


def make_mesh(
    num_row_shards: int | None = None,
    num_spp_shards: int = 1,
    devices=None,
) -> Mesh:
    """Build a (row, spp) mesh over the available devices.

    Defaults to all devices on the row axis.  With the automatic
    jax.devices() pool a sub-mesh is allowed (the first
    num_row_shards * num_spp_shards devices are used); an explicitly
    provided device list must match that product exactly.
    """
    explicit = devices is not None
    devices = list(jax.devices()) if devices is None else list(devices)
    if num_spp_shards < 1:
        raise ValueError(f"num_spp_shards must be >= 1, got {num_spp_shards}")
    if num_row_shards is None:
        num_row_shards = len(devices) // num_spp_shards
    if num_row_shards < 1:
        raise ValueError(
            f"mesh would have {num_row_shards} row shards "
            f"({len(devices)} devices / {num_spp_shards} spp shards) — a "
            "zero-device mesh fails later with an opaque sharding error"
        )
    n = num_row_shards * num_spp_shards
    if n > len(devices):
        raise ValueError(
            f"mesh {num_row_shards}x{num_spp_shards} needs {n} devices, "
            f"have {len(devices)}"
        )
    if explicit and n != len(devices):
        # An explicitly provided device list must match exactly — silently
        # dropping the remainder would waste hardware the caller named.
        # (The auto jax.devices() pool intentionally allows sub-meshes.)
        raise ValueError(
            f"mesh {num_row_shards}x{num_spp_shards} uses {n} devices but "
            f"{len(devices)} were explicitly provided; pass exactly {n}"
        )
    grid = np.asarray(devices[:n]).reshape(num_row_shards, num_spp_shards)
    return Mesh(grid, (ROW_AXIS, SPP_AXIS))
