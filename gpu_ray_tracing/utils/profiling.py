"""Profiling and per-frame metrics.

The reference has no timers, counters, or logging of any kind (SURVEY §5:
the only perf affordance is a commented-out vsync toggle, lib.rs:40-41).
This module supplies the observability layer: wall-clock frame timing with
derived ray-throughput counters, the device's published peaks, the record
of what a number was measured on, and a thin wrapper over jax.profiler for
device traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import time
from typing import Callable

import jax

#: Published peaks per `device_kind` (as `jax.devices()[0].device_kind`
#: reports it).  Source: NVIDIA's H100 data sheet, SXM part, dense rates,
#: at the full 700 W power limit.  A device that is not listed is an error,
#: never a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_sec": 3.35e12,
        "fp32_flops_per_sec": 67e12,  # outside the tensor cores
        "source": "NVIDIA H100 data sheet, SXM, dense",
    },
}

# Every reported ray writes at least one f32 RGB pixel (12 bytes) of image
# traffic, so no honest measurement exceeds peak bandwidth / 12 B.
MIN_BYTES_PER_RAY = 12.0


def peaks(device_kind: str) -> dict:
    """The published peaks of `device_kind`; ValueError if not tabled."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            "utils/profiling.PEAKS with its source"
        ) from None


def check_plausible(mrays_per_sec: float, device_kind: str, n_devices: int = 1) -> None:
    """Raise if a throughput number exceeds the device-memory bound.

    `n_devices` scales the ceiling for legitimately aggregated multi-card
    measurements."""
    bw = peaks(device_kind)["hbm_bytes_per_sec"]
    ceiling = bw / MIN_BYTES_PER_RAY / 1e6 * max(n_devices, 1)
    if mrays_per_sec > ceiling:
        raise RuntimeError(
            f"measured {mrays_per_sec:.0f} Mrays/s exceeds the device-memory "
            f"ceiling (~{ceiling:.0f} Mrays/s at {MIN_BYTES_PER_RAY:.0f} B/ray, "
            f"{bw / 1e9:.0f} GB/s x {max(n_devices, 1)} device(s)) — the "
            "timing did not cover the work; refusing to report it"
        )


def nvidia_smi(query: str = "name,power.limit") -> str | None:
    """One `nvidia-smi --query-gpu=<query>` line, or None where there is no
    NVIDIA driver (the CPU test hosts)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def device_record() -> dict:
    """What a measurement ran on: platform, device kind and count, the
    card's name and power limit (nvidia-smi), and XLA_FLAGS."""
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "nvidia_smi_name_power_limit": nvidia_smi(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


@dataclasses.dataclass
class FrameStats:
    """Throughput record for a timed render workload."""

    frames: int
    seconds: float
    width: int
    height: int
    spp: int
    # Per-window wall-clock times; `seconds` is the median window.
    window_seconds: tuple = ()
    # MEASURED rays traced per frame (count_traced_rays: live closest-hit
    # walks per bounce + driven NEE shadow rays, in-kernel counters) — set
    # by callers that counted; 0.0 = not counted.  `mrays_per_sec` counts
    # PRIMARY rays only and understates path workloads up to ~50x;
    # `true_mrays_per_sec` is the honest figure.
    rays_traced_per_frame: float = 0.0

    @property
    def ms_per_frame(self) -> float:
        return self.seconds / self.frames * 1e3

    @property
    def rays_per_frame(self) -> int:
        # Primary rays; bounce rays depend on the scene (SURVEY §6 counts
        # <= depth x primary as the upper bound).
        return self.width * self.height * self.spp

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_per_frame * self.frames / self.seconds / 1e6

    @property
    def true_mrays_per_sec(self) -> float:
        """Measured-rays throughput (0.0 when rays were not counted)."""
        return self.rays_traced_per_frame * self.frames / self.seconds / 1e6

    @property
    def spp_per_sec(self) -> float:
        return self.spp * self.frames / self.seconds

    @property
    def window_spread(self) -> float:
        """max/min ratio across repeated windows (1.0 = perfectly stable)."""
        ws = self.window_seconds
        if len(ws) < 2:
            return 1.0
        return max(ws) / max(min(ws), 1e-12)

    def to_dict(self) -> dict:
        d = {
            "frames": self.frames,
            "ms_per_frame": self.ms_per_frame,
            "mrays_per_sec": self.mrays_per_sec,
            "spp_per_sec": self.spp_per_sec,
            "window_spread": self.window_spread,
        }
        if self.rays_traced_per_frame:
            d["rays_traced_per_frame"] = self.rays_traced_per_frame
            d["true_mrays_per_sec"] = self.true_mrays_per_sec
        return d

    def __str__(self) -> str:
        return json.dumps(self.to_dict())


def time_frames(
    frame_fn: Callable[[int], jax.Array],
    *,
    width: int,
    height: int,
    spp: int,
    frames: int = 10,
    warmup: int = 1,
    repeats: int = 3,
) -> FrameStats:
    """Time `frame_fn(i)` over windows of `frames` calls (after `warmup`
    calls, which include compilation).

    Each window ends in `jax.block_until_ready` on every frame's output, so
    the clock stops only after the device has finished the work.  Runs
    `repeats` windows and reports the median; per-window times stay on the
    result for the spread.  Timing includes one host dispatch per frame.
    """
    for i in range(warmup):
        jax.block_until_ready(frame_fn(i))

    windows = []
    for r in range(repeats):
        t0 = time.perf_counter()
        outs = [frame_fn(warmup + r * frames + i) for i in range(frames)]
        jax.block_until_ready(outs)
        windows.append(time.perf_counter() - t0)
    seconds = sorted(windows)[len(windows) // 2]
    return FrameStats(
        frames=frames, seconds=seconds, width=width, height=height, spp=spp,
        window_seconds=tuple(windows),
    )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context: view with TensorBoard/XProf or read the
    .xplane.pb with jax.profiler.ProfileData."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
