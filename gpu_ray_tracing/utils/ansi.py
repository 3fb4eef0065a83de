"""Terminal image presentation: 24-bit ANSI half-block frames.

The reference is an interactive window — a Bevy sprite presents the
accumulation texture every frame (lib.rs:79-87, 96-102) so the user
watches the render converge.  A batch renderer is headless; the runtime
equivalent here is the terminal itself: the `view` CLI command renders
progressive steps and repaints the accumulation as truecolor half-block
cells (each character cell shows two image rows via '▀' with separate
foreground/background colors), in place, at interactive rates.

Pure numpy — the presentation layer stays independently testable.
"""

from __future__ import annotations

import numpy as np

RESET = "\x1b[0m"
CURSOR_HOME = "\x1b[H"
CLEAR_SCREEN = "\x1b[2J"
HIDE_CURSOR = "\x1b[?25l"
SHOW_CURSOR = "\x1b[?25h"


def downsample_mean(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Box-mean an (H, W, C) image to (out_h, out_w, C).

    Bins are the integer edges of a uniform partition (np.add.reduceat),
    so any input size maps to any smaller-or-equal output size without
    resampling libraries; equal sizes pass through untouched.
    """
    h, w = img.shape[:2]
    if out_h <= 0 or out_w <= 0:
        raise ValueError(f"output size must be positive, got {out_h}x{out_w}")
    if out_h > h or out_w > w:
        raise ValueError(
            f"downsample only: image is {h}x{w}, requested {out_h}x{out_w}"
        )
    if (h, w) == (out_h, out_w):
        return np.asarray(img, np.float32)
    img = np.asarray(img, np.float32)
    ye = (np.arange(out_h) * h) // out_h
    xe = (np.arange(out_w) * w) // out_w
    sums = np.add.reduceat(np.add.reduceat(img, ye, axis=0), xe, axis=1)
    ny = np.diff(np.append(ye, h)).astype(np.float32)
    nx = np.diff(np.append(xe, w)).astype(np.float32)
    return sums / (ny[:, None, None] * nx[None, :, None])


def tonemap_u8(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """Linear radiance -> display u8 with the CLI's gamma convention;
    non-finite pixels render black instead of poisoning the whole frame."""
    img = np.asarray(img, np.float32)
    img = np.where(np.isfinite(img), img, 0.0)
    img = np.clip(img, 0.0, 1.0) ** (1.0 / max(gamma, 1e-6))
    return (img * 255.0 + 0.5).astype(np.uint8)


def image_to_ansi(img: np.ndarray, cols: int, gamma: float = 2.2) -> str:
    """Render an (H, W, 3) linear-radiance image as `cols`-wide truecolor
    half-block text: ceil(rows/2) lines, each cell '▀' with the top image
    row as foreground and the bottom as background (2 pixels per cell).

    Aspect is preserved assuming ~2:1 terminal cell geometry, which the
    half-blocks exactly cancel: a cols-wide frame gets cols * H/W pixel
    rows = that many half-cells.
    """
    h, w = img.shape[:2]
    cols = max(2, min(cols, w))
    rows = max(2, min(int(round(cols * (h / w))), h))
    rows -= rows % 2  # half-blocks consume rows in pairs
    small = tonemap_u8(downsample_mean(img, rows, cols), gamma)
    top = small[0::2]
    bot = small[1::2]
    lines = []
    for ti, bi in zip(top, bot):
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(ti, bi)
        ]
        lines.append("".join(cells) + RESET)
    return "\n".join(lines)
