"""Terminal live view: ANSI half-block rendering of the progressive film.
NumPy only; the port's own copy of pyrenderer_tpu/utils/termview.py.

The reference shows its progressive render in a `ti.GUI` window
(reference main_taichi.py:102-127). A headless host draws the tonemapped
accumulation into the terminal instead: each character cell is two
vertical pixels, the upper-half-block glyph with a 24-bit foreground (top
pixel) and background (bottom pixel) color. The CLI's `--live` redraws it
in place every N passes; PNG previews (`--preview-interval`) stay
available independently.
"""

from __future__ import annotations

import os
import sys

import numpy as np

_HALF = "▀"  # upper half block: fg = top pixel, bg = bottom pixel


def _fit(h: int, w: int, max_cols: int, max_rows: int):
    """Output size in CHARACTER cells (each cell = 1x2 pixels)."""
    max_px_w = max_cols
    max_px_h = max_rows * 2
    scale = min(max_px_w / w, max_px_h / h, 1.0)
    return max(1, int(h * scale)) // 2 * 2 or 2, max(1, int(w * scale))


def _downsample(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Box-average to (out_h, out_w, 3) — no deps beyond numpy."""
    h, w = img.shape[:2]
    ys = (np.arange(out_h + 1) * h // out_h).clip(0, h)
    xs = (np.arange(out_w + 1) * w // out_w).clip(0, w)
    out = np.empty((out_h, out_w, 3), np.float32)
    csum = np.zeros((h + 1, w + 1, 3), np.float64)
    csum[1:, 1:] = np.cumsum(np.cumsum(img, axis=0), axis=1)
    for i in range(out_h):
        y0, y1 = ys[i], max(ys[i + 1], ys[i] + 1)
        area_y = y1 - y0
        row = (
            csum[y1, xs[1:]] - csum[y0, xs[1:]]
            - csum[y1, xs[:-1]] + csum[y0, xs[:-1]]
        )
        area = area_y * np.maximum(xs[1:] - xs[:-1], 1)[:, None]
        out[i] = row / area
    return out


def frame_to_ansi(ldr: np.ndarray, max_cols: int = 100,
                  max_rows: int = 40) -> str:
    """(H, W, 3) float [0,1] (or uint8) LDR image -> ANSI half-block art."""
    img = np.asarray(ldr, np.float32)
    if img.dtype == np.float32 and img.max() > 1.5:
        img = img / 255.0
    img = np.clip(img, 0.0, 1.0)
    out_h, out_w = _fit(img.shape[0], img.shape[1], max_cols, max_rows)
    small = (_downsample(img, out_h, out_w) * 255).astype(np.uint8)
    lines = []
    for y in range(0, out_h - 1, 2):
        parts = []
        for x in range(out_w):
            tr, tg, tb = small[y, x]
            br, bg, bb = small[y + 1, x]
            parts.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m{_HALF}"
            )
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


class LiveView:
    """In-place terminal redraw of the progressive film.

    Call update(ldr, status) per pass; the previous frame is overwritten
    via cursor-up escapes, so the render 'animates' like the reference's
    GUI window. Writes to stderr (stdout stays clean for pipelines).

    The rewind assumes the cursor has not moved since the last update —
    anything else printed between frames breaks the in-place redraw, so
    the CLI silences the driver's periodic progress prints while --live
    is active and routes the spp count through `status` instead."""

    def __init__(self, max_cols: int | None = None, max_rows: int = 40,
                 stream=None):
        self.stream = stream or sys.stderr
        if max_cols is None:
            try:
                max_cols = min(os.get_terminal_size().columns, 120)
            except OSError:
                max_cols = 100
        self.max_cols = max_cols
        self.max_rows = max_rows
        self._last_lines = 0

    def update(self, ldr: np.ndarray, status: str = "") -> None:
        art = frame_to_ansi(ldr, self.max_cols, self.max_rows)
        n_lines = art.count("\n") + 1 + (1 if status else 0)
        if self._last_lines:
            self.stream.write(f"\x1b[{self._last_lines}F\x1b[J")
        self.stream.write(art + "\n")
        if status:
            self.stream.write(status + "\n")
        self.stream.flush()
        self._last_lines = n_lines
