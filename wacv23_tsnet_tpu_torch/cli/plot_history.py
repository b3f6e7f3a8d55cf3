"""Render training-history / eval-metric CSVs as small-multiple curves
(counterpart of the JAX package's `cli/plot_history.py`, same flags and
layout), drawn without matplotlib.

    python -m wacv23_tsnet_tpu_torch.cli.plot_history \\
        --csv runs/face/history.csv --out loss_curves.png

One panel per column (losses and metrics have different scales, so they
never share a y-axis), up to four panels a row, each 3.2 x 2.4 inches at
110 dpi (352 x 264 pixels); a single series per panel, the panel title
carrying its name (no legend), a recessive grid at the y and x ticks, the
final value labelled at the curve's end, the x column named under the
figure. The colours are the JAX CLI's. Text is the port's 5x7 bitmap font
(`utils.font`), lines the port's rasterizer (`utils.viz.Canvas`); the PNG
is written by `data.image_io.encode_png`.
"""

from __future__ import annotations

import argparse
import csv
import math

import numpy as np

from ..data.image_io import encode_png
from ..utils.viz import Canvas

INK = (0x1f, 0x24, 0x30)        # primary text
MUTED = (0x6b, 0x72, 0x80)      # secondary text / axis
GRID = (0xe5, 0xe7, 0xeb)
LINE = (0x25, 0x63, 0xeb)       # one categorical hue; one series a panel

DPI = 110
PANEL_IN = (3.2, 2.4)           # a panel's width and height, inches
POINT = DPI / 72.0              # pixels a point
TITLE_BAND = 26                 # above the panels, for --title
XLABEL_BAND = 22                # below the panels, the x column's name
# the axes box inside a panel: left (y tick labels), top (title), right,
# bottom (x tick labels), in pixels
MARGINS = (56, 30, 14, 22)


def nice_ticks(lo: float, hi: float, n: int = 5) -> list[float]:
    """At most about n+1 round tick values (steps 1, 2, 2.5, 5 x 10^k)
    inside [lo, hi]."""
    if not hi > lo:
        return [lo]
    raw = (hi - lo) / n
    mag = 10.0 ** math.floor(math.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    first = math.ceil(lo / step - 1e-9) * step
    ticks, t = [], first
    while t <= hi + 1e-9 * step:
        ticks.append(0.0 if abs(t) < 1e-12 * step else t)
        t += step
    return ticks


def _limits(values: list[float]) -> tuple[float, float]:
    """The data range with matplotlib's 5% margin each side."""
    lo, hi = min(values), max(values)
    if hi == lo:
        pad = abs(lo) * 0.05 or 0.5
        return lo - pad, hi + pad
    pad = 0.05 * (hi - lo)
    return lo - pad, hi + pad


def _tick_label(v: float) -> str:
    return f"{v:.6g}"


def draw_panel(canvas: Canvas, box, name: str, xs, ys) -> None:
    """One panel: grid, spines, tick labels, the curve, the title and the
    final value, in the pixel box (left, top, right, bottom)."""
    left, top, right, bottom = box
    canvas.box = tuple(float(v) for v in box)
    canvas.xlim, canvas.ylim = _limits(xs), _limits(ys)
    grid_w = 0.8 * POINT
    for t in nice_ticks(*canvas.ylim):
        _, py = canvas.to_pixels(canvas.xlim[0], t)
        canvas.segment((left, py), (right, py), GRID, grid_w)
        canvas.text(left - 4, py, _tick_label(t), MUTED, ha="right",
                    va="center")
    for t in nice_ticks(*canvas.xlim):
        px, _ = canvas.to_pixels(t, canvas.ylim[0])
        canvas.segment((px, top), (px, bottom), GRID, grid_w)
        canvas.text(px, bottom + 4, _tick_label(t), MUTED, ha="center")
    # spines: left and bottom only
    canvas.segment((left, top), (left, bottom), MUTED, 1.0)
    canvas.segment((left, bottom), (right, bottom), MUTED, 1.0)
    canvas.polyline(xs, ys, LINE, 2.0 * POINT)
    canvas.text(left, top - 8, name, INK, scale=2, va="bottom")
    # the final value, offset (-2, +6) points from the last point
    px, py = canvas.to_pixels(xs[-1], ys[-1])
    canvas.text(px - 2 * POINT, py - 6 * POINT, f"{ys[-1]:.3g}", INK,
                scale=2, ha="right", va="bottom")


def render(rows: list[dict], xcol: str, ycols: list[str],
           title: str | None = None) -> np.ndarray:
    """The figure of `ycols` against `xcol` over `rows`: (H, W, 3)
    uint8."""
    n = len(ycols)
    ncols = min(4, n)
    nrows = math.ceil(n / ncols)
    width = int(PANEL_IN[0] * ncols * DPI)
    height = int(PANEL_IN[1] * nrows * DPI)
    canvas = Canvas(height, width)
    top0 = TITLE_BAND if title else 0
    cell_w = width / ncols
    cell_h = (height - top0 - XLABEL_BAND) / nrows
    xs = [float(r[xcol]) for r in rows]
    ml, mt, mr, mb = MARGINS
    for i, c in enumerate(ycols):
        x0 = (i % ncols) * cell_w
        y0 = top0 + (i // ncols) * cell_h
        box = (int(x0 + ml), int(y0 + mt), int(x0 + cell_w - mr),
               int(y0 + cell_h - mb))
        draw_panel(canvas, box, c, xs, [float(r[c]) for r in rows])
    if title:
        canvas.text(width / 2, TITLE_BAND / 2, title, INK, scale=2,
                    ha="center", va="center")
    canvas.text(width / 2, height - XLABEL_BAND / 2, xcol, MUTED, scale=2,
                ha="center", va="center")
    return canvas.image()


def main(argv=None) -> np.ndarray:
    """Parse `argv`, draw, write the PNG; returns the image."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--csv", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--x", default=None,
                   help="x column (default: first column)")
    p.add_argument("--skip", default="seconds",
                   help="comma-separated columns to skip")
    p.add_argument("--title", default=None)
    args = p.parse_args(argv)

    with open(args.csv) as fh:
        rows = list(csv.DictReader(fh))
    if not rows:
        raise SystemExit(f"{args.csv} is empty")
    cols = list(rows[0])
    xcol = args.x or cols[0]
    skip = set(args.skip.split(",")) | {xcol}
    ycols = [c for c in cols if c not in skip]
    img = render(rows, xcol, ycols, args.title)
    with open(args.out, "wb") as fh:
        fh.write(encode_png(img))
    print(f"wrote {args.out} ({len(ycols)} panels)")
    return img


if __name__ == "__main__":
    main()
