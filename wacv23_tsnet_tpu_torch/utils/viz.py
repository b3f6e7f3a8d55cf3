"""Visualization helpers (counterpart of the JAX package's `utils/viz.py`)
without matplotlib.

`tensor2im` turns an array into a displayable uint8 image as there;
`map2fig` colours a heatmap with matplotlib's `jet` colormap, its 256
colours computed here from matplotlib's segment data with matplotlib's
own interpolation; `plot_grid` / `grid2fig` draw a warp grid against the
identity grid on a 256 x 256 canvas with the port's own line rasterizer
(`Canvas`), which `cli.plot_history` also draws with, text included
(`utils.font`). Images are (H, W, 3) uint8 RGB, for
`data.image_io.encode_png`.
"""

from __future__ import annotations

import numpy as np

from . import font

# matplotlib's `jet` (matplotlib/_cm.py `_jet_data`): per channel, the
# (x, y0, y1) points of a piecewise-linear map [0, 1] -> [0, 1]
JET_DATA = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}

# matplotlib's default colours of `grid2fig`'s lines: "lightgrey" and
# "C0" (the first colour of the default cycle, #1f77b4)
LIGHTGREY = (211, 211, 211)
C0 = (31, 119, 180)


def _lookup_table(n: int, data) -> np.ndarray:
    """matplotlib's `colors._create_lookup_table(n, data)` (gamma 1)."""
    adata = np.array(data, dtype=float)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet_table(n: int = 256) -> np.ndarray:
    """(n, 3) float64 RGB of matplotlib's `jet` with n colours."""
    return np.stack([_lookup_table(n, JET_DATA[c])
                     for c in ("red", "green", "blue")], axis=1)


JET = jet_table()
JET_BYTES = (JET * 255).astype(np.uint8)     # as matplotlib's bytes=True


def tensor2im(array, imtype=np.uint8, normalize: bool = True) -> np.ndarray:
    """Array -> displayable HWC uint8 (the reference's tensor2im).

    Accepts (B, T, C, H, W) / (B, C, H, W) / (C, H, W) / (H, W) arrays,
    tensors on any device, or a list of them; min-max normalizes to
    [0, 255] when `normalize`, else scales by 255.
    """
    if isinstance(array, list):
        return [tensor2im(a, imtype, normalize) for a in array]
    if hasattr(array, "detach"):
        array = array.detach().float().cpu().numpy()
    a = np.asarray(array, np.float32)
    if a.ndim == 5:
        a = a[0, -1]
    if a.ndim == 4:
        a = a[0]
    if a.ndim == 2:
        a = a[None]
    a = a[:3]
    if normalize:
        lo, hi = a.min(), a.max()
        a = (a.transpose(1, 2, 0) - lo) / max(hi - lo, 1e-12) * 255.0
    else:
        a = a.transpose(1, 2, 0) * 255.0
    a = np.clip(a, 0, 255)
    if a.shape[2] == 1:
        a = a[:, :, 0]
    return a.astype(imtype)


def map2fig(heatmap: np.ndarray, initial: bool = True) -> np.ndarray:
    """Heatmap (H, W) -> jet-coloured (H, W, 3) uint8 at its own size,
    min-max normalized (with `initial`, pixel (0, 0) first set to 1, as
    the reference does to pin the colour scale)."""
    h = np.array(heatmap, np.float32, copy=True)
    if initial:
        h[0, 0] = 1.0
    lo, hi = h.min(), h.max()
    x = (h - lo) / (hi - lo) if hi > lo else np.zeros_like(h)
    idx = np.clip((x * len(JET)).astype(np.int64), 0, len(JET) - 1)
    return JET_BYTES[idx]


class Canvas:
    """An RGB image to draw on, with a map from data (x, y) to pixels:
    the data box `xlim` x `ylim` spans the pixel box `box` = (left, top,
    right, bottom), y up. Lines are drawn with coverage from each pixel
    centre's distance to the segment (a simple anti-aliasing), text with
    `utils.font`."""

    def __init__(self, height: int, width: int, background=(255, 255, 255)):
        self.img = np.empty((height, width, 3), np.float32)
        self.img[:] = background
        self.box = (0.0, 0.0, float(width), float(height))
        self.xlim = (0.0, 1.0)
        self.ylim = (0.0, 1.0)

    def to_pixels(self, x, y):
        left, top, right, bottom = self.box
        (x0, x1), (y0, y1) = self.xlim, self.ylim
        px = left + (np.asarray(x, float) - x0) / (x1 - x0) * (right - left)
        py = bottom - (np.asarray(y, float) - y0) / (y1 - y0) * (bottom - top)
        return px, py

    def _blend(self, rows, cols, cover, color) -> None:
        c = np.asarray(color, np.float32)
        region = self.img[rows, cols]
        self.img[rows, cols] = region + cover[..., None] * (c - region)

    def segment(self, p0, p1, color, width: float = 1.0,
                butt: tuple[bool, bool] = (False, False)) -> None:
        """A line from pixel point p0 to p1 (x, y), `width` pixels wide;
        round ends, or flat (butt) ones where `butt` says so."""
        (ax, ay), (bx, by) = p0, p1
        r = width / 2.0 + 1.0
        h, w = self.img.shape[:2]
        c0, c1 = int(max(np.floor(min(ax, bx) - r), 0)), int(
            min(np.ceil(max(ax, bx) + r), w))
        r0, r1 = int(max(np.floor(min(ay, by) - r), 0)), int(
            min(np.ceil(max(ay, by) + r), h))
        if c0 >= c1 or r0 >= r1:
            return
        ys, xs = np.mgrid[r0:r1, c0:c1] + 0.5
        dx, dy = bx - ax, by - ay
        length2 = dx * dx + dy * dy
        raw = (((xs - ax) * dx + (ys - ay) * dy) / length2
               if length2 > 0 else np.zeros_like(xs))
        t = np.clip(raw, 0.0, 1.0)
        dist = np.hypot(xs - (ax + t * dx), ys - (ay + t * dy))
        cover = np.clip(width / 2.0 + 0.5 - dist, 0.0, 1.0)
        along = raw * np.sqrt(length2)
        if butt[0]:
            cover *= np.clip(along + 0.5, 0.0, 1.0)
        if butt[1]:
            cover *= np.clip(np.sqrt(length2) - along + 0.5, 0.0, 1.0)
        self._blend(slice(r0, r1), slice(c0, c1), cover, color)

    def polyline(self, xs, ys, color, width: float = 1.0) -> None:
        """The data points (xs, ys) joined in order (round joins, flat
        ends, as matplotlib draws a line)."""
        px, py = self.to_pixels(xs, ys)
        n = len(px) - 1
        for i in range(n):
            self.segment((px[i], py[i]), (px[i + 1], py[i + 1]), color, width,
                         butt=(i == 0, i == n - 1))

    def text(self, x: float, y: float, s: str, color, scale: int = 1,
             ha: str = "left", va: str = "top") -> None:
        """`s` at pixel (x, y), anchored by `ha` (left, center, right) and
        `va` (top, center, bottom)."""
        mask = font.render(s, scale)
        th, tw = mask.shape
        x0 = int(round(x - {"left": 0, "center": tw / 2, "right": tw}[ha]))
        y0 = int(round(y - {"top": 0, "center": th / 2, "bottom": th}[va]))
        h, w = self.img.shape[:2]
        r0, c0 = max(y0, 0), max(x0, 0)
        r1, c1 = min(y0 + th, h), min(x0 + tw, w)
        if r0 >= r1 or c0 >= c1:
            return
        cover = mask[r0 - y0:r1 - y0, c0 - x0:c1 - x0].astype(np.float32)
        self._blend(slice(r0, r1), slice(c0, c1), cover, color)

    def image(self) -> np.ndarray:
        return np.clip(np.round(self.img), 0, 255).astype(np.uint8)


def plot_grid(canvas: Canvas, x: np.ndarray, y: np.ndarray, color,
              width: float = 1.5 * 100 / 72) -> None:
    """Draw a deformable grid given by the (h, w) point arrays x and y as
    its rows and its columns of lines (matplotlib's default 1.5-point
    lines at 100 dpi)."""
    for i in range(x.shape[0]):
        canvas.polyline(x[i], y[i], color, width)
    for j in range(x.shape[1]):
        canvas.polyline(x[:, j], y[:, j], color, width)


def grid2fig(warped_grid: np.ndarray, grid_size: int = 32) -> np.ndarray:
    """A (h, w, 2) flow grid drawn against the identity grid of
    `grid_size` lines: (256, 256, 3) uint8. The data box is both grids'
    extent with a 5% margin each side (matplotlib's autoscale), filling
    the canvas; the identity grid light grey, the flow grid C0 over it."""
    lin = np.linspace(-1, 1, grid_size)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    wx, wy = (np.asarray(warped_grid[..., i], float) for i in (0, 1))
    canvas = Canvas(256, 256)
    for axis, (lo, hi) in enumerate(
            [(min(gx.min(), wx.min()), max(gx.max(), wx.max())),
             (min(gy.min(), wy.min()), max(gy.max(), wy.max()))]):
        pad = 0.05 * (hi - lo)
        lim = (lo - pad, hi + pad)
        if axis == 0:
            canvas.xlim = lim
        else:
            canvas.ylim = lim
    plot_grid(canvas, gx, gy, LIGHTGREY)
    plot_grid(canvas, wx, wy, C0)
    return canvas.image()
