"""Image files and resizes of the data pipelines, in numpy.

The port's counterpart of what the JAX package's datasets take from
Pillow and OpenCV, which the port does not depend on:

- `decode_png` / `encode_png`: PNG on `zlib` + `struct`, 8-bit gray, RGB
  and RGBA, non-interlaced; all five row filters when reading, filter
  None when writing. Other PNGs (palette, 16-bit, interlaced) are
  refused with a `ValueError`.
- `read_rgb` reads a PNG or a JPEG frame (by its signature); JPEG goes
  to the port's baseline decoder (`data.jpeg`), bit-equal to Pillow's
  libjpeg-turbo. `image_size` reads a frame's size from its header.
- `crop` (Pillow's `Image.crop`: zero fill outside the image), `mirror`
  and `pad_square` (`ImageOps.expand` to a square, black border).
- `resize_frame`: Pillow's `Image.resize` default, bicubic (a = -0.5)
  with its support widened by the scale when shrinking, in Pillow's
  fixed point: 22-bit integer taps, a horizontal pass clipped to uint8,
  then a vertical pass. Bit-equal to Pillow.
- `resize_nearest`: Pillow's `Image.resize(size, Image.NEAREST)`.
- `resize_mask`: the JAX datasets' `_resize_bool`, OpenCV's float32
  resize (`INTER_AREA` when the width shrinks, else `INTER_LINEAR`) in
  OpenCV's float32 order, then the absolute 0.5 threshold.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .jpeg import SOI, decode_jpeg, jpeg_size

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_CHANNELS = {0: 1, 2: 3, 6: 4}       # gray, RGB, RGBA
_CHANNEL_COLOR = {c: t for t, c in _COLOR_CHANNELS.items()}


# ---------------------------------------------------------------- PNG

def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends without an IEND chunk")


def _unfilter(ftype: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters. filt (H, W, bpp) uint8, ftype (H,).

    Pixel (r, i) depends on its left, upper and upper-left neighbours, so
    every pixel of one anti-diagonal r + i = d is reconstructed at once:
    H + W - 1 vectorized steps for any mix of filter types."""
    if not ftype.any():
        return filt
    if ftype.max() > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    h, w, bpp = filt.shape
    out = np.zeros((h + 1, w + 1, bpp), np.int16)   # zero row 0, column 0
    f16 = filt.astype(np.int16)
    rows_all = np.arange(h)
    for d in range(h + w - 1):
        r = rows_all[max(0, d - w + 1):min(h, d + 1)]
        i = d - r
        a = out[r + 1, i]          # left
        b = out[r, i + 1]          # up
        c = out[r, i]              # upper left
        p_a = np.abs(b - c)
        p_b = np.abs(a - c)
        p_c = np.abs(a + b - 2 * c)
        paeth = np.where((p_a <= p_b) & (p_a <= p_c), a,
                         np.where(p_b <= p_c, b, c))
        pred = np.choose(ftype[r, None].astype(np.intp),
                         [np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        out[r + 1, i + 1] = (f16[r, i] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C = 1 (gray), 3 (RGB) or 4 (RGBA)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file: decode_png reads PNG frames only "
                         "(read_rgb takes JPEG frames to data.jpeg)")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _COLOR_CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {color}, "
            f"interlace {interlace}): only 8-bit gray, RGB and RGBA, "
            "non-interlaced")
    bpp = _COLOR_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError("PNG image data has the wrong size")
    rows = raw.reshape(h, 1 + w * bpp)
    return _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, bpp))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) or (H, W, C) uint8, C in 1, 3, 4 -> PNG bytes (filter None)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.shape[-1] not in _CHANNEL_COLOR:
        raise ValueError(f"cannot write a {img.dtype} image of shape "
                         f"{img.shape} as PNG")
    h, w, c = img.shape
    raw = np.zeros((h, 1 + w * c), np.uint8)
    raw[:, 1:] = img.reshape(h, w * c)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         _CHANNEL_COLOR[c], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_rgb(path: str) -> np.ndarray:
    """A PNG or JPEG frame as (H, W, 3) uint8 RGB: gray is repeated,
    alpha dropped (Pillow's `convert("RGB")`). Another format raises
    ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        img = decode_png(data)
    elif data[:2] == SOI:
        img = decode_jpeg(data, name=path)
    else:
        raise ValueError(f"{path}: neither PNG nor JPEG")
    if img.shape[-1] == 1:
        return np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of a PNG or JPEG frame, from its header."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return struct.unpack(">II", data[16:24])
    if data[:2] == SOI:
        return jpeg_size(data, name=path)
    raise ValueError(f"{path}: neither PNG nor JPEG")


# ---------------------------------------------------- crop and mirror

def crop(img: np.ndarray, coords) -> np.ndarray:
    """The box [min_y, max_y, min_x, max_x] of img (H, W, ...), zero
    outside the image (Pillow's `Image.crop`)."""
    min_y, max_y, min_x, max_x = (int(v) for v in coords)
    h, w = img.shape[:2]
    out = np.zeros((max_y - min_y, max_x - min_x) + img.shape[2:],
                   img.dtype)
    y0, y1 = max(min_y, 0), min(max_y, h)
    x0, x1 = max(min_x, 0), min(max_x, w)
    if y0 < y1 and x0 < x1:
        out[y0 - min_y:y1 - min_y, x0 - min_x:x1 - min_x] = img[y0:y1, x0:x1]
    return out


def mirror(img: np.ndarray) -> np.ndarray:
    """Left-right mirror of an (H, W, ...) image."""
    return np.ascontiguousarray(img[:, ::-1])


def pad_square(img: np.ndarray) -> np.ndarray:
    """(H, W, ...) -> (S, S, ...), S = max(H, W), the image centred on a
    zero border (left/top take the smaller half: `ImageOps.expand` as the
    JAX datasets' `_pad_square` calls it)."""
    h, w = img.shape[:2]
    s = max(h, w)
    top, left = (s - h) // 2, (s - w) // 2
    out = np.zeros((s, s) + img.shape[2:], img.dtype)
    out[top:top + h, left:left + w] = img
    return out


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's `ImagingScaleAffine` source positions: x0 = 0.5 * scale,
    then scale added once per output pixel in double precision, each cast
    to int; -1 where it leaves the image (that output stays 0)."""
    scale = float(in_size) / out_size
    steps = np.full(out_size, scale)
    steps[0] = 0.0 + scale * 0.5
    pos = np.add.accumulate(steps)
    idx = pos.astype(np.int64)
    return np.where((pos >= 0) & (idx < in_size), idx, -1)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """(H, W, ...) -> (h, w, ...) for `size` = (w, h), as Pillow's
    `Image.resize(size, Image.NEAREST)` samples."""
    w, h = size
    if img.shape[:2] == (h, w):
        return img.copy()
    xi = _nearest_index(img.shape[1], w)
    yi = _nearest_index(img.shape[0], h)
    out = img[np.maximum(yi, 0)][:, np.maximum(xi, 0)]
    out[yi < 0] = 0
    out[:, xi < 0] = 0
    return out


# ------------------------------------------ frame resize (Pillow bicubic)

_PRECISION_BITS = 22   # Pillow's fixed point for 8-bit images


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _pillow_taps(in_size: int, out_size: int):
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc`: the first
    input index and the integer taps of each output position, in the
    same double-precision order."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    k = _bicubic(((x[None] + xmin[:, None]) - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    k = np.where(x[None] < xmax[:, None], k, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):             # Pillow sums the taps in order
        ww = ww + k[:, j]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    k = k * (1 << _PRECISION_BITS)
    taps = np.where(k < 0, (k - 0.5).astype(np.int64),
                    (k + 0.5).astype(np.int64))
    return xmin, taps


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along `axis` of an (H, W, C) uint8 image. int32 holds the
    sums: a bicubic output's positive (and negative) taps sum to at most
    1.125 x 2^22, so every partial sum lies within 255 x 1.125 x 2^22 +
    2^21 < 2^31."""
    xmin, taps = _pillow_taps(img.shape[axis], out_size)
    taps = taps.astype(np.int32)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    for j in range(taps.shape[1]):
        idx = np.minimum(xmin + j, img.shape[axis] - 1)  # taps past xmax: 0
        acc += np.take(img, idx, axis=axis) * taps[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_frame(img: np.ndarray, size) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 for `size` = (w, h), as Pillow's
    `Image.resize(size)` (bicubic) resizes a frame."""
    w, h = size
    if img.shape[1] != w:
        img = _resample_axis(img, w, 1)
    if img.shape[0] != h:
        img = _resample_axis(img, h, 0)
    return img


# ------------------------------------------ mask resize (OpenCV float32)

_F32 = np.float32


def _area_fast(src: np.ndarray, sx: int, sy: int) -> np.ndarray:
    h, w = src.shape[0] // sy, src.shape[1] // sx
    total = src[:h * sy, :w * sx].reshape(h, sy, w, sx).sum(
        axis=(1, 3), dtype=np.float64)      # integer-valued, exact
    return total.astype(_F32) * _F32(1.0 / (sx * sy))


def _area_tab(ssize: int, dsize: int, scale: float):
    """OpenCV's `computeResizeAreaTab`, as a (dsize, k) table of source
    indices and float32 weights in OpenCV's order (weight 0 pads)."""
    entries = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        entries.append(row)
    k = max(len(r) for r in entries)
    idx = np.zeros((dsize, k), np.int64)
    wgt = np.zeros((dsize, k), _F32)
    for dx, row in enumerate(entries):
        for j, (s, a) in enumerate(row):
            idx[dx, j], wgt[dx, j] = s, a
    return idx, wgt


def _area(src: np.ndarray, dw: int, dh: int, scale_x: float,
          scale_y: float) -> np.ndarray:
    xi, xw = _area_tab(src.shape[1], dw, scale_x)
    yi, yw = _area_tab(src.shape[0], dh, scale_y)
    buf = np.zeros((src.shape[0], dw), _F32)
    for j in range(xi.shape[1]):           # OpenCV's float32 order
        buf = buf + src[:, xi[:, j]] * xw[:, j]
    out = np.zeros((dh, dw), _F32)
    for j in range(yi.shape[1]):
        out = out + yw[:, j, None] * buf[yi[:, j]]
    return out


def _linear_tab(ssize: int, dsize: int, scale: float, inv_scale: float,
                area_mode: bool):
    d = np.arange(dsize)
    if area_mode:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv_scale).astype(_F32)
        f = np.where(f <= 0, _F32(0), f - np.floor(f)).astype(_F32)
    else:
        f = (d + 0.5) * scale - 0.5
        s = np.floor(f).astype(np.int64)
        f = (f - s).astype(_F32)
    return s, f


def _lerp(x0: np.ndarray, x1: np.ndarray, t: np.ndarray) -> np.ndarray:
    """OpenCV's float32 blend x0 + (x1 - x0) * t, the product and sum
    fused (one rounding, as its FMA does)."""
    d = (x1 - x0).astype(np.float64)
    return (x0.astype(np.float64) + d * t).astype(_F32)


def _linear(src: np.ndarray, dw: int, dh: int, scale_x: float,
            scale_y: float, inv_x: float, inv_y: float,
            area_mode: bool) -> np.ndarray:
    h, w = src.shape
    sx, fx = _linear_tab(w, dw, scale_x, inv_x, area_mode)
    fx = np.where((sx < 0) | (sx >= w - 1), _F32(0), fx)  # edge: no blend
    sx = np.clip(sx, 0, w - 1)
    hor = _lerp(src[:, sx], src[:, np.minimum(sx + 1, w - 1)], fx)
    sy, fy = _linear_tab(h, dh, scale_y, inv_y, area_mode)
    return _lerp(hor[np.clip(sy, 0, h - 1)], hor[np.clip(sy + 1, 0, h - 1)],
                 fy[:, None])


def _cv_resize(src: np.ndarray, size, area: bool) -> np.ndarray:
    """OpenCV's `cv2.resize` of a 2-D float32 array to `size` (w, h)."""
    dw, dh = size
    h, w = src.shape
    inv_x, inv_y = dw / w, dh / h
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    ix, iy = int(round(scale_x)), int(round(scale_y))
    area_fast = (abs(scale_x - ix) < np.finfo(float).eps
                 and abs(scale_y - iy) < np.finfo(float).eps)
    if not area and area_fast and ix == 2 and iy == 2:
        area = True
    if area and scale_x >= 1 and scale_y >= 1:
        if area_fast:
            return _area_fast(src, ix, iy)
        return _area(src, dw, dh, scale_x, scale_y)
    return _linear(src, dw, dh, scale_x, scale_y, inv_x, inv_y, area)


def resize_mask(arr: np.ndarray, size) -> np.ndarray:
    """Binary mask (H, W) uint8 (0/1 or 0/255) -> (h, w) uint8 0/1 for
    `size` = (w, h): the JAX datasets' `_resize_bool` (area when the width
    shrinks, else bilinear; the ABSOLUTE 0.5 threshold, so attenuated
    stroke peaks thin out rather than the mask thickening)."""
    scale = 255.0 if arr.dtype == np.uint8 and arr.max() > 1 else 1.0
    src = arr.astype(_F32) / scale
    out = _cv_resize(src, size, area=size[0] < arr.shape[1])
    return (out > 0.5).astype(np.uint8)
