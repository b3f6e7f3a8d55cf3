"""Animated GIF89a writer in numpy (the port's counterpart of what the JAX
package's `save_gif` takes from imageio and Pillow).

Palette rule: each frame gets one adaptive palette of at most 256
colours by median cut, without dithering. The frame's colour histogram at
5 bits a channel starts as one box; the box holding the most pixels
(among boxes of more than one cell) is split along its widest channel at
its pixel-weighted median, until there are 256 boxes. Each box's colour
is the mean of the pixels in it, and each pixel takes the palette colour
nearest to it. A frame of at most 256 colours is written exactly.

Bit stream: per frame, a graphic-control extension (the delay in
centiseconds), an image descriptor with a 256-entry local colour table,
and LZW data at minimum code size 8 with variable-width codes (9 to 12
bits). The index stream is cut into segments of `SEGMENT` pixels, each
opening with a clear code, so the segments are independent LZW streams:
they are encoded all at once, one pixel of every segment per step, their
string tables in one open-addressing hash table. A NETSCAPE2.0 block
makes the animation loop.
"""

from __future__ import annotations

import heapq
import itertools
import struct
from typing import Sequence

import numpy as np

MAX_COLORS = 256
BIN_BITS = 5              # median cut on a 5-bit-per-channel histogram
_CELL = (1 << BIN_BITS) - 1
SEGMENT = 1024            # pixels per LZW segment: < 4096 - 258 codes
LANES = 4096              # segments encoded together (bounds the table)
_CLEAR, _EOI, _FIRST = 256, 257, 258
_EMPTY = np.int64(-1)


# ------------------------------------------------------------- palette

def quantize(frame: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 RGB -> (palette (n, 3) uint8 with n <= 256,
    indices (H, W) uint8) by median cut, each pixel mapped to its nearest
    palette colour.

    The boxes are cut on the histogram of the colours at BIN_BITS bits a
    channel (each cell weighted by its pixels); a box's colour is the mean
    of the full-precision pixels in its cells."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"a GIF frame is (H, W, 3) uint8, not {frame.dtype} "
                         f"{frame.shape}")
    h, w, _ = frame.shape
    px = frame.reshape(-1, 3).astype(np.int32)
    cell = px >> (8 - BIN_BITS)
    cell_key = (cell[:, 0] << 2 * BIN_BITS) | (cell[:, 1] << BIN_BITS) | \
        cell[:, 2]
    weight = np.bincount(cell_key, minlength=1 << 3 * BIN_BITS)
    cells = np.nonzero(weight)[0]
    if len(cells) <= MAX_COLORS:
        key = (px[:, 0] << 16) | (px[:, 1] << 8) | px[:, 2]
        uniq, inverse = np.unique(key, return_inverse=True)
        if len(uniq) <= MAX_COLORS:
            pal = np.stack([uniq >> 16, (uniq >> 8) & 255, uniq & 255], 1)
            return pal.astype(np.uint8), inverse.reshape(h, w).astype(
                np.uint8)
    coord = np.stack([cells >> 2 * BIN_BITS, (cells >> BIN_BITS) & _CELL,
                      cells & _CELL], axis=1)
    box_of_cell = np.zeros(len(weight), np.uint8)
    box_of_cell[cells], lo, hi = _median_cut(coord, weight[cells])
    box = box_of_cell[cell_key]
    n_px = np.bincount(box, minlength=MAX_COLORS)
    n_box = int(np.count_nonzero(n_px))
    palette = np.stack([np.bincount(box, weights=px[:, c],
                                    minlength=MAX_COLORS)
                        for c in range(3)], axis=1)[:n_box] / \
        n_px[:n_box, None]
    palette = np.clip(np.rint(palette), 0, 255)
    # the colours each box can hold: its cells' extent in full levels
    shift = 8 - BIN_BITS
    extent = (lo << shift, (hi << shift) + (1 << shift) - 1)
    return (palette.astype(np.uint8),
            _nearest(px, box, palette, *extent).reshape(h, w))


def _median_cut(coord: np.ndarray, weight: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Box index of each histogram cell, and each box's lowest and
    highest cell coordinates (n_box, 3): the box holding the most pixels
    (of boxes of more than one cell) is cut along its widest channel at
    its weighted median, until there are MAX_COLORS boxes."""
    tie = itertools.count()
    heap = [(-float(weight.sum()), next(tie), np.arange(len(coord)))]
    done = []
    while heap and len(heap) + len(done) < MAX_COLORS:
        _, _, idx = heapq.heappop(heap)
        c = coord[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        vals = c[:, axis]
        cum = np.cumsum(np.bincount(vals, weights=weight[idx]))
        lo, hi = int(vals.min()), int(vals.max())
        # the weighted median, kept inside [lo, hi) so both halves fill
        cut = min(max(int(np.searchsorted(cum, cum[-1] / 2.0)), lo), hi - 1)
        left = vals <= cut
        for part in (idx[left], idx[~left]):
            if len(part) > 1:
                heapq.heappush(heap, (-float(weight[part].sum()), next(tie),
                                      part))
            else:
                done.append(part)
    boxes = [idx for _, _, idx in heap] + done
    box_of = np.empty(len(coord), np.int64)
    lo = np.empty((len(boxes), 3), np.int64)
    hi = np.empty((len(boxes), 3), np.int64)
    for j, idx in enumerate(boxes):
        box_of[idx] = j
        lo[j] = coord[idx].min(axis=0)
        hi[j] = coord[idx].max(axis=0)
    return box_of, lo, hi


def _nearest(px: np.ndarray, box: np.ndarray, palette: np.ndarray,
             lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Index (uint8) of the nearest palette colour (squared RGB distance)
    of each pixel in px (n, 3), searched from its own box's colour p0: a
    palette colour p can be nearer to c only if |p - p0| <= 2 |c - p0|,
    and |c - p0| is at most the distance from p0 to the farthest corner of
    the box's extent [lo, hi]. Distances are integers below 2^24, so
    exact in float32."""
    pal = palette.astype(np.float32)
    pal_sq = (pal * pal).sum(axis=1)
    between = ((pal[:, None, :] - pal[None, :, :]) ** 2).sum(axis=2)
    reach = 4 * np.maximum((palette - lo) ** 2, (hi - palette) ** 2).sum(1)
    order = np.argsort(box, kind="stable")        # a radix sort of uint8
    bounds = np.cumsum(np.bincount(box, minlength=len(pal)))
    out = np.empty(len(px), np.uint8)
    start = 0
    for j, end in enumerate(bounds):
        sel = order[start:end]
        start = end
        cand = np.nonzero(between[j] <= reach[j])[0]
        if len(cand) == 1:
            out[sel] = j
            continue
        # |c - p|^2 less |c|^2, which is the same for every p
        dist = pal_sq[cand] - 2.0 * (px[sel].astype(np.float32)
                                     @ pal[cand].T)
        out[sel] = cand[np.argmin(dist, axis=1)]
    return out


# ----------------------------------------------------------------- LZW

def _hash_slots(keys: np.ndarray, bits: int) -> np.ndarray:
    mixed = keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return (mixed >> np.uint64(64 - bits)).astype(np.int64)


def _probe(table: np.ndarray, keys: np.ndarray, slots: np.ndarray,
           mask: int) -> tuple[np.ndarray, np.ndarray]:
    """Linear probing from `slots`: each key's slot (or the first empty
    slot on its way) and what that slot holds."""
    while True:
        have = table[slots]
        busy = np.nonzero(((have >> 12) != keys) & (have != _EMPTY))[0]
        if not len(busy):
            return slots, have
        slots[busy] = (slots[busy] + 1) & mask


def _lzw_lanes(data: np.ndarray, lengths: np.ndarray) -> list[np.ndarray]:
    """Greedy LZW (8-bit alphabet) of each row of data (n, L) uint8 over
    its first `lengths[i]` entries, all rows at once; each row's codes,
    starting from a fresh table (the clear code is not included).

    One hash table holds every row's strings: a slot holds
    (row, prefix code, next index) << 12 | code."""
    n, seg = data.shape
    bits = max(4, int(np.ceil(np.log2(max(1, n * seg)))) + 1)
    mask = (1 << bits) - 1
    table = np.full(1 << bits, _EMPTY, np.int64)
    order = np.argsort(-lengths, kind="stable")    # active lanes first
    data, lengths = data[order], lengths[order]
    lane_key = np.arange(n, dtype=np.int64) << 20
    cur = data[:, 0].astype(np.int64)
    nxt = np.full(n, _FIRST, np.int64)
    out = np.zeros((n, seg), np.int32)
    n_out = np.zeros(n, np.int64)
    active = n
    for t in range(1, seg):
        while active and lengths[active - 1] <= t:
            active -= 1
        if not active:
            break
        c = data[:active, t].astype(np.int64)
        cur_a = cur[:active]
        keys = lane_key[:active] | (cur_a << 8) | c
        slots, have = _probe(table, keys, _hash_slots(keys, bits), mask)
        hit = have != _EMPTY
        cur_a[hit] = have[hit] & 4095
        miss = np.nonzero(~hit)[0]
        if not len(miss):
            continue
        out[miss, n_out[miss]] = cur_a[miss]
        n_out[miss] += 1
        # new strings: lanes that found the same empty slot take turns
        entry = (keys[miss] << 12) | nxt[miss]
        mslots = slots[miss]
        while len(entry):
            table[mslots] = entry
            lost = table[mslots] != entry
            entry = entry[lost]
            mslots, _ = _probe(table, entry >> 12, (mslots[lost] + 1) & mask,
                               mask)
        nxt[miss] += 1
        cur_a[miss] = c[miss]
    out[np.arange(n), n_out] = cur
    n_out += 1
    codes = [None] * n
    for row, lane in enumerate(order):
        codes[lane] = out[row, :n_out[row]]
    return codes


def _frame_stream(segments: list[np.ndarray]) -> tuple[np.ndarray,
                                                    np.ndarray]:
    """One frame's codes and their bit widths: each segment after a clear
    code, then the end code. A decoder reads the k-th code after a clear
    (the clear itself is the 0-th of the previous run) at the width of the
    largest code its table may hold then: 258 + max(0, k - 2) entries,
    9 to 12 bits; the first clear at 9."""
    lens = np.array([len(x) for x in segments])
    runs = lens + 1                   # a clear code, then the segment
    start = np.cumsum(runs) - runs
    k = np.arange(runs.sum()) - np.repeat(start, runs)     # 0 at a clear
    codes = np.empty(runs.sum() + 1, np.int64)
    codes[start] = _CLEAR
    codes[:-1][k > 0] = np.concatenate(segments)
    codes[-1] = _EOI
    # the clear of a run and the end code take the width that the
    # previous run's next code would have had
    k_width = np.append(k, lens[-1] + 1)
    k_width[start[1:]] = lens[:-1] + 1
    size = _FIRST + np.maximum(0, k_width - 2)
    widths = np.clip(np.floor(np.log2(size)).astype(np.int64) + 1, 9, 12)
    widths[0] = 9
    return codes, widths


def _pack(codes: np.ndarray, widths: np.ndarray) -> bytes:
    """Codes LSB first, each in its width, as GIF packs them: each code
    lands in one or two 32-bit words."""
    offsets = np.cumsum(widths) - widths
    total = int(offsets[-1] + widths[-1])
    word = offsets >> 5
    v = codes.astype(np.uint64) << (offsets & 31).astype(np.uint64)
    n = int(word[-1]) + 2
    words = (np.bincount(word, weights=(v & np.uint64(0xFFFFFFFF)).astype(
        np.float64), minlength=n) + np.bincount(
        word + 1, weights=(v >> np.uint64(32)).astype(np.float64),
        minlength=n))
    return words.astype("<u4").tobytes()[:-(-total // 8)]


def _sub_blocks(data: bytes) -> bytes:
    """Data as GIF sub-blocks of at most 255 bytes, then a terminator."""
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def lzw_encode(indices: Sequence[np.ndarray]) -> list[bytes]:
    """Each frame's palette indices (uint8, any shape) -> its LZW image
    data (minimum code size 8), as sub-blocks."""
    flat = [np.asarray(x, np.uint8).reshape(-1) for x in indices]
    rows, owner = [], []
    for f, x in enumerate(flat):
        for lo in range(0, len(x), SEGMENT):
            rows.append(x[lo:lo + SEGMENT])
            owner.append(f)
    segs = []
    for lo in range(0, len(rows), LANES):
        group = rows[lo:lo + LANES]
        data = np.zeros((len(group), SEGMENT), np.uint8)
        for i, r in enumerate(group):
            data[i, :len(r)] = r
        segs += _lzw_lanes(data, np.array([len(r) for r in group]))
    per_frame = [[] for _ in flat]
    for f, seg in zip(owner, segs):
        per_frame[f].append(seg)
    return [bytes([8]) + _sub_blocks(_pack(*_frame_stream(s)))
            for s in per_frame]


# ----------------------------------------------------------------- file

def encode_gif(frames: Sequence[np.ndarray], duration_ms: int = 100) -> bytes:
    """Equally sized (H, W, 3) uint8 RGB frames -> GIF89a bytes: each
    frame shown for `duration_ms` (rounded to centiseconds), the whole
    looping forever."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("a GIF needs at least one frame")
    h, w = frames[0].shape[:2]
    if any(f.shape[:2] != (h, w) for f in frames):
        raise ValueError("GIF frames differ in size")
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a GIF frame of {h}x{w} pixels")
    delay = int(round(duration_ms / 10.0))
    quantized = [quantize(f) for f in frames]
    data = lzw_encode([idx for _, idx in quantized])
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\0\0\0"]
    for (palette, _), body in zip(quantized, data):
        table = np.zeros((MAX_COLORS, 3), np.uint8)
        table[:len(palette)] = palette
        out += [b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\0\0",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87),
                table.tobytes(), body]
    out.append(b"\x3b")
    return b"".join(out)


def write_gif(path: str, frames: Sequence[np.ndarray],
              duration_ms: int = 100) -> None:
    with open(path, "wb") as f:
        f.write(encode_gif(frames, duration_ms))
