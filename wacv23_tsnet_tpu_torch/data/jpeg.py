"""Baseline JPEG decoder in numpy, bit for bit as libjpeg-turbo decodes
with its defaults (the port's counterpart of what the JAX package's
datasets take from Pillow's `Image.open` of the dance frames).

What it reads: sequential Huffman-coded files of 8-bit samples (SOF0, and
SOF1 at 8 bits), one or three components, any quantization and Huffman
tables (DQT, DHT, also `optimize`d ones), restart intervals (DRI with
RSTn), interleaved scans or one scan a component. Chroma subsampling
4:4:4, 4:2:2, 4:2:0 and 4:4:0. Progressive, arithmetic-coded, lossless,
12-bit and four-component (CMYK) files raise `ValueError`.

How it matches libjpeg-turbo (`jdhuff.c`, `jidctint.c`, `jdsample.c`,
`jdcolor.c`, `jdmaster.c`), whose SIMD paths give the same bits as its
C code for these steps:

- the integer "islow" IDCT: two 1-D passes in 32-bit fixed point
  (CONST_BITS 13, PASS1_BITS 2) with its rounding, then the post-IDCT
  range-limit table, which wraps values beyond +-384 around (x & 1023);
- fancy upsampling: the triangle filter of `h2v1_fancy_upsample`,
  `h1v2_fancy_upsample` and `h2v2_fancy_upsample` with their biases,
  over the chroma plane with its first and last rows and columns
  replicated (libjpeg's context rows and edge special cases). Planes of
  at most 2 chroma columns are box-upsampled for 4:2:2 and 4:2:0, as
  libjpeg does there;
- YCbCr -> RGB through the fixed-point tables of `build_ycc_rgb_table`
  (SCALEBITS 16), clamped to 0..255.

Entropy decoding is sequential Python, table driven: each Huffman table
becomes a lookup of the next 16 bits that gives the code's length and
symbol and, where they fit in those 16 bits, the coefficient's value
too. The IDCT, the upsampling and the colour conversion run as numpy
over all blocks of a component at once.
"""

from __future__ import annotations

import functools
import re
import struct

import numpy as np

SOI = b"\xff\xd8"
_SOF_BASELINE = (0xC0, 0xC1)
_SOF_OTHER = {0xC2: "progressive", 0xC3: "lossless",
              0xC5: "differential sequential", 0xC6: "differential "
              "progressive", 0xC7: "differential lossless",
              0xC9: "arithmetic-coded sequential",
              0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless",
              0xCD: "arithmetic-coded differential sequential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}

# natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_UNZIG = np.argsort(ZIGZAG)        # zigzag position of natural index

# jidctint.c: FIX(x) at CONST_BITS 13
_CONST_BITS, _PASS1_BITS = 13, 2
_F0_298 = 2446
_F0_390 = 3196
_F0_541 = 4433
_F0_765 = 6270
_F0_899 = 7373
_F1_175 = 9633
_F1_501 = 12299
_F1_847 = 15137
_F1_961 = 16069
_F2_053 = 16819
_F2_562 = 20995
_F3_072 = 25172


def _idct_range_limit() -> np.ndarray:
    """`prepare_range_limit_table`'s post-IDCT part, indexed by x & 1023
    for a descaled IDCT output x: x + 128 clamped to 0..255 for
    -384 <= x < 384, wrapping around beyond."""
    v = np.arange(1024)
    return np.select([v < 128, v < 512, v < 896], [v + 128, 255, 0],
                     v - 896).astype(np.uint8)


_RANGE_LIMIT = _idct_range_limit()

# jdcolor.c build_ycc_rgb_table, SCALEBITS 16
_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix16(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def _ycc_tables():
    """`build_ycc_rgb_table`: Cr -> R and Cb -> B (rounded), and the
    green term of every (cb, cr) pair, indexed by cb << 8 | cr."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix16(1.40200) * x + _ONE_HALF) >> _SCALEBITS
    cb_b = (_fix16(1.77200) * x + _ONE_HALF) >> _SCALEBITS
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + _ONE_HALF
    g = (cb_g[:, None] + cr_g[None, :]) >> _SCALEBITS
    return (cr_r.astype(np.int32), cb_b.astype(np.int32),
            g.reshape(-1).astype(np.int32))


_CR_R, _CB_B, _CBCR_G = _ycc_tables()
# `range_limit` of the colour converter: y + term clamped to 0..255
_CLAMP_OFFSET = 384
_CLAMP = np.clip(np.arange(1024) - _CLAMP_OFFSET, 0, 255).astype(np.uint8)


# ------------------------------------------------------------- markers

_SCAN_END = re.compile(rb"\xff(?![\x00\xd0-\xd7])")
_RST = re.compile(rb"\xff[\xd0-\xd7]")


def _error(name: str, what: str) -> ValueError:
    return ValueError(f"{name}: {what}")


def _segments(data: bytes, name: str):
    """Yield (marker, end of its segment, body) of each marker segment;
    an SOS's entropy-coded data, which follows its segment, is skipped."""
    pos = 2
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            raise _error(name, f"expected a marker at byte {pos}")
        while pos < n and data[pos] == 0xFF:       # fill bytes
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:                         # EOI
            yield marker, pos, b""
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            break
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            break
        yield marker, pos + length, body
        pos += length
        if marker == 0xDA:
            m = _SCAN_END.search(data, pos)
            pos = m.start() if m else n
    raise _error(name, "truncated JPEG file")


def _huffman_table(bits: bytes, values: bytes, is_dc: bool) -> list:
    """The 16-bit lookup of one Huffman table. Entry for a peek of the
    next 16 bits: total length (code plus magnitude bits) in bits 0-4,
    the zero run in bits 5-8, the signed coefficient value from bit 9 up.
    Where the value does not fit in the 16 bits, bits 0-4 are 0 and the
    code's length sits in bits 5-9 and its symbol from bit 10 up; an
    entry that is 0 is no code of the table."""
    counts = list(bits)
    lengths = np.repeat(np.arange(1, 17), counts)
    syms = np.frombuffer(values, np.uint8).astype(np.int64)
    if len(syms) != lengths.size:
        raise ValueError("Huffman table: symbol count mismatch")
    codes = np.zeros(len(syms), np.int64)     # canonical codes (Annex C)
    code, i = 0, 0
    for length, count in enumerate(counts, 1):
        for _ in range(count):
            codes[i] = code
            code += 1
            i += 1
        if code > (1 << length):
            raise ValueError("Huffman table: bad code lengths")
        code <<= 1
    table = np.zeros(1 << 16, np.int64)
    run = np.zeros_like(syms) if is_dc else syms >> 4
    size = syms if is_dc else syms & 15
    for c, ln, r, s, sym in zip(codes, lengths, run, size, syms):
        lo = int(c) << (16 - int(ln))
        span = 1 << (16 - int(ln))
        ln, s = int(ln), int(s)
        if ln + s > 16:
            table[lo:lo + span] = (int(sym) << 10) | (ln << 5)
            continue
        peek = np.arange(span, dtype=np.int64)
        if s:
            mag = (peek >> (16 - ln - s)) & ((1 << s) - 1)
            val = np.where(mag < (1 << (s - 1)), mag - (1 << s) + 1, mag)
        else:
            val = np.zeros(span, np.int64)
        table[lo:lo + span] = (val << 9) | (int(r) << 5) | (ln + s)
    return table.tolist()


@functools.lru_cache(maxsize=64)
def _cached_table(bits: bytes, values: bytes, is_dc: bool) -> list:
    """`_huffman_table`, built once for each table a run meets (frames of
    one encoder share theirs); the list is only read."""
    return _huffman_table(bits, values, is_dc)


# ----------------------------------------------------- entropy decoding



def _windows(segment: bytes) -> list:
    """w[i] = the 24 bits starting at byte i of the de-stuffed segment,
    zero past its end (libjpeg feeds zeros once it meets a marker)."""
    d = np.frombuffer(segment.replace(b"\xff\x00", b"\xff") + b"\0" * 4,
                      np.uint8).astype(np.int64)
    return ((d[:-2] << 16) | (d[1:-1] << 8) | d[2:]).tolist()


def _decode_segment(w: list, slots: list, n_mcus: int, out: list,
                    name: str) -> None:
    """Decode `n_mcus` MCUs of one restart interval. `slots` lists each
    block of an MCU as (scan component, DC table, AC table); `out[c]` is
    [DC differences, AC positions, AC values] of component c, to which
    each decoded block appends its DC difference and, for each non-zero
    AC coefficient, its position (block number * 64 + zigzag index) and
    value."""
    p = 0
    for _ in range(n_mcus):
        for c, dct, act in slots:
            dcs, pos, vals = out[c]
            base = len(dcs) << 6
            e = dct[(w[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
            n = e & 31
            if n:
                p += n
                dcs.append(e >> 9)
            else:
                if not e:
                    raise _error(name, "bad Huffman code")
                p += (e >> 5) & 31
                s = e >> 10
                v = (w[p >> 3] >> (24 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                dcs.append(v if v >> (s - 1) else v - (1 << s) + 1)
            k = 1
            while k < 64:
                e = act[(w[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
                n = e & 31
                if n:
                    p += n
                    v = e >> 9
                    if v:
                        k += (e >> 5) & 15
                        if k > 63:
                            raise _error(name, "AC run past the block")
                        pos.append(base + k)
                        vals.append(v)
                        k += 1
                    elif (e >> 5) & 15 == 15:
                        k += 16
                    else:
                        break
                else:
                    if not e:
                        raise _error(name, "bad Huffman code")
                    p += (e >> 5) & 31
                    sym = e >> 10
                    s = sym & 15
                    if s:
                        k += sym >> 4
                        if k > 63:
                            raise _error(name, "AC run past the block")
                        v = (w[p >> 3] >> (24 - (p & 7) - s)) & ((1 << s) - 1)
                        p += s
                        pos.append(base + k)
                        vals.append(v if v >> (s - 1) else v - (1 << s) + 1)
                        k += 1
                    elif sym >> 4 == 15:
                        k += 16
                    else:
                        break
    if (p + 7) >> 3 > len(w) - 2:
        raise _error(name, "entropy-coded data ends early")


# ---------------------------------------------------------------- IDCT

def _idct_pass(x0, x1, x2, x3, x4, x5, x6, x7, shift: int, left: int):
    """One 1-D pass of `jpeg_idct_islow` on int64 arrays (inputs already
    dequantized, or the first pass's work values); returns the 8 outputs
    descaled by `shift` bits. `left` is the shift of the DC/4 terms
    (CONST_BITS in both passes)."""
    z1 = (x2 + x6) * _F0_541
    tmp2 = z1 + x6 * -_F1_847
    tmp3 = z1 + x2 * _F0_765
    tmp0 = (x0 + x4) << left
    tmp1 = (x0 - x4) << left
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = x7, x5, x3, x1
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * _F1_175
    t0 = t0 * _F0_298
    t1 = t1 * _F2_053
    t2 = t2 * _F3_072
    t3 = t3 * _F1_501
    z1 = z1 * -_F0_899
    z2 = z2 * -_F2_562
    z3 = z3 * -_F1_961 + z5
    z4 = z4 * -_F0_390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    half = 1 << (shift - 1)
    return [(tmp10 + t3 + half) >> shift, (tmp11 + t2 + half) >> shift,
            (tmp12 + t1 + half) >> shift, (tmp13 + t0 + half) >> shift,
            (tmp13 - t0 + half) >> shift, (tmp12 - t1 + half) >> shift,
            (tmp11 - t2 + half) >> shift, (tmp10 - t3 + half) >> shift]


def idct_islow(coef: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantized coefficients (natural order, [row, col]) ->
    (N, 8, 8) uint8 samples, as libjpeg's `jpeg_idct_islow`: columns
    first into a work array descaled by CONST_BITS - PASS1_BITS, then
    rows descaled by CONST_BITS + PASS1_BITS + 3, through the range-limit
    table. (Its shortcut for all-zero AC terms gives the same values.)"""
    c = coef.astype(np.int64)
    ws = _idct_pass(*(c[:, u, :] for u in range(8)),
                    shift=_CONST_BITS - _PASS1_BITS, left=_CONST_BITS)
    ws = np.stack(ws, axis=1)                    # (N, row, col)
    out = _idct_pass(*(ws[:, :, u] for u in range(8)),
                     shift=_CONST_BITS + _PASS1_BITS + 3, left=_CONST_BITS)
    out = np.stack(out, axis=2)                  # (N, row, col)
    return _RANGE_LIMIT[out & 1023]


# ----------------------------------------------------------- upsampling

def _fancy_h2(x: np.ndarray) -> np.ndarray:
    """`h2v1_fancy_upsample` along the last axis: each sample splits into
    (3 this + previous + 1) >> 2 and (3 this + next + 2) >> 2, the ends
    replicated."""
    v = x.astype(np.int32)
    prev = np.concatenate([v[..., :1], v[..., :-1]], axis=-1)
    nxt = np.concatenate([v[..., 1:], v[..., -1:]], axis=-1)
    out = np.empty(v.shape[:-1] + (2 * v.shape[-1],), np.int32)
    out[..., 0::2] = (3 * v + prev + 1) >> 2
    out[..., 1::2] = (3 * v + nxt + 2) >> 2
    return out.astype(np.uint8)


def _fancy_v2(x: np.ndarray) -> np.ndarray:
    """`h1v2_fancy_upsample`: each row splits into (3 this + above + 1)
    >> 2 and (3 this + below + 2) >> 2, the first and last rows
    replicated."""
    v = x.astype(np.int32)
    above = np.concatenate([v[:1], v[:-1]])
    below = np.concatenate([v[1:], v[-1:]])
    out = np.empty((2 * v.shape[0],) + v.shape[1:], np.int32)
    out[0::2] = (3 * v + above + 1) >> 2
    out[1::2] = (3 * v + below + 2) >> 2
    return out.astype(np.uint8)


def _fancy_h2v2(x: np.ndarray) -> np.ndarray:
    """`h2v2_fancy_upsample`: vertical sums 3 this + nearer neighbour row
    (above for the upper output row, below for the lower), then along
    each row (3 this + previous + 8) >> 4 and (3 this + next + 7) >> 4;
    first and last rows and columns replicated."""
    v = x.astype(np.int32)
    above = np.concatenate([v[:1], v[:-1]])
    below = np.concatenate([v[1:], v[-1:]])
    h, w = v.shape
    out = np.empty((2 * h, 2 * w), np.int32)
    for r, colsum in ((0, 3 * v + above), (1, 3 * v + below)):
        prev = np.concatenate([colsum[:, :1], colsum[:, :-1]], axis=1)
        nxt = np.concatenate([colsum[:, 1:], colsum[:, -1:]], axis=1)
        out[r::2, 0::2] = (3 * colsum + prev + 8) >> 4
        out[r::2, 1::2] = (3 * colsum + nxt + 7) >> 4
    return out.astype(np.uint8)


def _upsample(plane: np.ndarray, fh: int, fv: int, name: str) -> np.ndarray:
    """A chroma plane (its downsampled size) upsampled by (fh, fv) as
    libjpeg-turbo's `jinit_upsampler` chooses with fancy upsampling on."""
    if (fh, fv) == (1, 1):
        return plane
    if (fh, fv) == (1, 2):
        return _fancy_v2(plane)
    if (fh, fv) in ((2, 1), (2, 2)):
        if plane.shape[1] > 2:
            return _fancy_h2(plane) if fv == 1 else _fancy_h2v2(plane)
        return np.repeat(np.repeat(plane, fh, axis=1), fv, axis=0)
    raise _error(name, f"chroma subsampling {fh}x{fv} is not supported "
                       "(4:4:4, 4:2:2, 4:2:0 and 4:4:0 only)")


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """`ycc_rgb_convert` of uint8 planes -> (H, W, 3) uint8 RGB."""
    out = np.empty(y.shape + (3,), np.uint8)
    yi = y.astype(np.int32) + _CLAMP_OFFSET
    out[..., 0] = _CLAMP[yi + _CR_R[cr]]
    out[..., 1] = _CLAMP[yi + _CBCR_G[(cb.astype(np.int32) << 8) | cr]]
    out[..., 2] = _CLAMP[yi + _CB_B[cb]]
    return out


# ------------------------------------------------------------- decoding

def jpeg_size(data: bytes, name: str = "JPEG") -> tuple[int, int]:
    """(width, height) from a JPEG's frame header, decoding nothing."""
    if data[:2] != SOI:
        raise _error(name, "not a JPEG file")
    for marker, _, body in _segments(data, name):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            _, h, w = struct.unpack(">BHH", body[:5])
            return w, h
        if marker == 0xDA:
            break
    raise _error(name, "no frame header")


def decode_jpeg(data: bytes, name: str = "JPEG") -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, or (H, W, 1) for a grayscale
    file. `name` (the file's) goes into every error."""
    if data[:2] != SOI:
        raise _error(name, "not a JPEG file")
    qt, huff = {}, {}
    frame, restart = None, 0
    adobe_transform, jfif = None, False
    coefs = None
    for marker, end, body in _segments(data, name):
        if marker == 0xDB:                                   # DQT
            pos = 0
            while pos < len(body):
                pq, tq = body[pos] >> 4, body[pos] & 15
                if pq:
                    raise _error(name, "16-bit quantization tables "
                                       "(12-bit JPEG) are not supported")
                qt[tq] = np.frombuffer(body[pos + 1:pos + 65], np.uint8
                                       ).astype(np.int64)[_UNZIG]
                pos += 65
        elif marker == 0xC4:                                 # DHT
            pos = 0
            while pos < len(body):
                tc, th = body[pos] >> 4, body[pos] & 15
                bits = body[pos + 1:pos + 17]
                n = sum(bits)
                huff[(tc, th)] = _cached_table(
                    bytes(bits), bytes(body[pos + 17:pos + 17 + n]), tc == 0)
                pos += 17 + n
        elif marker == 0xDD:                                 # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker in _SOF_BASELINE:
            precision, h, w, nc = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise _error(name, f"{precision}-bit JPEG is not supported")
            if nc not in (1, 3):
                raise _error(name, f"{nc}-component JPEG (CMYK or other) "
                                   "is not supported")
            if h == 0 or w == 0:
                raise _error(name, "JPEG with a zero size (DNL) is not "
                                   "supported")
            comps = []
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq})
            frame = (w, h, comps)
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcus_x = -(-w // (8 * hmax))
            mcus_y = -(-h // (8 * vmax))
            coefs = [None] * nc
        elif marker in _SOF_OTHER:
            raise _error(name, f"{_SOF_OTHER[marker]} JPEG is not supported")
        elif marker == 0xDA:                                 # SOS
            if frame is None:
                raise _error(name, "scan before the frame header")
            _decode_scan(data, end, body, frame, huff, restart, coefs,
                         (mcus_x, mcus_y, hmax, vmax), name)
        elif marker == 0xD9:
            break
    if frame is None or any(c is None for c in coefs):
        raise _error(name, "no complete baseline scan")
    w, h, comps = frame
    planes = []
    for c, blocks in zip(comps, coefs):
        if c["tq"] not in qt:
            raise _error(name, f"missing quantization table {c['tq']}")
        rows, cols = blocks.shape[:2]
        nat = blocks.reshape(-1, 64)[:, _UNZIG] * qt[c["tq"]]
        pix = idct_islow(nat.reshape(-1, 8, 8)).reshape(rows, cols, 8, 8)
        pix = pix.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        cw = -(-w * c["h"] // hmax)
        ch = -(-h * c["v"] // vmax)
        pix = pix[:ch, :cw]
        pix = _upsample(pix, hmax // c["h"], vmax // c["v"], name)
        if hmax % c["h"] or vmax % c["v"]:
            raise _error(name, "unsupported sampling factors")
        planes.append(pix[:h, :w])
    if len(planes) == 1:
        return planes[0][..., None]
    ids = [c["id"] for c in comps]
    if jfif:
        rgb = False
    elif adobe_transform is not None:
        rgb = adobe_transform == 0
    else:
        rgb = ids == [82, 71, 66]
    if rgb:
        return np.stack(planes, axis=-1)
    return ycc_to_rgb(*planes)


def _decode_scan(data: bytes, start: int, sos: bytes, frame, huff: dict,
                 restart: int, coefs: list, grid, name: str) -> None:
    """Decode one baseline scan starting at byte `start` into `coefs`
    (per component, (block rows, block cols, 64) zigzag order, DC
    undifferenced)."""
    w, h, comps = frame
    mcus_x, mcus_y, hmax, vmax = grid
    ns = sos[0]
    ss, se, ahal = sos[1 + 2 * ns:4 + 2 * ns]
    if (ss, se, ahal) != (0, 63, 0):
        raise _error(name, "progressive scan in a baseline file")
    ids = [c["id"] for c in comps]
    slots, members = [], []
    for i in range(ns):
        cid, tables = sos[1 + 2 * i], sos[2 + 2 * i]
        if cid not in ids:
            raise _error(name, f"scan names unknown component {cid}")
        ci = ids.index(cid)
        dc, ac = huff.get((0, tables >> 4)), huff.get((1, tables & 15))
        if dc is None or ac is None:
            raise _error(name, "scan uses an undefined Huffman table")
        members.append(ci)
        reps = 1 if ns == 1 else comps[ci]["h"] * comps[ci]["v"]
        slots += [(i, dc, ac)] * reps
    if ns == 1:
        c = comps[members[0]]
        cols = -(-(-(-w * c["h"] // hmax)) // 8)
        rows = -(-(-(-h * c["v"] // vmax)) // 8)
        n_total = rows * cols
    else:
        n_total = mcus_x * mcus_y
    m = _SCAN_END.search(data, start)
    scan = data[start:m.start() if m else len(data)]
    parts = _RST.split(scan) if restart else [scan]
    out = [([], [], []) for _ in range(ns)]
    done = 0
    for part in parts:
        n = min(restart or n_total, n_total - done)
        if n <= 0:
            break
        _decode_segment(_windows(part), slots, n, out, name)
        done += n
    if done < n_total:
        raise _error(name, f"scan ends after {done} of {n_total} MCUs")
    for i, ci in enumerate(members):
        dcs, pos, vals = out[i]
        c = comps[ci]
        blk = np.zeros((len(dcs), 64), np.int64)
        blk.reshape(-1)[np.asarray(pos, np.int64)] = vals
        # DC: differences from the previous block's, reset at restarts
        per = (restart or n_total) * (1 if ns == 1 else c["h"] * c["v"])
        cum = np.cumsum(np.asarray(dcs, np.int64))
        start = np.arange(cum.size) // per * per
        blk[:, 0] = cum - np.concatenate([[0], cum])[start]
        if ns == 1:
            full = np.zeros((mcus_y * c["v"], mcus_x * c["h"], 64),
                            np.int64)
            full[:rows, :cols] = blk.reshape(rows, cols, 64)
        else:
            full = blk.reshape(mcus_y, mcus_x, c["v"], c["h"], 64).transpose(
                0, 2, 1, 3, 4).reshape(mcus_y * c["v"], mcus_x * c["h"], 64)
        coefs[ci] = full
