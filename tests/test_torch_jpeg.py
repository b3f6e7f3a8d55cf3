"""The port's JPEG decoder and nearest resize / square pad against Pillow
(CPU), bit for bit.

Files are written by Pillow (libjpeg-turbo) in each of its chroma
subsamplings, with `optimize` tables and restart intervals, and by
OpenCV for 4:4:0 (Pillow does not write it); each is decoded by Pillow
and by `data.jpeg.decode_jpeg`, which must agree on every byte. The
committed fixtures under tests/torch_fixtures/jpeg/ are held against
their manifest (the sha256 of Pillow's decode), which is what
chip_smoke.py, which needs no Pillow, holds the decoder to. `pytest -s`
prints the decode times.
"""

import hashlib
import io
import json
import os
import time

import cv2
import numpy as np
import pytest
from PIL import Image, ImageOps, features

from wacv23_tsnet_tpu_torch.data import image_io, jpeg

FIXTURES = os.path.join(os.path.dirname(__file__), "torch_fixtures", "jpeg")
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def _frame(h, w, seed, channels=3):
    """Ramps plus Gaussian noise of sigma 8 (a stand-in for a frame)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    ramp = np.stack([xx * 255 // max(w, 1), yy * 255 // max(h, 1),
                     (xx + yy) % 256], axis=-1)[..., :channels]
    return np.clip(ramp + rng.normal(0, 8, ramp.shape), 0,
                   255).astype(np.uint8)


def _pillow_jpeg(img, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img.squeeze(-1) if img.shape[-1] == 1 else img).save(
        buf, "JPEG", **options)
    return buf.getvalue()


def _check(data: bytes, tag: str):
    want = np.asarray(Image.open(io.BytesIO(data)))
    if want.ndim == 2:
        want = want[..., None]
    t0 = time.perf_counter()
    got = jpeg.decode_jpeg(data, name=tag)
    ms = 1e3 * (time.perf_counter() - t0)
    print(f"[jpeg] {tag}: {got.shape} {len(data)} bytes {ms:.1f} ms")
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_pillow_has_libjpeg_turbo():
    """The reference decoder is libjpeg-turbo (3.1.3 with Pillow 12.1)."""
    assert features.check_feature("libjpeg_turbo")


@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("hw", [(1, 1), (9, 17), (511, 289)],
                         ids=["1x1", "17x9", "289x511"])
def test_decode_matches_pillow(hw, sub, quality):
    img = _frame(*hw, seed=hw[1] + quality)
    _check(_pillow_jpeg(img, quality=quality,
                        subsampling=SUBSAMPLING[sub]),
           f"{hw[1]}x{hw[0]} {sub} q{quality}")


@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("hw", [(1, 1), (9, 17), (511, 289)],
                         ids=["1x1", "17x9", "289x511"])
def test_decode_gray_and_440(hw, quality):
    """Grayscale (Pillow) and 4:4:0 (OpenCV: Pillow writes no 4:4:0)."""
    _check(_pillow_jpeg(_frame(*hw, seed=1, channels=1), quality=quality),
           f"{hw[1]}x{hw[0]} gray q{quality}")
    ok, buf = cv2.imencode(".jpg", _frame(*hw, seed=2), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
        cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    data = buf.tobytes()
    sof = data.find(b"\xff\xc0")
    assert data[sof + 11] == 0x12          # luma 1x2: 4:4:0
    _check(data, f"{hw[1]}x{hw[0]} 440 q{quality}")


@pytest.mark.parametrize("hw", [(3, 4), (2, 3), (5, 2), (16, 16), (24, 40)])
@pytest.mark.parametrize("sub", ["420", "422"])
def test_decode_narrow_chroma(hw, sub):
    """Chroma planes of 1-3 columns: libjpeg box-upsamples 4:2:x planes
    of at most 2 columns and filters wider ones."""
    _check(_pillow_jpeg(_frame(*hw, seed=3), quality=90,
                        subsampling=SUBSAMPLING[sub]),
           f"{hw[1]}x{hw[0]} {sub}")


@pytest.mark.parametrize("options", [
    dict(optimize=True, quality=75),
    dict(optimize=True, quality=95, subsampling=0),
    dict(restart_marker_blocks=5, quality=95, subsampling=0),
    dict(restart_marker_rows=1, quality=75, subsampling=2),
    dict(restart_marker_blocks=1, optimize=True, quality=50),
], ids=["optimize", "optimize_444", "restart_blocks", "restart_rows",
        "restart_every_mcu_optimize"])
def test_decode_tables_and_restarts(options):
    data = _pillow_jpeg(_frame(511, 289, seed=4), **options)
    if "restart_marker_blocks" in options or "restart_marker_rows" in options:
        assert b"\xff\xdd" in data[:data.find(b"\xff\xda")]
    _check(data, str(options))


def test_decode_dense_coefficients():
    """Pure noise at quality 100: long codes, and values whose magnitude
    bits do not fit in the 16-bit lookup with their code."""
    img = np.random.default_rng(6).integers(0, 256, (64, 48, 3), np.uint8)
    _check(_pillow_jpeg(img, quality=100, subsampling=0), "noise q100")


@pytest.mark.parametrize("mode", ["progressive", "cmyk"])
def test_refuses_unsupported(mode, tmp_path):
    img = _frame(32, 24, seed=5)
    if mode == "progressive":
        data = _pillow_jpeg(img, progressive=True)
    else:
        buf = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(buf, "JPEG")
        data = buf.getvalue()
    path = tmp_path / f"{mode}.jpg"
    path.write_bytes(data)
    what = {"progressive": "progressive", "cmyk": "CMYK"}[mode]
    with pytest.raises(ValueError, match=f"{path.name}.*{what}"):
        image_io.read_rgb(str(path))


def test_refuses_twelve_bit_and_arithmetic():
    """Hand-edited frame headers: 12-bit precision, arithmetic coding."""
    data = bytearray(_pillow_jpeg(_frame(16, 16, seed=7)))
    sof = data.find(b"\xff\xc0")
    twelve = bytearray(data)
    twelve[sof + 4] = 12
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.decode_jpeg(bytes(twelve), name="twelve.jpg")
    arith = bytearray(data)
    arith[sof + 1] = 0xC9
    with pytest.raises(ValueError, match="arithmetic-coded"):
        jpeg.decode_jpeg(bytes(arith), name="arith.jpg")
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG", name="x")


def test_fixtures_match_manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["libjpeg_turbo"] == features.version_feature(
        "libjpeg_turbo")
    total = 0
    for name, entry in manifest["files"].items():
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        assert os.path.getsize(path) <= 64 * 1024
        want = np.asarray(Image.open(path).convert("RGB"))
        got = image_io.read_rgb(path)
        assert hashlib.sha256(want.tobytes()).hexdigest() \
            == entry["sha256_rgb"]
        assert hashlib.sha256(got.tobytes()).hexdigest() \
            == entry["sha256_rgb"], name
        assert image_io.image_size(path) == tuple(entry["size"])
    assert len(manifest["files"]) == 5 and total <= 256 * 1024


def test_read_rgb_dispatch(tmp_path):
    """PNG and JPEG by signature, gray repeated to RGB; others refused."""
    img = _frame(20, 30, seed=8)
    png = tmp_path / "a.jpg"                 # a PNG despite its name
    image_io.write_png(str(png), img)
    np.testing.assert_array_equal(image_io.read_rgb(str(png)), img)
    assert image_io.image_size(str(png)) == (30, 20)
    gray = tmp_path / "g.jpg"
    gray.write_bytes(_pillow_jpeg(_frame(20, 30, 9, channels=1)))
    want = np.asarray(Image.open(gray).convert("RGB"))
    np.testing.assert_array_equal(image_io.read_rgb(str(gray)), want)
    other = tmp_path / "x.gif"
    other.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        image_io.read_rgb(str(other))


@pytest.mark.parametrize("size", [(128, 256), (129, 255), (7, 3), (400, 999),
                                  (1, 1)])
@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_resize_nearest_matches_pillow(size, mode):
    rng = np.random.default_rng(size[0])
    for h, w in ((511, 289), (257, 129), (17, 9), (3, 7)):
        shape = (h, w, 3) if mode == "RGB" else (h, w)
        img = rng.integers(0, 256, shape, np.uint8)
        want = np.asarray(Image.fromarray(img).resize(size, Image.NEAREST))
        np.testing.assert_array_equal(image_io.resize_nearest(img, size),
                                      want)


@pytest.mark.parametrize("hw", [(256, 128), (128, 256), (7, 4), (4, 7),
                                (5, 5)])
def test_pad_square_matches_pillow(hw):
    h, w = hw
    s = max(h, w)
    for shape in ((h, w, 3), (h, w)):
        img = np.random.default_rng(h).integers(1, 256, shape, np.uint8)
        want = np.asarray(ImageOps.expand(Image.fromarray(img), (
            (s - w) // 2, (s - h) // 2, s - w - (s - w) // 2,
            s - h - (s - h) // 2)))
        np.testing.assert_array_equal(image_io.pad_square(img), want)
