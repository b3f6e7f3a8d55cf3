"""The port's face data pipeline against Pillow, OpenCV and the JAX
package's datasets (CPU).

The port reads PNG frames with its own codec and reproduces Pillow's
bicubic frame resize and ImageEnhance jitter and OpenCV's float mask
resize in numpy; each is held here against the library it replaces, bit
for bit, and the whole `FaceDatasetTrain` against the JAX package's on
one synthetic dataset. The JAX package's `draw_edge` takes its native
C++ fast path where a compiler exists; that path's rounding follows its
build flags, so the JAX reference here runs its numpy tier
(`interp_curve` + `stamp_edge`, which the native path is held to in
tests/test_native.py). `pytest -s` prints each measured difference.
"""

import io
import os
import random
import struct
import time
import zlib

import numpy as np
import pytest
from PIL import Image

import wacv23_tsnet_tpu.data.face as j_face
from wacv23_tsnet_tpu.data import augment as j_augment
from wacv23_tsnet_tpu.data import rasterize as j_ras
from wacv23_tsnet_tpu.data.datasets import FaceDatasetTrain as JFaceDataset
from wacv23_tsnet_tpu.data.datasets import _resize_bool
from wacv23_tsnet_tpu.data.loader import Loader as JLoader
from wacv23_tsnet_tpu_torch.data import augment, face, image_io, rasterize
from wacv23_tsnet_tpu_torch.data.datasets import FaceDatasetTrain
from wacv23_tsnet_tpu_torch.data.loader import Loader, collate

RNG = np.random.default_rng(21)


def _report(**values):
    name = os.environ.get("PYTEST_CURRENT_TEST", "").split()[0]
    print(f"[data] {name}: " + " ".join(f"{k}={v}" for k, v in
                                        values.items()))


def _jax_numpy_draw_edge(img, x, y, bw=1, color=(255, 255, 255),
                         endpoints=False):
    cx, cy = j_ras.interp_curve(x, y)
    j_ras.stamp_edge(img, cx, cy, bw=bw, color=color, endpoints=endpoints)


@pytest.fixture
def jax_numpy_tier(monkeypatch):
    monkeypatch.setattr(j_face, "draw_edge", _jax_numpy_draw_edge)
    monkeypatch.setenv("TSNET_NATIVE", "0")


def _test_image(h, w, c, kind):
    yy, xx = np.mgrid[:h, :w]
    ramp = (yy * 3 + xx * 5)[..., None] + np.arange(c) * 40
    noise = RNG.integers(0, 256, (h, w, c))
    img = {"noise": noise, "ramp": ramp, "mixed": ramp + noise // 16}[kind]
    return (img % 256).astype(np.uint8)


def _png_filter_types(data):
    """The row filter bytes of a PNG file."""
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, _, color = hdr[:4]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    bpp = {0: 1, 2: 3, 6: 4}[color]
    return set(raw.reshape(h, 1 + w * bpp)[:, 0].tolist())


def _refilter(data, types):
    """The PNG `data` with row r re-encoded under filter types[r % 5]
    (the spec's five filters, in plain Python)."""
    img = image_io.decode_png(data)
    h, w, bpp = img.shape
    x = img.reshape(h, w * bpp).astype(int)
    rows = []
    for r in range(h):
        t = types[r % len(types)]
        out = [t]
        for i in range(w * bpp):
            a = x[r, i - bpp] if i >= bpp else 0
            b = x[r - 1, i] if r else 0
            c = x[r - 1, i - bpp] if r and i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[t]
            out.append((x[r, i] - pred) % 256)
        rows.append(bytes(out))
    body = zlib.compress(b"".join(rows))
    idat = struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(
        ">I", zlib.crc32(b"IDAT" + body))
    end = data.index(b"IEND") - 4
    start = data.index(b"IDAT") - 4
    return data[:start] + idat + data[end:]


def test_png_codec_matches_pillow():
    """Pillow's files decode to Pillow's pixels and the port's files to
    the array written, in gray, RGB and RGBA, across odd widths and all
    five row filters (Pillow writes None, Sub, Up and Paeth; each file is
    also rewritten with the five filters in turn, Average included, and
    decoded by Pillow and the port)."""
    filters = set()
    for mode, c in (("L", 1), ("RGB", 3), ("RGBA", 4)):
        for w in (1, 7, 33, 64):
            for kind in ("noise", "ramp", "mixed"):
                arr = _test_image(int(RNG.integers(1, 40)), w, c, kind)
                pil = Image.fromarray(arr[..., 0] if c == 1 else arr, mode)
                buf = io.BytesIO()
                pil.save(buf, format="PNG")
                filters |= _png_filter_types(buf.getvalue())
                got = image_io.decode_png(buf.getvalue())
                np.testing.assert_array_equal(got, arr)
                mixed = _refilter(buf.getvalue(), [3, 4, 1, 0, 2])
                filters |= _png_filter_types(mixed)
                want = np.asarray(Image.open(io.BytesIO(mixed)))
                np.testing.assert_array_equal(
                    image_io.decode_png(mixed).reshape(want.shape), want)
                np.testing.assert_array_equal(want.reshape(arr.shape), arr)
                back = Image.open(io.BytesIO(image_io.encode_png(arr)))
                assert back.mode == mode
                np.testing.assert_array_equal(
                    np.asarray(back).reshape(arr.shape), arr)
    _report(filters=sorted(filters))
    assert filters == {0, 1, 2, 3, 4}


def test_read_rgb_matches_pillow_convert(tmp_path):
    for mode, c in (("L", 1), ("RGB", 3), ("RGBA", 4)):
        arr = _test_image(9, 11, c, "mixed")
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(path)
        np.testing.assert_array_equal(
            image_io.read_rgb(path), np.asarray(Image.open(path).convert("RGB")))


def test_png_decoder_refusals():
    arr = _test_image(8, 8, 3, "noise")
    jpeg, png16 = io.BytesIO(), io.BytesIO()
    Image.fromarray(arr).save(jpeg, format="JPEG")
    Image.fromarray(arr[..., 0].astype(np.uint16) * 200).save(
        png16, format="PNG")
    with pytest.raises(ValueError, match="PNG frames only"):
        image_io.decode_png(jpeg.getvalue())
    with pytest.raises(ValueError, match="bit depth 16"):
        image_io.decode_png(png16.getvalue())
    bad = bytearray(image_io.encode_png(arr))
    bad[40] ^= 0xFF                       # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        image_io.decode_png(bytes(bad))


@pytest.mark.parametrize("src, dst", [
    ((192, 150), (256, 256)),     # grow both
    ((400, 333), (256, 256)),     # shrink both
    ((300, 200), (256, 256)),     # shrink one, grow the other
    ((256, 97), (256, 64)),       # one axis unchanged
    ((31, 517), (8, 129)),
])
def test_frame_resize_matches_pillow(src, dst):
    """Pillow's default `Image.resize` (bicubic, fixed point), bit-equal
    on noise and on smooth content."""
    h, w = src
    for kind in ("noise", "ramp"):
        arr = _test_image(h, w, 3, kind)
        want = np.asarray(Image.fromarray(arr).resize(dst))
        got = image_io.resize_frame(arr, dst)
        diff = np.abs(got.astype(int) - want)
        _report(kind=kind, max_diff=diff.max(), n_diff=(diff > 0).sum())
        assert got.shape == want.shape and diff.max() == 0


def test_mask_resize_matches_resize_bool():
    """`_resize_bool` (OpenCV area / bilinear + 0.5 threshold), equal, on
    strokes and blocks, through every OpenCV branch: integer-factor
    area, fractional area, bilinear, and the bilinear stand-in of area
    for a growing height."""
    shapes = [((512, 512), (256, 256)), ((384, 256), (128, 128)),
              ((301, 277), (256, 256)), ((150, 140), (256, 256)),
              ((120, 300), (256, 256)), ((300, 120), (256, 256)),
              ((97, 61), (64, 64))]
    for (h, w), size in shapes:
        for _ in range(4):
            m = np.zeros((h, w), np.uint8)
            for _ in range(6):
                y0, x0 = RNG.integers(0, h), RNG.integers(0, w)
                m[y0:y0 + RNG.integers(1, 40), x0:x0 + RNG.integers(1, 40)] = 255
            kp = RNG.uniform(0, min(h, w), (68, 2))
            m |= face.render_face_edges(kp, (w, h), bw=1)
            np.testing.assert_array_equal(image_io.resize_mask(m, size),
                                          _resize_bool(m, size))


def test_crop_and_mirror_match_pillow():
    arr = _test_image(40, 30, 3, "noise")
    pil = Image.fromarray(arr)
    for coords in ([5, 25, 3, 20], [-7, 33, -4, 41], [30, 60, 20, 50]):
        min_y, max_y, min_x, max_x = coords
        want = np.asarray(pil.crop((min_x, min_y, max_x, max_y)))
        np.testing.assert_array_equal(image_io.crop(arr, coords), want)
    from PIL import ImageOps
    np.testing.assert_array_equal(image_io.mirror(arr),
                                  np.asarray(ImageOps.mirror(pil)))


def test_jitter_matches_pillow_enhance():
    """`apply_jitter` with the same factors (the same draws from one
    seeded rng) as the JAX package's ImageEnhance + HSV jitter; also at
    extrapolating factors and on grey pixels."""
    worst = 0
    for t in range(24):
        h, w = RNG.integers(1, 64, 2)
        img = _test_image(int(h), int(w), 3, "noise" if t % 2 else "mixed")
        if t % 3 == 0:
            img[..., 1] = img[..., 0]
        if t % 4 == 0:
            img[:] = img[..., :1]
        f = j_augment.sample_jitter_factors(random.Random(t))
        assert augment.sample_jitter_factors(random.Random(t)) == f
        if t % 5 == 0:
            f.update(brightness=1.25, contrast=0.7, saturation=1.2, hue=-0.04)
        want = np.asarray(j_augment.apply_jitter(Image.fromarray(img), f))
        got = augment.apply_jitter(img, f)
        worst = max(worst, int(np.abs(got.astype(int) - want).max()))
    _report(max_level_diff=worst)
    assert worst <= 1


def _face_landmarks(cx, cy, r):
    """A plausible 68-point layout (ellipse jaw + feature clusters), as
    tests/test_train_loop.py draws it."""
    t = np.linspace(np.pi * 0.1, np.pi * 0.9, 17)
    jaw = np.stack([cx + r * np.cos(t + np.pi / 2) * 1.2,
                    cy + r * np.sin(t)], 1)
    rest = RNG.uniform(-r * 0.5, r * 0.5, (51, 2)) + [cx, cy - r * 0.2]
    return np.concatenate([jaw, rest])


def test_face_helpers_match_jax(jax_numpy_tier):
    for k in range(8):
        kp = _face_landmarks(100 + 7 * k, 90 - 3 * k, 30 + 5 * k)
        for jitter in (False, True):
            want, ws = j_face.face_crop_coords(kp, jitter=jitter,
                                               rng=random.Random(k))
            got, gs = face.face_crop_coords(kp, jitter=jitter,
                                            rng=random.Random(k))
            assert (got, gs) == (want, ws)
        shifted = face.shift_keypoints(kp, got)
        np.testing.assert_array_equal(shifted,
                                      j_face.shift_keypoints(kp, got))
        size = (got[3] - got[2], got[1] - got[0])
        for bw in (1, 2):
            np.testing.assert_array_equal(
                face.render_face_edges(shifted, size, bw=bw),
                j_face.render_face_edges(shifted, size, bw=bw))
        np.testing.assert_array_equal(face.face_bbox_mask(shifted, size),
                                      j_face.face_bbox_mask(shifted, size))
        x, y = kp[:3, 0], kp[:3, 1]
        for a, b in zip(rasterize.interp_curve(x, y),
                        j_ras.interp_curve(x, y)):
            np.testing.assert_array_equal(a, b)
        img_a = np.zeros((200, 220, 3), np.uint8)
        img_b = img_a.copy()
        rasterize.draw_edge(img_a, x, y, bw=2, color=(9, 99, 199),
                            endpoints=True)
        _jax_numpy_draw_edge(img_b, x, y, bw=2, color=(9, 99, 199),
                             endpoints=True)
        np.testing.assert_array_equal(img_a, img_b)


@pytest.fixture(scope="module")
def face_dataset(tmp_path_factory):
    """3 videos x 6 frames of 192x192 noise (written by Pillow, so every
    PNG row filter occurs) with synthetic landmarks, the third face large
    enough that its crop shrinks to 64x64."""
    root = tmp_path_factory.mktemp("faces")
    for vid in range(3):
        (root / "labels" / f"vid{vid}").mkdir(parents=True)
        (root / "images" / f"vid{vid}").mkdir(parents=True)
        for f in range(6):
            kp = _face_landmarks(100 + 5 * f, 90 + 3 * vid, 20 + 25 * vid)
            np.savetxt(root / "labels" / f"vid{vid}" / f"{f:03d}.txt", kp,
                       delimiter=",")
            img = (RNG.random((192, 192, 3)) * 255).astype(np.uint8)
            Image.fromarray(img).save(root / "images" / f"vid{vid}"
                                      / f"{f:03d}.png")
    return str(root / "labels"), str(root / "images")


@pytest.mark.parametrize("jitter, mirror", [(True, True), (False, False),
                                            (True, False)])
def test_face_dataset_matches_jax(face_dataset, jax_numpy_tier, jitter,
                                  mirror):
    """The same seed gives the same clips: names, labels and bboxes
    equal; images bit-equal (the resize and jitter tolerances are 0)."""
    kw = dict(n_frame_total=4, is_jitter=jitter, is_mirror=mirror,
              img_size=(64, 64))
    want_ds = JFaceDataset(*face_dataset, rng=random.Random(5), **kw)
    got_ds = FaceDatasetTrain(*face_dataset, rng=random.Random(5), **kw)
    worst = 0.0
    for k in range(6):
        want, got = want_ds[k % 3], got_ds[k % 3]
        assert got["names"] == want["names"]
        for key in ("lbl", "bbox"):
            assert got[key].dtype == np.uint8
            np.testing.assert_array_equal(got[key], want[key])
        assert got["img"].shape == want["img"].shape == (4, 3, 64, 64)
        worst = max(worst, float(np.abs(got["img"] - want["img"]).max()))
    _report(img_max_abs_diff=worst)
    assert worst == 0.0


class _IndexDataset:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise OSError(f"cannot read sample {i}")
        return {"i": np.asarray(i), "name": f"s{i}"}


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_order_matches_jax(drop_last):
    ds = _IndexDataset(11)
    kw = dict(batch_size=3, shuffle=True, num_workers=3, seed=7,
              drop_last=drop_last)
    theirs = JLoader(ds, **kw)
    with Loader(ds, **kw) as ours:
        assert len(ours) == len(theirs)
        for _ in range(3):                     # three epochs, one rng each
            got, want = list(ours), list(theirs)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a["i"], b["i"])
                assert a["name"] == b["name"]
    assert collate([ds[0], ds[1]])["i"].shape == (2,)


def test_loader_builds_the_next_epoch_ahead():
    """With one batch an epoch, the second epoch's batch is built while
    the first is consumed (the JAX loader starts it when iterated)."""
    ds = _IndexDataset(4)
    with Loader(ds, batch_size=4, num_workers=2, seed=1, prefetch=2) as ld:
        first = list(ld)
        deadline = time.time() + 30
        while ld._queue.qsize() < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert ld._queue.qsize() == 2      # epoch 2's batch and its end
        second = list(ld)
    assert [sorted(b["i"].tolist()) for b in first + second] == [
        [0, 1, 2, 3], [0, 1, 2, 3]]
    assert not ld._thread


def test_loader_raises_a_worker_error():
    with Loader(_IndexDataset(9, fail_at=4), batch_size=3, shuffle=False,
                num_workers=2) as loader:
        with pytest.raises(OSError, match="cannot read sample 4"):
            list(loader)

