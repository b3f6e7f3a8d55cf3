"""Write the JPEG fixtures of this directory and their manifest.

    python tests/torch_fixtures/jpeg/make_fixtures.py

Needs Pillow (with libjpeg-turbo). Each fixture is a stand-in for a dance
video frame: colour ramps, a few filled shapes (a head, a torso, a
floor), and Gaussian noise of sigma 8 on the shapes and the floor.
`manifest.json` holds, for each file, the sha256 of Pillow's decode
(`Image.open(f).convert("RGB")`, the bytes of the (H, W, 3) uint8 array)
and the Pillow and libjpeg-turbo versions that decoded it, so that a
run without Pillow can hold the port's decoder against it.
"""

import hashlib
import io
import json
import os

import numpy as np
from PIL import Image, ImageDraw, features

HERE = os.path.dirname(os.path.abspath(__file__))
# name: ((width, height), save options, mode)
FIXTURES = {
    "ramp_420_q75.jpg": ((288, 512), dict(quality=75, subsampling=2), "RGB"),
    "ramp_422_q90.jpg": ((288, 512), dict(quality=90, subsampling=1), "RGB"),
    "ramp_444_q95_rst.jpg": ((288, 512), dict(
        quality=95, subsampling=0, restart_marker_blocks=12), "RGB"),
    "ramp_gray_q75.jpg": ((288, 512), dict(quality=75), "L"),
    "ramp_420_q75_optimize_289x511.jpg": ((289, 511), dict(
        quality=75, subsampling=2, optimize=True), "RGB"),
}
NOISE_SIGMA = 8.0


def frame(size, seed: int) -> np.ndarray:
    """(h, w, 3) uint8: ramps, filled shapes, noise on shapes and floor."""
    w, h = size
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    ramp = np.stack([40 + 150 * xx / w, 60 + 120 * yy / h,
                     200 - 100 * (xx + yy) / (w + h)], axis=-1)
    img = Image.fromarray(ramp.astype(np.uint8))
    mask = Image.new("L", size)
    shapes = [("ellipse", [w * 0.3, h * 0.1, w * 0.7, h * 0.35],
               (200, 150, 120)),
              ("rectangle", [w * 0.35, h * 0.35, w * 0.65, h * 0.75],
               (30, 60, 140)),
              ("polygon", [(w * 0.1, h * 0.9), (w * 0.3, h * 0.6),
                           (w * 0.45, h * 0.95)], (220, 220, 60)),
              ("rectangle", [0, h * 0.85, w, h], (90, 70, 50))]
    for kind, box, color in shapes:
        getattr(ImageDraw.Draw(img), kind)(box, fill=color)
        getattr(ImageDraw.Draw(mask), kind)(box, fill=255)
    noisy = np.asarray(mask)[..., None] > 0
    out = np.asarray(img).astype(np.float64) + noisy * rng.normal(
        0.0, NOISE_SIGMA, (h, w, 1))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def decoded_sha256(data: bytes) -> str:
    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def main() -> None:
    files = {}
    for seed, (name, (size, options, mode)) in enumerate(FIXTURES.items()):
        img = Image.fromarray(frame(size, seed)).convert(mode)
        buf = io.BytesIO()
        img.save(buf, "JPEG", **options)
        data = buf.getvalue()
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        files[name] = {"size": list(size), "mode": mode,
                       "options": options, "bytes": len(data),
                       "sha256_rgb": decoded_sha256(data)}
    manifest = {"pillow": Image.__version__,
                "libjpeg_turbo": features.version_feature("libjpeg_turbo"),
                "decode": "Image.open(f).convert('RGB'), (H, W, 3) uint8",
                "files": files}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
