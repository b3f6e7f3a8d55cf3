"""Build and bind the native rasterizer (`rasterize.cc`).

The host's C++ compiler builds it at first use into the port's
git-ignored `wacv23_tsnet_tpu_torch/_build/`:

    c++ -O3 -march=native -shared -fPIC -o _build/rasterize-<hash>.so rasterize.cc

named by a hash of the source and the flags, so an edited source is
rebuilt. Each process builds to a temporary name of its own and renames
it into place, so processes that build at once (test workers, a data
loader's workers) never read a half-written library. The library is
bound through `ctypes`. A failed build or load raises: nothing falls back
to the numpy tier; `TSNET_NATIVE=0` selects that tier
(`data.rasterize.draw_edge`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "rasterize.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"rasterize-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `rasterize.cc` unless its library is already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["c++", *FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as err:
        raise RuntimeError(f"cannot run the C++ compiler for {SOURCE.name}: "
                           f"{err}") from err
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"c++ failed on {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    with _LOCK:
        cdll = ctypes.CDLL(str(build()))
    cdll.tsnet_draw_edge.restype = ctypes.c_int
    cdll.tsnet_draw_edge.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
    ]
    return cdll


def native_draw_edge(img: np.ndarray, x, y, bw: int, color,
                     endpoints: bool) -> None:
    """Fit and stamp one edge into img, in place: a C-contiguous uint8
    (H, W) or (H, W, C) array. A colour shorter than C paints its first
    value in every channel, as the numpy tier's assignment does."""
    if img.dtype != np.uint8 or not img.flags.c_contiguous:
        raise ValueError("native_draw_edge needs a C-contiguous uint8 image")
    x = np.ascontiguousarray(x, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    if x.size < 2:
        return
    c = 1 if img.ndim == 2 else img.shape[2]
    col = np.asarray(color, np.uint8).reshape(-1)
    if col.size < c:
        col = np.broadcast_to(col[:1], (c,))
    col = np.ascontiguousarray(col[:c])
    lib().tsnet_draw_edge(img.ctypes.data, img.shape[0], img.shape[1], c,
                          x.ctypes.data, y.ctypes.data, x.size, int(bw),
                          col.ctypes.data, int(endpoints))
