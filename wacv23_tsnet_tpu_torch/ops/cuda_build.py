"""Build and load the port's CUDA kernels; count their launches.

Each `csrc/<name>.cu` is compiled by nvcc for Hopper (`sm_90a`) into its
own shared library with a plain C interface, loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

The build happens at first use, into `wacv23_tsnet_tpu_torch/_build/`
(git-ignored), named by a hash of the source, the shared headers of
`csrc/` (`*.cuh`) and the flags, so a changed source or header is rebuilt
and an unchanged one is loaded as it is. nvcc's output
(`-Xptxas -v`: registers, shared memory, spills) is kept beside the
library as `<name>-<hash>.log`. Nothing is built when a module is
imported, and a failed build raises: no caller falls back to a plain
version on the GPU.

`LAUNCHES` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches and nowhere else, one per call even where the
call runs two CUDA kernels (a statistics pass and the main kernel).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("transform_warp", "transform_warp_bwd", "in_mean",
           "fuse_pair_conv2", "conv3x3_in")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {
    "transform_warp_pairs_mean": 0,
    "transform_warp_pairs_nf": 0,
    "transform_warp_pairs": 0,
    "transform_warp_pairs_bwd": 0,
    "instance_norm_mean": 0,
    "fuse_pair_conv2": 0,
    "conv3x3_in": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from csrc/ with the CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to: keyed on its source, the headers
    of `csrc/` it may include, and the flags."""
    digest = hashlib.sha256()
    for path in (CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all(names=SOURCES) -> dict[str, float]:
    """Build every kernel source, one nvcc each, all started together.

    Returns the wall seconds each build took.
    """
    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
        return {name: fut.result() for name, fut in futures.items()}


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of `csrc/<name>.cu`."""
    lib = ctypes.CDLL(str(build(name)))
    lib.tsnet_error_string.argtypes = [ctypes.c_int]
    lib.tsnet_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.tsnet_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def check_aligned(what: str, *tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the kernels
    move 16-byte chunks)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel: tensors must start on a 16-byte "
                             "boundary (take a .clone() of a sliced view)")


def gemm_weight(w: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv weight (Co, C, 3, 3) repacked as the implicit GEMMs read
    it: bf16 (Co, 3, 3, C), contiguous.

    The repack is kept while `w` lives and is not changed in place (its
    version counter), so a module's weight is repacked once, not at every
    call.
    """
    packed = w.detach().to(torch.bfloat16).permute(0, 2, 3, 1)
    if w.is_inference():   # no version counter to key on
        return packed.contiguous()
    key = id(w)
    hit = _GEMM_WEIGHTS.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    packed = packed.contiguous()
    ref = weakref.ref(w, lambda _, key=key: _GEMM_WEIGHTS.pop(key, None))
    _GEMM_WEIGHTS[key] = (ref, w._version, packed)
    return packed


_GEMM_WEIGHTS: dict = {}


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current PyTorch stream of a CUDA tensor's device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
