"""Native (C++) host code of the port: the keypoint rasterizer's per-edge
loop, built by the host's compiler at first use and bound through ctypes
(`build.py`)."""

from .build import lib, native_draw_edge

__all__ = ["lib", "native_draw_edge"]
