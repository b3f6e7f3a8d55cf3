"""The port's native C++ rasterizer (`native/`) against its numpy tier and
against the JAX package's native path (CPU).

The bounds of tests/test_native.py: over 40 random edges of 2 and 3
points, with and without endpoint dots, a native stroke may differ from
the numpy tier's by single pixels (an int cast at a float tie:
<= max(8, 5%) of the stroke, in at most 8 of the 40); a grayscale edge
equals the numpy tier's and a degenerate fit draws nothing. Built by the
same compiler with the same flags, the port's library and the JAX
package's draw the same bits. `TSNET_NATIVE=0` selects the numpy tier of
`data.rasterize.draw_edge`; a failed build raises.
"""

import os
import shutil

import numpy as np
import pytest

from wacv23_tsnet_tpu.native import build as jbuild
from wacv23_tsnet_tpu_torch.data import rasterize
from wacv23_tsnet_tpu_torch.data.face import render_face_edges
from wacv23_tsnet_tpu_torch.native import build, native_draw_edge

RNG = np.random.default_rng(21)


def numpy_draw(img, x, y, bw, color, endpoints):
    cx, cy = rasterize.interp_curve(x, y)
    rasterize.stamp_edge(img, cx, cy, bw=bw, color=color, endpoints=endpoints)


@pytest.mark.parametrize("npts", [2, 3])
@pytest.mark.parametrize("endpoints", [False, True])
def test_native_draw_edge_matches_numpy(npts, endpoints):
    mismatches = 0
    for trial in range(40):
        x = RNG.uniform(5, 120, npts)
        y = RNG.uniform(5, 120, npts)
        want = np.zeros((128, 128, 3), np.uint8)
        got = np.zeros((128, 128, 3), np.uint8)
        numpy_draw(want, x, y, 2, (10, 200, 30), endpoints)
        native_draw_edge(got, x, y, 2, (10, 200, 30), endpoints)
        if not np.array_equal(got, want):
            diff = (got != want).any(axis=-1).sum()
            total = (want != 0).any(axis=-1).sum()
            assert diff <= max(8, 0.05 * total), (trial, diff, total)
            mismatches += 1
    assert mismatches <= 8


def test_native_grayscale_and_degenerate():
    img = np.zeros((64, 64), np.uint8)
    native_draw_edge(img, [10, 50], [20, 20], 1, (255,), False)
    want = np.zeros((64, 64), np.uint8)
    numpy_draw(want, np.array([10.0, 50.0]), np.array([20.0, 20.0]), 1,
               (255,), False)
    np.testing.assert_array_equal(img, want)
    img2 = np.zeros((64, 64), np.uint8)
    native_draw_edge(img2, [10, 10], [20, 20], 1, (255,), False)
    assert img2.sum() == 0


def _same_compiler() -> bool:
    """Whether the port's `c++` and the JAX package's `g++` are one
    compiler binary."""
    found = [shutil.which(cc) for cc in ("c++", "g++")]
    return None not in found and len({os.path.realpath(f)
                                      for f in found}) == 1


def test_native_matches_the_jax_package_bit_for_bit(tmp_path, monkeypatch):
    """Same source lines, same flags, same compiler: the same pixels, on
    random edges and on a whole face edge map."""
    if not _same_compiler():
        pytest.skip("c++ and g++ are different compilers here")
    monkeypatch.setenv("TSNET_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(jbuild, "_LIB", None)
    monkeypatch.setattr(jbuild, "_TRIED", False)
    assert jbuild.available()
    rng = np.random.default_rng(3)
    for npts in (2, 3, 3, 2):
        for _ in range(25):
            x, y = rng.uniform(-10, 140, npts), rng.uniform(-10, 140, npts)
            ours = np.zeros((128, 128, 3), np.uint8)
            theirs = np.zeros((128, 128, 3), np.uint8)
            native_draw_edge(ours, x, y, 3, (1, 2, 3), npts == 3)
            jbuild.native_draw_edge(theirs, x, y, 3, (1, 2, 3), npts == 3)
            np.testing.assert_array_equal(ours, theirs)
    kp = np.stack([rng.uniform(20, 230, 68), rng.uniform(20, 230, 68)], 1)
    ours = render_face_edges(kp, (256, 256), bw=2)
    from wacv23_tsnet_tpu.data.face import (
        render_face_edges as j_render_face_edges)
    np.testing.assert_array_equal(ours, j_render_face_edges(kp, (256, 256),
                                                            bw=2))


def test_draw_edge_tiers_and_refusals(monkeypatch, tmp_path):
    """`draw_edge` is native by default and numpy with TSNET_NATIVE=0,
    read at each call; the native path refuses images it cannot write
    and a build that fails raises rather than falling back."""
    x, y = np.array([3.3, 40.7, 60.2]), np.array([5.1, 30.9, 61.4])
    native = np.zeros((64, 64, 3), np.uint8)
    rasterize.draw_edge(native, x, y, bw=1, color=(7, 8, 9))
    want = np.zeros((64, 64, 3), np.uint8)
    native_draw_edge(want, x, y, 1, (7, 8, 9), False)
    np.testing.assert_array_equal(native, want)
    monkeypatch.setenv("TSNET_NATIVE", "0")
    tier = np.zeros((64, 64, 3), np.uint8)
    rasterize.draw_edge(tier, x, y, bw=1, color=(7, 8, 9))
    want = np.zeros((64, 64, 3), np.uint8)
    numpy_draw(want, x, y, 1, (7, 8, 9), False)
    np.testing.assert_array_equal(tier, want)
    with pytest.raises(ValueError, match="uint8"):
        native_draw_edge(np.zeros((8, 8), np.float32), x, y, 1, (1,), False)
    with pytest.raises(ValueError, match="uint8"):
        native_draw_edge(np.zeros((8, 16), np.uint8)[:, ::2], x, y, 1, (1,),
                         False)
    broken = tmp_path / "rasterize.cc"
    broken.write_text("int tsnet_draw_edge( {\n")
    monkeypatch.setattr(build, "SOURCE", broken)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match=r"c\+\+ failed on rasterize.cc"):
        build.build()
    assert not list((tmp_path / "_build").iterdir())
