"""The port's last tools against the JAX package's (CPU): `utils.viz`
(`tensor2im`, `map2fig`, `grid2fig`), `cli.plot_history` and
`cli.bench_sweep`. The JAX tools draw with matplotlib; the port draws
with its own rasterizer and bitmap font, so images are held by what they
show (colours, line positions within a pixel, sizes), not bit for bit.
`pytest -s` prints each measured agreement."""

import csv
import json

import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from wacv23_tsnet_tpu.cli import bench_sweep as j_sweep
from wacv23_tsnet_tpu.cli import plot_history as j_plot
from wacv23_tsnet_tpu.utils import viz as jv
from wacv23_tsnet_tpu_torch.cli import bench_sweep, plot_history
from wacv23_tsnet_tpu_torch.configs import toy_config
from wacv23_tsnet_tpu_torch.data.image_io import read_png
from wacv23_tsnet_tpu_torch.utils import font, viz

RNG = np.random.default_rng(17)
# a pixel is "drawn" where a channel is more than this far from white
DRAWN = 32


def _report(name, **values):
    print(f"[tools] {name}: " + " ".join(f"{k}={v:.4g}"
                                         for k, v in values.items()))


@pytest.mark.parametrize("shape,normalize", [
    ((2, 3, 16, 16), True), ((3, 8, 12), True), ((8, 12), True),
    ((1, 4, 3, 8, 8), True), ((1, 1, 8, 8), False), ((5, 6, 7), False)])
def test_tensor2im_matches_jax(shape, normalize):
    x = RNG.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(viz.tensor2im(x, normalize=normalize),
                                  jv.tensor2im(x, normalize=normalize))
    got = viz.tensor2im([x, x * 2], normalize=normalize)
    want = jv.tensor2im([x, x * 2], normalize=normalize)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_jet_table_is_matplotlibs():
    from matplotlib import cm
    np.testing.assert_array_equal(viz.JET, cm.jet(np.arange(256))[:, :3])
    np.testing.assert_array_equal(viz.JET_BYTES,
                                  cm.jet(np.arange(256), bytes=True)[:, :3])


@pytest.mark.parametrize("shape,initial", [((32, 32), True),
                                           ((48, 64), True),
                                           ((20, 30), False)])
def test_map2fig_matches_jax(shape, initial):
    """Within 1 level of the JAX image everywhere; the share of pixels
    that match exactly is printed."""
    heat = RNG.random(shape).astype(np.float32) * 3 - 1
    got = viz.map2fig(heat, initial).astype(int)
    want = jv.map2fig(heat, initial).astype(int)
    assert got.shape == want.shape == shape + (3,)
    diff = np.abs(got - want).max(-1)
    _report(f"map2fig {shape}", max_levels=diff.max(),
            exact_share=float((diff == 0).mean()))
    assert diff.max() <= 1


def _grids():
    lin = np.linspace(-1, 1, 32)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    noise = np.random.default_rng(3).normal(0, 0.01, (32, 32, 2))
    return {"wave": np.stack([gx + 0.05 * np.sin(3 * gy),
                              gy * 0.9 + 0.05 * np.cos(2 * gx)], -1),
            "shrunk": np.stack([gx, gy], -1) * 0.7 + noise,
            "wide": np.stack([gx * 1.3, gy], -1)}


@pytest.mark.parametrize("name", list(_grids()))
def test_grid2fig_lines_within_a_pixel_of_jax(name):
    """The same 256 x 256 size; every drawn pixel of each image lies
    within 1 pixel of a drawn pixel of the other (masks dilated 1 px);
    the IoU of the masks is printed."""
    warp = _grids()[name]
    got = viz.grid2fig(warp).astype(int)
    want = jv.grid2fig(warp).astype(int)
    assert got.shape == want.shape == (256, 256, 3)
    mg = (255 - got).max(-1) > DRAWN
    mw = (255 - want).max(-1) > DRAWN
    iou = (mg & mw).sum() / (mg | mw).sum()
    _report(f"grid2fig {name}", iou=iou)
    assert not (mg & ~ndimage.binary_dilation(mw)).any()
    assert not (mw & ~ndimage.binary_dilation(mg)).any()
    # the flow grid is drawn in C0 over the light-grey identity grid
    assert (np.abs(got - viz.C0).max(-1) <= 2).sum() > 1000


def test_font_covers_printable_ascii():
    for code in range(32, 127):
        g = font.glyph(chr(code))
        assert g.shape == (7, 5) and (g.any() or chr(code) == " ")
    assert font.render("ab", 2).shape == (14, 22)
    np.testing.assert_array_equal(font.glyph("\x01"), font.glyph("?"))


def _history(path, rows=30):
    cols = {"step": lambda s: s, "seconds": lambda s: 1.5 * s,
            "G": lambda s: 10 * np.exp(-s / 8),
            "D": lambda s: 0.5 + 0.1 * np.sin(s / 3),
            "warp": lambda s: 3 - 0.05 * s, "align": lambda s: 0.2,
            "G_VGG": lambda s: 5 / np.sqrt(s)}
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(cols)
        for s in range(1, rows + 1):
            w.writerow([f"{f(s):.6g}" for f in cols.values()])
    return {k: np.array([f(s) for s in range(1, rows + 1)], float)
            for k, f in cols.items()}


def _curve_follows(img, cell, xs, ys) -> float:
    """The correlation, over the cell's columns that hold the curve's
    colour, of the curve's mean row with the data interpolated there
    (1.0 for a flat series drawn on one row band)."""
    r0, r1, c0, c1 = cell
    sub = img[r0:r1, c0:c1, :3].astype(int)
    hit = np.abs(sub - np.array(plot_history.LINE)).max(-1) <= 40
    cols = np.flatnonzero(hit.any(0))
    assert cols.size > 20, "the curve's colour is missing"
    rows = np.array([np.flatnonzero(hit[:, c]).mean() for c in cols])
    if np.ptp(ys) == 0:
        return 1.0 if np.ptp(rows) <= 3 else 0.0
    data = np.interp(np.linspace(xs[0], xs[-1], cols.size), xs, ys)
    return float(np.corrcoef(-rows, data)[0, 1])


def test_plot_history_matches_jax(tmp_path, capsys):
    """One CSV through both CLIs: PNG size equal, the same `wrote ... (n
    panels)` line, and in every panel the curve's colour present and
    following the data (as in the JAX image)."""
    data = _history(tmp_path / "h.csv")
    argv = ["--csv", str(tmp_path / "h.csv"), "--title", "loss curves"]
    plot_history.main(argv + ["--out", str(tmp_path / "port.png")])
    port_line = capsys.readouterr().out.strip()
    j_plot.main(argv + ["--out", str(tmp_path / "jax.png")])
    jax_line = capsys.readouterr().out.strip()
    assert port_line.replace("port.png", "X") == jax_line.replace(
        "jax.png", "X") == f"wrote {tmp_path / 'X'} (5 panels)"
    got = read_png(str(tmp_path / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert got.shape[:2] == want.shape[:2] == (528, 1408)
    ycols = ["G", "D", "warp", "align", "G_VGG"]
    cell_h, cell_w = 528 // 2, 1408 // 4
    for i, c in enumerate(ycols):
        r, k = divmod(i, 4)
        cell = (r * cell_h, (r + 1) * cell_h, k * cell_w, (k + 1) * cell_w)
        corr = _curve_follows(got, cell, data["step"], data[c])
        corr_jax = _curve_follows(want, cell, data["step"], data[c])
        _report(f"plot_history {c}", corr=corr, corr_jax=corr_jax)
        assert corr >= 0.99 and corr_jax >= 0.99


@pytest.mark.parametrize("panels", [1, 3, 11])
def test_plot_history_size_matches_jax(tmp_path, capsys, panels):
    """1, 3 and 11 panels (one, one and three rows): the PNG's size in
    pixels is the JAX CLI's (matplotlib truncates the figure's inches
    times the dpi: 2.4 x 3 x 110 gives 791)."""
    with open(tmp_path / "h.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["step", "seconds"] + [f"m{i}" for i in range(panels)])
        for s in range(1, 6):
            w.writerow([s, s * 2.0] + [i + 1.0 / s for i in range(panels)])
    for mod, out in ((plot_history, "port.png"), (j_plot, "jax.png")):
        mod.main(["--csv", str(tmp_path / "h.csv"),
                  "--out", str(tmp_path / out)])
    said = capsys.readouterr().out.splitlines()
    assert [line.split()[-2:] for line in said] == \
        [[f"({panels}", "panels)"]] * 2
    got = read_png(str(tmp_path / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert got.shape[:2] == want.shape[:2]


def test_bench_sweep_lines_match_jax(monkeypatch, capsys):
    """The port's sweep on the CPU at the toy config: the card line
    first on stderr, then the JAX CLI's grid, with the same JSON keys,
    units and number of lines (the JAX CLI's timing stubbed: its numbers
    are its device's)."""
    calls = []

    def stub(cfg, n_source, frames, iters=5):
        calls.append((n_source, frames))
        return 1.0

    monkeypatch.setattr(j_sweep, "measure", stub)
    j_sweep.main([])
    jax_out = capsys.readouterr().out.strip().splitlines()
    lines = bench_sweep.main([], base_config=toy_config(), device="cpu")
    out, err = capsys.readouterr()
    port_out = out.strip().splitlines()
    assert err.splitlines()[0] == "cpu"
    grid = [tuple(int(v) for v in row.split()[:2])
            for row in err.splitlines()[2:]]
    assert grid == calls
    assert len(port_out) == len(jax_out) == len(lines) == 8
    for p, j in zip(port_out, jax_out):
        p, j = json.loads(p), json.loads(j)
        assert set(p) == set(j) and p["unit"] == j["unit"]
        assert p["metric"].split(",")[:-1] == j["metric"].split(",")[:-1]
        assert p["value"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench_sweep.main([])
