"""The arithmetic: FLOPs against FlopCounterMode over the reference, the
trace's busy and idle intervals, the roofline share, the seeded
traffic."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, flops, readers, traffic, weights
from benchmark.reference import model as ref
from benchmark.tests.conftest import toy_config
from benchmark.trace import idle_gaps, union_s


def counted(fn) -> int:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return mode.get_total_flops()


def clip_inputs(cfg, s, f, seed=0):
    size, nc = cfg["image_size"], cfg["label_nc"]
    r = common.rng(seed, 0)
    lbl, box = traffic.face_clip(r, s + f, size, "cpu", 1.0)
    img = traffic.smooth_images(r, s, size, "cpu")
    oh = traffic.one_hot(lbl.clamp(max=nc - 1), nc)
    return img, oh[:s], box[:s], oh[s:], box[s:]


@pytest.mark.parametrize("task", ["face", "pose"])
def test_clip_flops_match_flop_counter(task):
    cfg = toy_config(task)
    w = weights.make(cfg, 1, "cpu", train=False)
    args = clip_inputs(cfg, 2, 5)
    got = counted(lambda: ref.generator_clip(w, cfg, *args, ref.Precision(),
                                             block=3))
    assert got == flops.clip_flops(cfg, 2, 5)


@pytest.mark.parametrize("task", ["face", "pose"])
def test_train_step_flops_match_flop_counter(task):
    cfg = toy_config(task)
    w = weights.make(cfg, 2, "cpu", train=True)
    batch = traffic.train_batch(common.rng(3, 0), cfg, 2, task, 1.0, "cpu")
    p = {k: v.clone() for k, v in w.items()}
    got = counted(lambda: ref.train_step(p, {}, cfg, batch, 2e-4))
    assert got == flops.train_step_flops(cfg, 2)


def test_union_and_gaps():
    ivs = [(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]
    assert union_s(ivs) == pytest.approx((12 + 10 + 1) * 1e-6)
    assert idle_gaps(ivs) == [(12, 20), (30, 40)]
    assert union_s([]) == 0.0


def test_idle_share_and_roofline_readers():
    events = [("void transform_warp_kernel<1>(float*)", 0.0, 100.0),
              ("void in_mean_kernel<bf16>(x)", 150.0, 50.0),
              ("void transform_warp_kernel<1>(float*)", 300.0, 100.0)]
    rec = {"clip_shape": {}, "trace": {"device_events": events,
                                       "busy_s": 250e-6, "window_s": 1e-3},
           "launches": {"transform_warp_pairs_mean": 2}}
    assert readers.idle_share(rec, "clip_shape") == pytest.approx(75.0)
    call = (989e12 * 20e-6, 0)      # 20 us at the peak a call
    share = readers.kernel_roofline(rec, r"transform_warp_kernel",
                                    "transform_warp_pairs_mean", call)
    assert share == pytest.approx(100.0 * 2 * 20 / 200)
    rec["launches"] = {}
    assert readers.kernel_roofline(rec, r"transform_warp_kernel",
                                   "transform_warp_pairs_mean", call) is None
    assert readers.idle_share({"clip_shape": {}, "trace": {
        "device_events": [], "busy_s": 0.0, "window_s": 1.0}},
        "clip_shape") is None


def test_kernel_bounds_follow_the_shapes():
    f1, b1 = flops.k1_call(3, 64, 1024, 512)
    assert f1 == 3 * 64 * 1024 * (2 * 1024 * 512 + 10 * 1024 + 8 * 512)
    f2, b2 = flops.k2_call(3, 64, 1024, 1024, 2)
    assert b2 == 3 * 64 * 1024 * 1024 * 2 * 4 // 3
    assert flops.bound_s(f2, b2) == pytest.approx(b2 / 3.35e12)


def test_quartile_spread_is_pythons():
    import statistics
    q = statistics.quantiles([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], n=4)
    assert q == [1.75, 3.5, 5.25]


@pytest.mark.parametrize("labels", ["face", "pose"])
def test_traffic_is_seeded(labels):
    cfg = toy_config(labels)
    a = traffic.train_batch(common.rng(5, 1), cfg, 2, labels, 1.0, "cpu")
    b = traffic.train_batch(common.rng(5, 1), cfg, 2, labels, 1.0, "cpu")
    c = traffic.train_batch(common.rng(6, 1), cfg, 2, labels, 1.0, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tar_img"], c["tar_img"])
    assert a["tar_lbl"].sum(-1).eq(1).all()
    assert a["tar_lbl"][..., 1:].sum() > 0


def test_face_clip_traffic_moves_and_repeats():
    r1, r2 = common.rng(2 ** 31 + 77, 200), common.rng(2 ** 31 + 77, 200)
    l1, b1 = traffic.face_clip(r1, 6, 64, "cpu", 1.0)
    l2, b2 = traffic.face_clip(r2, 6, 64, "cpu", 1.0)
    assert torch.equal(l1, l2) and torch.equal(b1, b2)
    assert not torch.equal(l1[0], l1[5])
    assert l1.max() == 1 and b1.sum() > 0


def test_pose_frames_have_a_face_for_the_crop():
    lbl, box = traffic.pose_frames(common.rng(9, 0), 3, 256, 25, "cpu")
    assert (lbl == 24).any(dim=(1, 2)).all()
    assert ((lbl >= 1) & (lbl <= 4)).any(dim=(1, 2)).all()
    assert box.sum() > 0


def test_weights_are_seeded_and_complete():
    cfg = toy_config("pose")
    a = weights.make(cfg, 4, "cpu", train=True)
    b = weights.make(cfg, 4, "cpu", train=True)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(float(v.abs().sum()) == 0 for k, v in a.items()
               if k.endswith(".bias"))
    assert np.isclose(float(a["img_enc.conv_in.weight"].std()), 0.02,
                      rtol=0.2)
