"""Per-stage timing of the clip-inference hot path and of the train step
(counterpart of the JAX package's `cli/profile_stages.py`, same flags).

Clip: the stages of `models.tsnet.decode_with_sources` (`label_features`,
`propagate`, `fuse_clip`, `decode`), each run alone on the outputs of
the one before, with the S sources encoded once. The decoder line times
the decoder the entry points run: the phase-decomposed one
(`nn.decoder.decoder_apply_fast`), as the JAX package's does.
`--train`: the generator forward and forward+backward, netD
forward+backward on fake and real, the VGG loss forward+backward and the
full GAN step, at batch `--batch-size` with seeded random weights (the
VGG19 too, where `weights/` holds none). Each stage is timed with CUDA
events: the median of 3 runs after one warm-up. Runs on the GPU.

    python -m wacv23_tsnet_tpu_torch.cli.profile_stages [--frames 128]
    python -m wacv23_tsnet_tpu_torch.cli.profile_stages --train
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import face_config
from ..device import resolve_device
from ..losses import vgg_perceptual_loss
from ..models.tsnet import (TSNetModules, decode, encode_sources,
                            label_features, propagate, tsnet_forward)
from ..nn import fuse_clip
from ..train.state import create_train_state
from ..train.step import make_train_step


def timed(name: str, fn, device: torch.device, repeats: int = 3,
          unit: str = "ms/clip"):
    """Run `fn()` once to warm up, then `repeats` times, each between two
    CUDA events (host clock on the CPU); prints and returns (median ms,
    the last output)."""
    out = fn()
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
    ms = float(np.median(times))
    print(f"  {name:<36s} {ms:8.2f} {unit}", flush=True)
    return ms, out


def clip_stages(mods: TSNetModules, pack: dict, tar_lbl: torch.Tensor,
                tar_bbox: torch.Tensor, stage=lambda name, fn: fn()):
    """The stages of `decode_with_sources` one by one, each through
    `stage(name, fn)`, which runs `fn()` and returns its output. Returns
    the reconstructions (F, H, W, 3) f32."""
    warp = ("transform+warp+mean (K1)" if mods.dec.dtype == torch.bfloat16
            else "transform+warp (K3-nf), mean")
    with torch.inference_mode():
        tar_fea, tar_fea_n, tar_mask = stage(
            "lbl_enc", lambda: label_features(mods, tar_lbl, tar_bbox))
        prop = stage(warp, lambda: propagate(mods, pack, tar_fea_n, tar_mask))
        syn = stage("fuse (split form, K2)", lambda: fuse_clip(
            mods.fuse_net, pack["fea"].float(), tar_fea.float()))
        return stage("decoder (phase-decomposed)",
                     lambda: decode(mods, prop, syn).float())


def profile_clip(args, device: torch.device) -> dict:
    cfg = dataclasses.replace(face_config(), precision=args.precision,
                              fast_tail=not args.no_fast_tail)
    mods = TSNetModules(cfg, device=device, seed=0)
    rng = np.random.default_rng(0)
    s, f, hw, nl = args.n_source, args.frames, args.size, cfg.label_nc

    def put(x):
        return torch.as_tensor(x.astype(np.float32), device=device)

    src = (put(rng.random((s, hw, hw, 3), np.float32)),
           put(rng.integers(0, 2, (s, hw, hw, nl))),
           put(rng.integers(0, 2, (s, hw, hw))))
    tar_lbl = put(rng.integers(0, 2, (f, hw, hw, nl)))
    tar_bbox = put(rng.integers(0, 2, (f, hw, hw)))
    print(f"device={_device_name(device)} frames={f} n_source={s} "
          f"precision={cfg.precision} fast_tail={cfg.fast_tail}", flush=True)
    pack = encode_sources(mods, *src)
    stages = {}

    def stage(name, fn):
        stages[name], out = timed(name, fn, device)
        return out

    clip_stages(mods, pack, tar_lbl, tar_bbox, stage)
    total = sum(stages.values())
    print(f"  {'SUM of stages':<36s} {total:8.2f} ms/clip "
          f"({f / total * 1e3:.1f} fps equivalent)", flush=True)
    return {"stage_ms": stages, "sum_ms": total}


def profile_train(args, device: torch.device) -> dict:
    """Per-stage timing of the train step at the shipped width."""
    cfg = dataclasses.replace(face_config(), precision=args.precision,
                              bwd_precision=args.bwd_precision,
                              fast_tail=not args.no_fast_tail)
    state = create_train_state(cfg, device=device, seed=0)
    mods = state.mods
    rng = np.random.default_rng(0)
    bs, hw, nl, s = args.batch_size, cfg.image_size, cfg.label_nc, \
        cfg.n_source
    batch = {k: torch.as_tensor(v.astype(np.float32), device=device)
             for k, v in {
                 "src_img": rng.random((bs, s, hw, hw, 3), np.float32),
                 "src_lbl": rng.integers(0, 2, (bs, s, hw, hw, nl)),
                 "src_bbox": rng.integers(0, 2, (bs, s, hw, hw)),
                 "tar_img": rng.random((bs, hw, hw, 3), np.float32),
                 "tar_lbl": rng.integers(0, 2, (bs, hw, hw, nl)),
                 "tar_bbox": rng.integers(0, 2, (bs, hw, hw))}.items()}
    rec = torch.as_tensor(rng.random((bs, hw, hw, 3), np.float32),
                          device=device)
    print(f"device={_device_name(device)} TRAIN bs={bs} {hw}^2 "
          f"precision={cfg.precision} bwd_precision={cfg.bwd_precision} "
          f"fast_tail={cfg.fast_tail}", flush=True)

    def gen_fwd():
        with torch.no_grad():
            return tsnet_forward(mods, batch["src_img"], batch["src_lbl"],
                                 batch["src_bbox"], batch["tar_lbl"],
                                 batch["tar_bbox"], tar_img=batch["tar_img"],
                                 train=True)["rec_img"]

    def gen_fwd_bwd():
        state.gen_opt.zero_grad(set_to_none=True)
        out = tsnet_forward(mods, batch["src_img"], batch["src_lbl"],
                            batch["src_bbox"], batch["tar_lbl"],
                            batch["tar_bbox"], tar_img=batch["tar_img"],
                            train=True)
        (out["rec_img"].sum() + out["loss_warp"]).backward()

    def disc_fwd_bwd():
        state.disc_opt.zero_grad(set_to_none=True)
        fake = torch.cat([batch["tar_lbl"], rec], dim=-1)
        real = torch.cat([batch["tar_lbl"], batch["tar_img"]], dim=-1)
        sum(t.abs().sum() for t in mods.netD(fake) + mods.netD(real)
            ).backward()

    def vgg_fwd_bwd():
        r = rec.clone().requires_grad_(True)
        vgg_perceptual_loss(state.vgg, r, batch["tar_img"]).backward()

    step = make_train_step(state)
    stages = {}
    for name, fn in (("generator forward", gen_fwd),
                     ("generator fwd+bwd", gen_fwd_bwd),
                     ("netD fwd+bwd (fake+real)", disc_fwd_bwd),
                     ("VGG loss fwd+bwd", vgg_fwd_bwd),
                     ("FULL D+G step", lambda: step(state, batch, 2e-4))):
        stages[name], _ = timed(name, fn, device, unit="ms/step")
        if name == "generator fwd+bwd":
            print(f"  {'-> generator backward':<36s} "
                  f"{stages[name] - stages['generator forward']:8.2f} ms "
                  f"(difference)", flush=True)
    return {"stage_ms": stages}


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def main(argv=None, device="cuda") -> dict:
    """Parse `argv` and profile on `device` (the command line always
    takes the GPU). Returns the stage times in ms."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=128)
    p.add_argument("--n-source", type=int, default=3)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--precision", default="high")
    p.add_argument("--no-fast-tail", action="store_true")
    p.add_argument("--train", action="store_true",
                   help="profile the TRAIN step stages instead")
    p.add_argument("--batch-size", type=int, default=15)
    p.add_argument("--bwd-precision", default=None,
                   help="precision of the backward convs (train profile); "
                        "'default' is the fast train tier's")
    args = p.parse_args(argv)
    dev = resolve_device(device)
    if args.train:
        return profile_train(args, dev)
    return profile_clip(args, dev)


if __name__ == "__main__":
    main()
