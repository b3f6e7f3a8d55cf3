"""The GAN train step (counterpart of the JAX package's
`train/step.py:make_train_step`).

One call is the torch reference's `optimize_parameters`: one generator
forward; the D update on the detached reconstruction; then the G update
against the updated D, where D's parameters take no gradient and the
real branch is detached. The pose variant (`use_face_d`) adds the face
discriminator netDF to both phases, on `crop_faces` of the
reconstruction and of the target (DF_* and GF_* terms, the GF VGG loss on
the crops). The metrics carry the JAX package's names.

As the JAX package's step, it gives the same bits on every call from the
same state and batch: it runs under `deterministic_cudnn()`, and the
kernels (K3-flow, K4, K2) and the crops' backward sum in a fixed order.
"""

from __future__ import annotations

import contextlib

import torch

from ..losses import (feature_matching_loss, gradient_loss, lsgan_loss,
                      vgg_perceptual_loss)
from ..models.tsnet import crop_faces, disc_subnets, tsnet_forward
from ..ops.precision import deterministic_cudnn
from ..utils.profiling import span
from .state import TrainState

BATCH_KEYS = ("src_img", "src_lbl", "src_bbox", "tar_img", "tar_lbl",
              "tar_bbox")


@contextlib.contextmanager
def frozen(modules):
    """The modules' parameters take no gradient inside the block."""
    for m in modules:
        m.requires_grad_(False)
    try:
        yield
    finally:
        for m in modules:
            m.requires_grad_(True)


def make_train_step(state: TrainState, lambda_dec: float = 1.0,
                    d_lr_factor: float = 0.5, use_kernels: bool = True,
                    mark=None, grad_hook=None):
    """Build `step(state, batch, lr) -> (state, metrics, rec_img)`.

    `batch` holds src_img (B, S, H, W, 3), src_lbl (B, S, H, W, L),
    src_bbox (B, S, H, W), tar_img (B, H, W, 3), tar_lbl (B, H, W, L) and
    tar_bbox (B, H, W), as numpy arrays or tensors; they move to the
    state's device. Learning rates: `lr` for img_enc, lbl_enc and
    fuse_net, `lambda_dec * lr` for dec, `d_lr_factor * lr` for netD and
    netDF. The state is updated in place (parameters, moments, step
    count) and returned. After the call every parameter's `.grad` holds
    the gradient of this step's loss (netD's and netDF's: the D loss,
    D + DF); a generator parameter the loss does not use (FuseNet's conv2
    bias and the decoder's up-stage biases, which instance norms cancel
    and the split forms drop) takes a zero gradient, as optax gives it:
    Adam still decays its moments and moves it by them.
    `use_kernels=False` runs every kernel's plain version. The metrics
    are 0-d tensors on the device. `mark(name)`, where given, is called
    at the end of each stage of the step: "g_forward", "d_phase",
    "d_opt", "g_loss_backward", "g_opt" (a profiler places its events
    there). Under a profiler the step is the span `tsnet.train.step` (the
    unit), holding `tsnet.train.g_forward`, `.d_phase` (with netDF's
    crops), `.d_opt`, `.g_loss_forward` (the G phase's losses on the
    updated discriminators), `.g_backward` (with the zero-gradient fill)
    and `.g_opt` (`utils.profiling.span`). `grad_hook(opt)`,
    where given, is called just before each Adam update with the
    optimizer about to step (`parallel.spmd` averages the gradients over
    its `data` axis there).
    """
    mods, vgg = state.mods, state.vgg
    cfg = mods.cfg
    subnet_lr = {"img_enc": 1.0, "lbl_enc": 1.0, "fuse_net": 1.0,
                 "dec": lambda_dec, "netD": d_lr_factor,
                 "netDF": d_lr_factor}
    discs = [getattr(mods, name) for name in disc_subnets(cfg)]
    dev = mods.device

    def done(name):
        if mark is not None:
            mark(name)

    def set_lr(opt, lr):
        for group in opt.param_groups:
            group["lr"] = subnet_lr[group["name"]] * lr

    def step(state: TrainState, batch: dict, lr: float):
        with span("tsnet.train.step", dev), deterministic_cudnn():
            return run(state, batch, lr)

    def run(state: TrainState, batch: dict, lr: float):
        b = {k: torch.as_tensor(batch[k], device=mods.device).float()
             for k in BATCH_KEYS}
        state.gen_opt.zero_grad(set_to_none=True)
        state.disc_opt.zero_grad(set_to_none=True)

        # generator forward, once
        with span("tsnet.train.g_forward", dev):
            out = tsnet_forward(mods, b["src_img"], b["src_lbl"],
                                b["src_bbox"], b["tar_lbl"], b["tar_bbox"],
                                tar_img=b["tar_img"], train=True,
                                use_kernels=use_kernels)
        done("g_forward")
        rec, tar = out["rec_img"], b["tar_img"]

        # D phase: fake from the current generator, detached
        with span("tsnet.train.d_phase", dev):
            real_st = torch.cat([b["tar_lbl"], tar], dim=-1)
            if cfg.use_face_d:
                fake_face = crop_faces(rec, b["tar_lbl"])
                real_face = crop_faces(tar, b["tar_lbl"])
            pred_fake = mods.run(mods.netD, torch.cat(
                [b["tar_lbl"], rec.detach()], dim=-1))
            pred_real = mods.run(mods.netD, real_st)
            metrics = {"D_fake": lsgan_loss(pred_fake[-1], False),
                       "D_real": lsgan_loss(pred_real[-1], True)}
            metrics["D"] = 0.5 * (metrics["D_fake"] + metrics["D_real"])
            d_total = metrics["D"]
            if cfg.use_face_d:
                pf = mods.run(mods.netDF, fake_face.detach())
                pr = mods.run(mods.netDF, real_face)
                metrics["DF_fake"] = lsgan_loss(pf[-1], False)
                metrics["DF_real"] = lsgan_loss(pr[-1], True)
                metrics["DF"] = 0.5 * (metrics["DF_fake"]
                                       + metrics["DF_real"])
                d_total = d_total + metrics["DF"]
            d_total.backward()
        done("d_phase")
        with span("tsnet.train.d_opt", dev):
            set_lr(state.disc_opt, lr)
            if grad_hook is not None:
                grad_hook(state.disc_opt)
            state.disc_opt.step()
        done("d_opt")

        # G phase: against the updated discriminators, which take no
        # gradient
        with frozen(discs):
            with span("tsnet.train.g_loss_forward", dev):
                pred_fake = mods.run(mods.netD,
                                     torch.cat([b["tar_lbl"], rec], dim=-1))
                with torch.no_grad():
                    pred_real = mods.netD(real_st)
                metrics["G_GAN"] = lsgan_loss(pred_fake[-1], True)
                metrics["G_FML"] = feature_matching_loss(
                    pred_fake, pred_real, cfg.lambda_fml)
                metrics["G_VGG"] = cfg.lambda_vgg * vgg_perceptual_loss(
                    vgg, rec, tar)
                metrics["grad_G"] = cfg.lambda_grad * gradient_loss(rec, tar)
                metrics["warp"] = out["loss_warp"]
                metrics["G"] = (metrics["G_GAN"] + metrics["G_FML"]
                                + metrics["G_VGG"])
                total = metrics["G"] + metrics["grad_G"] + metrics["warp"]
                if cfg.use_align_loss:
                    metrics["align"] = out["loss_align"]
                    total = total + metrics["align"]
                if cfg.use_face_d:
                    pf = mods.run(mods.netDF, fake_face)
                    with torch.no_grad():
                        pr = mods.netDF(real_face)
                    metrics["GF_GAN"] = lsgan_loss(pf[-1], True)
                    metrics["GF_FML"] = feature_matching_loss(
                        pf, pr, cfg.lambda_fml)
                    metrics["GF_VGG"] = cfg.lambda_vgg * vgg_perceptual_loss(
                        vgg, fake_face, real_face)
                    metrics["GF"] = (metrics["GF_GAN"] + metrics["GF_FML"]
                                     + metrics["GF_VGG"])
                    total = total + metrics["GF"]
            with span("tsnet.train.g_backward", dev):
                total.backward()
                done("g_loss_backward")
                for group in state.gen_opt.param_groups:
                    for p in group["params"]:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
        with span("tsnet.train.g_opt", dev):
            set_lr(state.gen_opt, lr)
            if grad_hook is not None:
                grad_hook(state.gen_opt)
            state.gen_opt.step()
        done("g_opt")
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}, rec.detach()

    return step
