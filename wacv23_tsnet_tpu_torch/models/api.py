"""Reference-style stateful TSNet (counterpart of the JAX package's
`models/api.py:TSNet`), in PyTorch.

Callers stage inputs with `set_train_input` / `set_test_input`, call
`forward()` or `optimize_parameters()`, and read results from attributes
(`rec_tar_img`, `warp_src_img_list`, `get_current_losses()`), as the
torch reference's training scripts do. Inputs are numpy arrays, NCHW,
in the reference's conventions: images mean-subtracted BGR (divided by
255 here), labels one-hot (B, L, H, W), bboxes (B, H, W). The work is done by
`models.tsnet.tsnet_forward` and `train.step.make_train_step`; results
stay on the device until read.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, Optional

import numpy as np
import torch

from ..configs import TSNetConfig
from ..train.schedule import lr_poly
from .tsnet import GEN_SUBNETS, TSNetModules, tsnet_forward

LOSS_NAMES = ("G", "G_GAN", "G_FML", "G_VGG", "D", "D_real", "D_fake",
              "grad_G", "warp", "align")
# the pose variant's, with the face discriminator's terms and no align
POSE_LOSS_NAMES = ("G", "G_GAN", "G_FML", "G_VGG", "GF", "GF_GAN", "GF_FML",
                   "GF_VGG", "D", "D_real", "D_fake", "DF", "DF_real",
                   "DF_fake", "grad_G", "warp")


def _nhwc(x) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(x), (0, 2, 3, 1)))


class TSNet:
    """Stateful TS-Net with the reference's method surface.

    `use_kernels=False` runs every kernel's plain version (the JAX
    package's `use_pallas=False`). Runs on the GPU unless
    `device="cpu"`."""

    def __init__(self, cfg: Optional[TSNetConfig] = None, *, lr: float = 2e-4,
                 beta1: float = 0.5, is_train: bool = True,
                 lambda_dec: float = 1.0, seed: int = 0,
                 use_kernels: bool = True, vgg_params=None, device="cuda",
                 **overrides):
        if cfg is None:
            cfg = TSNetConfig(**overrides)
        self.cfg = cfg
        self.lr = lr
        self.is_train = is_train
        self.lambda_dec = lambda_dec
        self.use_kernels = use_kernels
        self.n_source = cfg.n_source
        if is_train:
            # `train` imports this package: imported here, not at the top
            from ..train import create_train_state, make_train_step
            self.state = create_train_state(cfg, device=device, seed=seed,
                                            vgg_params=vgg_params,
                                            beta1=beta1)
            self.mods = self.state.mods
            self._train_step = make_train_step(
                self.state, lambda_dec=lambda_dec, use_kernels=use_kernels)
        else:
            self.state = None
            self.mods = TSNetModules(cfg, device=device, seed=seed)
        self.device = self.mods.device
        self._current_lr = lr
        self._batch = None
        self.loss_names = list(POSE_LOSS_NAMES if cfg.use_face_d
                               else LOSS_NAMES)
        self._losses = {k: 0.0 for k in self.loss_names}
        self._rec_dev = None
        self._rec_cache = None
        self._metrics_dev = None
        self.warp_src_img_list = None

    # ------------------------------------------- lazy device -> host reads
    @property
    def rec_tar_img(self) -> Optional[np.ndarray]:
        """The last reconstruction, (B, 3, H, W) model space, copied to
        the host on first read."""
        if self._rec_cache is None and self._rec_dev is not None:
            self._rec_cache = self._rec_dev.permute(0, 3, 1, 2).cpu().numpy()
        return self._rec_cache

    def _set_rec(self, rec: torch.Tensor) -> None:
        self._rec_dev = rec
        self._rec_cache = None

    def _sync_losses(self) -> None:
        if self._metrics_dev is None:
            return
        metrics, self._metrics_dev = self._metrics_dev, None
        keys = list(metrics)   # one stacked copy, not one per scalar
        values = torch.stack([metrics[k].float() for k in keys]).cpu()
        for k, v in zip(keys, values.tolist()):
            self._losses[k] = v

    # ---------------------------------------------------- parameter access
    @property
    def generator_params(self) -> dict:
        """The generator subnets' state dict (tensors on the device)."""
        return {k: v for k, v in self.mods.state_dict().items()
                if k.split(".")[0] in GEN_SUBNETS}

    def load_generator_params(self, params: Mapping) -> None:
        """Load a `generator_params` state dict (every generator tensor)."""
        own = self.generator_params
        if set(params) != set(own):
            raise KeyError("generator state dict mismatch: "
                           f"{sorted(set(params) ^ set(own))}")
        with torch.no_grad():
            for k, v in params.items():
                own[k].copy_(torch.as_tensor(v))

    # ------------------------------------------------------- input staging
    def set_train_input(self, src_img_list, src_lbl_list, src_bbox_list,
                        tar_img, tar_lbl, tar_bbox, use_prev=None) -> None:
        """Sources and one target, reference NCHW numpy (`use_prev[i]`:
        source i is already model space, as the reference's previous
        output is)."""
        srcs = []
        for idx, img in enumerate(src_img_list):
            scaled = np.asarray(img, np.float32)
            if use_prev is None or not use_prev[idx]:
                scaled = scaled / 255.0
            srcs.append(_nhwc(scaled))
        self._batch = {
            "src_img": np.stack(srcs, axis=1),
            "src_lbl": np.stack([_nhwc(x) for x in src_lbl_list], axis=1),
            "src_bbox": np.stack(
                [np.asarray(b, np.float32) for b in src_bbox_list], axis=1),
            "tar_img": _nhwc(np.asarray(tar_img, np.float32) / 255.0),
            "tar_lbl": _nhwc(tar_lbl),
            "tar_bbox": np.asarray(tar_bbox, np.float32),
        }

    def set_test_input(self, src_img_list, src_lbl_list, src_bbox_list,
                       tar_lbl, tar_bbox, **_prev) -> None:
        self._batch = {
            "src_img": np.stack(
                [_nhwc(np.asarray(i, np.float32) / 255.0)
                 for i in src_img_list], axis=1),
            "src_lbl": np.stack([_nhwc(x) for x in src_lbl_list], axis=1),
            "src_bbox": np.stack(
                [np.asarray(b, np.float32) for b in src_bbox_list], axis=1),
            "tar_lbl": _nhwc(tar_lbl),
            "tar_bbox": np.asarray(tar_bbox, np.float32),
        }

    def set_source_num(self, n_source: int) -> None:
        self.n_source = n_source

    # ------------------------------------------------------------- compute
    def _forward(self, batch: dict, train: bool) -> dict:
        b = {k: torch.as_tensor(v, device=self.device).float()
             for k, v in batch.items()}
        with torch.no_grad():
            return tsnet_forward(
                self.mods, b["src_img"], b["src_lbl"], b["src_bbox"],
                b["tar_lbl"], b["tar_bbox"], tar_img=b.get("tar_img"),
                train=train, use_kernels=self.use_kernels)

    def forward(self) -> None:
        """Generator forward on the staged inputs; with a staged target
        image on a training model, also the warp previews and the warp
        and align losses."""
        train = self.is_train and "tar_img" in self._batch
        out = self._forward(self._batch, train)
        self._set_rec(out["rec_img"])
        if train:
            warp = out["warp_imgs"].permute(0, 1, 4, 2, 3).cpu().numpy()
            self.warp_src_img_list = [warp[:, i] for i in range(warp.shape[1])]
            self._losses["warp"] = out["loss_warp"].item()
            if self.cfg.use_align_loss:
                self._losses["align"] = out["loss_align"].item()

    def optimize_parameters(self) -> None:
        """One D-then-G GAN update on the staged inputs."""
        self.optimize_parameters_on(self._batch)
        self._sync_losses()

    def optimize_parameters_on(self, batch: dict) -> None:
        """One GAN update on a batch in the train step's NHWC layout
        (tensors already on the device are not copied). The metrics stay
        on the device until `get_current_losses()` reads them."""
        if not self.is_train:
            raise RuntimeError("optimize_parameters needs is_train=True")
        self.state, metrics, rec = self._train_step(self.state, batch,
                                                    self._current_lr)
        self._set_rec(rec)
        self._metrics_dev = metrics

    def render_warp_previews(self, batch: dict) -> np.ndarray:
        """(B, S, 3, H, W) warp-supervision images of `batch` (the train
        step does not return them; image shots call this)."""
        warp = self._forward(batch, True)["warp_imgs"]
        return warp.permute(0, 1, 4, 2, 3).cpu().numpy()

    # ------------------------------------------------ schedule + reporting
    def setup(self, actual_step: int, batch_size: int, initial_iter: int,
              max_iter: int, power: float) -> None:
        self._current_lr = float(lr_poly(self.lr, actual_step * batch_size,
                                         initial_iter, max_iter, power))

    def get_current_losses(self) -> "OrderedDict[str, float]":
        self._sync_losses()
        return OrderedDict((k, float(self._losses.get(k, 0.0)))
                           for k in self.loss_names)

    def print_learning_rate(self) -> None:
        lr = self._current_lr
        print("lr= %.7f, lr_dec=%.7f, lr_dis=%.7f"
              % (lr, self.lambda_dec * lr, 0.5 * lr))
