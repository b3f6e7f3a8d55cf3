"""Whole-clip inference and its output helpers (counterpart of the JAX
package's `infer/pipeline.py`).

`ClipInference` runs a driving clip in fixed chunks of frames (the last
one padded by wrapping round the clip, as the JAX package does so that
jit compiles one program), each chunk through `tsnet_forward_clip`:
K3-nf + K2 in the bit-parity tier, K1 + K2 in the bench tier (`fast_tail`).
Under a profiler a job is the span `tsnet.clip.run` (the unit), holding
`tsnet.clip.upload` (the sources, one-hot labels and boxes to the device),
each chunk's model stages (`models.tsnet`) and `tsnet.clip.copy_back`
(the frames to the host).
`run_renormalized` also renormalizes each frame to the first reference's
mean and unbiased std on the device (reference demo/demo_face.py:178-198).
`to_display_rgb` and `montage_row` make the uint8 frames that
`data.image_io.write_png` writes, and `save_gif` animates them
(`data.gif`).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..compat.flax_params import load_flax_params
from ..configs import TSNetConfig
from ..data.gif import write_gif
from ..device import resolve_device
from ..models.tsnet import GEN_SUBNETS, TSNetModules, tsnet_forward_clip
from ..utils.profiling import span


class ClipInference:
    """Whole-clip TS-Net inference with the reference demo's semantics.

    `params` is a generator tree in the JAX package's layout (what
    `train.restore_generator_params(path)` returns; a trainer snapshot's
    tree also works, its other entries are ignored), or generator modules
    of `cfg` on `device` (`TSNetModules`), which the engine then runs as
    they are: weights loaded into them later are the engine's."""

    def __init__(self, cfg: TSNetConfig, params: Mapping | TSNetModules,
                 use_kernels: bool = True, chunk: int = 32, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if isinstance(params, TSNetModules):
            if params.cfg != cfg or params.device != self.device:
                raise ValueError("the modules were built for another "
                                 "config or device")
            self.mods = params
        else:
            self.mods = TSNetModules(cfg, device=self.device)
            load_flax_params(self.mods, {k: params[k] for k in GEN_SUBNETS})
        self.use_kernels = use_kernels
        self.chunk = chunk

    def _onehot(self, lbl) -> torch.Tensor:
        lbl = torch.as_tensor(np.asarray(lbl), device=self.device).long()
        return F.one_hot(lbl, self.cfg.label_nc).float()

    def prepare_sources(self, src_imgs, src_lbls, src_bboxes):
        """(S, 3, H, W) dataset-space images, (S, H, W) class maps and
        (S, H, W) bboxes -> model-space NHWC tensors on the device."""
        img = torch.as_tensor(np.asarray(src_imgs, np.float32),
                              device=self.device)
        return (img.permute(0, 2, 3, 1) / 255.0, self._onehot(src_lbls),
                torch.as_tensor(np.asarray(src_bboxes, np.float32),
                                device=self.device))

    def _forward(self, src, tar_lbl, tar_bbox) -> torch.Tensor:
        return tsnet_forward_clip(self.mods, *src, tar_lbl, tar_bbox,
                                  use_kernels=self.use_kernels,
                                  device=self.device)

    def _renormalized(self, src, tar_lbl, tar_bbox) -> torch.Tensor:
        rec = self._forward(src, tar_lbl, tar_bbox)
        ref = src[0][0]
        ref_mean = ref.mean(dim=(0, 1))
        ref_std = ref.std(dim=(0, 1))                 # unbiased, as torch
        gen_mean = rec.mean(dim=(1, 2), keepdim=True)
        gen_std = rec.std(dim=(1, 2), keepdim=True)
        return (rec - gen_mean) / gen_std * ref_std + ref_mean

    def _run_chunks(self, fn, src_imgs, src_lbls, src_bboxes, tar_lbls,
                    tar_bboxes) -> np.ndarray:
        dev = self.device
        with span("tsnet.clip.run", dev):
            with span("tsnet.clip.upload", dev):
                src = self.prepare_sources(src_imgs, src_lbls, src_bboxes)
                tar_lbl = self._onehot(tar_lbls)
                tar_bbox = torch.as_tensor(np.asarray(tar_bboxes, np.float32),
                                           device=dev)
            f = tar_lbl.shape[0]
            outs = []
            with torch.inference_mode():
                for lo in range(0, f, self.chunk):
                    idx = torch.arange(lo, lo + self.chunk,
                                       device=dev) % f   # pad by wrapping
                    rec = fn(src, tar_lbl[idx], tar_bbox[idx])
                    outs.append(rec[:min(self.chunk, f - lo)])
                with span("tsnet.clip.copy_back", dev):
                    rec = torch.cat(outs).permute(0, 3, 1, 2).cpu().numpy()
        return rec

    def run(self, src_imgs, src_lbls, src_bboxes, tar_lbls, tar_bboxes):
        """The whole driving clip -> (F, 3, H, W) model-space frames."""
        return self._run_chunks(self._forward, src_imgs, src_lbls,
                                src_bboxes, tar_lbls, tar_bboxes)

    def run_renormalized(self, src_imgs, src_lbls, src_bboxes, tar_lbls,
                         tar_bboxes):
        """`run`, each frame renormalized on the device to the first
        reference's mean and std."""
        return self._run_chunks(self._renormalized, src_imgs, src_lbls,
                                src_bboxes, tar_lbls, tar_bboxes)


def to_display_rgb(img_chw: np.ndarray, mean) -> np.ndarray:
    """Model-space (3, H, W) -> uint8 RGB (H, W, 3): add mean/255, clip to
    [0, 1], scale, BGR -> RGB (reference demo/demo_face.py:95-106)."""
    img = img_chw.transpose(1, 2, 0) + np.asarray(mean, np.float32) / 255.0
    img = np.clip(img, 0.0, 1.0) * 255.0
    return img[:, :, ::-1].astype(np.uint8)


def montage_row(images: Sequence[np.ndarray]) -> np.ndarray:
    """Equally sized (H, W, 3) uint8 images side by side."""
    return np.concatenate([np.asarray(i, np.uint8) for i in images], axis=1)


def save_gif(path: str, frames: Sequence[np.ndarray],
             duration_ms: int = 100) -> None:
    """(H, W, 3) uint8 RGB frames as a looping GIF, each shown for
    `duration_ms` (the GIF's delays are in centiseconds)."""
    write_gif(path, frames, duration_ms=duration_ms)
