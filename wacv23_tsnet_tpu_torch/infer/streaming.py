"""Streaming retargeting sessions (counterpart of the JAX package's
`infer/streaming.py:RetargetSession`).

A session encodes the reference frames once and keeps their feature pack
on the device; callers then stream driving inputs in chunks and get
synthesized frames back. Two input levels:

- `push_labels(tar_lbl, tar_bbox)`: rasterized label maps;
- `push_keypoints(keypoints)`: raw keypoints, face landmarks or the
  pose task's OpenPose points. Rasterization (`data.rasterize_device`),
  one-hot expansion and the extent bbox run on the device, chunk by
  chunk, so only keypoints cross to it.

`output="model"` returns f32 model-space frames; `output="display"`
converts on the device to `round(clip(rec*255 + img_mean))` uint8 frames
in the model's BGR order, a quarter of the bytes to copy back.

The JAX session kept `pipeline_depth` chunks in flight to hide dispatch
latency. Here every chunk is enqueued on the current CUDA stream, which
orders them; the host does not wait until all chunks are queued, then
copies the frames back once. A short last chunk runs at its own size
(eager PyTorch has no per-shape compile to avoid).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..data.rasterize_device import rasterize_face_clip, rasterize_pose_clip
from ..device import resolve_device
from ..models.tsnet import TSNetModules, decode_with_sources, encode_sources


class RetargetSession:
    def __init__(self, mods: TSNetModules, src_img, src_lbl, src_bbox,
                 chunk: int = 32, output: str = "model", device="cuda",
                 use_kernels: bool = True):
        """src_img (S, H, W, 3) model space, src_lbl (S, H, W, L) one-hot,
        src_bbox (S, H, W): numpy arrays or tensors, moved to `device`,
        where `mods` must live. `use_kernels=False` decodes through every
        kernel's plain version (the JAX session's `use_pallas`)."""
        if output not in ("model", "display"):
            raise ValueError(f"unknown output format: {output!r}")
        dev = resolve_device(device)
        if mods.device != dev:
            raise ValueError(
                f"modules live on {mods.device}, session on {dev}")
        self.mods = mods
        self.device = dev
        self.chunk = chunk
        self.output = output
        self.use_kernels = use_kernels
        self._mean = torch.as_tensor(mods.cfg.img_mean_array(), device=dev)
        self.src_pack = encode_sources(
            mods, *(torch.as_tensor(x, device=dev)
                    for x in (src_img, src_lbl, src_bbox)),
            use_kernels=use_kernels)

    def _finish(self, rec: torch.Tensor) -> torch.Tensor:
        if self.output == "display":
            return torch.clamp(torch.round(rec * 255.0 + self._mean),
                               0.0, 255.0).to(torch.uint8)
        return rec

    def _decode(self, lbl: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
        """One chunk: one-hot (or class-map) labels and bboxes -> frames."""
        if lbl.dim() == 3:
            lbl = F.one_hot(lbl.long(), self.mods.cfg.label_nc)
        rec = decode_with_sources(self.mods, self.src_pack, lbl.float(),
                                  bbox.float(), use_kernels=self.use_kernels)
        return self._finish(rec)

    def push_labels(self, tar_lbl, tar_bbox) -> np.ndarray:
        """Label maps + bboxes -> (F, H, W, 3) frames in `output` format.

        `tar_lbl` is (F, H, W, L) one-hot float or an (F, H, W) integer
        class map (expanded to one-hot on the device); `tar_bbox`
        (F, H, W) in any dtype (uint8 0/1 on the wire).
        """
        tar_lbl = torch.as_tensor(tar_lbl, device=self.device)
        tar_bbox = torch.as_tensor(tar_bbox, device=self.device)
        with torch.inference_mode():
            outs = [self._decode(tar_lbl[lo:lo + self.chunk],
                                 tar_bbox[lo:lo + self.chunk])
                    for lo in range(0, int(tar_lbl.shape[0]), self.chunk)]
        return torch.cat(outs).cpu().numpy()

    @staticmethod
    def _extent_bbox(xs: torch.Tensor, ys: torch.Tensor, hw: int
                     ) -> torch.Tensor:
        """Extent + 1/16-margin bbox masks (F, hw, hw) f32 of keypoint
        sets xs, ys (F, K) (the device form of `data.face.face_bbox_mask`,
        as the JAX session computes it)."""
        margin = hw // 16
        x_min = torch.clamp(torch.amin(xs, dim=1) - margin, 0, hw)
        x_max = torch.clamp(torch.amax(xs, dim=1) + margin, 0, hw)
        y_min = torch.clamp(torch.amin(ys, dim=1) - margin, 0, hw)
        y_max = torch.clamp(torch.amax(ys, dim=1) + margin, 0, hw)
        pos = torch.arange(hw, dtype=torch.float32, device=xs.device)
        in_x = ((pos[None, None, :] >= x_min[:, None, None])
                & (pos[None, None, :] < x_max[:, None, None]))
        in_y = ((pos[None, :, None] >= y_min[:, None, None])
                & (pos[None, :, None] < y_max[:, None, None]))
        return (in_x & in_y).float()

    def _rasterize(self, kp: torch.Tensor, bw: torch.Tensor):
        """One chunk of keypoints -> (class maps (F, hw, hw), bboxes)."""
        hw = self.mods.cfg.image_size
        if self.mods.cfg.task == "face":
            return (rasterize_face_clip(kp, bw, hw, hw),
                    self._extent_bbox(kp[..., 0], kp[..., 1], hw))
        lbl = rasterize_pose_clip(kp[:, :25], kp[:, 25:95], kp[:, 95:116],
                                  kp[:, 116:137], bw,
                                  torch.clamp(bw / 3.0, min=1.0), hw, hw)
        # the extent over the detected points only
        valid = (kp != 0).all(dim=-1)
        inf = torch.tensor(float("inf"), device=kp.device)
        lo = torch.where(valid[..., None], kp, inf).amin(dim=1)
        hi = torch.where(valid[..., None], kp, -inf).amax(dim=1)
        return lbl, self._extent_bbox(torch.stack([lo[:, 0], hi[:, 0]], 1),
                                      torch.stack([lo[:, 1], hi[:, 1]], 1),
                                      hw)

    def push_keypoints(self, keypoints, bw=None) -> np.ndarray:
        """Crop-local keypoints -> (F, H, W, 3) frames in `output` format,
        rasterized on the device with brush widths `bw` (F,) (default 1;
        the pose task's hands and face take max(bw / 3, 1)). Face task:
        (F, 68, 2) landmarks; pose task: (F, 137, 2) validated OpenPose
        points (zeros: not detected), pose 25 | face 70 | hand_l 21 |
        hand_r 21. Raises ValueError on another shape (the rasterizer
        gathers by point index, which on the GPU would fail inside a
        kernel)."""
        n_pts = 68 if self.mods.cfg.task == "face" else 137
        kp = torch.as_tensor(keypoints, dtype=torch.float32)
        if kp.dim() != 3 or tuple(kp.shape[1:]) != (n_pts, 2):
            raise ValueError(f"keypoints must be (F, {n_pts}, 2), got "
                             f"{tuple(kp.shape)}")
        kp = kp.to(self.device)
        f = int(kp.shape[0])
        bw = (torch.ones(f, device=self.device) if bw is None else
              torch.as_tensor(bw, dtype=torch.float32, device=self.device))
        outs = []
        with torch.inference_mode():
            for lo in range(0, f, self.chunk):
                outs.append(self._decode(*self._rasterize(
                    kp[lo:lo + self.chunk], bw[lo:lo + self.chunk])))
        return torch.cat(outs).cpu().numpy()
