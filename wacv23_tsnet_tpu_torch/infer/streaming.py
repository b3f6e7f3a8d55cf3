"""Streaming retargeting sessions (counterpart of the JAX package's
`infer/streaming.py:RetargetSession`, label-driven path).

A session encodes the reference frames once and keeps their feature pack
on the device; callers then stream driving label maps in chunks and get
synthesized frames back. `output="model"` returns f32 model-space frames;
`output="display"` converts on the device to `round(clip(rec*255 +
img_mean))` uint8 frames in the model's BGR order, a quarter of the bytes
to copy back.

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

from ..device import resolve_device
from ..models.tsnet import TSNetModules, decode_with_sources, encode_sources


class RetargetSession:
    def __init__(self, mods: TSNetModules, src_img, src_lbl, src_bbox,
                 chunk: int = 32, output: str = "model", device="cuda"):
        """src_img (S, H, W, 3) model space, src_lbl (S, H, W, L) one-hot,
        src_bbox (S, H, W): numpy arrays or tensors, moved to `device`,
        where `mods` must live."""
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
        self._mean = torch.as_tensor(mods.cfg.img_mean_array(), device=dev)
        self.src_pack = encode_sources(
            mods, *(torch.as_tensor(x, device=dev)
                    for x in (src_img, src_lbl, src_bbox)))

    def _finish(self, rec: torch.Tensor) -> torch.Tensor:
        if self.output == "display":
            return torch.clamp(torch.round(rec * 255.0 + self._mean),
                               0.0, 255.0).to(torch.uint8)
        return rec

    def push_labels(self, tar_lbl, tar_bbox) -> np.ndarray:
        """Label maps + bboxes -> (F, H, W, 3) frames in `output` format.

        `tar_lbl` is (F, H, W, L) one-hot float or an (F, H, W) integer
        class map (expanded to one-hot on the device); `tar_bbox`
        (F, H, W) in any dtype (uint8 0/1 on the wire).
        """
        tar_lbl = torch.as_tensor(tar_lbl, device=self.device)
        tar_bbox = torch.as_tensor(tar_bbox, device=self.device)
        outs = []
        with torch.inference_mode():
            for lo in range(0, int(tar_lbl.shape[0]), self.chunk):
                lbl = tar_lbl[lo:lo + self.chunk]
                if lbl.dim() == 3:
                    lbl = F.one_hot(lbl.long(), self.mods.cfg.label_nc)
                rec = decode_with_sources(self.mods, self.src_pack,
                                          lbl.float(),
                                          tar_bbox[lo:lo + self.chunk].float())
                outs.append(self._finish(rec))
        return torch.cat(outs).cpu().numpy()
