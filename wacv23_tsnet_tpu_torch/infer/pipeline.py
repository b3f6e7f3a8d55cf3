"""Whole-clip inference and its output helpers (counterpart of the JAX
package's `infer/pipeline.py`).

`ClipInference` encodes a job's S source frames once (`encode_sources`)
and runs the driving clip against that pack in fixed chunks of frames
(the last one padded by wrapping round the clip, as the JAX package does
so that jit compiles one program), each chunk through
`decode_with_sources`: K3-nf + K2 in the bit-parity tier, K1 + K2 in the
bench tier (`fast_tail`). The pack lives for the job only; the next job
encodes its own. `utils.profiling.CLIP_PACKS` counts the chunks decoded
on a pack encoded for them (a job's first) and on one reused.
Under a profiler a job is the span `tsnet.clip.run` (the unit), holding
`tsnet.clip.upload` (the sources, one-hot labels and boxes to the device),
`tsnet.encode_sources` once, each chunk's model stages (`models.tsnet`)
and `tsnet.clip.copy_back` (the frames to the host).
On a CUDA device each chunk's frames go to the host while the next chunk
computes: a copy stream of the engine's own copies them into one of two
pinned host slots, which the host empties into the job's array once the
next chunk is enqueued, so `tsnet.clip.copy_back` holds only the last
chunk's copy and move. Elsewhere the frames stay on the device until the
clip is done and go to the host in one copy.
`run_renormalized` also renormalizes each frame to the first reference's
mean and unbiased std on the device (reference demo/demo_face.py:178-198).
`to_display_rgb` and `montage_row` make the uint8 frames that
`data.image_io.write_png` writes, and `save_gif` animates them
(`data.gif`).
"""

from __future__ import annotations

import mmap
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..compat.flax_params import load_flax_params
from ..configs import TSNetConfig
from ..data.gif import write_gif
from ..device import resolve_device
from ..models.tsnet import (GEN_SUBNETS, TSNetModules, decode_with_sources,
                            encode_sources)
from ..utils.profiling import CLIP_COPIES, CLIP_PACKS, span


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
        self._staging: _PinnedSlots | None = None

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

    def _forward(self, src, pack, tar_lbl, tar_bbox) -> torch.Tensor:
        return decode_with_sources(self.mods, pack, tar_lbl, tar_bbox,
                                   use_kernels=self.use_kernels)

    def _renormalized(self, src, pack, tar_lbl, tar_bbox) -> torch.Tensor:
        rec = self._forward(src, pack, tar_lbl, tar_bbox)
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
            if dev.type == "cuda":
                if self._staging is None:
                    self._staging = _PinnedSlots(dev)
                frames = _StagedFrames(self._staging, f, self.chunk)
            else:
                frames = _PlainFrames()
            with torch.inference_mode():
                pack = encode_sources(self.mods, *src,     # once a job
                                      use_kernels=self.use_kernels)
                for lo in range(0, f, self.chunk):
                    idx = torch.arange(lo, lo + self.chunk,
                                       device=dev) % f   # pad by wrapping
                    rec = fn(src, pack, tar_lbl[idx], tar_bbox[idx])
                    CLIP_PACKS["reused" if lo else "encoded"] += 1
                    frames.put(rec[:min(self.chunk, f - lo)])
                with span("tsnet.clip.copy_back", dev):
                    return frames.finish()

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


# pages touched between two looks at a chunk's copy (1 MiB at 4-KiB pages)
FAULT_PIECE_PAGES = 256


class _PlainFrames:
    """A clip's frames kept on the device chunk by chunk, then copied to
    fresh host memory in one copy when the clip is done."""

    def __init__(self):
        self.outs: list[torch.Tensor] = []

    def put(self, rec: torch.Tensor) -> None:
        self.outs.append(rec)

    def finish(self) -> np.ndarray:
        CLIP_COPIES["plain"] += len(self.outs)
        return torch.cat(self.outs).permute(0, 3, 1, 2).cpu().numpy()


class _PinnedSlots:
    """Two pinned host slots of one chunk's (chunk, H, W, C) frames and a
    CUDA stream for the copies into them, made at an engine's first job
    on the card and again only when the chunk's frame shape or dtype
    changes."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots: tuple[torch.Tensor, ...] = ()

    def get(self, shape: tuple, dtype: torch.dtype) -> tuple:
        if (not self.slots or self.slots[0].shape != shape
                or self.slots[0].dtype != dtype):
            self.slots = tuple(torch.empty(shape, dtype=dtype,
                                           pin_memory=True) for _ in range(2))
        return self.slots


class _StagedFrames:
    """A clip's frames on their way to the host while the next chunk
    computes. Each chunk, once enqueued, is copied on the slots' stream
    (after the compute stream's work so far) into slot i % 2. Once the
    next chunk is enqueued and its copy issued, the host waits for this
    chunk's copy: meanwhile it touches the fresh pages of the chunk's
    share of the job's array a piece at a time, so that page faults hold
    up the move less, and stops as soon as the copy is done. Then it
    moves the slot into the array: a slot is refilled only once emptied.
    The chunk's device frames are held until then, so their memory is
    not reused while the copy reads it. `finish` makes the compute
    stream wait for the last copy and moves the last slot: all that is
    left once the last chunk is computed."""

    def __init__(self, staging: _PinnedSlots, frames: int, chunk: int):
        self.staging, self.frames, self.chunk = staging, frames, chunk
        self.out: torch.Tensor | None = None
        self.pending = None     # (slot, lo, n, copy done, device frames)
        self.lo = self.count = 0

    def put(self, rec: torch.Tensor) -> None:
        if self.out is None:
            self.out = torch.empty((self.frames, *rec.shape[1:]),
                                   dtype=rec.dtype)
        slots = self.staging.get((self.chunk, *rec.shape[1:]), rec.dtype)
        slot, n = slots[self.count % 2], rec.shape[0]
        copy = self.staging.stream
        copy.wait_stream(torch.cuda.current_stream(self.staging.device))
        with torch.cuda.stream(copy):
            slot[:n].copy_(rec, non_blocking=True)
        done = copy.record_event()
        if self.pending is not None:
            self._drain()
        self.pending = (slot, self.lo, n, done, rec)
        self.lo += n
        self.count += 1

    def _drain(self) -> None:
        slot, lo, n, done, _ = self.pending
        dst = self.out[lo:lo + n]
        pages = dst.view(-1)[::mmap.PAGESIZE // dst.element_size()]
        for piece in pages.split(FAULT_PIECE_PAGES):
            if done.query():
                break
            piece.zero_()
        done.synchronize()
        dst.copy_(slot[:n])
        self.pending = None

    def finish(self) -> np.ndarray:
        torch.cuda.current_stream(self.staging.device).wait_event(
            self.pending[3])
        self._drain()
        CLIP_COPIES["staged"] += self.count
        return self.out.permute(0, 3, 1, 2).numpy()


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
