"""The GAN training loop (counterpart of the JAX package's
`train/loop.py`; reference train_face.py:221-380).

Each loaded batch is a (B, T)-frame clip: frames 0 .. n_source-1 are the
shared sources, and frames n_source .. T-1 are successive targets, so a
clip gives T - n_source optimizer steps. The poly LR advances per step,
counted in examples; snapshots (`TSNet_S%06d.msgpack`, the JAX package's
format), image shots and `history.csv` rows fire on the JAX package's
counters.

Feeding keeps the host out of the device's way:
- frames cross as uint8 (BGR pixels, class maps, 0/1 bboxes), and the
  device expands them (mean subtracted, /255, one-hot);
- a clip's sources cross once, not once per target step;
- per-step metrics stay on the device and are copied in one stacked
  transfer at print, image-shot and snapshot boundaries.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import TrainConfig, TSNetConfig
from ..data.codecs import labels_to_image
from ..data.image_io import write_png
from ..infer.pipeline import montage_row, to_display_rgb
from ..models.api import TSNet
from ..utils import AverageMeter, StepTimer
from .checkpoint import save_checkpoint


def _expand(img_u8: torch.Tensor, lbl_u8: torch.Tensor,
            bbox_u8: torch.Tensor, mean: torch.Tensor, label_nc: int):
    """uint8 device tensors -> model space: (BGR - mean) / 255, one-hot
    labels, float bboxes."""
    img = (img_u8.float() - mean) / 255.0
    lbl = F.one_hot(lbl_u8.long(), label_nc).float()
    return img, lbl, bbox_u8.float()


def _nhwc_u8(imgs_ds: np.ndarray, mean: np.ndarray) -> np.ndarray:
    """Dataset-space (C-first, BGR - mean) floats -> raw uint8 NHWC."""
    raw = imgs_ds.transpose(0, 2, 3, 1) + mean
    return np.clip(np.rint(raw), 0, 255).astype(np.uint8)


def run_training(model: TSNet, loader, cfg: TSNetConfig, tcfg: TrainConfig,
                 final_step: int, start_step: int = 0,
                 snapshot_dir: str = "snapshots",
                 imgshot_dir: str = "imgshots",
                 save_every: int = 1000,
                 n_source: int = 3,
                 history_path: str | None = None,
                 timer: StepTimer | None = None) -> int:
    """Train from `start_step` up to `final_step` optimizer steps; returns
    the step reached. `history_path`, where given, gets one CSV row of
    running-average losses per `print_freq` steps. `timer` (a fresh
    `StepTimer` by default) records each clip batch's wall time and its
    wait for data."""
    os.makedirs(snapshot_dir, exist_ok=True)
    os.makedirs(imgshot_dir, exist_ok=True)
    meters = {name: AverageMeter() for name in model.loss_names}
    timer = timer or StepTimer()
    mean = cfg.img_mean_array()
    mean_dev = torch.as_tensor(mean, device=model.device)
    dev = model.device

    def upload(imgs, lbls, boxes):
        return _expand(torch.from_numpy(imgs).to(dev),
                       torch.from_numpy(lbls.astype(np.uint8)).to(dev),
                       torch.from_numpy(boxes.astype(np.uint8)).to(dev),
                       mean_dev, cfg.label_nc)

    actual_step = start_step
    t0 = time.time()
    pending: list = []   # (device metrics dict, batch size) per step

    def sync_pending():
        if not pending:
            return
        keys = list(pending[0][0])
        stacked = torch.stack([torch.stack([m[k].float() for k in keys])
                               for m, _ in pending]).cpu().tolist()
        for row, (_, bsz) in zip(stacked, pending):
            for k, v in zip(keys, row):
                meters[k].update(v, bsz)
                model._losses[k] = v
        pending.clear()

    while actual_step < final_step:
        for clip in loader:
            timer.mark_data()
            imgs = clip["img"]           # (B, T, 3, H, W) dataset space
            lbls = clip["lbl"]           # (B, T, H, W) class maps
            boxes = clip["bbox"]         # (B, T, H, W) 0/1
            bsz, n_total = imgs.shape[:2]

            src_u8 = np.stack([_nhwc_u8(imgs[:, i], mean)
                               for i in range(n_source)], axis=1)
            src_img, src_lbl, src_bbox = upload(
                src_u8, lbls[:, :n_source], boxes[:, :n_source])
            src_dev = {"src_img": src_img, "src_lbl": src_lbl,
                       "src_bbox": src_bbox}

            for frame_iter in range(n_source, n_total):
                if actual_step >= final_step:
                    break
                model.setup(actual_step, tcfg.batch_size, tcfg.initial_iter,
                            tcfg.max_iter, tcfg.power)
                tar_img, tar_lbl, tar_bbox = upload(
                    _nhwc_u8(imgs[:, frame_iter], mean), lbls[:, frame_iter],
                    boxes[:, frame_iter])
                step_batch = dict(src_dev, tar_img=tar_img, tar_lbl=tar_lbl,
                                  tar_bbox=tar_bbox)
                model.optimize_parameters_on(step_batch)
                pending.append((model._metrics_dev, bsz))
                model._metrics_dev = None   # the loop owns the sync
                actual_step += 1

                if actual_step % tcfg.print_freq == 0:
                    sync_pending()
                    losses = " ".join(
                        f"{k}={m.avg:.3f}" for k, m in meters.items())
                    print(f"step {actual_step}/{final_step} "
                          f"({time.time() - t0:.0f}s) {losses}")
                    model.print_learning_rate()
                    if history_path is not None:
                        header = not os.path.exists(history_path)
                        with open(history_path, "a") as fh:
                            if header:
                                fh.write("step,seconds," + ",".join(
                                    meters) + "\n")
                            fh.write(f"{actual_step},"
                                     f"{time.time() - t0:.1f},"
                                     + ",".join(f"{m.avg:.5f}"
                                                for m in meters.values())
                                     + "\n")

                if actual_step % tcfg.save_img_freq == 0:
                    sync_pending()
                    _save_imgshot(model, imgs, lbls, frame_iter, mean,
                                  imgshot_dir, actual_step, step_batch,
                                  cfg.task)

                if actual_step % save_every == 0:
                    sync_pending()
                    path = os.path.join(
                        snapshot_dir, f"TSNet_S{actual_step:06d}.msgpack")
                    save_checkpoint(path, model.state)
                    print(f"saved snapshot {path}")
            timer.mark_batch()
            if actual_step >= final_step:
                break

    sync_pending()
    path = os.path.join(snapshot_dir, f"TSNet_S{actual_step:06d}.msgpack")
    save_checkpoint(path, model.state)
    print(f"final snapshot {path}; "
          f"avg batch {timer.batch.avg:.3f}s data {timer.data.avg:.3f}s")
    return actual_step


def _save_imgshot(model, imgs, lbls, frame_iter, mean, imgshot_dir, step,
                  step_batch, task):
    """source | target label | target | reconstruction | warp montage.

    `imgs` are dataset space (mean-subtracted, 0..255 scale), so they are
    divided by 255 for `to_display_rgb` (which takes model space);
    `rec_tar_img` and the warp previews are model space already. The
    label column is white face edges, or the pose palette.
    """
    lbl = labels_to_image(lbls[0, frame_iter], task)
    if task == "face":
        lbl = np.repeat(lbl[..., None], 3, axis=-1)
    row = [
        to_display_rgb(imgs[0, 0] / 255.0, mean),
        lbl,
        to_display_rgb(imgs[0, frame_iter] / 255.0, mean),
        to_display_rgb(model.rec_tar_img[0], mean),
        to_display_rgb(model.render_warp_previews(step_batch)[0, 0], mean),
    ]
    write_png(os.path.join(imgshot_dir, f"step_{step:06d}.png"),
              montage_row(row))
