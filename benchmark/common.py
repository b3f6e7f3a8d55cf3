"""What the drivers share: the port's configuration from a cell's files,
the seeded random source, memory, and the comparisons that decide
`correct`."""

from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from .reference.model import Precision

MODEL_KEYS = ("task", "label_nc", "image_size", "n_source", "ngf",
              "n_downsampling", "enc_n_blocks", "dec_n_blocks", "addcoords",
              "softmax_temp", "use_face_d", "use_fg_mask", "use_align_loss",
              "lambda_fml", "lambda_vgg", "lambda_grad", "lambda_con", "ndf",
              "d_n_layers", "img_mean")


def port_config(config: dict, tier: dict):
    """The port's `TSNetConfig` of a configuration file, in a tier
    (`precision`, `fast_trunk`, `fast_tail`, ...)."""
    from wacv23_tsnet_tpu_torch.configs import TSNetConfig
    fields = {k: config[k] for k in MODEL_KEYS}
    fields["img_mean"] = tuple(fields["img_mean"])
    return dataclasses.replace(TSNetConfig(**fields), **tier)


def precision(spec: dict) -> Precision:
    """A reference `Precision` from a cell's `reference` or `control`."""
    return Precision(trunk=spec.get("trunk", "fp32"),
                     tail=spec.get("tail", "fp32"),
                     sim=getattr(torch, spec.get("sim", "float32")),
                     tf32=bool(spec.get("tf32", False)))


def rng(seed: int, stream: int) -> np.random.Generator:
    """The numpy generator of one stream of a seed's inputs."""
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), stream])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def norm_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Per leaf, the gap between the two sides' norms, over the larger of
    the reference leaf's norm and the median leaf's: name -> gap. `keep`
    (a set of names), where given, limits the leaves."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].double().norm()) for k in names}
    med = float(np.median(list(rn.values()))) if rn else 0.0
    out = {}
    for k in names:
        pn = float(prog[k].double().norm())
        out[k] = abs(pn - rn[k]) / max(rn[k], med, 1e-30)
    return out


def live_leaves(grads: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient is not nought to rounding: norm at
    least `share` of the median leaf's."""
    norms = {k: float(g.double().norm()) for k, g in grads.items()}
    med = float(np.median(list(norms.values())))
    return {k for k, v in norms.items() if v >= share * med}


def worst(gaps: dict) -> tuple[float, str]:
    if not gaps:
        return float("nan"), ""
    k = max(gaps, key=gaps.get)
    return gaps[k], k
