"""Convert torchvision's VGG19 conv weights to the npz the perceptual
loss reads (the port's counterpart of the JAX package's
`compat/export_vgg19.py`).

    python -m wacv23_tsnet_tpu_torch.compat.export_vgg19 --out weights/vgg19_features.npz

needs torchvision (imported by the CLI only) and its ImageNet weights.
Only the 13 convs up to conv5_1 are kept: the reference slices
`vgg19(pretrained=True).features` at relu{1..5}_1. The npz holds
`conv{i}_kernel` (HWIO) and `conv{i}_bias`; `nn.vgg.load_vgg19_npz` and
the JAX package's loader both read it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch.nn as nn

# torchvision `features` indices of the 13 convs up to conv5_1
TORCHVISION_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28)


def convert(features: nn.Sequential) -> dict[str, np.ndarray]:
    """{conv{i}_kernel (HWIO), conv{i}_bias} of a module in torchvision's
    VGG19 `features` layout."""
    arrays = {}
    for i, idx in enumerate(TORCHVISION_CONV_IDS):
        conv = features[idx]
        if not isinstance(conv, nn.Conv2d):
            raise ValueError(f"features[{idx}] is {type(conv).__name__}, "
                             "not a Conv2d: not torchvision's VGG19 layout")
        arrays[f"conv{i}_kernel"] = (
            conv.weight.detach().cpu().numpy().transpose(2, 3, 1, 0))
        arrays[f"conv{i}_bias"] = conv.bias.detach().cpu().numpy()
    return arrays


def export(out_path: str) -> None:
    from torchvision import models

    features = models.vgg19(
        weights=models.VGG19_Weights.IMAGENET1K_V1).features
    arrays = convert(features)
    np.savez(out_path, **arrays)
    print(f"wrote {out_path} ({len(arrays)} arrays)")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="weights/vgg19_features.npz")
    export(p.parse_args(argv).out)


if __name__ == "__main__":
    main()
