"""The port's VGG19 export (`compat/export_vgg19.py`): a module in
torchvision's VGG19 `features` layout, converted to the npz, read back by
both packages' loaders, gives the source module's features (CPU).

torchvision is not needed: the test builds the `features` Sequential
itself (convs at `TORCHVISION_CONV_IDS`, ReLUs and max-pools between, as
torchvision's `vgg19().features`) with seeded weights. The port's
`VGG19Features` and the JAX package's, loaded from the npz, are held
against that module's relu{1..5}_1 activations at 1e-4 of their largest
value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from wacv23_tsnet_tpu.nn import VGG19Features as JVGG
from wacv23_tsnet_tpu.nn.vgg import load_vgg19_params as j_load_vgg19_params
from wacv23_tsnet_tpu_torch.compat import export_vgg19
from wacv23_tsnet_tpu_torch.compat.flax_params import load_flax_params
from wacv23_tsnet_tpu_torch.nn.vgg import VGG19Features, load_vgg19_npz

torch.set_num_threads(2)
# torchvision's vgg19 "E" layout up to conv5_1; "M" is a max-pool
CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
       512, "M", 512)
# the relu after conv1_1, conv2_1, conv3_1, conv4_1, conv5_1
RELU_TAPS = (1, 6, 11, 20, 29)


def torchvision_features(seed: int = 0) -> nn.Sequential:
    gen = torch.Generator().manual_seed(seed)
    layers, c = [], 3
    for v in CFG:
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
            continue
        conv = nn.Conv2d(c, v, 3, padding=1)
        with torch.no_grad():
            conv.weight.normal_(0.0, (2.0 / (9 * c)) ** 0.5, generator=gen)
            conv.bias.normal_(0.0, 0.01, generator=gen)
        layers += [conv, nn.ReLU()]
        c = v
    return nn.Sequential(*layers)


def test_conv_ids_are_torchvision_layout():
    feats = torchvision_features()
    ids = tuple(i for i, m in enumerate(feats) if isinstance(m, nn.Conv2d))
    assert ids == export_vgg19.TORCHVISION_CONV_IDS
    with pytest.raises(ValueError, match="not a Conv2d"):
        export_vgg19.convert(nn.Sequential(*list(feats)[1:]))


def test_npz_read_by_both_loaders_gives_the_source_features(tmp_path):
    feats = torchvision_features()
    arrays = export_vgg19.convert(feats)
    assert len(arrays) == 26
    assert arrays["conv0_kernel"].shape == (3, 3, 3, 64)
    path = tmp_path / "vgg19_features.npz"
    np.savez(path, **arrays)

    x = np.random.default_rng(2).random((2, 64, 64, 3), np.float32)
    want, h = [], torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        for i, layer in enumerate(feats):
            h = layer(h)
            if i in RELU_TAPS:
                want.append(h.permute(0, 2, 3, 1).numpy())

    ours = VGG19Features()
    load_flax_params(ours, load_vgg19_npz(path))
    with torch.no_grad():
        got = [t.numpy() for t in ours(torch.from_numpy(x))]
    jvgg = JVGG()
    theirs = jvgg.apply(j_load_vgg19_params(str(path)), jnp.asarray(x))
    assert len(got) == len(theirs) == len(want) == 5
    for g, j, w in zip(got, theirs, want):
        scale = float(np.abs(w).max())
        assert np.abs(g - w).max() <= 1e-4 * scale
        assert np.abs(np.asarray(j) - w).max() <= 1e-4 * scale
