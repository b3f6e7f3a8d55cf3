"""The training slice's small modules against the JAX package (CPU, f32).

One parametrised test: each case runs the same numpy inputs (and, for a
module, the same flax weights carried with `compat.flax_params`) through
the JAX function and the port's, and compares the values and the
gradients of one scalar (the outputs dotted with a fixed random
cotangent) with respect to the inputs and, for a module, its parameters.
Each tensor is held within `tol * max(1, max |ref|)`: 1e-5 for the
elementwise ops and losses, 1e-4 for convolution stacks (fp32 sums in
another order). A parameter gradient is scaled by the largest parameter
gradient of its module instead: the bias of a conv in front of an
instance norm has a zero gradient, which both sides return as rounding
noise of sums whose terms are of the kernel gradients' size. An input or
parameter that the function does not use has a zero gradient in JAX and
none in torch. `pytest -s` prints each measured error.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu import losses as jl
from wacv23_tsnet_tpu.losses.gan import gan_loss as j_gan_loss
from wacv23_tsnet_tpu.nn import FuseNet as JFuseNet
from wacv23_tsnet_tpu.nn import PatchDiscriminator as JPatchD
from wacv23_tsnet_tpu.nn import VGG19Features as JVGG
from wacv23_tsnet_tpu.nn.fusenet import fuse_train as j_fuse_train
from wacv23_tsnet_tpu.ops.warp import patch_warp as j_patch_warp
from wacv23_tsnet_tpu_torch import losses as tl
from wacv23_tsnet_tpu_torch.compat import (load_flax_params,
                                           state_dict_to_flax)
from wacv23_tsnet_tpu_torch.nn import (FuseNet, PatchDiscriminator,
                                       VGG19Features, fuse_train)
from wacv23_tsnet_tpu_torch.ops.warp import patch_warp

torch.set_num_threads(2)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _run(jax_fn, port_fn, inputs, seed, params=None, module=None):
    """Values and gradients of both sides. `jax_fn(params, *inputs)` and
    `port_fn(*inputs)` return a list of arrays / tensors; the scalar is
    the sum of each output times a fixed random cotangent."""
    jin = [jnp.asarray(x) for x in inputs]
    outs = jax_fn(params, *jin)
    rng = np.random.default_rng(seed)
    cts = [rng.standard_normal(np.shape(o)).astype(np.float32) for o in outs]

    def scalar(p, *xs):
        return sum(jnp.sum(o * c) for o, c in zip(jax_fn(p, *xs), cts))

    argnums = tuple(range(len(jin) + 1)) if params is not None else tuple(
        range(1, len(jin) + 1))
    grads = jax.grad(scalar, argnums=argnums)(params, *jin)
    want = {f"out{i}": np.asarray(o) for i, o in enumerate(outs)}
    want.update({f"d_in{i}": np.asarray(g) for i, g in
                 enumerate(grads[-len(jin):])})
    if params is not None:
        want.update({f"d_param{k}": v for k, v in _flat(grads[0]).items()})

    tin = [torch.from_numpy(np.asarray(x)).requires_grad_(True)
           for x in inputs]
    touts = port_fn(*tin)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cts)
        ).backward()
    got = {f"out{i}": o.detach().numpy() for i, o in enumerate(touts)}
    got.update({f"d_in{i}": _grad(x) for i, x in enumerate(tin)})
    if module is not None:
        pg = state_dict_to_flax({n: torch.from_numpy(_grad(p)) for n, p in
                                 module.named_parameters()})
        got.update({f"d_param{k}": v for k, v in _flat(pg).items()})
    return got, want


def _grad(x):
    return (x.grad if x.grad is not None else torch.zeros_like(x)).numpy()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def case_patch_warp(rng):
    img = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    flow = rng.uniform(-1.1, 1.1, (2, 4, 4, 2)).astype(np.float32)
    return _run(lambda p, i, f: [j_patch_warp(i, f)],
                lambda i, f: [patch_warp(i, f)], (img, flow), 1), 1e-5


def case_l1_loss(rng):
    a, b = rng.standard_normal((2, 2, 8, 8, 3)).astype(np.float32)
    return _run(lambda p, x, y: [jl.l1_loss(x, y)],
                lambda x, y: [tl.l1_loss(x, y)], (a, b), 2), 1e-5


def case_gradient_loss(rng):
    a, b = rng.standard_normal((2, 2, 16, 16, 3)).astype(np.float32)
    return _run(lambda p, x, y: [jl.gradient_loss(x, y)],
                lambda x, y: [tl.gradient_loss(x, y)], (a, b), 3), 1e-5


def case_cosine_align_loss(rng):
    a, b = rng.standard_normal((2, 2, 8, 8, 16)).astype(np.float32)
    a[0, 0, 0] = 0.0          # a zero feature: the eps clamp
    return _run(lambda p, x, y: [jl.cosine_align_loss(x, y)],
                lambda x, y: [tl.cosine_align_loss(x, y)], (a, b), 4), 1e-5


def case_renorm_to_reference(rng):
    img = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    ref = (rng.standard_normal((2, 16, 16, 3)) * 0.3 + 0.2).astype(np.float32)
    return _run(lambda p, x, y: [jl.renorm_to_reference(x, y)],
                lambda x, y: [tl.renorm_to_reference(x, y)], (img, ref),
                5), 1e-5


def case_lsgan_loss(rng):
    pred = rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
    return _run(lambda p, x: [jl.lsgan_loss(x, True), jl.lsgan_loss(x, False)],
                lambda x: [tl.lsgan_loss(x, True), tl.lsgan_loss(x, False)],
                (pred,), 6), 1e-5


def case_gan_loss(rng):
    pred = rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
    modes = [(m, real) for m in ("lsgan", "vanilla", "wgangp")
             for real in (True, False)]
    return _run(lambda p, x: [j_gan_loss(x, r, m) for m, r in modes],
                lambda x: [tl.gan_loss(x, r, m) for m, r in modes],
                (pred,), 11), 1e-5


def case_feature_matching_loss(rng):
    shapes = [(2, 8, 8, 4), (2, 4, 4, 8), (2, 3, 3, 1)]
    fake = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    real = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return _run(lambda p, *f: [jl.feature_matching_loss(f[:3], f[3:], 10.0)],
                lambda *f: [tl.feature_matching_loss(f[:3], f[3:], 10.0)],
                (*fake, *real), 7), 1e-5


def case_patch_discriminator(rng):
    jmod = JPatchD(ndf=8, n_layers=3)
    params = jmod.init(jax.random.PRNGKey(8), jnp.zeros((1, 64, 64, 5)))
    mod = PatchDiscriminator(5, ndf=8, n_layers=3)
    load_flax_params(mod, _np_tree(params["params"]))
    x = rng.standard_normal((2, 64, 64, 5)).astype(np.float32)
    return _run(lambda p, xx: jmod.apply({"params": p}, xx), mod, (x,), 8,
                params["params"], mod), 1e-4


def case_vgg_perceptual(rng):
    jmod = JVGG()
    params = jmod.init(jax.random.PRNGKey(9), jnp.zeros((1, 32, 32, 3)))
    mod = VGG19Features()
    load_flax_params(mod, _np_tree(params["params"]))
    fake, real = rng.standard_normal((2, 2, 32, 32, 3)).astype(np.float32)

    def jfn(p, f, r):
        return jmod.apply({"params": p}, f) + [
            jl.vgg_perceptual_loss(jmod, {"params": p}, f, r)]

    def tfn(f, r):
        return mod(f) + [tl.vgg_perceptual_loss(mod, f, r)]
    return _run(jfn, tfn, (fake, real), 9, params["params"], mod), 1e-4


def case_fuse_train(rng):
    c = 16
    jmod = JFuseNet(ngf=2 * c, n_blocks=1)
    z = jnp.zeros((1, 8, 8, c))
    params = jmod.init(jax.random.PRNGKey(10), z, z)["params"]
    mod = FuseNet(ngf=2 * c, n_blocks=1)
    load_flax_params(mod, _np_tree(params))
    src = rng.standard_normal((2, 3, 8, 8, c)).astype(np.float32)
    tar = rng.standard_normal((2, 8, 8, c)).astype(np.float32)
    return _run(lambda p, s, t: [j_fuse_train(p, s, t, use_pallas=True)],
                lambda s, t: [fuse_train(mod, s, t)], (src, tar), 10,
                params, mod), 1e-4


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_module_matches_jax(name):
    (got, want), tol = CASES[name](np.random.default_rng(0))
    assert got.keys() == want.keys(), set(got) ^ set(want)
    param_scale = max([np.abs(v).max() for k, v in want.items()
                       if k.startswith("d_param")] + [1.0])
    errs = {}
    for key, ref in want.items():
        assert got[key].shape == ref.shape, key
        scale = (param_scale if key.startswith("d_param")
                 else max(1.0, np.abs(ref).max()))
        errs[key] = float(np.abs(got[key] - ref).max() / scale)
    worst = max(errs, key=errs.get)
    print(f"[parity] {os.environ.get('PYTEST_CURRENT_TEST', '').split()[0]}:"
          f" {len(errs)} tensors, worst {worst}={errs[worst]:.3e}")
    assert errs[worst] <= tol, (worst, errs[worst])
