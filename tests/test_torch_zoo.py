"""The port's network zoo against the JAX package's (CPU, the sizes of
tests/test_zoo.py): generators, discriminators, the WGAN-GP penalty, the
schedules, the norm and init factories. Weights are carried from JAX with
`compat.flax_params`. `pytest -s` prints each measured error."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wacv23_tsnet_tpu.losses.gan import gradient_penalty as j_penalty
from wacv23_tsnet_tpu.nn import (PixelDiscriminator as JPixel,
                                 VideoDiscriminator as JVideo,
                                 define_D as j_define_D,
                                 define_G as j_define_G)
from wacv23_tsnet_tpu.nn.blocks import get_norm_layer as j_norm_layer
from wacv23_tsnet_tpu.train.schedule import PlateauScale as JPlateau
from wacv23_tsnet_tpu.train.schedule import get_scheduler as j_scheduler
from wacv23_tsnet_tpu_torch.compat import (export_flax_params,
                                           gather_flax_trees,
                                           load_flax_params, shard_flax_tree)
from wacv23_tsnet_tpu_torch.losses import gradient_penalty
from wacv23_tsnet_tpu_torch.nn import (PixelDiscriminator, VideoDiscriminator,
                                       define_D, define_G, get_initializer,
                                       get_norm_layer)
from wacv23_tsnet_tpu_torch.train import PlateauScale, get_scheduler

torch.set_num_threads(2)


def _report(name, **errors):
    print(f"[zoo] {name}: " + " ".join(f"{k}={v:.3e}"
                                       for k, v in errors.items()))


def _x(shape, seed):
    return np.random.default_rng(seed).random(shape, np.float32)


@pytest.mark.parametrize("name,size", [("resnet_6blocks", 64),
                                       ("resnet_9blocks", 32),
                                       ("unet_128", 128), ("unet_256", 256)])
def test_generator_zoo_matches_jax(name, size):
    x = _x((1, size, size, 3), 1)
    jg = j_define_G(3, 16, name)
    params = jg.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jg.apply(params, jnp.asarray(x)))
    g = define_G(3, 3, 16, name, device="cpu")
    load_flax_params(g, params["params"])
    with torch.no_grad():
        got = g(torch.from_numpy(x)).numpy()
    _report(name, max_abs=float(np.abs(got - want).max()))
    assert got.shape == (1, size, size, 3)
    assert np.abs(got - want).max() <= 1e-5
    # and back: the port's tree is the JAX tree
    back = export_flax_params(g)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))


def _disc_cases():
    return {
        "pixel": (lambda: JPixel(ndf=8),
                  lambda: PixelDiscriminator(3, ndf=8), (2, 64, 64, 3)),
        "video": (lambda: JVideo(out_nc=16, ndf=8),
                  lambda: VideoDiscriminator(3, out_nc=16, ndf=8),
                  (2, 256, 256, 3)),
        "define_D n_layers": (lambda: j_define_D(8, "n_layers", n_layers_d=2),
                              lambda: define_D(3, 8, "n_layers", n_layers_d=2,
                                               device="cpu"),
                              (2, 64, 64, 3)),
        "define_D pixel": (lambda: j_define_D(8, "pixel"),
                           lambda: define_D(3, 8, "pixel", device="cpu"),
                           (2, 64, 64, 3)),
    }


@pytest.mark.parametrize("case", list(_disc_cases()))
def test_discriminator_zoo_matches_jax(case):
    make_j, make_t, shape = _disc_cases()[case]
    x = _x(shape, 2)
    jd = make_j()
    params = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jd.apply(params, jnp.asarray(x))
    d = make_t()
    load_flax_params(d, params["params"])
    with torch.no_grad():
        got = d(torch.from_numpy(x))
    wants = want if isinstance(want, list) else [want]
    gots = got if isinstance(got, list) else [got]
    assert len(gots) == len(wants)
    err = max(float(np.abs(g.numpy() - np.asarray(w)).max())
              for g, w in zip(gots, wants))
    _report(case, max_abs=err)
    assert [tuple(g.shape) for g in gots] == [w.shape for w in wants]
    assert err <= 1e-5


@pytest.mark.parametrize("kind", ["real", "fake", "mixed"])
def test_gradient_penalty_matches_jax(kind):
    """The same PixelGAN weights and the same alpha: <=1e-5 relative; the
    penalty backpropagates into the discriminator."""
    x = _x((3, 16, 16, 3), 3)
    fake = x * 0.5 + 0.1
    jd = JPixel(ndf=4)
    params = jd.init(jax.random.PRNGKey(0), jnp.asarray(x))
    key = jax.random.PRNGKey(1)
    alpha = np.asarray(jax.random.uniform(key, (3, 1, 1, 1))).reshape(3)
    want = float(j_penalty(lambda z: jd.apply(params, z), jnp.asarray(x),
                           jnp.asarray(fake), key, kind=kind))
    d = PixelDiscriminator(3, ndf=4)
    load_flax_params(d, params["params"])
    got = gradient_penalty(d, torch.from_numpy(x), torch.from_numpy(fake),
                           alpha=torch.from_numpy(alpha), kind=kind)
    got.backward()
    rel = abs(float(got) - want) / abs(want)
    _report(f"gradient_penalty {kind}", penalty=float(got), rel=rel)
    assert rel <= 1e-5
    # the last conv's bias shifts D's output, not its input gradient
    assert d.conv2.bias.grad is None
    assert all(torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0
               for p in (d.conv0.weight, d.conv1.weight, d.conv2.weight))


def test_gradient_penalty_alpha_from_a_generator():
    """`alpha` as a torch.Generator draws one weight a sample, the same
    for the same seed; lambda_gp <= 0 gives 0; an unknown kind raises."""
    d = PixelDiscriminator(3, ndf=4)
    x = torch.from_numpy(_x((2, 8, 8, 3), 4))
    a = gradient_penalty(d, x, x * 0.3, alpha=torch.Generator().manual_seed(7))
    b = gradient_penalty(d, x, x * 0.3, alpha=torch.Generator().manual_seed(7))
    w = torch.rand(2, generator=torch.Generator().manual_seed(7))
    c = gradient_penalty(d, x, x * 0.3, alpha=w)
    assert float(a) == float(b) == float(c) > 0.0
    assert float(gradient_penalty(d, x, x, lambda_gp=0.0)) == 0.0
    with pytest.raises(NotImplementedError, match="bogus"):
        gradient_penalty(d, x, x, kind="bogus")


@pytest.mark.parametrize("policy,kw", [
    ("linear", dict(n_epochs=10, n_epochs_decay=10, steps_per_epoch=2)),
    ("linear", dict(n_epochs=7, n_epochs_decay=19, epoch_count=3)),
    ("step", dict(lr_decay_iters=5)),
    ("cosine", dict(n_epochs=10)),
    ("cosine", dict(n_epochs=13, steps_per_epoch=3)),
])
def test_scheduler_matches_jax(policy, kw):
    """Each policy over steps 0-40: <=1e-7 relative."""
    want_fn, got_fn = j_scheduler(policy, 1e-3, **kw), get_scheduler(
        policy, 1e-3, **kw)
    worst = 0.0
    for step in range(41):
        want, got = float(want_fn(step)), got_fn(step)
        worst = max(worst, abs(got - want) / max(abs(want), 1e-30)
                    if want else abs(got))
    _report(f"{policy} {kw}", rel=worst)
    assert worst <= 1e-7
    with pytest.raises(NotImplementedError, match="plateau"):
        get_scheduler("plateau", 1e-3)


def test_plateau_scale_matches_jax():
    metrics = [1.0, 0.9, 0.95, 0.95, 0.95, 0.5, 0.5, 0.5, 0.49, 0.6, 0.7,
               0.7, 0.7, 0.1]
    for patience in (0, 1, 2):
        j, p = JPlateau(1e-3, patience=patience), PlateauScale(
            1e-3, patience=patience)
        assert [p.update(m) for m in metrics] == \
               [j.update(m) for m in metrics]


def test_norm_layer_matches_jax():
    x = _x((2, 8, 8, 4), 5)
    got = get_norm_layer("instance")(torch.from_numpy(x)).numpy()
    want = np.asarray(j_norm_layer("instance")(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-5
    np.testing.assert_array_equal(
        get_norm_layer("none")(torch.from_numpy(x)).numpy(), x)
    for name in ("batch", "layer"):
        with pytest.raises(NotImplementedError) as want_err:
            j_norm_layer(name)
        with pytest.raises(NotImplementedError) as got_err:
            get_norm_layer(name)
        assert str(got_err.value) == str(want_err.value)


@pytest.mark.parametrize("shape", [(64, 32, 3, 3), (8, 64, 4, 4)])
def test_initializer_statistics(shape):
    """normal: std = gain; xavier / kaiming: flax's truncated-normal
    variance scaling (std within 5%, nothing past 2 truncated stds);
    orthogonal: orthonormal rows (or columns) times the gain, to 1e-5;
    one seed gives one kernel."""
    o, i, kh, kw = shape
    fan_in, fan_out = i * kh * kw, o * kh * kw
    for kind, gain, std in (
            ("normal", 0.02, 0.02),
            ("xavier", 0.02, 0.02 * (2.0 / (fan_in + fan_out)) ** 0.5),
            ("kaiming", 0.02, (2.0 / fan_in) ** 0.5)):
        init = get_initializer(kind, gain)
        w = init(torch.empty(shape), torch.Generator().manual_seed(0))
        again = init(torch.empty(shape), torch.Generator().manual_seed(0))
        assert torch.equal(w, again)
        assert abs(float(w.std()) / std - 1.0) <= 0.05, (kind, float(w.std()))
        if kind != "normal":
            assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978
    w = get_initializer("orthogonal", 0.5)(torch.empty(shape),
                                           torch.Generator().manual_seed(1))
    m = w.reshape(o, -1).double()
    gram = m @ m.T if o <= m.shape[1] else m.T @ m
    err = float((gram - 0.25 * torch.eye(gram.shape[0],
                                         dtype=torch.float64)).abs().max())
    _report(f"orthogonal {shape}", max_abs=err)
    assert err <= 1e-5
    with pytest.raises(NotImplementedError, match="bogus"):
        get_initializer("bogus")


def test_zoo_factories_default_to_cuda_and_tp_trees():
    """`define_G` / `define_D` refuse without CUDA unless asked for the
    CPU, and refuse an unknown name; the flax tree of a TP rank's share
    gathers back to the full tree."""
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        define_G(3, 3, 8, "resnet_6blocks")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        define_D(3, 8, "pixel")
    with pytest.raises(NotImplementedError, match="bogus"):
        define_G(3, 3, 8, "bogus", device="cpu")
    with pytest.raises(NotImplementedError, match="bogus"):
        define_D(3, 8, "bogus", device="cpu")
    tree = export_flax_params(define_G(3, 3, 8, "resnet_6blocks",
                                       device="cpu"))
    shares = [shard_flax_tree(tree, i, 2) for i in range(2)]
    assert shares[0]["block0"]["conv1"]["kernel"].shape == (3, 3, 32, 16)
    assert shares[0]["block0"]["conv2"]["kernel"].shape == (3, 3, 16, 32)
    assert shares[1]["conv_in"]["kernel"].shape == (7, 7, 3, 8)
    back = gather_flax_trees(shares)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
