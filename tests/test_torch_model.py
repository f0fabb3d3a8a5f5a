"""The port's denoise CNN against the Flax one, on the same weights.

Flax variables come from ``init_variables`` (the full widths), with
BatchNorm scales, biases and batch statistics set from a seed so that every
converted leaf matters, and are carried across by
``convert.denoise_state_dict_from_flax``. Tolerances: the output (in [0, 1])
within 1e-4 absolute, in eval mode and for a training-mode forward, whose
updated running statistics are held within rtol 1e-4 (atol 1e-5 for means
near 0). In training the batch variance of Flax is E[x^2] - E[x]^2 and the
port's the two-pass one, so outputs near 0 differ by more than 1e-4
relative. Preprocessing within rtol 1e-6. The cases of tests/test_model.py
follow on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from pathtrace_tpu.models.denoise_cnn import DenoiseCNN as FlaxDenoiseCNN
from pathtrace_tpu.models.denoise_cnn import init_variables
from pathtrace_tpu.models.preprocess import preprocess_channels as jax_preprocess_channels
from pathtrace_tpu.models.preprocess import preprocess_target as jax_preprocess_target

from pathtrace_tpu_torch.config import CHANNEL_NAMES, NUM_CHANNELS
from pathtrace_tpu_torch.convert import denoise_state_dict_from_flax
from pathtrace_tpu_torch.models import (DenoiseCNN, ResidualBlock, init_model,
                                        preprocess_channels, preprocess_target)
from pathtrace_tpu_torch.models.denoise_cnn import BatchNorm, SameConv2d
from pathtrace_tpu_torch.models.preprocess import EPSILON
from pathtrace_tpu_torch.train import load_checkpoint, save_checkpoint

SIZES = [(64, 64), (96, 160), (50, 70)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb_bn(variables, seed=0):
    """Variables with every BatchNorm scale, bias, mean and variance drawn
    from a seed (Flax's init leaves them 1, 0, 0, 1)."""
    rng = np.random.default_rng(seed)
    tree = _np_tree(variables)

    def walk(params, stats):
        for key in params:
            if key.startswith("BatchNorm"):
                c = params[key]["scale"].shape
                params[key]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                params[key]["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
                stats[key]["mean"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
                stats[key]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(params[key], dict) and key in stats:
                walk(params[key], stats[key])

    walk(tree["params"], tree["batch_stats"])
    return tree


@pytest.fixture(scope="module")
def flax_full():
    model, variables = init_variables(jax.random.key(0))
    variables = _perturb_bn(variables)
    port = DenoiseCNN()
    port.load_state_dict(denoise_state_dict_from_flax(variables))
    return model, variables, port.eval()


def _inputs(shape, seed):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def test_channel_constants_match_jax():
    from pathtrace_tpu import config as jax_config

    assert NUM_CHANNELS == jax_config.NUM_CHANNELS
    assert CHANNEL_NAMES == jax_config.CHANNEL_NAMES


def test_state_dict_keys_are_the_flax_paths(flax_full):
    _, variables, port = flax_full
    converted = denoise_state_dict_from_flax(variables)
    assert set(converted) == set(port.state_dict())
    assert "block1.Conv_0.weight" in converted and "backwards_65.weight" in converted
    assert converted["block1.BatchNorm_2.running_var"].shape == (32,)
    assert int(converted["block3.BatchNorm_1.num_batches_tracked"]) == 0
    # HWIO -> OIHW
    kernel = variables["params"]["block2"]["Conv_1"]["kernel"]
    np.testing.assert_array_equal(converted["block2.Conv_1.weight"].numpy(),
                                  np.transpose(kernel, (3, 2, 0, 1)))


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_eval_forward_matches_flax(flax_full, size):
    model, variables, port = flax_full
    x = _inputs((1,) + size + (14,), seed=sum(size))
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1,) + size + (3,)
    assert np.abs(got - want).max() <= 1e-4
    # Not a clamped image: most pixels lie strictly inside (0, 1).
    assert ((want > 0.0) & (want < 1.0)).mean() > 0.2


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_training_forward_matches_flax(flax_full, size):
    """One training-mode forward on a batch of 2: batch statistics normalise,
    and the running statistics take the biased batch variance, as Flax's."""
    model, variables, _ = flax_full
    port = DenoiseCNN()
    port.load_state_dict(denoise_state_dict_from_flax(variables))
    port.train()
    x = _inputs((2,) + size + (14,), seed=7 + sum(size))
    want, updates = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = port(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - np.asarray(want)).max() <= 1e-4
    want_state = denoise_state_dict_from_flax({"params": variables["params"],
                                               "batch_stats": _np_tree(updates["batch_stats"])})
    state = port.state_dict()
    for key, value in want_state.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[key].numpy(), value.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=key)
        elif key.endswith("num_batches_tracked"):
            assert int(state[key]) == 1


def test_batchnorm_running_var_is_biased_as_flax():
    """Batch 2 of 1x1 maps (block6 at 64x64): torch's own BatchNorm2d puts
    n/(n-1) = 2 times the batch variance into its running variance; the
    port's BatchNorm puts Flax's biased variance there."""
    x = _inputs((2, 1, 1, 8), seed=3)
    flax_bn = nn.BatchNorm(use_running_average=False)
    fvars = flax_bn.init(jax.random.key(0), jnp.asarray(x))
    fy, upd = flax_bn.apply(fvars, jnp.asarray(x), mutable=["batch_stats"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ours, stock = BatchNorm(8).train(), torch.nn.BatchNorm2d(8, eps=1e-5, momentum=0.01).train()
    y = ours(xt).permute(0, 2, 3, 1)
    stock(xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(fy), rtol=1e-4, atol=1e-5)
    want_var = np.asarray(upd["batch_stats"]["var"])
    np.testing.assert_allclose(ours.running_var.numpy(), want_var, rtol=1e-6)
    np.testing.assert_allclose(ours.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    assert np.abs(stock.running_var.numpy() - want_var).max() > 1e-3


def test_batch_stats_and_gradient_are_flax_fast_variance():
    """batch_stats is Flax's _compute_stats with use_fast_variance
    (E[x^2] - E[x]^2, clamped at 0), on a channel whose mean is 20 times its
    spread (the difference loses 3 of f32's digits, so both round it alike
    only to 1e-3) and on a constant one; and BatchNorm's gradient with
    respect to its input and scale is Flax's (``_TrainBatchNorm``'s analytic
    backward, through the statistics)."""
    from flax.linen.normalization import _compute_stats

    from pathtrace_tpu_torch.models.denoise_cnn import batch_stats

    x = _inputs((4, 3, 5, 6), seed=7)
    x[..., 0] = 3.0 + 0.5 * x[..., 0]
    x[..., 1] = 2.5
    fmean, fvar = _compute_stats(jnp.asarray(x), (0, 1, 2), None, use_fast_variance=True)
    mean, var, count = batch_stats(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert count == 4 * 3 * 5
    np.testing.assert_allclose(mean.numpy(), np.asarray(fmean), rtol=1e-6)
    np.testing.assert_allclose(var.numpy()[2:], np.asarray(fvar)[2:], rtol=1e-5)
    np.testing.assert_allclose(var.numpy()[0], np.asarray(fvar)[0], rtol=1e-3)
    assert var.numpy()[1] == np.asarray(fvar)[1] == 0.0  # clamped where it rounds below

    # Plain inputs for the gradient: a constant channel's is rounding, and
    # the offset one's carries the 1e-4 of its variance.
    x = _inputs((4, 3, 5, 6), seed=9)
    w = _inputs((6,), seed=8)
    flax_bn = nn.BatchNorm(use_running_average=False)
    fvars = flax_bn.init(jax.random.key(0), jnp.asarray(x))

    def floss(xx, scale):
        params = {"params": {"scale": scale, "bias": fvars["params"]["bias"]},
                  "batch_stats": fvars["batch_stats"]}
        y, _ = flax_bn.apply(params, xx, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y) * jnp.asarray(w))

    fgx, fgs = jax.grad(floss, argnums=(0, 1))(jnp.asarray(x), fvars["params"]["scale"])
    xt = torch.from_numpy(x).requires_grad_(True)
    bn = BatchNorm(6).train()
    y = bn(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.sum(torch.sin(y) * torch.from_numpy(w)).backward()
    for got, want in ((xt.grad, fgx), (bn.weight.grad, fgs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("size_in,size_out", [((4, 5), (8, 10)), ((1, 1), (2, 2)),
                                              ((16, 16), (31, 33)), ((25, 35), (50, 70))])
def test_resize_is_interpolate_with_a_matrix_backward(size_in, size_out):
    """The FPN's bilinear resize: F.interpolate's values to the bit, and a
    backward (products with the interpolation matrices, deterministic on a
    card) equal to F.interpolate's within f32 rounding."""
    import torch.nn.functional as F

    from pathtrace_tpu_torch.models.denoise_cnn import _BilinearResize

    x = torch.from_numpy(_inputs((2, 3) + size_in, seed=4)).requires_grad_(True)
    g = torch.from_numpy(_inputs((2, 3) + size_out, seed=5))
    want = F.interpolate(x, size=size_out, mode="bilinear", align_corners=False)
    got = _BilinearResize.apply(x, size_out)
    assert torch.equal(got, want)
    (gw,) = torch.autograd.grad(want, x, g)
    (gg,) = torch.autograd.grad(got, x, g)
    np.testing.assert_allclose(gg.numpy(), gw.numpy(), atol=1e-6 * float(gw.abs().max()))


@pytest.mark.parametrize("size,pads", [(8, (0, 1)), (7, (1, 1)), (1, (1, 1)), (2, (0, 1))])
def test_same_padding_of_a_strided_conv(size, pads):
    """Flax "SAME" with stride 2 pads (0, 1) on an even size, (1, 1) on an
    odd one: the port's conv equals an explicit pad and a VALID conv."""
    conv = SameConv2d(2, 3, 3, 2)
    x = torch.from_numpy(_inputs((1, 2, size, size + 1), seed=size))
    w_pads = (0, 1) if (size + 1) % 2 == 0 else (1, 1)
    want = torch.nn.functional.conv2d(torch.nn.functional.pad(x, w_pads + pads), conv.weight,
                                      conv.bias, stride=2)
    got = conv(x)
    assert got.shape[-2:] == (-(-size // 2), -(-(size + 1) // 2))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_residual_block_halves_resolution():
    block = ResidualBlock(8, 16)
    y = block(torch.ones(2, 8, 32, 32))
    assert y.shape == (2, 16, 16, 16)


def test_full_model_shapes_and_range():
    model = init_model(torch.Generator().manual_seed(0))
    names = {name for name, _ in model.named_children()}
    assert {f"block{i}" for i in range(1, 7)} <= names
    assert {f"lat_{i}" for i in range(0, 7)} <= names
    assert {"rgb_conv", "backwards_10", "backwards_21", "backwards_65"} <= names
    with torch.no_grad():
        y = model.eval()(torch.from_numpy(_inputs((1, 64, 64, 14), seed=0)))
    assert y.shape == (1, 64, 64, 3)
    assert float(y.min()) >= 0.0 and float(y.max()) <= 1.0


def test_init_model_is_seeded():
    a = init_model(torch.Generator().manual_seed(1), widths=(8, 16))
    b = init_model(torch.Generator().manual_seed(1), widths=(8, 16))
    c = init_model(torch.Generator().manual_seed(2), widths=(8, 16))
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not torch.equal(a.block1.Conv_0.weight, c.block1.Conv_0.weight)
    # Flax's lecun-normal: truncated at two standard deviations of its scale.
    w = init_model(torch.Generator().manual_seed(3)).block6.Conv_2.weight
    std = np.sqrt(1.0 / (1024 * 9)) / 0.87962566103423978
    w = w.detach()
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) / (np.sqrt(1.0 / (1024 * 9))) - 1.0) < 0.02


def test_albedo_remultiply():
    """Output = clip(rgb * (eps + albedo)): zero albedo bounds it by eps."""
    model = init_model(torch.Generator().manual_seed(1), widths=(8, 16)).eval()
    with torch.no_grad():
        y = model(torch.zeros(1, 32, 32, 14))
    assert float(y.max()) <= EPSILON * 10


def test_batchnorm_updates_in_train_mode():
    model = init_model(torch.Generator().manual_seed(0), widths=(8, 16))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()(torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 32, 32, 14)).astype(np.float32)))
    after = model.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in after if "running" in k)


@pytest.mark.parametrize("shape", [(16, 16, 14), (2, 8, 12, 14)], ids=["single", "batched"])
def test_preprocess_matches_jax(shape):
    """Per-image maxima: the batched buffer's images normalise apart."""
    buf = np.random.default_rng(3).uniform(0.1, 2.0, size=shape).astype(np.float32)
    if len(shape) == 4:
        buf[1, ..., 9:14] *= 10.0  # the second image's maxima are 10x the first's
    got = preprocess_channels(torch.from_numpy(buf)).numpy()
    want = np.asarray(jax_preprocess_channels(jnp.asarray(buf)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got[..., 0:3], buf[..., 0:3] / (EPSILON + buf[..., 6:9]),
                               rtol=1e-6)
    np.testing.assert_array_equal(got[..., 3:9], buf[..., 3:9])
    if len(shape) == 4:
        np.testing.assert_allclose(got[1], preprocess_channels(torch.from_numpy(buf[1])).numpy(),
                                   rtol=1e-6)
    got_t = preprocess_target(torch.from_numpy(buf * 2 - 1)).numpy()
    want_t = np.asarray(jax_preprocess_target(jnp.asarray(buf * 2 - 1)))
    np.testing.assert_array_equal(got_t, want_t)
    assert got_t.shape == shape[:-1] + (3,)


def test_checkpoint_round_trip(tmp_path):
    model = init_model(torch.Generator().manual_seed(4), widths=(8, 16), lateral_features=4)
    model.train()(torch.rand(2, 16, 16, 14))  # running statistics off their init
    path = save_checkpoint(str(tmp_path), model, name="model_best")
    assert path.endswith("model_best.pt")
    assert (tmp_path / "model.json").read_text() == '{"widths": [8, 16], "lateral_features": 4}'
    loaded = load_checkpoint(str(tmp_path), name="model_best")
    assert loaded.widths == (8, 16) and loaded.lateral_features == 4 and not loaded.training
    for (k, v), w in zip(model.state_dict().items(), loaded.state_dict().values()):
        assert torch.equal(v, w), k
    x = torch.rand(1, 24, 20, 14)
    with torch.no_grad():
        torch.testing.assert_close(loaded(x), model.eval()(x), rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path))  # no model_epoch.pt
