"""The image models' layers and losses against `tpu_dist.nn`, on the same
params and inputs.

Params come from the JAX init (converted with `interop`), inputs from numpy
with a fixed seed.  Outputs, gradients and new batch-norm state agree to
atol 1e-5 (float32 sums in another order); gradients through a
convolution's reduction over the batch also to rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import nn as jax_nn
from tpu_dist_torch import interop, nn

TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _jax_init(layer, in_shape, seed=0):
    params, state = layer.init(jax.random.key(seed), in_shape)
    return jax.device_get(params), jax.device_get(state)


def _check_forward_and_grads(jax_layer, port_layer, x, *, train=False):
    """Output and d(sum(out * g))/d(x, params) of both layers on ``x``."""
    params, state = _jax_init(jax_layer, x.shape[1:])
    interop.load_jax(port_layer, params, state)
    port_layer.train(train)
    want, _ = jax_layer.apply(params, state, x, train=train)
    g = _images(np.shape(want), seed=9)

    def f(p, xx):
        out, _ = jax_layer.apply(p, state, xx, train=train)
        return (out * g).sum()

    want_gp, want_gx = jax.grad(f, argnums=(0, 1))(params, x)
    xt = torch.from_numpy(x).requires_grad_()
    got = port_layer(xt)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), **GRAD_TOL)
    got_gp = interop.params_from_jax(jax.device_get(want_gp))
    for name, p in port_layer.named_parameters():
        np.testing.assert_allclose(interop.jax_view(p.grad).numpy(),
                                   interop.jax_view(got_gp[name]).numpy(), **GRAD_TOL)
    return got


@pytest.mark.parametrize(
    "case",
    [
        dict(features=8, kernel=3, stride=2, padding=1, use_bias=False, hw=(9, 9)),
        dict(features=8, kernel=3, stride=2, padding="SAME", use_bias=True, hw=(9, 9)),
        dict(features=6, kernel=3, stride=2, padding="SAME", use_bias=False, hw=(8, 7)),
        dict(features=8, kernel=4, stride=4, padding="VALID", use_bias=True, hw=(16, 16)),
        dict(features=8, kernel=7, stride=2, padding=3, use_bias=False, hw=(15, 15)),
        dict(features=8, kernel=1, stride=2, padding="VALID", use_bias=False, hw=(8, 8)),
    ],
    ids=["stride2_pad1_nobias", "same_stride2_odd", "same_stride2_oddw", "patch4",
         "imagenet_stem", "projection"],
)
def test_conv2d_matches_jax(case):
    """Strided, SAME on odd sizes (XLA pads one more on the high side), the
    ViT's patch convolution and ResNet's stems and projection."""
    h, w = case.pop("hw")
    x = _images((2, h, w, 3))
    jax_layer = jax_nn.Conv2D(**case)
    port = nn.Conv2D(3, case["features"], case["kernel"], stride=case["stride"],
                     padding=case["padding"], use_bias=case["use_bias"])
    got = _check_forward_and_grads(jax_layer, port, x)
    assert tuple(got.shape[1:]) == jax_layer.out_shape((h, w, 3))
    assert (port.b is None) == (not case["use_bias"])
    assert got.is_contiguous()  # NHWC in memory: the NCHW result was channels-last


def test_conv2d_refuses_unknown_padding():
    with pytest.raises(ValueError, match="padding"):
        nn.Conv2D(3, 4, 3, padding="FULL")


@pytest.mark.parametrize(
    "make",
    [
        lambda m: m.MaxPool2D(2),
        lambda m: m.MaxPool2D(3, 2),
        lambda m: m.AvgPool2D(2),
        lambda m: m.AvgPool2D(3, 2),
        lambda m: m.GlobalAvgPool(),
    ],
    ids=["max2", "max3_stride2", "avg2", "avg3_stride2", "global_avg"],
)
def test_pools_match_jax(make):
    x = _images((2, 9, 9, 4), seed=3)
    _check_forward_and_grads(make(jax_nn), make(nn), x)


@pytest.mark.parametrize("momentum", [0.9, 0.7])
@pytest.mark.parametrize("shape", [(4, 5, 5, 6), (16, 6)], ids=["4d", "2d"])
def test_batch_norm_matches_jax(momentum, shape):
    """Train mode normalizes by the batch's statistics and moves the running
    ones by ``momentum * old + (1 - momentum) * batch`` with the biased
    variance; eval mode normalizes by the running ones.  Two momenta, so a
    port that took torch's reversed momentum fails."""
    x = _images(shape, seed=4) * 3.0 + 1.5
    jax_bn = jax_nn.BatchNorm(momentum=momentum)
    params, state = _jax_init(jax_bn, shape[1:])
    # scale and bias away from 1 and 0, so their gradients are exercised
    rng = np.random.default_rng(5)
    params = {k: v + rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
    state = {"mean": rng.standard_normal(shape[-1]).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, shape[-1]).astype(np.float32)}
    port = nn.BatchNorm(shape[-1], momentum=momentum)
    interop.load_jax(port, params, state)

    want, new_state = jax_bn.apply(params, state, x, train=True)
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, k).numpy(), np.asarray(new_state[k]), **TOL)
        assert getattr(port, k).dtype == torch.float32
    want_eval, same = jax_bn.apply(params, new_state, x, train=False)
    got_eval = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.detach().numpy(), np.asarray(want_eval), **TOL)
    np.testing.assert_allclose(port.mean.numpy(), np.asarray(same["mean"]), **TOL)

    # gradients through the batch statistics, from a fresh copy of the state
    port2 = nn.BatchNorm(shape[-1], momentum=momentum)
    interop.load_jax(port2, params, state)
    _check_grads_train(jax_bn, params, state, port2, x)


def _check_grads_train(jax_bn, params, state, port, x):
    g = _images(x.shape, seed=6)

    def f(p, xx):
        out, _ = jax_bn.apply(p, state, xx, train=True)
        return (out * g).sum()

    gp, gx = jax.grad(f, argnums=(0, 1))(params, x)
    xt = torch.from_numpy(x).requires_grad_()
    (port.train()(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD_TOL)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(getattr(port, k).grad.numpy(), np.asarray(gp[k]), **GRAD_TOL)


def test_batch_norm_keeps_jax_state_names():
    """Buffers ``mean`` and ``var`` only: no torch running_mean, running_var
    or num_batches_tracked in the checkpoint tree."""
    port = nn.BatchNorm(5)
    assert sorted(n for n, _ in port.named_buffers()) == ["mean", "var"]
    assert sorted(n for n, _ in port.named_parameters()) == ["bias", "scale"]
    _, state = _jax_init(jax_nn.BatchNorm(), (5,))
    assert sorted(state) == ["mean", "var"]


def test_frozen_statistics_leaves_buffers_and_output_alone():
    x = torch.from_numpy(_images((8, 3, 3, 4), seed=7))
    bn = nn.BatchNorm(4).train()
    with nn.frozen_statistics(bn):
        y = bn(x)
    assert torch.equal(bn.mean, torch.zeros(4)) and torch.equal(bn.var, torch.ones(4))
    assert bn.update
    assert torch.equal(y, bn(x))  # the same batch statistics normalize
    assert not torch.equal(bn.mean, torch.zeros(4))


def test_batch_norm_bfloat16_keeps_float32_state():
    """bfloat16 activations, float32 buffers: the new state matches JAX's
    promotion ((1 - m) * batch mean in bfloat16, the sum in float32).  The
    batch statistics are float32 sums rounded to bfloat16, the sums taken in
    another order on each side, so a statistic may land one bfloat16 step
    (2^-8 relative) away: rtol 2^-7."""
    x = _images((8, 4, 4, 6), seed=8) + 2.0
    jax_bn = jax_nn.BatchNorm()
    params, state = _jax_init(jax_bn, (4, 4, 6))
    xb = jnp.asarray(x, jnp.bfloat16)
    pb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want, new_state = jax_bn.apply(pb, state, xb, train=True)
    port = nn.BatchNorm(6)
    interop.load_jax(port, params, state)
    port = port.train()
    with torch.no_grad():
        port.scale.data, port.bias.data = port.scale.bfloat16(), port.bias.bfloat16()
    got = port(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16 and port.mean.dtype == torch.float32
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=2e-2, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(port, k).numpy(), np.asarray(new_state[k]),
                                   atol=0, rtol=2**-7)


def test_cross_entropy_and_accuracy_match_jax():
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((32, 10)).astype(np.float32) * 3
    y = rng.integers(0, 10, 32).astype(np.int32)
    want = jax_nn.cross_entropy(jnp.asarray(logits), jnp.asarray(y))
    lt = torch.from_numpy(logits).requires_grad_()
    got = nn.cross_entropy(lt, torch.from_numpy(y))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    got.backward()
    want_g = jax.grad(lambda z: jax_nn.cross_entropy(z, jnp.asarray(y)))(jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g), **TOL)
    acc = nn.accuracy(torch.from_numpy(logits), torch.from_numpy(y))
    assert acc.dtype == torch.float32
    assert acc.item() == float(jax_nn.accuracy(jnp.asarray(logits), jnp.asarray(y)))
    assert 0 < acc.item() < 1
