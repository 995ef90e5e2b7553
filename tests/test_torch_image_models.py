"""ResNet-18 and the ViT against `tpu_dist.models`, on the same params.

Params and batch-norm state come from the JAX init, converted with
`interop`; images from numpy with a fixed seed.  Logits, new state and
gradients agree to atol 1e-5 (float32 sums in another order).  Gradients
agree to rtol 1e-4 and an atol of 1e-5 times the largest gradient of the
same tensor (at least 1e-5): each is a sum over the batch and every
spatial position, taken in another order on each side, through layers of
batch statistics, so its rounding error scales with the tensor's size, not
with the element's.  Parameter counts and tree structures are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import models as jax_models
from tpu_dist import nn as jax_nn
from tpu_dist_torch import interop, models, nn

TOL = dict(atol=1e-5, rtol=0)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4, scaled=True)


def _batch(n, hw, classes, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + hw, dtype=np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    return x, y


def _pair(jax_model, port_model, in_shape, seed=0):
    params, state = jax.device_get(jax_model.init(jax.random.key(seed), in_shape))
    interop.load_jax(port_model, params, state)
    return params, state


def _assert_trees_close(got, want, *, atol, rtol, scaled=False):
    got_leaves, got_def = jax.tree.flatten(got)
    want_leaves, want_def = jax.tree.flatten(want)
    assert got_def == want_def
    for a, b in zip(got_leaves, want_leaves):
        b = np.asarray(b)
        leaf_atol = atol * max(1.0, float(np.abs(b).max())) if scaled else atol
        np.testing.assert_allclose(np.asarray(a), b, atol=leaf_atol, rtol=rtol)


def _check_train_step_parts(jax_model, port, params, state, x, y):
    """Train-mode logits, new state and cross-entropy gradients."""

    def loss(p):
        logits, new_state = jax_model.apply(p, state, x, train=True)
        return jax_nn.cross_entropy(logits, y), (logits, new_state)

    (want_loss, (want_logits, want_state)), want_grads = jax.value_and_grad(
        loss, has_aux=True)(params)
    port.train()
    logits = port(torch.from_numpy(x))
    got_loss = nn.cross_entropy(logits, torch.from_numpy(y))
    got_loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **TOL)
    got_params, got_state = interop.module_to_jax(port)
    _assert_trees_close(got_state, jax.device_get(want_state), **TOL)
    grads = {k: p.grad for k, p in port.named_parameters()}
    _assert_trees_close(interop.params_to_jax(grads, interop.num_layers(port)),
                        jax.device_get(want_grads), **GRAD_TOL)
    return want_state


@pytest.mark.parametrize("in_features,features,stride", [(8, 8, 1), (8, 16, 2), (8, 16, 1)],
                         ids=["identity", "projection_stride2", "projection_width"])
def test_basic_block_matches_jax(in_features, features, stride):
    from tpu_dist.models.resnet import BasicBlock as JaxBlock

    jax_block = JaxBlock(features, stride)
    port = models.BasicBlock(in_features, features, stride)
    in_shape = (9, 9, in_features)
    params, state = _pair(jax_block, port, in_shape)
    assert ("proj" in params) == (port.proj is not None) == (stride != 1 or in_features != features)
    x, _ = _batch(4, in_shape, 2, seed=1)
    g = np.random.default_rng(2).standard_normal(
        (4,) + jax_block.out_shape(in_shape), dtype=np.float32)

    def f(p):
        out, new_state = jax_block.apply(p, state, x, train=True)
        return (out * g).sum(), (out, new_state)

    (_, (want, want_state)), want_grads = jax.value_and_grad(f, has_aux=True)(params)
    out = port.train()(torch.from_numpy(x))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    _assert_trees_close(interop.module_to_jax(port)[1], jax.device_get(want_state), **TOL)
    grads = {k: p.grad for k, p in port.named_parameters()}
    _assert_trees_close(interop.params_to_jax(grads), jax.device_get(want_grads), **GRAD_TOL)


@pytest.mark.parametrize("imagenet_stem", [False, True], ids=["cifar_stem", "imagenet_stem"])
def test_resnet18_matches_jax(imagenet_stem):
    """Forward in train mode, new state and gradients against ``jax.grad``,
    then eval mode on the new state."""
    jax_model = jax_models.resnet18(num_classes=10, imagenet_stem=imagenet_stem)
    port = models.resnet18(num_classes=10, imagenet_stem=imagenet_stem)
    hw = (40, 40, 3) if imagenet_stem else (16, 16, 3)
    params, state = _pair(jax_model, port, hw)
    x, y = _batch(4, hw, 10, seed=3)
    new_state = _check_train_step_parts(jax_model, port, params, state, x, y)
    want_eval, _ = jax_model.apply(params, new_state, x, train=False)
    got_eval = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.detach().numpy(), np.asarray(want_eval), **TOL)


def _count(tree):
    return sum(int(np.prod(np.shape(a))) for a in jax.tree.leaves(tree))


@pytest.mark.parametrize(
    "build",
    [
        lambda m: (m.resnet18(num_classes=10), (32, 32, 3)),
        lambda m: (m.resnet18(num_classes=1000, imagenet_stem=True), (224, 224, 3)),
        lambda m: (m.vit_tiny(), (224, 224, 3)),
        lambda m: (m.vit_tiny(image_size=32, patch=4, num_classes=10), (32, 32, 3)),
    ],
    ids=["resnet18_cifar", "resnet18_imagenet", "vit_ti16_224", "vit_ti4_32"],
)
def test_parameter_counts_and_names_match_jax(build):
    """The full-width configurations: the same parameter and state trees,
    leaf for leaf (ResNet-18 on CIFAR-10: 11,173,962; ViT-Ti/16: 5,717,416)."""
    jax_model, in_shape = build(jax_models)
    port, _ = build(models)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.key(0), in_shape))
    want_params, want_state = shapes
    got_params, got_state = interop.module_to_jax(port)
    assert jax.tree.structure(got_params) == jax.tree.structure(want_params)
    assert jax.tree.structure(got_state) == jax.tree.structure(want_state)
    for a, b in zip(jax.tree.leaves(got_params) + jax.tree.leaves(got_state),
                    jax.tree.leaves(want_params) + jax.tree.leaves(want_state)):
        assert a.shape == b.shape
    n = sum(p.numel() for p in port.parameters())
    assert n == _count(want_params)
    if isinstance(jax_model, jax_models.ViT) and in_shape[0] == 224:
        assert n == 5_717_416
    elif in_shape == (32, 32, 3) and not isinstance(jax_model, jax_models.ViT):
        assert n == 11_173_962


def test_vit_refuses_indivisible_image():
    with pytest.raises(ValueError, match="not divisible"):
        models.ViT(image_size=30, patch=4)
    with pytest.raises(ValueError, match="not divisible"):
        jax_models.ViT(image_size=30, patch=4)


@pytest.mark.parametrize("flash", ["0", "1"], ids=["dense", "flash"])
def test_small_vit_matches_jax(monkeypatch, flash):
    """Depth 2, dim 32, 2 heads (head dim 16) at image 48, patch 4: 145
    tokens, so under ``TPU_DIST_FLASH=1`` attention takes the non-causal
    flash path in both packages (JAX's Pallas kernel in interpret mode, the
    port's plain versions on the CPU) with a block of 145; logits, loss and
    gradients against ``jax.grad``."""
    monkeypatch.setenv("TPU_DIST_FLASH", flash)
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    cfg = dict(image_size=48, patch=4, dim=32, depth=2, heads=2, num_classes=10)
    jax_model = jax_models.ViT(**cfg)
    port = models.ViT(**cfg)
    assert port.num_tokens == jax_model.num_tokens == 145
    params, state = _pair(jax_model, port, (48, 48, 3))
    x, y = _batch(2, (48, 48, 3), 10, seed=4)
    calls = []
    if flash == "1":
        import importlib

        fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
        real = fa.flash_fwd_reference
        monkeypatch.setattr(fa, "flash_fwd_reference",
                            lambda *a, **k: calls.append(k) or real(*a, **k))
    _check_train_step_parts(jax_model, port, params, state, x, y)
    if flash == "1":
        assert calls == [dict(causal=False, window=None)] * 2  # one per block


def test_vit_bfloat16_forward_matches_jax():
    """Params and images cast to bfloat16 on both sides, as the trainers'
    ``compute_dtype`` casts them: logits within four bfloat16 steps (2^-8
    relative) of the largest logit, every activation of the two blocks
    rounded at its own places on each side."""
    cfg = dict(image_size=32, patch=4, dim=32, depth=2, heads=2, num_classes=10)
    jax_model, port = jax_models.ViT(**cfg), models.ViT(**cfg)
    params, state = _pair(jax_model, port, (32, 32, 3))
    x, _ = _batch(4, (32, 32, 3), 10, seed=5)
    pb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want, _ = jax_model.apply(pb, state, jnp.asarray(x, jnp.bfloat16))
    port = port.to(torch.bfloat16)
    got = port(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().detach().numpy(), want,
                               atol=4 * 2**-8 * np.abs(want).max(), rtol=0)
