"""The port's TransformerLM against `tpu_dist.models.transformer_lm`.

Params come from the JAX init, converted with `interop`; tokens from the
seeded Markov corpus both packages generate.  ``TPU_DIST_FLASH=1`` at
S = 128 sends every block's attention through the flash path in both
(JAX's Pallas kernels in interpret mode, the port's plain version).
Logits agree to 2e-5 and gradients of the loss to 5e-5 (float32 sums in
another order through two blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import models as jax_models
from tpu_dist_torch import interop, models

SMALL = dict(vocab=64, dim=32, depth=2, heads=4, max_seq=128)
CONFIGS = {
    "learned": dict(pos_embedding="learned"),
    "rope": dict(pos_embedding="rope"),
    "rope-gqa": dict(pos_embedding="rope", kv_heads=2),
    "window": dict(pos_embedding="learned", kv_heads=1, sliding_window=32),
}
VAL = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=5e-5, atol=5e-5)


def _pair(config, **extra):
    ref = jax_models.TransformerLM(**SMALL, **CONFIGS[config], **extra)
    params = jax.device_get(ref.init(jax.random.key(0))[0])
    port = models.TransformerLM(**SMALL, **CONFIGS[config], **extra)
    port.load_state_dict(interop.params_from_jax(params))
    return ref, params, port


def _tokens(n=2, seq=128, seed=3):
    return np.array(jax_models.synthetic_tokens(n, seq, SMALL["vocab"], seed=seed))


@pytest.fixture(autouse=True)
def flash(monkeypatch):
    monkeypatch.setenv("TPU_DIST_FLASH", "1")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_logits_match_jax(config):
    ref, params, port = _pair(config)
    tokens = _tokens()
    want, _ = ref.apply(params, {}, jnp.asarray(tokens))
    got = port(torch.from_numpy(tokens))
    assert tuple(got.shape) == (2, 128, SMALL["vocab"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **VAL)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("config", ["rope", "window"])
def test_loss_grads_match_jax(config, remat):
    ref, params, port = _pair(config, remat=remat)
    tokens = _tokens(seed=4)

    def loss(p):
        logits, _ = ref.apply(p, {}, jnp.asarray(tokens))
        return jax_models.lm_loss(logits, jnp.asarray(tokens))

    want_loss, want = jax.value_and_grad(loss)(params)
    got_loss = models.lm_loss(port(torch.from_numpy(tokens)), torch.from_numpy(tokens))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **VAL)
    want = interop.params_from_jax(jax.device_get(want))
    assert sorted(want) == sorted(n for n, _ in port.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **GRAD, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 9, 17)).astype(np.float32)
    tokens = rng.integers(0, 17, size=(3, 9)).astype(np.int32)
    mask = rng.random((3, 9)) > 0.3 if masked else None
    want = jax_models.lm_loss(jnp.asarray(logits), jnp.asarray(tokens),
                              mask=None if mask is None else jnp.asarray(mask))
    got = models.lm_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                         mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), **VAL)


def test_synthetic_tokens_are_jaxs_bit_for_bit():
    got = models.synthetic_tokens(7, 33, 50, seed=9)
    want = np.asarray(jax_models.synthetic_tokens(7, 33, 50, seed=9))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    table = models.markov_table(50, seed=9)
    np.testing.assert_array_equal(table, jax_models.markov_table(50, seed=9))
    np.testing.assert_array_equal(table[want[:, :-1]], want[:, 1:])


def test_perplexity_matches_jax():
    ref, params, port = _pair("rope")
    tokens = _tokens(n=5, seed=6)
    want = jax_models.lm_perplexity(ref, params, tokens, batch=2)
    got = models.lm_perplexity(port, torch.from_numpy(tokens), batch=2)
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_interop_round_trips_the_lm_tree():
    _, params, port = _pair("learned")
    state = interop.params_from_jax(params)
    assert "blocks.1.attn.qkv.w" in state and state["pos"].shape == (1, 128, 32)
    assert state["blocks.0.mlp.fc1.w"].shape == (32, 128)  # Dense w stays (in, out)
    back = interop.params_to_jax(port.state_dict())
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 2
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in flat_back] == [p for p, _ in flat_want]
    for (_, a), (_, b) in zip(flat_back, flat_want):
        np.testing.assert_array_equal(a, b)


def test_interop_round_trips_the_mnist_sequential():
    ref = jax_models.mnist_net()
    params = jax.device_get(ref.init(jax.random.key(1), jax_models.IN_SHAPE)[0])
    net = models.mnist_net()
    net.load_state_dict(interop.params_from_jax(params))
    assert net[0].w.shape == (10, 1, 5, 5)  # HWIO -> OIHW
    back = interop.params_to_jax(net.state_dict(), len(net))
    assert len(back) == len(params)
    for a, b in zip(back, params):
        assert a.keys() == b.keys()
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])


def test_moe_is_refused_until_ported():
    """MoE is ported (tests/test_torch_moe.py): two experts or more build,
    and a single expert is refused with the JAX package's ValueError."""
    assert models.TransformerLM(**SMALL, moe_experts=2).blocks[0].moe.up.shape == (2, 32, 128)
    with pytest.raises(ValueError, match="moe_experts must be 0"):
        models.TransformerLM(**SMALL, moe_experts=1)


def test_layer_norm_embedding_and_gelu_match_jax():
    from tpu_dist import nn as jax_nn
    from tpu_dist_torch import nn

    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 5, 16)) * 3 + 1).astype(np.float32)
    params = {"scale": rng.standard_normal(16).astype(np.float32),
              "bias": rng.standard_normal(16).astype(np.float32)}
    want, _ = jax_nn.LayerNorm().apply(params, {}, jnp.asarray(x))
    ln = nn.LayerNorm(16)
    ln.load_state_dict(interop.params_from_jax(params))
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(), np.asarray(want), **VAL)

    table = rng.standard_normal((10, 4)).astype(np.float32)
    ids = np.array([[1, 9, 0], [3, 3, 7]], np.int32)
    want, _ = jax_nn.Embedding(10, 4).apply({"table": table}, {}, jnp.asarray(ids))
    emb = nn.Embedding(10, 4)
    emb.load_state_dict({"table": torch.from_numpy(table)})
    np.testing.assert_array_equal(emb(torch.from_numpy(ids)).detach().numpy(), np.asarray(want))

    want, _ = jax_nn.gelu().apply({}, {}, jnp.asarray(x))
    np.testing.assert_allclose(nn.gelu()(torch.from_numpy(x)).numpy(), np.asarray(want), **VAL)


def test_dense_keeps_3d_inputs_off_the_fused_kernel(monkeypatch):
    """As tpu_dist/nn/layers.py:50: only 2-D inputs take the fused-dense
    path under TPU_DIST_PALLAS_DENSE=1; every LM activation is 3-D."""
    from tpu_dist_torch import nn
    from tpu_dist_torch.nn import layers

    calls = []
    monkeypatch.setattr(layers, "matmul", lambda *a, **k: calls.append(a) or a[0] @ a[1] + a[2])
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    dense = nn.Dense(4, 3)
    dense(torch.zeros(2, 5, 4))
    assert calls == []
    dense(torch.zeros(2, 4))
    assert len(calls) == 1
