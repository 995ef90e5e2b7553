"""The port's attention against `tpu_dist.nn.attention` on the same inputs.

Inputs come from numpy with a seed; module params come from the JAX init,
converted with `interop`.  Under ``TPU_DIST_FLASH=1`` the JAX package runs
its Pallas kernels in interpret mode and the port its plain flash path.
Tolerances: 2e-5 for float32 values (float32 sums in another order), 2e-4
for gradients, as the JAX flash tests use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import nn as jax_nn
from tpu_dist_torch import interop, nn

VAL = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _attend(q, k, v, **kw):
    want = jax_nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    kw = {n: torch.from_numpy(np.asarray(a)) if n == "mask" else a for n, a in kw.items()}
    got = nn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)
    return got.numpy(), np.asarray(want)


CASES = {
    "dense": ((2, 3, 16, 8), (2, 3, 16, 8), {}),
    "causal": ((2, 3, 16, 8), (2, 3, 16, 8), dict(causal=True)),
    "causal-sq<sk": ((2, 3, 5, 8), (2, 3, 16, 8), dict(causal=True)),
    "window": ((1, 2, 16, 8), (1, 2, 16, 8), dict(window=4)),
    "causal-window-sq<sk": ((1, 2, 6, 8), (1, 2, 16, 8), dict(causal=True, window=3)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_dense_attention_matches_jax(name):
    q_shape, k_shape, kw = CASES[name]
    got, want = _attend(_normal(q_shape, 0), _normal(k_shape, 1), _normal(k_shape, 2), **kw)
    np.testing.assert_allclose(got, want, **VAL)


def test_padding_mask_and_empty_row_give_zeros_as_jax():
    q, k, v = (_normal((2, 2, 8, 4), s) for s in range(3))
    mask = np.ones((2, 1, 8, 8), bool)
    mask[0, :, :, 5:] = False  # padded keys
    mask[1, :, 3, :] = False  # query 3 of batch 1 sees nothing
    got, want = _attend(q, k, v, mask=mask, causal=True)
    np.testing.assert_allclose(got, want, **VAL)
    assert np.all(got[1, :, 3] == 0.0) and np.isfinite(got).all()


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 32)])
def test_flash_flag_matches_dense_in_both_packages(monkeypatch, causal, window):
    q, k, v = (_normal((2, 2, 128, 8), s) for s in range(3))
    results = {}
    for flag in ("0", "1"):
        monkeypatch.setenv("TPU_DIST_FLASH", flag)
        results[flag] = _attend(q, k, v, causal=causal, window=window)
    for flag in ("0", "1"):
        np.testing.assert_allclose(*results[flag], **VAL)  # port against JAX
    np.testing.assert_allclose(results["1"][0], results["0"][0], **VAL)


def test_flash_routing_rule_is_jaxs(monkeypatch):
    """Eligible: the flag, equal shapes, S >= 128 divisible by its block,
    no mask.  The port's rule must agree with where the JAX package
    sends each call."""
    from tpu_dist_torch.nn.attention import use_flash

    monkeypatch.setenv("TPU_DIST_FLASH", "1")
    t = lambda *s: torch.zeros(s)  # noqa: E731
    assert use_flash(t(1, 2, 128, 8), t(1, 2, 128, 8), t(1, 2, 128, 8), None)
    assert use_flash(t(1, 2, 512, 8), t(1, 2, 512, 8), t(1, 2, 512, 8), None)
    assert not use_flash(t(1, 2, 64, 8), t(1, 2, 64, 8), t(1, 2, 64, 8), None)
    assert not use_flash(t(1, 2, 384, 8), t(1, 2, 384, 8), t(1, 2, 384, 8), None)
    assert not use_flash(t(1, 2, 128, 8), t(1, 2, 256, 8), t(1, 2, 256, 8), None)
    assert not use_flash(t(1, 2, 128, 8), t(1, 2, 128, 8), t(1, 2, 128, 8), t(128, 128))
    monkeypatch.setenv("TPU_DIST_FLASH", "0")
    assert not use_flash(t(1, 2, 128, 8), t(1, 2, 128, 8), t(1, 2, 128, 8), None)


def test_window_below_one_is_refused():
    q = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="window"):
        nn.dot_product_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="window"):
        nn.sliding_window_mask(8, 0)


def test_rope_matches_jax_and_keeps_dtype():
    x = _normal((2, 3, 10, 8), 4)
    pos = np.arange(3, 13)
    want = jax_nn.rope(jnp.asarray(x), jnp.asarray(pos))
    got = nn.rope(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)
    assert nn.rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos)).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="even"):
        nn.rope(torch.zeros(1, 4, 5), torch.arange(4))


def test_rope_scores_depend_on_relative_position_only():
    q, k = (torch.from_numpy(_normal((1, 1, 1, 16), s)) for s in (5, 6))
    score = lambda i, j: (nn.rope(q, torch.tensor([i])) * nn.rope(k, torch.tensor([j]))).sum()  # noqa: E731
    torch.testing.assert_close(score(3, 1), score(10, 8), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(score(0, 0), score(7, 7), rtol=1e-5, atol=1e-5)


def test_masks_match_jax():
    np.testing.assert_array_equal(nn.sliding_window_mask(9, 3).numpy(),
                                  np.asarray(jax_nn.sliding_window_mask(9, 3)))
    seg = np.array([[0, 0, 1, 1, 1, 2], [0, 1, 1, 1, 2, 2]], np.int32)
    np.testing.assert_array_equal(nn.segment_mask(torch.from_numpy(seg)).numpy(),
                                  np.asarray(jax_nn.segment_mask(jnp.asarray(seg))))


@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("kv_heads,window,rope", [(None, None, True), (2, 32, False),
                                                 (1, None, True), (4, 48, True)])
def test_mha_forward_and_param_grads_match_jax(monkeypatch, flag, kv_heads, window, rope):
    monkeypatch.setenv("TPU_DIST_FLASH", flag)
    kw = dict(causal=True, kv_heads=kv_heads, use_rope=rope, sliding_window=window)
    ref = jax_nn.MultiHeadAttention(32, 4, **kw)
    params, _ = ref.init(jax.random.key(0), (2, 128, 32))
    x = _normal((2, 128, 32), 7)

    def loss(p):
        out, _ = ref.apply(p, {}, jnp.asarray(x))
        return jnp.sum(out**2), out

    (_, want), g_want = jax.value_and_grad(loss, has_aux=True)(params)
    port = nn.MultiHeadAttention(32, 4, **kw)
    port.load_state_dict(interop.params_from_jax(jax.device_get(params)))
    assert sorted(port.state_dict()) == sorted(interop.params_from_jax(jax.device_get(params)))
    out = port(torch.from_numpy(x))
    (out**2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **VAL)
    g_want = interop.params_from_jax(jax.device_get(g_want))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), g_want[name].numpy(), **GRAD, err_msg=name)


def test_gqa_expands_kv_heads_like_jnp_repeat():
    port = nn.MultiHeadAttention(32, 4, kv_heads=2)
    t = torch.arange(2 * 2 * 3 * 1, dtype=torch.float32).reshape(2, 2, 3, 1)
    np.testing.assert_array_equal(port._expand_kv(t).numpy(),
                                  np.repeat(t.numpy(), 2, axis=1))
