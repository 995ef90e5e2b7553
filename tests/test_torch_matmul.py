"""The port's fused-dense op against the JAX package's Pallas kernel.

On the CPU the port's `matmul` runs its plain version, and the JAX kernel
runs in interpret mode, as tests/test_ops.py runs it.  Inputs come from
numpy with a fixed seed.  Tolerances: float32 as tests/test_ops.py (the
two sides sum in different orders), bfloat16 2e-2 (one bf16 rounding of
the output may differ).  The kernel's tiling (`dense_tiling`), which the
CUDA source takes as given, is checked here: every output element in one
tile, every K column summed once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import ops as jax_ops
from tpu_dist_torch.ops import fused_dense, matmul
from tpu_dist_torch.ops.matmul import SMALL_MAX_SMEM, dense_tiling, small_smem_bytes

F32 = dict(rtol=1e-4, atol=5e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
SHAPES = [(256, 512, 256), (128, 384, 512), (8, 16, 32), (100, 60, 40)]
EPILOGUES = ["none", "relu", "gelu"]


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32)
    b = rng.standard_normal((n,), dtype=np.float32)
    return x, w, b


def _jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype=dtype)


def _torch(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(shape, epilogue):
    x, w, b = _inputs(*shape)
    want = jax_ops.matmul(_jax(x), _jax(w), _jax(b), epilogue=epilogue, interpret=True)
    got = matmul(_torch(x), _torch(w), _torch(b), epilogue=epilogue)
    assert got.dtype == torch.float32 and tuple(got.shape) == (shape[0], shape[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("shape", [(8, 16, 32), (100, 60, 40)])
def test_no_bias_matches_jax(shape):
    x, w, _ = _inputs(*shape)
    want = jax_ops.matmul(_jax(x), _jax(w), interpret=True)
    got = matmul(_torch(x), _torch(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("shape", [(64, 128, 32), (100, 60, 40)])
def test_bf16_matches_jax(shape, epilogue):
    x, w, b = _inputs(*shape, seed=1)
    bf = jnp.bfloat16
    want = jax_ops.matmul(
        _jax(x, bf), _jax(w, bf), _jax(b, bf), epilogue=epilogue, interpret=True
    )
    got = matmul(
        _torch(x, torch.bfloat16), _torch(w, torch.bfloat16),
        _torch(b, torch.bfloat16), epilogue=epilogue,
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **BF16
    )


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_float16_dense_under_the_flag_matches_jax(monkeypatch, epilogue):
    """A float16 `nn.Dense` under TPU_DIST_PALLAS_DENSE=1 goes through the
    op (on the CPU its plain version) and matches the JAX kernel on the same
    float16 operands in interpret mode; both accumulate in float32 and
    round once to float16, so they may differ by one float16 rounding of
    the output (2^-10 relative): rtol 2e-3, atol 2e-3.  The epilogue goes
    through `matmul` itself, as Dense has none."""
    from tpu_dist_torch import nn as port_nn
    from tpu_dist_torch.nn import layers

    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0].dtype)
        return matmul(*args, **kwargs)

    monkeypatch.setattr(layers, "matmul", spy)
    x, w, b = _inputs(64, 96, 48, seed=6)
    f16 = jnp.float16
    want = jax_ops.matmul(_jax(x, f16), _jax(w, f16), _jax(b, f16), epilogue=epilogue,
                          interpret=True)
    if epilogue == "none":
        dense = port_nn.Dense(96, 48)
        with torch.no_grad():
            dense.w.copy_(_torch(w))
            dense.b.copy_(_torch(b))
        got = dense.half()(_torch(x, torch.float16))
        assert calls == [torch.float16]
    else:
        got = matmul(_torch(x, torch.float16), _torch(w, torch.float16),
                     _torch(b, torch.float16), epilogue=epilogue)
    assert got.dtype == torch.float16 and want.dtype == f16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("shape", [(32, 64, 16), (100, 60, 40)])
def test_grads_match_jax(shape, epilogue, with_bias):
    x, w, b = _inputs(*shape, seed=2)
    g = np.random.default_rng(3).standard_normal((shape[0], shape[2]), dtype=np.float32)
    if not with_bias:
        b = None

    def loss(x_, w_, b_):
        y = jax_ops.matmul(x_, w_, b_, epilogue=epilogue, interpret=True)
        return (y * g).sum()

    argnums = (0, 1, 2) if with_bias else (0, 1)
    want = jax.grad(loss, argnums=argnums)(_jax(x), _jax(w), _jax(b))

    xt, wt = _torch(x).requires_grad_(), _torch(w).requires_grad_()
    bt = _torch(b).requires_grad_() if with_bias else None
    matmul(xt, wt, bt, epilogue=epilogue).backward(torch.from_numpy(g))
    got = (xt.grad, wt.grad) + ((bt.grad,) if with_bias else ())
    for gt, gj in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **F32)


def test_bad_shapes_raise():
    with pytest.raises(ValueError, match="inner dims"):
        matmul(torch.ones(4, 5), torch.ones(6, 7))


def test_bad_epilogue_raises():
    with pytest.raises(ValueError, match="epilogue"):
        matmul(torch.ones(4, 4), torch.ones(4, 4), epilogue="tanh")


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        fused_dense(torch.ones(4, 4), torch.ones(4, 4), None)


class TestMatmulBlockSelection:
    """The counterpart of tests/test_ops.py::TestMatmulBlockSelection: shapes
    that no 128-multiple divides, which the JAX kernel pads and the CUDA
    kernel masks, against the JAX kernel in interpret mode."""

    def test_nondivisible_shapes_match_jax(self):
        x, w, b = _inputs(520, 384, 520, seed=4)
        want = jax_ops.matmul(_jax(x), _jax(w), _jax(b), epilogue="relu", interpret=True)
        got = matmul(_torch(x), _torch(w), _torch(b), epilogue="relu")
        assert tuple(got.shape) == (520, 520)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    def test_grad_through_nondivisible_shapes_matches_jax(self):
        x, w, _ = _inputs(260, 384, 260, seed=5)

        def loss(x_, w_):
            return jax_ops.matmul(x_, w_, epilogue="gelu", interpret=True).sum()

        want = jax.grad(loss, argnums=(0, 1))(_jax(x), _jax(w))
        xt, wt = _torch(x).requires_grad_(), _torch(w).requires_grad_()
        matmul(xt, wt, epilogue="gelu").sum().backward()
        for gt, gj in zip((xt.grad, wt.grad), want):
            np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **F32)


# (m, k, n): the MNIST layers in training and evaluation, every shape
# chip_smoke.py times, the shapes above, ragged and degenerate ones
TILED_SHAPES = [(128, 320, 50), (128, 50, 10), (1024, 320, 50), (1024, 50, 10),
                (300, 270, 520), (4096, 4096, 4096), (520, 384, 520), (260, 384, 260),
                (100, 60, 40), (1, 1, 1), (7, 100_003, 3), (8448, 64, 64), (33, 0, 17)]


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("shape", TILED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dense_tiling_covers_every_output_and_k_once(shape, sms):
    m, k, n = shape
    t = dense_tiling(m, n, k, sms)
    seen = np.zeros((m, n), dtype=np.int64)
    for rows, cols in t.tiles(m, n):
        assert rows.stop - rows.start <= t.bm and cols.stop - cols.start <= t.bn
        seen[rows, cols] += 1
    assert (seen == 1).all()
    summed = np.zeros(k, dtype=np.int64)
    for cols in t.k_slices(k):
        summed[cols.start:cols.stop] += 1
    assert (summed == 1).all()
    assert len(t.k_slices(k)) == t.k_split * -(-k // t.k_chunk)


@pytest.mark.parametrize("shape", TILED_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dense_tiling_picks_a_route_the_kernel_builds(shape):
    """Outputs that give each of 132 SMs a 64 x 64 tile take the large
    route; smaller ones the small route, whose tiles fit the static shared
    memory and spread the MNIST layers over 32-112 blocks."""
    m, k, n = shape
    t = dense_tiling(m, n, k, 132)
    if -(-m // 64) * -(-n // 64) >= 132:
        assert (t.route, t.bm, t.bn, t.k_split, t.k_chunk) == ("large", 64, 64, 1, 16)
        return
    assert t.route == "small" and (t.bm, t.bn) in ((8, 8), (16, 16))
    assert 1 <= t.k_split <= 8 and t.k_chunk >= 1
    assert small_smem_bytes(t.bm, t.bn, t.k_split, t.k_chunk) <= SMALL_MAX_SMEM
    if shape[0] == 128 and shape[1] in (320, 50):  # a training step's layers: one chunk
        assert t.k_chunk == k and 32 <= len(t.tiles(m, n)) <= 132
