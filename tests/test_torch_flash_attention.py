"""The port's flash attention (its plain path, on the CPU) against the JAX
package's Pallas kernels in interpret mode, as `tests/test_ops.py`'s
``TestFlashAttention`` runs them.

Inputs come from numpy with a seed and go to both.  Tolerances are the JAX
tests': 2e-5 for float32 values and lse, 2e-4 for gradients (float32 sums
over S in another order, and the backward's extra products).  The
tile-range helpers, which the CUDA kernels mirror, are checked against the
brute-force mask, and the route, the dispatch to the route's wrappers and
the tile order of the tensor-core kernels are checked here too.
"""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import ops as jax_ops

# the module (the package exports its function of the same name)
fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")

VAL = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _both(fn_jax, fn_port, arrays):
    want = fn_jax(*(jnp.asarray(a) for a in arrays))
    got = fn_port(*(torch.from_numpy(a) for a in arrays))
    return got, want


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 64, 16), (2, 3, 128, 8)])
def test_values_match_jax(shape, causal):
    got, want = _both(
        lambda q, k, v: jax_ops.flash_attention(q, k, v, causal=causal, bq=32, bk=32,
                                                interpret=True),
        lambda q, k, v: fa.flash_attention(q, k, v, causal=causal, bq=32, bk=32),
        _qkv(shape),
    )
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


def _grads(causal, window, shape, blocks, seed):
    """Gradients of sum(out**2) with respect to q, k, v in both packages."""
    arrays = _qkv(shape, seed)

    def loss_jax(q, k, v):
        out = jax_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      bq=blocks, bk=blocks, interpret=True)
        return jnp.sum(out**2), out

    (_, out_jax), g_jax = jax.value_and_grad(loss_jax, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in arrays)
    )
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fa.flash_attention(*leaves, causal=causal, window=window, bq=blocks, bk=blocks)
    (out**2).sum().backward()
    return out.detach(), out_jax, [t.grad for t in leaves], g_jax


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax(causal):
    _, _, got, want = _grads(causal, None, (1, 2, 64, 8), 16, seed=5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [16, 64])
def test_sliding_window_values_and_grads_match_jax(causal, window):
    out, out_jax, got, want = _grads(causal, window, (1, 2, 128, 8), 32, seed=11)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_jax), **VAL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD)


@pytest.mark.parametrize("causal,window", [(False, None), (True, None), (True, 24)])
def test_lse_matches_jax(causal, window):
    (out, lse), (out_jax, lse_jax) = _both(
        lambda q, k, v: jax_ops.flash_attention_lse(q, k, v, causal=causal, window=window,
                                                    bq=32, bk=32, interpret=True),
        lambda q, k, v: fa.flash_attention_lse(q, k, v, causal=causal, window=window,
                                               bq=32, bk=32),
        _qkv((2, 3, 64, 16), seed=2),
    )
    assert lse.shape == (2, 3, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_jax), **VAL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_jax), **VAL)


def test_blocks_clamp_to_small_seq():
    got, want = _both(
        lambda q, k, v: jax_ops.flash_attention(q, k, v, interpret=True),
        lambda q, k, v: fa.flash_attention(q, k, v),
        _qkv((1, 1, 8, 4), seed=1),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VAL)


REFUSED = [
    ("indivisible", (1, 1, 48, 4), (1, 1, 48, 4), dict(bq=32, bk=32), "not divisible"),
    ("shapes", (1, 1, 32, 4), (1, 1, 16, 4), {}, "shapes differ"),
    ("window", (1, 1, 128, 8), (1, 1, 128, 8), dict(window=0), "window"),
]


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_lse"])
@pytest.mark.parametrize("case", REFUSED, ids=lambda c: c[0])
def test_refuses_what_jax_refuses(case, fn):
    _, q_shape, k_shape, kw, match = case
    with pytest.raises(ValueError, match=match):
        getattr(jax_ops, fn)(jnp.ones(q_shape), jnp.ones(k_shape), jnp.ones(k_shape),
                             interpret=True, **kw)
    with pytest.raises(ValueError, match=match):
        getattr(fa, fn)(torch.ones(q_shape), torch.ones(k_shape), torch.ones(k_shape), **kw)


def test_bf16_plain_path_keeps_dtypes():
    q, k, v = (torch.from_numpy(a).bfloat16().requires_grad_() for a in _qkv((1, 2, 64, 16)))
    out = fa.flash_attention(q, k, v, causal=True)
    out.float().sum().backward()
    assert out.dtype == q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16


def _brute_force_visible(S, causal, window):
    mask = fa.visible_mask(S, causal=causal, window=window)
    return torch.ones(S, S, dtype=torch.bool) if mask is None else mask


@pytest.mark.parametrize("S,bq,bk", [(64, 16, 16), (96, 32, 32), (100, 16, 32),
                                     (70, 32, 16), (128, 64, 64), (33, 8, 8),
                                     (384, 128, 128), (300, 128, 128), (129, 128, 128),
                                     (1000, 64, 128), (129, 64, 128)])
def test_tile_ranges_skip_only_masked_tiles(S, bq, bk):
    """For every tile pair: a pair outside the scanned range holds no
    visible (query, key) element, from both sides (the query tile's key
    range and the key tile's query range), under every mask kind."""
    nq, nk = -(-S // bq), -(-S // bk)
    for causal, window in itertools.product([False, True], [None, 1, 5, 17, 40, 1000]):
        visible = _brute_force_visible(S, causal, window)
        for i, j in itertools.product(range(nq), range(nk)):
            tile = visible[i * bq : (i + 1) * bq, j * bk : (j + 1) * bk]
            k_lo, k_hi = fa.key_tile_range(i, S, bq, bk, causal=causal, window=window)
            q_lo, q_hi = fa.query_tile_range(j, S, bq, bk, causal=causal, window=window)
            assert 0 <= k_lo <= k_hi <= nk and 0 <= q_lo <= q_hi <= nq
            if not k_lo <= j < k_hi:
                assert not tile.any(), (causal, window, i, j)
            if not q_lo <= i < q_hi:
                assert not tile.any(), (causal, window, i, j)


def test_tile_ranges_cut_the_work():
    """Causal scans about half the tiles, and a narrow window a band."""
    S, t = 1024, fa.TILE
    n = S // t
    causal = sum(np.subtract(*fa.key_tile_range(i, S, t, t, causal=True, window=None)[::-1])
                 for i in range(n))
    assert causal == n * (n + 1) // 2
    band = [fa.query_tile_range(j, S, t, t, causal=True, window=64) for j in range(n)]
    assert all(hi - lo <= 2 for lo, hi in band)


def test_tiles_and_peaks_cover_every_kernel_shape_and_dtype():
    """The kernels take 32-row tiles only past d = 128, and the card's peak
    table (the bounds `chip_smoke.py` prints) holds every dtype they take."""
    from tpu_dist_torch.train import flops

    assert [fa.tile_rows(d) for d in (8, 64, 128, 129, 256)] == [64, 64, 64, 32, 32]
    for dtype in fa._DTYPE_CODES:
        assert flops.peak_flops("NVIDIA H100 80GB HBM3", dtype) > 0


@pytest.mark.parametrize("d", [8, 64, 100, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda t: str(t)[6:])
def test_route_takes_tensor_cores_for_16_bit_types_at_64_and_128(dtype, d):
    """The tensor-core kernels take bfloat16 and float16 at head dims 64 and
    128; float32 (whose products must stay float32) and every other head
    dim stay on the SIMT kernels."""
    sm90 = dtype in (torch.bfloat16, torch.float16) and d in (64, 128)
    assert fa.flash_route(dtype, d) == ("sm90" if sm90 else "simt")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [1, 2, 7, 16])
def test_sm90_tile_order_covers_every_tile_heaviest_first(n, causal):
    """Each kernel's launch order is a permutation of its tiles; under a
    causal mask the tiles that scan the most of the other side go first.
    dQ takes query tiles as the forward does, scanning 64-key tiles."""
    S, t, tq, tk = n * fa.SM90_TILE, fa.SM90_TILE, fa.SM90_DKV_QUERY_TILE, fa.SM90_DQ_KEY_TILE
    scans = {
        "fwd": lambda i: np.subtract(*fa.key_tile_range(i, S, t, t, causal=causal,
                                                        window=None)[::-1]),
        "dkv": lambda j: np.subtract(*fa.query_tile_range(j, S, tq, t, causal=causal,
                                                          window=None)[::-1]),
        "dq": lambda i: np.subtract(*fa.key_tile_range(i, S, t, tk, causal=causal,
                                                       window=None)[::-1]),
    }
    for kernel, scanned in scans.items():
        order = fa.sm90_tile_order(n, causal=causal, kernel=kernel)
        assert sorted(order) == list(range(n)), (kernel, order)
        work = [scanned(i) for i in order]
        assert work == sorted(work, reverse=True), (kernel, work)
        if causal and n > 1:
            assert work[0] > work[-1], (kernel, work)
    with pytest.raises(ValueError, match="kernel"):
        fa.sm90_tile_order(n, causal=causal, kernel="bwd")


@pytest.mark.parametrize("d", [8, 64, 100, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda t: str(t)[6:])
def test_dispatch_takes_the_wrapper_the_route_names(monkeypatch, dtype, d):
    """`flash_fwd`, `flash_dkv` and `flash_dq` hand the call to the route's
    wrapper: ``flash_dq_sm90`` for bfloat16 and float16 at d = 64 and 128,
    ``flash_dq_simt`` otherwise (the wrappers are stood in for here; they
    launch kernels only on the card)."""
    called = []
    for kernel in fa.KERNELS:
        name = kernel.__name__
        monkeypatch.setattr(fa, name, lambda *a, _name=name, **kw: called.append(_name))
    route = fa.flash_route(dtype, d)
    q = torch.zeros(1, 128, d, dtype=dtype)
    rows = torch.zeros(1, 128)
    fa.flash_fwd(q, q, q, causal=True)
    fa.flash_dkv(q, q, q, q, rows, rows, causal=True)
    fa.flash_dq(q, q, q, q, rows, rows, causal=True)
    assert called == [f"flash_fwd_{route}", f"flash_dkv_{route}", f"flash_dq_{route}"]
    sm90 = dtype in (torch.bfloat16, torch.float16) and d in (64, 128)
    assert (called[-1] == "flash_dq_sm90") == sm90


@pytest.mark.parametrize("kernel", ["fwd", "dkv"])
@pytest.mark.parametrize("d", [1, 8, 16, 17, 32, 64, 100, 128, 200, 256])
def test_simt_tiling_is_one_the_kernel_builds(kernel, d):
    """Every head dim takes the tiling of its template width, the narrowest
    of 16, 32, 64, 128 and 256 that holds it: the one tiling the source
    builds there (the card test `test_simt_entry_points_take_only_their_tiling`
    holds the C entry points to it).  Its tiles are whole 16-row multiples,
    so the tile ranges and the grid are those of the kernel."""
    t = fa.simt_tiling(kernel, d)
    width = fa.head_width(d)
    assert d <= width and (width // 2 < d or width == 16) and width in fa.SIMT_WIDTHS
    assert t == fa.simt_tiling(kernel, width)
    assert t.rows % 16 == 0 and t.cols % 16 == 0 and t.stages in (1, 2)


def test_simt_tiling_refuses_another_kernel_or_head_dim():
    with pytest.raises(ValueError, match="kernel"):
        fa.simt_tiling("dq", 64)
    for d in (0, 257):
        with pytest.raises(ValueError, match="head dims"):
            fa.simt_tiling("fwd", d)


@pytest.mark.parametrize("width", fa.SIMT_WIDTHS)
@pytest.mark.parametrize("S", [64, 100, 129, 300, 1024])
def test_simt_tile_ranges_cover_every_visible_pair_once(S, width):
    """The forward's query tiles with their key-tile ranges, and dK/dV's key
    tiles with their query-tile ranges, at each width's tiles: every visible
    (query, key) pair lies in exactly one scanned tile pair, under every
    mask kind."""
    fwd = fa.simt_tiling("fwd", width)
    dkv = fa.simt_tiling("dkv", width)
    for causal, window in itertools.product([False, True], [None, 1, 17, 64, 1000]):
        visible = _brute_force_visible(S, causal, window).numpy()
        seen = np.zeros((S, S), dtype=np.int64)
        bq, bk = fwd.rows, fwd.cols
        for i in range(-(-S // bq)):
            lo, hi = fa.key_tile_range(i, S, bq, bk, causal=causal, window=window)
            for j in range(lo, hi):
                seen[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk] += 1
        assert (seen[visible] == 1).all(), ("fwd", causal, window)
        seen[:] = 0
        bq, bk = dkv.cols, dkv.rows
        for j in range(-(-S // bk)):
            lo, hi = fa.query_tile_range(j, S, bq, bk, causal=causal, window=window)
            for i in range(lo, hi):
                seen[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk] += 1
        assert (seen[visible] == 1).all(), ("dkv", causal, window)
