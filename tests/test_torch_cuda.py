"""The CUDA kernels against their plain versions, on the card: fused dense
(both routes), the flash-attention kernels (the tensor-core forward, dK/dV
and dQ, the SIMT forward, dK/dV and dQ) and the ring all-reduce across
processes.  The flash and ring checks are the port's own
(`tpu_dist_torch.ops.checks`), which ``chip_smoke.py`` runs too.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one.  They import neither jax nor the JAX package, so they run on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import functools
import importlib

import pytest
import torch

from tpu_dist_torch.ops import checks, fused_dense, matmul, matmul_reference, pallas_ring
from tpu_dist_torch.ops.matmul import dense_tiling

# the module (the package exports its function of the same name)
fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")

pytestmark = pytest.mark.cuda

# The main path's four shapes (M x K x N), a ragged one and a wide one.
SHAPES = [(128, 320, 50), (128, 50, 10), (1024, 320, 50), (1024, 50, 10),
          (100, 60, 40), (300, 270, 520)]
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2),  # one bf16 rounding of the output
       torch.float16: dict(rtol=2e-3, atol=2e-3)}  # one f16 rounding of the output


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, bias=True):
    m, k, n = shape
    g = torch.Generator(device).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=device).to(dtype)
    w = torch.randn(k, n, generator=g, device=device).to(dtype)
    b = torch.randn(n, generator=g, device=device).to(dtype) if bias else None
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("epilogue", ["none", "relu", "gelu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_version(card, shape, epilogue, dtype):
    x, w, b = _inputs(shape, dtype, card)
    before = fused_dense.launches
    got = fused_dense(x, w, b, epilogue)
    torch.cuda.synchronize()
    assert fused_dense.launches == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got, matmul_reference(x, w, b, epilogue), **TOL[dtype])


def test_kernel_without_bias(card):
    x, w, _ = _inputs((100, 60, 40), torch.float32, card, bias=False)
    torch.testing.assert_close(fused_dense(x, w, None), matmul_reference(x, w, None),
                               **TOL[torch.float32])


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("epilogue", ["none", "relu", "gelu"])
@pytest.mark.parametrize("shape", SHAPES[:4], ids=lambda s: "x".join(map(str, s)))
def test_small_route_matches_plain_version_at_mnist_shapes(card, shape, epilogue, bias):
    """The MNIST layers take the small route (K split over warps, one
    round trip to memory), with and without bias, under every epilogue."""
    m, k, n = shape
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert dense_tiling(m, n, k, sms).route == "small"
    x, w, b = _inputs(shape, torch.float32, card, bias=bias)
    got = fused_dense(x, w, b, epilogue)
    torch.testing.assert_close(got, matmul_reference(x, w, b, epilogue), **TOL[torch.float32])


def test_both_routes_are_the_same_from_run_to_run(card):
    """The small route adds the warps' partial sums in warp order, and the
    large route owns each output in one thread: the same bits every run."""
    for shape in [(128, 320, 50), (4096, 512, 2048)]:
        x, w, b = _inputs(shape, torch.float32, card)
        first = fused_dense(x, w, b, "gelu")
        for _ in range(3):
            assert torch.equal(fused_dense(x, w, b, "gelu"), first)


@pytest.mark.parametrize("epilogue", ["none", "gelu"])
def test_grads_on_card_match_plain_version(card, epilogue):
    x, w, b = (t.requires_grad_() for t in _inputs((128, 320, 50), torch.float32, card))
    g = torch.randn(128, 50, device=card, generator=torch.Generator(card).manual_seed(1))
    matmul(x, w, b, epilogue=epilogue).backward(g)
    got = [t.grad.clone() for t in (x, w, b)]
    for t in (x, w, b):
        t.grad = None
    matmul_reference(x, w, b, epilogue).backward(g)
    for a, e in zip(got, (x.grad, w.grad, b.grad)):
        torch.testing.assert_close(a, e, **TOL[torch.float32])


def test_wrapper_refuses_bad_input(card):
    """Mixed dtypes, non-contiguous operands and a wrong bias raise; float16,
    which the JAX kernel takes, runs and matches the plain version."""
    x, w, b = _inputs((16, 32, 8), torch.float32, card)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dense(x.T.contiguous().T, w, b)
    got = fused_dense(x.half(), w.half(), b.half())
    assert got.dtype == torch.float16
    torch.testing.assert_close(got, matmul_reference(x.half(), w.half(), b.half()),
                               **TOL[torch.float16])
    with pytest.raises(TypeError):
        fused_dense(x.half(), w, b)
    with pytest.raises(ValueError, match="bias"):
        fused_dense(x, w, b[:4].contiguous())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=lambda t: str(t)[6:])
def test_kernel_past_2_31_elements(card, dtype):
    """x of more than 2^31 elements ((2^21 + 64) x 1024, 4.3 GB in 16 bits):
    64-bit offsets and the one-dimensional grid (32,769 tiles) of the large
    route; the rows past element 2^31 are held to the plain version."""
    m, k, n = 2**21 + 64, 1024, 16
    g = torch.Generator(card).manual_seed(2)
    x = torch.empty(m, k, device=card, dtype=dtype)
    for r in range(0, m, 1 << 18):  # without a float32 copy of all of x
        x[r:r + (1 << 18)] = torch.randn(min(1 << 18, m - r), k, generator=g, device=card)
    w = torch.randn(k, n, generator=g, device=card).to(dtype)
    b = torch.randn(n, generator=g, device=card).to(dtype)
    assert x.numel() > 2**31
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert dense_tiling(m, n, k, sms).route == "large"
    got = fused_dense(x, w, b, "gelu")
    torch.cuda.synchronize()
    tail = slice(2**31 // k - 64, m)  # from before element 2^31 to the end
    torch.testing.assert_close(got[tail], matmul_reference(x[tail], w, b, "gelu"),
                               **TOL[dtype])


# ---------------------------------------------------------------- flash

# (causal, window): dense, causal, the causal band, and the one-sided band
MASKS = [(False, None), (True, None), (True, 40), (False, 40)]
# (bh, S); 96, 129 and 1000 are ragged at every kernel's tile
FLASH_SHAPES = [(2, 64), (2, 128), (3, 96), (1, 1024), (2, 129), (1, 1000)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("d", [8, 64, 128, 256], ids=lambda d: f"d{d}")
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: f"bh{s[0]}-S{s[1]}")
@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"causal{int(m[0])}-w{m[1]}")
def test_flash_kernels_match_plain_versions(card, mask, shape, d, dtype):
    """Every head dim up to 256 (32-row tiles at d = 256) and every input
    type the JAX kernels take, each through its route: bfloat16 and float16
    at d = 64 and 128 through the tensor-core forward and dK/dV (the check
    asserts which wrappers launched), the rest through the SIMT kernels.
    At d = 8 in float32, where the scale is no power of two, dK equals the
    plain version bit for bit while the plain version's product over the S
    queries is one in-order sum, as the kernel's (S <= 128 here; cuBLAS
    splits the sum at S = 1024)."""
    causal, window = mask
    q, k, v, go = checks.flash_inputs(*shape, d, dtype, card)
    checks.check_flash_kernels(q, k, v, go, causal=causal, window=window,
                               exact_dk=d == 8 and dtype == torch.float32 and shape[1] <= 128)


def test_flash_kernels_past_2_31_elements(card):
    """(bh, S, d) bfloat16 arrays of more than 2^31 elements at d = 128:
    the tensor-core forward's, dK/dV's and dQ's (d, S, bh) TMA coordinates
    and 64-bit loads and stores."""
    assert checks.check_flash_past_2_31(card)["route"] == "sm90"


@pytest.mark.parametrize("d", [64, 128])
def test_flash_sm90_is_the_same_from_run_to_run(card, d):
    """No atomics: each block owns its output rows, so runs of the
    tensor-core forward, dK/dV and dQ on the same inputs agree bit for
    bit."""
    q, k, v, go = checks.flash_inputs(24, 1024, d, torch.bfloat16, card, seed=7)
    out, lse = fa.flash_fwd_sm90(q, k, v, causal=True)
    delta = (go.float() * out.float()).sum(-1)
    runs = [fa.flash_dkv_sm90(q, k, v, go, lse, delta, causal=True) for _ in range(3)]
    dqs = [fa.flash_dq_sm90(q, k, v, go, lse, delta, causal=True) for _ in range(3)]
    again = fa.flash_fwd_sm90(q, k, v, causal=True)
    torch.cuda.synchronize()
    for dk, dv in runs[1:]:
        assert torch.equal(dk, runs[0][0]) and torch.equal(dv, runs[0][1])
    for dq in dqs[1:]:
        assert torch.equal(dq, dqs[0])
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("d", [64, 128], ids=lambda d: f"d{d}")
@pytest.mark.parametrize("shape", [(3, 128), (2, 129), (1, 1000), (2, 1024)],
                         ids=lambda s: f"bh{s[0]}-S{s[1]}")
@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"causal{int(m[0])}-w{m[1]}")
def test_flash_dq_sm90_matches_plain_version(card, mask, shape, d, dtype):
    """The tensor-core dQ alone, against `flash_dq_reference` on the plain
    forward's lse and D: unmasked, causal and windowed, ragged S (129 and
    1000 end inside a 64-key and a 128-query tile)."""
    causal, window = mask
    q, k, v, go = checks.flash_inputs(*shape, d, dtype, card, seed=11)
    out, lse = fa.flash_fwd_reference(q, k, v, causal=causal, window=window)
    delta = (go.float() * out.float()).sum(-1)
    before = fa.flash_dq_sm90.launches
    got = fa.flash_dq_sm90(q, k, v, go, lse, delta, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_dq_sm90.launches == before + 1 and got.dtype == dtype
    want = fa.flash_dq_reference(q, k, v, go, lse, delta, causal=causal, window=window)
    torch.testing.assert_close(got, want, **checks.FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("d", [5, 16, 32, 64, 100, 128, 256], ids=lambda d: f"d{d}")
@pytest.mark.parametrize("shape", [(3, 128), (2, 129), (1, 1000)],
                         ids=lambda s: f"bh{s[0]}-S{s[1]}")
@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"causal{int(m[0])}-w{m[1]}")
def test_flash_simt_fwd_and_dkv_match_plain_versions(card, mask, shape, d, dtype):
    """The SIMT forward and dK/dV alone, at every template width (16, 32, 64,
    128, 256; d = 5 and 100 pad to 16 and 128 and take the element-wise
    copies, d * itemsize not being a multiple of 16 bytes in every dtype) and
    every input type, tensor-core domain included: unmasked, causal and
    windowed, ragged S (129 and 1000 end inside every tile), against the
    plain versions on the plain forward's lse and D."""
    causal, window = mask
    kw = dict(causal=causal, window=window)
    q, k, v, go = checks.flash_inputs(*shape, d, dtype, card, seed=13)
    want_out, want_lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = (go.float() * want_out.float()).sum(-1)
    before = (fa.flash_fwd_simt.launches, fa.flash_dkv_simt.launches)
    out, lse = fa.flash_fwd_simt(q, k, v, **kw)
    dk, dv = fa.flash_dkv_simt(q, k, v, go, want_lse, delta, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd_simt.launches, fa.flash_dkv_simt.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    assert out.dtype == dk.dtype == dv.dtype == dtype and lse.dtype == torch.float32
    tol = checks.FLASH_TOL[dtype]
    torch.testing.assert_close(out, want_out, **tol)
    torch.testing.assert_close(lse, want_lse, **checks.FLASH_TOL[torch.float32])
    want_dk, want_dv = fa.flash_dkv_reference(q, k, v, go, want_lse, delta, **kw)
    torch.testing.assert_close(dk, want_dk, **tol)
    torch.testing.assert_close(dv, want_dv, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=lambda t: str(t)[6:])
@pytest.mark.parametrize("d", [16, 64, 128, 256], ids=lambda d: f"d{d}")
def test_flash_simt_is_the_same_from_run_to_run(card, d, dtype):
    """No atomics and no order that depends on timing: each block owns its
    output rows and sums in a fixed order, so runs of the SIMT forward and
    dK/dV on the same inputs agree bit for bit."""
    q, k, v, go = checks.flash_inputs(24, 1000, d, dtype, card, seed=7)
    out, lse = fa.flash_fwd_simt(q, k, v, causal=True)
    delta = (go.float() * out.float()).sum(-1)
    runs = [fa.flash_dkv_simt(q, k, v, go, lse, delta, causal=True) for _ in range(3)]
    again = [fa.flash_fwd_simt(q, k, v, causal=True) for _ in range(2)]
    torch.cuda.synchronize()
    for dk, dv in runs[1:]:
        assert torch.equal(dk, runs[0][0]) and torch.equal(dv, runs[0][1])
    for o, m in again:
        assert torch.equal(o, out) and torch.equal(m, lse)


@pytest.mark.parametrize("kernel", ["fwd", "dkv"])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256], ids=lambda d: f"d{d}")
def test_simt_entry_points_take_only_their_tiling(card, d, kernel):
    """The source builds one tiling of the SIMT forward and dK/dV at each
    width: its entry point takes the one `simt_tiling` names and refuses it
    with any field changed, so the two cannot drift apart unseen."""
    q, k, v, go = checks.flash_inputs(2, 256, d, torch.float32, card)
    lse = torch.zeros(2, 256, device=card)
    out, out2 = torch.empty_like(q), torch.empty_like(q)
    operands = (q, k, v, out, lse) if kernel == "fwd" else (q, k, v, go, lse, lse, out, out2)
    launch = functools.partial(fa._launch, "flash_attention", f"flash_{kernel}",
                               [t.data_ptr() for t in operands], tuple(q.shape), q.dtype,
                               True, None, q.device)
    tiles = fa.simt_tiling(kernel, d)
    launch(tiles)
    torch.cuda.synchronize()
    for field in tiles._fields:
        with pytest.raises(RuntimeError, match="invalid argument"):
            launch(tiles._replace(**{field: 2 * getattr(tiles, field)}))


def _dense_attention(q, k, v, causal, window):
    """Autograd's own reference: the masked softmax on (S, S), float32."""
    mask = fa.visible_mask(q.shape[-2], causal=causal, window=window, device=q.device)
    logits = (q.float() * q.shape[-1] ** -0.5) @ k.float().transpose(-1, -2)
    if mask is not None:
        logits = logits.masked_fill(~mask, fa.NEG_INF)
    return (torch.softmax(logits, -1) @ v.float()).to(q.dtype)


@pytest.mark.parametrize("mask", MASKS, ids=lambda m: f"causal{int(m[0])}-w{m[1]}")
@pytest.mark.parametrize("seq", [96, 256])
def test_flash_attention_grads_on_card(card, seq, mask):
    """The autograd Function (forward kernel, then the two backward kernels)
    against autograd through dense attention, on the JAX layout; S = 96 with
    bq = bk = 32 leaves the kernels a ragged last tile."""
    causal, window = mask
    g = torch.Generator(card).manual_seed(3)
    q, k, v = (torch.randn(2, 3, seq, 16, generator=g, device=card).requires_grad_()
               for _ in range(3))
    cot = torch.randn(2, 3, seq, 16, generator=g, device=card)
    kernels = (fa.flash_fwd_simt, fa.flash_dkv_simt, fa.flash_dq_simt)  # float32: SIMT
    before = [kernel.launches for kernel in kernels]
    fa.flash_attention(q, k, v, causal=causal, window=window, bq=32, bk=32).backward(cot)
    assert [kernel.launches for kernel in kernels] == [n + 1 for n in before]
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    _dense_attention(q, k, v, causal, window).backward(cot)
    for a, e in zip(got, (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(a, e, **TOL[torch.float32])


def test_flash_wrappers_refuse_bad_input(card):
    q, k, v, go = checks.flash_inputs(2, 64, 16, torch.float32, card)
    lse = torch.zeros(2, 64, device=card)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, k.cpu(), v)
    with pytest.raises(TypeError):
        fa.flash_fwd(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        fa.flash_fwd(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_fwd(q, k[:, :32].contiguous(), v)
    with pytest.raises(ValueError, match="head dims"):
        big = torch.zeros(1, 64, 264, device=card)
        fa.flash_fwd(big, big, big)
    with pytest.raises(TypeError, match="lse"):
        fa.flash_dq(q, k, v, go, lse.double(), lse)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_dkv(q, k, v, go, lse[:, :32].contiguous(), lse)


def test_flash_sm90_wrappers_refuse_what_tma_cannot_take(card):
    """Outside bfloat16/float16 at d = 64 or 128, or on q/k/v that are not
    16-byte aligned, the tensor-core wrappers raise; nothing falls back."""
    q, k, v, go = checks.flash_inputs(2, 128, 64, torch.float32, card)
    lse = torch.zeros(2, 128, device=card)
    before = [kernel.launches for kernel in fa.KERNELS]
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        fa.flash_fwd_sm90(q, k, v)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        fa.flash_dkv_sm90(q, k, v, go, lse, lse)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        fa.flash_dq_sm90(q, k, v, go, lse, lse)
    odd = checks.flash_inputs(2, 128, 96, torch.bfloat16, card)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_fwd_sm90(*odd[:3])
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_dq_sm90(*odd, lse, lse)
    flat = torch.zeros(2 * 128 * 64 + 1, device=card, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 128, 64)  # contiguous, 2 bytes off alignment
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_fwd_sm90(shifted, shifted, shifted)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_dq_sm90(shifted, shifted, shifted, shifted, lse, lse)
    assert [kernel.launches for kernel in fa.KERNELS] == before


# ---------------------------------------------------------------- ring


@pytest.mark.parametrize("world", [2, 3, 4])
def test_ring_kernel_matches_plain_version(card, world):
    """`world` processes on the card: every output bit for bit equal to the
    plain version (float32, bfloat16, float16, int32, ragged, 100 calls back
    to back, a workspace grown and reused) and to rank 0's, one launch per
    call."""
    checks.check_ring(world)


def test_ring_stuck_neighbour_raises_within_the_bound(card):
    checks.check_ring_stuck_neighbour()


def test_ring_ranks_that_disagree_raise_within_the_bound(card):
    """Another numel, another dtype, or a growth only one rank needs: both
    ranks raise, and nothing hangs."""
    checks.check_ring_mismatch()


def test_ring_wrapper_refuses_what_the_kernel_cannot_take(card):
    with pytest.raises(TypeError):
        pallas_ring.ring_all_reduce_pallas(torch.zeros(8, device=card, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="process group"):
        pallas_ring.ring_all_reduce_pallas(torch.zeros(8, device=card))
