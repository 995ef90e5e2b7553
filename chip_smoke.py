#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, in order; any failure raises and
the exit code is nonzero:

[env]     Python, torch, CUDA; the card's name and power limit; TF32 off.
[build]   the nvcc build of every kernel source, all started together, with
          each build's seconds and ptxas's registers and spills.
[matmul]  the fused-dense kernel against its plain version on the card, at
          the main path's four shapes and a few others, each with the route
          and tiles `dense_tiling` picked; times from CUDA events, beside
          ``torch.addmm`` plus the epilogue and the least time the card
          could take (bound_ms).
[main]    the entry point ``python -m tpu_dist_torch.demos.train_dist
          --epochs 1`` with TPU_DIST_PALLAS_DENSE=1 (NCCL, world 1,
          synthetic MNIST: 468 steps of 128, then evaluation), its kernel
          launch count, loss and accuracy; then one training step from the
          same state on the card and on the CPU.
[flash]   the flash-attention kernels of each case's route (`flash_route`:
          the tensor-core forward, dK/dV and dQ for bfloat16 and float16 at
          head dims 64 and 128, the SIMT ones otherwise) against
          their plain versions on the card, the launch counts showing which
          ran: the LM path's shape (q, k, v (16, 12, 1024, 64) bfloat16,
          causal), float32, float16, windowed, dense, ragged, head-dim-128
          (bfloat16, S 2048) and head-dim-256 (float32, bfloat16, float16)
          cases, and arrays past 2^31 elements; each kernel's time and
          TFLOP/s beside its bound, its plain version's and, for the
          forward and forward + backward, the time of
          ``scaled_dot_product_attention`` on the same inputs, and for the
          backward pair (dK/dV + dQ) SDPA's forward + backward less its
          forward; at the LM shape the SIMT forward, dK/dV and dQ timed too;
          the count of dK elements that differ from the plain version at
          d = 8, float32.
[lm]      ``LMTrainer.fit`` of the GPT-2-small-class TransformerLM (vocab
          32768, dim 768, depth 12, heads 12, rope, seq 1024, global batch
          16, bfloat16 compute) with TPU_DIST_FLASH=1 for two epochs, its
          flash launch counts (12 per step of the tensor-core forward, dK/dV
          and dQ, none of the SIMT kernels), tokens/s and
          losses; the kernels' share of a profiled step; then the same LM in
          float32 (``compute_dtype=None``, the trainer's default; matmuls
          without TF32) for two epochs of 4 steps, which takes the SIMT
          forward, dK/dV and dQ (12 launches each per step, none of the
          tensor-core ones), its tokens/s and each flash kernel's device ms
          per step from a profile; then one step of a small float32 LM on
          the card and on the CPU, losses and gradients compared.
[ring]    the ring all-reduce kernel under ``comm.spmd`` at worlds 2, 3 and
          4, every rank a process on this one card (the Gloo control group
          carries the handle exchange; the kernel moves the data): each
          rank's output bit for bit against the plain version in float32,
          bfloat16, float16 and int32, ragged sizes, 100 calls back to back,
          a workspace grown and reused, every rank's output the same bits
          as rank 0's; launch counts; one 64 MiB float32 call at world 4,
          held to the plain version too, timed per call and traced for the
          kernel's own time and phases beside the plain version and its
          bound, with no control-group collective per call; then a
          neighbour that cannot start, and ranks that pass another numel or
          dtype or disagree about growing, make both ranks' calls raise.

Then one JSON line per kernel, the card's name and power limit, and the
result line.  Without a CUDA device it exits nonzero before printing any
result.

    python3 chip_smoke.py --lm-f32

runs only [env] and the float32 [lm] sub-phase (the kernels built at first
use), to compare the SIMT kernels of two trees end to end, and prints no
result line.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import platform
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

F32_TOL = dict(rtol=1e-4, atol=1e-4)  # float32 sums in another order
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of the output
# Bounds are taken against this card's published dense peaks (H100 SXM at
# 700 W, `tpu_dist_torch.train.flops.PEAKS`): HBM bytes/s, and FLOP/s by
# operand type (float32 outside the tensor cores, bf16 on them).
PEAK_CARD = "NVIDIA H100 80GB HBM3"
SOURCES = ("matmul", "flash_attention", "flash_attention_sm90", "ring")  # csrc/<name>.cu


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int, *, graph: bool = True) -> float:
    """Mean time of one call, from CUDA events around ``iters`` calls after a
    warm-up.  With ``graph`` the calls are captured once in a CUDA graph and
    the events bracket its replay: device time, without the host's launch
    overhead, which at these sizes is larger than the kernels."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        run = g.replay
        run()
    else:
        def run():
            for _ in range(iters):
                fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, n_ops: float, dtype: torch.dtype) -> tuple[float, str]:
    from tpu_dist_torch.train import flops  # the port: absent when this script stands alone

    t_bytes = nbytes / flops.peak_bytes_per_s(PEAK_CARD)
    t_ops = n_ops / flops.peak_flops(PEAK_CARD, dtype)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def matmul_cases(device, ops, F) -> list[dict]:
    dense_tiling = importlib.import_module("tpu_dist_torch.ops.matmul").dense_tiling
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    library_epilogue = {
        "none": lambda y: y,
        "relu": F.relu,
        "gelu": lambda y: F.gelu(y, approximate="tanh"),
    }
    cases = [
        (128, 320, 50, "none", torch.float32),  # training step: fc1
        (128, 50, 10, "none", torch.float32),  # training step: fc2
        (1024, 320, 50, "none", torch.float32),  # evaluation batch: fc1
        (1024, 50, 10, "none", torch.float32),  # evaluation batch: fc2
        (300, 270, 520, "relu", torch.float32),
        (300, 270, 520, "gelu", torch.float32),
        (4096, 4096, 4096, "none", torch.float32),
        (4096, 4096, 4096, "none", torch.bfloat16),
    ]
    gen = torch.Generator(device).manual_seed(0)
    rows = []
    for m, k, n, epilogue, dtype in cases:
        x = torch.randn(m, k, generator=gen, device=device).to(dtype)
        w = torch.randn(k, n, generator=gen, device=device).to(dtype)
        b = torch.randn(n, generator=gen, device=device).to(dtype)
        got = ops.fused_dense(x, w, b, epilogue)
        want = ops.matmul_reference(x, w, b, epilogue)
        torch.cuda.synchronize()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        torch.testing.assert_close(got, want, **tol)
        iters = 20 if m * n * k > 10**9 else 200
        act = library_epilogue[epilogue]
        item = x.element_size()
        bound_ms, bound_by = bound(
            (m * k + k * n + n + m * n) * item, 2 * m * n * k, dtype
        )
        rows.append({
            "m": m, "k": k, "n": n, "epilogue": epilogue, "dtype": str(dtype)[6:],
            "tiling": dataclasses.asdict(dense_tiling(m, n, k, sms)),
            "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "tol": tol, "timing": f"CUDA graph of {iters} launches",
            "ms": time_ms(lambda: ops.fused_dense(x, w, b, epilogue), iters),
            "plain_ms": time_ms(lambda: ops.matmul_reference(x, w, b, epilogue), iters),
            "library_ms": time_ms(lambda: act(torch.addmm(b, x, w)), iters),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        print("[matmul]", json.dumps(rows[-1]), flush=True)
    rows.append(gradient_case(device, ops, F, gen))
    print("[matmul]", json.dumps(rows[-1]), flush=True)
    return rows


def gradient_case(device, ops, F, gen) -> dict:
    """dx, dw, db through the port's op (kernel forward, kernel recompute of
    the pre-activation, plain products) against autograd through the plain
    version, at the first dense layer's training shape."""
    m, k, n, epilogue = 128, 320, 50, "gelu"
    leaves = [
        torch.randn(shape, generator=gen, device=device).requires_grad_()
        for shape in ((m, k), (k, n), (n,))
    ]
    g = torch.randn(m, n, generator=gen, device=device)

    def grads(fn):
        for t in leaves:
            t.grad = None
        fn(*leaves).backward(g)
        return [t.grad for t in leaves]

    port = lambda x, w, b: ops.matmul(x, w, b, epilogue=epilogue)
    plain = lambda x, w, b: ops.matmul_reference(x, w, b, epilogue)
    library = lambda x, w, b: F.gelu(torch.addmm(b, x, w), approximate="tanh")
    got = [t.clone() for t in grads(port)]
    want = grads(plain)
    err = 0.0
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, **F32_TOL)
        err = max(err, (a - e).abs().max().item())
    # the function's own work: forward, dx and dw products; bytes of
    # x, w, b, g read and y, dx, dw, db written
    bound_ms, bound_by = bound(
        4 * 2 * (m * k + k * n + n + m * n), 3 * 2 * m * n * k, torch.float32
    )
    return {
        "m": m, "k": k, "n": n, "epilogue": epilogue, "dtype": "float32",
        "gradient": "dx, dw, db (forward and backward)",
        "timing": "eager: host launch overhead included",
        "max_abs_err": err, "tol": F32_TOL,
        "ms": time_ms(lambda: grads(port), 100, graph=False),
        "plain_ms": time_ms(lambda: grads(plain), 100, graph=False),
        "library_ms": time_ms(lambda: grads(library), 100, graph=False),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def main_path(device, ops, card_name) -> dict:
    from tpu_dist_torch import data, models
    from tpu_dist_torch.demos import train_dist
    from tpu_dist_torch.nn import nll_loss
    from tpu_dist_torch.train import TrainConfig, Trainer

    os.environ["TPU_DIST_PALLAS_DENSE"] = "1"
    os.environ.update(WORLD_SIZE="1", RANK="0", MASTER_ADDR="localhost")
    os.environ.pop("MASTER_PORT", None)  # world 1 takes a free port
    seed = TrainConfig().seed
    train_set = data.load_mnist("train")
    n_test = len(data.load_mnist("test"))
    x0, y0 = next(data.DistributedLoader(train_set, 1, 128, rank=0).epoch(0))
    x0, y0 = torch.from_numpy(x0), torch.from_numpy(y0)
    with torch.no_grad():
        fresh = models.mnist_net(torch.Generator().manual_seed(seed)).to(device).eval()
        first_loss = nll_loss(fresh(x0.to(device)), y0.to(device)).item()

    print("[main] python -m tpu_dist_torch.demos.train_dist --epochs 1 "
          "(TPU_DIST_PALLAS_DENSE=1, world 1, NCCL)", flush=True)
    ops.fused_dense.launches = 0
    t0 = time.perf_counter()
    _, history, accuracy = train_dist.main(["--epochs", "1"])
    wall = time.perf_counter() - t0
    launches = ops.fused_dense.launches
    (stats,) = history
    steps = len(train_set) // 128
    expected = 2 * (steps + math.ceil(n_test / 1024))
    print(f"[main] epoch 0: mean loss {stats.mean_loss} (first batch {first_loss}), "
          f"{stats.samples_per_sec} samples/s on {card_name}, train {stats.seconds} s, "
          f"eval accuracy {accuracy}; entry point wall time {wall} s "
          "(data generation, set-up, training and evaluation)", flush=True)
    print(f"[main] fused_dense launches {launches} (expected 2 x ({steps} steps + "
          f"{math.ceil(n_test / 1024)} eval batches) = {expected})", flush=True)
    check(expected == 956, f"expected 956 launches for the full sets, got {expected}")
    check(launches == expected, f"fused_dense launched {launches} times, not {expected}")
    check(stats.mean_loss < first_loss,
          f"mean loss {stats.mean_loss} not below the first batch's {first_loss}")
    check(accuracy >= 0.9, f"eval accuracy {accuracy} below 0.9")

    # One step from identical state, dropout off, on the card and the CPU.
    nets = []
    for _ in range(2):
        net = models.mnist_net(torch.Generator().manual_seed(seed))
        for layer in net:
            if hasattr(layer, "rate"):
                layer.rate = 0.0
        nets.append(net)
    nets[1].load_state_dict(nets[0].state_dict())
    quiet = TrainConfig(log=lambda line: None)
    on_card = Trainer(nets[0], quiet, device=device)
    on_cpu = Trainer(nets[1], quiet, device="cpu")
    loss_card = on_card.train_step(x0.to(device), y0.to(device)).item()
    loss_cpu = on_cpu.train_step(x0, y0).item()
    cpu_state = on_cpu.model.state_dict()
    param_diff = max(
        (t.cpu() - cpu_state[name]).abs().max().item()
        for name, t in on_card.model.state_dict().items()
    )
    print(f"[main] one step, dropout off: loss card {loss_card} cpu {loss_cpu} "
          f"|diff| {abs(loss_card - loss_cpu)}; updated params max |diff| "
          f"{param_diff}", flush=True)
    check(abs(loss_card - loss_cpu) <= 1e-5, "card and CPU losses differ by more than 1e-5")
    check(param_diff <= 1e-5, "card and CPU params differ by more than 1e-5")
    return {"launches": launches}


FLASH_REPLACES = {  # wrapper: (TPU kernel, CUDA source)
    "flash_fwd_sm90": ("tpu_dist/ops/flash_attention.py:47", "flash_attention_sm90.cu"),
    "flash_dkv_sm90": ("tpu_dist/ops/flash_attention.py:184", "flash_attention_sm90.cu"),
    "flash_dq_sm90": ("tpu_dist/ops/flash_attention.py:233", "flash_attention_sm90.cu"),
    "flash_fwd_simt": ("tpu_dist/ops/flash_attention.py:47", "flash_attention.cu"),
    "flash_dkv_simt": ("tpu_dist/ops/flash_attention.py:184", "flash_attention.cu"),
    "flash_dq_simt": ("tpu_dist/ops/flash_attention.py:233", "flash_attention.cu"),
}
# one attention call of the [lm] path: (batch, heads, S, head_dim)
LM_ATTENTION = (16, 12, 1024, 64)
LM_ROUTE = ("flash_fwd_sm90", "flash_dkv_sm90", "flash_dq_sm90")  # the kernels it launches
LM_F32_ROUTE = ("flash_fwd_simt", "flash_dkv_simt", "flash_dq_simt")  # float32 [lm]


def visible_fraction(S: int, causal: bool, window, flops, fa) -> float:
    """The share of the (S, S) scores the kernels compute: the causal
    fraction of `train.flops.attention_flops`, or the band's own count."""
    if window is None:
        return (flops.attention_flops(1, 1, S, S, 1, causal=causal)
                / flops.attention_flops(1, 1, S, S, 1))
    return fa.visible_mask(S, causal=causal, window=window).float().mean().item()


def flash_cases(device, fa, F, flops, checks) -> list[dict]:
    """Each flash kernel of the case's route against its plain version on
    the same inputs (`ops.checks.check_flash_kernels`: the forward's out
    and lse, then dK/dV and dQ from the plain forward's lse and D =
    rowsum(dO * out); the launch counts show the route's kernels ran).
    Times are CUDA events around eager launches (each launch runs for a
    tenth of a millisecond or more, above its launch cost).  The bound of
    each kernel is its own products at the operand type's peak against its
    bytes: 2 products forward, 4 for dK/dV (it recomputes P), 3 for dQ,
    each 2*bh*S*S*d times the visible fraction; ``tflops`` is those
    products over the kernel's time."""
    cases = [
        ("lm", LM_ATTENTION, torch.bfloat16, True, None),  # every [lm] call
        ("f32", LM_ATTENTION, torch.float32, True, None),
        ("f16", LM_ATTENTION, torch.float16, True, None),
        ("window", LM_ATTENTION, torch.bfloat16, True, 256),
        ("dense", (2, 12, 1024, 64), torch.float32, False, None),
        ("ragged", (2, 3, 96, 8), torch.float32, True, 40),
        ("ragged_bf16", (2, 6, 1000, 128), torch.bfloat16, True, None),
        ("d128_bf16", (4, 16, 2048, 128), torch.bfloat16, True, None),
        ("d256_f32", (2, 4, 1024, 256), torch.float32, True, None),
        ("d256_bf16", (2, 4, 1024, 256), torch.bfloat16, True, None),
        ("d256_f16", (2, 4, 1024, 256), torch.float16, True, None),
    ]
    rows = []
    for seed, (label, (b, h, S, d), dtype, causal, window) in enumerate(cases):
        bh = b * h
        q, k, v, go = checks.flash_inputs(bh, S, d, dtype, device, seed=seed + 1)
        kw = dict(causal=causal, window=window)
        d8_f32 = d == 8 and dtype == torch.float32
        checked = checks.check_flash_kernels(q, k, v, go, **kw, exact_dk=d8_f32)
        errs, tol, route = checked["max_abs_err"], checked["tol"], checked["route"]
        want_lse, delta = checked["lse"], checked["delta"]
        if d8_f32:
            print(f"[flash] dK elements that differ from the plain version at d = 8 float32: "
                  f"{checked['dk_differing']} of {bh * S * d}", flush=True)

        product = 2 * bh * S * S * d * visible_fraction(S, causal, window, flops, fa)
        block, row = bh * S * d * q.element_size(), bh * S * 4
        work = {"flash_fwd": (4 * block + row, 2 * product),
                "flash_dkv": (6 * block + 2 * row, 4 * product),
                "flash_dq": (5 * block + 2 * row, 3 * product)}
        q4, k4, v4, go4 = (t.view(b, h, S, d) for t in (q, k, v, go))
        mask = fa.visible_mask(S, causal=causal, window=window, device=device)
        library_kw = (dict(is_causal=causal) if window is None else dict(attn_mask=mask))
        library = lambda: F.scaled_dot_product_attention(q4, k4, v4, **library_kw)  # noqa: E731
        fwd_args, bwd_args = (q, k, v), (q, k, v, go, want_lse, delta)
        plain = {"flash_fwd": lambda: fa.flash_fwd_reference(*fwd_args, **kw),
                 "flash_dkv": lambda: fa.flash_dkv_reference(*bwd_args, **kw),
                 "flash_dq": lambda: fa.flash_dq_reference(*bwd_args, **kw)}
        # (function, wrapper, its error against the plain version)
        calls = [("flash_fwd", f"flash_fwd_{route}", errs["flash_fwd"]),
                 ("flash_dkv", f"flash_dkv_{route}", errs["flash_dkv"]),
                 ("flash_dq", f"flash_dq_{route}", errs["flash_dq"])]
        if label == "lm":  # the SIMT kernels on the same inputs, for comparison
            calls += simt_errors(fa, checks, fwd_args, bwd_args, kw)
        iters = 10 if S >= 1024 else 50
        shape = {"case": label, "q": [b, h, S, d], "dtype": str(dtype)[6:],
                 "causal": causal, "window": window}
        for fn, name, err in calls:
            kernel = getattr(fa, name)
            args = fwd_args if fn == "flash_fwd" else bwd_args
            bound_ms, bound_by = bound(*work[fn], dtype)
            ms = time_ms(lambda: kernel(*args, **kw), iters, graph=False)
            rows.append({
                "kernel": name, **shape, "max_abs_err": err, "tol": tol,
                "dk_differing": checked["dk_differing"] if name == f"flash_dkv_{route}" else None,
                "timing": f"CUDA events around {iters} eager launches",
                "ms": ms, "tflops": work[fn][1] / ms / 1e9,
                "plain_ms": time_ms(plain[fn], iters, graph=False),
                "library_ms": time_ms(library, iters, graph=False) if fn == "flash_fwd" else None,
                "bound_ms": bound_ms, "bound_by": bound_by,
            })
            print("[flash]", json.dumps(rows[-1]), flush=True)

        # forward + backward through the autograd Function (its D and the
        # cast of dO included) against SDPA's forward + backward
        leaves = [t.detach().requires_grad_() for t in (q4, k4, v4)]
        blocks = 256 if S % 256 == 0 else S  # the JAX block check: S divides by them

        def port_step():
            o = fa.flash_attention(*leaves, causal=causal, window=window, bq=blocks, bk=blocks)
            return torch.autograd.grad(o, leaves, go4)

        def library_step():
            o = F.scaled_dot_product_attention(*leaves, **library_kw)
            return torch.autograd.grad(o, leaves, go4)

        def plain_step():
            o, m = fa.flash_fwd_reference(q, k, v, **kw)
            dd = (go.float() * o.float()).sum(-1)
            fa.flash_dkv_reference(q, k, v, go, m, dd, **kw)
            return fa.flash_dq_reference(q, k, v, go, m, dd, **kw)

        # reads q, k, v, dO and writes out, dq, dk, dv; 9 products in all
        bound_ms, bound_by = bound(8 * block, sum(w[1] for w in work.values()), dtype)
        library_step_ms = time_ms(library_step, iters, graph=False)
        rows.append({
            "kernel": "flash fwd+bwd", **shape, "timing": f"CUDA events around {iters} "
            "eager forward + backward calls",
            "ms": time_ms(port_step, iters, graph=False),
            "plain_ms": time_ms(plain_step, iters, graph=False),
            "library_ms": library_step_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        print("[flash]", json.dumps(rows[-1]), flush=True)
        rows.append(backward_pair(rows, label, route, library_step_ms, work, dtype))
        print("[flash]", json.dumps(rows[-1]), flush=True)
        del q, k, v, go, checked, want_lse, delta, leaves, fwd_args, bwd_args, plain
        torch.cuda.empty_cache()
    past = checks.check_flash_past_2_31(device)
    print("[flash]", json.dumps({"case": "past 2^31", **past}), flush=True)
    torch.cuda.empty_cache()
    return rows


def simt_errors(fa, checks, fwd_args, bwd_args, kw) -> list:
    """The SIMT forward, dK/dV and dQ on inputs that the tensor-core route
    takes, held to the plain versions (its tolerance): what they are timed
    beside."""
    tol = checks.FLASH_TOL[fwd_args[0].dtype]
    out, _ = fa.flash_fwd_simt(*fwd_args, **kw)
    dk, dv = fa.flash_dkv_simt(*bwd_args, **kw)
    dq = fa.flash_dq_simt(*bwd_args, **kw)
    want_out, _ = fa.flash_fwd_reference(*fwd_args, **kw)
    want_dk, want_dv = fa.flash_dkv_reference(*bwd_args, **kw)
    want_dq = fa.flash_dq_reference(*bwd_args, **kw)
    torch.cuda.synchronize()
    errs = []
    for got, want in [(out, want_out), (dk, want_dk), (dv, want_dv), (dq, want_dq)]:
        torch.testing.assert_close(got, want, **tol)
        errs.append((got.float() - want.float()).abs().max().item())
    return [("flash_fwd", "flash_fwd_simt", errs[0]),
            ("flash_dkv", "flash_dkv_simt", max(errs[1:3])),
            ("flash_dq", "flash_dq_simt", errs[3])]


def backward_pair(rows, label, route, library_step_ms, work, dtype) -> dict:
    """dK/dV + dQ of the route beside the one library yardstick of the
    backward: SDPA's forward + backward less its forward (its backward is
    one autograd node that computes dQ, dK and dV together)."""
    def row_of(name):
        return next(r for r in rows if r["case"] == label and r["kernel"] == name)

    fwd, dkv, dq = (row_of(f"flash_{fn}_{route}") for fn in ("fwd", "dkv", "dq"))
    bound_ms, bound_by = bound(work["flash_dkv"][0] + work["flash_dq"][0],
                               work["flash_dkv"][1] + work["flash_dq"][1], dtype)
    return {
        "kernel": "flash backward pair (dK/dV + dQ)", "case": label,
        "kernels": [dkv["kernel"], dq["kernel"]], "ms": dkv["ms"] + dq["ms"],
        "plain_ms": dkv["plain_ms"] + dq["plain_ms"],
        "library_ms": library_step_ms - fwd["library_ms"],
        "library": "SDPA forward + backward less SDPA forward, same inputs",
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def profile_steps(trainer, tokens, steps: int, card_name: str, compute: str) -> dict:
    """Device time by kernel over a few training steps, from
    ``torch.profiler``, summed by kind of kernel (by name); the flash
    kernels' share of it and each flash kernel's time, and the share of the
    profiled steps' wall time
    the card was busy (the profiler slows the host, so this share is a
    floor)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us == 0:
        print("[lm] profile: no device time recorded; kernel shares not measured", flush=True)
        return {"device_us": None}
    kinds = {"flash": ("flash_",), "matmul": ("gemm", "nvjet", "cutlass", "sm90_xmma"),
             "elementwise": ("elementwise", "copy"), "reduce": ("reduce",),
             "softmax": ("softmax",)}
    by_kind = dict.fromkeys([*kinds, "other"], 0.0)
    for e in kernels:
        kind = next((k for k, tags in kinds.items()
                     if any(t in e.key.lower() for t in tags)), "other")
        by_kind[kind] += e.self_device_time_total / steps / 1e3
    flash = {}  # ms per step of each flash kernel, by its name in the source
    for e in kernels:
        name = re.search(r"flash_\w+_kernel", e.key)
        if name:
            flash[name[0]] = flash.get(name[0], 0.0) + e.self_device_time_total / steps / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    out = {
        "compute": compute, "steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
        "device_ms_per_step": device_us / steps / 1e3,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "device_ms_per_step_by_kind": by_kind,
        "flash_share_of_device_time": by_kind["flash"] * steps * 1e3 / device_us,
        "flash_ms_per_step_by_kernel": flash,
        "device_busy_share_of_wall": device_us / wall_us,
        "card": card_name,
        "top_kernels": [{"name": e.key[:120], "ms_per_step": e.self_device_time_total
                         / steps / 1e3, "calls_per_step": e.count / steps} for e in top],
    }
    print("[lm] profile", json.dumps(out), flush=True)
    return out


def lm_step_flops(flops, batch, seq, dim, depth, heads, vocab) -> float:
    """Model FLOPs of one training step: the products of every block (qkv,
    out, two MLP layers), causal attention and the tied head, forward and
    backward (3x forward)."""
    tokens = batch * seq
    block = (flops.linear_flops(tokens, dim, 3 * dim) + flops.linear_flops(tokens, dim, dim)
             + 2 * flops.linear_flops(tokens, dim, 4 * dim)
             + flops.attention_flops(batch, heads, seq, seq, dim // heads, causal=True))
    return flops.train_step_flops_estimate(depth * block + flops.linear_flops(tokens, dim, vocab))


def lm_fit(device, fa, flops, card_name, *, compute_dtype, steps_per_epoch: int,
           route: tuple) -> dict:
    """``LMTrainer.fit`` of the GPT-2-small-class TransformerLM for two
    epochs under TPU_DIST_FLASH=1 (the first includes the first steps'
    warm-up; the second is timed), with every flash launch count at 0
    before it and read after it: 12 a step of each kernel of ``route``,
    none of the others.  Then a profile of 3 steps."""
    from tpu_dist_torch import models
    from tpu_dist_torch.train import LMTrainConfig, LMTrainer

    depth, epochs, batch, seq = 12, 2, 16, 1024
    lm = models.TransformerLM(vocab=32768, dim=768, depth=depth, heads=12, max_seq=seq,
                              pos_embedding="rope", generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in lm.parameters())
    trainer = LMTrainer(lm, LMTrainConfig(global_batch=batch, compute_dtype=compute_dtype,
                                          log=lambda line: print("[lm]", line, flush=True)),
                        device=device)
    windows = models.synthetic_tokens(batch * steps_per_epoch, seq, 32768)
    compute = compute_dtype or "float32 (compute_dtype=None)"
    print(f"[lm] LMTrainer.fit: TransformerLM vocab 32768, dim 768, depth {depth}, heads 12, "
          f"rope, {n_params} params; seq {seq}, global batch {batch}, {compute} compute, "
          f"TPU_DIST_FLASH=1, torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}; {epochs} epochs of {steps_per_epoch} "
          "steps", flush=True)
    for kernel in fa.KERNELS:
        kernel.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    history = trainer.fit(windows, epochs=epochs)
    wall = time.perf_counter() - t0
    launches = {kernel.__name__: kernel.launches for kernel in fa.KERNELS}
    steps = epochs * steps_per_epoch
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    step_flops = lm_step_flops(flops, batch, seq, 768, depth, 12, 32768)
    dtype = getattr(torch, compute_dtype or "float32")
    peak = flops.peak_flops(PEAK_CARD, dtype)
    for stats in history:
        rate = step_flops * steps_per_epoch / stats.seconds
        print(f"[lm] {compute} epoch {stats.epoch}: mean loss {stats.mean_loss}, "
              f"{stats.tokens_per_sec} tokens/s, {stats.seconds} s, {rate / 1e12} model "
              f"TFLOP/s ({step_flops / 1e12} TFLOP per step), {rate / peak} of the "
              f"{str(dtype)[6:]} peak, on {card_name}", flush=True)
    expected = {name: depth * steps if name in route else 0 for name in launches}
    print(f"[lm] {compute} fit wall time {wall} s; peak device memory {peak_gb} GB; flash "
          f"launches {launches} (expected {expected}: {depth} x {steps} steps)", flush=True)
    check(launches == expected, f"flash launches {launches}, not {expected}")
    check(all(math.isfinite(s.mean_loss) for s in history), "non-finite epoch loss")
    tokens = trainer._to_device(windows[:batch].numpy())
    profile = profile_steps(trainer, tokens, 3, card_name, compute)
    del trainer, lm
    torch.cuda.empty_cache()
    return {"launches": launches, "history": history, "profile": profile}


def lm_path(device, fa, card_name) -> dict:
    from tpu_dist_torch import models
    from tpu_dist_torch.train import LMTrainConfig, LMTrainer, flops

    os.environ["TPU_DIST_FLASH"] = "1"
    # bfloat16 at head dim 64: the tensor-core forward, dK/dV and dQ
    bf16 = lm_fit(device, fa, flops, card_name, compute_dtype="bfloat16", steps_per_epoch=8,
                  route=LM_ROUTE)
    launches, history, profile = bf16["launches"], bf16["history"], bf16["profile"]
    check(history[1].mean_loss < history[0].mean_loss,
          f"epoch 1 mean loss {history[1].mean_loss} not below epoch 0's "
          f"{history[0].mean_loss}")
    # float32, the trainer's default: the SIMT forward, dK/dV and dQ
    f32 = lm_fit(device, fa, flops, card_name, compute_dtype=None, steps_per_epoch=4,
                 route=LM_F32_ROUTE)

    # One step from identical state, card against CPU, at a small size.
    small = dict(vocab=512, dim=128, depth=2, heads=2, max_seq=256, pos_embedding="rope")
    pair = [LMTrainer(models.TransformerLM(**small, generator=torch.Generator().manual_seed(1)),
                      LMTrainConfig(global_batch=2, log=lambda line: None), device=dev)
            for dev in (device, "cpu")]
    tokens = models.synthetic_tokens(2, 256, 512, seed=3)
    for kernel in fa.KERNELS:
        kernel.launches = 0
    loss_card = pair[0].loss_and_grads(tokens.to(device)).item()
    small_launches = {kernel.__name__: kernel.launches for kernel in fa.KERNELS}
    # float32: the SIMT route, one call of each kernel per block
    small_expected = {name: 0 if name.endswith("_sm90") else 2 for name in small_launches}
    check(small_launches == small_expected,
          f"small-LM flash launches {small_launches}, not {small_expected}")
    loss_cpu = pair[1].loss_and_grads(tokens).item()
    grad_diff = 0.0
    for name, p in pair[0].params.items():
        want = pair[1].params[name].grad
        # float32 sums in another order on each side, through a 512-way
        # softmax and two blocks
        torch.testing.assert_close(p.grad.cpu(), want, rtol=1e-3, atol=1e-5)
        grad_diff = max(grad_diff, (p.grad.cpu() - want).abs().max().item())
    print(f"[lm] one step of a small LM (vocab 512, dim 128, depth 2, heads 2, seq 256, "
          f"batch 2, float32, TPU_DIST_FLASH=1): loss card {loss_card} cpu {loss_cpu} "
          f"|diff| {abs(loss_card - loss_cpu)}; gradients max |diff| {grad_diff}; flash "
          f"launches on the card {small_launches}", flush=True)
    check(abs(loss_card - loss_cpu) <= 1e-5, "card and CPU losses differ by more than 1e-5")
    return {"launches": launches, "small_launches": small_launches, "history": history,
            "profile": profile, "f32": f32}


RING_WORLDS = (2, 3, 4)
RING_TIMED = (4, 64.0)  # world, MiB of float32 per rank
RING_SCHEDULE = ("reduce-scatter then all-gather of ceil(numel / n)-element chunks in one "
                 "launch (the chunked ring)")


def ring_path(checks, flops, metrics, card_name) -> dict:
    """The ring kernel under `comm.spmd` at each world on this one card
    (`ops.checks.check_ring`, which raises on any element that differs from
    the plain version, a rank whose output differs from rank 0's, a
    miscounted launch, a wrong workspace growth or a control-group
    collective on a timed call), the world-4 run timed, then the
    stuck-neighbour and mismatch checks."""
    runs = {}
    for world in RING_WORLDS:
        timed = world == RING_TIMED[0]
        res = checks.check_ring(world, time_mib=RING_TIMED[1] if timed else 0.0)
        runs[world] = res
        differing = {label: counts.tolist() for label, counts in res["differing"].items()}
        print(f"[ring] world {world}, {world} processes on one card: elements that differ "
              f"from the plain version, per rank: {json.dumps(differing)}; every rank's "
              f"output the same bits as rank 0's in all {len(res['digests'])} cases; kernel "
              f"launches per rank {res['launches'].tolist()}; workspace grew "
              f"{res['grows'].tolist()} times to {res['capacity'].tolist()} bytes", flush=True)
    world, mib = RING_TIMED
    res = runs[world]
    payload = int(mib * 2**20)
    ms = float(res["kernel_ms"].max())
    # every rank's input read once and output written once, all on this card
    bound_ms = 2 * world * payload / flops.peak_bytes_per_s(PEAK_CARD) * 1e3
    timing = {
        "world": world, "bytes_per_rank": payload, "dtype": "float32",
        "schedule": RING_SCHEDULE,
        "timing": "ms: the kernel's own device time per launch from torch.profiler over 20 "
                  "calls, the slowest rank; call_ms: CUDA events around 20 calls on each rank "
                  "after a barrier (the wrapper's host work included), the slowest rank; "
                  "gap_ms: the card idle between one launch and the next on the stream; "
                  "control_per_call: control-group collectives per timed call; phase_ms: "
                  "per launch, the mean over blocks of the kernel's waits and moves",
        "ms_per_rank": res["kernel_ms"].tolist(), "ms": ms,
        "call_ms_per_rank": res["call_ms"].tolist(), "call_ms": float(res["call_ms"].max()),
        "gap_ms_per_rank": res["gap_ms"].tolist(), "host_ms_per_rank": res["host_ms"].tolist(),
        "control_per_call_per_rank": res["control_per_call"].tolist(),
        "phase_ms_rank0": {k: float(v[0]) for k, v in res["phase_ms"].items()},
        "bus_gbps": metrics.allreduce_gbps(payload, float(res["call_ms"].max()) / 1e3, world),
        "differing": res["timed_differing"].tolist(),
        "max_abs_err": float(res["timed_max_abs_err"].max()),
        "plain_ms": float(res["plain_ms"][0]),
        "plain": "ring_all_reduce_reference of the 4 stacked inputs, rank 0 alone on the card",
        "bound_ms": bound_ms, "bound_by": "bytes",
        "bound_basis": f"{world} inputs read once and {world} outputs written once in HBM",
        "library_ms": None,
        "library": "none: NCCL refuses two ranks on one device",
        "card": card_name,
    }
    print("[ring]", json.dumps(timing), flush=True)
    stuck = checks.check_ring_stuck_neighbour()
    print(f"[ring] stuck neighbour: both ranks raised after {stuck['seconds']} s "
          f"(bound 2 s per wait): {stuck['message']}", flush=True)
    for kind, seen in checks.check_ring_mismatch().items():
        print(f"[ring] ranks that disagree ({kind}): both raised after {seen['seconds']} s "
              f"(bound 2 s per wait): {seen['messages'][0]}", flush=True)
    return {"launches": int(res["launches"][0]), "timing": timing}


def build_all(_build) -> None:
    """One nvcc per source, all started together."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = list(pool.map(_build.build, SOURCES))
    for built in builds:
        if built.command is None:
            print(f"[build] {built.path} already built", flush=True)
            continue
        print(f"[build] {' '.join(built.command)}  {built.seconds:.1f}s", flush=True)
        for line in built.log.splitlines():
            print(f"[build]   {line.strip()}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this check needs "
                 "an NVIDIA GPU")
    # the port itself: absent when this script stands alone
    import torch.nn.functional as F

    from tpu_dist_torch import ops
    from tpu_dist_torch.ops import _build, checks
    from tpu_dist_torch.train import flops, metrics

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card_name = torch.cuda.get_device_name(0)
    print(f"[env] python {platform.python_version()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}, "
          f"{torch.cuda.device_count()} card(s): {card_name}", flush=True)
    print(f"[env] nvidia-smi: {card_and_power_limit()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[env] TF32 off for matmul and cuDNN (float32 computed in float32)", flush=True)

    if sys.argv[1:] not in ([], ["--lm-f32"]):
        sys.exit("usage: python3 chip_smoke.py [--lm-f32]")
    if sys.argv[1:] == ["--lm-f32"]:
        os.environ["TPU_DIST_FLASH"] = "1"
        lm_fit(device, fa, flops, card_and_power_limit(), compute_dtype=None,
               steps_per_epoch=4, route=LM_F32_ROUTE)
        return

    build_all(_build)

    rows = matmul_cases(device, ops, F)
    launches = main_path(device, ops, card_name)["launches"]
    flash_rows = flash_cases(device, fa, F, flops, checks)
    lm = lm_path(device, fa, card_and_power_limit())  # tokens/s beside the card's power limit
    ring = ring_path(checks, flops, metrics, card_name)

    step = rows[:2]  # the two launches of one training step
    kernel = {
        "name": "fused_dense",
        "route": "cuda",
        "source": "tpu_dist_torch/ops/csrc/matmul.cu",
        "replaces": "tpu_dist/ops/matmul.py:38",
        "launches": launches,
        # over the main path's four shapes (training and evaluation)
        "max_abs_err": max(r["max_abs_err"] for r in rows[:4]),
        "ms": sum(r["ms"] for r in step),
        "plain_ms": sum(r["plain_ms"] for r in step),
        "bound_ms": sum(r["bound_ms"] for r in step),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in step) else "operations",
        "library_ms": sum(r["library_ms"] for r in step),
        "work": "one training step's two launches: 128x320x50 + 128x50x10 (MxKxN), "
                "float32, epilogue none",
        "tiling": [r["tiling"] for r in step],
    }
    kernels = [kernel]
    pairs = {case: next(r for r in flash_rows if r["case"] == case and "pair" in r["kernel"])
             for case in ("lm", "f32")}
    for name, (replaces, source) in FLASH_REPLACES.items():
        on_lm = name in LM_ROUTE  # else the SIMT route: float32, timed at the f32 case
        row = next(r for r in flash_rows
                   if r["kernel"] == name and r["case"] == ("lm" if on_lm else "f32"))
        entry = {
            "name": name, "route": "cuda", "source": f"tpu_dist_torch/ops/csrc/{source}",
            "replaces": replaces,
            "launches": lm["launches"][name] if on_lm else lm["f32"]["launches"][name],
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "tflops")},
            "work": "one attention call of the [lm] path: q, k, v (16, 12, 1024, 64) "
                    "bfloat16, causal; 12 calls per training step" if on_lm else
                    "one attention call of the float32 [lm] run: q, k, v (16, 12, 1024, 64) "
                    "float32, causal; 12 calls per training step",
        }
        if "_fwd_" not in name:  # SDPA's backward beside the route's dK/dV + dQ
            pair = pairs["lm" if on_lm else "f32"]
            entry["backward_pair"] = {
                key: pair[key] for key in ("kernels", "ms", "library_ms", "library")}
        if on_lm:  # the same [lm] inputs, SIMT
            simt = next(r for r in flash_rows
                        if r["case"] == "lm" and r["kernel"] == name.replace("sm90", "simt"))
            entry["simt_ms_same_inputs"] = simt["ms"]
        kernels.append(entry)
    timing = ring["timing"]
    kernels.append({
        "name": "ring_all_reduce", "route": "cuda",
        "source": "tpu_dist_torch/ops/csrc/ring.cu",
        "replaces": "tpu_dist/ops/pallas_ring.py:36", "launches": ring["launches"],
        **{key: timing[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
        "schedule": RING_SCHEDULE,
        "work": f"one call of {timing['bytes_per_rank']} bytes of float32 per rank at world "
                f"{timing['world']}, every rank a process on this one card; max_abs_err: that "
                "call's output against the plain version, the worst rank; ms: the kernel's "
                "own time per launch from torch.profiler, the slowest rank; launches: rank 0 "
                "of the world-4 run of [ring]; library_ms null: NCCL refuses two ranks on "
                "one device",
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_and_power_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
