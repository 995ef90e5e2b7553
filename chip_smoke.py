#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, in order; any failure raises and
the exit code is nonzero:

[env]     Python, torch, CUDA; the card's name and power limit; TF32 off.
[build]   the nvcc build of every kernel source, all started together, with
          each build's seconds and ptxas's registers and spills.
[matmul]  the fused-dense kernel against its plain version on the card, at
          the main path's four shapes, a few others and [image]'s heads
          (ResNet-18's 512 -> 10 and ViT-Ti's 192 -> 1000 at batches 128
          and 256, and ViT-Ti's in bfloat16), each with the route and
          tiles `dense_tiling` picked; times from CUDA events, beside
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
          cases, the ViT's (q, k, v (128, 3, 197, 64), non-causal, bfloat16
          and float32), and arrays past 2^31 elements; each kernel's time and
          TFLOP/s beside its bound, its plain version's and, for the
          forward and forward + backward, the time of
          ``scaled_dot_product_attention`` on the same inputs, and for the
          backward pair (dK/dV + dQ) SDPA's forward + backward less its
          forward; at the LM shape the SIMT forward, dK/dV and dQ timed too
          (each SIMT row with the `simt_tiling` it ran); the counts of dK
          and dQ elements that differ from the plain version at d = 8,
          float32.
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
[collectives] every collective of ``comm`` (all_reduce SUM/PRODUCT/MAX/MIN
          in float32 and int32, world-wide and over a group {0, 2}, reduce,
          broadcast, all_gather, gather, scatter, reduce_scatter,
          all_to_all) under ``comm.spmd`` at worlds 2, 3 and 4 on this
          card, one spawn a world, each held to its plain version on the
          stacked inputs (the ranks share the card, so Gloo carries every
          call through host memory); ``python -m
          tpu_dist_torch.demos.gather --world 4`` and its known answer; a
          ``comm.launch`` of 2 ranks through a ``file://`` store with
          ``restarts=1``, rank 1 failing attempt 0, returning on attempt 1.
[dp]      the MNIST Trainer at world 2 under ``comm.spmd`` (both ranks on
          this card, TPU_DIST_PALLAS_DENSE=1, synthetic MNIST, global batch
          128): 20 steps with ``grad_reduce="ring"``, then 20 with "psum"
          from the same seed; per rank the ring kernel launched 9 times a
          step (8 gradients and the loss) in the ring run and never in the
          psum run, fused dense twice a step; losses and final parameters
          the same bits in both runs and on both ranks, no control-group
          collective after the first step; seconds per step (a correctness
          run: the two ranks' kernels take turns on the card); then 3 more
          ring steps traced per rank: the ring kernel's device time a
          launch, the device's busy and idle share, the host's time a step.
[resume]  the trainers' checkpoints, accumulation and guard at full width
          (TPU_DIST_FLASH=1, TPU_DIST_PALLAS_DENSE=1): the bfloat16
          GPT-2-small-class LM's forward and backward at accum_steps 4
          against 1 from the same state (loss, gradient norm, peak memory,
          48 launches of each tensor-core flash kernel); ``fit`` of one
          epoch with ``checkpoint_dir``, ``verify``, ``latest_intact``, a
          restore into a trainer from another seed (params, m, v and step
          bit for bit), the checkpoint's size, snapshot and write seconds,
          and the resumed epoch 1 against the uninterrupted one; the same LM
          in float16 under ``nan_guard`` with ``loss_scale=2**15`` (2 x 4
          steps, finite and falling, bad steps counted) and one guarded
          update given a NaN gradient (state unchanged bit for bit, the
          scale halved); ``train_dist --epochs 1 --ckpt D`` then ``--epochs
          2 --ckpt D`` against ``--epochs 2`` (cuDNN deterministic) and an
          MNIST step at accum_steps 2 against 1 (4 fused-dense launches
          against 2); ``train_lm --steps 60 --corpus docs/tutorial.md --seq
          128`` (head dim 16: the SIMT flash kernels), its loss falling and
          its tokens/s.
[image]   the flash kernels of each route against their plain versions at
          the ViT's attention shape first; then ``python -m
          tpu_dist_torch.demos.train_image --model resnet18 --dataset
          cifar10 --epochs 2 --samples 4096`` (TPU_DIST_PALLAS_DENSE=1,
          float32): its launch counts in training (the fused-dense head
          once a step) and in evaluation, the loss falling, the test
          accuracy, epoch 1's samples/s, a step on a batch already on the
          card and its profile; one ResNet-18 step from the same state on
          the card and on the CPU (loss, params, batch-norm statistics
          within 1e-4); then ViT-Ti/16 at 224 (``--model vit --dataset
          imagenet --samples 512 --batch 128``, TPU_DIST_FLASH=1) in
          bfloat16 and in float32: in training 12 launches a step of each
          kernel of the route (tensor-core for bfloat16, SIMT for float32)
          and none of the other, in evaluation (float32 masters) 12 SIMT
          forwards; losses, images/s, a resident step and its profile.
[serve]   the GPT-2-small-class LM trained for 150 steps on the Markov corpus
          (`LMTrainer`, bfloat16), then served in float32 and in bfloat16
          (params and cache cast) by ``ServeEngine`` (max_batch 16, block 16,
          1,024 blocks, max_seq 1,024, prefill chunks of 128, 4 a round):
          48 seeded requests (prompts of 32-512 corpus tokens, 16-256 new;
          two thirds greedy, one third sampled at temperature 0.8, top_k 50,
          top_p 0.95; one cancelled mid-stream, one with a stop token).
          Gates: (1) every request finishes with its reason, the pool
          drains; (2) each greedy stream equals dense ``generate`` up to a
          first difference, which must be a tie (dense's top-2 margin under
          `SERVE_TIE`), ties under 1 % of the compared positions; (3) each
          sampled stream equals the same request alone through a fresh
          engine; (4) float32 ``apply_cached`` logits (2 x 256 prefill, 8
          decode steps) card against CPU; (5) ``generate_beam(beams=1)`` is
          greedy ``generate``, beams=4 sorted; (6) ``save_params`` then
          ``LMServer.from_artifact`` (meta-device structure) serves the same
          greedy tokens; (7) every event passes ``validate_dir``; (8) no
          hand-written kernel launches once training is done, with
          TPU_DIST_FLASH=1 and TPU_DIST_PALLAS_DENSE=1.  Reported: tokens/s,
          TTFT and TPOT p50/p99, static ``generate`` at batch 16 beside it,
          weights and pool bytes, peak memory, a decode step's launches and
          busy share (``torch.profiler``), the phase's seconds.

Then one JSON line per kernel (with its launches in each [image] run and
its ``vit`` row of [flash]), the card's name and power limit, and the
result line.  Without a CUDA device it exits nonzero before printing any
result.

    python3 chip_smoke.py --lm-f32

runs only [env] and the float32 [lm] sub-phase (the kernels built at first
use), to compare the SIMT kernels of two trees end to end, and prints no
result line.

    python3 chip_smoke.py --nccl

needs four cards: it runs only [env], the build, [collectives], [dp] and
[image-dp], where each rank now has a card of its own, so the collectives
take NCCL on the card and [dp]'s ring kernel crosses NVLink; [image-dp]
(`ops.checks.check_image_dp`) trains ResNet-18 at world 4 under "psum" for
10 steps of 128 and requires every parameter and batch-norm buffer to hold
the same bits on every rank; no result line.

    python3 chip_smoke.py --resume

runs only [env], the build and [resume]; no result line.

    python3 chip_smoke.py --image

runs only [env], the build, [matmul]'s image-head cases and [image], to
compare it between two trees
(run this file from each tree's root); no result line.

    python3 chip_smoke.py --serve

runs only [env], the build and [serve]; no result line.

    python3 chip_smoke.py --main

runs only [env], the build, [matmul] and [main], the order the whole run
reaches [main] in, to compare [main]'s samples/s between two trees (run
this file from each tree's root); no result line.
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


MATMUL_CASES = [  # (M, K, N, epilogue, dtype)
    (128, 320, 50, "none", torch.float32),  # training step: fc1
    (128, 50, 10, "none", torch.float32),  # training step: fc2
    (1024, 320, 50, "none", torch.float32),  # evaluation batch: fc1
    (1024, 50, 10, "none", torch.float32),  # evaluation batch: fc2
    (300, 270, 520, "relu", torch.float32),
    (300, 270, 520, "gelu", torch.float32),
    (4096, 4096, 4096, "none", torch.float32),
    (4096, 4096, 4096, "none", torch.bfloat16),
]
# the classifier heads of [image]: ResNet-18's 512 -> 10 and ViT-Ti's
# 192 -> 1000, at the training batch and the evaluation batch (float32
# masters in evaluation)
IMAGE_HEAD_CASES = [
    (128, 512, 10, "none", torch.float32),  # ResNet-18 training step
    (256, 512, 10, "none", torch.float32),  # ResNet-18 evaluation batch
    (128, 192, 1000, "none", torch.float32),  # ViT-Ti float32 training step
    (128, 192, 1000, "none", torch.bfloat16),  # ViT-Ti bfloat16 training step
    (256, 192, 1000, "none", torch.float32),  # ViT-Ti evaluation batch
]


def matmul_cases(device, ops, F) -> list[dict]:
    """The rows of MATMUL_CASES, the gradient case's, then those of
    IMAGE_HEAD_CASES: each held to the plain version and timed."""
    gen = torch.Generator(device).manual_seed(0)
    rows = dense_rows(device, ops, F, MATMUL_CASES, gen)
    grad = gradient_case(device, ops, F, gen)
    print("[matmul]", json.dumps(grad), flush=True)
    return rows + [grad] + image_head_rows(device, ops, F)


def image_head_rows(device, ops, F) -> list[dict]:
    return dense_rows(device, ops, F, IMAGE_HEAD_CASES, torch.Generator(device).manual_seed(2))


def dense_rows(device, ops, F, cases, gen) -> list[dict]:
    dense_tiling = importlib.import_module("tpu_dist_torch.ops.matmul").dense_tiling
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    library_epilogue = {
        "none": lambda y: y,
        "relu": F.relu,
        "gelu": lambda y: F.gelu(y, approximate="tanh"),
    }
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
    os.environ.pop("MASTER_PORT", None)  # world 1: an in-process store, no port
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
VIT_ATTENTION = (128, 3, 197, 64)  # one attention call of ViT-Ti/16 at 224: (b, heads, S, d)
VIT_DEPTH = 12


FLASH_CASES = [  # label, (b, heads, S, d), dtype, causal, window
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
    ("vit", VIT_ATTENTION, torch.bfloat16, False, None),  # every bf16 [image] ViT call
    ("vit_f32", VIT_ATTENTION, torch.float32, False, None),  # every float32 one
]


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
    rows = []
    for seed, (label, (b, h, S, d), dtype, causal, window) in enumerate(FLASH_CASES):
        bh = b * h
        q, k, v, go = checks.flash_inputs(bh, S, d, dtype, device, seed=seed + 1)
        kw = dict(causal=causal, window=window)
        d8_f32 = d == 8 and dtype == torch.float32
        checked = checks.check_flash_kernels(q, k, v, go, **kw, exact_dk=d8_f32, exact_dq=d8_f32)
        errs, tol, route = checked["max_abs_err"], checked["tol"], checked["route"]
        want_lse, delta = checked["lse"], checked["delta"]
        if d8_f32:
            print(f"[flash] dK elements that differ from the plain version at d = 8 float32: "
                  f"{checked['dk_differing']} of {bh * S * d}; dQ elements: "
                  f"{checked['dq_differing']} of {bh * S * d}", flush=True)

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
                "tiling": fa.simt_tiling(fn[6:], d)._asdict() if name.endswith("_simt") else None,
                "dk_differing": checked["dk_differing"] if name == f"flash_dkv_{route}" else None,
                "dq_differing": checked["dq_differing"] if name == f"flash_dq_{route}" else None,
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


def profile_steps(step, steps: int, card_name: str, compute: str, phase: str = "[lm]") -> dict:
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
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    if device_us == 0:
        print(f"{phase} profile: no device time recorded; kernel shares not measured", flush=True)
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
    print(f"{phase} profile", json.dumps(out), flush=True)
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
    profile = profile_steps(lambda: trainer.train_step(tokens), 3, card_name, compute)
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


COLLECTIVE_WORLDS = (2, 3, 4)
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


def layout(world: int) -> str:
    """Where ``world`` ranks of ``comm.spmd`` run on this host, and the
    backend `comm.choose_backend` gives them."""
    if world > torch.cuda.device_count():
        return (f"{world} processes on one card (Gloo control group; collectives staged "
                "through host memory)")
    return f"{world} processes, one card each (NCCL; nothing staged)"


def collectives_path(checks, card: str) -> None:
    """`ops.checks.check_collectives` at each world, the gather demo as a
    subprocess, and `ops.checks.check_launch_restart`; each with its
    seconds."""
    t0 = time.perf_counter()
    for world in COLLECTIVE_WORLDS:
        res = checks.check_collectives(world)
        print(f"[collectives] world {world}, {layout(world)}: {res['cases']} cases equal to their plain "
              f"versions (float32 SUM and PRODUCT max |diff| {res['max_abs_err']}, the rest "
              f"bit for bit) in {res['seconds']} s", flush=True)
    t1 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m", "tpu_dist_torch.demos.gather", "--world", "4"],
                          cwd=root, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"the gather demo exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = [line for line in proc.stdout.splitlines() if "sum after gather" in line]
    want = [f"Rank {r} sum after gather: {4.0 if r == 0 else 0.0:.1f} " for r in range(4)]
    check(len(lines) == 4 and all(line.startswith(w) for line, w in zip(lines, want)),
          f"the gather demo printed {lines}")
    for line in lines:
        print(f"[collectives] demos.gather --world 4: {line}", flush=True)
    print(f"[collectives] demos.gather --world 4 ({layout(4)}): {time.perf_counter() - t1} s",
          flush=True)
    launched = checks.check_launch_restart()
    print(f"[collectives] comm.launch(world 2, {layout(2)}, file:// store, restarts=1), rank 1 failing "
          f"attempt 0: (all_reduce of ones, attempt) per rank {launched['results']} in "
          f"{launched['seconds']} s", flush=True)
    print(f"[collectives] phase {time.perf_counter() - t0} s on {card}", flush=True)


def dp_path(checks, card: str) -> dict:
    """`ops.checks.check_dp`: the ring kernel on the MNIST training path."""
    t0 = time.perf_counter()
    res = checks.check_dp()
    steps, tensors = res["steps"], res["tensors"]
    check(tensors == 9, f"{tensors} tensors a step, not 9 (8 gradients and the loss)")
    shared = res["world"] > torch.cuda.device_count()
    print(f"[dp] MNIST Trainer, world {res['world']}, {layout(res['world'])} (comm.spmd, "
          f"TPU_DIST_PALLAS_DENSE=1, synthetic MNIST, global batch 128), {steps} steps "
          f"with grad_reduce='ring' and {steps} with 'psum' from seed 0: ring launches per "
          f"rank {res['ring_launches']} (expected {tensors} x {steps}), in the psum run "
          f"{res['psum_ring_launches']}; fused dense per rank {res['dense_launches']} "
          f"(2 a step) in each run; losses and final parameters bit for bit equal between the "
          f"runs and the ranks ({res['elements_differing']} elements differ); losses "
          f"{res['losses']}", flush=True)
    note = ("a correctness run, no bandwidth measure: the ranks share one card, so their "
            "kernels take turns" if shared else "each rank on a card of its own")
    print(f"[dp] seconds per step, per rank: {json.dumps(res['seconds_per_step'])}; the first "
          f"step (the ring's workspace grows): {json.dumps(res['first_step_seconds'])}; steps "
          f"2-{steps} per step: {json.dumps(res['later_seconds_per_step'])} on {card}; {note}; "
          "control-group collectives after step 1 per rank: 0", flush=True)
    print(f"[dp] traced ring steps, per rank (torch.profiler; ring_kernel_ms: a launch's mean "
          f"device time; busy_ms, wall_ms, host_ms: per step): {json.dumps(res['trace'])} on "
          f"{card}; phase {time.perf_counter() - t0} s", flush=True)
    return res


GPT2_SMALL = dict(vocab=32768, dim=768, depth=12, heads=12, max_seq=1024, pos_embedding="rope")


def counts(fa, ops) -> dict:
    return {k.__name__: k.launches for k in (*fa.KERNELS, ops.fused_dense)}


def zero_counts(fa, ops) -> None:
    for k in (*fa.KERNELS, ops.fused_dense):
        k.launches = 0


def lm_resume(device, fa, ops, card: str) -> dict:
    """The GPT-2-small-class LM in bfloat16 (TPU_DIST_FLASH=1): one
    accumulated step against one plain step from the same state, then a
    checkpointed epoch, a restore into a trainer built from another seed,
    and the next epoch resumed against the same epoch uninterrupted."""
    import tempfile

    from tpu_dist_torch import models
    from tpu_dist_torch.train import LMTrainConfig, LMTrainer, checkpoint, global_norm

    batch, seq, steps = 16, 1024, 4
    windows = models.synthetic_tokens(batch * steps, seq, GPT2_SMALL["vocab"], seed=5)

    def trainer(seed, **cfg):
        lm = models.TransformerLM(**GPT2_SMALL, generator=torch.Generator().manual_seed(seed))
        return LMTrainer(lm, LMTrainConfig(global_batch=batch, compute_dtype="bfloat16",
                                           log=lambda line: print("[resume]", line, flush=True),
                                           **cfg), device=device)

    first = trainer(0)
    tokens = first._to_device(windows[:batch].numpy())
    step = {}
    for accum in (4, 1):
        first.config.accum_steps = accum
        zero_counts(fa, ops)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        loss = first.loss_and_grads(tokens).item()
        norm = global_norm({k: p.grad for k, p in first.params.items()}).item()
        step[accum] = {"loss": loss, "grad_norm": norm, "launches": counts(fa, ops),
                       "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9}
    print(f"[resume] LM bf16, one global batch of {batch} x {seq}: accum_steps 4 "
          f"{json.dumps(step[4])}; accum_steps 1 {json.dumps(step[1])}; on {card}", flush=True)
    loss_rel = abs(step[4]["loss"] - step[1]["loss"]) / abs(step[1]["loss"])
    norm_rel = abs(step[4]["grad_norm"] - step[1]["grad_norm"]) / abs(step[1]["grad_norm"])
    check(loss_rel <= 1e-3, f"accum 4 loss {step[4]['loss']} vs accum 1 {step[1]['loss']}")
    check(norm_rel <= 1e-2, f"accum 4 gradient norm {step[4]['grad_norm']} vs "
          f"{step[1]['grad_norm']}")
    check(step[4]["peak_gb"] < step[1]["peak_gb"], "accum 4 did not lower peak memory")
    depth = GPT2_SMALL["depth"]
    want = {name: 4 * depth if name in LM_ROUTE else 0 for name in step[4]["launches"]}
    check(step[4]["launches"] == want, f"accum 4 launches {step[4]['launches']}, not {want}")
    first.config.accum_steps = 1

    with tempfile.TemporaryDirectory() as tmp:
        zero_counts(fa, ops)
        first.fit(windows, epochs=1, checkpoint_dir=tmp)
        fit_launches = counts(fa, ops)
        path = os.path.join(tmp, "lm_ckpt_0.npz")
        t0 = time.perf_counter()
        intact = checkpoint.verify(path)
        verify_s = time.perf_counter() - t0
        check(intact, "verify() refused the fit's checkpoint")
        check(str(checkpoint.latest_intact(tmp)) == path, "latest_intact did not pick it")
        second = trainer(1)
        t0 = time.perf_counter()
        check(second.restore(path) == 1, "restore did not return epoch 1")
        restore_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        for name, p in first.params.items():
            for got, want_t in ((second.params[name], p),
                                (second.opt_state["m"][name], first.opt_state["m"][name]),
                                (second.opt_state["v"][name], first.opt_state["v"][name])):
                check(torch.equal(got, want_t), f"restored {name} differs")
        check(torch.equal(second.opt_state["step"], first.opt_state["step"]), "step differs")
        writer = checkpoint.AsyncCheckpointer()
        timed = os.path.join(tmp, "timed.npz")
        first.save(timed, epoch=1, async_writer=writer)
        writer.wait()
        size = os.path.getsize(timed)
        print(f"[resume] checkpoint of {sum(p.numel() for p in first.params.values())} "
              f"float32 params + m + v: {size} bytes; snapshot (device to host) "
              f"{writer.snapshot_seconds} s, write {writer.write_seconds} s (background "
              f"thread), verify {verify_s} s, restore {restore_s} s; on {card}", flush=True)
        (resumed,) = second.fit(windows, start_epoch=1, epochs=2)
        (uninterrupted,) = first.fit(windows, start_epoch=1, epochs=2)
    rel = abs(resumed.mean_loss - uninterrupted.mean_loss) / abs(uninterrupted.mean_loss)
    print(f"[resume] epoch 1: resumed {resumed.mean_loss}, uninterrupted "
          f"{uninterrupted.mean_loss}, rel {rel}; fit launches {json.dumps(fit_launches)}",
          flush=True)
    check(rel <= 1e-4, f"resumed epoch-1 loss {resumed.mean_loss} vs {uninterrupted.mean_loss}")
    del first, second
    torch.cuda.empty_cache()
    return {"accum": step, "fit_launches": fit_launches, "bytes": size,
            "snapshot_s": writer.snapshot_seconds, "write_s": writer.write_seconds}


def lm_guarded_f16(device, fa, ops, card: str) -> dict:
    """The same LM in float16 under ``nan_guard`` with ``loss_scale=2**15``:
    2 epochs of 4 steps, then one guarded update given a NaN gradient."""
    from tpu_dist_torch import models
    from tpu_dist_torch.resilience import guards
    from tpu_dist_torch.train import LMTrainConfig, LMTrainer

    batch, seq, steps = 16, 1024, 4
    lm = models.TransformerLM(**GPT2_SMALL, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        # float16's LayerNorm backward overflows at the init's std of 0.02
        # (rsqrt(var)^3 = 1.25e5 > 65504), in both packages: start at 0.1
        lm.embed.table.mul_(5.0)
    trainer = LMTrainer(lm, LMTrainConfig(global_batch=batch, compute_dtype="float16",
                                          nan_guard=True, loss_scale=2.0**15,
                                          log=lambda line: print("[resume]", line, flush=True)),
                        device=device)
    windows = models.synthetic_tokens(batch * steps, seq, GPT2_SMALL["vocab"], seed=6)
    zero_counts(fa, ops)
    history = trainer.fit(windows, epochs=2)
    launches = counts(fa, ops)
    want = {name: GPT2_SMALL["depth"] * 2 * steps if name.endswith("_sm90") else 0
            for name in launches}
    print(f"[resume] float16, nan_guard, loss_scale 2**15: losses "
          f"{[h.mean_loss for h in history]}, bad_steps {[h.bad_steps for h in history]}, "
          f"scale {guards.loss_scale(trainer.opt_state)}, tokens/s "
          f"{[h.tokens_per_sec for h in history]}, launches {json.dumps(launches)}; on {card}",
          flush=True)
    check(launches == want, f"float16 launches {launches}, not {want}")
    check(all(math.isfinite(h.mean_loss) for h in history), "non-finite float16 epoch loss")
    check(history[1].mean_loss < history[0].mean_loss, "float16 epoch 1 not below epoch 0")

    trainer.loss_and_grads(trainer._to_device(windows[:batch].numpy()))
    grads = {k: p.grad for k, p in trainer.params.items()}
    next(iter(grads.values())).view(-1)[7] = float("nan")
    params = {k: p.detach().clone() for k, p in trainer.params.items()}
    inner = {key: {k: t.clone() for k, t in trainer.opt_state["inner"][key].items()}
             for key in ("m", "v")}
    inner_step = trainer.opt_state["inner"]["step"].clone()
    bad, scale = guards.bad_steps(trainer.opt_state), guards.loss_scale(trainer.opt_state)
    trainer.optimizer.update(trainer.params, grads, trainer.opt_state)
    torch.cuda.synchronize()
    same = all(torch.equal(p, params[k]) for k, p in trainer.params.items()) and all(
        torch.equal(trainer.opt_state["inner"][key][k], t)
        for key in inner for k, t in inner[key].items()
    ) and torch.equal(trainer.opt_state["inner"]["step"], inner_step)
    after = (guards.bad_steps(trainer.opt_state), guards.loss_scale(trainer.opt_state))
    print(f"[resume] guarded update with a NaN gradient: params and state unchanged {same}, "
          f"bad_steps {bad} -> {after[0]}, scale {scale} -> {after[1]}", flush=True)
    check(same, "a NaN step changed the params or the optimizer state")
    check(after == (bad + 1, max(scale / 2, 1.0)), f"guard scalars {after} after a bad step")
    del trainer, lm
    torch.cuda.empty_cache()
    return {"launches": launches, "history": [h.mean_loss for h in history]}


def mnist_resume(device, ops, card: str) -> dict:
    """``train_dist --epochs 1 --ckpt D`` then ``--epochs 2 --ckpt D``
    against ``--epochs 2`` uninterrupted (TPU_DIST_PALLAS_DENSE=1, cuDNN
    deterministic), and one step at accum_steps 2 against 1."""
    import tempfile

    from tpu_dist_torch import data, models
    from tpu_dist_torch.demos import train_dist
    from tpu_dist_torch.train import TrainConfig, Trainer

    os.environ.update(WORLD_SIZE="1", RANK="0", MASTER_ADDR="localhost")
    os.environ.pop("MASTER_PORT", None)  # world 1: an in-process store, no port
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False  # the runs must compute the same bits
    ops.fused_dense.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        train_dist.main(["--epochs", "1", "--ckpt", tmp])
        _, resumed, _ = train_dist.main(["--epochs", "2", "--ckpt", tmp])
        _, whole, _ = train_dist.main(["--epochs", "2"])
    runs_launches = ops.fused_dense.launches
    # 468 steps an epoch and 10 evaluation batches a run, 2 launches each
    check(runs_launches == 2 * (4 * 468 + 3 * 10),
          f"fused dense launched {runs_launches} times in the three runs, not 3804")
    check([h.epoch for h in resumed] == [1], f"resumed epochs {[h.epoch for h in resumed]}")
    rel = abs(resumed[0].mean_loss - whole[1].mean_loss) / whole[1].mean_loss
    print(f"[resume] train_dist --ckpt: epoch 1 resumed {resumed[0].mean_loss}, uninterrupted "
          f"{whole[1].mean_loss}, rel {rel}; fused_dense {runs_launches} launches in the "
          "three runs", flush=True)
    check(rel <= 1e-5, "resumed MNIST epoch 1 differs from the uninterrupted one")

    x, y = data.synthetic_mnist(128, seed=2)[:]
    x, y = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    out = {}
    for accum in (2, 1):
        net = models.mnist_net(torch.Generator().manual_seed(0))
        for layer in net:
            if hasattr(layer, "rate"):
                layer.rate = 0.0
        trainer = Trainer(net, TrainConfig(accum_steps=accum, log=lambda line: None),
                          device=device)
        ops.fused_dense.launches = 0
        out[accum] = (trainer.train_step(x, y).item(), ops.fused_dense.launches)
    print(f"[resume] MNIST step, accum_steps 2: loss {out[2][0]}, fused_dense {out[2][1]}; "
          f"accum_steps 1: loss {out[1][0]}, fused_dense {out[1][1]}", flush=True)
    check(abs(out[2][0] - out[1][0]) <= 1e-5, "accum 2 loss differs from accum 1 by > 1e-5")
    check((out[2][1], out[1][1]) == (4, 2), f"fused dense launches {out[2][1]}, {out[1][1]}")
    cudnn.deterministic, cudnn.benchmark = before
    return {"runs_launches": runs_launches, "accum_launches": {2: out[2][1], 1: out[1][1]}}


def lm_demo(fa, ops, card: str) -> dict:
    """``python -m tpu_dist_torch.demos.train_lm --steps 60 --corpus
    docs/tutorial.md --seq 128`` (TPU_DIST_FLASH=1): head dim 16, the SIMT
    kernels."""
    from tpu_dist_torch.demos import train_lm

    corpus = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs", "tutorial.md")
    zero_counts(fa, ops)
    out = train_lm.main(["--steps", "60", "--corpus", corpus, "--seq", "128"])
    launches = counts(fa, ops)
    losses = out["losses"]
    print(f"[resume] train_lm --steps 60 --corpus docs/tutorial.md --seq 128: loss "
          f"{losses[0]} -> {losses[-1]}, {out['tokens_per_sec']} tokens/s, held-out "
          f"perplexity {out['val_perplexity']}, launches {json.dumps(launches)}; on {card}",
          flush=True)
    check(losses[-1] < losses[0], "train_lm's loss did not fall")
    # depth 2: 60 training steps, and the held-out pass's forward (one batch)
    want = {name: 2 * 60 + (2 if name == "flash_fwd_simt" else 0) if name in LM_F32_ROUTE
            else 0 for name in launches}
    check(launches == want, f"train_lm launches {launches}, not {want}")
    return {"launches": launches, "tokens_per_sec": out["tokens_per_sec"]}


def resume_path(device, fa, ops, card: str) -> dict:
    t0 = time.perf_counter()
    os.environ["TPU_DIST_FLASH"] = "1"
    os.environ["TPU_DIST_PALLAS_DENSE"] = "1"
    out = {"lm": lm_resume(device, fa, ops, card), "f16": lm_guarded_f16(device, fa, ops, card),
           "mnist": mnist_resume(device, ops, card), "demo": lm_demo(fa, ops, card)}
    print(f"[resume] phase {time.perf_counter() - t0} s on {card}", flush=True)
    return out


IMAGE_RESNET = ["--model", "resnet18", "--dataset", "cifar10", "--epochs", "2",
                "--samples", "4096"]
IMAGE_VIT = ["--model", "vit", "--dataset", "imagenet", "--epochs", "2", "--samples", "512",
             "--batch", "128"]


def image_demo(fa, ops, argv: list[str]) -> dict:
    """``python -m tpu_dist_torch.demos.train_image <argv>`` in this process,
    every launch count set to 0 just before it; the counts read at the last
    epoch's line (training) and at the end (training and evaluation)."""
    from tpu_dist_torch.demos import train_image

    lines = []

    def log(line):
        lines.append((line, counts(fa, ops)))
        print("[image]", line, flush=True)

    zero_counts(fa, ops)
    t0 = time.perf_counter()
    trainer, history, accuracy = train_image.main(argv, log=log)
    wall = time.perf_counter() - t0
    total = counts(fa, ops)
    fit = next(c for line, c in lines if line.startswith(f"Rank 0 of 1, epoch {len(history) - 1}:"))
    out = {"history": history, "accuracy": accuracy, "wall": wall, "fit": fit,
           "eval": {name: total[name] - fit[name] for name in total}}
    print(f"[image] {' '.join(argv)}: launches in training {json.dumps(fit)}, in evaluation "
          f"{json.dumps(out['eval'])}; entry point wall time {wall} s (data generation, set-up, "
          "training and evaluation)", flush=True)
    # the step alone, on a batch already on the card: against the epoch's
    # seconds a step, what the host's batch assembly and copy add
    size = 224 if "imagenet" in argv else 32
    x = torch.randn(128, size, size, 3, device=trainer.device)
    y = torch.randint(0, 10, (128,), device=trainer.device)
    compute = "bfloat16" if argv[-2:] == ["--bf16", "1"] else "float32"
    out["step_ms"] = time_ms(lambda: trainer.train_step(x, y), 5, graph=False)
    print(f"[image] {argv[1]} {compute}: a step on a batch already on the card "
          f"{out['step_ms']} ms (CUDA events around 5 steps)", flush=True)
    out["profile"] = profile_steps(lambda: trainer.train_step(x, y), 3, card_and_power_limit(),
                                   compute, phase=f"[image] {argv[1]} {compute}")
    return out


def resnet_card_against_cpu(device) -> dict:
    """One step of ResNet-18 (batch 128, TPU_DIST_PALLAS_DENSE=1) from the
    same state on the card and on the CPU: loss, parameters and batch-norm
    statistics within 1e-4 (float32 sums in another order; about 3e-5 of
    float32's own spread on the params after a step at lr 0.05)."""
    from tpu_dist_torch import data, models, nn
    from tpu_dist_torch.train import TrainConfig, Trainer

    x, y = next(data.DistributedLoader(data.synthetic_cifar10(128, seed=0), 1, 128,
                                       rank=0).epoch(0))
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    cfg = TrainConfig(global_batch=128, lr=0.05, momentum=0.9, log=lambda line: None)
    pair = [Trainer(models.resnet18(generator=torch.Generator().manual_seed(1234)), cfg,
                    device=dev, loss=nn.cross_entropy) for dev in (device, "cpu")]
    loss_card = pair[0].train_step(x.to(device), y.to(device)).item()
    loss_cpu = pair[1].train_step(x, y).item()
    cpu_state = pair[1].model.state_dict()
    diff = {"params": 0.0, "batch-norm statistics": 0.0}
    for name, t in pair[0].model.state_dict().items():
        kind = "batch-norm statistics" if name.endswith((".mean", ".var")) else "params"
        diff[kind] = max(diff[kind], (t.cpu() - cpu_state[name]).abs().max().item())
    print(f"[image] one ResNet-18 step (batch 128, float32) from the same state: loss card "
          f"{loss_card} cpu {loss_cpu} |diff| {abs(loss_card - loss_cpu)}; max |diff| "
          f"{json.dumps(diff)}", flush=True)
    check(abs(loss_card - loss_cpu) <= 1e-4, "card and CPU losses differ by more than 1e-4")
    for kind, d in diff.items():
        check(d <= 1e-4, f"card and CPU {kind} differ by {d}, more than 1e-4")
    return {"loss_card": loss_card, "loss_cpu": loss_cpu, **diff}


def image_path(device, fa, ops, checks, card: str) -> dict:
    """[image]: the image-classification entry point at BASELINE configs 4
    and 5, then the ViT's attention kernels at its shape."""
    t0 = time.perf_counter()
    os.environ["TPU_DIST_PALLAS_DENSE"] = "1"
    os.environ["TPU_DIST_FLASH"] = "1"
    os.environ.update(WORLD_SIZE="1", RANK="0", MASTER_ADDR="localhost")
    os.environ.pop("MASTER_PORT", None)  # world 1: an in-process store, no port
    none = dict.fromkeys(counts(fa, ops), 0)

    # the ViT's attention shape through each route, held to the plain versions first
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, go = checks.flash_inputs(VIT_ATTENTION[0] * VIT_ATTENTION[1],
                                          *VIT_ATTENTION[2:], dtype, device, seed=3)
        res = checks.check_flash_kernels(q, k, v, go, causal=False, window=None)
        print(f"[image] flash kernels at the ViT's attention {list(VIT_ATTENTION)} "
              f"{str(dtype)[6:]}, non-causal, route {res['route']}: max |err| "
              f"{json.dumps(res['max_abs_err'])} (tol {res['tol']})", flush=True)
        del q, k, v, go, res

    print("[image] python -m tpu_dist_torch.demos.train_image " + " ".join(IMAGE_RESNET)
          + " (TPU_DIST_PALLAS_DENSE=1, float32, world 1)", flush=True)
    resnet = image_demo(fa, ops, IMAGE_RESNET)
    history = resnet["history"]
    steps, eval_batches = 2 * 4096 // 128, math.ceil(2000 / 256)
    fit, evaluation = resnet["fit"], resnet["eval"]
    check(fit == {**none, "fused_dense": steps}, f"resnet18 training: launches {fit}")
    check(evaluation == {**none, "fused_dense": eval_batches},
          f"resnet18 evaluation: launches {evaluation}")
    check(history[1].mean_loss < history[0].mean_loss,
          f"epoch 1 mean loss {history[1].mean_loss} not below epoch 0's {history[0].mean_loss}")
    check(resnet["accuracy"] >= 0.9, f"test accuracy {resnet['accuracy']} below 0.9")
    print(f"[image] resnet18: epoch losses {[h.mean_loss for h in history]}, test accuracy "
          f"{resnet['accuracy']}; epoch 1 (warm) {history[1].samples_per_sec} samples/s, "
          f"{history[1].seconds} s, on {card}; fused dense {steps} in training (one a step) "
          f"+ {eval_batches} in evaluation", flush=True)
    step = resnet_card_against_cpu(device)

    vit = {}
    for compute, flag in (("bfloat16", "1"), ("float32", "0")):
        print("[image] python -m tpu_dist_torch.demos.train_image " + " ".join(IMAGE_VIT)
              + f" --bf16 {flag} (TPU_DIST_FLASH=1, TPU_DIST_PALLAS_DENSE=1)", flush=True)
        run = vit[compute] = image_demo(fa, ops, IMAGE_VIT + ["--bf16", flag])
        history, steps = run["history"], 2 * 512 // 128
        route = LM_ROUTE if compute == "bfloat16" else LM_F32_ROUTE
        fit, evaluation = run["fit"], run["eval"]
        check(fit == {**none, "fused_dense": steps, **dict.fromkeys(route, VIT_DEPTH * steps)},
              f"vit {compute} training: launches {fit}")
        # evaluation runs the float32 masters, as the JAX Trainer's: the SIMT forward
        check(evaluation == {**none, "fused_dense": 1, "flash_fwd_simt": VIT_DEPTH},
              f"vit {compute} evaluation: launches {evaluation}")
        check(all(math.isfinite(h.mean_loss) for h in history), "non-finite ViT loss")
        print(f"[image] vit {compute}: epoch losses {[h.mean_loss for h in history]}, test "
              f"accuracy {run['accuracy']}; epoch 1 (warm) {history[1].samples_per_sec} "
              f"images/s, {history[1].seconds} s, on {card}; flash {VIT_DEPTH} x {steps} steps "
              f"of each of {list(route)} and none of the other route in training", flush=True)
        torch.cuda.empty_cache()
    print(f"[image] phase {time.perf_counter() - t0} s on {card}", flush=True)
    return {"resnet": resnet, "step": step, "vit": vit}


def image_launches(image: dict, name: str) -> dict:
    """A kernel's launches in each [image] run, training and evaluation
    apart."""
    runs = {"resnet18": image["resnet"], **{f"vit {c}": r for c, r in image["vit"].items()}}
    return {f"{label} {part}": run[part][name] for label, run in runs.items()
            for part in ("fit", "eval")}


def image_dp_path(checks, card: str) -> None:
    """`ops.checks.check_image_dp`: ResNet-18 at world 4, one card a rank."""
    t0 = time.perf_counter()
    res = checks.check_image_dp()
    print(f"[image-dp] ResNet-18 Trainer, world {res['world']}, {layout(res['world'])} "
          f"(comm.spmd, grad_reduce='psum', TPU_DIST_PALLAS_DENSE=1, synthetic CIFAR-10, global "
          f"batch {res['global_batch']}), {res['steps']} steps: {res['tensors_compared']} "
          f"tensors (losses, parameters, {res['batch_norm_buffers']} batch-norm buffers) the "
          f"same bits on every rank ({res['elements_differing']} elements differ); fused dense "
          f"per rank {res['dense_launches']}; losses {res['losses']}; per rank, the first "
          f"step (cuDNN's and NCCL's set-up) {res['first_step_seconds']} s, steps "
          f"2-{res['steps']} {res['later_seconds_per_step']} s a step, on {card}; phase "
          f"{time.perf_counter() - t0} s", flush=True)


SERVE_CONFIG = dict(max_batch=16, block_size=16, num_blocks=1024, max_seq=1024,
                    prefill_chunk=128, prefill_batch=4)
SERVE_REQUESTS = 48
SERVE_TRAIN = (150, 256, 128)  # steps, global batch, window: the Markov corpus, bfloat16
SERVE_CHAIN = 0  # seed of the one Markov chain: training windows, prompts and the check
SERVE_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)
# A greedy stream of the engine may leave dense `generate`'s only where
# dense's top-2 logit margin is under this share of its top logit's size (at
# least 1), about ten times the two paths' honest spread or more, which
# `serve_noise_floor` prints: float32 1e-3 against a spread of about 3e-6;
# bfloat16 2**-3 against about 1.3e-2 (logits out of 12 blocks that each
# round to 8 significant bits after matmuls whose shapes differ between the
# paths: 16 slots and 128-token chunks against one stream and one prefill).
# A wrong engine leaves dense where the margin is wide, or too often: ties
# must stay under 1 % of the compared positions.
SERVE_TIE = {torch.float32: 1e-3, torch.bfloat16: 2.0**-3}
SERVE_CARD_CPU_TOL = dict(rtol=1e-4, atol=1e-3)  # float32 logits, sums in another order


def serve_corpus(model: dict, n: int):
    """The Markov chain of seed `SERVE_CHAIN`: ``SERVE_TRAIN``'s training
    windows, 64 held-out windows, and ``n`` request rows of 512 tokens, all
    following ``markov_table(vocab, seed=SERVE_CHAIN)``."""
    from tpu_dist_torch import models

    steps, batch, seq = SERVE_TRAIN
    rows = steps * batch
    corpus = models.synthetic_tokens(rows + 64 + n, 512, model["vocab"], seed=SERVE_CHAIN)
    return corpus[:rows, :seq], corpus[rows : rows + 64, :seq], corpus[rows + 64 :].numpy()


def serve_load(model: dict, rows, seed: int = 0) -> list[dict]:
    """One request a corpus row (seeded): prompts of 32-512 tokens, 16-256
    new; every third sampled (`SERVE_SAMPLING`, seed = its index); request 0
    (greedy, 256 new) to be cancelled mid-stream, request 1 (greedy) with
    the chain's 8th token after its prompt as stop token."""
    import numpy as np

    from tpu_dist_torch import models

    rng = np.random.default_rng(seed)
    load = []
    for i, row in enumerate(rows):
        plen, new = int(rng.integers(32, 513)), int(rng.integers(16, 257))
        load.append({"prompt": row[:plen], "max_new": new, "sampled": i % 3 == 2,
                     "stop": None})
    load[0]["max_new"] = 256
    table, cur = models.markov_table(model["vocab"], seed=SERVE_CHAIN), load[1]["prompt"][-1]
    for _ in range(8):
        cur = table[cur]
    load[1].update(stop=int(cur), max_new=max(load[1]["max_new"], 32))
    return load


def serve_train(device, fa, ops, model: dict, windows, held_out):
    """The LM trained briefly on the Markov corpus with `LMTrainer` in
    bfloat16, so that greedy continuations are decisive; returns it and the
    launches its training made."""
    from tpu_dist_torch import models
    from tpu_dist_torch.train import LMTrainConfig, LMTrainer

    steps, batch, seq = SERVE_TRAIN
    lm = models.TransformerLM(**model, generator=torch.Generator().manual_seed(0))
    trainer = LMTrainer(lm, LMTrainConfig(global_batch=batch, compute_dtype="bfloat16",
                                          log=lambda line: None), device=device)
    zero_counts(fa, ops)
    t0 = time.perf_counter()
    history = trainer.fit(windows, epochs=1, val_windows=held_out)
    launches = counts(fa, ops)
    print(f"[serve] training: LMTrainer.fit, {steps} steps of {batch} x {seq} Markov tokens, "
          f"bfloat16 compute: mean loss {history[0].mean_loss}, final held-out loss "
          f"{history[0].val_loss} (float32, 64 windows), {time.perf_counter() - t0} s; "
          f"launches {json.dumps(launches)}", flush=True)
    check(math.isfinite(history[0].val_loss), "non-finite held-out loss")
    return trainer.lm, launches


def serve_percentiles(values: list) -> dict:
    import numpy as np

    values = [v for v in values if v is not None]
    return {"p50": float(np.percentile(values, 50)), "p99": float(np.percentile(values, 99))}


def serve_engine_run(lm, load, device) -> dict:
    """The load through a `ServeEngine` (after `warmup`), request 0 cancelled
    once it has 8 tokens; gate 1 on the results."""
    from tpu_dist_torch import serve

    eng = serve.ServeEngine(lm, serve.ServeConfig(**SERVE_CONFIG), device=device,
                            now=time.perf_counter)
    eng.warmup()
    torch.cuda.reset_peak_memory_stats(device)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    rids = [eng.submit(r["prompt"], r["max_new"], stop_token=r["stop"],
                       sampling=serve.SamplingParams(**SERVE_SAMPLING, seed=i)
                       if r["sampled"] else None)
            for i, r in enumerate(load)]
    victim = None
    while eng.pending:
        eng.step()
        if victim is None:
            victim = next((q for q in eng.slots if q is not None and q.request_id == rids[0]
                           and len(q.tokens) >= 8), None)
            if victim is not None:
                check(eng.cancel(rids[0]), "cancel of an in-flight request refused")
    wall = time.perf_counter() - t0
    res = [eng.results[r] for r in rids]
    # gate 1: every request finished with the right reason; the pool drained
    emitted = sum(r.emitted for r in res)
    check(res[0].finish_reason == "cancelled" and 0 < res[0].emitted < load[0]["max_new"],
          f"request 0: {res[0].finish_reason}, {res[0].emitted} tokens")
    stop = load[1]["stop"]
    stopped = stop in res[1].tokens.tolist()
    check(res[1].finish_reason == ("stop" if stopped else "length")
          and (res[1].tokens.tolist().index(stop) == res[1].emitted - 1 if stopped
               else res[1].emitted == load[1]["max_new"]),
          f"request 1 (stop token {stop}): {res[1].finish_reason}, {res[1].tokens.tolist()}")
    for r, q in zip(res[2:], load[2:]):
        check(r.finish_reason == "length" and r.emitted == q["max_new"],
              f"request {r.request_id}: {r.finish_reason}, {r.emitted} of {q['max_new']}")
    check(eng.allocator.used == 0, f"{eng.allocator.used} KV blocks still allocated")
    out = {"engine": eng, "context_len": eng.context_len, "results": res, "wall": wall, "emitted": emitted,
           "tokens_per_s": emitted / wall, "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9,
           "ttft": serve_percentiles([r.ttft for r in res]),
           "tpot": serve_percentiles([r.tpot_mean for r in res]),
           "high_water": eng.allocator.high_water, "steps": eng.step_count,
           "decode_steps": eng.steps_with_decode, "prefill_steps": eng.steps_with_prefill}
    return out


def serve_greedy_against_dense(lm, load, run, dtype) -> dict:
    """Gate 2: each greedy stream against dense `generate` of its prompt, up
    to the first position where they differ, which must be a tie (dense's
    top-2 margin under `SERVE_TIE`)."""
    import numpy as np

    from tpu_dist_torch import models

    ctx = run["context_len"]
    device = lm.embed.table.device
    table = models.markov_table(lm.vocab, seed=SERVE_CHAIN)
    compared, ties, chain, chain_total = 0, [], 0, 0
    for i, (q, r) in enumerate(zip(load, run["results"])):
        if q["sampled"]:
            continue
        got = r.tokens
        prompt = torch.from_numpy(q["prompt"]).to(device)
        dense = lm.generate(prompt[None], q["max_new"], cache_len=ctx,
                            stop_token=q["stop"])[0].cpu().numpy()[: got.size]
        prev = np.concatenate([q["prompt"][-1:], got[:-1]])
        chain += int((table[prev] == got).sum())
        chain_total += got.size
        differ = np.nonzero(got != dense)[0]
        if differ.size == 0:
            compared += got.size
            continue
        j = int(differ[0])
        compared += j + 1
        seq = torch.cat([prompt, torch.from_numpy(dense[:j]).to(device)])[None]
        with torch.no_grad():
            logits = lm.apply_cached(seq, lm.init_cache(1, ctx), 0)[0][0, -1].float()
        top2 = logits.topk(2).values.tolist()
        margin, tol = top2[0] - top2[1], SERVE_TIE[dtype] * max(1.0, abs(top2[0]))
        check(margin < tol, f"request {i}: the engine's greedy token {int(got[j])} at position "
              f"{j} differs from dense generate's {int(dense[j])} where dense's top-2 margin "
              f"{margin} is not under the tie tolerance {tol}")
        ties.append({"request": i, "position": j, "margin": margin, "tol": tol})
    share = len(ties) / compared
    check(share < 0.01, f"tie share {share} of {compared} compared positions not under 1 %")
    return {"compared": compared, "ties": ties, "tie_share": share,
            "chain_share": chain / chain_total}


def serve_noise_floor(lm, load, ctx: int) -> float:
    """The spread of dense logits between two honest orders of the same
    work: the last prompt position's logits after one prefill against after
    prefill chunks of ``SERVE_CONFIG["prefill_chunk"]``, for 8 greedy
    prompts longer than a chunk; the largest difference as a share of the
    top logit's size (at least 1).  Printed beside the ties of gate 2."""
    device = lm.embed.table.device
    chunk = SERVE_CONFIG["prefill_chunk"]
    prompts = [q["prompt"] for q in load if not q["sampled"] and q["prompt"].size > chunk][:8]
    worst = 0.0
    with torch.no_grad():
        for p in prompts:
            tok = torch.from_numpy(p).to(device)[None]
            whole = lm.apply_cached(tok, lm.init_cache(1, ctx), 0)[0][0, -1].float()
            cache = lm.init_cache(1, ctx)
            for start in range(0, p.size, chunk):
                part = lm.apply_cached(tok[:, start : start + chunk], cache, start)[0]
            parts = part[0, -1].float()
            scale = max(1.0, whole.abs().max().item())
            worst = max(worst, (whole - parts).abs().max().item() / scale)
    return worst


def serve_sampled_alone(lm, load, run, device) -> int:
    """Gate 3: each sampled request alone through a fresh engine gives the
    tokens it had beside the others."""
    from tpu_dist_torch import serve

    n = 0
    for i, (q, r) in enumerate(zip(load, run["results"])):
        if not q["sampled"]:
            continue
        eng = serve.ServeEngine(lm, serve.ServeConfig(**SERVE_CONFIG), device=device)
        rid = eng.submit(q["prompt"], q["max_new"],
                         sampling=serve.SamplingParams(**SERVE_SAMPLING, seed=i))
        alone = eng.run_until_drained()[rid].tokens
        check(alone.tolist() == r.tokens.tolist(),
              f"sampled request {i}: alone {alone.tolist()[:16]}... beside the others "
              f"{r.tokens.tolist()[:16]}...")
        n += 1
        del eng
    return n


def serve_card_against_cpu(lm, model: dict) -> float:
    """Gate 4: `apply_cached` logits of a 2 x 256 prefill then 8
    teacher-forced decode steps, float32, card against CPU."""
    from tpu_dist_torch import models

    with torch.device("meta"):
        cpu_lm = models.TransformerLM(**model)
    cpu_lm = cpu_lm.to_empty(device="cpu")
    cpu_lm.load_state_dict({k: v.cpu() for k, v in lm.state_dict().items()})
    tokens = models.synthetic_tokens(2, 264, model["vocab"], seed=5)
    outs = []
    for m in (lm, cpu_lm):
        tok = tokens.to(m.embed.table.device)
        with torch.no_grad():
            cache = m.init_cache(2, model["max_seq"])
            logits = [m.apply_cached(tok[:, :256], cache, 0)[0][:, -1]]
            for t in range(256, 264):
                logits.append(m.apply_cached(tok[:, t : t + 1], cache, t)[0][:, 0])
        outs.append(torch.stack(logits).cpu())
    diff = (outs[0] - outs[1]).abs().max().item()
    torch.testing.assert_close(outs[0], outs[1], **SERVE_CARD_CPU_TOL)
    return diff


def serve_beam(lm, load) -> None:
    """Gate 5: ``generate_beam(beams=1)`` is greedy `generate`; ``beams=4``
    returns its scores best first."""
    device = lm.embed.table.device
    prompt = torch.from_numpy(load[3]["prompt"][-64:]).to(device)[None].repeat(2, 1)
    greedy = lm.generate(prompt, 32)
    check(torch.equal(lm.generate_beam(prompt, 32, beams=1), greedy),
          "generate_beam(beams=1) differs from greedy generate")
    toks, scores = lm.generate_beam(prompt, 32, beams=4, return_all=True)
    check(toks.shape == (2, 4, 32) and bool((scores[:, :-1] >= scores[:, 1:]).all()),
          f"beam scores not sorted best first: {scores.tolist()}")


def serve_artifact(lm, weights_f32, model: dict, load, device, tmp: str, dtype) -> None:
    """Gate 6: `save_params` of the float32 weights, then
    `LMServer.from_artifact` into a structure of ``dtype`` built on the meta
    device, serves the same greedy tokens as a server around ``lm``."""
    from tpu_dist_torch import export, models, serve

    path = os.path.join(tmp, "weights.npz")
    if not os.path.exists(path):
        export.save_params(weights_f32, path)
    with torch.device("meta"):
        like = models.TransformerLM(**model).to(dtype)
    cfg = serve.ServeConfig(**SERVE_CONFIG)
    servers = [serve.LMServer(lm, cfg, device=device),
               serve.LMServer.from_artifact(like, path, cfg, device=device)]
    for (name, p), loaded in zip(lm.named_parameters(), servers[1].lm.parameters()):
        check(torch.equal(p, loaded), f"{name} differs after from_artifact")
    greedy = [q for q in load[2:] if not q["sampled"]][:4]
    toks = []
    for srv in servers:
        rids = [srv.submit(q["prompt"], 32) for q in greedy]
        res = srv.run_until_drained()
        toks.append([res[r].tokens.tolist() for r in rids])
    check(toks[0] == toks[1], "from_artifact serves other greedy tokens")


def serve_static(lm, load) -> dict:
    """Static batching for comparison: `generate` at batch 16, each batch's
    prompts left-padded to its longest and run to its longest output
    (greedy)."""
    device = lm.embed.table.device
    useful, padded, t0 = 0, 0, time.perf_counter()
    batch = SERVE_CONFIG["max_batch"]
    for b in range(0, len(load), batch):
        group = load[b : b + batch]
        width = max(q["prompt"].size for q in group)
        steps = max(q["max_new"] for q in group)
        prompt = torch.zeros((len(group), width), dtype=torch.int64)
        for row, q in enumerate(group):
            prompt[row, width - q["prompt"].size :] = torch.from_numpy(q["prompt"])
        lm.generate(prompt.to(device), steps, cache_len=SERVE_CONFIG["max_seq"]).cpu()
        useful += sum(q["max_new"] for q in group)
        padded += len(group) * steps
    wall = time.perf_counter() - t0
    return {"wall": wall, "tokens_per_s": useful / wall, "padded_tokens_per_s": padded / wall}


def serve_profile(lm, load, device, card: str, compute: str) -> dict:
    """Launches and busy share of 5 decode steps with every slot active."""
    from tpu_dist_torch import serve

    eng = serve.ServeEngine(lm, serve.ServeConfig(**SERVE_CONFIG), device=device)
    for i in range(SERVE_CONFIG["max_batch"]):
        eng.submit(load[i % len(load)]["prompt"][:32], 64)
    while eng._prefillq or eng.queue:
        eng.step()
    out = profile_steps(eng.step, 5, card, compute, phase=f"[serve] {compute} decode step")
    check(eng.occupancy() == SERVE_CONFIG["max_batch"], "profiled decode steps not full")
    return out


def serve_path(device, fa, ops, card: str, model: dict = GPT2_SMALL,
               n_requests: int = SERVE_REQUESTS) -> dict:
    """[serve]: the LM trained briefly, then served in float32 and bfloat16
    under gates 1-8; no hand-written kernel launches once training is done."""
    import copy
    import tempfile

    from tpu_dist_torch.observe import events as ev_mod

    t0 = time.perf_counter()
    os.environ["TPU_DIST_FLASH"] = "1"
    os.environ["TPU_DIST_PALLAS_DENSE"] = "1"
    windows, held_out, rows = serve_corpus(model, n_requests)
    trained, train_launches = serve_train(device, fa, ops, model, windows, held_out)
    load = serve_load(model, rows)
    zero_counts(fa, ops)  # from here on, serving only
    ops.ring_all_reduce_pallas.launches = 0
    out = {"train_launches": train_launches}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in (torch.float32, torch.bfloat16):
            t1 = time.perf_counter()
            compute = str(dtype)[6:]
            lm = trained if dtype == torch.float32 else copy.deepcopy(trained).to(dtype)
            # every engine of this dtype logs to one directory (gate 7)
            events_dir = os.path.join(tmp, f"events_{compute}")
            os.environ["TPU_DIST_TELEMETRY"] = events_dir
            run = serve_engine_run(lm, load, device)
            eng = run.pop("engine")
            print(f"[serve] {compute}: ServeEngine {json.dumps(SERVE_CONFIG)}, "
                  f"{len(load)} requests ({sum(not q['sampled'] for q in load)} greedy, "
                  f"{sum(q['sampled'] for q in load)} sampled at {json.dumps(SERVE_SAMPLING)}): "
                  f"{run['emitted']} tokens in {run['wall']} s, {run['tokens_per_s']} tokens/s; "
                  f"TTFT {json.dumps(run['ttft'])} s, TPOT {json.dumps(run['tpot'])} s; "
                  f"{run['steps']} steps ({run['decode_steps']} with a decode step, "
                  f"{run['prefill_steps']} with a prefill round); pool high water "
                  f"{run['high_water']} of {SERVE_CONFIG['num_blocks']} blocks, drained; "
                  f"weights {eng.weights_bytes} bytes, KV pool {eng.kv_pool_bytes} bytes "
                  f"({eng.kv_block_bytes} a block); peak memory {run['peak_gb']} GB; "
                  f"request 0 cancelled after {run['results'][0].emitted} tokens, request 1 "
                  f"{run['results'][1].finish_reason} after {run['results'][1].emitted}; on "
                  f"{card}", flush=True)
            del eng
            secs = {"engine": time.perf_counter() - t1}

            def timed(name, fn, *args):
                t = time.perf_counter()
                value = fn(*args)
                secs[name] = time.perf_counter() - t
                return value

            floor = timed("noise floor", serve_noise_floor, lm, load, run["context_len"])
            print(f"[serve] {compute}: dense logits, one prefill against chunks of "
                  f"{SERVE_CONFIG['prefill_chunk']}, differ by up to {floor} of the top logit",
                  flush=True)
            greedy = timed("gate 2", serve_greedy_against_dense, lm, load, run, dtype)
            print(f"[serve] {compute} gate 2: greedy streams against dense generate over "
                  f"{greedy['compared']} positions: {len(greedy['ties'])} ties "
                  f"{json.dumps(greedy['ties'])}, share {greedy['tie_share']} (tie: a top-2 "
                  f"margin under {SERVE_TIE[dtype]} of the top logit); greedy tokens following "
                  f"markov_table({model['vocab']}): {greedy['chain_share']}", flush=True)
            alone = timed("gate 3", serve_sampled_alone, lm, load, run, device)
            print(f"[serve] {compute} gate 3: {alone} sampled streams equal to the same "
                  "request alone through a fresh engine", flush=True)
            if dtype == torch.float32:
                diff = timed("gate 4", serve_card_against_cpu, lm, model)
                print(f"[serve] float32 gate 4: apply_cached logits, 2 x 256 prefill then 8 "
                      f"decode steps, card against CPU: max |diff| {diff} "
                      f"(tolerance {json.dumps(SERVE_CARD_CPU_TOL)})", flush=True)
            timed("gate 5", serve_beam, lm, load)
            timed("gate 6", serve_artifact, lm, trained, model, load, device, tmp, dtype)
            ev_mod.from_env().close()
            del os.environ["TPU_DIST_TELEMETRY"]
            n, errors = ev_mod.validate_dir(events_dir)
            kinds = {rec["event"] for rec in ev_mod.read_events(events_dir)}
            check(not errors, f"{len(errors)} event schema errors: {errors[:5]}")
            check({"request_admit", "prefill", "decode_step", "request_finish"} <= kinds,
                  f"event kinds {sorted(kinds)}")
            print(f"[serve] {compute} gates 5-7: generate_beam(beams=1) is greedy generate, "
                  f"beams=4 scores best first; save_params then LMServer.from_artifact serves "
                  f"the same greedy tokens; {n} events validate ({sorted(kinds)})", flush=True)
            static = timed("static", serve_static, lm, load)
            profile = timed("profile", serve_profile, lm, load, device, card, compute)
            print(f"[serve] {compute}: static generate at batch {SERVE_CONFIG['max_batch']}, "
                  f"padded to each batch's longest: {static['tokens_per_s']} requested tokens/s "
                  f"({static['padded_tokens_per_s']} with the padding), {static['wall']} s, "
                  f"against the engine's {run['tokens_per_s']}; decode step (one CUDA graph "
                  f"launch from the host): {profile.get('kernel_launches_per_step')} kernels, "
                  f"device busy share "
                  f"{profile.get('device_busy_share_of_wall')}, "
                  f"{profile.get('device_ms_per_step')} device ms of "
                  f"{profile.get('wall_ms_per_step')} ms; {time.perf_counter() - t1} s "
                  f"({json.dumps(secs)}), on {card}", flush=True)
            out[compute] = {**run, "greedy": greedy, "static": static, "profile": profile}
            out[compute].pop("results")
            del lm
            torch.cuda.empty_cache()
    serving = {**counts(fa, ops), "ring_all_reduce": ops.ring_all_reduce_pallas.launches}
    check(not any(serving.values()), f"hand-written kernels launched while serving: {serving}")
    out["launches"] = serving
    print(f"[serve] gate 8: launches while serving {json.dumps(serving)} (TPU_DIST_FLASH=1, "
          f"TPU_DIST_PALLAS_DENSE=1); phase {time.perf_counter() - t0} s on {card}", flush=True)
    return out


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

    if sys.argv[1:] not in ([], ["--lm-f32"], ["--nccl"], ["--resume"], ["--main"], ["--image"],
                            ["--serve"]):
        sys.exit("usage: python3 chip_smoke.py [--lm-f32 | --nccl | --resume | --main | --image "
                 "| --serve]")
    if sys.argv[1:] == ["--serve"]:
        build_all(_build)
        serve_path(device, fa, ops, card_and_power_limit())
        return
    if sys.argv[1:] == ["--image"]:
        build_all(_build)
        image_head_rows(device, ops, F)
        image_path(device, fa, ops, checks, card_and_power_limit())
        return
    if sys.argv[1:] == ["--main"]:
        build_all(_build)
        matmul_cases(device, ops, F)
        main_path(device, ops, card_name)
        return
    if sys.argv[1:] == ["--resume"]:
        build_all(_build)
        resume_path(device, fa, ops, card_and_power_limit())
        return
    if sys.argv[1:] == ["--lm-f32"]:
        os.environ["TPU_DIST_FLASH"] = "1"
        lm_fit(device, fa, flops, card_and_power_limit(), compute_dtype=None,
               steps_per_epoch=4, route=LM_F32_ROUTE)
        return
    if sys.argv[1:] == ["--nccl"]:
        cards = torch.cuda.device_count()
        check(cards >= max(COLLECTIVE_WORLDS), f"--nccl needs {max(COLLECTIVE_WORLDS)} cards, "
              f"this host has {cards}")
        build_all(_build)
        collectives_path(checks, card_and_power_limit())
        dp_path(checks, card_and_power_limit())
        image_dp_path(checks, card_and_power_limit())
        return

    build_all(_build)

    rows = matmul_cases(device, ops, F)
    launches = main_path(device, ops, card_name)["launches"]
    flash_rows = flash_cases(device, fa, F, flops, checks)
    lm = lm_path(device, fa, card_and_power_limit())  # tokens/s beside the card's power limit
    ring = ring_path(checks, flops, metrics, card_name)
    collectives_path(checks, card_and_power_limit())
    dp = dp_path(checks, card_and_power_limit())
    resume = resume_path(device, fa, ops, card_and_power_limit())
    image = image_path(device, fa, ops, checks, card_and_power_limit())
    served = serve_path(device, fa, ops, card_and_power_limit())

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
        "launches_resume": {"train_dist, three runs": resume["mnist"]["runs_launches"],
                            "one step at accum_steps 2": resume["mnist"]["accum_launches"][2]},
        "launches_image": image_launches(image, "fused_dense"),
        "launches_serve": served["launches"]["fused_dense"],
        "image_heads": [{key: r[key] for key in ("m", "k", "n", "dtype", "max_abs_err", "ms",
                                                 "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")}
                        for r in rows if "gradient" not in r
                        and (r["m"], r["k"], r["n"]) in {c[:3] for c in IMAGE_HEAD_CASES}],
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
        if on_lm:
            entry["launches_resume"] = {
                "bf16 step, accum_steps 4": resume["lm"]["accum"][4]["launches"][name],
                "bf16 fit, one epoch": resume["lm"]["fit_launches"][name],
                "float16 guarded fit": resume["f16"]["launches"][name]}
        else:
            entry["launches_resume"] = {"train_lm": resume["demo"]["launches"][name]}
        entry["launches_image"] = image_launches(image, name)
        entry["launches_serve"] = served["launches"][name]
        vit_row = next(r for r in flash_rows
                       if r["kernel"] == name and r["case"] == ("vit" if on_lm else "vit_f32"))
        entry["vit"] = {key: vit_row[key] for key in ("q", "dtype", "causal", "max_abs_err", "ms",
                                                      "plain_ms", "bound_ms", "bound_by",
                                                      "library_ms", "tflops")}
        if on_lm:  # the same [lm] inputs, SIMT
            simt = next(r for r in flash_rows
                        if r["case"] == "lm" and r["kernel"] == name.replace("sm90", "simt"))
            entry["simt_ms_same_inputs"] = simt["ms"]
        kernels.append(entry)
    timing = ring["timing"]
    kernels.append({
        "name": "ring_all_reduce", "route": "cuda",
        "source": "tpu_dist_torch/ops/csrc/ring.cu",
        "replaces": "tpu_dist/ops/pallas_ring.py:36", "launches": dp["ring_launches"][0],
        "launches_ring_phase": ring["launches"],
        **{key: timing[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
        "launches_serve": served["launches"]["ring_all_reduce"],
        "schedule": RING_SCHEDULE,
        "work": f"one call of {timing['bytes_per_rank']} bytes of float32 per rank at world "
                f"{timing['world']}, every rank a process on this one card; max_abs_err: that "
                "call's output against the plain version, the worst rank; ms: the kernel's "
                "own time per launch from torch.profiler, the slowest rank; launches: rank 0 "
                "of the ring run of [dp], the MNIST Trainer's 20 steps (9 a step); "
                "launches_ring_phase: rank 0 of the world-4 run of [ring]; library_ms null: "
                "NCCL refuses two ranks on one device",
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_and_power_limit(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": 1}}), flush=True)


if __name__ == "__main__":
    main()
