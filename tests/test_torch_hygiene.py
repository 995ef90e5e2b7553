"""The port stands alone: no jax, no JAX package, no silent CPU fallback."""

import importlib
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_dist_torch import models, serve
from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.ops import _build, fused_dense, matmul, pallas_ring
from tpu_dist_torch.train import LMTrainer, Trainer

fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "tpu_dist_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|tpu_dist)(\.|\s|$)", re.MULTILINE)


def test_importing_the_port_loads_neither_jax_nor_tpu_dist():
    code = (
        "import sys, tpu_dist_torch, tpu_dist_torch.demos.train_dist\n"
        "import tpu_dist_torch.ops.flash_attention, tpu_dist_torch.models.transformer_lm\n"
        "import tpu_dist_torch.train.lm_trainer\n"
        "import tpu_dist_torch.comm.runner, tpu_dist_torch.parallel.ring\n"
        "import tpu_dist_torch.ops.pallas_ring, tpu_dist_torch.ops.checks\n"
        "import tpu_dist_torch.train.metrics\n"
        "import tpu_dist_torch.demos.ptp, tpu_dist_torch.demos.allreduce\n"
        "import tpu_dist_torch.demos.gather, tpu_dist_torch.comm.launch, tpu_dist_torch.run\n"
        "import tpu_dist_torch.resilience.retry\n"
        "import tpu_dist_torch.demos.train_lm, tpu_dist_torch.train.checkpoint\n"
        "import tpu_dist_torch.resilience.guards, tpu_dist_torch.resilience.preempt\n"
        "import tpu_dist_torch.data.text, tpu_dist_torch.data.digits\n"
        "import tpu_dist_torch.demos.train_image, tpu_dist_torch.data.cifar\n"
        "import tpu_dist_torch.models.resnet, tpu_dist_torch.models.vit\n"
        "import tpu_dist_torch.serve, tpu_dist_torch.observe, tpu_dist_torch.export\n"
        "import tpu_dist_torch.demos.generate, tpu_dist_torch.demos.serve_demo\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpu_dist'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_neither_jax_nor_tpu_dist(path):
    assert not FORBIDDEN.search(path.read_text()), path


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(models.mnist_net(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMTrainer(models.TransformerLM(vocab=8, dim=8, depth=1, heads=2), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.ServeEngine(models.TransformerLM(vocab=8, dim=8, depth=1, heads=2, max_seq=256))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.LMServer(models.TransformerLM(vocab=8, dim=8, depth=1, heads=2, max_seq=256))


def test_cpu_matmul_never_touches_the_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU matmul tried to build {name}")

    monkeypatch.setattr(_build, "build", refuse)
    before = fused_dense.launches
    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 4, requires_grad=True)
    matmul(x, w, torch.randn(4), epilogue="gelu").sum().backward()
    assert fused_dense.launches == before
    assert x.grad is not None and w.grad is not None


def test_cpu_flash_never_touches_the_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU flash attention tried to build {name}")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setenv("TPU_DIST_FLASH", "1")
    counters = fa.KERNELS
    assert len(counters) == 6  # the forward, dK/dV and dQ of both routes
    before = [k.launches for k in counters]
    lm = models.TransformerLM(vocab=16, dim=16, depth=1, heads=2, max_seq=128)
    tokens = models.synthetic_tokens(2, 128, 16)
    models.lm_loss(lm(tokens), tokens).backward()
    q = torch.randn(1, 2, 64, 8, requires_grad=True)
    fa.flash_attention(q, q, q, causal=True, window=8).sum().backward()
    fa.flash_attention_lse(q, q, q)
    assert [k.launches for k in counters] == before
    assert q.grad is not None and lm.embed.table.grad is not None


def test_cpu_ring_never_touches_the_build(monkeypatch):
    """A CPU tensor takes the plain ring (a world of one here): no build,
    no launch counted."""

    def refuse(name):
        raise AssertionError(f"CPU ring tried to build {name}")

    monkeypatch.setattr(_build, "build", refuse)
    before = pallas_ring.ring_all_reduce_pallas.launches
    x = torch.arange(6.0).reshape(2, 3)
    torch.testing.assert_close(pallas_ring.ring_all_reduce_pallas(x), x)
    assert pallas_ring.ring_all_reduce_pallas.launches == before


def test_cpu_ring_gradient_reduction_never_touches_the_build(monkeypatch):
    """``average_gradients(backend="ring")`` on CPU tensors takes the plain
    ring (a world of one here): no build, no launch counted, each tensor
    its own mean."""
    from tpu_dist_torch.parallel import average_gradients

    def refuse(name):
        raise AssertionError(f"CPU ring tried to build {name}")

    monkeypatch.setattr(_build, "build", refuse)
    before = pallas_ring.ring_all_reduce_pallas.launches
    grads = [torch.arange(6.0).reshape(2, 3), torch.tensor([0.5])]
    want = [g.clone() for g in grads]
    average_gradients(grads, backend="ring")
    assert all(torch.equal(g, w) for g, w in zip(grads, want))
    assert pallas_ring.ring_all_reduce_pallas.launches == before
