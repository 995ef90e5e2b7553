"""The port's side of the ring-attention parity tests: the cases, their
inputs from a seed, and the function every spawned rank runs.

Imported by the parent test process and by every rank `comm.spmd` spawns,
so it imports neither jax nor the JAX package.  The JAX side of the same
cases is in test_torch_ring_attention.py.
"""

from __future__ import annotations

import numpy as np
import torch

from tests import torch_seq_workers as seq
from tpu_dist_torch import comm, models
from tpu_dist_torch.parallel import ring_attention, ring_attention_flash
from tpu_dist_torch.parallel.ring_attention import RingMultiHeadAttention
from tpu_dist_torch.train import LMTrainConfig, LMTrainer, sgd, sgd_rule

SEED = 23
# ring_attention: q, k, v (B, H, n * S_LOCAL, D), the sequence split over the
# world; name -> (keyword arguments, dtype)
B, H, S_LOCAL, D = 2, 2, 4, 8
RING = {"causal": (dict(causal=True), "float32"),
        "full": (dict(causal=False), "float32"),
        "window": (dict(causal=False, window=5), "float32"),
        "bf16": (dict(causal=False), "bfloat16")}
# ring_attention_flash on the plain blocks: q, k, v (B, H, n * FLASH_S_LOCAL,
# FLASH_D) float32
FLASH_S_LOCAL, FLASH_D = 8, 16
FLASH = {"causal": dict(causal=True), "full": dict(causal=False)}
# RingMultiHeadAttention(core="ring"): x (B, n * S_LOCAL, MHA_DIM)
MHA_DIM, MHA_HEADS = 16, 4
MHA = {"ring": dict(causal=True, use_rope=True),
       "ring_flash": dict(causal=True, use_rope=True, use_flash=True),
       "ring_window": dict(causal=True, sliding_window=3)}
# apply_seq_parallel(attention="ring", flash=) at world 2: test_torch_seq_parallel's
# models and tokens; the window model without flash, which refuses it
LM_CASES = [("learned", False), ("learned", True), ("rope_window", False)]
# generate_seq_parallel: greedy at world 4 (the JAX test's models: 2 x 24
# prompt tokens, 8 steps), sampled at world 2 (1 x 16, 6 steps)
GEN_LMS = {"learned": dict(vocab=32, dim=16, depth=2, heads=4, max_seq=64),
           "rope": dict(vocab=32, dim=16, depth=2, heads=4, max_seq=64, pos_embedding="rope")}
GEN_GREEDY = (2, 24, 8)  # batch, global prompt, steps
GEN_SAMPLED_LM = dict(vocab=32, dim=16, depth=1, heads=2, max_seq=48)
GEN_SAMPLED = (1, 16, 6)
SAMPLING = dict(temperature=0.8, top_k=8)
SAMPLING_SEED = 7


def ring_inputs(n: int) -> dict[str, dict[str, np.ndarray]]:
    """case -> q, k, v and the loss weights w, each ``(B, H, n * S_LOCAL, D)``
    float32 (the bf16 case's are rounded to bf16 on both sides)."""
    rng = np.random.default_rng(SEED + n)
    return {case: {t: rng.standard_normal((B, H, n * S_LOCAL, D)).astype(np.float32)
                   for t in ("q", "k", "v", "w")} for case in RING}


def flash_inputs(n: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(SEED + 10 * n)
    return {t: rng.standard_normal((B, H, n * FLASH_S_LOCAL, FLASH_D)).astype(np.float32)
            for t in ("q", "k", "v", "w")}


def mha_input(n: int) -> np.ndarray:
    return np.random.default_rng(SEED + 20 * n).standard_normal(
        (B, n * S_LOCAL, MHA_DIM)).astype(np.float32)


def gen_prompt(kind: str) -> np.ndarray:
    b, s, _ = GEN_GREEDY if kind == "greedy" else GEN_SAMPLED
    return models.synthetic_tokens(b, s, 32, seed=8 if kind == "greedy" else 9).numpy()


def shard(t: np.ndarray, axis: int) -> torch.Tensor:
    """This rank's contiguous piece of ``t`` along ``axis``."""
    n, r = comm.world_size(), comm.rank()
    return torch.from_numpy(np.split(t, n, axis=axis)[r].copy())


def _grads(core, q, k, v, w, **kw) -> dict:
    """``core``'s output and the gradients of ``sum(w * out)``."""
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = core(q, k, v, **kw)
    (w * o.float()).sum().backward()
    return {"out": o.detach(), "dtype": str(o.dtype),
            "grads": {"q": q.grad, "k": k.grad, "v": v.grad}}


def ring_cases(n: int) -> dict:
    out = {}
    for case, (kw, dtype) in RING.items():
        x = {t: shard(a, 2) for t, a in ring_inputs(n)[case].items()}
        q, k, v = (x[t].to(getattr(torch, dtype)) for t in ("q", "k", "v"))
        out[case] = _grads(ring_attention, q, k, v, x["w"], **kw)
    return out


def flash_cases(n: int) -> dict:
    """`ring_attention_flash` and `ring_attention` on the same shards."""
    x = {t: shard(a, 2) for t, a in flash_inputs(n).items()}
    out = {}
    for case, kw in FLASH.items():
        args = (x["q"], x["k"], x["v"], x["w"])
        out[case] = {"flash": _grads(ring_attention_flash, *args, **kw),
                     "ring": _grads(ring_attention, *args, **kw)}
    return out


def mha_cases(n: int, state: dict) -> dict:
    x = shard(mha_input(n), 1)
    out = {}
    for case, kw in MHA.items():
        attn = RingMultiHeadAttention(MHA_DIM, MHA_HEADS, **kw)
        attn.load_state_dict(state)
        with torch.no_grad():
            out[case] = attn(x)
    return out


def lm_cases(states: dict) -> dict:
    """`apply_seq_parallel(attention="ring", flash=)` and
    `lm_loss_seq_parallel` on this rank's half of the tokens, and the
    loss's gradients."""
    local = shard(seq.lm_tokens(), 1)
    out = {}
    for name, flash in LM_CASES:
        lm = models.TransformerLM(**seq.LMS[name])
        lm.load_state_dict(states[name])
        logits = lm.apply_seq_parallel(local, flash=flash)
        loss = models.lm_loss_seq_parallel(logits, local)
        loss.backward()
        out[(name, flash)] = {"logits": logits.detach(), "loss": loss.detach(),
                              "grads": {k: p.grad for k, p in lm.named_parameters()}}
    return out


def fit(state: dict, cfg: dict, mesh) -> dict:
    """Three ``LMTrainer(sequence_parallel="ring")`` steps under ``cfg``,
    sgd(0.1), from ``state`` on test_torch_seq_parallel's windows."""
    lm = models.TransformerLM(**seq.FIT_LM)
    lm.load_state_dict(state)
    config = LMTrainConfig(**cfg, sequence_parallel="ring", log=lambda line: None)
    trainer = LMTrainer(lm, config, optimizer=sgd_rule(sgd(lm.parameters(), seq.FIT_LR)),
                        device="cpu", mesh=mesh)
    history = trainer.fit(seq.fit_windows())
    return {"losses": torch.tensor([s.mean_loss for s in history]),
            "params": {k: p.detach().clone() for k, p in lm.named_parameters()}}


def generate_greedy(states: dict) -> dict:
    _, _, steps = GEN_GREEDY
    prompt = shard(gen_prompt("greedy"), 1)
    out = {}
    for name, kw in GEN_LMS.items():
        lm = models.TransformerLM(**kw)
        lm.load_state_dict(states[name])
        out[name] = lm.generate_seq_parallel(prompt, steps)
    return out


def generate_sampled(state: dict) -> torch.Tensor:
    lm = models.TransformerLM(**GEN_SAMPLED_LM)
    lm.load_state_dict(state)
    return lm.generate_seq_parallel(
        shard(gen_prompt("sampled"), 1), GEN_SAMPLED[2],
        generator=torch.Generator().manual_seed(SAMPLING_SEED), **SAMPLING)


def run_all(states: dict) -> dict:
    """Every case of this world (2 or 4, on its (1, n) or (2, 2) mesh for
    the trainer); ``states`` holds the parameters the parent made."""
    torch.set_num_threads(1)
    n = comm.world_size()
    mesh = comm.make_mesh(seq.mesh_shape(n), seq.MESH[1])
    out = {"ring": ring_cases(n), "flash": flash_cases(n), "mha": mha_cases(n, states["mha"]),
           "fit": fit(states["fit"], seq.FIT, mesh)}
    if n == 2:
        out["fit_composed"] = fit(states["fit"], seq.FIT_COMPOSED, mesh)
        out["lm"] = lm_cases(states["lm"])
        out["sampled"] = generate_sampled(states["sampled"])
    else:
        out["greedy"] = generate_greedy(states["greedy"])
    return out
