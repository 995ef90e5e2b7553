"""The port's side of the MoE parity tests: the cases, their inputs from a
seed, and the function every spawned rank runs.

Imported by the parent test process and by every rank `comm.spmd` spawns,
so it imports neither jax nor the JAX package.  The JAX side of the same
cases is in test_torch_moe.py.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_dist_torch import comm, models, parallel
from tpu_dist_torch.train import LMTrainConfig, LMTrainer, sgd, sgd_rule

SEED = 20
D, H, T = 8, 16, 12  # model width, expert hidden width, tokens per rank
# the MoE LM of the expert-parallel cases: one expert per rank of world 2
LM = dict(vocab=32, dim=16, depth=2, heads=2, max_seq=16, moe_experts=2,
          moe_balance_weight=0.01)
LM_TOKENS = (4, 8)  # the global batch of apply_moe_ep: 2 windows a rank
FIT = dict(epochs=3, global_batch=8)  # one step an epoch on 8 windows
# what the JAX step composes with moe: accumulation, the guard, clipping
FIT_COMPOSED = dict(FIT, accum_steps=2, nan_guard=True, grad_clip=0.5)
FIT_WINDOWS = (8, 8)
FIT_LR = 0.1


def collective_cases(n: int) -> dict[str, tuple[str, dict, tuple, tuple]]:
    """name -> (collective, keyword arguments, input shape, output shape);
    ``group`` names the members (0, n - 1)."""
    return {
        "all_to_all_split0_concat0": ("all_to_all", {"split_axis": 0, "concat_axis": 0},
                                      (2 * n, 3), (2 * n, 3)),
        "all_to_all_split0_concat1": ("all_to_all", {"split_axis": 0, "concat_axis": 1},
                                      (2 * n, 3), (2, 3 * n)),
        "all_to_all_split1_concat0": ("all_to_all", {"split_axis": 1, "concat_axis": 0},
                                      (3, 2 * n), (3 * n, 2)),
        "all_gather": ("all_gather", {}, (2, 3), (n, 2, 3)),
        "all_gather_axis1": ("all_gather", {"axis": 1}, (2, 3), (2, n, 3)),
        "all_gather_tiled": ("all_gather", {"tiled": True}, (2, 3), (2 * n, 3)),
        "all_gather_group": ("all_gather", {"group": (0, n - 1)}, (2, 3), (2, 2, 3)),
    }


def collective_inputs(n: int) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """name -> (every rank's input ``(n, *in)``, every rank's weights
    ``(n, *out)``): rank r's loss is ``sum(weights[r] * collective(x[r]))``."""
    rng = np.random.default_rng(SEED + n)
    return {name: (rng.standard_normal((n, *shape_in)).astype(np.float32),
                   rng.standard_normal((n, *shape_out)).astype(np.float32))
            for name, (_, _, shape_in, shape_out) in collective_cases(n).items()}


# name -> (function, capacity_factor): outputs, stats and gradients
MOE_CASES = {
    "top1": ("moe_mlp", 1.25),
    "top1_drops": ("moe_mlp", 0.34),
    "top2": ("moe_mlp_top2", 2.0),
    "top2_drops": ("moe_mlp_top2", 0.5),
    "expert_choice": ("moe_mlp_expert_choice", 2.0),
    "expert_choice_clamped": ("moe_mlp_expert_choice", 100.0),  # past the n * T pool
}
BALANCE_WEIGHT = 0.5  # top-2 cases: the loss carries the balance term too


def moe_inputs(n: int) -> dict[str, np.ndarray]:
    """Every rank's tokens ``x (n, T, D)`` and loss weights ``w (n, T,
    D)``, the router ``gate (D, n)`` and the stacked experts ``up (n, D,
    H)``, ``down (n, H, D)``."""
    rng = np.random.default_rng(SEED + 10 * n)
    f32 = np.float32
    return {"x": rng.standard_normal((n, T, D)).astype(f32),
            "w": rng.standard_normal((n, T, D)).astype(f32),
            "gate": rng.standard_normal((D, n)).astype(f32),
            "up": (rng.standard_normal((n, D, H)) / np.sqrt(D)).astype(f32),
            "down": (rng.standard_normal((n, H, D)) / np.sqrt(H)).astype(f32)}


def lm_tokens() -> np.ndarray:
    return models.synthetic_tokens(*LM_TOKENS, LM["vocab"], seed=4).numpy()


def fit_windows() -> np.ndarray:
    return models.synthetic_tokens(*FIT_WINDOWS, LM["vocab"], seed=6).numpy()


def _collectives(n: int, r: int) -> dict:
    out = {}
    for name, (fn, kw, _, _) in collective_cases(n).items():
        xs, ws = collective_inputs(n)[name]
        kw = dict(kw)
        if "group" in kw:
            kw["group"] = comm.new_group(kw["group"])  # every rank, in the same order
        x = torch.tensor(xs[r], requires_grad=True)
        y = getattr(comm, fn)(x, **kw)
        if y.requires_grad:  # a rank outside the group gets zeros, not a function of x
            (torch.from_numpy(ws[r]) * y).sum().backward()
        out[name] = {"y": y.detach(),
                     "grad": torch.zeros_like(x) if x.grad is None else x.grad}
    return out


def _moe(n: int, r: int) -> dict:
    inputs = {k: torch.from_numpy(v) for k, v in moe_inputs(n).items()}
    out = {}
    for name, (fn, factor) in MOE_CASES.items():
        x = inputs["x"][r].clone().requires_grad_()
        leaves = {k: inputs[k].clone().requires_grad_() for k in ("gate", "up", "down")}
        y, stats = getattr(parallel, fn)(x, leaves["gate"], leaves["up"][r],
                                         leaves["down"][r], capacity_factor=factor)
        loss = (inputs["w"][r] * y).sum()
        if "balance_loss" in stats:
            loss = loss + BALANCE_WEIGHT * stats["balance_loss"]
        loss.backward()
        out[name] = {"y": y.detach(), "stats": {k: v.detach() for k, v in stats.items()},
                     "grads": {"x": x.grad, **{k: t.grad for k, t in leaves.items()}}}
    return out


def _lm_ep(state: dict) -> dict:
    """`apply_moe_ep` and `loss_moe_ep` on this rank's 2 windows, and the
    loss's gradients."""
    r = comm.rank()
    lm = models.TransformerLM(**LM)
    lm.load_state_dict(state)
    local = torch.from_numpy(lm_tokens()[2 * r : 2 * r + 2])
    with torch.no_grad():
        logits, balance = lm.apply_moe_ep(local)
    loss = lm.loss_moe_ep(local)
    loss.backward()
    return {"logits": logits, "balance": balance, "loss": loss.detach(),
            "grads": {k: p.grad for k, p in lm.named_parameters()}}


def _fit(state: dict, cfg: dict) -> dict:
    """``LMTrainer(moe=True)`` under ``cfg``, sgd(0.1), three steps from
    ``state``."""
    lm = models.TransformerLM(**LM)
    lm.load_state_dict(state)
    trainer = LMTrainer(lm, LMTrainConfig(**cfg, moe=True, log=lambda line: None),
                        optimizer=sgd_rule(sgd(lm.parameters(), FIT_LR)), device="cpu")
    history = trainer.fit(fit_windows())
    return {"losses": torch.tensor([s.mean_loss for s in history]),
            "params": {k: p.detach().clone() for k, p in lm.named_parameters()}}


def run_all(lm_state: dict | None = None, fit_state: dict | None = None) -> dict:
    """Every case at this world; with the LM states (world 2), the
    expert-parallel LM cases too."""
    torch.set_num_threads(1)
    n, r = comm.world_size(), comm.rank()
    out = {"collectives": _collectives(n, r), "moe": _moe(n, r)}
    if lm_state is not None:
        out["lm_ep"] = _lm_ep(lm_state)
        out["fit"] = _fit(fit_state, FIT)
        out["fit_composed"] = _fit(fit_state, FIT_COMPOSED)
    return out
