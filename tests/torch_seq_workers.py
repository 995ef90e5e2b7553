"""The port's side of the sequence-parallel parity tests: the cases, their
inputs from a seed, and the function every spawned rank runs.

Imported by the parent test process and by every rank `comm.spmd` spawns,
so it imports neither jax nor the JAX package.  The JAX side of the same
cases is in test_torch_seq_parallel.py.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from tpu_dist_torch import comm, models
from tpu_dist_torch.parallel.ulysses import ulysses_attention
from tpu_dist_torch.train import LMTrainConfig, LMTrainer, sgd, sgd_rule

SEED = 22
MESH = ((2, 2), ("data", "seq"))  # the world-4 mesh; at world 2 the mesh is (1, 2)
# ulysses_attention: q, k, v (B, H, n * S_LOCAL, D), the sequence split over
# the world; H divides by 2 and 4
B, H, S_LOCAL, D = 2, 4, 4, 8
ULYSSES = {"causal": dict(causal=True), "full": dict(causal=False),
           "window": dict(causal=True, window=3)}
# apply_seq_parallel and lm_loss_seq_parallel at world 2: 2 x 16 tokens
LMS = {"learned": dict(vocab=32, dim=16, depth=2, heads=4, max_seq=16),
       "rope_window": dict(vocab=32, dim=16, depth=2, heads=4, max_seq=16,
                           pos_embedding="rope", sliding_window=5)}
LM_TOKENS = (2, 16)
# three LMTrainer(sequence_parallel="ulysses") steps, one an epoch
FIT_LM = dict(vocab=32, dim=16, depth=2, heads=4, max_seq=16, pos_embedding="rope")
FIT = dict(epochs=3, global_batch=8)
# what the JAX step composes with a model-parallel mode: accumulation, the
# guard, clipping
FIT_COMPOSED = dict(FIT, accum_steps=2, nan_guard=True, grad_clip=0.5)
FIT_WINDOWS = (8, 16)
FIT_LR = 0.1


def mesh_shape(n: int) -> tuple[int, int]:
    return MESH[0] if n == 4 else (1, n)


def collective_cases(n: int) -> dict[str, tuple[str, dict, tuple, tuple]]:
    """name -> (collective, keyword arguments, input shape, output shape).
    ``group`` names the members (0, n - 1); ``axis`` runs the call over
    that axis's group of the (2, 2) mesh (world 4 only)."""
    g = (0, n - 1)
    cases = {
        "all_reduce_sum": ("all_reduce", {"op": "sum"}, (3, 2), (3, 2)),
        "all_reduce_avg": ("all_reduce", {"op": "avg"}, (4,), (4,)),
        "all_reduce_product": ("all_reduce", {"op": "product"}, (5,), (5,)),
        "all_reduce_sum_group": ("all_reduce", {"op": "sum", "group": g}, (4,), (4,)),
        "all_reduce_product_group": ("all_reduce", {"op": "product", "group": g}, (3,), (3,)),
        "reduce_sum_to_last": ("reduce", {"op": "sum", "dst": n - 1}, (2, 3), (2, 3)),
        "reduce_avg_to_first": ("reduce", {"op": "avg", "dst": 0}, (4,), (4,)),
        "reduce_product_group": ("reduce", {"op": "product", "dst": n - 1, "group": g},
                                 (3,), (3,)),
        "broadcast_from_last": ("broadcast", {"src": n - 1}, (2, 3), (2, 3)),
        "broadcast_group": ("broadcast", {"src": 0, "group": g}, (4,), (4,)),
        "gather_to_first": ("gather", {"dst": 0}, (3,), (n, 3)),
        "gather_group": ("gather", {"dst": n - 1, "group": g}, (2,), (n, 2)),
        "scatter_from_last": ("scatter", {"src": n - 1}, (n, 3), (3,)),
        "scatter_group": ("scatter", {"src": 0, "group": g}, (2, 2), (2,)),
        "reduce_scatter_sum": ("reduce_scatter", {"op": "sum"}, (2 * n, 3), (2, 3)),
        "reduce_scatter_sum_axis1": ("reduce_scatter", {"op": "sum", "scatter_axis": 1},
                                     (3, 2 * n), (3, 2)),
        "reduce_scatter_product": ("reduce_scatter", {"op": "product"}, (n, 2), (1, 2)),
        "sendrecv_ring_back": ("sendrecv", {"perm": [(i, (i - 1) % n) for i in range(n)]},
                               (3,), (3,)),
        "sendrecv_one_pair": ("sendrecv", {"perm": [(0, n - 1)]}, (2, 2), (2, 2)),
        "shift": ("shift", {"offset": 1}, (3,), (3,)),
        "shift_by_2": ("shift", {"offset": 2}, (2,), (2,)),
        "send": ("send", {"dst": n - 1, "src": 0}, (4,), (4,)),
    }
    if n == 4:
        cases.update({
            "all_to_all_seq_axis": ("all_to_all", {"split_axis": 1, "concat_axis": 0,
                                                   "axis": "seq"}, (3, 4), (6, 2)),
            "shift_seq_axis": ("shift", {"offset": 1, "axis": "seq"}, (3,), (3,)),
            "all_reduce_data_axis": ("all_reduce", {"op": "sum", "axis": "data"}, (2,), (2,)),
        })
    return cases


# MAX and MIN have no gradient (JAX's pmax/pmin): the backward raises
NO_GRADIENT = {"all_reduce_max": ("all_reduce", {"op": "max"}),
               "reduce_min": ("reduce", {"op": "min", "dst": 0}),
               "reduce_scatter_max": ("reduce_scatter", {"op": "max"})}


def collective_inputs(n: int) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """name -> (every rank's input ``(n, *in)``, every rank's weights
    ``(n, *out)``): rank r's loss is ``sum(weights[r] * collective(x[r]))``."""
    rng = np.random.default_rng(SEED + n)
    return {name: (rng.standard_normal((n, *shape_in)).astype(np.float32),
                   rng.standard_normal((n, *shape_out)).astype(np.float32))
            for name, (_, _, shape_in, shape_out) in collective_cases(n).items()}


def ulysses_inputs(n: int) -> dict[str, np.ndarray]:
    """q, k, v and the loss weights w, each ``(B, H, n * S_LOCAL, D)``."""
    rng = np.random.default_rng(SEED + 100 * n)
    return {name: rng.standard_normal((B, H, n * S_LOCAL, D)).astype(np.float32)
            for name in ("q", "k", "v", "w")}


def lm_tokens() -> np.ndarray:
    return models.synthetic_tokens(*LM_TOKENS, LMS["learned"]["vocab"], seed=4).numpy()


def fit_windows() -> np.ndarray:
    return models.synthetic_tokens(*FIT_WINDOWS, FIT_LM["vocab"], seed=6).numpy()


def call(fn: str, x: torch.Tensor, kw: dict, mesh) -> torch.Tensor:
    """One collective on this rank; ``group`` and ``axis`` become groups."""
    kw = dict(kw)
    if "group" in kw:
        kw["group"] = comm.new_group(kw["group"])  # every rank, in the same order
    if "axis" in kw:
        kw["group"] = mesh.group(kw.pop("axis"))
    if "op" in kw:
        kw["op"] = comm.ReduceOp[kw["op"].upper()]
    if fn in ("all_reduce", "reduce", "broadcast"):
        x = x.clone()  # they work in place
    if fn in ("reduce", "gather"):
        return getattr(comm, fn)(x, kw.pop("dst"), **kw)
    if fn in ("broadcast", "scatter"):
        return getattr(comm, fn)(x, kw.pop("src"), **kw)
    if fn == "sendrecv":
        return comm.sendrecv(x, kw.pop("perm"), **kw)
    return getattr(comm, fn)(x, **kw)


def _collectives(n: int, r: int, mesh) -> dict:
    out = {}
    for name, (fn, kw, _, _) in collective_cases(n).items():
        xs, ws = collective_inputs(n)[name]
        x = torch.tensor(xs[r], requires_grad=True)
        y = call(fn, x, kw, mesh)
        if y.requires_grad:  # a rank outside the group gets zeros, not a function of x
            (torch.from_numpy(ws[r]) * y).sum().backward()
        out[name] = {"y": y.detach(),
                     "grad": torch.zeros_like(x) if x.grad is None else x.grad}
    refused = {}
    for name, (fn, kw) in NO_GRADIENT.items():
        x = torch.ones(2 * n, requires_grad=True)
        try:
            call(fn, x, kw, mesh).sum().backward()
            refused[name] = ""
        except NotImplementedError as e:
            refused[name] = str(e)
    return {"cases": out, "refused": refused}


def _mesh_layout(mesh) -> dict:
    return {"ranks": torch.from_numpy(mesh.ranks),
            "coords": torch.tensor(mesh.coords),
            **{f"group_{a}": torch.tensor(mesh.group(a).ranks) for a in mesh.axis_names}}


def _ulysses(n: int, r: int) -> dict:
    inputs = {k: torch.from_numpy(v[:, :, r * S_LOCAL : (r + 1) * S_LOCAL])
              for k, v in ulysses_inputs(n).items()}
    out = {}
    for name, kw in ULYSSES.items():
        q, k, v = (inputs[t].clone().requires_grad_() for t in ("q", "k", "v"))
        o = ulysses_attention(q, k, v, **kw)
        (inputs["w"] * o).sum().backward()
        out[name] = {"out": o.detach(), "grads": {"q": q.grad, "k": k.grad, "v": v.grad}}
    try:
        x = torch.ones(1, 3, S_LOCAL, D)
        ulysses_attention(x, x, x)
        out["refused"] = ""
    except ValueError as e:
        out["refused"] = str(e)
    return out


def _lm_seq(states: dict) -> dict:
    """`apply_seq_parallel(attention="ulysses")` and `lm_loss_seq_parallel`
    on this rank's half of the tokens, and the loss's gradients."""
    r = comm.rank()
    half = LM_TOKENS[1] // 2
    local = torch.from_numpy(lm_tokens()[:, r * half : (r + 1) * half])
    out = {}
    for name, kw in LMS.items():
        lm = models.TransformerLM(**kw)
        lm.load_state_dict(states[name])
        logits = lm.apply_seq_parallel(local, attention="ulysses")
        loss = models.lm_loss_seq_parallel(logits, local)
        loss.backward()
        out[name] = {"logits": logits.detach(), "loss": loss.detach(),
                     "grads": {k: p.grad for k, p in lm.named_parameters()}}
    return out


def _fit(state: dict, cfg: dict, mesh, ckpt_dir: str | None = None) -> dict:
    """``LMTrainer(sequence_parallel="ulysses")`` under ``cfg``, sgd(0.1),
    three steps from ``state``; with ``ckpt_dir``, its checkpoint restored
    into a second trainer, which must hold the same bits."""
    lm = models.TransformerLM(**FIT_LM)
    lm.load_state_dict(state)
    config = LMTrainConfig(**cfg, sequence_parallel="ulysses", log=lambda line: None)
    trainer = LMTrainer(lm, config, optimizer=sgd_rule(sgd(lm.parameters(), FIT_LR)),
                        device="cpu", mesh=mesh)
    history = trainer.fit(fit_windows())
    out = {"losses": torch.tensor([s.mean_loss for s in history]),
           "params": {k: p.detach().clone() for k, p in lm.named_parameters()}}
    if ckpt_dir is not None:
        path = os.path.join(ckpt_dir, "seq.npz")
        trainer.save(path, epoch=3)
        dist.barrier()
        other = models.TransformerLM(**FIT_LM, generator=torch.Generator().manual_seed(99))
        again = LMTrainer(other, config, optimizer=sgd_rule(sgd(other.parameters(), FIT_LR)),
                          device="cpu", mesh=mesh)
        out["restored_epoch"] = again.restore(path)
        out["restored_equal"] = all(torch.equal(p, out["params"][k])
                                    for k, p in other.named_parameters())
    return out


def run_all(lm_states: dict | None = None, fit_state: dict | None = None,
            ckpt_dir: str | None = None) -> dict:
    """Every case at this world on its (1, n) or (2, 2) mesh; with the LM
    states (world 2) the LM cases too, and with ``fit_state`` the
    trainer's."""
    torch.set_num_threads(1)
    n, r = comm.world_size(), comm.rank()
    mesh = comm.make_mesh(mesh_shape(n), MESH[1])
    out = {"collectives": _collectives(n, r, mesh), "mesh": _mesh_layout(mesh),
           "ulysses": _ulysses(n, r)}
    if lm_states is not None:
        out["lm_seq"] = _lm_seq(lm_states)
    if fit_state is not None:
        out["fit"] = _fit(fit_state, FIT, mesh, ckpt_dir)
        if n == 2:
            out["fit_composed"] = _fit(fit_state, FIT_COMPOSED, mesh)
    return out
