"""Parameters to and from the JAX package's layout.

A JAX parameter tree is nested dicts, lists and tuples of arrays (numpy
after ``jax.device_get``).  The port's state dict names each leaf by its
path with dots, list positions included: ``{"blocks": [{"attn": {"qkv":
{"w": ...}}}]}`` holds ``blocks.0.attn.qkv.w``.  A `tpu_dist.nn.Sequential`
keeps one dict per layer in a tuple (``{}`` for layers without
parameters), so layer ``i``'s ``"w"`` is ``"i.w"``, the index of the same
layer in a port ``Sequential``.  Only the convolution weight changes
layout (every 4-D leaf): JAX's HWIO against torch's OIHW.  Dense weights
are (in, out) on both sides, and the learned position table stays
(1, max_seq, dim), as do the ViT's 3-D ``cls`` and ``pos``.  The same
mapping carries any tree shaped like the parameters, such as optimizer
moments and momentum buffers, and the model state: a JAX model's
``state`` tree (batch-norm ``mean``/``var``) is the port module's
buffers (`load_jax`, `module_to_jax`); the trainers' checkpoints are
`jax_views` of their live tensors.  KV caches, dense or paged, keep their
layout (`cache_from_jax`, `cache_to_jax`).
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix] = tree
        return
    for key, sub in items:
        _flatten(sub, f"{prefix}.{key}" if prefix else str(key), out)


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX parameter tree -> port state dict (CPU tensors, own memory)."""
    leaves: dict = {}
    _flatten(tree, "", leaves)
    state = {}
    for name, leaf in leaves.items():
        a = np.asarray(leaf)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        state[name] = torch.from_numpy(np.ascontiguousarray(a).copy())
    return state


def jax_view(tensor: torch.Tensor) -> torch.Tensor:
    """A tensor in the JAX layout: a 4-D (OIHW) tensor as an HWIO view of
    its own memory, any other tensor as it is."""
    return tensor.permute(2, 3, 1, 0) if tensor.dim() == 4 else tensor


def _lists(node):
    """Nested dicts whose keys are all 0..n-1 become lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        indices = sorted(int(k) for k in node)
        if indices == list(range(len(indices))):
            return [node[str(i)] for i in indices]
    return node


def _nest(state: dict[str, torch.Tensor], num_layers: int | None, leaf):
    root: dict = {}
    for key, tensor in state.items():
        *path, name = key.split(".")
        node = root
        for part in path:
            node = node.setdefault(part, {})
        node[name] = leaf(tensor)
    if num_layers is not None:
        return tuple(root.get(str(i), {}) for i in range(num_layers))
    return _lists(root)


def params_to_jax(state: dict[str, torch.Tensor], num_layers: int | None = None):
    """Port state dict -> JAX parameter tree of numpy arrays.

    With ``num_layers``: the tuple of per-layer dicts of a ``Sequential`` of
    that many layers.  Without: nested dicts, with lists where the keys are
    list positions (the TransformerLM's ``blocks``)."""
    return _nest(state, num_layers,
                 lambda t: np.ascontiguousarray(jax_view(t).detach().cpu().numpy()))


def jax_views(state: dict[str, torch.Tensor], num_layers: int | None = None):
    """The tree of `params_to_jax`, its leaves the `jax_view`s of the
    tensors themselves: reading a leaf reads the tensor, writing into it
    writes the tensor."""
    return _nest(state, num_layers, jax_view)


def num_layers(module: torch.nn.Module) -> int | None:
    """The layer count a ``Sequential``'s JAX tree has (a tuple of
    per-layer dicts); None for a module whose tree nests by name."""
    return len(module) if isinstance(module, torch.nn.Sequential) else None


def load_jax(module: torch.nn.Module, params, model_state=()) -> None:
    """Load a JAX model's ``(params, state)`` trees into ``module``'s
    parameters and buffers; every one of them must be given."""
    module.load_state_dict({**params_from_jax(params), **params_from_jax(model_state)})


def module_to_jax(module: torch.nn.Module) -> tuple:
    """``module``'s parameters and buffers as the JAX model's ``(params,
    state)`` trees of numpy arrays (a ``Sequential``'s as tuples of
    per-layer dicts)."""
    n = num_layers(module)
    return (params_to_jax(dict(module.named_parameters()), n),
            params_to_jax(dict(module.named_buffers()), n))


def cache_from_jax(cache, device=None) -> list[dict[str, torch.Tensor]]:
    """A JAX KV cache, dense (``TransformerLM.init_cache``: per block
    ``{"k", "v"}`` of ``(batch, kv_heads, len, head_dim)``) or paged
    (``serve.init_paged_cache``: per block ``(blocks + 1, kv_heads,
    block_size, head_dim)``), as the port's: the same layout, tensors with
    their own memory."""
    return [{name: torch.tensor(np.asarray(a), device=device) for name, a in c.items()}
            for c in cache]


def cache_to_jax(cache) -> list[dict[str, np.ndarray]]:
    """The port's dense or paged KV cache as the JAX package's, numpy leaves."""
    return [{name: t.detach().cpu().numpy() for name, t in c.items()} for c in cache]
