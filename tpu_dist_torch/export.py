"""Raw-weights serving artifacts: `save_params` and `load_params`.

The counterpart of `tpu_dist.export.save_params`/`load_params`, on
`train.checkpoint`'s ``.npz`` with its sha256 digest and the JAX package's
key paths, so an artifact written by either package loads in the other's
`LMServer.from_artifact`.  The StableHLO artifacts of the JAX module
(``export_forward``, ``export_generate``, ``load``) map to ``torch.export``,
which is not ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

from pathlib import Path

import torch

from tpu_dist_torch import interop
from tpu_dist_torch.train import checkpoint


def _state(params) -> dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def save_params(params, path: str | Path) -> None:
    """Write a module's parameters (or a state dict) as the JAX package's
    parameter tree."""
    checkpoint.save(path, interop.jax_views(_state(params)))


def load_params(path: str | Path, like) -> dict[str, torch.Tensor]:
    """The parameters of a `save_params` artifact (either package's) as a
    state dict of CPU tensors, checked against the names of ``like`` (a
    module or state dict; meta tensors will do) and the file's digest."""
    tree, _ = checkpoint.restore(path, interop.jax_views(_state(like)))
    return interop.params_from_jax(tree)
