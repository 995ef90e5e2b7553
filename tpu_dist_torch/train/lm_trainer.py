"""LMTrainer: data-parallel, expert-parallel and sequence-parallel training
of the TransformerLM over token windows.

The port of `tpu_dist.train.LMTrainer` on its data-parallel, MoE and
sequence-parallel paths:
per step the dense next-token loss on the global batch (each rank its slice, over
``accum_steps`` microbatches), the gradients averaged over ranks with one
all-reduce that also carries the loss, and AdamW (optionally under
``grad_clip``, and under ``nan_guard`` outermost, with the dynamic
``loss_scale``).  Per epoch the JAX package's order
(``default_rng(seed + epoch).permutation``), ``n // global_batch`` steps fed
through a `data.HostLoader`, the mean loss, tokens/s, ``bad_steps`` under
the guard and, given ``val_windows``, the validation perplexity; given
``checkpoint_dir``, ``lm_ckpt_<epoch>.npz`` written asynchronously, and
``lm_ckpt_preempt.npz`` on SIGTERM or SIGINT.

``compute_dtype`` (``"float32"``, ``"bfloat16"`` or ``"float16"``) runs the
forward and backward on a copy of the float32 master parameters in that
type, cast where the JAX package casts (every floating leaf, before the
forward), and the gradients land on the masters; the loss is a float32
log-softmax of the logits.

``moe=True`` trains a `TransformerLM` with ``moe_experts`` equal to the
world size expert-parallel: the loss is `TransformerLM.loss_moe_ep` on this
rank's tokens (one expert per rank, tokens dispatched by all_to_all, plus
the weighted balance loss), and the gradients and the loss go through the
same mean over ranks, which is the JAX step's uniform ``pmean`` contract.
It composes with ``accum_steps``, ``compute_dtype``, ``grad_clip``,
``nan_guard`` and ``loss_scale``, as in the JAX package.  Without ``moe``
a model with experts trains data-parallel on its dense MoE evaluation.

``sequence_parallel="ring"`` or ``"ulysses"`` trains over a ``(data,
seq)`` mesh (`comm.make_mesh`): rank ``(d, s)`` takes rows ``d`` of the
global batch and columns ``s`` of the window (the JAX step's ``P(data,
seq)`` batch spec), the loss is `lm_loss_seq_parallel` on
`TransformerLM.apply_seq_parallel`'s logits over the ``seq`` group (its
attention core the K/V ring or the Ulysses all-to-all), and the
gradients and the loss go through the same mean over every rank: the
JAX step's pmean over ``data`` and over ``seq`` (``extra_grad_axes``), the
parameters being replicated.  It composes with everything ``moe`` does.

Checkpoints hold ``{"params", "opt_state"}`` in the JAX package's layout
(`interop`), so either package's `LMTrainer.restore` reads the other's.

Not ported yet (ROADMAP queue 1): the fsdp, zero1, tensor and pipeline
modes, compressed gradients, partition rules (item 10; the tensor and
pipeline fields exist and refuse), in-flight steps and telemetry (item
11), ``generate`` (item 9).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from tpu_dist_torch.comm.mesh import DATA_AXIS, Mesh, world_mesh
from tpu_dist_torch.data.loader import HostLoader
from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.models.transformer_lm import lm_loss, lm_loss_seq_parallel, lm_perplexity
from tpu_dist_torch.parallel.data_parallel import (
    accumulate_gradients,
    average_gradients,
    broadcast_parameters,
)
from tpu_dist_torch.resilience.guards import bad_steps, poison_if_nonfinite
from tpu_dist_torch.resilience.preempt import PreemptionGuard
from tpu_dist_torch.train import checkpoint
from tpu_dist_torch.train.optim import Optimizer, adamw, clip_by_global_norm
from tpu_dist_torch.train.trainer import compute_dtype_of, guarded, jax_layout, restore_leaves


@dataclass
class LMTrainConfig:
    epochs: int = 3
    global_batch: int = 64
    lr: float = 3e-3
    seed: int = 1234
    accum_steps: int = 1
    compute_dtype: str | None = None  # e.g. "bfloat16"
    grad_clip: float | None = None  # global-norm clipping
    # Skip-and-count of non-finite steps (LMEpochStats.bad_steps);
    # loss_scale arms the dynamic loss scale.
    nan_guard: bool = False
    loss_scale: float | None = None
    # Expert-parallel MoE: lm.moe_experts == world size, one expert per
    # rank (TransformerLM.loss_moe_ep).
    moe: bool = False
    # Sequence-parallel training over the mesh's seq_axis: "ring" (K/V
    # blocks rotate around the seq group) or "ulysses" (all-to-all head
    # resharding).  seq_axis names the mesh axis, as the JAX package's
    # config field does.
    sequence_parallel: str | None = None
    seq_axis: str = "seq"
    # The JAX package's other model-parallel modes, not ported yet: set,
    # they refuse.
    tensor_parallel: str | None = None
    pipeline: str | None = None
    log: Callable[[str], None] = print


@dataclass
class LMEpochStats:
    epoch: int
    mean_loss: float
    seconds: float
    tokens_per_sec: float
    val_loss: float | None = None
    val_perplexity: float | None = None
    bad_steps: int | None = None


def _check_modes(config: LMTrainConfig, lm: torch.nn.Module, mesh: Mesh) -> None:
    """The JAX LMTrainer's exclusion of its model-parallel modes, then the
    modes the port lacks, then each mode's mesh and ``moe``'s expert
    count."""
    modes = {"tensor_parallel": config.tensor_parallel,
             "sequence_parallel": config.sequence_parallel, "pipeline": config.pipeline}
    if sum(v is not None for v in modes.values()) + bool(config.moe) > 1:
        raise ValueError(
            "tensor_parallel, sequence_parallel, pipeline, and moe are mutually exclusive "
            "trainer modes"
        )
    unported = [name for name in ("tensor_parallel", "pipeline") if modes[name] is not None]
    if unported:
        raise NotImplementedError(
            f"LMTrainer {unported[0]}: not ported yet (ROADMAP queue 1, item 10, the "
            "parallel strategies); the port trains data-parallel, moe=True or "
            "sequence_parallel='ring'|'ulysses'"
        )
    sp = config.sequence_parallel
    if sp is not None:
        if sp not in ("ring", "ulysses"):
            raise ValueError(f"sequence_parallel must be 'ring' or 'ulysses', got {sp!r}")
        if config.seq_axis not in mesh.shape:
            raise ValueError(
                f"sequence_parallel needs a {config.seq_axis!r} mesh axis; mesh has "
                f"{mesh.axis_names}"
            )
        if set(mesh.axis_names) - {DATA_AXIS, config.seq_axis}:
            raise ValueError(f"sequence_parallel runs on a ({DATA_AXIS!r}, "
                             f"{config.seq_axis!r}) mesh; mesh has {mesh.axis_names}")
    elif mesh.axis_names != (DATA_AXIS,):
        raise ValueError(f"without sequence_parallel the mesh is the 1-D {DATA_AXIS!r} mesh "
                         f"(comm.world_mesh()); mesh has {mesh.axis_names}")
    experts = getattr(lm, "moe_experts", 0)
    data = mesh.shape.get(DATA_AXIS, 1)
    if config.moe and experts != data:
        raise ValueError(
            f"moe mode needs lm.moe_experts == data-axis size ({data}), got {experts}"
        )


class _StepLoss(torch.nn.Module):
    """The loss of this rank's tokens as a module over the LM, so that
    `functional_call` runs it on the cast parameters: the dense next-token
    loss, with ``moe`` `TransformerLM.loss_moe_ep`, or with
    ``sequence_parallel`` the boundary-correct loss of this rank's
    sequence shard over ``seq_group``."""

    def __init__(self, lm: torch.nn.Module, moe: bool, sequence_parallel: str | None,
                 seq_group):
        super().__init__()
        self.lm, self.moe = lm, moe
        self.sequence_parallel, self.seq_group = sequence_parallel, seq_group

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.moe:
            return self.lm.loss_moe_ep(tokens)
        if self.sequence_parallel is not None:
            logits = self.lm.apply_seq_parallel(tokens, self.seq_group,
                                                attention=self.sequence_parallel)
            return lm_loss_seq_parallel(logits.float(), tokens, self.seq_group)
        return lm_loss(self.lm(tokens).float(), tokens)


class LMTrainer:
    """Data-parallel (with ``moe`` expert-parallel, with
    ``sequence_parallel`` sequence-parallel) LM training over ``(N, S)``
    token windows.

    ``mesh``: the world's ranks as a `comm.Mesh`; the default is the 1-D
    ``data`` mesh of the world (`comm.world_mesh`), a sequence-parallel
    run a ``(data, seq)`` one.  The model arrives initialized; the trainer
    moves it to ``device``, in a process group overwrites every rank's
    parameters and buffers with rank 0's (the replicas start equal however
    each rank built the model), and keeps its float32 parameters as the
    masters the optimizer updates in place."""

    def __init__(
        self,
        lm: torch.nn.Module,
        config: LMTrainConfig | None = None,
        *,
        optimizer: Optimizer | None = None,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
    ):
        self.device = resolve_device(device)
        self.config = config or LMTrainConfig()
        if self.config.accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {self.config.accum_steps}")
        self.compute_dtype = compute_dtype_of(self.config.compute_dtype)
        self.distributed = dist.is_initialized()
        if self.distributed:
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.world = 0, 1
        self.mesh = world_mesh() if mesh is None else mesh
        _check_modes(self.config, lm, self.mesh)
        self.lm = lm.to(self.device)
        sp = self.config.sequence_parallel
        self._step_loss = _StepLoss(self.lm, self.config.moe, sp,
                                    None if sp is None else self.mesh.group(self.config.seq_axis))
        if self.distributed:
            broadcast_parameters(self.lm)
        self.params = dict(self.lm.named_parameters())
        self.optimizer = optimizer or adamw(self.config.lr)
        if self.config.grad_clip is not None:
            self.optimizer = clip_by_global_norm(self.optimizer, self.config.grad_clip)
        # outermost, over grad_clip: a non-finite step is skipped before
        # clipping touches it
        self.optimizer = guarded(self.optimizer, self.config)
        self.opt_state = self.optimizer.init(
            {k: p.detach() for k, p in self.params.items()}
        )

    def _loss(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return self._step_loss(tokens)
        cast = {
            f"lm.{k}": p.to(self.compute_dtype) if p.is_floating_point() else p
            for k, p in self.params.items()
        }
        return functional_call(self._step_loss, cast, (tokens,))

    def loss_and_grads(self, tokens: torch.Tensor) -> torch.Tensor:
        """Forward and backward on this rank's (b, s) tokens, over
        ``accum_steps`` microbatches and under the guard's loss scale:
        leaves the mean gradients in each master's ``.grad`` and returns the
        loss (0-d, detached)."""
        cfg = self.config
        scale = (
            self.optimizer.current_scale(self.opt_state) if cfg.loss_scale is not None else None
        )
        return accumulate_gradients(
            self._loss, list(self.params.values()), (tokens,),
            accum_steps=cfg.accum_steps, scale=scale,
        )

    def train_step(self, tokens: torch.Tensor) -> torch.Tensor:
        """One AdamW step; returns the loss averaged over ranks, a 0-d
        tensor on the device (not synchronized)."""
        loss = self.loss_and_grads(tokens).reshape(1)
        grads = {k: p.grad for k, p in self.params.items()}
        if self.config.nan_guard:
            poison_if_nonfinite(grads.values(), loss)
        if self.distributed:
            average_gradients(list(grads.values()) + [loss])
        self.optimizer.update(self.params, grads, self.opt_state)
        return loss.reshape(())

    def _ckpt_tree(self) -> dict:
        """``{"params", "opt_state"}`` in the JAX LMTrainer's layout, as
        views of the live tensors."""
        return {"params": jax_layout(self.params, self.params),
                "opt_state": jax_layout(self.opt_state, self.params)}

    def save(self, path, *, epoch: int = 0, async_writer=None) -> None:
        """Checkpoint the parameters and optimizer state (rank 0 writes);
        with ``async_writer`` the file is written while training goes on."""
        writer = async_writer or checkpoint
        writer.save(path, self._ckpt_tree(), step=epoch)

    def restore(self, path) -> int:
        """Load state written by `save` (or by the JAX LMTrainer); returns
        the stored epoch (the resume point)."""
        live = self._ckpt_tree()
        loaded, epoch = checkpoint.restore(path, live)
        restore_leaves(live, loaded)
        return epoch

    def _batch_slices(self, gb: int, s: int) -> tuple[slice, slice]:
        """This rank's rows of a global batch of ``gb`` windows of ``s``
        tokens and its columns: rows ``d`` of the data axis, columns ``s``
        of the sequence axis (all of them without one)."""
        n_data = self.mesh.shape.get(DATA_AXIS, 1)
        if gb % n_data:
            raise ValueError(f"global batch {gb} does not split over {n_data} ranks")
        local = gb // n_data
        d = self.mesh.index(DATA_AXIS) if DATA_AXIS in self.mesh.shape else 0
        rows = slice(d * local, (d + 1) * local)
        if self.config.sequence_parallel is None:
            return rows, slice(None)
        n_seq = self.mesh.shape[self.config.seq_axis]
        if s % n_seq:
            raise ValueError(f"window of {s} tokens does not split over {n_seq} sequence ranks")
        s_local = s // n_seq
        c = self.mesh.index(self.config.seq_axis)
        return rows, slice(c * s_local, (c + 1) * s_local)

    def fit(
        self,
        windows,
        *,
        epochs: int | None = None,
        val_windows=None,
        checkpoint_dir: str | None = None,
        start_epoch: int = 0,
    ) -> list[LMEpochStats]:
        """``windows``: (N, S) int tokens (e.g. `models.synthetic_tokens`).
        Trains epochs ``start_epoch`` .. ``epochs``; ``checkpoint_dir`` as in
        `Trainer.fit`, with files named ``lm_ckpt_*``."""
        cfg = self.config
        windows = np.asarray(windows)
        n, s = windows.shape
        gb = cfg.global_batch
        if n < gb:
            raise ValueError(
                f"{n} windows < global batch {gb} — shrink the batch or use more data"
            )
        rows, cols = self._batch_slices(gb, s)
        steps_per_epoch = n // gb
        history = []
        with checkpoint.AsyncCheckpointer() as writer, PreemptionGuard() as preempt:
            for epoch in range(start_epoch, epochs if epochs is not None else cfg.epochs):
                order = np.random.default_rng(cfg.seed + epoch).permutation(n)

                def host_batches(order=order):
                    for b in range(steps_per_epoch):
                        yield windows[order[b * gb : (b + 1) * gb][rows], cols]

                t0 = time.perf_counter()
                total = torch.zeros((), dtype=torch.float64, device=self.device)
                with HostLoader(host_batches(), self.device) as batches:
                    for tokens in batches:
                        total += self.train_step(tokens)
                        if preempt.requested:
                            break
                if preempt.requested:
                    if checkpoint_dir:
                        writer.wait()
                        self.save(f"{checkpoint_dir}/lm_ckpt_preempt.npz", epoch=epoch)
                    cfg.log(
                        f"preemption ({preempt.signal_name}) at epoch {epoch}: "
                        + ("checkpoint written, stopping" if checkpoint_dir
                           else "no checkpoint_dir, stopping")
                    )
                    break
                mean = total.item() / steps_per_epoch  # waits for the device
                dt = time.perf_counter() - t0
                tps = steps_per_epoch * gb * s / dt
                vloss = vppl = None
                if val_windows is not None:
                    vloss, vppl = lm_perplexity(
                        self.lm, val_windows, batch=min(64, len(val_windows))
                    )
                bad = bad_steps(self.opt_state)  # None without the guard
                cfg.log(
                    f"epoch {epoch}: loss {mean:.4f}  [{tps:,.0f} tok/s]"
                    + (f"  val loss {vloss:.4f} ppl {vppl:.1f}" if vppl else "")
                    + (f"  bad_steps {bad}" if bad else "")
                )
                history.append(LMEpochStats(epoch, mean, dt, tps, vloss, vppl, bad))
                if checkpoint_dir:
                    self.save(f"{checkpoint_dir}/lm_ckpt_{epoch}.npz", epoch=epoch + 1,
                              async_writer=writer)
        return history
