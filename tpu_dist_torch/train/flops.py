"""Analytic FLOP counts, and the card's published peaks.

The counters of `tpu_dist.train.flops` (matrix-product terms only, 2 FLOP
per multiply-add).  The peak table holds only the NVIDIA cards the port
runs on, keyed by ``torch.cuda.get_device_name()``: H100 SXM, dense rates
(NVIDIA's data sheet), which assume the card's full 700 W power limit.
"""

from __future__ import annotations

import torch

# name -> {"bfloat16", "float16": FLOP/s on the tensor cores, "float32":
# FLOP/s outside them, "hbm_bytes_per_s": device memory bandwidth}
PEAKS: dict[str, dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12,
        "float16": 989e12,
        "float32": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peak_flops(device_name: str, dtype: torch.dtype = torch.bfloat16) -> float | None:
    """Dense peak FLOP/s of the card for operands of ``dtype`` (bfloat16,
    float16 or float32), or None for a card the table does not hold."""
    peaks = PEAKS.get(device_name)
    return None if peaks is None else peaks[str(dtype).removeprefix("torch.")]


def peak_bytes_per_s(device_name: str) -> float | None:
    peaks = PEAKS.get(device_name)
    return None if peaks is None else peaks["hbm_bytes_per_s"]


def linear_flops(batch: int, d_in: int, d_out: int) -> float:
    return 2.0 * batch * d_in * d_out


def attention_flops(
    batch: int, heads: int, seq_q: int, seq_k: int, head_dim: int, *, causal: bool = False
) -> float:
    """QK^T + PV product FLOPs (4*b*h*sq*sk*d).  ``causal`` counts only the
    visible scores under the bottom-right alignment: query i of sq (ending
    at key sk) sees ``sk - sq + i + 1`` keys."""
    f = 2.0 * batch * heads * seq_q * seq_k * head_dim * 2
    if not causal:
        return f
    realizable = seq_q * seq_k - seq_q * (seq_q - 1) / 2
    return f * realizable / (seq_q * seq_k)


def train_step_flops_estimate(forward_flops: float) -> float:
    """Forward and backward: backward ~ 2x forward, so 3x in all."""
    return 3.0 * forward_flops
