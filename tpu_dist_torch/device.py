"""Device selection for every entry point of the port.

The card is the default.  The CPU runs only when the caller asks for it, as
the tests do; a missing card is an error, never a reason to carry on on the
CPU.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card: ``cuda:($LOCAL_RANK % device_count)`` (rank
    0 outside torchrun; ranks past the card count share cards).  ``"cpu"``
    means the CPU.  A CUDA device with no card present raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        if device.index is None and "LOCAL_RANK" in os.environ:
            local_rank = int(os.environ["LOCAL_RANK"])
            device = torch.device("cuda", local_rank % torch.cuda.device_count())
        elif device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device
