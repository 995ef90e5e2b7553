"""Device selection for every entry point of the port, and `Replay`, the
CUDA graph of a decode step.

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


class Replay:
    """``step`` (a function of no arguments that reads and writes only
    tensors it keeps, and must not synchronise) run as one CUDA graph on
    the card: eagerly on a side stream at the first call, captured at the
    second, replayed from then on, so a decode step costs one launch from
    the host instead of one per kernel.  On the CPU it is ``step`` itself.
    Each call returns what ``step`` returned, the same tensors every time
    on the card: read them before the next call."""

    def __init__(self, step, device: torch.device):
        self.step, self.device = step, torch.device(device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.warm = False
        self.out = None

    def __call__(self):
        if self.device.type != "cuda":
            return self.step()
        if self.graph is None and not self.warm:
            # the first step eagerly, off the main stream, as torch asks
            # before a capture (lazy initialisation, workspaces)
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = self.step()
            main.wait_stream(side)
            self.warm = True
            return out
        if self.graph is None:
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self.step()
        self.graph.replay()
        return self.out
