"""Request front end over the continuous-batching engine.

`LMServer`, the counterpart of `tpu_dist.serve.LMServer`: built around a
model, or from a weights artifact on disk (`export.save_params`, from either
package), it takes requests with their own sampling parameters (`submit`)
and drives the engine (`step`, `run_until_drained`).  Telemetry flows
through the engine (``TPU_DIST_TELEMETRY`` events, the ``tpu_dist_serve_*``
metrics).
"""

from __future__ import annotations

import time

import torch

from tpu_dist_torch.serve.engine import RequestResult, SamplingParams, ServeConfig, ServeEngine


class LMServer:
    """One model, one paged KV pool, one admission queue.  ``device``: None
    = the card, ``"cpu"`` when asked."""

    def __init__(self, lm, config: ServeConfig | None = None, *, device=None,
                 now=time.monotonic, events=None):
        self.lm = lm
        self.engine = ServeEngine(lm, config, device=device, now=now, events=events)

    @classmethod
    def from_artifact(cls, lm, path, config: ServeConfig | None = None, *, device=None,
                      **kw) -> "LMServer":
        """Serve the weights of a `save_params` artifact with ``lm``'s
        structure.  ``lm`` may be built on the meta device
        (``with torch.device("meta"): TransformerLM(...)``): its parameters
        are then made on ``device`` and filled from the file, with no
        random weights drawn."""
        from tpu_dist_torch import export
        from tpu_dist_torch.device import resolve_device

        device = resolve_device(device)
        state = export.load_params(path, lm)
        if any(p.is_meta for p in lm.parameters()):
            lm = lm.to_empty(device=device)
        with torch.no_grad():
            for name, p in lm.named_parameters():
                p.copy_(state[name])
        return cls(lm, config, device=device, **kw)

    def submit(self, prompt, max_new_tokens: int, *, temperature: float = 0.0,
               top_k: int | None = None, top_p: float | None = None, seed: int = 0,
               stop_token: int | None = None) -> int:
        """Queue a request; returns its id (see `result`)."""
        return self.engine.submit(
            prompt, max_new_tokens,
            sampling=SamplingParams(temperature=temperature, top_k=top_k, top_p=top_p,
                                    seed=seed),
            stop_token=stop_token,
        )

    def cancel(self, request_id: int) -> bool:
        return self.engine.cancel(request_id)

    def step(self) -> None:
        self.engine.step()

    def run_until_drained(self, **kw) -> dict[int, RequestResult]:
        return self.engine.run_until_drained(**kw)

    def result(self, request_id: int) -> RequestResult | None:
        return self.engine.results.get(request_id)

    @property
    def pending(self) -> bool:
        return self.engine.pending
