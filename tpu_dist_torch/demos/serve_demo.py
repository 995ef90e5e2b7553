"""Serving end to end: the port's counterpart of demos/serve_demo.py.

    python -m tpu_dist_torch.demos.serve_demo
    python -m tpu_dist_torch.demos.serve_demo --device cpu

Trains the tiny LM of `demos.generate` on the Markov corpus, saves its
weights with `export.save_params`, brings `serve.LMServer` up from the
artifact (the model built on the meta device, so no random weights are
drawn) with ``TPU_DIST_TELEMETRY`` pointed at a scratch directory, and
pushes a mixed load through it: greedy and sampled requests of mixed
prompt and output lengths, one request cancelled mid-stream.  Then it checks (1) that greedy
continuations follow the Markov table, (2) that every request-lifecycle
event passes the schema validators (`observe.events`: admit, prefill,
decode_step, finish), and (3) that the KV block pool drained.  Exits
nonzero on any violation.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from tpu_dist_torch import export, models, serve
from tpu_dist_torch.demos.generate import chain, train_tiny_lm
from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.observe import events as ev_mod


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=150, help="training steps")
    parser.add_argument("--requests", type=int, default=12, help="requests to serve")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    out = tempfile.mkdtemp(prefix="tpu_dist_torch_serve_")
    os.environ["TPU_DIST_TELEMETRY"] = out

    trained, tokens, loss = train_tiny_lm(96, args.steps, 64, device, log=lambda line: None)
    tokens = tokens.cpu().numpy()
    print(f"trained: final loss {loss:.4f}")
    artifact = os.path.join(out, "weights.npz")
    export.save_params(trained, artifact)
    with torch.device("meta"):
        lm = models.TransformerLM(vocab=64, dim=64, depth=2, heads=4, max_seq=96)
    srv = serve.LMServer.from_artifact(
        lm, artifact,
        serve.ServeConfig(max_batch=4, block_size=8, num_blocks=64, max_seq=64,
                          prefill_chunk=8, decode_event_every=2),
        device=device,
    )
    print(f"server up from {artifact} ({os.path.getsize(artifact):,} bytes) [{device}]")

    rng = np.random.default_rng(0)
    victim = srv.submit(tokens[0, :4], 40)
    greedy = []
    for i in range(args.requests):
        plen = int(rng.integers(2, 6))
        prompt = tokens[i, :plen]
        steps_out = int(rng.integers(4, 20))
        if i % 3 == 2:  # every third request samples
            srv.submit(prompt, steps_out, temperature=0.8, top_k=8, seed=i)
        else:
            greedy.append((srv.submit(prompt, steps_out), prompt, steps_out))
    for _ in range(6):
        srv.step()
    srv.cancel(victim)  # a cancel mid-stream must not wedge the engine
    results = srv.run_until_drained()
    srv.engine.events.close()

    ok = True
    accs = []
    for rid, prompt, steps_out in greedy:
        got = results[rid].tokens
        accs.append((got == chain(prompt[-1:], steps_out)[0][: got.size]).mean())
    acc = float(np.mean(accs))
    print(f"greedy accuracy vs chain: {acc:.2f} (expect >= 0.9)")
    ok &= acc >= 0.9

    vres = results[victim]
    print(f"cancelled request: reason={vres.finish_reason} emitted={vres.emitted}")
    ok &= vres.finish_reason == "cancelled"

    pool = srv.engine.allocator
    print(f"block pool: used={pool.used} high_water={pool.high_water} of "
          f"{pool.num_blocks} (expect used == 0)")
    ok &= pool.used == 0

    n, errors = ev_mod.validate_dir(out)
    if errors:
        print(f"FAIL: {len(errors)} schema violations in {n} records:")
        for e in errors[:20]:
            print(f"  {e}")
        return 1
    kinds = {r["event"] for r in ev_mod.read_events(out)}
    missing = {"request_admit", "prefill", "decode_step", "request_finish"} - kinds
    if missing:
        print(f"FAIL: no {sorted(missing)} events among {sorted(kinds)}")
        return 1
    print(f"OK: {n} events validate ({sorted(kinds)}) in {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
