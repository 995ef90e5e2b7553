"""``python -m tpu_dist_torch.run`` — the external script launcher.

The port of `tpu_dist.run`, the torchrun/mpirun analog (``mpirun -n 4
python myscript.py``, tuto.md:393-398):

    python -m tpu_dist_torch.run --nproc 4 myscript.py --arg value

It starts ``nproc`` copies of the script with the rendezvous contract set:
MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK (tuto.md:421-428), and
LOCAL_RANK, which picks the card (``cuda:(LOCAL_RANK % device_count)``).
The launcher hosts the store on MASTER_PORT (by default a port the system
picks as it binds it) and tells the ranks so (``TORCHELASTIC_USE_AGENT_STORE``,
which `comm.init_process_group` and torch's own ``env://`` init both read),
so every rank joins as a client.  ``--rankless`` omits RANK, and the store
hands out ranks first come, first served (the rank-less init of
allreduce.py:54).

Fail-stop: the first child that exits non-zero makes the launcher terminate
the rest and exit with that code.  Child output passes through, line by
line, with a ``[rank N]`` prefix (``--no-tag`` drops it).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading

from tpu_dist_torch.comm import init as _init


def _stream(proc, rank: int, tag: bool):
    prefix = f"[rank {rank}] " if tag else ""
    for line in proc.stdout:
        sys.stdout.write(f"{prefix}{line}")
        sys.stdout.flush()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_dist_torch.run",
        description="Launch N copies of a script with the distributed rendezvous "
                    "environment set (torchrun/mpirun analog).",
    )
    ap.add_argument("--nproc", type=int, required=True, help="world size")
    ap.add_argument("--master-addr", default="127.0.0.1")
    ap.add_argument("--master-port", type=int, default=0, help="0 = pick a free port")
    ap.add_argument("--rankless", action="store_true",
                    help="omit RANK; ranks assigned first come, first served by the store")
    ap.add_argument("--no-tag", action="store_true",
                    help="don't prefix child output with [rank N]")
    ap.add_argument("script", help="python script to run per rank")
    ap.add_argument("script_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.nproc < 1:
        ap.error("--nproc must be >= 1")

    store = _init.host_store(args.master_addr, args.master_port)  # held until the end
    procs: list[subprocess.Popen] = []
    threads = []
    for rank in range(args.nproc):
        env = dict(os.environ, **_init.launcher_env(store, args.master_addr, args.nproc),
                   LOCAL_RANK=str(rank))
        env.pop("TPU_DIST_INIT_METHOD", None)  # this launcher's store, whatever was inherited
        if args.rankless:
            env.pop("RANK", None)
        else:
            env["RANK"] = str(rank)
        p = subprocess.Popen(
            [sys.executable, args.script, *args.script_args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, bufsize=1,
        )
        procs.append(p)
        t = threading.Thread(target=_stream, args=(p, rank, not args.no_tag), daemon=True)
        t.start()
        threads.append(t)

    # fail-stop: the first non-zero exit kills the rest (the reference's
    # failure model: blocked peers and join, SURVEY.md §5)
    rc = 0
    alive = set(range(args.nproc))
    while alive:
        for r in sorted(alive):
            code = procs[r].poll()
            if code is None:
                continue
            alive.discard(r)
            if code != 0 and rc == 0:
                rc = code
                sys.stderr.write(f"[tpu_dist_torch.run] rank {r} exited with {code}; "
                                 "terminating remaining ranks\n")
                for other in alive:
                    procs[other].terminate()
        if alive:
            try:
                procs[next(iter(alive))].wait(timeout=0.1)
            except subprocess.TimeoutExpired:
                pass
    for t in threads:
        t.join(timeout=5)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
