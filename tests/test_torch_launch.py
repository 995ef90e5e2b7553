"""The port's bootstrap and launchers against the JAX package's contracts.

- `resilience.retry`: the same schedule as `tpu_dist.resilience.retry` for
  the same inputs (delays from the same seeded ``random.Random``, the cap,
  the deadline, the typed error), on a fake clock.
- `comm.InitConfig.from_env` field for field against the JAX package's;
  the ``file://`` init's refusal of an off-host MASTER_ADDR; rank-less init.
- `comm.launch`: rank-less init at world 3 (each rank assigned once),
  fail-stop, and ``restarts=1`` on a fresh store.
- ``python -m tpu_dist_torch.run``: the env contract, ``--rankless``, the
  child's exit code, argument pass-through and an all-reduce through
  `comm.init_process_group`, as tests/test_run_cli.py holds ``tpu_dist.run``.
"""

import importlib
import random
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from tests import torch_collective_workers as workers
from tpu_dist.resilience import retry as jax_retry
from tpu_dist_torch import comm
from tpu_dist_torch.comm import init as port_init
from tpu_dist_torch.resilience import RendezvousTimeout, RetryPolicy, WorkerFailed
from tpu_dist_torch.resilience import retry as port_retry

REPO = Path(__file__).resolve().parents[1]
jax_init = importlib.import_module("tpu_dist.comm.init")  # `tpu_dist.comm.init` is a function


class FakeClock:
    def __init__(self):
        self.now, self.sleeps = 0.0, []

    def sleep(self, d):
        self.sleeps.append(d)
        self.now += d

    def __call__(self):
        return self.now


def _schedule(module, policy_kw: dict, fail_until: int, burn: float, seed: int) -> dict:
    """One retry_call of ``module`` on a fake clock: the sleeps, the log,
    the attempts, and the outcome."""
    clk, logs, calls = FakeClock(), [], []

    def fn(attempt):
        calls.append(attempt)
        clk.now += burn
        if attempt < fail_until:
            raise OSError("transient")
        return "joined"

    try:
        out = module.retry_call(fn, policy=module.RetryPolicy(**policy_kw), describe="rdzv",
                                error_type=module.RendezvousTimeout, sleep=clk.sleep,
                                clock=clk, log=logs.append, rng=random.Random(seed))
    except module.RendezvousTimeout as e:
        out = f"{type(e).__name__}: {e} <- {type(e.__cause__).__name__}"
    return {"sleeps": clk.sleeps, "logs": logs, "calls": calls, "out": out}


@pytest.mark.parametrize("policy_kw, fail_until, burn", [
    (dict(max_attempts=5, base_delay=0.25, jitter=0.0), 3, 0.0),  # joins on attempt 4
    (dict(max_attempts=6, base_delay=0.25, jitter=0.25), 5, 0.0),  # jittered, seeded
    (dict(max_attempts=6, base_delay=1.0, max_delay=3.0, jitter=0.0), 5, 0.0),  # the cap
    (dict(max_attempts=3, jitter=0.0), 9, 0.0),  # spent: the typed error
    (dict(max_attempts=10, jitter=0.1, deadline=10.0), 99, 4.0),  # the deadline
], ids=["backoff", "jitter", "cap", "exhausted", "deadline"])
def test_retry_schedule_matches_jax_package(policy_kw, fail_until, burn):
    got = _schedule(port_retry, policy_kw, fail_until, burn, seed=3)
    want = _schedule(jax_retry, policy_kw, fail_until, burn, seed=3)
    assert got == want
    assert got["sleeps"] or got["out"] == "joined"


def test_retry_policy_from_env_matches_jax_package(monkeypatch):
    monkeypatch.setenv("TPU_DIST_RDZV_RETRIES", "9")
    monkeypatch.setenv("TPU_DIST_RDZV_BASE_DELAY", "0.5")
    monkeypatch.setenv("TPU_DIST_STARTUP_DEADLINE", "120.5")
    assert RetryPolicy.from_env() == RetryPolicy(max_attempts=9, base_delay=0.5,
                                                 deadline=120.5)
    assert vars(RetryPolicy.from_env()) == vars(jax_retry.RetryPolicy.from_env())
    monkeypatch.setenv("TPU_DIST_RDZV_RETRIES", "many")
    with pytest.raises(ValueError, match="TPU_DIST_RDZV_RETRIES"):
        RetryPolicy.from_env()


def test_rendezvous_retries_then_raises_the_typed_error(monkeypatch):
    """A store that never comes: every attempt fails, and the init raises
    RendezvousTimeout after the policy's attempts."""
    attempts = []

    def no_store(*args, **kwargs):
        attempts.append(kwargs.get("is_master"))
        raise RuntimeError("connection refused")

    monkeypatch.setattr(port_init.dist, "TCPStore", no_store)
    monkeypatch.setenv("TPU_DIST_RDZV_RETRIES", "3")
    monkeypatch.setenv("TPU_DIST_RDZV_BASE_DELAY", "0.01")
    monkeypatch.delenv("TPU_DIST_INIT_METHOD", raising=False)
    monkeypatch.delenv(port_init.AGENT_STORE, raising=False)
    for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT="1", WORLD_SIZE="2",
                     RANK="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RendezvousTimeout, match="after 3 attempt"):
        comm.init_process_group(torch.device("cpu"))
    assert attempts == [False] * 3  # rank 1 is a client of rank 0's store


@pytest.mark.parametrize("env", [
    dict(MASTER_ADDR="10.0.0.1", MASTER_PORT="29500", WORLD_SIZE="4", RANK="2"),
    dict(MASTER_ADDR="10.0.0.1", WORLD_SIZE="3"),  # no port: no coordinator
    {},
], ids=["full", "addr-without-port", "empty"])
def test_init_config_from_env_matches_jax_package(monkeypatch, env):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = comm.InitConfig.from_env(), jax_init.InitConfig.from_env()
    assert (got.coordinator_address, got.num_processes, got.process_id) == (
        want.coordinator_address, want.num_processes, want.process_id)


def test_file_init_refuses_an_off_host_master_addr(monkeypatch, tmp_path):
    """file:// is single-host: a MASTER_ADDR that resolves off this host
    (TEST-NET-3) is refused before any store is made, as the JAX package
    refuses it; this host's own names pass the same check."""
    monkeypatch.setenv("MASTER_ADDR", "203.0.113.7")
    monkeypatch.setenv("TPU_DIST_INIT_METHOD", f"file://{tmp_path}/rdzv")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="single-host only"):
        comm.init_process_group(torch.device("cpu"))
    assert not (tmp_path / "rdzv").exists()
    for addr in ("203.0.113.7", "localhost", "127.0.0.1"):
        assert port_init._addr_is_remote(addr) == jax_init._addr_is_remote(addr)


def test_rankless_tcp_init_needs_a_launchers_store(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv(port_init.AGENT_STORE, raising=False)
    monkeypatch.delenv("TPU_DIST_INIT_METHOD", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="rank-less init"):
        comm.init_process_group(torch.device("cpu"))


def test_launch_rankless_assigns_each_rank_once():
    """World 3 with RANK unset: the launcher's store hands out ranks 0-2,
    each once, and the world all-reduces."""
    out = comm.launch(workers.rank_and_sum, 3, device="cpu", assign_ranks=False, timeout=120)
    assert sorted(o["dist_rank"] for o in out) == [0, 1, 2]
    assert all(o["rank"] == o["dist_rank"] and o["world"] == 3 and o["sum"] == 3.0
               and o["attempt"] == 0 for o in out)


def test_launch_fail_stop_terminates_the_others():
    t0 = time.monotonic()
    with pytest.raises(WorkerFailed, match="rank 1 fails on purpose"):
        comm.launch(workers.fail_on_rank_1, 3, device="cpu", timeout=120)
    assert time.monotonic() - t0 < 45  # the others sleep 60 s unless terminated


@pytest.mark.parametrize("method", ["tcp", "file-rankless"])
def test_launch_restarts_the_gang_on_a_fresh_store(tmp_path, method):
    """Rank 1 fails attempt 0; with restarts=1 the gang runs again, on a
    fresh store (the launcher's, or a ``file://`` one whose counter hands
    out the ranks), and attempt 1 returns."""
    init = f"file://{tmp_path}/rdzv" if method == "file-rankless" else None
    out = comm.launch(workers.fail_on_rank_1_first_attempt, 2, device="cpu",
                      init_method=init, assign_ranks=init is None, restarts=1, timeout=120)
    assert out == [2.0, 2.0]


def test_launch_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="file:///path"):
        comm.launch(workers.rank_and_sum, 2, device="cpu", init_method="tcp://x:1")
    with pytest.raises(TypeError):
        comm.launch(workers.rank_and_sum, 2, device="cpu", probe_world=lambda: 1)


def _run(script: Path, *extra, timeout=120):
    return subprocess.run([sys.executable, "-m", "tpu_dist_torch.run", *extra, str(script)],
                          capture_output=True, text=True, timeout=timeout, cwd=REPO)


def test_run_env_contract_and_world(tmp_path):
    script = tmp_path / "w.py"
    script.write_text(textwrap.dedent("""
        import os
        print("R", os.environ["RANK"], "W", os.environ["WORLD_SIZE"],
              "L", os.environ["LOCAL_RANK"], "P", os.environ["MASTER_PORT"], flush=True)
    """))
    proc = _run(script, "--nproc", "3")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [line for line in proc.stdout.splitlines() if " W 3 " in line]
    assert len(lines) == 3
    assert sorted(line.split("R ")[1].split()[0] for line in lines) == ["0", "1", "2"]
    assert all(line.split("R ")[1].split()[0] == line.split("L ")[1].split()[0]
               for line in lines)
    assert all("[rank " in line for line in lines)  # tagged passthrough
    assert len({line.rsplit("P ", 1)[1] for line in lines}) == 1  # one store for all


def test_run_rankless_omits_rank(tmp_path):
    script = tmp_path / "r.py"
    script.write_text("import os; print('HASRANK', 'RANK' in os.environ, flush=True)")
    proc = _run(script, "--nproc", "2", "--rankless", "--no-tag")
    assert proc.returncode == 0
    assert proc.stdout.count("HASRANK False") == 2


def test_run_fail_stop_propagates_exit_code(tmp_path):
    script = tmp_path / "f.py"
    script.write_text(textwrap.dedent("""
        import os, sys, time
        if os.environ["RANK"] == "1":
            sys.exit(7)
        time.sleep(60)  # would hang without fail-stop
    """))
    proc = _run(script, "--nproc", "3", timeout=60)
    assert proc.returncode == 7, proc.stdout + proc.stderr
    assert "terminating remaining ranks" in proc.stderr


def test_run_script_args_pass_through(tmp_path):
    script = tmp_path / "a.py"
    script.write_text("import sys; print('ARGS', *sys.argv[1:], flush=True)")
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.run", "--nproc", "1", "--no-tag",
         str(script), "--alpha", "beta"],
        capture_output=True, text=True, timeout=60, cwd=REPO)
    assert proc.returncode == 0
    assert "ARGS --alpha beta" in proc.stdout


def test_run_end_to_end_rankless_all_reduce(tmp_path):
    """The launcher's env contract into `comm.init_process_group`, RANK
    unset, so the launcher's store assigns the ranks; then an all-reduce:
    1 + 2 = 3 on both ranks."""
    script = tmp_path / "sum.py"
    script.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import torch
        from tpu_dist_torch import comm

        rank, world = comm.init_process_group(torch.device("cpu"))
        total = comm.all_reduce(torch.tensor([rank + 1.0]))
        print("SUM", float(total), "WORLD", world, flush=True)
        comm.destroy_process_group()
    """))
    proc = _run(script, "--nproc", "2", "--no-tag", "--rankless")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("SUM 3.0 WORLD 2") == 2, proc.stdout
