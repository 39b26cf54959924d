"""Kill-and-heal drill: two replica groups of a trainer (``train_hsdp``,
``train_diloco`` or ``train_ddp``) against one lighthouse; one group is
SIGKILLed mid-run, restarted, heals from the survivor, and both finish
(:func:`kill_heal_drill`; driven by ``chip_smoke.py`` on the card and by the
CPU integration tests)."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_REPO = Path(__file__).resolve().parent.parent


def _spawn(
    trainer: str, group: int, trainer_args: Sequence[str], lighthouse: str,
    log: Path, env: Optional[Dict[str, str]],
) -> subprocess.Popen:
    full_env = dict(os.environ)
    full_env.update(env or {})
    full_env.update(
        TORCHFT_LIGHTHOUSE=lighthouse,
        REPLICA_GROUP_ID=str(group),
        PYTHONPATH=os.pathsep.join(
            p for p in (str(_REPO), full_env.get("PYTHONPATH", "")) if p
        ),
    )
    with open(log, "a") as out:
        return subprocess.Popen(
            [sys.executable, "-m", trainer, *trainer_args],
            cwd=str(_REPO),
            env=full_env,
            stdout=out,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def kill_heal_drill(
    trainer_args: Sequence[str],
    result_dir: str,
    log_dir: str,
    kill_after_step: int = 3,
    timeout_s: float = 600.0,
    env: Optional[Dict[str, str]] = None,
    trainer: str = "torchft_tpu_torch.train_hsdp",
    mark: str = "[group 1] step {n} loss",
) -> Dict[int, dict]:
    """Runs groups 0 and 1 of ``python -m <trainer> <trainer_args>
    --min-replicas 2 --result-dir <result_dir>``; once group 1's log shows
    ``mark`` formatted with ``n=kill_after_step`` (its progress line for
    that step; ``train_diloco``'s is ``"outer_step={n} loss"`` and
    ``train_ddp``'s ``"[group 1] step={n} loss="``) it is SIGKILLed and
    restarted at once. Returns {group: result JSON}; raises
    if a group fails or the drill outlasts ``timeout_s``. Every process it
    starts is stopped before it returns."""
    from torchft_tpu_torch.coordination import LighthouseServer

    result_dir = os.path.abspath(result_dir)  # the trainers run in the repo root
    logs = Path(log_dir)
    logs.mkdir(parents=True, exist_ok=True)
    args = [*trainer_args, "--min-replicas", "2", "--result-dir", result_dir]
    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=2,
        join_timeout_ms=30000,
        quorum_tick_ms=50,
        heartbeat_timeout_ms=5000,
    )
    procs: List[subprocess.Popen] = []
    deadline = time.monotonic() + timeout_s
    try:
        for g in range(2):
            procs.append(
                _spawn(
                    trainer, g, args, lighthouse.address(),
                    logs / f"group{g}.log", env,
                )
            )
        mark = mark.format(n=kill_after_step)
        victim_log = logs / "group1.log"
        while mark not in victim_log.read_text(errors="replace"):
            if procs[1].poll() is not None:
                raise RuntimeError(
                    f"group 1 exited ({procs[1].returncode}) before step "
                    f"{kill_after_step}; see {victim_log}"
                )
            if time.monotonic() > deadline:
                raise TimeoutError(f"group 1 never reached step {kill_after_step}")
            time.sleep(0.05)
        _stop(procs[1])
        with open(victim_log, "a") as f:
            f.write(f"\n=== SIGKILLed after step {kill_after_step}; restart ===\n")
        procs[1] = _spawn(trainer, 1, args, lighthouse.address(), victim_log, env)
        for g, proc in enumerate(procs):
            left = max(deadline - time.monotonic(), 1.0)
            try:
                rc = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"group {g} did not finish in {timeout_s}s")
            if rc != 0:
                raise RuntimeError(
                    f"group {g} exited {rc}; see {logs / f'group{g}.log'}"
                )
    finally:
        for proc in procs:
            _stop(proc)
        lighthouse.shutdown()
    results = {}
    for g in range(2):
        with open(os.path.join(result_dir, f"group{g}.json")) as f:
            results[g] = json.load(f)
    return results
