"""Fault drills over two replica groups of a trainer (``train_hsdp``,
``train_diloco`` or ``train_ddp``), driven by ``chip_smoke.py`` on the card
and by the CPU integration tests:

- :func:`kill_heal_drill`: against one lighthouse, one group is SIGKILLed
  mid-run, restarted, heals from the survivor, and both finish;
- :func:`preempt_all_drill`: a full-job preemption (the twin of the JAX
  package's ``tools/drills.py preempt-all``): every group is SIGTERMed at
  once and drains with a durable snapshot, then the whole job relaunches
  against a FRESH lighthouse and resumes from the snapshots.

A group is ``ranks_per_group`` processes (default 1), each launched with
the torchrun environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT`` for rank 0's Manager store) and the group's
own torch rendezvous (``GROUP_INIT_METHOD``, a file store fresh for each
launch of the group); a fault hits every rank of the group. Rank 0 logs to
``group<g>.log``, rank r to ``group<g>_rank<r>.log``."""

from __future__ import annotations

import json
import os
import re
import signal
import socket
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Group:
    """The ``ranks`` processes of one replica group, launched with the
    torchrun environment."""

    def __init__(
        self, trainer: str, group: int, trainer_args: Sequence[str],
        lighthouse: str, logs: Path, env: Optional[Dict[str, str]],
        ranks: int, launch: int,
    ) -> None:
        self.log = logs / f"group{group}.log"
        store = (logs / f"group{group}.launch{launch}.store").resolve()
        store.unlink(missing_ok=True)
        common = {
            **(env or {}),
            "WORLD_SIZE": str(ranks),
            "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(_free_port()),
            "GROUP_INIT_METHOD": f"file://{store}",
        }
        self.procs = [
            _spawn(
                trainer, group, trainer_args, lighthouse,
                self.log if r == 0 else logs / f"group{group}_rank{r}.log",
                {**common, "RANK": str(r), "LOCAL_RANK": str(r)},
            )
            for r in range(ranks)
        ]

    def poll(self) -> Optional[int]:
        """None while every rank runs, else the first exit code seen."""
        for proc in self.procs:
            if proc.poll() is not None:
                return proc.returncode
        return None

    def wait(self, timeout: float) -> int:
        """The group's exit code: 0 when every rank exits 0."""
        deadline = time.monotonic() + timeout
        rcs = [
            proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            for proc in self.procs
        ]
        return next((rc for rc in rcs if rc != 0), 0)

    def signal(self, sig: int) -> None:
        for proc in self.procs:
            os.kill(proc.pid, sig)

    def stop(self) -> None:
        for proc in self.procs:
            _stop(proc)


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def _lighthouse():
    from torchft_tpu_torch.coordination import LighthouseServer

    return LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=2,
        join_timeout_ms=30000,
        quorum_tick_ms=50,
        heartbeat_timeout_ms=5000,
    )


def _wait_for_mark(
    group: _Group, mark: str, deadline: float, what: str
) -> None:
    """Returns once the group's rank-0 log holds ``mark``; raises if a rank
    exits first or ``deadline`` passes."""
    while mark not in group.log.read_text(errors="replace"):
        rc = group.poll()
        if rc is not None:
            raise RuntimeError(
                f"group 1 exited ({rc}) before {what}; see {group.log}"
            )
        if time.monotonic() > deadline:
            raise TimeoutError(f"group 1 never reached {what}")
        time.sleep(0.05)


def _wait_all(
    groups: List[_Group], deadline: float, timeout_s: float
) -> List[int]:
    """Each group's exit code; raises if one outlasts ``deadline``."""
    rcs = []
    for g, group in enumerate(groups):
        left = max(deadline - time.monotonic(), 1.0)
        try:
            rcs.append(group.wait(left))
        except subprocess.TimeoutExpired:
            raise TimeoutError(f"group {g} did not finish in {timeout_s}s")
    return rcs


def _read_results(result_dir: str, ranks: int) -> Dict[int, Optional[dict]]:
    """{group: rank 0's result JSON}, None where it is missing; each result
    carries ``"ranks"``: every rank's, in order (rank 0's without
    ``"ranks"``)."""
    def read(name: str) -> Optional[dict]:
        try:
            with open(os.path.join(result_dir, f"{name}.json")) as f:
                return json.load(f)
        except OSError:
            return None

    results: Dict[int, Optional[dict]] = {}
    for g in range(2):
        first = read(f"group{g}")
        results[g] = first and {
            **first,
            "ranks": [first] + [
                read(f"group{g}_rank{r}") for r in range(1, ranks)
            ],
        }
    return results


def kill_heal_drill(
    trainer_args: Sequence[str],
    result_dir: str,
    log_dir: str,
    kill_after_step: int = 3,
    timeout_s: float = 600.0,
    env: Optional[Dict[str, str]] = None,
    trainer: str = "torchft_tpu_torch.train_hsdp",
    mark: str = "[group 1] step {n} loss",
    ranks_per_group: int = 1,
) -> Dict[int, dict]:
    """Runs groups 0 and 1 of ``python -m <trainer> <trainer_args>
    --min-replicas 2 --result-dir <result_dir>``; once group 1's log shows
    ``mark`` formatted with ``n=kill_after_step`` (its progress line for
    that step; ``train_diloco``'s is ``"outer_step={n} loss"`` and
    ``train_ddp``'s ``"[group 1] step={n} loss="``) it is SIGKILLed and
    restarted at once: every one of its ``ranks_per_group`` ranks (see the
    module docstring). Returns {group: rank 0's result JSON}, each with
    ``"ranks"`` (every rank's); raises
    if a group fails or the drill outlasts ``timeout_s``. Every process it
    starts is stopped before it returns."""
    result_dir = os.path.abspath(result_dir)  # the trainers run in the repo root
    logs = Path(log_dir)
    logs.mkdir(parents=True, exist_ok=True)
    args = [*trainer_args, "--min-replicas", "2", "--result-dir", result_dir]
    lighthouse = _lighthouse()
    groups: List[_Group] = []
    deadline = time.monotonic() + timeout_s

    def launch(g: int, n: int) -> _Group:
        return _Group(
            trainer, g, args, lighthouse.address(), logs, env,
            ranks_per_group, n,
        )

    try:
        groups = [launch(g, 0) for g in range(2)]
        _wait_for_mark(
            groups[1], mark.format(n=kill_after_step), deadline,
            f"step {kill_after_step}",
        )
        groups[1].stop()
        with open(groups[1].log, "a") as f:
            f.write(f"\n=== SIGKILLed after step {kill_after_step}; restart ===\n")
        groups[1] = launch(1, 1)
        for g, rc in enumerate(_wait_all(groups, deadline, timeout_s)):
            if rc != 0:
                raise RuntimeError(
                    f"group {g} exited {rc}; see {logs / f'group{g}.log'}"
                )
    finally:
        for group in groups:
            group.stop()
        lighthouse.shutdown()
    results = _read_results(result_dir, ranks_per_group)
    for g, r in results.items():
        if r is None:
            raise RuntimeError(f"group {g} wrote no result in {result_dir}")
    return results


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


# The progress line that marks a committed step in each trainer's log, and
# the result keys of its bitwise state and its final step.
_FAMILY = {
    "torchft_tpu_torch.train_hsdp": (
        "[group 1] step {n} loss", "param_sha256", "final_step",
    ),
    "torchft_tpu_torch.train_ddp": (
        "[group 1] step={n} loss=", "param_sha256", "final_step",
    ),
    "torchft_tpu_torch.train_diloco": (
        "outer_step={n} loss", "global_sha", "final_outer_step",
    ),
}


def preempt_all_drill(
    trainer: str,
    trainer_args: Sequence[str],
    result_dir: str,
    log_dir: str,
    term_after_step: int = 3,
    timeout_s: float = 600.0,
    env: Optional[Dict[str, str]] = None,
    ranks_per_group: int = 1,
) -> dict:
    """Full-job preemption: runs groups 0 and 1 of ``python -m <trainer>
    <trainer_args> --min-replicas 2 --result-dir ...`` (``trainer_args``
    must carry ``--durable-dir``); once group 1's log shows its progress
    line for ``term_after_step``, SIGTERMs BOTH groups (every rank). Each
    drains at its next step boundary with a final durable snapshot. Then
    the whole job relaunches from scratch, against a FRESH lighthouse (total
    control-plane loss): only the snapshots connect the two phases. Groups
    may snapshot one step apart; the behind group live-heals forward at
    the first quorum after the resume.

    Raises unless both groups drained, each relaunched group resumed from
    its drain-time snapshot ("resumed from durable step N" equal to the
    step it drained at) and both ended with the same bitwise state.
    Results land in ``result_dir/{drain,resume}``, logs in
    ``log_dir/{drain,resume}/group{g}.log``. Returns ``{"drained_steps",
    "resumed_from_steps", "final_steps", "drain": {group: result},
    "resume": {group: result}, "wall_s"}``. Every process it starts is
    stopped before it returns."""
    mark, sha_key, step_key = _FAMILY[trainer]
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    phases = {}
    for phase in ("drain", "resume"):
        phase_dir = os.path.abspath(os.path.join(result_dir, phase))
        logs = Path(log_dir) / phase
        logs.mkdir(parents=True, exist_ok=True)
        args = [*trainer_args, "--min-replicas", "2", "--result-dir", phase_dir]
        lighthouse = _lighthouse()
        groups: List[_Group] = []
        try:
            groups = [
                _Group(
                    trainer, g, args, lighthouse.address(), logs, env,
                    ranks_per_group, 0,
                )
                for g in range(2)
            ]
            if phase == "drain":
                _wait_for_mark(
                    groups[1], mark.format(n=term_after_step), deadline,
                    f"the kill window (step {term_after_step})",
                )
                for g, group in enumerate(groups):
                    _require(group.poll() is None, f"SIGTERM {g} failed")
                    group.signal(signal.SIGTERM)
            rcs = _wait_all(groups, deadline, timeout_s)
        finally:
            for group in groups:
                group.stop()
            lighthouse.shutdown()
        phases[phase] = (_read_results(phase_dir, ranks_per_group), rcs, logs)

    res1, rcs1, _ = phases["drain"]
    all_drained = all(r and r.get("drained") for r in res1.values())
    drained_steps = [(res1[g] or {}).get(step_key) for g in (0, 1)]
    _require(all_drained, f"not every group drained cleanly: {res1}")
    _require(rcs1 == [0, 0], "phase-1 drain did not exit cleanly everywhere")

    res2, rcs2, logs2 = phases["resume"]
    resumed = []
    for g in (0, 1):
        text = (logs2 / f"group{g}.log").read_text(errors="replace")
        m = re.search(r"resumed from durable step (\d+)", text)
        resumed.append(int(m.group(1)) if m else None)
    _require(rcs2 == [0, 0], "relaunched job did not finish cleanly")
    # Resume must come from the DRAIN-time snapshot, not merely any
    # periodic one: otherwise a broken save-on-drain path would still pass
    # (the relaunch would fall back to the last cadence snapshot and
    # converge bitwise anyway).
    _require(
        resumed == drained_steps,
        f"relaunch did not resume from the drain snapshots: "
        f"resumed={resumed} drained={drained_steps}",
    )
    sha = [(res2[g] or {}).get(sha_key) for g in (0, 1)]
    _require(
        sha[0] is not None and sha[0] == sha[1], "post-resume groups diverged"
    )
    return {
        "drained_steps": drained_steps,
        "resumed_from_steps": resumed,
        "final_steps": [res2[g][step_key] for g in (0, 1)],
        "drain": res1,
        "resume": res2,
        "wall_s": time.monotonic() - t0,
    }
