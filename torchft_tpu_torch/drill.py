"""Fault drills over two replica groups of a trainer (``train_hsdp``,
``train_diloco`` or ``train_ddp``), driven by ``chip_smoke.py`` on the card
and by the CPU integration tests:

- :func:`kill_heal_drill`: against one lighthouse, one group is SIGKILLed
  mid-run, restarted, heals from the survivor, and both finish;
- :func:`preempt_all_drill`: a full-job preemption (the twin of the JAX
  package's ``tools/drills.py preempt-all``): every group is SIGTERMed at
  once and drains with a durable snapshot, then the whole job relaunches
  against a FRESH lighthouse and resumes from the snapshots;
- :func:`runner_kill_heal_drill`: the kill/heal drill with the groups
  launched by ``orchestration.render_topology`` and kept alive by
  ``orchestration.ReplicaGroupRunner``: the kill goes through the
  lighthouse, and the runner, not the drill, relaunches the victim;
  :func:`kill_episode` reads the kill's recovery episode off the groups'
  journals, and :func:`fault_planes` the drill's stripe failovers, goodput
  ledger and fleet digests.

A group is ``ranks_per_group`` processes (default 1), each launched with
the torchrun environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and
above one rank ``MASTER_ADDR``/``MASTER_PORT`` for rank 0's Manager store)
and the group's own torch rendezvous (``GROUP_INIT_METHOD``, a file store
fresh for each launch of the group); a fault hits every rank of the group. Rank 0 logs to
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
import urllib.request
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
            "GROUP_INIT_METHOD": f"file://{store}",
        }
        if ranks > 1:
            # The other ranks find rank 0's Manager store here. A group of
            # one rank lets its Manager bind any free port: a port picked
            # now can be taken by another process before the trainer binds it.
            common.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
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


def _lighthouse_replica_id(address: str, group: int) -> str:
    """The id under which group ``group``'s manager is registered at the
    lighthouse (``<group>:<uuid>``), from its ``/status.json``."""
    with urllib.request.urlopen(f"http://{address}/status.json", timeout=5) as r:
        ids = json.loads(r.read())["heartbeat_ages_ms"]
    found = [i for i in ids if i.startswith(f"{group}:")]
    if len(found) != 1:
        raise RuntimeError(f"group {group} ids at the lighthouse: {sorted(ids)}")
    return found[0]


# Seconds a trainer may outlive its manager server before the runner kills it.
_LIGHTHOUSE_KILL_GRACE_S = 2.0
# Seconds between two reads of the lighthouse's fleet view during the drill.
_FLEET_POLL_S = 0.25

# The fault planes' drill environment (``fault_planes``): four stripes a
# peer link, of a class without the int8 wire (which would move the bits),
# and a seeded reset of every stripe-1 leg of both groups in the last step
# (7), after the victim's heal; the engine hands each leg's range to a
# live stripe inside the collective. Both ends reset their own legs: a
# reset that only one end injects can abort a collective (ROADMAP.md
# section 3).
STRIPED_LINKS = "*=local,streams=4"
STRIPE_RESET = "seed:7,spec:reset@data:match=|s1:step=7-7"
FAULT_PLANES_ENV = {
    "TORCHFT_PG": "native",
    "TORCHFT_LINKS": STRIPED_LINKS,
    "TORCHFT_CHAOS": STRIPE_RESET,
    # A digest at every commit gate, so that the fleet samples see each
    # group's step rate however short its run.
    "TORCHFT_DIGEST_INTERVAL_S": "0",
}


def runner_kill_heal_drill(
    trainer_args: Sequence[str], result_dir: str, log_dir: str,
    env: Optional[Dict[str, str]] = None,
) -> dict:
    """Groups 0 and 1 of ``python -m torchft_tpu_torch.train_hsdp
    <trainer_args> --min-replicas 2 --result-dir <result_dir>``, one rank
    each, rendered by ``render_topology`` (each with its journal in
    ``log_dir/journal``, and ``env`` in its environment: for example
    ``TORCHFT_PG=native``) and supervised by a ``ReplicaGroupRunner`` (logs
    ``log_dir/replica<g>_rank0.r<restart>.log``). Once group 1's log shows
    its step 3, its manager is killed through the lighthouse
    (``kill_via_lighthouse``). That ends the manager server, a process of
    its own here (in the reference it lives in the trainer, whose exit it
    forces), and the trainer may outlive it: if the trainer still runs
    after ``_LIGHTHOUSE_KILL_GRACE_S``, ``runner.kill_group(1)`` SIGKILLs
    it. The runner relaunches it; it heals from group 0 and both finish.

    The runner's own journal (``log_dir/journal/runner.jsonl``) records
    each death it sees as a ``failure_signal`` with source ``proc_death``.
    While the groups run, the lighthouse's fleet view is read every
    ``_FLEET_POLL_S``; ``fleet`` keeps each group's newest row whose digest
    has a step rate above 0, else its newest row with a digest (the
    lighthouse drops a row when its replica leaves), with its
    ``replica_id``.
    Returns ``{"results": {group: result JSON}, "restarts", "kill"
    ("lighthouse" or "runner": what ended the trainer), "kill_to_relaunch_s",
    "kill_ts" (the wall clock at the lighthouse kill, the journals'
    clock), "wall_s", "restart_log", "proc_deaths", "journal_dir",
    "fleet" ({group: fleet row})}``; raises if a group fails or
    the drill outlasts 400 s. Every process it starts is stopped before it
    returns."""
    import threading

    from torchft_tpu_torch.coordination import LighthouseClient
    from torchft_tpu_torch.orchestration import (
        ReplicaGroupRunner,
        kill_via_lighthouse,
        render_topology,
    )
    from torchft_tpu_torch.telemetry import reset_event_log

    result_dir = os.path.abspath(result_dir)
    logs = Path(log_dir).resolve()
    journal = logs / "journal"
    journal.mkdir(parents=True, exist_ok=True)
    runner_journal = journal / "runner.jsonl"
    runner_journal.unlink(missing_ok=True)
    lighthouse = _lighthouse()
    specs = render_topology(
        [sys.executable, "-m", "torchft_tpu_torch.train_hsdp", *trainer_args,
         "--min-replicas", "2", "--result-dir", result_dir],
        num_replica_groups=2,
        lighthouse_addr=lighthouse.address(),
        env={
            **(env or {}),
            "PYTHONPATH": os.pathsep.join(
                p for p in (str(_REPO), os.environ.get("PYTHONPATH", "")) if p
            ),
        },
        journal_dir=str(journal),
    )
    runner = ReplicaGroupRunner(
        specs, max_restarts=2, poll_interval=0.1, log_dir=str(logs)
    )
    saved = os.environ.get("TORCHFT_JOURNAL_FILE")
    os.environ["TORCHFT_JOURNAL_FILE"] = str(runner_journal)
    fleet: Dict[int, dict] = {}
    stop_sampling = threading.Event()

    def sample_fleet() -> None:
        client = LighthouseClient(lighthouse.address())
        try:
            while not stop_sampling.wait(_FLEET_POLL_S):
                try:
                    rows = client.fleet(timeout=5.0)["replicas"]
                except Exception:  # noqa: BLE001 - the next poll retries
                    continue
                for rid, row in rows.items():
                    slot = rid.split(":", 1)[0]
                    rate = (row.get("digest") or {}).get("rate") or 0
                    kept = (fleet.get(int(slot), {}).get("digest") or {}).get("rate") or 0
                    if row.get("digest") and slot.isdigit() and (rate > 0 or not kept):
                        fleet[int(slot)] = {**row, "replica_id": rid}
        finally:
            client.close()

    sampler = threading.Thread(target=sample_fleet, name="fleet-sampler", daemon=True)
    t0 = time.monotonic()
    deadline = t0 + 400.0
    try:
        runner.start()
        sampler.start()
        first_log = logs / "replica1_rank0.r0.log"
        while "[group 1] step 3 loss" not in (
            first_log.read_text(errors="replace") if first_log.exists() else ""
        ):
            runner.monitor_once()
            if sum(runner.restarts.values()) or len(runner.live_pids()) < 2:
                raise RuntimeError(f"a group exited before step 3; see {logs}")
            if time.monotonic() > deadline:
                raise TimeoutError("group 1 never reached step 3")
            time.sleep(0.05)
        victim = runner.live_pids()[1]
        t_kill = time.monotonic()
        kill_ts = time.time()
        if not kill_via_lighthouse(
            lighthouse.address(), _lighthouse_replica_id(lighthouse.address(), 1)
        ):
            raise RuntimeError("the lighthouse refused the kill")
        method = "lighthouse"
        while runner.live_pids().get(1) == victim:
            if time.monotonic() - t_kill > _LIGHTHOUSE_KILL_GRACE_S:
                runner.kill_group(1)
                method = "runner"
                break
            time.sleep(0.05)
        while runner.restarts[1] == 0:
            runner.monitor_once()
            if time.monotonic() > deadline:
                raise TimeoutError("the runner never relaunched group 1")
            time.sleep(0.02)
        relaunch_s = time.monotonic() - t_kill
        if not runner.run_until_done(max(deadline - time.monotonic(), 1.0)):
            raise RuntimeError(
                f"the runner did not finish cleanly (restarts "
                f"{runner.restarts}); see {logs}"
            )
    finally:
        stop_sampling.set()
        if sampler.is_alive():
            sampler.join(10)
        runner.stop()
        lighthouse.shutdown()
        if saved is None:
            os.environ.pop("TORCHFT_JOURNAL_FILE", None)
        else:
            os.environ["TORCHFT_JOURNAL_FILE"] = saved
        reset_event_log()
    results = _read_results(result_dir, 1)
    for g, r in results.items():
        if r is None:
            raise RuntimeError(f"group {g} wrote no result in {result_dir}")
    events = [json.loads(line) for line in runner_journal.read_text().splitlines()]
    return {
        "results": results,
        "restarts": runner.restarts,
        "kill": method,
        "kill_to_relaunch_s": relaunch_s,
        "kill_ts": kill_ts,
        "wall_s": time.monotonic() - t0,
        "restart_log": str(logs / "replica1_rank0.r1.log"),
        "proc_deaths": [
            e["attrs"] for e in events
            if e["event"] == "failure_signal"
            and e["attrs"].get("source") == "proc_death"
        ],
        "journal_dir": str(journal),
        "fleet": dict(fleet),
    }


def kill_episode(journal_dir: str, group: int) -> dict:
    """The recovery episode of a drill's kill, by ``telemetry.detect_episodes``
    over the groups' journals in ``journal_dir`` (``journal_replica*``).
    The groups' first quorum heals at step 0, an episode of its own; the
    kill's is the one after it. Raises unless exactly one episode has a
    step above 0, it is closed, ``group`` is its primary, and
    ``telemetry.check_episodes`` finds its phases tile its time to
    recover."""
    from torchft_tpu_torch import telemetry

    events = telemetry.load_journal(
        sorted(str(f) for f in Path(journal_dir).glob("journal_replica*.jsonl"))
    )
    episodes = [
        e for e in telemetry.detect_episodes(events) if (e["max_step"] or 0) > 0
    ]
    if len(episodes) != 1:
        raise RuntimeError(
            f"{len(episodes)} episodes after step 0 in {journal_dir}: "
            f"{[(e['id'], e['primary'], e['max_step']) for e in episodes]}"
        )
    (episode,) = episodes
    if episode["open"] or episode["primary"] != str(group):
        raise RuntimeError(
            f"episode {episode['id']}: primary {episode['primary']}, open "
            f"{episode['open']}; want group {group}, closed"
        )
    errors = telemetry.check_episodes(episodes)
    if errors:
        raise RuntimeError(f"episode {episode['id']} fails its check: {errors}")
    return episode


def fault_planes(out: dict, victim: int = 1) -> dict:
    """The fault-tolerance planes of a :func:`runner_kill_heal_drill` run
    (``out``) over ``TORCHFT_PG=native`` with a striped ``TORCHFT_LINKS``
    and a seeded stripe reset in ``TORCHFT_CHAOS``, read off its journals
    and its fleet samples:

    - ``failovers``: the ``stripe_failover`` rows each group journaled,
      with the steps (``s<step>`` of their trace) at which they happened;
    - ``goodput``: each group's goodput ledger, ``telemetry.audit_goodput``
      of its ``goodput_window`` events;
    - ``fleet``: each group's newest digest at the lighthouse.

    Raises ``AssertionError`` unless both groups journaled a handoff to a
    live stripe (``to_stripe`` >= 0) in one collective, that step committed
    in both groups, each group's ledger tiles its accounted wall (no audit
    problem, every kind in ``BADPUT_KINDS``), ``victim`` shows two
    incarnations with ``down`` and ``heal`` seconds above 0, and the fleet
    holds a digest of each group with a step rate above 0."""
    from torchft_tpu_torch import telemetry

    events = telemetry.load_journal(
        sorted(str(f) for f in Path(out["journal_dir"]).glob("journal_replica*.jsonl"))
    )

    def slot(ev):
        return str(ev.get("replica_id", "")).split(":", 1)[0]

    failovers: Dict[str, List[dict]] = {}
    commits: Dict[str, set] = {}
    for ev in events:
        if ev["event"] == "stripe_failover":
            step = re.search(r"\.s(\d+)", ev.get("trace") or "")
            failovers.setdefault(slot(ev), []).append(
                {**ev["attrs"], "step": int(step.group(1)) if step else None}
            )
        elif ev["event"] == "commit_gate" and (ev.get("attrs") or {}).get("committed"):
            commits.setdefault(slot(ev), set()).add(ev.get("step"))
    handed = {
        g: {f["step"] for f in rows if f.get("to_stripe", -1) >= 0}
        for g, rows in failovers.items()
    }
    both = sorted(set.intersection(*(handed.get(str(g), set()) for g in (0, 1))))
    if not both:
        raise AssertionError(
            f"stripe_failover: no step with a handoff journaled by both groups ({handed})"
        )
    for step in both:
        for g in ("0", "1"):
            if step not in commits.get(g, set()):
                raise AssertionError(f"stripe_failover at step {step}: group {g} did "
                                     "not commit that step")
    # The audit's problems include every kind outside BADPUT_KINDS and every
    # window or incarnation that does not tile.
    rows, problems = telemetry.audit_goodput(events)
    if problems or sorted(rows) != ["0", "1"]:
        raise AssertionError(f"goodput ledger: groups {sorted(rows)}, problems {problems}")
    hit = rows[str(victim)]
    if hit["incarnations"] != 2 or not (hit["badput_s"]["down"] > 0
                                       and hit["badput_s"]["heal"] > 0):
        raise AssertionError(f"goodput ledger: group {victim} {hit}")
    fleet = {g: row["digest"] for g, row in out["fleet"].items()}
    if sorted(fleet) != [0, 1] or not all(d.get("rate", 0) > 0 for d in fleet.values()):
        raise AssertionError(f"fleet digests at the lighthouse: {fleet}")
    return {"failovers": failovers, "failover_steps": both, "goodput": rows,
            "fleet": fleet}
