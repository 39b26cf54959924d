"""Reproducible OS-process departure drills of the port: the twin of the JAX
package's ``tools/drills.py``, over the port's trainers.

Each drill launches real trainer processes (``python -m
torchft_tpu_torch.train_ddp|train_diloco|train_hsdp``) under
``orchestration.ReplicaGroupRunner`` against an in-process lighthouse,
injects the departure, and prints ONE JSON line with the outcome (the JAX
drill's report, key for key)::

    python -m torchft_tpu_torch.drills soak          # SIGKILLs, DDP int4+EF wire
    python -m torchft_tpu_torch.drills elastic-up    # third group joins mid-run
    python -m torchft_tpu_torch.drills elastic-down  # 3->2 permanent departure
    python -m torchft_tpu_torch.drills drain         # SIGTERM graceful drain vs
                                                     # SIGKILL survivor-stall control
    python -m torchft_tpu_torch.drills preempt-all   # every group drains; the
                                                     # relaunch resumes from
                                                     # durable snapshots
    python -m torchft_tpu_torch.drills heal-storm    # SIGKILLs aimed at the heal
                                                     # machinery (join + transfer)
    python -m torchft_tpu_torch.drills spare-failover  # hot spare promotes, no heal
    python -m torchft_tpu_torch.drills model-heal --model moe|pipeline|ulysses

Every drill takes ``--device`` (default ``cuda``; ``cpu`` runs the
trainers on the CPU). ``--device cuda`` without a card raises before any
process starts. The report's verdicts are held by :func:`check_report`; a
drill that fails (a check, or a kill that could not land in its intended
phase) still prints its report, then its reasons on stderr, and exits 1.

Each drill works in a fresh temporary directory (``results/``,
``logs/replica<g>_rank0.r<incarnation>.log``, ``journal/``). The trainers
do the tensor work; this module imports torch only to ask whether a card is
visible (``require_device``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import signal
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from torchft_tpu_torch.drill import _lighthouse, preempt_all_drill
from torchft_tpu_torch.orchestration import ReplicaGroupRunner, render_topology

_REPO = Path(__file__).resolve().parent.parent

# The JAX drills' DDP wire (cnn, int4 with error feedback, batch 8), and the
# trainer every DDP drill runs.
DDP_TRAINER = "torchft_tpu_torch.train_ddp"
CNN_INT4_EF = [
    "--model", "cnn", "--batch-size", "8",
    "--quantize", "--quantize-bits", "4", "--error-feedback",
]
# The survivor's largest inter-step gap after a departure must stay under
# this (``tools/drills.py:420-426``): step speed, not a heartbeat or socket
# timeout.
STALL_LIMIT_S = 3.5
# The spare drill's pinned effective world size (one hot spare beside it).
FIXED = 2
STORM_PHASES = ["reconfiguring pg", "healing from"]


class DrillFailed(Exception):
    """A drill that ran to its report but failed: ``report`` (the JAX
    drill's keys) and ``reasons``."""

    def __init__(self, report: dict, reasons: Sequence[str]) -> None:
        super().__init__("; ".join(reasons))
        self.report = report
        self.reasons = list(reasons)


class _Landing(Exception):
    """A departure that could not land where the drill aims it."""


def _land(ok, msg: str) -> None:
    if not ok:
        raise _Landing(msg)


def require_device(device: str) -> None:
    """Raises unless ``device`` can run the trainers: a CUDA device needs a
    visible card (checked here, before any process starts, as the trainers
    would at their start)."""
    if device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {device}: no CUDA device is visible; pass --device cpu"
            )


def _workdir(args, prefix: str) -> str:
    root = getattr(args, "workdir", None)
    if root:
        os.makedirs(root, exist_ok=True)
    return tempfile.mkdtemp(prefix=prefix, dir=root)


def _specs(
    trainer: str, trainer_args, n_groups: int, lighthouse, device: str,
    extra_env=None, result_dir=None, journal_dir=None,
):
    env = {
        "PYTHONUNBUFFERED": "1",  # step-mark detection reads live logs
        "TORCHFT_QUORUM_TIMEOUT_SEC": "120",
        "PYTHONPATH": os.pathsep.join(
            p for p in (str(_REPO), os.environ.get("PYTHONPATH", "")) if p
        ),
    }
    env.update(extra_env or {})
    full = [sys.executable, "-m", trainer, *trainer_args, "--device", device]
    if result_dir:
        full += ["--result-dir", result_dir]
        # Every drill run journals: a drill IS a fault-injection
        # experiment, and the per-replica journals are what the port's
        # obs_report turns into the step/heal timeline afterwards.
        if journal_dir is None:
            journal_dir = os.path.join(os.path.dirname(result_dir), "journal")
    if journal_dir:
        os.makedirs(journal_dir, exist_ok=True)
    return render_topology(
        full,
        num_replica_groups=n_groups,
        lighthouse_addr=lighthouse.address(),
        env=env,
        journal_dir=journal_dir,
    )


def _ddp_args(args, steps: int, min_replicas: int = 2, wire=None) -> List[str]:
    """``train_ddp``'s arguments: ``args.ddp_args`` (a model and wire in
    place of the JAX drills' cnn on the int4+EF wire, e.g. ResNet-50 on
    the card) or ``wire``, then the steps and ``--min-replicas``."""
    model = getattr(args, "ddp_args", None) or wire or CNN_INT4_EF
    return [*model, "--steps", str(steps), "--min-replicas", str(min_replicas)]


def _log(log_dir, group: int, incarnation: int) -> str:
    return os.path.join(log_dir, f"replica{group}_rank0.r{incarnation}.log")


def _read(path: str) -> str:
    try:
        return open(path, errors="replace").read()
    except OSError:
        return ""


def _wait_log_marker(
    runner, log_dir, group, incarnation, markers, deadline_s,
    poll_s: float = 1.0,
):
    """Polls one incarnation's log for any of ``markers``; pumps the
    runner so relaunches happen between kills. Returns the marker found,
    or None on deadline: never a silent fallback, a drill that couldn't
    land its kill in the intended phase must FAIL, not quietly degrade into
    a different drill."""
    deadline = time.time() + deadline_s
    path = _log(log_dir, group, incarnation)
    while time.time() < deadline:
        runner.monitor_once()
        text = _read(path)
        for m in markers:
            if m in text:
                return m
        time.sleep(poll_s)
    return None


# Seconds between two reads of a log for a step mark. The JAX drills poll
# once a second; the port's cnn steps take 5-20 ms, so a kill a second late
# lands tens of steps past its mark, or after the run ended.
STEP_POLL_S = 0.1


def _wait_step_mark(runner, log_dir, group, incarnation, marks, deadline_s):
    """Whether the incarnation's manager logged one of the steps ``marks``
    (its ``[<replica>/<rank> - step N]`` prefix)."""
    return (
        _wait_log_marker(
            runner, log_dir, group, incarnation,
            [f"- step {s}]" for s in marks], deadline_s, poll_s=STEP_POLL_S,
        )
        is not None
    )


def _read_results(result_dir, groups) -> Dict[int, Optional[dict]]:
    """Per-group result dicts, None where a group never wrote one: a failed
    drill must still emit its report, not a traceback masking the
    failure."""
    out = {}
    for g in groups:
        try:
            with open(os.path.join(result_dir, f"group{g}.json")) as f:
                out[g] = json.load(f)
        except (OSError, ValueError):
            out[g] = None
    return out


def _sha(res):
    return res.get("param_sha256") if res else None


def _step(res):
    return res.get("final_step") if res else None


# Groups in lockstep finish within a step of each other: one still running
# this long after a peer finished cleanly can never form a quorum again.
STRANDED_S = 60.0


def _supervise(runners, timeout: float, stranded_s: float = STRANDED_S) -> bool:
    """Supervises ``runners`` (their restart budgets stay live) until every
    group exited cleanly (True), or the deadline passes, a group exhausts
    its restarts, or a group is left running ``stranded_s`` after another
    exited cleanly (False): a relaunch that came after its peers finished
    fails the drill at once instead of retrying its quorum to the
    deadline."""
    deadline = time.monotonic() + timeout
    first_clean = None
    while time.monotonic() < deadline:
        running = [r.monitor_once() for r in runners]
        clean = [r.clean_exit(i) for r in runners for i in range(len(r.restarts))]
        if all(clean):
            return True
        if not any(running):
            return False
        if any(clean) and first_clean is None:
            first_clean = time.monotonic()
        if first_clean is not None and time.monotonic() - first_clean > stranded_s:
            return False
        time.sleep(0.5)
    return False


def _shutdown(runners, lighthouse) -> None:
    for runner in runners:
        runner.stop()
    lighthouse.shutdown()


def drill_soak(args) -> tuple:
    """N SIGKILLs of one of two DDP groups on the int4+EF wire; every
    relaunch heals from the survivor; both finish bitwise-identical."""
    steps, kills = args.steps, args.kills
    marks = [int(steps * (k + 0.6) / (kills + 1)) for k in range(kills)]
    workdir = _workdir(args, "drill_soak_")
    result_dir, log_dir = workdir + "/results", workdir + "/logs"
    lighthouse = _lighthouse()
    runner = ReplicaGroupRunner(
        _specs(DDP_TRAINER, _ddp_args(args, steps), 2, lighthouse, args.device,
               result_dir=result_dir),
        max_restarts=kills * 2,
        log_dir=log_dir,
    )
    t0 = time.time()
    errors: List[str] = []
    ok = False
    done_kills = 0
    runner.start()
    try:
        for k in range(kills):
            window = range(marks[k], marks[k] + 6)
            _land(_wait_step_mark(runner, log_dir, 1, done_kills, window, 600),
                  f"group 1 never reached step {marks[k]}")
            _land(runner.kill_group(1), "kill failed")
            done_kills += 1
        ok = _supervise([runner], 900)
    except _Landing as e:
        errors.append(str(e))
    finally:
        _shutdown([runner], lighthouse)
    res = _read_results(result_dir, (0, 1))
    return {
        "drill": "soak",
        "kills": done_kills,
        "clean_finish": bool(ok),
        "restarts": dict(runner.restarts),
        "final_steps": [_step(res[0]), _step(res[1])],
        "bitwise_equal": _sha(res[0]) is not None and _sha(res[0]) == _sha(res[1]),
        "wall_s": round(time.time() - t0, 1),
        # Feed to `python -m torchft_tpu_torch.obs_report <journal_dir>` for
        # the step-aligned heal timeline of this run.
        "journal_dir": workdir + "/journal",
    }, errors


def joiner_heal_step(log_dir, group: int = 2) -> Optional[int]:
    """The step of the group's first "healing from replica_rank=R at step
    N" line, over all its incarnations (a joiner whose first launch died
    heals in a relaunch)."""
    for path in sorted(glob.glob(os.path.join(log_dir, f"replica{group}_rank0.r*.log"))):
        heals = re.findall(r"healing from replica_rank=\d+ at step (\d+)", _read(path))
        if heals:
            return int(heals[0])
    return None


def drill_elastic_up(args) -> tuple:
    """Two groups train; a third joins mid-run, heals the live state, and
    all three finish bitwise-identical. UNPACED: the step count is sized so
    that a full-speed run outlives the joiner's start (imports, the card,
    one warm step before it registers); ``joiner_heal_step`` in (0, steps)
    proves from the report that the join landed mid-run."""
    steps = args.steps
    workdir = _workdir(args, "drill_up_")
    result_dir, log_dir = workdir + "/results", workdir + "/logs"
    lighthouse = _lighthouse()
    specs = _specs(DDP_TRAINER, _ddp_args(args, steps), 3, lighthouse, args.device,
                   result_dir=result_dir)
    runner = ReplicaGroupRunner(specs[:2], max_restarts=3, log_dir=log_dir)
    late = ReplicaGroupRunner(specs[2:], max_restarts=3, log_dir=log_dir)
    t0 = time.time()
    errors: List[str] = []
    ok = False
    runner.start()
    try:
        _land(_wait_step_mark(runner, log_dir, 0, 0, range(5, 12), 600),
              "first groups never reached step 5")
        late.start()
        # One supervision loop: both runners' monitors (and so the
        # joiner's restart budget) stay live until both finish.
        ok = _supervise([runner, late], 900)
    except _Landing as e:
        errors.append(str(e))
    finally:
        _shutdown([runner, late], lighthouse)
    res = _read_results(result_dir, (0, 1, 2))
    shas = [_sha(res[g]) for g in range(3)]
    heal_step = joiner_heal_step(log_dir)
    return {
        "drill": "elastic-up",
        "clean_finish": bool(ok),
        "final_steps": [_step(res[g]) for g in range(3)],
        "bitwise_equal_all3": None not in shas and len(set(shas)) == 1,
        "joiner_heal_step": heal_step,
        "joined_mid_run": heal_step is not None and 0 < heal_step < steps,
        "unpaced": True,
        "wall_s": round(time.time() - t0, 1),
    }, errors


def step_times(log_path) -> list:
    """(step, unix time) pairs from a trainer log's ``step=N ... t=T``
    lines (``train_ddp`` stamps each step line for this)."""
    return [
        (int(m.group(1)), float(m.group(2)))
        for m in re.finditer(r"step=(\d+) .*?t=([0-9.]+)", _read(log_path))
    ]


def stall_after(times, t_signal, window_s: float = 45.0) -> tuple:
    """The largest inter-step gap a survivor saw in the window after the
    signal landed (the departure stall), and its pre-signal median step
    time."""
    ts = [t for (_, t) in times]
    before = [b - a for a, b in zip(ts, ts[1:]) if b < t_signal]
    gaps = [
        b - a
        for a, b in zip(ts, ts[1:])
        if b >= t_signal - 0.5 and a <= t_signal + window_s
    ]
    median_before = sorted(before)[len(before) // 2] if before else None
    return (max(gaps) if gaps else None), median_before


def drain_logged(victim_log: str) -> bool:
    return "draining at step" in victim_log and "left the quorum" in victim_log


def drill_drain(args) -> tuple:
    """Graceful drain against a SIGKILL departure, measured from the
    survivors' own step cadence: two 3-group runs (min_replicas 2, no
    restarts); group 2 leaves mid-run, with SIGTERM (``train_ddp`` drains:
    finishes the step, ``manager.leave()``, exit 0) and then with SIGKILL
    (the control). Both must cost the survivors about one step
    (``STALL_LIMIT_S``): the leave removes the drained member at tick
    speed, and a killed one is removed by the manager server's parent-death
    watchdog, with the survivors' collectives failing fast on the dead
    peer."""
    steps = args.steps
    errors: List[str] = []

    def leg(sig_name):
        sig = signal.SIGTERM if sig_name == "drain" else signal.SIGKILL
        workdir = _workdir(args, f"drill_drain_{sig_name}_")
        result_dir, log_dir = workdir + "/results", workdir + "/logs"
        lighthouse = _lighthouse()
        runner = ReplicaGroupRunner(
            _specs(DDP_TRAINER,
                   _ddp_args(args, steps, wire=["--model", "cnn", "--batch-size", "512"]),
                   3, lighthouse, args.device, result_dir=result_dir),
            max_restarts=0,
            log_dir=log_dir,
        )
        t0 = time.time()
        t_signal = None
        runner.start()
        try:
            _land(_wait_step_mark(runner, log_dir, 2, 0, range(12, 20), 600),
                  f"{sig_name}: group 2 never reached step 12")
            t_signal = time.time()
            _land(runner.kill_group(2, sig), f"{sig_name}: signal failed")
            runner.run_until_done(timeout=900)
        except _Landing as e:
            errors.append(str(e))
        finally:
            _shutdown([runner], lighthouse)
        res = _read_results(result_dir, (0, 1, 2))
        stall_s = step_s = None
        if t_signal is not None:
            stall_s, step_s = stall_after(step_times(_log(log_dir, 0, 0)), t_signal)
        return {
            "survivor_final_steps": [_step(res[0]), _step(res[1])],
            "bitwise_equal_survivors": _sha(res[0]) is not None
            and _sha(res[0]) == _sha(res[1]),
            "victim_exit_clean": runner.clean_exit(2),
            "victim_drain_logged": drain_logged(_read(_log(log_dir, 2, 0))),
            "survivor_stall_s": round(stall_s, 2) if stall_s else None,
            "survivor_step_s_median": round(step_s, 2) if step_s else None,
            "wall_s": round(time.time() - t0, 1),
        }

    drain = leg("drain")
    kill = leg("sigkill")
    return {
        "drill": "drain",
        "graceful_drain": drain,
        "sigkill_control": kill,
    }, errors


# The JAX drill's families (``tools/drills.py:452-489``): the trainer, its
# arguments, and the step after which the groups are told to drain (the
# first of the JAX drill's kill window).
PREEMPT_FAMILIES = {
    "ddp": (DDP_TRAINER, ["--model", "cnn", "--batch-size", "512",
                          "--durable-every", "10"], 12),
    "diloco": ("torchft_tpu_torch.train_diloco",
               ["--sync-every", "4", "--n-fragments", "2",
                "--fragment-sync-delay", "1", "--durable-every", "2"], 3),
    "hsdp": ("torchft_tpu_torch.train_hsdp",
             ["--model", "debug", "--durable-every", "5"], 4),
}


def drill_preempt_all(args) -> tuple:
    """Full-job preemption (``drill.preempt_all_drill``): every group is
    told to drain at once, by SIGTERM or (``--via operator``) by ONE
    lighthouse ``drain_all``; each drains with a final durable snapshot;
    the whole job relaunches against a fresh lighthouse and must resume
    from the drain-time snapshots and finish bitwise-identical. ``--family``
    picks the trainer: ddp, diloco (outer steps) or hsdp."""
    trainer, family_args, term_after = PREEMPT_FAMILIES[args.family]
    steps_flag = "--outer-steps" if args.family == "diloco" else "--steps"
    workdir = _workdir(args, "drill_preempt_")
    t0 = time.time()
    errors: List[str] = []
    out: dict = {}
    try:
        out = preempt_all_drill(
            trainer,
            [*family_args, steps_flag, str(args.steps),
             "--durable-dir", workdir + "/durable", "--device", args.device],
            workdir + "/results",
            workdir + "/logs",
            term_after_step=term_after,
            timeout_s=900.0,
            env={"PYTHONUNBUFFERED": "1", "TORCHFT_QUORUM_TIMEOUT_SEC": "120"},
            via=args.via,
            check=False,
        )
        errors += out["failures"]
    except (AssertionError, RuntimeError, TimeoutError) as e:
        errors.append(f"{type(e).__name__}: {e}")
    return {
        "drill": f"preempt-all:{args.family}",
        "via": args.via,
        "drained_steps": out.get("drained_steps"),
        "resumed_from_steps": out.get("resumed_from_steps"),
        "final_steps": out.get("final_steps"),
        "bitwise_equal": bool(out.get("bitwise_equal")),
        "wall_s": round(time.time() - t0, 1),
    }, errors


def drill_elastic_down(args) -> tuple:
    """Three groups train; one is SIGKILLed for good (no restarts); the
    quorum shrinks 3->2 and the survivors finish bitwise-identical."""
    steps = args.steps
    workdir = _workdir(args, "drill_dn_")
    result_dir, log_dir = workdir + "/results", workdir + "/logs"
    lighthouse = _lighthouse()
    runner = ReplicaGroupRunner(
        _specs(DDP_TRAINER,
               _ddp_args(args, steps, wire=[
                   "--model", "cnn", "--batch-size", "512",
                   "--quantize", "--quantize-bits", "4", "--error-feedback"]),
               3, lighthouse, args.device, result_dir=result_dir),
        max_restarts=0,
        log_dir=log_dir,
    )
    t0 = time.time()
    errors: List[str] = []
    runner.start()
    try:
        _land(_wait_step_mark(runner, log_dir, 2, 0, range(15, 25), 600),
              "group 2 never reached step 15")
        _land(runner.kill_group(2), "kill failed")
        runner.run_until_done(timeout=900)
    except _Landing as e:
        errors.append(str(e))
    finally:
        _shutdown([runner], lighthouse)
    res = _read_results(result_dir, (0, 1))
    return {
        "drill": "elastic-down",
        "final_steps": [_step(res[0]), _step(res[1])],
        "bitwise_equal_survivors": _sha(res[0]) is not None
        and _sha(res[0]) == _sha(res[1]),
        "wall_s": round(time.time() - t0, 1),
    }, errors


def drill_heal_storm(args) -> tuple:
    """Kill the HEALER, not just the runner: after a steady-state SIGKILL,
    the victim's next incarnations are killed AGAIN as soon as they reach
    the dangerous phases: one on "reconfiguring pg" (quorum join in
    flight) and one on "healing from" (checkpoint transfer and commit
    fence in flight). The survivor must ride through every storm kill with
    zero restarts of its own, and the final incarnation heals and finishes
    bitwise-identical."""
    steps = args.steps
    workdir = _workdir(args, "drill_storm_")
    result_dir, log_dir = workdir + "/results", workdir + "/logs"
    lighthouse = _lighthouse()
    runner = ReplicaGroupRunner(
        _specs(DDP_TRAINER, _ddp_args(args, steps), 2, lighthouse, args.device,
               result_dir=result_dir),
        max_restarts=6,
        log_dir=log_dir,
    )
    t0 = time.time()
    errors: List[str] = []
    ok = False
    storm_hits: List[str] = []
    runner.start()
    try:
        # Kill 1: steady state, mid-run (the soak's class).
        mark = int(steps * 0.3)
        _land(_wait_step_mark(runner, log_dir, 1, 0, range(mark, mark + 8), 600),
              f"group 1 never reached step {mark}")
        _land(runner.kill_group(1), "kill 1 failed")
        # Kills 2..3: aimed at the relaunch's join and heal phases. The live
        # incarnation is re-read from runner.restarts each round: a
        # self-death while waiting relaunches the group, and polling a stale
        # incarnation would mislabel the storm phases.
        kills_done = 1
        for marker in STORM_PHASES:
            t_r = time.time()
            while runner.restarts[1] < kills_done and time.time() - t_r < 180:
                runner.monitor_once()
                time.sleep(0.2)
            inc = runner.restarts[1]
            _land(inc == kills_done,
                  f"relaunch {kills_done} never landed (restarts={inc})")
            hit = _wait_log_marker(runner, log_dir, 1, inc, (marker,), 600, poll_s=0.2)
            live_inc = runner.restarts[1]
            _land(hit is not None, f"incarnation {inc} never reached {marker!r}")
            _land(live_inc == inc,
                  f"incarnation churned {inc}->{live_inc} while waiting for "
                  f"{marker!r} (self-death?): phase label unreliable")
            storm_hits.append(hit)
            _land(runner.kill_group(1), f"storm kill (inc {inc}) failed")
            kills_done += 1
        ok = _supervise([runner], 900)
    except _Landing as e:
        errors.append(str(e))
    finally:
        _shutdown([runner], lighthouse)
    res = _read_results(result_dir, (0, 1))
    return {
        "drill": "heal-storm",
        "kills": 1 + len(storm_hits),
        "storm_kill_phases": storm_hits,
        "clean_finish": bool(ok),
        "restarts": dict(runner.restarts),
        "survivor_restarts": runner.restarts.get(0, 0),
        "final_steps": [_step(res[0]), _step(res[1])],
        "bitwise_equal": _sha(res[0]) is not None and _sha(res[0]) == _sha(res[1]),
        "wall_s": round(time.time() - t0, 1),
    }, errors


_RANK_LINE = re.compile(r"reconfiguring pg: quorum \d+, rank (\d+)/(\d+)")


def latest_rank(text: str) -> Optional[tuple]:
    """(rank, world) of the log's last "reconfiguring pg: quorum N, rank
    R/W" line, None before any."""
    m = _RANK_LINE.findall(text)
    return (int(m[-1][0]), int(m[-1][1])) if m else None


def promoted_no_heal(post_kill: str, fixed: int = FIXED) -> bool:
    """Whether the spare's log after the kill re-ranked it into a quorum of
    ``fixed`` members without a heal (it was in lockstep)."""
    promoted = bool(
        re.search(rf"reconfiguring pg: quorum \d+, rank \d+/{fixed}\b", post_kill)
    )
    return promoted and "healing from" not in post_kill


def drill_spare_failover(args) -> tuple:
    """Hot-spare failover (``WorldSizeMode.FIXED_WITH_SPARES``): three
    groups, the effective world size PINNED at ``FIXED`` (2): the third
    runs as a spare (contributes zeros, applies the same averaged update,
    stays in bitwise lockstep). An ACTIVE group is SIGKILLed early in the
    run; the spare must promote at once (no heal: it was never behind)
    while the relaunched victim heals and becomes the new spare. All three
    finish bitwise-identical."""
    steps = args.steps
    n_groups = FIXED + 1
    workdir = _workdir(args, "drill_spare_")
    result_dir, log_dir = workdir + "/results", workdir + "/logs"
    lighthouse = _lighthouse()
    runner = ReplicaGroupRunner(
        _specs(DDP_TRAINER,
               [*_ddp_args(args, steps, min_replicas=FIXED),
                "--world-size-mode", "fixed_with_spares"],
               n_groups, lighthouse, args.device, result_dir=result_dir),
        max_restarts=3,
        log_dir=log_dir,
    )
    t0 = time.time()
    errors: List[str] = []
    ok = False

    def spare_log(group):
        return _log(log_dir, group, runner.restarts[group])

    spare_group = victim = None
    spare_kill_offset = 0
    runner.start()
    try:
        # Kill early (15% in): the victim's relaunch must rejoin, as the new
        # spare, while the run is still live.
        mark = int(steps * 0.15)
        _land(_wait_step_mark(runner, log_dir, 0, 0, range(mark, mark + 8), 600),
              f"group 0 never reached step {mark}")
        # Identify the spare (quorum rank >= FIXED) once every group reports
        # a full n_groups-member quorum: one unsynchronized snapshot can
        # straddle quorum epochs.
        ranks = {}
        deadline = time.time() + 120
        while time.time() < deadline:
            runner.monitor_once()
            ranks = {g: latest_rank(_read(spare_log(g))) for g in range(n_groups)}
            if all(r and r[1] == n_groups for r in ranks.values()):
                break
            time.sleep(0.5)
        spares = [g for g, r in ranks.items() if r and r[0] >= FIXED]
        _land(len(spares) == 1, f"expected exactly one spare, ranks={ranks}")
        spare_group = spares[0]
        victim = next(g for g in range(n_groups) if g != spare_group)
        # The promotion and any disqualifying heal must come AFTER this
        # offset (a 'rank 0/FIXED' line can also occur at startup).
        spare_kill_offset = len(_read(spare_log(spare_group)))
        _land(runner.kill_group(victim), "kill failed")
        ok = _supervise([runner], 900)
    except _Landing as e:
        errors.append(str(e))
    finally:
        _shutdown([runner], lighthouse)
    res = _read_results(result_dir, tuple(range(n_groups)))
    shas = [_sha(res[g]) for g in range(n_groups)]
    post_kill = (
        _read(spare_log(spare_group))[spare_kill_offset:]
        if spare_group is not None else ""
    )
    return {
        "drill": "spare-failover",
        "spare_group": spare_group,
        "victim_group": victim,
        "clean_finish": bool(ok),
        "restarts": dict(runner.restarts),
        "spare_promoted_no_heal": promoted_no_heal(post_kill),
        "final_steps": [_step(res[g]) for g in range(3)],
        "bitwise_equal_all3": None not in shas and len(set(shas)) == 1,
        "wall_s": round(time.time() - t0, 1),
    }, errors


def drill_model_heal(args) -> tuple:
    """``train_hsdp`` kill/heal for a parallelism family: moe, pipeline, or
    ulysses attention, on the int4 outer wire with the pg-sharded heal (the
    port's groups run one rank each)."""
    model = args.model
    steps = args.steps
    trainer_args = [
        "--steps", str(steps), "--min-replicas", "2",
        "--ckpt-transport", "pg-sharded",
        "--quantize", "--quantize-bits", "4",
    ]
    trainer_args += (
        ["--model", "debug", "--attn", "ulysses"] if model == "ulysses"
        else ["--model", model]
    )
    workdir = _workdir(args, f"drill_{model}_")
    result_dir, log_dir = workdir + "/results", workdir + "/logs"
    lighthouse = _lighthouse()
    runner = ReplicaGroupRunner(
        _specs("torchft_tpu_torch.train_hsdp", trainer_args, 2, lighthouse,
               args.device, result_dir=result_dir),
        max_restarts=3,
        log_dir=log_dir,
    )
    t0 = time.time()
    errors: List[str] = []
    ok = False
    runner.start()
    try:
        _land(_wait_step_mark(runner, log_dir, 1, 0, range(2, 5), 600),
              "group 1 never reached step 2")
        _land(runner.kill_group(1), "kill failed")
        ok = _supervise([runner], 900)
    except _Landing as e:
        errors.append(str(e))
    finally:
        _shutdown([runner], lighthouse)
    res = _read_results(result_dir, (0, 1))
    return {
        "drill": f"model-heal:{model}",
        "clean_finish": bool(ok),
        "restarts": dict(runner.restarts),
        "final_steps": [_step(res[0]), _step(res[1])],
        "bitwise_equal": _sha(res[0]) is not None and _sha(res[0]) == _sha(res[1]),
        "wall_s": round(time.time() - t0, 1),
    }, errors


DRILLS = {
    "soak": drill_soak,
    "elastic-up": drill_elastic_up,
    "elastic-down": drill_elastic_down,
    "drain": drill_drain,
    "preempt-all": drill_preempt_all,
    "heal-storm": drill_heal_storm,
    "spare-failover": drill_spare_failover,
    "model-heal": drill_model_heal,
}


def _equal_steps(steps) -> bool:
    return bool(steps) and steps[0] is not None and len(set(steps)) == 1


def check_report(drill: str, report: dict) -> None:
    """Holds a drill's report to what the JAX drill asserts or reports as
    its verdict; raises AssertionError naming every check that fails.
    ``drill`` is the subcommand (``"preempt-all"``, not
    ``"preempt-all:ddp"``)."""
    bad: List[str] = []

    def need(ok, msg):
        if not ok:
            bad.append(msg)

    r = report
    if drill == "soak":
        need(r["clean_finish"], "soak: not a clean finish")
        need(r["bitwise_equal"], "soak: the groups diverged")
        need(_equal_steps(r["final_steps"]), f"soak: final steps {r['final_steps']}")
    elif drill == "elastic-up":
        step = r["joiner_heal_step"]
        end = max((s for s in r["final_steps"] if s is not None), default=None)
        need(r["clean_finish"], "elastic-up: not a clean finish")
        need(r["joined_mid_run"] and step is not None and end is not None
             and 0 < step < end,
             f"elastic-up: the joiner healed at step {step}, not mid-run")
        need(r["bitwise_equal_all3"], "elastic-up: the three groups diverged")
    elif drill == "drain":
        drain, kill = r["graceful_drain"], r["sigkill_control"]
        need(drain["victim_exit_clean"], "drain: the drained trainer did not exit 0")
        need(drain["victim_drain_logged"], "drain: drain markers missing from its log")
        for name, leg in (("drain", drain), ("sigkill", kill)):
            need(leg["bitwise_equal_survivors"], f"{name} leg: the survivors diverged")
            stall = leg["survivor_stall_s"]
            need(stall is not None and stall < STALL_LIMIT_S,
                 f"{name} leg: survivor stall {stall} s, not under "
                 f"{STALL_LIMIT_S} s (about one step)")
    elif drill == "preempt-all":
        drained, resumed = r["drained_steps"], r["resumed_from_steps"]
        need(drained is not None and None not in drained and resumed == drained,
             f"preempt-all: resumed from {resumed}, drained at {drained}")
        need(r["bitwise_equal"], "preempt-all: the resumed groups diverged")
    elif drill == "elastic-down":
        need(r["bitwise_equal_survivors"], "elastic-down: the survivors diverged")
    elif drill == "heal-storm":
        need(r["storm_kill_phases"] == STORM_PHASES,
             f"heal-storm: storm kills landed in {r['storm_kill_phases']}")
        need(r["survivor_restarts"] == 0,
             f"heal-storm: the survivor restarted {r['survivor_restarts']} times")
        need(r["clean_finish"], "heal-storm: not a clean finish")
        need(r["bitwise_equal"], "heal-storm: the groups diverged")
    elif drill == "spare-failover":
        need(r["spare_group"] is not None, "spare-failover: no single spare")
        need(r["spare_promoted_no_heal"],
             "spare-failover: the spare was not promoted, or healed")
        need(r["clean_finish"], "spare-failover: not a clean finish")
        need(r["bitwise_equal_all3"], "spare-failover: the three groups diverged")
    elif drill == "model-heal":
        need(r["clean_finish"], "model-heal: not a clean finish")
        need(r["bitwise_equal"], "model-heal: the groups diverged")
    else:
        raise ValueError(f"unknown drill {drill!r}")
    if bad:
        raise AssertionError("; ".join(bad))


def planted(drill: str, report: dict) -> dict:
    """A copy of a passing ``report`` with one departure-specific fault
    planted, which :func:`check_report` must refuse: a diverged group, a
    joiner that never healed mid-run, a 30 s drain stall, a resume step
    other than the drain step, a storm kill in the wrong phase, a "healing
    from" line in the promoted spare's post-kill log."""
    r = json.loads(json.dumps(report))
    if drill in ("soak", "model-heal"):
        r["bitwise_equal"] = False
    elif drill == "elastic-up":
        r["joiner_heal_step"] = None
        r["joined_mid_run"] = False
    elif drill == "drain":
        r["graceful_drain"]["survivor_stall_s"] = 30.0
    elif drill == "preempt-all":
        r["resumed_from_steps"] = [s - 10 for s in r["drained_steps"]]
    elif drill == "elastic-down":
        r["bitwise_equal_survivors"] = False
    elif drill == "heal-storm":
        r["storm_kill_phases"] = [STORM_PHASES[0], STORM_PHASES[0]]
    elif drill == "spare-failover":
        r["spare_promoted_no_heal"] = promoted_no_heal(
            f"reconfiguring pg: quorum 9, rank 0/{FIXED}\n"
            "healing from replica_rank=1 at step 5\n"
        )
    else:
        raise ValueError(f"unknown drill {drill!r}")
    return r


def build_parser() -> argparse.ArgumentParser:
    """The CLI: ``tools/drills.py``'s subcommands, flags and defaults, and
    ``--device`` on each."""
    p = argparse.ArgumentParser(
        prog="python -m torchft_tpu_torch.drills", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="drill", required=True)

    def drill(name, steps):
        s = sub.add_parser(name)
        s.add_argument("--steps", type=int, default=steps)
        s.add_argument(
            "--device", type=str, default="cuda",
            help="torch device of every trainer (default cuda; cpu runs them "
            "on the CPU)",
        )
        # Not flags: a caller that builds the Namespace may set ``workdir``
        # (where the drill's temporary directory goes) and ``ddp_args`` (a
        # model and wire for the DDP drills in place of the cnn's).
        s.set_defaults(workdir=None, ddp_args=None)
        return s

    drill("soak", 100).add_argument("--kills", type=int, default=4)
    # Full-speed peers: sized so that the run outlives the joiner's start.
    drill("elastic-up", 1200)
    drill("elastic-down", 120)
    # Long enough that the departure at ~step 15 leaves the survivors a
    # post-stall runway for the cadence measurement.
    drill("drain", 60)
    s = drill("preempt-all", 60)
    s.add_argument("--family", choices=("ddp", "diloco", "hsdp"), default="ddp")
    s.add_argument(
        "--via", choices=("sigterm", "operator"), default="sigterm",
        help="how the full-job drain is triggered: per-process SIGTERM "
        "(preemption shape) or one lighthouse drain_all RPC (dashboard "
        "'drain ALL' button)",
    )
    drill("heal-storm", 100)
    # The killed ACTIVE's relaunch must rejoin (as the new spare) while the
    # run is still live: the post-kill runway must outlive its start.
    drill("spare-failover", 2000)
    # 30, not 8: the kill-mark poll is 1 Hz, and a fast family can blow
    # from the mark past the finish inside one poll interval.
    drill("model-heal", 30).add_argument(
        "--model", choices=["moe", "pipeline", "ulysses"], required=True
    )
    return p


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Runs the drill ``args`` names and returns its report; raises
    :class:`DrillFailed` (with the report) if it failed."""
    require_device(args.device)
    report, errors = DRILLS[args.drill](args)
    try:
        check_report(args.drill, report)
    except AssertionError as e:
        errors.append(str(e))
    if errors:
        raise DrillFailed(report, errors)
    return report


def main(argv=None) -> int:
    # A SIGTERM (``timeout``, a driver) would otherwise kill this process
    # without running the drills' cleanup, leaving the trainers spinning on
    # quorum retries: turn it into SystemExit so every runner.stop() and
    # lighthouse shutdown runs.
    def _term(_signum, _frame):
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, _term)
    args = parse_args(argv)
    try:
        report = run(args)
    except DrillFailed as e:
        print(json.dumps(e.report), flush=True)
        for reason in e.reasons:
            print(f"drill failed: {reason}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
