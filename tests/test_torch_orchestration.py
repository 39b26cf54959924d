"""The port's orchestration (torchft_tpu_torch/orchestration): the twins of
tests/test_orchestration.py's six cases (topology rendering, the keep-alive
runner with chaos kills and state equality, the punisher's MTBF loop, the
lighthouse kill RPC, the DiLoCo int4 kill/heal under the runner, the
full-job preemption), the rendered environment held to the JAX package's,
and what the port's runner adds: the runner-driven llama_debug kill/heal
(the CPU rehearsal of ``chip_smoke.py``'s orchestration phase), a JAX and a
port demo trainer committing the same bits in one quorum, and a runner
process that never imports torch."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from torchft_tpu.orchestration import render_topology as jax_render_topology
from torchft_tpu_torch.coordination import LighthouseServer, ManagerServer
from torchft_tpu_torch.orchestration import (
    Punisher,
    ReplicaGroupRunner,
    kill_via_lighthouse,
    render_topology,
)
from torchft_tpu_torch.orchestration.punisher import kill_one

REPO = Path(__file__).resolve().parent.parent


def _lighthouse(min_replicas=2):
    return LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=min_replicas,
        join_timeout_ms=10000,
        quorum_tick_ms=50,
        heartbeat_timeout_ms=3000,
    )


def test_render_topology_env():
    specs = render_topology(
        ["python", "train.py"],
        num_replica_groups=2,
        workers_per_replica=2,
        lighthouse_addr="127.0.0.1:29510",
        env={"EXTRA": "1"},
        timeout_sec=12.5,
    )
    assert len(specs) == 4
    s = specs[3]  # group 1, rank 1
    assert s.replica_group == 1 and s.group_rank == 1
    assert s.cmd == ["python", "train.py"]
    assert s.env["REPLICA_GROUP_ID"] == "1"
    assert s.env["NUM_REPLICA_GROUPS"] == "2"
    assert s.env["TORCHFT_LIGHTHOUSE"] == "127.0.0.1:29510"
    assert s.env["RANK"] == "1"
    assert s.env["WORLD_SIZE"] == "2"
    assert s.env["EXTRA"] == "1"
    assert s.env["TORCHFT_TIMEOUT_SEC"] == "12.5"
    # ranks of one group share a master port and a torch rendezvous;
    # groups differ
    assert specs[2].env["MASTER_PORT"] == specs[3].env["MASTER_PORT"]
    assert specs[0].env["MASTER_PORT"] != specs[2].env["MASTER_PORT"]
    assert specs[2].env["GROUP_INIT_METHOD"] == specs[3].env["GROUP_INIT_METHOD"]
    assert specs[0].env["GROUP_INIT_METHOD"] != specs[2].env["GROUP_INIT_METHOD"]
    assert [sp.env["LOCAL_RANK"] for sp in specs] == ["0", "1", "0", "1"]
    # single-worker topologies don't force a master port
    solo = render_topology(
        ["x"], num_replica_groups=1, lighthouse_addr="a:1"
    )
    assert "MASTER_PORT" not in solo[0].env


@pytest.mark.parametrize("workers", [1, 2])
def test_render_topology_env_keys_equal_jax(workers, tmp_path):
    """The same arguments give the JAX package's environment: the same keys
    and values, but for the ports a group of several ranks picks at
    random, and the port's two additions for such a group (``LOCAL_RANK``,
    the card; ``GROUP_INIT_METHOD``, its torch rendezvous)."""
    kwargs = dict(
        num_replica_groups=3,
        lighthouse_addr="127.0.0.1:29510",
        workers_per_replica=workers,
        env={"EXTRA": "1"},
        timeout_sec=9.0,
        quorum_timeout_sec=30.0,
        journal_dir=str(tmp_path),
    )
    port = render_topology(["python", "-m", "t"], **kwargs)
    ref = jax_render_topology(["python", "-m", "t"], **kwargs)
    added = {"LOCAL_RANK", "GROUP_INIT_METHOD"} if workers > 1 else set()
    assert len(port) == len(ref)
    for p, j in zip(port, ref):
        assert (p.replica_group, p.group_rank, p.cmd, p.name) == (
            j.replica_group, j.group_rank, j.cmd, j.name
        )
        assert set(p.env) == set(j.env) | added
        for key, value in j.env.items():
            if key != "MASTER_PORT":
                assert p.env[key] == value, key


@pytest.mark.slow
def test_chaos_runner_kills_heal_and_state_equal(tmp_path):
    """Three replica groups of the port's demo trainer train under the
    keep-alive runner; two SIGKILLs hit non-zero groups mid-run; the runner
    relaunches them, they heal from the survivors, and every group finishes
    with bitwise-equal params."""
    steps = 150
    lighthouse = _lighthouse()
    result_dir = str(tmp_path / "results")
    runner = None
    try:
        specs = render_topology(
            [
                sys.executable, "-m",
                "torchft_tpu_torch.orchestration.demo_trainer",
                "--steps", str(steps),
                "--result-dir", result_dir,
                "--step-sleep", "0.03",
                "--device", "cpu",
            ],
            num_replica_groups=3,
            lighthouse_addr=lighthouse.address(),
        )
        runner = ReplicaGroupRunner(
            specs, max_restarts=10, log_dir=str(tmp_path / "logs")
        )
        runner.start()
        time.sleep(4.0)
        assert kill_one(runner, spare_group_zero=True) is not None
        runner.monitor_once()  # relaunch immediately
        time.sleep(3.0)
        assert kill_one(runner, spare_group_zero=True) is not None
        ok = runner.run_until_done(timeout=240)
        assert ok, f"runner did not finish cleanly (restarts={runner.restarts})"
        assert sum(runner.restarts.values()) >= 2
    finally:
        if runner is not None:
            runner.stop()
        lighthouse.shutdown()

    results = {}
    for g in range(3):
        with open(os.path.join(result_dir, f"group{g}.json")) as f:
            results[g] = json.load(f)
    ws = [np.asarray(results[g]["w"], np.float32) for g in range(3)]
    for w in ws[1:]:
        np.testing.assert_array_equal(ws[0], w)
    for g in range(3):
        assert results[g]["final_step"] == steps
        assert results[g]["steps_per_sec"] > 0
    healed = [
        g for g in range(3)
        if results[g]["committed_this_life"] < steps
    ]
    assert healed, f"no group shows heal evidence: {results}"


def test_punisher_mtbf_loop(tmp_path):
    """The MTBF loop kills repeatedly (respecting max_kills and the
    spare-group-zero rule) and the runner keeps victims alive."""
    specs = render_topology(
        [sys.executable, "-c", "import time; time.sleep(60)"],
        num_replica_groups=3,
        lighthouse_addr="127.0.0.1:1",  # never contacted by the sleepers
    )
    runner = ReplicaGroupRunner(specs, max_restarts=50)
    runner.start()
    try:
        punisher = Punisher(
            runner, mtbf_secs=0.2, interval_secs=0.05, seed=7, max_kills=3
        )
        punisher.start()
        deadline = time.monotonic() + 20
        while punisher.kills < 3 and time.monotonic() < deadline:
            runner.monitor_once()
            time.sleep(0.05)
        punisher.stop()
        assert punisher.kills == 3
        runner.monitor_once()
        assert runner.restarts[0] == 0  # group zero spared
        assert sum(runner.restarts.values()) >= 2
        assert len(runner.live_pids()) == 3  # all victims relaunched
    finally:
        runner.stop()


def test_kill_via_lighthouse():
    """Control-plane chaos: the lighthouse Kill RPC makes the target
    manager server process exit (reference: lighthouse.rs:454-479 ->
    manager.rs:481-486 exit(1))."""
    from torchft_tpu_torch.coordination import ManagerClient

    lighthouse = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=1, quorum_tick_ms=50
    )
    server = None
    try:
        server = ManagerServer(
            replica_id="killme",
            lighthouse_addr=lighthouse.address(),
            store_address="127.0.0.1:1",
            world_size=1,
        )
        client = ManagerClient(server.address(), connect_timeout=10.0)
        client._quorum(
            group_rank=0,
            step=0,
            checkpoint_metadata="",
            shrink_only=False,
            timeout=15.0,
            init_sync=False,
            commit_failures=0,
        )
        client.close()

        assert kill_via_lighthouse(lighthouse.address(), "killme")
        deadline = time.monotonic() + 10
        while server.is_alive() and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not server.is_alive(), "manager server survived the kill RPC"
        server = None  # already dead; skip shutdown
    finally:
        if server is not None:
            server.shutdown()
        lighthouse.shutdown()


DILOCO_ARGS = [
    "--sync-every", "4", "--n-fragments", "2", "--batch-size", "4",
    "--seq-len", "64", "--device", "cpu",
]


@pytest.mark.slow
def test_diloco_int4_ef_kill_heal_bitwise_equal(tmp_path):
    """Streaming DiLoCo across two OS processes under the runner on the
    int4 + error-feedback wire, SIGKILL one group mid-run: the relaunched
    incarnation heals the global state and both groups finish the
    outer-step target with the same global state."""
    outer_steps = 10
    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=2,
        join_timeout_ms=30000,
        quorum_tick_ms=50,
        heartbeat_timeout_ms=5000,
    )
    result_dir = str(tmp_path / "results")
    runner = None
    try:
        specs = render_topology(
            [
                sys.executable, "-m", "torchft_tpu_torch.train_diloco",
                "--outer-steps", str(outer_steps),
                "--fragment-sync-delay", "0",
                "--min-replicas", "2",
                "--quantize", "--quantize-bits", "4", "--error-feedback",
                *DILOCO_ARGS,
                "--result-dir", result_dir,
            ],
            num_replica_groups=2,
            lighthouse_addr=lighthouse.address(),
            env={
                "OMP_NUM_THREADS": "1",
                "TORCHFT_QUORUM_TIMEOUT_SEC": "120",
                "TORCHFT_TIMEOUT_SEC": "60",
            },
        )
        runner = ReplicaGroupRunner(
            specs, max_restarts=3, log_dir=str(tmp_path / "logs")
        )
        runner.start()
        deadline = time.monotonic() + 300
        killed = False
        while time.monotonic() < deadline and not killed:
            time.sleep(0.5)
            runner.monitor_once()
            log = tmp_path / "logs" / "replica1_rank0.r0.log"
            if log.exists() and "outer_step=2" in log.read_text():
                assert runner.kill_group(1), "kill failed"
                killed = True
        assert killed, "group 1 never reached outer step 2 in the deadline"
        ok = runner.run_until_done(timeout=600)
        assert ok, f"runner did not finish cleanly (restarts={runner.restarts})"
        assert runner.restarts[1] >= 1, "killed group was never relaunched"
    finally:
        if runner is not None:
            runner.stop()
        lighthouse.shutdown()

    results = {}
    for g in range(2):
        with open(os.path.join(result_dir, f"group{g}.json")) as f:
            results[g] = json.load(f)
    assert results[0]["final_outer_step"] >= outer_steps
    assert results[1]["final_outer_step"] >= outer_steps
    assert results[0]["global_sha"] == results[1]["global_sha"], results


@pytest.mark.slow
@pytest.mark.timeout(480)
def test_preempt_all_drill_diloco(tmp_path):
    """Full-job preemption of the port's DiLoCo trainer (the JAX drill's
    diloco family): every group SIGTERMed at once, final durable
    snapshots, relaunch under a FRESH lighthouse, resume from the
    drain-time snapshots and a bitwise-equal finish."""
    from torchft_tpu_torch.drill import preempt_all_drill

    out = preempt_all_drill(
        "torchft_tpu_torch.train_diloco",
        [
            "--outer-steps", "12", "--fragment-sync-delay", "1",
            "--durable-every", "2", "--durable-dir", str(tmp_path / "durable"),
            *DILOCO_ARGS,
        ],
        str(tmp_path / "results"),
        str(tmp_path / "logs"),
        term_after_step=3,
        timeout_s=450.0,
        env={"OMP_NUM_THREADS": "1"},
    )
    assert out["resumed_from_steps"] == out["drained_steps"]
    assert out["final_steps"] == [12, 12], out["final_steps"]


# -- what the port's runner adds ---------------------------------------------


@pytest.mark.timeout(300)
def test_runner_relaunches_a_group_killed_through_the_lighthouse(
    tmp_path, monkeypatch
):
    """The CPU rehearsal of chip_smoke.py's orchestration phase on
    llama_debug: the runner launches both groups, group 1's manager is
    killed through the lighthouse after step 3, the runner relaunches the
    group once, it heals from group 0, both end at step 8 in the same bits,
    and the runner's journal holds one ``proc_death`` for it."""
    from torchft_tpu_torch.drill import runner_kill_heal_drill

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the trainers inherit it
    out = runner_kill_heal_drill(
        ["--model", "debug", "--steps", "8", "--device", "cpu"],
        str(tmp_path / "results"),
        str(tmp_path / "logs"),
    )
    r0, r1 = out["results"][0], out["results"][1]
    assert out["restarts"] == {0: 0, 1: 1}
    assert [d["subject"] for d in out["proc_deaths"]] == ["replica1/rank0"]
    assert out["kill"] in ("lighthouse", "runner")
    assert r0["final_step"] == r1["final_step"] == 8
    assert r0["param_sha256"] == r1["param_sha256"]
    healed = Path(out["restart_log"]).read_text()
    assert "healing from replica_rank=0" in healed


@pytest.mark.timeout(180)
def test_jax_and_port_demo_trainers_commit_the_same_bits(tmp_path):
    """One JAX and one port demo trainer in one quorum under one runner:
    the same fp32 arithmetic on the same averaged gradient, so both end
    with the same bits."""
    steps = 12
    lighthouse = _lighthouse()
    result_dir = tmp_path / "results"
    common = ["--steps", str(steps), "--min-replicas", "2",
              "--result-dir", str(result_dir)]
    env = {"JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    try:
        specs = render_topology(
            [sys.executable, "-m", "torchft_tpu.orchestration.demo_trainer",
             *common],
            num_replica_groups=2, lighthouse_addr=lighthouse.address(), env=env,
        )[:1] + render_topology(
            [sys.executable, "-m", "torchft_tpu_torch.orchestration.demo_trainer",
             *common, "--device", "cpu"],
            num_replica_groups=2, lighthouse_addr=lighthouse.address(), env=env,
        )[1:]
        runner = ReplicaGroupRunner(
            specs, max_restarts=0, log_dir=str(tmp_path / "logs")
        )
        runner.start()
        try:
            assert runner.run_until_done(timeout=150), "a demo trainer failed"
        finally:
            runner.stop()
    finally:
        lighthouse.shutdown()
    results = [json.loads((result_dir / f"group{g}.json").read_text()) for g in (0, 1)]
    assert [r["final_step"] for r in results] == [steps, steps]
    ws = [np.asarray(r["w"], np.float32) for r in results]
    assert ws[0].tobytes() == ws[1].tobytes()
    assert not np.array_equal(ws[0], np.zeros_like(ws[0]))


def _journal_commits(journal, group):
    """Committed steps in group ``group``'s journal so far."""
    return sum(
        1
        for f in journal.glob(f"journal_replica{group}_*.jsonl")
        for line in f.read_text(errors="replace").splitlines()
        if '"commit_gate"' in line and '"committed": true' in line
    )


@pytest.mark.timeout(240)
@pytest.mark.parametrize("pg", ["socket", "native"])
def test_port_groups_heal_a_killed_jax_demo_trainer(tmp_path, pg):
    """Two port demo trainers and one JAX demo trainer in one quorum under
    one runner, over the socket group or ``TORCHFT_PG=native``. The JAX
    group is SIGKILLed once it has committed; the runner relaunches it and
    it heals from a port replica (a JAX heal source would skip the
    collective that fences its checkpoint: ROADMAP.md section 3). A quorum
    needs all three groups, so the port groups wait for the relaunch
    however long its start takes. All three end at the last step with the
    same ``w`` bits."""
    steps = 40
    lighthouse = _lighthouse(min_replicas=3)
    result_dir = tmp_path / "results"
    journal = tmp_path / "journal"
    common = ["--steps", str(steps), "--min-replicas", "3",
              "--result-dir", str(result_dir), "--step-sleep", "0.03"]
    env = {"JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    if pg == "native":
        env["TORCHFT_PG"] = "native"
    try:
        port = [sys.executable, "-m", "torchft_tpu_torch.orchestration.demo_trainer",
                *common, "--device", "cpu"]
        jax = [sys.executable, "-m", "torchft_tpu.orchestration.demo_trainer", *common]
        specs = [
            render_topology(
                cmd, num_replica_groups=3, lighthouse_addr=lighthouse.address(),
                env=env, journal_dir=str(journal),
            )[g]
            for g, cmd in enumerate((port, port, jax))
        ]
        runner = ReplicaGroupRunner(specs, max_restarts=2, log_dir=str(tmp_path / "logs"))
        runner.start()
        try:
            deadline = time.monotonic() + 120
            while _journal_commits(journal, 2) < 5:
                assert time.monotonic() < deadline, "the JAX group never committed"
                assert not sum(runner.restarts.values()), "a group died early"
                time.sleep(0.05)
            assert runner.kill_group(2)
            assert runner.run_until_done(timeout=180), (
                f"a demo trainer failed (restarts {runner.restarts})"
            )
            assert runner.restarts == {0: 0, 1: 0, 2: 1}
        finally:
            runner.stop()
    finally:
        lighthouse.shutdown()
    results = [json.loads((result_dir / f"group{g}.json").read_text()) for g in range(3)]
    assert [r["final_step"] for r in results] == [steps] * 3
    assert 0 < results[2]["committed_this_life"] < steps, "the JAX group did not heal"
    ws = [np.asarray(r["w"], np.float32).tobytes() for r in results]
    assert ws[0] == ws[1] == ws[2]
    backends = {
        json.loads(line)["attrs"]["backend"]
        for f in journal.glob("journal_replica*.jsonl")
        for line in f.read_text(errors="replace").splitlines()
        if '"pg_collective"' in line
    }
    assert backends == {f"torchft-{pg}"}


def test_runner_cli_launches_groups_without_importing_torch(tmp_path):
    """``python -m torchft_tpu_torch.orchestration.runner`` runs each
    group's command with its topology environment, and the runner process
    itself never imports torch (so it never touches a card)."""
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import json, os, sys\n"
        f"out = {str(tmp_path)!r}\n"
        "g = os.environ['REPLICA_GROUP_ID']\n"
        "keys = ('NUM_REPLICA_GROUPS', 'TORCHFT_LIGHTHOUSE', 'RANK', 'WORLD_SIZE')\n"
        "json.dump({k: os.environ[k] for k in keys}, open(f'{out}/g{g}.json', 'w'))\n"
    )
    code = (
        "import sys\n"
        "from torchft_tpu_torch.orchestration import runner\n"
        "rc = runner.main(sys.argv[1:])\n"
        "assert 'torch' not in sys.modules, 'the runner imported torch'\n"
        "sys.exit(rc)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO), "TORCHFT_RUNNER_PDEATHSIG": "0"}
    out = subprocess.run(
        [sys.executable, "-c", code, "--replicas", "2", "--lighthouse",
         "127.0.0.1:29510", "--timeout", "60", "--", sys.executable, str(probe)],
        env=env, capture_output=True, text=True, timeout=90,
    )
    assert out.returncode == 0, out.stderr
    for g in (0, 1):
        got = json.loads((tmp_path / f"g{g}.json").read_text())
        assert got == {
            "NUM_REPLICA_GROUPS": "2", "TORCHFT_LIGHTHOUSE": "127.0.0.1:29510",
            "RANK": "0", "WORLD_SIZE": "1",
        }
