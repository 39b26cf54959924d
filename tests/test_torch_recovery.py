"""The port's recovery accounting held to the JAX package's: the episode
detector (``telemetry.detect_episodes``), its per-replica phase windows
(``episode_phase_windows`` over ``_local_episodes``), the tiling check
(``check_episodes``, the per-episode part of ``tools/recovery_report.py
--check``) and the rotation-aware journal loader (``load_journal``, the
twin of ``tools/obs_report.py load_events``), on the journals of
tests/test_recovery.py (the kill/heal fixture and the hand-built event
lists): field for field, the JAX package's result the reference. The
port's HTTP and ``pg`` checkpoint transports emit the ``heal_xfer`` fields
that file requires of the JAX package's."""

import copy
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu import telemetry as jtel
from torchft_tpu_torch import telemetry

from test_recovery import REPO, _ev, kill_heal_fixture

sys.path.insert(0, os.path.join(REPO, "tools"))

import obs_report  # noqa: E402
import recovery_report  # noqa: E402


def _chaos_without_relaunch():
    return [
        _ev("chaos_inject", 10.0, rid="0", kind="reset", plane="data",
            site="allreduce"),
        _ev("allreduce_complete", 10.5, step=3, rid="0", elapsed_s=0.1,
            ok=False),
        _ev("pg_abort", 10.6, rid="0"),
        _ev("quorum_start", 10.7, rid="0"),
        _ev("quorum_ready", 12.0, rid="0", elapsed_s=1.0, heal=False),
        _ev("commit_gate", 12.5, step=3, rid="0", elapsed_s=0.05,
            committed=True),
    ]


def _open_at_journal_end():
    return [
        _ev("quorum_start", 50.0, rid="1"),
        _ev("quorum_ready", 51.0, rid="1", elapsed_s=1.0, heal=True),
        _ev("heal_failed", 51.5, rid="1", cause="TimeoutError",
            phase="transfer", error="recv timed out"),
    ]


def _commits_without_impact():
    return [
        _ev("quorum_start", 1.0, rid="0"),
        _ev("quorum_ready", 1.2, rid="0", elapsed_s=0.2, heal=False),
        _ev("commit_gate", 2.0, step=1, rid="0", elapsed_s=0.05,
            committed=True),
        _ev("commit_gate", 3.0, step=2, rid="0", elapsed_s=0.05,
            committed=True),
    ]


def _chaos_soak_schedule():
    with open(os.path.join(REPO, "CHAOS_SOAK.json")) as f:
        soak = json.load(f)
    evs = []
    for g, injs in soak["injections"].items():
        for inj in injs:
            evs.append(_ev(
                "chaos_inject", float(inj["ts"]), step=inj.get("step"),
                rid=str(g), kind=inj["kind"], plane=inj["plane"],
                site=inj["site"],
            ))
            evs.append(_ev(
                "commit_gate", float(inj["ts"]) + 0.5, step=inj.get("step"),
                rid=str(g), elapsed_s=0.05, committed=True,
            ))
    return evs


def _two_kills():
    """The fixture twice, the second 100 s later with a gap: two episodes."""
    later = []
    for ev in kill_heal_fixture():
        ev = copy.deepcopy(ev)
        ev["ts"] += 100.0
        later.append(ev)
    return kill_heal_fixture() + later


JOURNALS = {
    "kill_heal": kill_heal_fixture,
    "chaos_without_relaunch": _chaos_without_relaunch,
    "open_at_journal_end": _open_at_journal_end,
    "commits_without_impact": _commits_without_impact,
    "chaos_soak_schedule": _chaos_soak_schedule,
    "two_kills": _two_kills,
}


@pytest.mark.parametrize("journal", sorted(JOURNALS))
def test_port_episodes_equal_the_jax_packages(journal):
    evs = JOURNALS[journal]()
    got = telemetry.detect_episodes(copy.deepcopy(evs))
    want = jtel.detect_episodes(copy.deepcopy(evs))
    assert got == want
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("journal", sorted(JOURNALS))
def test_port_phase_windows_equal_the_jax_packages(journal):
    """Each replica's local episodes and their five phase windows."""
    by_replica = {}
    for ev in sorted(JOURNALS[journal](), key=lambda e: e["ts"]):
        by_replica.setdefault(telemetry._episode_replica(ev), []).append(ev)
    for revs in by_replica.values():
        got = telemetry._local_episodes(copy.deepcopy(revs))
        want = jtel._local_episodes(copy.deepcopy(revs))
        assert got == want
        for g, w in zip(got, want):
            assert telemetry.episode_phase_windows(g) == jtel.episode_phase_windows(w)
            assert telemetry._episode_row(g) == jtel._episode_row(w)


def test_kill_heal_fixture_reads_the_jax_tests_numbers():
    """The JAX test's pinned decomposition, read off the port's detector."""
    (ep,) = telemetry.detect_episodes(kill_heal_fixture())
    assert (ep["primary"], ep["root_cause"]["kind"]) == ("1", "process_loss")
    assert ep["ttr_s"] == pytest.approx(6.8)
    p1 = ep["replicas"]["1"]["phases"]
    assert p1["quorum"] == pytest.approx(1.4)
    assert p1["transfer"] == pytest.approx(1.0)
    assert p1["rebuild"] == pytest.approx(0.3)
    assert ep["replicas"]["1"]["ttr_s"] == pytest.approx(4.0)


@pytest.mark.parametrize("journal", sorted(JOURNALS))
def test_check_episodes_passes_where_the_report_check_passes(journal):
    evs = JOURNALS[journal]()
    assert telemetry.check_episodes(telemetry.detect_episodes(evs)) == []
    assert recovery_report.check(recovery_report.analyze(evs)) == []


def test_check_episodes_catches_what_the_report_check_catches():
    """A broken tiling and an unlatched cause: the port's check names the
    same faults, in the same words, as ``recovery_report.check``."""
    eps = telemetry.detect_episodes(kill_heal_fixture())
    report = recovery_report.analyze(kill_heal_fixture())
    for row in (eps[0]["replicas"]["1"], report["episodes"][0]["replicas"]["1"]):
        row["phases"]["catchup"] += 0.5
        row["attempts"][0]["cause"] = None
    got = telemetry.check_episodes(eps)
    assert any("phases sum" in e for e in got)
    assert any("without a latched cause" in e for e in got)
    assert set(got) <= set(recovery_report.check(report))


def test_load_journal_reads_the_rotated_segment_first(tmp_path):
    live = tmp_path / "journal_replica0_rank0.jsonl"
    old = tmp_path / "journal_replica0_rank0.jsonl.1"
    old.write_text(
        json.dumps({"ts": 1.0, "event": "quorum_start", "replica_id": "0"}) + "\n"
        + json.dumps({"ts": 2.0, "event": "quorum_ready", "replica_id": "0"}) + "\n"
    )
    live.write_text(
        json.dumps({"ts": 3.0, "event": "commit_gate", "replica_id": "0"}) + "\n"
        + "{torn line\n"
    )
    for paths in ([str(tmp_path)], [str(live)], [str(old), str(live)]):
        evs = telemetry.load_journal(paths)
        assert [e["ts"] for e in evs] == [1.0, 2.0, 3.0]
        assert evs == obs_report.load_events(paths)


# ---------------------------------------------------------------------------
# heal_xfer emission from the port's transports
# ---------------------------------------------------------------------------


def _sample_state():
    """tests/test_recovery.py's state, as the port holds it."""
    return {
        "model": {
            "w": torch.arange(4096, dtype=torch.float32).reshape(64, 64),
            "b": torch.zeros(64, dtype=torch.float32),
        },
        "step": 7,
    }


def _xfers(journal):
    return [
        json.loads(line)["attrs"]
        for line in journal.read_text().splitlines()
        if json.loads(line)["event"] == "heal_xfer"
    ]


def test_http_transport_emits_heal_xfer(tmp_path, monkeypatch):
    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

    journal = tmp_path / "j.jsonl"
    monkeypatch.setenv("TORCHFT_JOURNAL_FILE", str(journal))
    telemetry.reset_event_log()
    sender = HTTPTransport(num_chunks=2)
    receiver = HTTPTransport()
    try:
        state = _sample_state()
        sender.send_checkpoint([1], step=7, state_dict=state, timeout=10)
        got = receiver.recv_checkpoint(
            src_rank=0, metadata=sender.metadata(), step=7, timeout=10
        )
        np.testing.assert_array_equal(np.asarray(got["model"]["w"]), state["model"]["w"].numpy())
    finally:
        sender.shutdown()
        receiver.shutdown()
        telemetry.reset_event_log()
    by_dir = {}
    for x in _xfers(journal):
        by_dir.setdefault(x["dir"], []).append(x)
    assert set(by_dir) == {"stage", "send", "recv"}
    recv = by_dir["recv"][0]
    assert recv["transport"] == "http"
    assert recv["nbytes"] > 0 and recv["elapsed_s"] > 0
    assert recv["wire_s"] >= 0 and recv["ser_s"] >= 0
    assert recv["retries"] == 0
    assert recv["chunks"] and all(c["nbytes"] > 0 for c in recv["chunks"])
    assert sum(s["nbytes"] for s in by_dir["send"]) == recv["nbytes"]


@pytest.mark.parametrize("sharded", [False, True], ids=["plain", "sharded"])
def test_pg_transport_emits_heal_xfer(tmp_path, monkeypatch, sharded):
    from torchft_tpu_torch.checkpointing.pg_transport import PGTransport
    from torchft_tpu_torch.process_group import ProcessGroupSocket
    from torchft_tpu_torch.store import TCPStoreServer

    journal = tmp_path / "j.jsonl"
    monkeypatch.setenv("TORCHFT_JOURNAL_FILE", str(journal))
    telemetry.reset_event_log()
    store = TCPStoreServer()
    pgs = [ProcessGroupSocket(timeout=10.0) for _ in range(2)]
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            list(pool.map(
                lambda r: pgs[r].configure(f"{store.address()}/ckpt", r, 2), range(2)
            ))
            state = _sample_state()
            target = _sample_state()
            sender = PGTransport(pgs[0], timeout=10.0, sharded=sharded)
            receiver = PGTransport(
                pgs[1], timeout=10.0, sharded=sharded, state_dict_fn=lambda: target
            )
            fs = pool.submit(sender.send_checkpoint, [1], 2, state, 10)
            fr = pool.submit(receiver.recv_checkpoint, 0, "<n/a>", 2, 10)
            fs.result(timeout=30)
            got = fr.result(timeout=30)
        np.testing.assert_array_equal(np.asarray(got["model"]["w"]), state["model"]["w"].numpy())
    finally:
        for pg in pgs:
            pg.shutdown()
        store.shutdown()
        telemetry.reset_event_log()
    xfers = {x["dir"]: x for x in _xfers(journal)}
    assert set(xfers) == {"send", "recv"}
    assert xfers["send"]["transport"] == xfers["recv"]["transport"] == "pg"
    assert xfers["recv"]["nbytes"] == xfers["send"]["nbytes"] > 0
    assert xfers["recv"]["wire_s"] >= 0 and xfers["recv"]["ser_s"] >= 0
    assert xfers["recv"].get("sharded", False) is sharded
