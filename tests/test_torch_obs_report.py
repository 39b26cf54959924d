"""The port's cross-replica timeline (``torchft_tpu_torch/obs_report.py``)
held to the JAX package's ``tools/obs_report.py``: every subject of
tests/test_observability.py's obs_report tests (merging a directory of
journals, the replica key, heal alignment, the phase breakdown and compute
residual, the heal phase, a row without a gate, the slowest replica, the
stalls, the last goodput event winning, ``render_text``, the native
attribution over mixed and malformed journals, a Manager's journal across
generations of trace ids) and a journal drawn from a fixed numpy seed,
through both tools' functions and ``main``, compared as whole JSON
documents and text, exactly. The port's Manager writes the journal where
the JAX test uses the JAX one. Its comm attribution is the port's
``perf_report``'s on the same journal."""

import copy
import json
import os
import re
import sys
from unittest.mock import MagicMock, patch

import numpy as np
import pytest
import torch

from torchft_tpu_torch import obs_report as port
from torchft_tpu_torch import perf_report as port_perf
from torchft_tpu_torch import telemetry

from test_torch_recovery_report import _main

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
)

import obs_report as ref  # noqa: E402


def _ev(ts, event, step=None, replica_id="0", **attrs):
    return {"ts": ts, "replica_id": replica_id, "step": step, "event": event,
            "attrs": attrs}


def _dump(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


def _phase_breakdown():
    return [
        _ev(10.0, "quorum_start", step=4),
        _ev(10.2, "quorum_ready", step=4, elapsed_s=0.2),
        _ev(10.8, "allreduce_issue", step=4, nbytes=1024),
        _ev(11.0, "allreduce_complete", step=4, ok=True, elapsed_s=0.3),
        _ev(11.1, "commit_gate", step=4, committed=True),
    ]


def _heal_phase():
    return [
        _ev(10.0, "quorum_start", step=0, replica_id="1:u2"),
        _ev(10.1, "quorum_ready", step=0, replica_id="1:u2", elapsed_s=0.1),
        _ev(10.2, "heal_start", step=0, replica_id="1:u2", max_step=0),
        _ev(12.2, "heal_done", step=0, replica_id="1:u2", max_step=0, elapsed_s=2.0),
        _ev(12.5, "commit_gate", step=0, replica_id="1:u2", committed=True),
    ]


def _without_gate():
    return [_ev(1.0, "quorum_start", step=9),
            _ev(1.4, "quorum_ready", step=9, elapsed_s=0.4)]


def _slowest():
    return [
        _ev(1.0, "quorum_start", step=0, replica_id="0"),
        _ev(1.1, "quorum_ready", step=0, replica_id="0", elapsed_s=0.1),
        _ev(1.2, "commit_gate", step=0, replica_id="0", committed=True),
        _ev(1.0, "quorum_start", step=0, replica_id="1"),
        _ev(3.0, "quorum_ready", step=0, replica_id="1", elapsed_s=2.0),
        _ev(3.1, "commit_gate", step=0, replica_id="1", committed=True),
    ]


def _stalls():
    """40 steps so the 95th percentile's rank lands below the one outlier."""
    events = []
    for step in range(40):
        t = float(step * 10)
        wait = 5.0 if step == 7 else 0.01
        events += [
            _ev(t, "quorum_start", step=step),
            _ev(t + wait, "quorum_ready", step=step, elapsed_s=wait),
            _ev(t + wait + 0.1, "commit_gate", step=step, committed=True),
        ]
    return events


def _goodput_last_wins():
    return [
        _ev(1.0, "goodput", replica_id="0:u1", committed_steps=2, failed_commits=1,
            committed_s=2.0, failed_s=1.0, heal_count=0, heal_s=0.0),
        _ev(9.0, "goodput", replica_id="0:u2", committed_steps=5, failed_commits=1,
            committed_s=6.0, failed_s=1.0, heal_count=1, heal_s=1.0),
        _ev(9.5, "goodput", replica_id="1:u9", committed_steps=5, failed_commits=0,
            committed_s=2.0, failed_s=0.0, heal_count=0, heal_s=0.0),
    ]


def _render():
    return [
        _ev(1.0, "quorum_start", step=0, replica_id="0"),
        _ev(1.1, "quorum_ready", step=0, replica_id="0", elapsed_s=0.1),
        _ev(1.2, "commit_gate", step=0, replica_id="0", committed=True),
        _ev(1.0, "quorum_start", step=0, replica_id="1"),
        _ev(2.0, "quorum_ready", step=0, replica_id="1", elapsed_s=1.0),
        _ev(2.1, "commit_gate", step=0, replica_id="1", committed=False),
        _ev(3.0, "goodput", replica_id="0", committed_steps=1, failed_commits=0,
            committed_s=1.0, failed_s=0.0, heal_count=0, heal_s=0.0),
    ]


def _mixed_native():
    """Native-engine replicas, a torn record (null fields), a lane that is
    not an object and a socket-only replica."""
    return [
        _ev(1.0, "native_collective", step=1, replica_id="0",
            lanes=[{"peer": 1, "stripe": 0, "dir": "tx", "bytes": 1 << 20,
                    "t0_ns": 0, "t1_ns": 1_000_000}]),
        _ev(1.1, "native_collective", step=1, replica_id="1",
            lanes=[{"peer": 0, "stripe": 0, "dir": "rx", "bytes": None,
                    "t0_ns": None, "t1_ns": None}]),
        _ev(1.2, "native_collective", step=1, replica_id="2", lanes=["not-a-lane"]),
        _ev(1.3, "commit_gate", step=1, replica_id="3", committed=True),
    ]


def _seeded_fleet():
    """Three replicas, twelve steps with phases drawn from a fixed seed, a
    relaunch of replica 2 (its fresh uuid, its heal aligned to max_step),
    engine records on replicas 0 and 1 with stripes of a seeded length,
    a replica whose records are partly malformed, a failed gate and each
    replica's goodput events (the relaunch's last)."""
    rng = np.random.default_rng(24)
    evs = []
    t = 2000.0
    for step in range(12):
        for g in ("0", "1", "2"):
            rid = f"{g}:{'b' if g == '2' and step >= 6 else 'a'}"
            q, c, ar, w, cm = (float(x) for x in rng.uniform(0.01, 0.3, 5))
            if step == 6 and g == "0":
                q += 4.0  # the survivor waits out replica 2's relaunch
            evs += [
                _ev(t, "quorum_start", step=step, replica_id=rid),
                _ev(t + q, "quorum_ready", step=step, replica_id=rid, elapsed_s=q),
            ]
            if step == 6 and g == "2":
                evs += [_ev(t + q + 0.01, "heal_start", step=0, replica_id=rid, max_step=6),
                        _ev(t + q + 0.5, "heal_done", step=0, replica_id=rid,
                            elapsed_s=0.49, max_step=6)]
                q += 0.5
            evs += [
                _ev(t + q + c, "allreduce_issue", step=step, replica_id=g),
                _ev(t + q + c + ar, "allreduce_complete", step=step, replica_id=g,
                    elapsed_s=min(w, ar)),
                _ev(t + q + c + ar + cm, "commit_gate", step=step, replica_id=rid,
                    committed=not (step == 5 and g == "1")),
            ]
            if g in ("0", "1"):
                ns = int((t + q + c) * 1e9)
                evs.append(_ev(t + q + c + ar, "native_collective", step=step,
                               replica_id=g, op="allreduce", status="ok", lanes=[
                                   {"peer": 1 - int(g), "stripe": s, "dir": d,
                                    "bytes": int(rng.integers(1 << 16, 1 << 20)),
                                    "t0_ns": ns,
                                    "t1_ns": ns + int(rng.integers(1000, 10**6))}
                                   for s in range(4) for d in ("send", "recv")]))
            elif step % 4 == 0:
                evs.append(_ev(t + q, "native_collective", step=step, replica_id=g,
                               lanes=[{"peer": 0, "t0_ns": "x"}] if step else [None]))
        t += 1.0
    for g, rid in (("0", "0:a"), ("1", "1:a"), ("2", "2:a"), ("2", "2:b")):
        evs.append(_ev(t + int(g), "goodput", replica_id=rid,
                       committed_steps=int(rng.integers(5, 12)), failed_commits=1,
                       committed_s=float(rng.uniform(5, 9)), failed_s=0.3,
                       heal_count=int(rid == "2:b"), heal_s=0.49 * (rid == "2:b")))
    return evs


JOURNALS = {
    "phase_breakdown": _phase_breakdown,
    "heal_phase": _heal_phase,
    "without_gate": _without_gate,
    "slowest": _slowest,
    "stalls": _stalls,
    "goodput_last_wins": _goodput_last_wins,
    "render": _render,
    "mixed_native": _mixed_native,
    "seeded_fleet": _seeded_fleet,
}


def _write(path, evs):
    with open(path, "w") as fh:
        for ev in evs:
            fh.write(json.dumps(ev) + "\n")


def test_load_events_merges_dir_sorts_and_skips_garbage(tmp_path):
    """The port's loader is ``telemetry.load_journal``: a directory merges
    time-sorted, garbage and torn lines are skipped, as the JAX tool's."""
    assert port.load_events is telemetry.load_journal
    _write(tmp_path / "a.jsonl", [_ev(2.0, "quorum_start", step=0)])
    with open(tmp_path / "b.jsonl", "w") as fh:
        fh.write(json.dumps(_ev(1.0, "quorum_start", step=0, replica_id="1")))
        fh.write("\n{not json\n")
        fh.write('{"no_event_key": 1}\n')
        fh.write(json.dumps(_ev(3.0, "commit_gate", step=0, replica_id="1")))
    got = port.load_events([str(tmp_path)])
    assert got == ref.load_events([str(tmp_path)])
    assert [e["ts"] for e in got] == [1.0, 2.0, 3.0]


def test_replica_key_and_heal_alignment_are_the_jax_tools():
    """``<group>:<uuid>`` folds onto the group; a heal event files under
    the step it heals to."""
    for rid in ("3:abc-123", "3", "3:other", "x:y:z"):
        ev = _ev(0, "x", replica_id=rid)
        assert telemetry._replica_key(ev) == ref._replica_key(ev)
    assert telemetry._replica_key(_ev(0, "x", replica_id="3:abc")) == "3"
    events = [_ev(1.0, "heal_start", step=0, max_step=7),
              _ev(2.0, "heal_done", step=0, max_step=7, elapsed_s=1.0),
              _ev(3.0, "quorum_start", step=2), _ev(4.0, "goodput")]
    steps = [telemetry._event_step(e) for e in events]
    assert steps == [ref._event_step(e) for e in events] == [7, 7, 2, None]


@pytest.mark.parametrize("journal", sorted(JOURNALS))
def test_timeline_equals_the_jax_tools(journal):
    """``build_timeline`` and each step's ``slowest_replica``."""
    evs = JOURNALS[journal]()
    got = port.build_timeline(copy.deepcopy(evs))
    want = ref.build_timeline(copy.deepcopy(evs))
    assert _dump(got) == _dump(want)
    for step in got:
        assert port.slowest_replica(got[step]) == ref.slowest_replica(want[step])


@pytest.mark.parametrize("journal", sorted(JOURNALS))
def test_rollups_equal_the_jax_tools(journal):
    """``detect_stalls`` at three thresholds, ``goodput_rollup``,
    ``native_stall_attribution`` and ``overlap_rollup`` (the JAX tool's
    with its package importable)."""
    evs = JOURNALS[journal]()
    tl = port.build_timeline(copy.deepcopy(evs))
    for pct, floor in ((95.0, 0.5), (95.0, 10.0), (50.0, 0.0)):
        assert port.detect_stalls(tl, pct, floor) == ref.detect_stalls(tl, pct, floor)
    for fn in ("goodput_rollup", "native_stall_attribution", "overlap_rollup"):
        got = getattr(port, fn)(copy.deepcopy(evs))
        assert _dump(got) == _dump(getattr(ref, fn)(copy.deepcopy(evs))), fn


@pytest.mark.parametrize("journal", sorted(JOURNALS))
def test_render_text_equals_the_jax_tools(journal):
    evs = JOURNALS[journal]()
    texts = []
    for m in (port, ref):
        tl = m.build_timeline(copy.deepcopy(evs))
        texts.append(m.render_text(
            tl, m.detect_stalls(tl, 95.0, 0.5), m.goodput_rollup(evs),
            m.native_stall_attribution(evs), m.overlap_rollup(evs)))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("journal", sorted(JOURNALS))
def test_main_equals_the_jax_tools(journal, tmp_path, capsys):
    """Exit code, stdout and stderr of the text and ``--json`` reports and
    of the stall options."""
    path = tmp_path / "journal.jsonl"
    _write(path, JOURNALS[journal]())
    for argv in ([], ["--json"], ["--stall-pct", "50", "--stall-min-s", "0"],
                 ["--json", "--stall-min-s", "100"]):
        got = _main(port, [str(path), *argv], capsys)
        assert got == _main(ref, [str(path), *argv], capsys), argv
        assert got[0] == 0


def test_main_refusals_equal_the_jax_tools(tmp_path, capsys):
    """No path (argparse's usage error), an empty journal and a path that
    cannot be opened: the same exit and message."""
    empty = tmp_path / "empty.jsonl"
    empty.write_text("{torn\n")
    for argv in ([], [str(empty)], [str(tmp_path / "missing.jsonl"), "--json"]):
        got = _main(port, argv, capsys)
        assert got == _main(ref, argv, capsys), argv
        assert got[0] in (1, ("exit", 2))


def test_the_jax_tests_numbers_read_off_the_port():
    """tests/test_observability.py's pinned numbers, from the port."""
    row = port.build_timeline(_phase_breakdown())[4]["0"]
    assert (row["quorum_s"], row["allreduce_s"]) == (pytest.approx(0.2), pytest.approx(0.3))
    assert row["commit_s"] == pytest.approx(0.1) and row["total_s"] == pytest.approx(1.1)
    assert row["compute_s"] == pytest.approx(0.5) and row["committed"] is True
    heal = port.build_timeline(_heal_phase())[0]["1"]
    assert heal["heal_s"] == pytest.approx(2.0) and heal["commit_s"] == 0.0
    gateless = port.build_timeline(_without_gate())[9]["0"]
    assert gateless["committed"] is None and gateless["total_s"] == pytest.approx(0.4)
    assert port.slowest_replica(port.build_timeline(_slowest())[0]) == ("1", "quorum")
    tl = port.build_timeline(_stalls())
    stalls = port.detect_stalls(tl, 95.0, 0.5)
    assert [(s["step"], s["replica"]) for s in stalls] == [(7, "0")]
    assert port.detect_stalls(tl, 95.0, 10.0) == []
    roll = port.goodput_rollup(_goodput_last_wins())
    assert roll["replicas"] == ["0", "1"] and roll["committed_steps"] == 10
    assert roll["goodput_frac"] == pytest.approx(0.8)
    native = port.native_stall_attribution(_mixed_native())
    assert native["0"]["peer"] == 1 and native["0"]["gib_s"] > 0
    assert native["1"]["gib_s"] == 0.0 and native["2"] == {"skipped": 1}
    assert "3" not in native
    text = port.render_text({}, [], {}, native)
    assert "replica 2: attribution degraded" in text
    assert "replica 0: bounded by peer 1" in text
    lines = port.render_text(port.build_timeline(_render()), [],
                             port.goodput_rollup(_render())).splitlines()
    slow = [ln for ln in lines if "<- slowest (quorum)" in ln]
    assert len(slow) == 1 and " 1 " in slow[0]
    assert any("FAIL" in ln for ln in lines) and any("goodput rollup:" in ln for ln in lines)


@pytest.mark.parametrize("journal", ["seeded_fleet", "phase_breakdown", "heal_phase"])
def test_overlap_rollup_is_perf_reports(journal):
    """The comm attribution line reads the rows ``perf_report`` reads: the
    same row count, its overlap fraction and exposed seconds to 4 places."""
    evs = JOURNALS[journal]()
    got = port.overlap_rollup(copy.deepcopy(evs))
    s = port_perf.analyze(copy.deepcopy(evs))["summary"]
    assert got["rows"] == s["num_rows"]
    want = None if s["overlap_frac"] is None else round(s["overlap_frac"], 4)
    assert got["overlap_frac"] == want
    assert got["comm_exposed_s"] == round(s["allreduce_s"], 4)
    assert got["exposed_comm_frac"] == round(s["exposed_allreduce_frac"], 4)


# -- a journal that the port's Manager writes ----------------------------------------


def _port_manager(pg):
    """The port's Manager with its control plane mocked (the JAX test's
    ``make_manager``): quorum 1 at step 0, the local vote echoed."""
    from torchft_tpu_torch.coordination import QuorumResult
    from torchft_tpu_torch.manager import Manager

    transport = MagicMock()
    transport.metadata.return_value = "http://127.0.0.1:0"
    with patch("torchft_tpu_torch.manager.ManagerServer") as server_cls, patch(
        "torchft_tpu_torch.manager.ManagerClient"
    ) as client_cls:
        server_cls.return_value.address.return_value = "127.0.0.1:1"
        client = client_cls.return_value
        client._quorum.return_value = _quorum(QuorumResult, 1, 0)
        client.should_commit.side_effect = (
            lambda rank, step, ok, timeout=None, trace_id="": ok
        )
        client.drain_status.return_value = False
        m = Manager(pg=pg, checkpoint_transport=transport, replica_id="test",
                    lighthouse_addr="unused:1", group_rank=0, group_world_size=1,
                    use_async_quorum=True)
    m._test_client = client
    return m, QuorumResult


def _quorum(cls, quorum_id, max_step):
    return cls(quorum_id=quorum_id, replica_rank=0, replica_world_size=2,
               recover_src_manager_address="", recover_src_replica_rank=None,
               recover_dst_replica_ranks=[], store_address="127.0.0.1:1234",
               max_step=max_step, max_replica_rank=0, max_world_size=2,
               heal=False, commit_failures=0)


def test_the_port_managers_journal_across_generations(tmp_path, monkeypatch, capsys):
    """Two quorum generations of the port's Manager (the second at a later
    step, as after a kill and heal): each journals its trace id on the
    full step cycle, the first ``quorum_start`` carries none, and both
    tools give the same timeline (two committed rows), report and text."""
    from torchft_tpu_torch.process_group import ProcessGroupDummy

    path = str(tmp_path / "journal.jsonl")
    monkeypatch.setenv("TORCHFT_JOURNAL_FILE", path)
    telemetry.reset_event_log()
    try:
        m, result_cls = _port_manager(ProcessGroupDummy())
        try:
            m.start_quorum()
            m.allreduce(torch.ones(4)).wait()
            assert m.should_commit()
            m._test_client._quorum.return_value = _quorum(result_cls, 2, 5)
            m.start_quorum()
            m.allreduce(torch.ones(4)).wait()
            assert m.should_commit()
            assert m._trace_id == "q2.s5"
            rpc = [c.kwargs["trace_id"] for c in m._test_client._quorum.call_args_list]
            assert rpc == ["", "q1.s0"]
        finally:
            m.shutdown()
    finally:
        telemetry.reset_event_log()

    rows = [json.loads(line) for line in open(path)]
    by_trace = {}
    for r in rows:
        if r.get("trace"):
            by_trace.setdefault(r["trace"], set()).add(r["event"])
    assert set(by_trace) == {"q1.s0", "q2.s5"}
    for tid, names in by_trace.items():
        assert re.fullmatch(r"q\d+\.s\d+", tid)
        assert {"quorum_ready", "allreduce_issue", "allreduce_complete",
                "commit_gate"} <= names
    assert "trace" not in next(r for r in rows if r["event"] == "quorum_start")

    events = port.load_events([path])
    assert {"quorum_start", "quorum_ready", "allreduce_issue", "allreduce_complete",
            "commit_gate", "goodput"} <= {e["event"] for e in events}
    tl = port.build_timeline(events)
    assert _dump(tl) == _dump(ref.build_timeline(ref.load_events([path])))
    rid = telemetry._replica_key(events[0])
    assert tl[0][rid]["committed"] is True and tl[0][rid]["total_s"] >= 0.0
    for argv in ([path], [path, "--json"]):
        assert _main(port, argv, capsys) == _main(ref, argv, capsys)


def test_the_four_readers_run_with_jax_blocked(tmp_path):
    """``python -m torchft_tpu_torch.obs_report``, ``.goodput_report``,
    ``.detect_report`` and ``.obs_trace`` in processes where ``jax``,
    ``flax``, ``optax`` and ``torchft_tpu`` cannot be imported, as on the
    card, exit 0 on a synthetic journal (the BENCH_r05 steps, the kill/heal
    episode, a ledger, a chaos injection) without importing torch. The
    report keeps its comm-attribution line and the trace its ``recovery``
    track: what the JAX tools drop where their package is missing."""
    import subprocess

    from test_recovery import kill_heal_fixture
    from test_torch_goodput_report import _kill_heal_with_ledgers
    from test_torch_perf_report import BLOCKED_RUN, _bench_r05

    journal = tmp_path / "journal"
    journal.mkdir()
    evs = _bench_r05() + _kill_heal_with_ledgers() + [
        _ev(104.5, "chaos_inject", replica_id="1", kind="abort_heal", site="1",
            plane="heal")]
    _write(journal / "journal_replica0_rank0.jsonl", evs)
    trace = tmp_path / "trace.json"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = {}
    for module, args in (
        ("obs_report", []),
        ("goodput_report", ["--check", "--min-windows", "25"]),
        ("detect_report", ["--check", "--min-injections", "2"]),
        ("obs_trace", ["--check", "-o", str(trace)]),
    ):
        proc = subprocess.run(
            [sys.executable, "-c", BLOCKED_RUN, f"torchft_tpu_torch.{module}",
             str(journal), *args],
            capture_output=True, text=True, timeout=120, cwd=repo,
            env={**os.environ, "PYTHONPATH": repo},
        )
        assert proc.returncode == 0, module + proc.stdout[-2000:] + proc.stderr[-2000:]
        out = proc.stdout.splitlines()
        assert out[-1] == "torch not imported", module
        outs[module] = out[:-1]
    assert any(ln.startswith("comm attribution: exposed_comm_frac=") for ln in outs["obs_report"])
    assert outs["goodput_report"][-1].startswith("goodput_report check OK: 25 window(s)")
    assert outs["detect_report"][-1].startswith("detect_report check OK: 2 injection(s)")
    assert outs["obs_trace"] == [f"wrote {trace}: " + outs["obs_trace"][0].split(": ", 1)[1]]
    doc = json.loads(trace.read_text())
    assert any(e["name"] == "thread_name" and e["args"]["name"] == "recovery"
               for e in doc["traceEvents"])
    assert any(e.get("cat") == "episode" and e["ph"] == "X" for e in doc["traceEvents"])


def test_the_exporter_and_dashboard_run_with_jax_blocked(tmp_path):
    """``python -m torchft_tpu_torch.obs_export --once --journal <journal>``
    and ``python -m torchft_tpu_torch.obs_top --help`` in processes where
    ``jax``, ``flax``, ``optax`` and ``torchft_tpu`` cannot be imported, as
    on the card, exit 0 without importing torch; the exporter prints the
    native engine's gauges of a synthetic journal of ``native_counters``
    events, the JAX tool's text."""
    import subprocess

    from test_torch_obs_export import _counters_journal
    from test_torch_perf_report import BLOCKED_RUN

    import obs_export

    journal = _counters_journal(str(tmp_path / "journal"), 4)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = {}
    for module, args in (("obs_export", ["--once", "--journal", journal]),
                         ("obs_top", ["--help"])):
        proc = subprocess.run(
            [sys.executable, "-c", BLOCKED_RUN, f"torchft_tpu_torch.{module}", *args],
            capture_output=True, text=True, timeout=120, cwd=repo,
            env={**os.environ, "PYTHONPATH": repo},
        )
        assert proc.returncode == 0, module + proc.stdout[-2000:] + proc.stderr[-2000:]
        out = proc.stdout.splitlines()
        assert out[-1] == "torch not imported", module
        outs[module] = out[:-1]
    want = obs_export.render_native_prometheus(
        obs_export.latest_native_counters(ref.load_events([journal])))
    assert outs["obs_export"] == want.splitlines()
    assert any(ln.startswith("torchft_exporter_native_peer_gib_s{") for ln in outs["obs_export"])
    assert outs["obs_top"][0].startswith("usage: ")
    assert any("--ttr-budget" in ln for ln in outs["obs_top"])
