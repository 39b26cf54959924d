"""The port's failure-evidence plane, held to tests/test_evidence.py: signals
carried on the port client's heartbeats land in the shared lighthouse's
ring (attribution on the subject's row, the closed ``SIGNAL_SOURCES`` enum,
``proc_death`` on a corpse's leave and none on a planned drain, cadence
eviction as ``hb_lapse`` for declared cadences only, ring overflow
counted); the port's manager client queues signals that ride the
heartbeat and reads the acked cursor back; the port's ``_EvidenceWatcher``
takes the JAX watcher's decisions on the same acks; journals written by the
port's ``EventLog`` read through the shared tools (``obs_export``,
``obs_top``, ``detect_report``, ``recovery_report``) as the JAX package's
do; and a miniature detect drill on the port's client finds each fault's
expected first source. Live and mixed: a port Manager blocked in an
allreduce beside a wedged JAX peer is aborted by its evidence watcher on
the peer's ``proc_death``, in seconds instead of the collective timeout."""

import json
import os
import sys
import threading
import time
import urllib.request

import pytest
import torch

from torchft_tpu import manager as jmanager
from torchft_tpu import telemetry as jtelemetry
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch import telemetry
from torchft_tpu_torch.coordination import (
    LighthouseClient,
    LighthouseServer,
    ManagerClient,
    ManagerServer,
)
from torchft_tpu_torch.telemetry import SIGNAL_SOURCES, EventLog

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

import detect_drill  # noqa: E402
import detect_report  # noqa: E402
import obs_export  # noqa: E402
import obs_top  # noqa: E402
import recovery_report  # noqa: E402

from torchft_tpu_torch import obs_export as port_export  # noqa: E402
from torchft_tpu_torch import obs_top as port_top  # noqa: E402

pytestmark = pytest.mark.timeout(60)


def _lighthouse(**kw):
    return LighthouseServer(min_replicas=2, join_timeout_ms=200, quorum_tick_ms=20,
                            fleet_snap_ms=0, **kw)


@pytest.fixture
def lighthouse():
    server = _lighthouse()
    yield server
    server.shutdown()


def _wait(pred, deadline_s=10.0, tick_s=0.05):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(tick_s)
    pytest.fail(f"condition not met within {deadline_s}s: {pred}")


def _dg(step, rate, cf=0):
    d = {"v": 1, "step": step, "rate": rate, "gp": 1.0, "err": 0}
    if cf:
        d["cf"] = cf
    return d


def _sig(source, subject="", site="", detail=None):
    s = {"source": source}
    if subject:
        s["replica_id"] = subject
    if site:
        s["site"] = site
    if detail is not None:
        s["detail"] = detail
    return s


# -- the signal bus ----------------------------------------------------------------


def test_heartbeat_piggyback_signal_ingested(lighthouse):
    c = LighthouseClient(lighthouse.address())
    c.heartbeat("alive", digest=_dg(1, 1.0), hb_interval_ms=60000)
    c.heartbeat("victim", digest=_dg(1, 1.0), hb_interval_ms=60000)
    c.heartbeat("alive", digest=_dg(2, 1.0), hb_interval_ms=60000,
                signals=[_sig("native_abort", subject="victim", site="manager:alive",
                              detail={"msg": "abort"})])
    fleet = c.fleet()
    assert fleet["signal_seq"] == 1
    [rec] = fleet["signals"]
    assert (rec["source"], rec["replica_id"], rec["site"], rec["seq"]) == (
        "native_abort", "victim", "manager:alive", 1)
    assert rec["ts_ms"] > 0
    assert fleet["signal_counts"] == {"native_abort": 1}
    assert fleet["replicas"]["victim"]["signal"] == "native_abort"
    assert fleet["replicas"]["victim"]["signal_age_ms"] >= 0
    assert fleet["replicas"]["alive"]["signal"] is None
    assert "victim" in fleet["replicas"]  # evidence never evicts
    c.close()


def test_unknown_signal_source_dropped(lighthouse):
    c = LighthouseClient(lighthouse.address())
    c.heartbeat("r0", digest=_dg(1, 1.0), hb_interval_ms=60000,
                signals=[_sig("made_up_source", subject="r0"), _sig("rpc_error", subject="r0")])
    fleet = c.fleet()
    assert fleet["signal_seq"] == 1
    assert [r["source"] for r in fleet["signals"]] == ["rpc_error"]
    assert set(fleet["signal_counts"]) <= set(SIGNAL_SOURCES)
    c.close()


def test_dead_leave_signals_proc_death_planned_drain_does_not(lighthouse):
    c = LighthouseClient(lighthouse.address())
    c.heartbeat("planned", digest=_dg(1, 1.0), hb_interval_ms=60000)
    c.heartbeat("corpse", digest=_dg(1, 1.0), hb_interval_ms=60000)
    c.leave("planned")
    assert c.fleet()["signal_seq"] == 0
    c.leave("corpse", reason="trainer died")
    fleet = c.fleet()
    assert fleet["signal_seq"] == 1
    [rec] = fleet["signals"]
    assert (rec["source"], rec["replica_id"], rec["site"]) == (
        "proc_death", "corpse", "lighthouse.leave")
    assert "corpse" not in fleet["replicas"] and "planned" not in fleet["replicas"]
    c.close()


def test_hb_lapse_evicts_declared_cadence_only(monkeypatch):
    """A replica that declared a heartbeat cadence and blew its evidence
    budget is evicted with ``hb_lapse``; a client that declared none keeps
    the timeout path."""
    monkeypatch.setenv("TORCHFT_LH_EVICT_FLOOR_MS", "400")
    server = _lighthouse(heartbeat_timeout_ms=60000)
    try:
        c = LighthouseClient(server.address())
        c.heartbeat("modern", digest=_dg(1, 1.0), hb_interval_ms=50)
        c.heartbeat("legacy", digest=_dg(1, 1.0))
        fleet = _wait(lambda: (lambda f: f if any(
            r["source"] == "hb_lapse" for r in f.get("signals") or []) else None)(c.fleet()))
        lapse = [r for r in fleet["signals"] if r["source"] == "hb_lapse"]
        assert [r["replica_id"] for r in lapse] == ["modern"]
        assert lapse[0]["site"] == "lighthouse.fleet_scan"
        assert lapse[0]["detail"]["gap_ms"] > lapse[0]["detail"]["budget_ms"]
        assert fleet["replicas"]["modern"]["signal"] == "hb_lapse"
        assert fleet["replicas"]["legacy"]["signal"] is None
        # Rise edge only: later scans do not signal the same lapse again.
        seq = fleet["signal_seq"]
        time.sleep(0.5)  # the span under test: 25 scan ticks of 20 ms
        fleet = c.fleet()
        assert fleet["signal_seq"] == seq
        assert [r["replica_id"] for r in fleet["signals"] if r["source"] == "hb_lapse"] == [
            "modern"]
        c.close()
    finally:
        server.shutdown()


def test_signal_ring_overflow_is_counted(lighthouse):
    c = LighthouseClient(lighthouse.address())
    c.heartbeat("rep", digest=_dg(1, 1.0), hb_interval_ms=60000)
    for i in range(70):
        c.heartbeat("rep", digest=_dg(i + 2, 1.0), hb_interval_ms=60000,
                    signals=[_sig("rpc_error", subject="rep", site=f"client:{i}")])
    fleet = c.fleet()
    assert fleet["signal_seq"] == 70 and len(fleet["signals"]) == 64
    assert fleet["agg"]["signals_dropped"] == 6
    assert fleet["signals"][-1]["seq"] == 70 and fleet["signals"][0]["seq"] == 7
    assert fleet["signal_counts"]["rpc_error"] == 70
    with urllib.request.urlopen(f"http://{lighthouse.address()}/metrics", timeout=5) as resp:
        metrics = resp.read().decode()
    assert "torchft_lighthouse_signals_total 70" in metrics
    assert 'torchft_lighthouse_signals_total{source="rpc_error"} 70' in metrics
    assert "torchft_lighthouse_signals_dropped 6" in metrics
    c.close()


# -- the shared tools on the port's journal ------------------------------------------

SIGNAL_FLEET = {
    "job": "default", "signal_seq": 3,
    "agg": {"n": 2, "stragglers": 0, "anomalies_dropped": 0, "signals_dropped": 2},
    "replicas": {}, "anomalies": [],
    "signal_counts": {"proc_death": 1, "rpc_error": 2},
    "signals": [
        {"seq": 2, "source": "rpc_error", "replica_id": "r1", "site": "client:heartbeat",
         "ts_ms": 100},
        {"seq": 3, "source": "proc_death", "replica_id": "r0", "site": "lighthouse.leave",
         "ts_ms": 200},
    ],
}


def _exporter_journal(log_cls, path, exporter=obs_export):
    fleet = json.loads(json.dumps(SIGNAL_FLEET))
    log = log_cls(str(path), replica_id="exporter")
    cursor = exporter.journal_signals(log, fleet, 0)
    assert cursor == 3 and exporter.journal_signals(log, fleet, cursor) == 3
    mark = exporter.journal_signal_overflow(log, fleet, 0)
    assert mark == 2 and exporter.journal_signal_overflow(log, fleet, mark) == 2
    fleet["agg"]["signals_dropped"] = 5
    assert exporter.journal_signal_overflow(log, fleet, mark) == 5
    log.close()
    return [{k: v for k, v in json.loads(line).items() if k != "ts"}
            for line in open(path)]


def test_obs_export_journals_signals_through_the_port_event_log(tmp_path):
    """The JAX tool on the port's ``EventLog``, and the port's exporter
    (``torchft_tpu_torch.obs_export``) beside it: the same journal and the
    same gauges."""
    lines = _exporter_journal(EventLog, tmp_path / "port.jsonl")
    assert lines == _exporter_journal(jtelemetry.EventLog, tmp_path / "jax.jsonl")
    assert lines == _exporter_journal(EventLog, tmp_path / "twin.jsonl", port_export)
    assert port_export.render_fleet_prometheus(SIGNAL_FLEET, max_replicas=64) == \
        obs_export.render_fleet_prometheus(SIGNAL_FLEET, max_replicas=64)
    assert port_export.journal_signals(None, None, 7) == 7
    assert port_export.journal_signal_overflow(None, None, 7) == 7
    assert [ln["event"] for ln in lines] == [
        "failure_signal", "failure_signal", "signal_overflow", "signal_overflow"]
    assert lines[0]["attrs"]["source"] == "rpc_error"
    assert lines[1]["attrs"]["subject"] == "r0"
    assert [ln["attrs"]["new_drops"] for ln in lines[2:]] == [2, 3]
    text = obs_export.render_fleet_prometheus(SIGNAL_FLEET, max_replicas=64)
    assert 'torchft_exporter_fleet_signals_total{job="default"} 3' in text
    assert 'torchft_exporter_fleet_signals_dropped{job="default"} 2' in text
    assert obs_export.journal_signals(None, None, 7) == 7
    assert obs_export.journal_signal_overflow(None, None, 7) == 7


def test_obs_top_signal_column_on_a_live_port_fleet(lighthouse):
    """The SIGNAL column and the recent-signals tail render from a fleet
    that the port's client fed, and pass ``--once --check``'s validation."""
    c = LighthouseClient(lighthouse.address())
    c.heartbeat("r0", digest=_dg(5, 1.0), hb_interval_ms=60000)
    c.heartbeat("r1", digest=_dg(5, 1.0), hb_interval_ms=60000,
                signals=[_sig("rpc_error", subject="r0", site="client:x")])
    c.heartbeat("r1", digest=_dg(6, 1.0), hb_interval_ms=60000,
                signals=[_sig("native_abort", subject="r0", site="manager:r1")])
    fleet = c.fleet()
    c.close()
    frame = obs_top.render(fleet, color=False)
    assert obs_top.check_frame(fleet, frame) == []
    assert "signals=2" in frame.splitlines()[0]
    r0 = next(ln for ln in frame.splitlines() if ln.startswith("r0"))
    assert "native_abort" in r0
    assert "#2 native_abort subject=r0 site=manager:r1" in frame
    broken = frame.replace("native_abort", "-")
    assert any("SIGNAL column" in p or "recent-signals" in p
               for p in obs_top.check_frame(fleet, broken))
    # The port's dashboard beside the JAX tool: the same frames and problems.
    assert port_top.render(fleet, color=False) == frame
    assert port_top.render(fleet, color=True) == obs_top.render(fleet, color=True)
    assert port_top.check_frame(fleet, frame) == []
    assert port_top.check_frame(fleet, broken) == obs_top.check_frame(fleet, broken)


# -- the manager's evidence RPCs -------------------------------------------------------


def test_manager_signal_rpc_relays_to_lighthouse(lighthouse):
    """A signal queued with the port's manager client rides the heartbeat
    into the lighthouse ring, and the ack moves the evidence cursor."""
    mgr = ManagerServer(replica_id="g0", lighthouse_addr=lighthouse.address(),
                        store_address="127.0.0.1:0", world_size=1, heartbeat_interval_ms=50)
    try:
        mc = ManagerClient(mgr.address())
        st = mc.evidence_status()
        assert st["signal_seq"] == 0 and st["outbox"] == 0
        mc.signal("native_abort", replica_id="g1", site="trainer:g0", detail={"msg": "wedged"})
        st = _wait(lambda: (lambda s: s if s["signal_seq"] >= 1 and s["outbox"] == 0 else None)(
            mc.evidence_status()))
        assert (st.get("signal") or {}).get("source") == "native_abort"
        lc = LighthouseClient(lighthouse.address())
        assert any(r["source"] == "native_abort" and r["replica_id"] == "g1"
                   for r in lc.fleet()["signals"])
        lc.close()
        with pytest.raises(Exception):
            mc.signal("")
        mc.close()
    finally:
        mgr.shutdown()


# -- the trainer's evidence watcher ------------------------------------------------------

ACKS = [
    {"ok": True},
    {"ok": True},
    {"ok": True, "signal_seq": 1, "signal": {"source": "rpc_error", "replica_id": "peer"}},
    {"ok": True, "signal_seq": 2, "signal": {"source": "proc_death", "replica_id": "self"}},
    {"ok": True, "signal_seq": 3, "signal": {"source": "hb_lapse", "replica_id": "peer:dead-uuid"}},
    {"ok": True, "signal_seq": 4, "signal": {"source": "proc_death", "replica_id": "peer"}},
    {"ok": True, "signal_seq": 5, "signal": {"source": "native_abort", "replica_id": "peer"}},
]


def _watch(module):
    """The watcher of ``module`` polled once for each of ``ACKS``: its
    cursor and the manager's abort count after each poll, and the journal."""

    class FakeManager:
        _replica_id = "self"
        _evidence_peers = {"self", "peer"}

        def __init__(self):
            self.aborts = 0
            self.journal = []

        def _journal(self, event, **attrs):
            self.journal.append((event, attrs))

        class _logger:  # noqa: N801 - attribute shim
            @staticmethod
            def info(msg):
                pass

        def _abort_pg_on_stall(self):
            self.aborts += 1

    class FakeClient:
        def __init__(self, responses):
            self.responses = list(responses)

        def evidence_status(self, timeout=1.0):
            return self.responses.pop(0)

    mgr = FakeManager()
    w = module._EvidenceWatcher.__new__(module._EvidenceWatcher)
    w._manager, w._poll_s, w._base_seq, w._fired = mgr, 0.01, None, False
    w._client = FakeClient(ACKS)
    trace = []
    for _ in ACKS:
        w._poll_once()
        trace.append((w._base_seq, mgr.aborts))
    return trace, mgr.journal


def test_evidence_watcher_takes_the_jax_watchers_decisions():
    """Old-server acks neither fire nor crash it; soft, self and
    non-member signals only move the cursor; one hard signal about a
    current peer fires exactly once."""
    trace, journal = _watch(tmanager)
    assert (trace, journal) == _watch(jmanager)
    assert trace == [(0, 0), (0, 0), (1, 0), (2, 0), (3, 0), (3, 1), (3, 1)]
    assert [e for e, _ in journal] == ["failure_signal"]
    assert journal[0][1]["reaction"] == "pg_abort"


@pytest.mark.timeout(120)
def test_watcher_aborts_a_port_allreduce_wedged_by_a_dead_jax_peer(tmp_path, monkeypatch):
    """A JAX and a port Manager form one quorum; the JAX replica never
    issues its allreduce (wedged), so the port replica's blocks. Once the
    JAX replica's leave is filed as a corpse's, the ``proc_death`` signal
    reaches the port manager server on a heartbeat ack and the port's
    watcher aborts its group: the allreduce fails in seconds against a
    30 s collective timeout, the gate does not commit, and the port's
    journal holds the watcher's ``failure_signal``."""
    from torchft_tpu.manager import Manager as JManager
    from torchft_tpu.process_group import ProcessGroupSocket as JSocket
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.process_group import ProcessGroupSocket

    path = tmp_path / "journal.jsonl"
    monkeypatch.setenv("TORCHFT_JOURNAL_FILE", str(path))
    telemetry.reset_event_log()
    server = _lighthouse()
    kw = dict(min_replica_size=2, use_async_quorum=False, timeout=30.0, quorum_timeout=30.0,
              lighthouse_addr=server.address(), group_rank=0, group_world_size=1,
              init_sync=False)
    wedged, release = threading.Event(), threading.Event()
    jax_id = []

    def jax_replica():
        m = JManager(pg=JSocket(timeout=30.0), replica_id="ev0", **kw)
        try:
            m.start_quorum()
            jax_id.append(m._replica_id)
            wedged.set()
            release.wait(60)
        finally:
            m.shutdown()

    t = threading.Thread(target=jax_replica, daemon=True)
    t.start()
    port = Manager(pg=ProcessGroupSocket(timeout=30.0), replica_id="ev1", **kw)
    try:
        port.start_quorum()
        assert wedged.wait(30)
        assert jax_id[0] in port._evidence_peers
        lc = LighthouseClient(server.address())

        def file_the_corpse():
            # Once the port replica is blocked in its allreduce.
            time.sleep(0.5)
            lc.leave(jax_id[0], reason="trainer died")

        killer = threading.Thread(target=file_the_corpse, daemon=True)
        killer.start()
        t0 = time.monotonic()
        port.allreduce(torch.ones(1 << 12)).wait()
        elapsed = time.monotonic() - t0
        killer.join(10)
        lc.close()
        assert elapsed < 15.0, elapsed
        assert port.errored() is not None
        assert not port.should_commit()
    finally:
        release.set()
        port.shutdown()
        t.join(60)
        server.shutdown()
        telemetry.reset_event_log()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    fired = [e["attrs"] for e in events
             if e["event"] == "failure_signal" and e.get("replica_id", "").startswith("ev1")]
    assert fired and fired[0]["source"] == "proc_death"
    assert fired[0]["subject"] == jax_id[0] and fired[0]["reaction"] == "pg_abort"


# -- detection: a miniature drill on the port's client --------------------------------


def _first_signal(client, subject, after_seq, deadline_s=5.0):
    def find():
        for rec in client.fleet().get("signals") or []:
            if rec["seq"] > after_seq and rec.get("replica_id") == subject:
                return rec
        return None

    return _wait(find, deadline_s, 0.02)


def port_detect_drill(path, monkeypatch) -> None:
    """The detect drill's seeded plan (one fault of each kind), injected
    through the port's lighthouse client, journaled to ``path`` by the
    port's ``EventLog`` (the injections and the exporter's
    ``failure_signal`` lines). Asserts each victim's first signal comes
    from the kind's expected source."""
    monkeypatch.setenv("TORCHFT_LH_EVICT_FLOOR_MS", str(detect_drill.EVICT_FLOOR_MS))
    plan = detect_drill.fault_schedule(4242, len(detect_drill.EXPECTED_SOURCE))
    assert plan == detect_drill.fault_schedule(4242, len(detect_drill.EXPECTED_SOURCE))
    assert {f["kind"] for f in plan} == set(detect_drill.EXPECTED_SOURCE)
    server = _lighthouse()
    log = EventLog(str(path), replica_id="drill")
    c = LighthouseClient(server.address())
    try:
        for i, f in enumerate(plan):
            victim = f["victim"]
            for step in range(2):
                c.heartbeat(victim, digest=_dg(step + 1, 1.0), hb_interval_ms=50)
                c.heartbeat(f"ok{i}", digest=_dg(step + 1, 1.0), hb_interval_ms=60000)
            seq = c.fleet()["signal_seq"]
            log.emit("chaos_inject", kind=f["kind"], plane="detect", site=victim,
                     expected_source=f["expected_source"])
            if f["kind"] == "hb_stop":
                pass  # no more frames: the cadence scan must notice
            elif f["kind"] == "digest_stall":
                c.heartbeat(victim, digest=_dg(3, 1.0, cf=5), hb_interval_ms=60000)
            elif f["kind"] == "dead_leave":
                c.leave(victim, reason="trainer died")
            else:
                c.heartbeat(f"ok{i}", digest=_dg(3, 1.0), hb_interval_ms=60000,
                            signals=[_sig("native_abort", subject=victim, site=f"manager:ok{i}")])
            rec = _first_signal(c, victim, seq)
            assert rec["source"] == f["expected_source"], (f, rec)
            obs_export.journal_signals(log, c.fleet(), seq)
    finally:
        c.close()
        log.close()
        server.shutdown()


@pytest.mark.timeout(90)
def test_detect_drill_on_the_port_client_finds_each_expected_source(tmp_path, monkeypatch):
    """The detect drill on the port's client (``port_detect_drill``): the
    journal passes ``detect_report --require-detected``, every expected
    source first."""
    path = tmp_path / "detect.jsonl"
    port_detect_drill(path, monkeypatch)
    report = detect_report.analyze(telemetry.load_journal([str(path)]))
    assert detect_report.check(report, require_detected=True) == []
    assert sorted(r["source"] for r in report["rows"]) == sorted(
        detect_drill.EXPECTED_SOURCE.values())


def test_detect_and_recovery_reports_read_the_port_journal(tmp_path):
    """The attribution reports give the same answers on a journal that the
    port's ``EventLog`` wrote as on the events themselves."""
    base = 1000.0
    events = [
        ("drill", "chaos_inject", base, {"kind": "hb_stop", "plane": "detect", "site": "r1",
                                         "expected_source": "hb_lapse"}),
        ("exporter", "failure_signal", base + 0.6, {"source": "hb_lapse", "subject": "r1",
                                                     "site": "lighthouse.fleet_scan", "seq": 1}),
        ("r0", "quorum_ready", base + 0.9, {"quorum_id": 2}),
        ("r1", "heal_attempt", base + 1.4, {}),
        ("drill", "chaos_inject", base + 10.0, {"kind": "digest_stall", "plane": "detect",
                                                "site": "r2",
                                                "expected_source": "digest_anomaly"}),
        ("runner", "failure_signal", 99.5, {"source": "proc_death", "subject": "r1",
                                            "site": "runner.monitor"}),
    ]
    path = tmp_path / "j.jsonl"
    logs = {}
    for rid, event, ts, attrs in events:
        log = logs.setdefault(rid, EventLog(str(path), replica_id=rid))
        log.emit(event, **attrs)
    for log in logs.values():
        log.close()
    lines = telemetry.load_journal([str(path)])
    assert [(e["replica_id"], e["event"], e.get("attrs", {})) for e in lines] == [
        (rid, event, attrs) for rid, event, _, attrs in events]
    for line, (_, _, ts, _) in zip(lines, events):
        line["ts"] = ts  # the events' own clock
    report = detect_report.analyze(lines)
    row = report["rows"][0]
    assert row["source"] == "hb_lapse"
    assert row["signal_s"] == pytest.approx(0.6)
    assert row["quorum_s"] == pytest.approx(0.3)
    assert row["react_s"] == pytest.approx(0.5)
    assert report["rows"][1]["source"] is None
    assert detect_report.check(report) == []
    episodes = [{"id": "e0", "open": False, "t_start": 100.0, "t_end": 106.0, "ttr_s": 6.0,
                 "primary": "r1", "replicas": {}, "root_cause": {"kind": "chaos"},
                 "cascade": []}]
    recovery_report.attribute_detect(lines, episodes)
    assert episodes[0]["detect_signal"]["source"] == "proc_death"
    assert episodes[0]["detect_signal"]["lead_s"] == pytest.approx(0.5)
