"""The port's control-plane exporter (``torchft_tpu_torch.obs_export``) held
to the JAX package's ``tools/obs_export.py``: each exporter subject of
tests/test_observability.py, tests/test_goodput.py and tests/test_evidence.py
through both tools, compared as strings (Prometheus text) and as journaled
events (every field but the wall-clock ``ts``); the native engine's
``native_counters`` gauges at one and four streams; the serving path
(``_Exporter`` behind ``_make_handler``) and ``main`` over a live lighthouse
fed by the port's client."""

import copy
import json
import os
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

from torchft_tpu import telemetry as jtelemetry
from torchft_tpu_torch import obs_export as texport
from torchft_tpu_torch import telemetry
from torchft_tpu_torch.coordination import LighthouseClient
from torchft_tpu_torch.telemetry import BADPUT_KINDS

from test_torch_fleet import _SEQ, _dg, lighthouse  # noqa: F401 - the fixture

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

import obs_export as jexport  # noqa: E402
import obs_report  # noqa: E402
from test_observability import (  # noqa: E402
    _composite_fleet,
    _fake_fleet,
    _sample,
    _synthetic_fleet,
)

pytestmark = pytest.mark.timeout(60)


def _both(fn):
    """``fn(module)`` for the port's exporter and the JAX tool; asserts the
    two are equal and returns the port's."""
    port, ref = fn(texport), fn(jexport)
    assert port == ref
    return port


def _journal(module, path, fn):
    """Runs ``fn(module, log)`` with an exporter ``EventLog`` of the
    module's package at ``path``; returns (``fn``'s value, the journal's
    events without ``ts``)."""
    log_cls = telemetry.EventLog if module is texport else jtelemetry.EventLog
    log = log_cls(str(path), replica_id="exporter")
    value = fn(module, log)
    log.close()
    with open(path) as f:
        return value, [{k: v for k, v in json.loads(line).items() if k != "ts"}
                       for line in f]


def _both_journals(tmp_path, fn):
    port = _journal(texport, tmp_path / "port.jsonl", fn)
    ref = _journal(jexport, tmp_path / "jax.jsonl", fn)
    assert port == ref
    return port


# -- tests/test_observability.py: Prometheus rendering ----------------------------------

SAMPLES = {
    "gauges_and_labels": _sample(),
    "escaped_label_values": _sample(heartbeat_ages_ms={'we"ird\\id': 7}, member_steps={}),
    "empty": _sample(heartbeat_ages_ms={}, member_steps={}, heartbeat_age_max_ms=0),
}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_render_prometheus_is_the_tools(name):
    text = _both(lambda m: m.render_prometheus(SAMPLES[name]))
    if name == "escaped_label_values":
        assert 'torchft_exporter_heartbeat_age_ms{replica="we\\"ird\\\\id"} 7' in text
    else:
        assert text.endswith("\n")


def test_exporter_up_gauge_tracks_scrape_health_as_the_tool():
    def run(m):
        ex = m._Exporter()
        bodies = [ex.render()]
        ex.update(_sample())
        bodies.append(ex.render())
        ex.fail("connection refused")
        bodies.append(ex.render())
        ex.update(_sample(quorum_id=4), _fake_fleet())
        bodies.append(ex.render())
        return bodies

    bodies = _both(run)
    assert "torchft_exporter_up 0" in bodies[0] and "torchft_exporter_up 1" in bodies[1]
    assert "torchft_exporter_up 0" in bodies[2] and "torchft_exporter_quorum_id 3" in bodies[2]
    assert 'torchft_exporter_fleet_replicas{job="default"} 2' in bodies[3]


def _scoped(job):
    fleet = _fake_fleet()
    fleet["job"] = job
    return fleet


def _signal_fleet():
    return {
        "job": "default", "signal_seq": 3,
        "agg": {"n": 2, "stragglers": 0, "anomalies_dropped": 0, "signals_dropped": 2},
        "replicas": {}, "anomalies": [],
        "signal_counts": {"proc_death": 1, "rpc_error": 2},
        "signals": [
            {"seq": 2, "source": "rpc_error", "replica_id": "r1",
             "site": "client:heartbeat", "ts_ms": 100},
            {"seq": 3, "source": "proc_death", "replica_id": "r0",
             "site": "lighthouse.leave", "ts_ms": 200},
        ],
    }


def _goodput_fleet(extra_kind=False):
    from test_goodput import _fleet_payload

    fleet = _fleet_payload()
    fleet["agg"]["badput_s"] = {"compute": 90.0, "heal": 10.0}
    if extra_kind:
        fleet["agg"]["badput_s"]["coffee_break"] = 5.0
    return fleet


FLEETS = {
    "fake": (_fake_fleet, {}),
    "fake_tenant": (lambda: _scoped("tenant-a"), {}),
    "fake_escaped_job": (lambda: _scoped('we"ird\\job'), {}),
    "synthetic_capped": (lambda: _synthetic_fleet(200), {"max_replicas": 64}),
    "synthetic_uncapped": (lambda: _synthetic_fleet(200), {"max_replicas": 200}),
    "composite": (_composite_fleet, {"max_replicas": 64}),
    "goodput": (_goodput_fleet, {}),
    "goodput_closed_enum": (lambda: _goodput_fleet(True), {}),
    "signals": (_signal_fleet, {"max_replicas": 64}),
    "empty": (lambda: {}, {}),
}


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_render_fleet_prometheus_is_the_tools(name):
    make, kw = FLEETS[name]
    text = _both(lambda m: m.render_fleet_prometheus(make(), **kw))
    if name == "fake":
        assert 'torchft_exporter_replica_anomaly{job="default",replica="a",kind="hb_jitter"} 1' \
            in text
    if name == "goodput_closed_enum":
        assert "coffee_break" not in text


@pytest.mark.parametrize("max_jobs", ["2", "1", "64"])
def test_job_rollup_cap_is_the_tools(monkeypatch, max_jobs):
    """tests/test_observability.py's job cap, through ``TORCHFT_EXPORT_MAX_JOBS``
    (both packages' knobs read it)."""
    monkeypatch.setenv("TORCHFT_EXPORT_MAX_JOBS", max_jobs)
    text = _both(lambda m: m.render_fleet_prometheus(_composite_fleet(), max_replicas=64))
    if max_jobs == "2":
        assert "torchft_exporter_jobs_suppressed 1" in text


def test_the_replica_cap_defaults_to_the_knob(monkeypatch):
    monkeypatch.setenv("TORCHFT_EXPORT_MAX_REPLICAS", "16")
    text = _both(lambda m: m.render_fleet_prometheus(_synthetic_fleet(128)))
    assert 'torchft_exporter_replicas_suppressed{job="default"} 125' in text
    assert 'replica="w0050"' not in text


# -- journaling: cursors and rise edges ------------------------------------------------


def test_journal_anomalies_cursor_dedup_is_the_tools(tmp_path):
    def run(m, log):
        fleet = _fake_fleet()
        return [m.journal_anomalies(log, fleet, 0), m.journal_anomalies(log, fleet, 3),
                m.journal_anomalies(log, fleet, 2), m.journal_anomalies(None, fleet, 0),
                m.journal_anomalies(log, None, 5)]

    cursors, events = _both_journals(tmp_path, run)
    assert cursors == [3, 3, 3, 3, 5]
    assert [e["attrs"]["seq"] for e in events] == [2, 3, 3]


def test_journal_overflow_rise_edge_is_the_tools(tmp_path):
    def run(m, log):
        fleet = _synthetic_fleet()
        fleet["agg"]["anomalies_dropped"] = 5
        marks = [m.journal_overflow(log, fleet, 0)]
        marks.append(m.journal_overflow(log, fleet, marks[-1]))
        fleet["agg"]["anomalies_dropped"] = 9
        marks.append(m.journal_overflow(log, fleet, marks[-1]))
        marks += [m.journal_overflow(None, fleet, 9), m.journal_overflow(None, None, 3)]
        return marks

    marks, events = _both_journals(tmp_path, run)
    assert marks == [5, 5, 9, 9, 3]
    assert [e["attrs"]["new_drops"] for e in events] == [5, 4]


def test_journal_signals_and_signal_overflow_are_the_tools(tmp_path):
    def run(m, log):
        fleet = _signal_fleet()
        out = [m.journal_signals(log, fleet, 0)]
        out.append(m.journal_signals(log, fleet, out[-1]))
        mark = m.journal_signal_overflow(log, fleet, 0)
        out += [mark, m.journal_signal_overflow(log, fleet, mark)]
        fleet["agg"]["signals_dropped"] = 5
        out.append(m.journal_signal_overflow(log, fleet, mark))
        out += [m.journal_signals(None, None, 7), m.journal_signal_overflow(None, None, 7)]
        return out

    marks, events = _both_journals(tmp_path, run)
    assert marks == [3, 3, 2, 2, 5, 7, 7]
    assert [e["event"] for e in events] == [
        "failure_signal", "failure_signal", "signal_overflow", "signal_overflow"]


def test_journal_slo_burns_is_the_tools(tmp_path):
    def run(m, log):
        fleet = _goodput_fleet()
        cur = m.journal_slo_burns(log, fleet, 0)
        return [cur, m.journal_slo_burns(log, fleet, cur), m.journal_slo_burns(None, None, 4)]

    cursors, events = _both_journals(tmp_path, run)
    assert cursors == [1, 1, 4]
    assert [e["event"] for e in events] == ["slo_burn"]


# -- the native engine's counters -------------------------------------------------------


def _counters_event(ts, rid, n_streams, scale, step=1):
    """A ``native_counters`` event in the shape the port's
    ``ProcessGroupNative`` journals (process_group.py's drain)."""
    peers = [
        {"peer": p, "tx_bytes": scale * (p + 1) << 20, "rx_bytes": scale * (p + 2) << 20,
         "tx_busy_ns": 0 if p == 2 else scale * 1_300_000 * (p + 1),
         "rx_busy_ns": scale * 2_100_000 + p, "spins": 7 * p + scale}
        for p in (0, 2, 3)
    ]
    return {"ts": ts, "replica_id": rid, "step": step, "event": "native_counters",
            "attrs": {"trace": f"q1.s{step}", "seq": 10 * scale, "dropped": scale - 1,
                      "spin_total": 11 * scale, "bytes_tx": scale << 24,
                      "bytes_rx": scale << 23, "world": 4, "n_streams": n_streams,
                      "peers": peers}}


def _counters_journal(dirpath, n_streams):
    os.makedirs(dirpath, exist_ok=True)
    rows = {
        "journal_replica0_rank0.jsonl": [
            _counters_event(1.0, "0:aaaa", n_streams, 1),
            {"ts": 1.5, "replica_id": "0:aaaa", "step": 1, "event": "commit_gate",
             "attrs": {"committed": True}},
            _counters_event(2.0, "0:aaaa", n_streams, 2, step=2),
        ],
        # A relaunch: the new incarnation's counters win for the slot.
        "journal_replica1_rank0.jsonl": [
            _counters_event(1.2, "1:bbbb", n_streams, 3),
            _counters_event(3.0, "1:cccc", n_streams, 1, step=3),
        ],
        "journal_replica2_rank0.jsonl": [_counters_event(0.5, '2"x\\y', n_streams, 5)],
    }
    for name, evs in rows.items():
        with open(os.path.join(dirpath, name), "w") as f:
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
    return dirpath


@pytest.mark.parametrize("n_streams", [1, 4])
def test_native_counters_gauges_are_the_tools(tmp_path, n_streams):
    journal = _counters_journal(str(tmp_path / "journal"), n_streams)
    port = texport.latest_native_counters(telemetry.load_journal([journal]))
    ref = jexport.latest_native_counters(obs_report.load_events([journal]))
    assert port == ref and sorted(port) == ['0', '1', '2"x\\y']
    assert port["1"]["spin_total"] == 11  # the relaunch's
    text = texport.render_native_prometheus(port)
    assert text == jexport.render_native_prometheus(ref)
    c = port["0"]["peers"][0]
    want = c["tx_bytes"] / 2**30 / (c["tx_busy_ns"] / n_streams / 1e9)
    assert f'torchft_exporter_native_peer_gib_s{{replica="0",peer="0",dir="tx"}} {want:.4f}' \
        in text.splitlines()
    assert 'torchft_exporter_native_peer_gib_s{replica="0",peer="2",dir="tx"} 0.0000' in text
    assert texport.render_native_prometheus({}) == jexport.render_native_prometheus({}) == ""


@pytest.mark.parametrize("n_streams", [1, 4])
def test_exporter_render_scans_the_journals_as_the_tool(tmp_path, n_streams):
    journal = _counters_journal(str(tmp_path / "journal"), n_streams)

    def run(m):
        ex = m._Exporter(journal_paths=[journal])
        ex.update(_sample(), _fake_fleet())
        return ex.render()

    assert "torchft_exporter_native_fr_seq" in _both(run)


# -- live: the serving path and main over a lighthouse ----------------------------------


def _feed(addr):
    """Digests that raise every anomaly rule, and two failure signals."""
    client = LighthouseClient(addr)
    for rid, dg in _SEQ:
        client.heartbeat(rid, digest=dg, hb_interval_ms=60000)
    client.heartbeat("ra", digest=_dg(11, 1.0), hb_interval_ms=60000,
                     signals=[{"source": "rpc_error", "replica_id": "rb", "site": "client:x"}])
    client.heartbeat("rb", digest=_dg(11, 1.0), hb_interval_ms=60000,
                     signals=[{"source": "native_abort", "replica_id": "ra",
                               "site": "manager:rb"}])
    return client


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, None, None


def test_serving_path_is_the_tools_render(lighthouse, tmp_path):
    """``_Exporter`` behind ``_make_handler`` on 127.0.0.1:0 serves, at
    ``/metrics`` and ``/``, the body the JAX tool's ``render()`` gives on
    the same sample, fleet and journal, and a 404 elsewhere."""
    client = _feed(lighthouse.address())
    sample, fleet = texport.scrape(client), texport.scrape_fleet(client)
    client.close()
    assert fleet is not None and fleet["anomaly_seq"] >= 4
    journal = _counters_journal(str(tmp_path / "journal"), 4)
    ex, ref = texport._Exporter([journal]), jexport._Exporter([journal])
    ex.update(sample, fleet)
    ref.update(sample, fleet)
    server = ThreadingHTTPServer(("127.0.0.1", 0), texport._make_handler(ex))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        want = ref.render()
        assert _get(base + "/metrics") == (
            200, "text/plain; version=0.0.4; charset=utf-8", want)
        assert _get(base + "/")[2] == want
        assert _get(base + "/fleet.json")[0] == 404
        assert _get(base + "/metricsx")[0] == 404
    finally:
        server.shutdown()
        server.server_close()
    assert "torchft_exporter_up 1" in want
    assert 'torchft_exporter_fleet_anomalies_total{job="default"} 4' in want
    assert 'torchft_exporter_fleet_signals_by_source{job="default",source="rpc_error"} 1' in want


def _clock_free(sample):
    """A scrape without its heartbeat ages, which move between two scrapes."""
    return {k: v for k, v in sample.items()
            if k not in ("heartbeat_ages_ms", "heartbeat_age_max_ms")}


def test_scrape_is_the_tools(lighthouse):
    from torchft_tpu.coordination import LighthouseClient as JaxClient

    client = _feed(lighthouse.address())
    jclient = JaxClient(lighthouse.address())
    try:
        port, ref = texport.scrape(client), jexport.scrape(jclient)
        assert _clock_free(port) == _clock_free(ref)
        assert sorted(port["heartbeat_ages_ms"]) == sorted(ref["heartbeat_ages_ms"]) == [
            "ra", "rb"]
        fleets = [m.scrape_fleet(c) for m, c in ((texport, client), (jexport, jclient))]
        assert [f["anomalies"] for f in fleets][0] == fleets[1]["anomalies"]
    finally:
        client.close()
        jclient.close()


def test_scrape_fleet_is_none_against_a_lighthouse_without_the_rpc():
    from test_torch_fleet import _old_lighthouse

    addr, _, thread, sock = _old_lighthouse()
    client = LighthouseClient(addr)
    try:
        assert texport.scrape_fleet(client, timeout=2.0) is None
    finally:
        client.close()
        sock.close()


def _strip_ages(text):
    return [ln for ln in text.splitlines()
            if not ln.startswith(("torchft_exporter_heartbeat_age", "torchft_exporter_fleet_mtbf",
                                  "torchft_exporter_fleet_ettr"))]


def test_main_once_journals_as_the_tool(lighthouse, tmp_path, capsys):
    """``main --once --journal-file`` against the live lighthouse: both exit
    0, print the same exposition (heartbeat ages aside) and journal the
    same events, kinds and fields, each field's value but the clock's."""
    _feed(lighthouse.address()).close()
    out = {}
    for name, m in (("port", texport), ("jax", jexport)):
        path = tmp_path / f"{name}.jsonl"
        rc = m.main(["--lighthouse", lighthouse.address(), "--once", "--journal-file",
                     str(path)])
        printed = capsys.readouterr().out
        events = [json.loads(line) for line in path.read_text().splitlines()]
        for ev in events:
            ev.pop("ts")
            if ev["event"] == "lighthouse_status":
                ev["attrs"] = _clock_free(ev["attrs"])
        out[name] = (rc, _strip_ages(printed), events)
    assert out["port"] == out["jax"]
    rc, _, events = out["port"]
    assert rc == 0
    kinds = [e["event"] for e in events]
    assert kinds[0] == "lighthouse_status" and "anomaly" in kinds and "failure_signal" in kinds
    assert all(e["replica_id"] == "exporter" for e in events)


@pytest.mark.parametrize("n_streams", [1, 4])
def test_main_once_over_a_journal_is_the_tool(tmp_path, capsys, n_streams):
    journal = _counters_journal(str(tmp_path / "journal"), n_streams)
    printed = []
    for m in (texport, jexport):
        assert m.main(["--once", "--journal", journal]) == 0
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "torchft_exporter_native_peer_gib_s" in printed[0]


@pytest.mark.parametrize("argv", [[], ["--journal", "/nonexistent"], ["--port", "9"]])
def test_main_refuses_as_the_tool(monkeypatch, capsys, argv):
    """No lighthouse and no journal, or serving mode without a lighthouse:
    both exit 2 with the same usage error."""
    monkeypatch.delenv("TORCHFT_LIGHTHOUSE", raising=False)
    errs = []
    for m in (texport, jexport):
        with pytest.raises(SystemExit) as e:
            m.main(argv)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1]


def test_the_badput_gauges_iterate_the_closed_enum():
    fleet = _goodput_fleet()
    fleet["agg"]["badput_s"] = {k: float(i) for i, k in enumerate(reversed(BADPUT_KINDS))}
    text = _both(lambda m: m.render_fleet_prometheus(copy.deepcopy(fleet)))
    kinds = [ln.split('kind="')[1].split('"')[0] for ln in text.splitlines()
             if ln.startswith("torchft_exporter_fleet_badput_seconds{")]
    assert kinds == list(BADPUT_KINDS)


@pytest.mark.timeout(240)
def test_fleet_plane_drill_on_the_cpu(tmp_path):
    """``drill.fleet_plane_drill`` with ``--device cpu`` (the card runs it in
    ``chip_smoke.py``): group 1's stalled heartbeats flag it a straggler
    with ``hb_jitter`` while it runs, the dashboard's check passes, the
    exporter's live gauges show it, and the exporter's journal holds the
    anomaly and every scrape seen, and the planted faults of the card's
    phase are caught on its readings."""
    import chip_smoke
    from torchft_tpu_torch import drill
    from torchft_tpu_torch.obs_top import check_frame

    out = drill.fleet_plane_drill(str(tmp_path / "fleet"), device="cpu")
    rid = out["straggler"]["replica_id"]
    assert rid.startswith("1:") and "hb_jitter" in out["straggler"]["flags"]
    assert out["obs_top_rc"] == 0 and out["exporter_rc"] == 0
    assert sorted(drill.frame_rows(out["frame"])) == [0, 1]
    # The frame is obs_top's own fetch, a moment after the drill's: the
    # rows agree, their signal cells and the signal ring may have moved on.
    assert not [p for p in check_frame(out["fleet"], out["frame"])
                if p.endswith("missing from rendered frame")]
    assert drill.fleet_gauges_hold(out["metrics"], rid)
    assert out["status_events"] >= out["scrapes_seen"] > 0
    assert (rid, "hb_jitter") in out["anomalies"]
    # 40 steps of 0.25 s: ~15 s alone on the CPU, longer beside other tests.
    assert out["wall_s"] > 10
    # The card phase's planted faults on these readings.
    row = drill.frame_rows(out["frame"])[1]
    assert chip_smoke.planted_frame_fault(
        "cpu fleet plane", out["fleet"], out["frame"],
        out["frame"].replace(row, row.replace("STRAGGLER ", "")),
        f"replica {rid!r} is a straggler but its row has no STRAGGLER tag")
    unflagged = copy.deepcopy(out["fleet"])
    unflagged["replicas"][rid]["flags"].remove("hb_jitter")
    body = texport.render_fleet_prometheus(unflagged) + "torchft_exporter_up 1\n"
    assert not drill.fleet_gauges_hold(body, rid)
