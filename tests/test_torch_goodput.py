"""The port's goodput ledger, held to tests/test_goodput.py: the port's
``TimeLedger`` credits the JAX ledger's seconds window by window on the
same (numpy-seeded) calls, clamps and refuses alike, and its account rides
the ``StepDigest`` ``acct`` wire in the JAX package's bytes; the port's
client carries it to old and new lighthouses, whose badput aggregates, SLO
burn edges and MTBF/ETTR it feeds; the port's ``telemetry.audit_goodput``
gives ``tools/goodput_report.py``'s accounts and problems; and the shared
``goodput_report``, ``obs_top`` and ``obs_export`` read what the port
writes. Live and mixed: a JAX and a port Manager train together with
their journals on; each one's ``goodput_window`` events tile its ledger,
``Manager.goodput()`` agrees with its journal, and the lighthouse sums
both accounts."""

import json
import os
import sys

import numpy as np
import pytest

from torchft_tpu import telemetry as jtelemetry
from torchft_tpu_torch import telemetry
from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer
from torchft_tpu_torch.telemetry import (
    BADPUT_KINDS,
    FAULT_BADPUT_KINDS,
    EventLog,
    StepDigest,
    TimeLedger,
)

from test_torch_fleet import _old_lighthouse, _wait, manager_world

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import goodput_report  # noqa: E402
import obs_export  # noqa: E402
import obs_top  # noqa: E402

from torchft_tpu_torch import obs_export as port_export  # noqa: E402
from torchft_tpu_torch import obs_top as port_top  # noqa: E402

pytestmark = pytest.mark.timeout(60)


def _lighthouse():
    return LighthouseServer(min_replicas=2, join_timeout_ms=200, quorum_tick_ms=20,
                            fleet_snap_ms=0)


@pytest.fixture
def lighthouse():
    server = _lighthouse()
    yield server
    server.shutdown()


# -- the ledger: the same seconds ----------------------------------------------


def _both(fn):
    port, ref = fn(TimeLedger), fn(jtelemetry.TimeLedger)
    assert port == ref
    return port


def test_ledger_tiles_wall_clock():
    def run(cls):
        led = cls(now=100.0)
        w = led.account({"heal": 2.0, "quorum_wait": 1.0}, "compute", upto=110.0)
        led.account({}, "drain", upto=112.5)
        return w, led.totals(), led.total_s(), led.tiling_error_s(), led.acct_vector()

    w, totals, total, err, vec = _both(run)
    assert w == pytest.approx({"heal": 2.0, "quorum_wait": 1.0, "compute": 7.0})
    assert totals["drain"] == pytest.approx(2.5)
    assert total == pytest.approx(12.5) and sum(totals.values()) == pytest.approx(total)
    assert err < 1e-9
    assert len(vec) == len(BADPUT_KINDS)
    assert vec[BADPUT_KINDS.index("heal")] == pytest.approx(2.0)
    assert vec[BADPUT_KINDS.index("compute")] == pytest.approx(7.0)


def test_ledger_clamps_overclaimed_splits():
    def run(cls):
        led = cls(now=0.0)
        return led.account({"heal": 30.0, "exposed_comm": 10.0}, "discarded_step", upto=2.0), \
            led.totals(), led.tiling_error_s()

    w, totals, err = _both(run)
    assert w == pytest.approx({"heal": 1.5, "exposed_comm": 0.5, "discarded_step": 0.0})
    assert all(v >= 0.0 for v in totals.values()) and err < 1e-9


def test_ledger_time_never_runs_backward():
    def run(cls):
        led = cls(now=50.0)
        led.account({}, "compute", upto=60.0)
        return led.account({}, "heal", upto=55.0), led.total_s()

    w, total = _both(run)
    assert w == {"heal": 0.0} and total == pytest.approx(10.0)


def test_ledger_rejects_unknown_kind():
    for splits, residual in (({"coffee_break": 1.0}, "compute"), ({}, "coffee_break")):
        messages = []
        for cls in (TimeLedger, jtelemetry.TimeLedger):
            with pytest.raises(ValueError) as err:
                cls(now=0.0).account(splits, residual, upto=1.0)
            messages.append(str(err.value))
        assert messages[0] == messages[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_windows_equal_the_jax_ledger_on_seeded_calls(seed):
    """Seeded windows (some over-claimed, some behind the frontier, every
    kind as a split or a residual): the two ledgers credit the same seconds
    to the bit, window by window, and end with the same totals."""
    rng = np.random.default_rng(seed)
    calls = []
    t = 1000.0
    for _ in range(200):
        t += float(rng.exponential(2.0)) * (1 if rng.random() < 0.9 else -1)
        kinds = rng.choice(len(BADPUT_KINDS), size=int(rng.integers(0, 5)), replace=False)
        splits = {BADPUT_KINDS[k]: float(rng.exponential(0.8)) for k in kinds}
        calls.append((splits, BADPUT_KINDS[rng.integers(len(BADPUT_KINDS))], t))

    def run(cls):
        led = cls(now=1000.0)
        windows = [led.account(s, r, upto=u) for s, r, u in calls]
        return windows, led.totals(), led.acct_vector(), led.total_s()

    windows, totals, _, total = _both(run)
    assert abs(sum(totals.values()) - total) < 1e-9


def test_fault_badput_kinds_subset():
    assert FAULT_BADPUT_KINDS == jtelemetry.FAULT_BADPUT_KINDS
    assert set(FAULT_BADPUT_KINDS) <= set(BADPUT_KINDS)
    assert "compute" not in FAULT_BADPUT_KINDS and "init_compile" not in FAULT_BADPUT_KINDS


# -- the acct wire ---------------------------------------------------------------------


def _acct(**kinds):
    vec = [0.0] * len(BADPUT_KINDS)
    for k, v in kinds.items():
        vec[BADPUT_KINDS.index(k)] = v
    return vec


def test_digest_acct_roundtrip():
    d = StepDigest(step=7, rate=1.0, goodput=0.9, acct=_acct(compute=120.5, heal=3.25))
    s = d.to_json()
    assert s == jtelemetry.StepDigest(step=7, rate=1.0, goodput=0.9,
                                      acct=_acct(compute=120.5, heal=3.25)).to_json()
    back = StepDigest.from_wire(json.loads(s))
    assert back.acct[BADPUT_KINDS.index("compute")] == pytest.approx(120.5, rel=1e-3)
    assert back.acct[BADPUT_KINDS.index("heal")] == pytest.approx(3.25, rel=1e-3)
    assert "acct" not in json.loads(StepDigest(step=1, rate=0.0, goodput=0.0).to_json())


def test_digest_worst_case_with_acct_stays_under_budget():
    def worst(cls):
        return cls(
            step=2**53 - 1, rate=123456.789, goodput=0.999999,
            phases={k: [123456.123456, 999999.99999] for k in ("q", "h", "c", "a", "m")},
            peer_gib_s={f"peer-{i:06d}": 123456.789 for i in range(32)},
            errored=True, chaos_injections=2**31, commit_failures=2**31,
            acct=[604800.123456] * len(BADPUT_KINDS),
        ).to_json()

    s = worst(StepDigest)
    assert s == worst(jtelemetry.StepDigest)
    assert len(s.encode()) <= StepDigest.MAX_WIRE_BYTES
    assert len(json.loads(s)["acct"]) == len(BADPUT_KINDS)


def test_acct_digest_against_old_lighthouse():
    addr, received, t, lsock = _old_lighthouse()
    client = LighthouseClient(addr, connect_timeout=5.0)
    wire = json.loads(StepDigest(step=9, rate=1.0, goodput=1.0, acct=_acct(compute=10.0)).to_json())
    client.heartbeat("compat", digest=wire, hb_interval_ms=100)
    client.close()
    lsock.close()
    t.join(timeout=5)
    assert received and received[0]["digest"]["acct"][1] == 10.0


def test_old_digest_against_new_lighthouse(lighthouse):
    c = LighthouseClient(lighthouse.address())
    c.heartbeat("oldie", digest={"v": 1, "step": 3, "rate": 1.0}, hb_interval_ms=60000)
    fleet = c.fleet()
    assert fleet["replicas"]["oldie"]["digest"]["step"] == 3
    agg = fleet["agg"]
    assert agg["goodput_frac"] is None and agg["badput_s"] is None
    assert agg["mtbf_s"] is None and agg["ettr_s"] is None
    assert agg["slo_burning"] is False
    c.close()


# -- lighthouse aggregation, SLO burn, MTBF/ETTR --------------------------------------


def _hb_acct(c, rid, step, **kinds):
    c.heartbeat(rid, digest={"v": 1, "step": step, "rate": 1.0, "gp": 1.0,
                             "acct": _acct(**kinds)}, hb_interval_ms=60000)


def test_fleet_badput_aggregation(lighthouse):
    c = LighthouseClient(lighthouse.address())
    _hb_acct(c, "ga", 5, compute=80.0, heal=5.0)
    _hb_acct(c, "gb", 5, compute=90.0, quorum_wait=25.0)
    agg = c.fleet()["agg"]
    assert agg["badput_s"]["compute"] == pytest.approx(170.0)
    assert agg["badput_s"]["heal"] == pytest.approx(5.0)
    assert agg["badput_s"]["quorum_wait"] == pytest.approx(25.0)
    assert agg["goodput_frac"] == pytest.approx(170.0 / 200.0)
    _hb_acct(c, "ga", 6, compute=100.0, heal=5.0)  # replaces, not adds
    assert c.fleet()["agg"]["badput_s"]["compute"] == pytest.approx(190.0)
    import urllib.request

    with urllib.request.urlopen(f"http://{lighthouse.address()}/metrics", timeout=5) as resp:
        metrics = resp.read().decode()
    assert "torchft_lighthouse_job_goodput_fraction" in metrics
    assert 'torchft_lighthouse_job_badput_seconds{job="default",kind="heal"}' in metrics
    assert "torchft_lighthouse_job_slo_burning" in metrics
    c.close()


def test_slo_burn_rise_and_fall(monkeypatch):
    monkeypatch.setenv("TORCHFT_LH_SLO_GOODPUT", "0.95")
    monkeypatch.setenv("TORCHFT_LH_SLO_BURN", "2.0")
    monkeypatch.setenv("TORCHFT_LH_SLO_MIN_S", "10.0")
    server = _lighthouse()
    try:
        c = LighthouseClient(server.address())
        _hb_acct(c, "sa", 5, compute=50.0, heal=50.0)  # burn 10x: rise edge
        fleet = c.fleet()
        assert fleet["agg"]["slo_burning"] is True
        assert len(fleet["slo_burns"]) == 1 and fleet["slo_seq"] == 1
        assert fleet["slo_burns"][0]["goodput"] == pytest.approx(0.5)
        assert fleet["slo_burns"][0]["burn"] == pytest.approx(10.0)
        _hb_acct(c, "sa", 6, compute=51.0, heal=50.0)  # still burning: no new record
        fleet = c.fleet()
        assert fleet["slo_seq"] == 1 and len(fleet["slo_burns"]) == 1
        _hb_acct(c, "sa", 7, compute=990.0, heal=10.0)  # recovered
        fleet = c.fleet()
        assert fleet["agg"]["slo_burning"] is False and fleet["slo_seq"] == 1
        c.close()
    finally:
        server.shutdown()


def test_slo_disarmed_below_min_accounted(monkeypatch):
    monkeypatch.setenv("TORCHFT_LH_SLO_GOODPUT", "0.95")
    monkeypatch.setenv("TORCHFT_LH_SLO_MIN_S", "1000.0")
    server = _lighthouse()
    try:
        c = LighthouseClient(server.address())
        _hb_acct(c, "sb", 5, compute=5.0, heal=50.0)
        fleet = c.fleet()
        assert fleet["agg"]["slo_burning"] is False and fleet["slo_burns"] == []
        c.close()
    finally:
        server.shutdown()


def test_mtbf_and_ettr_from_evidence(lighthouse):
    c = LighthouseClient(lighthouse.address())
    _hb_acct(c, "ma", 10, compute=60.0)
    assert c.fleet()["agg"]["mtbf_s"] is None
    c.heartbeat("ma", signals=[{"source": "digest_anomaly", "replica_id": "ma", "site": "t"}])
    assert c.fleet()["agg"]["mtbf_s"] is None  # soft evidence does not count
    c.heartbeat("ma", signals=[{"source": "proc_death", "replica_id": "ma", "site": "t"}])
    agg = c.fleet()["agg"]
    assert agg["mtbf_s"] is not None and agg["mtbf_s"] >= 0.0
    assert agg["ettr_s"] is None  # the episode is still open
    _hb_acct(c, "ma", 11, compute=61.0)
    agg = c.fleet()["agg"]
    assert agg["ettr_s"] is not None and agg["ettr_s"] >= 0.0
    c.close()


# -- the offline audit: the port's and the tool's -------------------------------------


def _win(rid, ts, dur, total, committed=True, residual="compute", **splits):
    body = dict(splits)
    body[residual] = body.get(residual, 0.0) + (dur - sum(splits.values()))
    return {"ts": ts, "replica_id": rid, "step": None, "event": "goodput_window",
            "attrs": {"committed": committed, "residual": residual, "dur_s": dur,
                      "total_s": total, "splits": body}}


def _audit_equals_the_tool(events):
    rows, problems = telemetry.audit_goodput(events)
    report = goodput_report.analyze(events)
    assert rows == report["replicas"]
    assert problems == report["problems"]
    return rows, problems, report


def test_goodput_report_tiling_and_down_attribution():
    events = [
        _win("r1:a", 110.0, 10.0, 10.0),
        _win("r1:a", 120.0, 10.0, 20.0, heal=2.0),
        # The relaunch: the ledger restarts at 128, 8 s after 120.
        _win("r1:b", 133.0, 5.0, 5.0, residual="init_compile"),
        _win("r1:b", 143.0, 10.0, 15.0),
    ]
    rows, problems, report = _audit_equals_the_tool(events)
    assert problems == [] and goodput_report.check(report) == []
    row = rows["r1"]
    assert row["incarnations"] == 2
    assert row["down_s"] == pytest.approx(8.0)
    assert row["badput_s"]["heal"] == pytest.approx(2.0)
    assert row["badput_s"]["down"] == pytest.approx(8.0)
    assert report["summary"]["accounted_s"] == pytest.approx(43.0)
    assert report["summary"]["goodput_retention"] == pytest.approx(1.0 - 10.0 / 38.0)


def test_a_relaunch_that_outlasts_the_killed_incarnation_is_split_by_its_id():
    """The killed incarnation accounted 5 s; its relaunch's first window
    closes 13 s into its process (start, model build, quorum, heal). The
    port's audit splits the slot where the replica id changes: two
    incarnations that tile, 7 s down. The JAX package's tool splits only
    where ``total_s`` falls back, merges them and reports a tiling problem
    with no down time (ROADMAP.md section 3)."""
    events = [
        _win("g1:a", 102.0, 2.0, 2.0, residual="init_compile"),
        _win("g1:a", 105.0, 3.0, 5.0),
        # Killed at 105; the relaunch's process starts at 112.
        _win("g1:b", 125.0, 13.0, 13.0, heal=6.0, residual="init_compile"),
        _win("g1:b", 126.0, 1.0, 14.0, residual="replay_catchup"),
    ]
    rows, problems = telemetry.audit_goodput(events)
    assert problems == []
    row = rows["g1"]
    assert row["incarnations"] == 2
    assert row["down_s"] == pytest.approx(7.0)
    assert row["accounted_s"] == pytest.approx(26.0)
    report = goodput_report.analyze(events)
    assert report["replicas"]["g1"]["incarnations"] == 1
    assert report["replicas"]["g1"]["down_s"] == 0.0
    assert any("incarnation 0 windows sum" in p for p in report["problems"])


def test_goodput_report_catches_broken_tiling():
    ev = _win("r2", 10.0, 5.0, 5.0)
    ev["attrs"]["splits"]["compute"] += 0.5
    _, problems, _ = _audit_equals_the_tool([ev])
    assert any("splits sum" in p for p in problems)
    ev2 = _win("r3", 10.0, 5.0, 5.0)
    ev2["attrs"]["splits"] = {"coffee_break": 5.0}
    _, problems, report = _audit_equals_the_tool([ev2])
    assert any("unknown kind" in e for e in goodput_report.check(report))
    ev3 = _win("r4", 10.0, 5.0, 6.0)  # windows do not sum to the ledger total
    _, problems, _ = _audit_equals_the_tool([ev3])
    assert any("incarnation 0" in p for p in problems)


def test_goodput_report_fault_cost_join_on_port_episodes():
    """The fault-cost join over the windows a port journal holds and the
    episode the port's detector opens on it (a relaunch), as the JAX
    detector opens it."""
    events = [
        {"ts": 100.0, "replica_id": "r4:a", "step": 0, "event": "quorum_start", "attrs": {}},
        {"ts": 100.5, "replica_id": "r4:a", "step": 0, "event": "quorum_ready",
         "attrs": {"quorum_id": 1, "max_step": 0, "heal": False}},
        _win("r4:a", 108.0, 8.0, 8.0),
        {"ts": 108.0, "replica_id": "r4:a", "step": 0, "event": "commit_gate",
         "attrs": {"committed": True}},
        {"ts": 109.0, "replica_id": "r4:b", "step": 0, "event": "quorum_start", "attrs": {}},
        {"ts": 110.0, "replica_id": "r4:b", "step": 0, "event": "quorum_ready",
         "attrs": {"quorum_id": 2, "max_step": 1, "heal": True}},
        {"ts": 114.0, "replica_id": "r4:b", "step": 1, "event": "heal_done",
         "attrs": {"max_step": 1}},
        _win("r4:b", 118.0, 9.0, 9.0, heal=4.0, residual="replay_catchup"),
        {"ts": 118.0, "replica_id": "r4:b", "step": 1, "event": "commit_gate",
         "attrs": {"committed": True}},
        _win("r4:b", 128.0, 10.0, 19.0),
    ]
    episodes = telemetry.detect_episodes(events)
    assert episodes == jtelemetry.detect_episodes(events)
    cost = goodput_report.attribute_fault_cost(events, episodes)
    assert cost == goodput_report.attribute_fault_cost(events, jtelemetry.detect_episodes(events))
    row = cost[episodes[-1]["root_cause"]["kind"]]
    assert row["cost_s"]["heal"] == pytest.approx(4.0)
    assert "compute" not in row["cost_s"]


# -- obs_top and obs_export over a port fleet ------------------------------------------


def _fleet_payload():
    return {
        "job": "default",
        "replicas": {
            "acct-r0": {"digest": json.loads(StepDigest(
                step=9, rate=1.0, goodput=0.9, acct=_acct(compute=90.0, heal=10.0)).to_json()),
                "digest_age_ms": 10, "hb_age_ms": 10, "straggler": False, "flags": []},
            "plain-r1": {"digest": json.loads(StepDigest(step=9, rate=1.0, goodput=0.9).to_json()),
                         "digest_age_ms": 10, "hb_age_ms": 10, "straggler": False, "flags": []},
        },
        "agg": {"n": 2, "n_digest": 2, "stragglers": 0, "quorum_world": 2, "joins_total": 0,
                "leaves_total": 0, "badput_s": {k: 0.0 for k in BADPUT_KINDS},
                "goodput_frac": 0.9, "slo_burning": True, "mtbf_s": 1234.5, "ettr_s": 6.7},
        "anomalies": [], "signals": [], "anomaly_seq": 0, "signal_seq": 0,
        "slo_burns": [{"seq": 1, "ts_ms": 1, "job": "default", "goodput": 0.5,
                       "target": 0.95, "burn": 10.0}],
        "slo_seq": 1,
    }


def test_obs_top_renders_the_port_digests_ledger():
    fleet = _fleet_payload()
    frame = obs_top.render(fleet, color=False)
    assert obs_top.check_frame(fleet, frame) == []
    assert "LEDG%" in frame and "WORST" in frame
    row = next(ln for ln in frame.splitlines() if ln.startswith("acct-r0"))
    assert "90.0" in row and " he " in row
    head = frame.splitlines()[0]
    assert "goodput=90.0%" in head and "SLO_BURN" in head
    plain = next(ln for ln in frame.splitlines() if ln.startswith("plain-r1"))
    assert " - " in plain
    broken = frame.replace(" he ", " -- ")
    assert any("worst-badput" in p for p in obs_top.check_frame(fleet, broken))
    dn = json.loads(StepDigest(
        step=1, rate=1.0, goodput=1.0, acct=_acct(compute=8.0, down=2.0)).to_json())
    gp, glyph = obs_top._acct_view(dn)
    assert gp == pytest.approx(80.0) and glyph == "dn"
    assert obs_top._acct_view({}) == (None, "-")
    # The port's dashboard beside the JAX tool: the same frames, problems
    # and cells.
    assert port_top.render(fleet, color=False) == frame
    assert port_top.render(fleet, color=True) == obs_top.render(fleet, color=True)
    assert port_top.check_frame(fleet, frame) == []
    assert port_top.check_frame(fleet, broken) == obs_top.check_frame(fleet, broken)
    assert port_top._acct_view(dn) == (gp, glyph)
    assert port_top._acct_view({}) == (None, "-")


def test_obs_export_goodput_gauges_and_slo_journal_on_the_port_event_log(tmp_path):
    fleet = _fleet_payload()
    fleet["agg"]["badput_s"] = {"compute": 90.0, "heal": 10.0, "coffee_break": 5.0}
    text = obs_export.render_fleet_prometheus(fleet)
    assert 'torchft_exporter_fleet_goodput_fraction{job="default"} 0.9' in text
    assert 'torchft_exporter_fleet_badput_seconds{job="default",kind="heal"} 10' in text
    assert 'torchft_exporter_fleet_slo_burning{job="default"} 1' in text
    assert "coffee_break" not in text
    assert port_export.render_fleet_prometheus(fleet) == text
    lines = {}
    for name, log_cls, exporter in (("port", EventLog, obs_export),
                                    ("jax", jtelemetry.EventLog, obs_export),
                                    ("twin", EventLog, port_export)):
        path = tmp_path / f"{name}.jsonl"
        journal = log_cls(str(path), replica_id="exporter")
        cur = exporter.journal_slo_burns(journal, fleet, 0)
        assert cur == 1 and exporter.journal_slo_burns(journal, fleet, cur) == 1
        journal.close()
        lines[name] = [{k: v for k, v in json.loads(ln).items() if k != "ts"}
                       for ln in path.read_text().splitlines()]
    assert lines["port"] == lines["jax"] == lines["twin"]
    assert [ln["event"] for ln in lines["port"]] == ["slo_burn"]
    assert lines["port"][0]["attrs"]["burn"] == pytest.approx(10.0)


# -- live: a JAX and a port Manager with their ledgers --------------------------------


@pytest.mark.timeout(120)
def test_mixed_managers_journal_ledgers_that_tile(tmp_path, monkeypatch):
    """Both Managers journal a ``goodput_window`` at each gate: the port's
    audit and ``goodput_report`` find the same accounts, every window and
    each ledger tiles, ``Manager.goodput()`` of each agrees with its
    journal, and the lighthouse's badput aggregate sums both digests."""
    path = tmp_path / "journal.jsonl"
    monkeypatch.setenv("TORCHFT_JOURNAL_FILE", str(path))
    monkeypatch.setenv("TORCHFT_DIGEST_INTERVAL_S", "0")
    telemetry.reset_event_log()
    jtelemetry.reset_event_log()
    server = _lighthouse()
    steps = 4
    try:
        def agg():
            c = LighthouseClient(server.address())
            try:
                return _wait(lambda: (lambda f: f if len(f["replicas"]) == 2 and all(
                    (r["digest"] or {}).get("step") == steps - 1 for r in f["replicas"].values()
                ) else None)(c.fleet()))
            finally:
                c.close()

        goodputs, fleet = manager_world(server.address(), ["jax", "torch"], steps, "gp",
                                        on_done=agg)
    finally:
        server.shutdown()
        telemetry.reset_event_log()
        jtelemetry.reset_event_log()
    events = telemetry.load_journal([str(path)])
    rows, problems, report = _audit_equals_the_tool(events)
    assert problems == [] and goodput_report.check(report) == []
    assert sorted(rows) == ["gp0", "gp1"]
    for i, slot in enumerate(("gp0", "gp1")):
        row = rows[slot]
        # One window a gate, and the shutdown's drain window after
        # ``goodput()`` was read.
        assert row["committed_windows"] == steps and row["windows"] == steps + 1
        assert row["incarnations"] == 1
        drain = row["badput_s"]["drain"]
        assert row["accounted_s"] - drain == pytest.approx(goodputs[i]["accounted_s"], abs=1e-3)
        for k in BADPUT_KINDS:
            if k != "drain":
                assert row["badput_s"][k] == pytest.approx(goodputs[i]["badput_s"][k], abs=1e-3)
        assert goodputs[i]["tiling_error_s"] < 1e-6
    sums = [sum(r["digest"]["acct"][BADPUT_KINDS.index(k)] for r in fleet["replicas"].values())
            for k in BADPUT_KINDS]
    for k, want in zip(BADPUT_KINDS, sums):
        assert fleet["agg"]["badput_s"][k] == pytest.approx(want, rel=1e-3, abs=1e-6)
