"""The port's fleet-health plane, held to tests/test_fleet.py: the port's
``StepDigest`` gives the JAX package's wire bytes (at most 512) for the
same fields, worst case and numpy-seeded draws alike, and reads them back
alike; its ``DigestWindow`` gives the same rate, goodput and pruning; the
port's lighthouse and manager clients keep heartbeat compatibility both
ways, land digests in the shared lighthouse's fleet table, its aggregates,
anomaly detector, snapshot cache, anomaly ring and job namespaces; and the
port's Manager pushes its digest on the heartbeat. Mixed: a JAX and a port
manager server's digests side by side in one fleet table, and a JAX and a
port Manager training together, both rows read with a step rate.

``manager_world`` (used by the evidence and goodput files too) runs one
Manager a package in threads against one lighthouse."""

import json
import random
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from torchft_tpu import coordination as jcoord
from torchft_tpu import telemetry as jtelemetry
from torchft_tpu_torch import _net
from torchft_tpu_torch.coordination import (
    LighthouseClient,
    LighthouseServer,
    ManagerClient,
    ManagerServer,
    Quorum,
)
from torchft_tpu_torch.telemetry import DigestWindow, StepDigest

pytestmark = pytest.mark.timeout(60)

@pytest.fixture
def lighthouse():
    # fleet_snap_ms=0: every fleet() read sees the writes just made.
    server = LighthouseServer(min_replicas=2, join_timeout_ms=200, quorum_tick_ms=20,
                              fleet_snap_ms=0)
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


# -- a Manager a package, training together -------------------------------------


def manager_world(addr, packages, steps, prefix, on_done=None, on_step=None):
    """One Manager of each package in ``packages`` (``"torch"`` or
    ``"jax"``) in its own thread, over its package's socket group, against
    the lighthouse at ``addr``: ``steps`` rounds of quorum, an allreduce of
    64 floats and a committed gate each. ``on_step(i, step, manager)`` runs
    after each of replica ``i``'s commits. Once every replica has committed
    its last step, and before any shuts down, ``on_done()`` runs here.
    Returns ``([manager.goodput() of each replica], on_done's value)``."""
    n = len(packages)
    finished = threading.Barrier(n + 1)
    release = threading.Event()
    goodputs = [None] * n
    errors = []

    def replica(i):
        if packages[i] == "jax":
            from torchft_tpu.manager import Manager
            from torchft_tpu.process_group import ProcessGroupSocket

            hold = np.asarray
        else:
            from torchft_tpu_torch.manager import Manager
            from torchft_tpu_torch.process_group import ProcessGroupSocket

            hold = torch.from_numpy
        manager = None
        try:
            manager = Manager(
                pg=ProcessGroupSocket(timeout=15.0), min_replica_size=n,
                use_async_quorum=False, timeout=15.0, quorum_timeout=30.0,
                replica_id=f"{prefix}{i}", lighthouse_addr=addr, group_rank=0,
                group_world_size=1, init_sync=False,
            )
            for step in range(steps):
                manager.start_quorum()
                manager.allreduce(hold(np.full(64, i + 1.0, np.float32))).wait()
                assert manager.should_commit(), f"{packages[i]} step {step}"
                if on_step is not None:
                    on_step(i, step, manager)
            goodputs[i] = manager.goodput()
            finished.wait(60)
            release.wait(60)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            finished.abort()
        finally:
            if manager is not None:
                manager.shutdown()

    threads = [threading.Thread(target=replica, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    view = None
    try:
        finished.wait(90)
        view = on_done() if on_done is not None else None
    except threading.BrokenBarrierError:
        pass
    finally:
        release.set()
        for t in threads:
            t.join(60)
    if errors:
        raise errors[0]
    return goodputs, view


# -- the digest wire: the same bytes ------------------------------------------------


def _worst(cls):
    return cls(
        step=2**53 - 1, rate=123456.789, goodput=0.999999,
        phases={k: [123456.123456, 999999.99999] for k in ("q", "h", "c", "a", "m")},
        peer_gib_s={f"peer-{i:06d}": 123456.789 for i in range(32)},
        errored=True, chaos_injections=2**31, commit_failures=2**31,
    )


def test_digest_worst_case_stays_under_budget_in_the_jax_bytes():
    s = _worst(StepDigest).to_json()
    assert s == _worst(jtelemetry.StepDigest).to_json()
    assert len(s.encode()) <= StepDigest.MAX_WIRE_BYTES == 512
    wire = json.loads(s)
    assert wire["v"] == 1 and wire["step"] == 2**53 - 1
    assert len(wire.get("bw", {})) <= StepDigest.MAX_PEERS


def _random_fields(rng):
    n_peers = int(rng.integers(0, 12))
    return dict(
        step=int(rng.integers(0, 2**40)),
        rate=float(rng.exponential(5.0)),
        goodput=float(rng.random()),
        phases={k: sorted(rng.exponential(0.1, 2).tolist())
                for k in ("q", "h", "c", "a", "m") if rng.random() < 0.7},
        peer_gib_s={str(int(p)): float(rng.exponential(3.0))
                    for p in rng.integers(0, 64, n_peers)},
        errored=bool(rng.random() < 0.2),
        chaos_injections=int(rng.integers(0, 3)) * int(rng.integers(0, 10**6)),
        commit_failures=int(rng.integers(0, 3)),
        acct=(rng.exponential(1000.0, len(jtelemetry.BADPUT_KINDS)).tolist()
              if rng.random() < 0.7 else None),
    )


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_digest_json_bytes_equal_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        fields = _random_fields(rng)
        port, ref = StepDigest(**fields).to_json(), jtelemetry.StepDigest(**fields).to_json()
        assert port == ref
        assert len(port.encode()) <= 512
        wire = json.loads(port)
        assert vars(StepDigest.from_wire(wire)) == vars(jtelemetry.StepDigest.from_wire(wire))


def test_digest_wire_roundtrip():
    digest = StepDigest(step=42, rate=1.25, goodput=0.5, phases={"q": [0.001, 0.002]},
                        peer_gib_s={"1": 2.5}, errored=False, chaos_injections=3,
                        commit_failures=1)
    back = StepDigest.from_wire(json.loads(digest.to_json()))
    assert back.step == 42
    assert back.rate == pytest.approx(1.25) and back.goodput == pytest.approx(0.5)
    assert back.phases["q"] == pytest.approx([0.001, 0.002])
    assert back.peer_gib_s["1"] == pytest.approx(2.5)
    assert back.chaos_injections == 3 and back.commit_failures == 1
    small = json.loads(StepDigest(step=1, rate=0.0, goodput=0.0).to_json())
    assert "chaos" not in small and "cf" not in small


def test_digest_window_rate_goodput_and_pruning():
    def run(cls):
        w = cls(window_s=10.0)
        w.note_gate(1, True, 1.0, now=1.0)
        w.note_gate(2, True, 1.0, now=2.0)
        w.note_gate(3, False, 2.0, now=4.0)
        return w.snapshot(now=4.0), w.snapshot(now=30.0)

    live, aged = run(DigestWindow)
    assert (live, aged) == run(jtelemetry.DigestWindow)
    assert live["step"] == 2
    assert live["rate"] == pytest.approx(2 / 3.0)
    assert live["gp"] == pytest.approx(0.5)
    assert aged == {"step": 2, "rate": 0.0, "gp": 0.0}


# -- heartbeat compatibility, both directions --------------------------------------


def _old_lighthouse():
    """A lighthouse from before the fleet plane: answers every frame with
    ``{"ok": true}`` and records what it got. Returns (address, received,
    thread, socket)."""
    received = []
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def serve():
        conn, _ = lsock.accept()
        try:
            while True:
                req = _net.recv_json(conn, timeout=5)
                received.append(json.loads(bytes(req).decode())
                                if isinstance(req, (bytes, bytearray)) else req)
                _net.send_json(conn, {"ok": True})
        except Exception:  # noqa: BLE001 - the client hung up
            pass

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return f"127.0.0.1:{lsock.getsockname()[1]}", received, t, lsock


def test_new_client_against_old_lighthouse():
    addr, received, t, lsock = _old_lighthouse()
    client = LighthouseClient(addr, connect_timeout=5.0)
    client.heartbeat("compat", digest={"v": 1, "step": 7}, hb_interval_ms=100)
    client.close()
    lsock.close()
    t.join(timeout=5)
    assert received and received[0]["type"] == "heartbeat"
    assert received[0]["digest"]["step"] == 7


def test_old_client_against_new_lighthouse(lighthouse):
    old = LighthouseClient(lighthouse.address())
    old.heartbeat("old-style")
    new = LighthouseClient(lighthouse.address())
    new.heartbeat("new-style", digest={"v": 1, "step": 3, "rate": 1.0}, hb_interval_ms=60000)
    fleet = new.fleet()
    assert fleet["replicas"]["old-style"]["digest"] is None
    assert fleet["replicas"]["old-style"]["digest_age_ms"] is None
    assert fleet["replicas"]["new-style"]["digest"]["step"] == 3
    results = {}

    def join(name):
        c = LighthouseClient(lighthouse.address())
        results[name] = c.quorum(replica_id=name, step=1, timeout=10.0, address=f"addr-{name}")
        c.close()

    threads = [threading.Thread(target=join, args=(n,)) for n in ("old-style", "new-style")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15)
    assert results["old-style"].quorum_id == results["new-style"].quorum_id
    old.close()
    new.close()


@pytest.mark.parametrize("package", ["torch", "mixed"])
def test_manager_heartbeat_piggybacks_digest(lighthouse, package):
    """``set_digest`` on the port's manager server rides the C++ heartbeat
    into the fleet table; in the mixed case a JAX manager server's digest
    sits beside it."""
    servers = {"port": (ManagerServer, ManagerClient)}
    if package == "mixed":
        servers["jax"] = (jcoord.ManagerServer, jcoord.ManagerClient)
    running = []
    lh = LighthouseClient(lighthouse.address())
    try:
        for i, (name, (server_cls, client_cls)) in enumerate(servers.items()):
            mgr = server_cls(replica_id=f"digester-{name}", lighthouse_addr=lighthouse.address(),
                             store_address="store:1", world_size=1, heartbeat_interval_ms=50)
            mc = client_cls(mgr.address())
            running.append((mgr, mc))
            mc.set_digest({"v": 1, "step": 11 + i, "rate": 2.0, "gp": 0.9})
        rows = _wait(lambda: (lambda r: r if all(
            (r.get(f"digester-{n}") or {}).get("digest") for n in servers) else None
        )(lh.fleet()["replicas"]))
        for i, name in enumerate(servers):
            row = rows[f"digester-{name}"]
            assert row["digest"]["step"] == 11 + i, row
            assert row["hb_interval_ms"] == 50
    finally:
        lh.close()
        for mgr, mc in running:
            mc.close()
            mgr.shutdown()


@pytest.mark.timeout(120)
def test_port_manager_pushes_its_digest_beside_a_jax_one(monkeypatch):
    """A JAX and a port Manager train three steps together: each pushes its
    digest at every gate, and before either shuts down the shared
    lighthouse's fleet table holds both at their last committed step (2:
    the digest names the step a gate committed) with a step rate above 0."""
    monkeypatch.setenv("TORCHFT_DIGEST_INTERVAL_S", "0")
    server = LighthouseServer(min_replicas=2, join_timeout_ms=200, quorum_tick_ms=20,
                              fleet_snap_ms=0)
    try:
        def fleet_rows():
            c = LighthouseClient(server.address())
            try:
                return _wait(lambda: (lambda r: r if len(r) == 2 and all(
                    (row["digest"] or {}).get("step") == 2 for row in r.values()
                ) else None)(c.fleet()["replicas"]))
            finally:
                c.close()

        goodputs, rows = manager_world(server.address(), ["jax", "torch"], 3, "dg",
                                       on_done=fleet_rows)
    finally:
        server.shutdown()
    assert {rid.split(":")[0] for rid in rows} == {"dg0", "dg1"}
    for row in rows.values():
        assert row["digest"]["rate"] > 0 and row["digest"]["err"] == 0
        assert len(row["digest"]["acct"]) == len(jtelemetry.BADPUT_KINDS)
    assert all(g["committed_steps"] == 3 for g in goodputs)


# -- fleet aggregation and endpoints ---------------------------------------------------


def _dg(step, rate, gp=1.0, cf=0):
    return {"v": 1, "step": step, "rate": rate, "gp": gp, "err": 0, "cf": cf}


def _http(lighthouse, path):
    with urllib.request.urlopen(f"http://{lighthouse.address()}{path}", timeout=5) as resp:
        return resp.read().decode()


def test_fleet_aggregation_and_endpoints(lighthouse):
    c = LighthouseClient(lighthouse.address())
    c.heartbeat("fa", digest=_dg(10, 1.0, gp=0.8), hb_interval_ms=60000)
    c.heartbeat("fb", digest=_dg(12, 2.0, gp=1.0), hb_interval_ms=60000)
    c.heartbeat("fc")
    agg = c.fleet()["agg"]
    assert agg["n"] == 3 and agg["n_digest"] == 2
    assert agg["median_rate"] == pytest.approx(2.0)  # upper median
    assert agg["median_step"] == 12
    assert agg["median_goodput"] == pytest.approx(1.0)
    assert agg["stragglers"] == 0
    assert set(json.loads(_http(lighthouse, "/fleet.json"))["replicas"]) == {"fa", "fb", "fc"}
    status = c.status()
    assert status["fleet"]["n"] == 3 and "anomaly_seq" in status["fleet"]
    metrics = _http(lighthouse, "/metrics")
    assert "torchft_lighthouse_anomalies_total" in metrics
    assert "torchft_lighthouse_fleet_median_step_rate" in metrics
    c.close()


def test_fleet_leave_removes_row(lighthouse):
    c = LighthouseClient(lighthouse.address())
    c.heartbeat("leaver", digest=_dg(1, 1.0), hb_interval_ms=60000)
    assert "leaver" in c.fleet()["replicas"]
    c.leave("leaver")
    assert "leaver" not in c.fleet()["replicas"]
    c.close()


# -- the online anomaly detector ---------------------------------------------------------

_SEQ = [
    ("ra", _dg(10, 1.0)),
    ("rb", _dg(10, 1.0)),
    ("rb", _dg(10, 1.0, cf=3)),   # commit_stall rises
    ("rb", _dg(10, 0.4)),         # slow_rate rises
    ("rb", _dg(7, 1.0)),          # step_lag rises
    ("rb", _dg(10, 1.0, cf=3)),   # commit_stall again
]


def _drive(addr, seq, client_cls=LighthouseClient):
    client = client_cls(addr)
    for rid, dg in seq:
        client.heartbeat(rid, digest=dg, hb_interval_ms=60000)
    fleet = client.fleet()
    client.close()
    return [(a["seq"], a["kind"], a["replica_id"]) for a in fleet["anomalies"]]


def _fresh_lighthouse(**kw):
    return LighthouseServer(min_replicas=2, join_timeout_ms=200, quorum_tick_ms=20,
                            fleet_snap_ms=kw.pop("fleet_snap_ms", 0), **kw)


def test_anomaly_rules_fire_in_order():
    server = _fresh_lighthouse()
    try:
        anomalies = _drive(server.address(), _SEQ)
    finally:
        server.shutdown()
    assert [(k, r) for _, k, r in anomalies] == [
        ("commit_stall", "rb"), ("slow_rate", "rb"), ("step_lag", "rb"), ("commit_stall", "rb"),
    ]
    assert [s for s, _, _ in anomalies] == [1, 2, 3, 4]


def test_anomaly_stream_is_the_same_from_either_package():
    """The same digest sequence through two fresh lighthouses, once from
    the port's client and once from the JAX one: the same anomalies."""
    runs = []
    for client_cls in (LighthouseClient, jcoord.LighthouseClient):
        server = _fresh_lighthouse()
        try:
            runs.append(_drive(server.address(), _SEQ, client_cls))
        finally:
            server.shutdown()
    assert runs[0] == runs[1] and runs[0]


# -- fleet scale ------------------------------------------------------------------------------


def _upper_median(vals):
    s = sorted(vals)
    return s[len(s) // 2] if s else None


def _recompute_agg(fleet):
    rows = fleet["replicas"]
    digests = [r["digest"] for r in rows.values() if r["digest"]]
    cfs = [int(d.get("cf") or 0) for d in digests]
    return {
        "n": len(rows),
        "n_digest": len(digests),
        "stragglers": sum(1 for r in rows.values() if r["straggler"]),
        "median_rate": _upper_median([d["rate"] for d in digests if d.get("rate")]),
        "median_step": _upper_median([int(d.get("step", 0)) for d in digests]),
        "median_goodput": _upper_median([float(d.get("gp") or 0.0) for d in digests]),
        "max_commit_failures": max(cfs) if cfs else 0,
    }


def test_fleet_incremental_agg_matches_recompute_under_churn():
    """N=1024 with randomized join, digest and leave churn from the port's
    client: the lighthouse's incrementally kept aggregates equal a
    recompute from the rows of the same payload, exactly."""
    rng = random.Random(0xF1EE7)
    server = _fresh_lighthouse()
    try:
        client = LighthouseClient(server.address())

        def rand_dg():
            return {"v": 1, "step": rng.randrange(0, 1000), "rate": rng.randrange(0, 8) * 0.25,
                    "gp": rng.randrange(0, 9) / 8.0, "cf": rng.choice((0, 0, 0, 1, 2, 3))}

        alive, joined = [], 0

        def join():
            nonlocal joined
            rid = f"r{joined:04d}"
            joined += 1
            client.heartbeat(rid, digest=rand_dg(), hb_interval_ms=60000)
            alive.append(rid)

        for _ in range(1024):
            join()
        for _ in range(1000):
            op = rng.random()
            if alive and op < 0.20:
                client.leave(alive.pop(rng.randrange(len(alive))))
            elif op < 0.40:
                join()
            else:
                client.heartbeat(alive[rng.randrange(len(alive))], digest=rand_dg(),
                                 hb_interval_ms=60000)
        fleet = client.fleet(timeout=30.0)
        client.close()
    finally:
        server.shutdown()
    assert set(fleet["replicas"]) == set(alive)
    for key, want in _recompute_agg(fleet).items():
        assert fleet["agg"][key] == want, key
    assert fleet["agg"]["anomalies_dropped"] >= 0
    assert fleet["gen"] > 0 and fleet["snap_ms"] == 0


def test_fleet_snapshot_staleness_bound():
    server = _fresh_lighthouse(fleet_snap_ms=600)
    try:
        c = LighthouseClient(server.address())
        c.heartbeat("s0", digest=_dg(1, 1.0), hb_interval_ms=60000)
        f1 = c.fleet()
        assert f1["snap_ms"] == 600 and "s0" in f1["replicas"]
        c.heartbeat("s1", digest=_dg(2, 2.0), hb_interval_ms=60000)
        f2 = c.fleet()
        assert (f2["gen"], f2["ts_ms"]) == (f1["gen"], f1["ts_ms"])
        assert "s1" not in f2["replicas"]
        f3 = _wait(lambda: (lambda f: f if f["gen"] > f1["gen"] else None)(c.fleet()), 5.0)
        assert "s1" in f3["replicas"]
        # Served from the cache for the whole window, and not for longer.
        assert f3["ts_ms"] - f1["ts_ms"] >= 600
        c.close()
    finally:
        server.shutdown()


def test_anomaly_ring_overflow_is_counted(lighthouse):
    c = LighthouseClient(lighthouse.address())
    for i in range(70):
        c.heartbeat("of", digest=_dg(i + 1, 1.0, cf=3), hb_interval_ms=60000)
        c.heartbeat("of", digest=_dg(i + 1, 1.0, cf=0), hb_interval_ms=60000)
    fleet = c.fleet()
    assert fleet["anomaly_seq"] == 70 and len(fleet["anomalies"]) == 64
    assert fleet["agg"]["anomalies_dropped"] == 6
    assert fleet["anomalies"][-1]["seq"] == 70 and fleet["anomalies"][0]["seq"] == 7
    assert c.status()["fleet"]["anomalies_dropped"] == 6
    assert "torchft_lighthouse_anomalies_dropped 6" in _http(lighthouse, "/metrics")
    c.close()


def test_hb_jitter_flags_closed_gap():
    """A heartbeat gap beyond max(8 x the declared cadence, 1 s) flags
    ``hb_jitter`` when the late heartbeat arrives."""
    server = _fresh_lighthouse()
    try:
        client = LighthouseClient(server.address())
        client.heartbeat("jit", digest=_dg(1, 1.0), hb_interval_ms=100)
        time.sleep(1.3)  # the gap under test, above the 1 s floor
        client.heartbeat("jit", digest=_dg(2, 1.0), hb_interval_ms=100)
        fleet = client.fleet()
        row = fleet["replicas"]["jit"]
        assert "hb_jitter" in row["flags"] and row["straggler"] is True
        assert "hb_jitter" in [a["kind"] for a in fleet["anomalies"]]
        client.close()
    finally:
        server.shutdown()


# -- job namespaces ------------------------------------------------------------------------------


def test_job_namespace_isolation(lighthouse):
    c = LighthouseClient(lighthouse.address())
    for job, rids in (("alpha", ("a0", "a1")), ("beta", ("b0", "b1"))):
        for rid in rids:
            c.heartbeat(rid, digest=_dg(5, 1.0), hb_interval_ms=60000, job=job)

    def form(job, rids):
        out = {}
        clients = [LighthouseClient(lighthouse.address()) for _ in rids]
        threads = [
            threading.Thread(target=lambda cl=cl, r=r: out.setdefault(
                r, cl.quorum(r, timeout=10.0, step=1, job=job)))
            for cl, r in zip(clients, rids)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for cl in clients:
            cl.close()
        return out

    qa = form("alpha", ["a0", "a1"])
    qb = form("beta", ["b0", "b1"])
    assert sorted(m.replica_id for m in qa["a0"].participants) == ["a0", "a1"]
    assert qa["a0"].job == "alpha" and qb["b0"].job == "beta"
    before = c.status()["jobs"]["beta"]
    c.leave("a1", job="alpha")
    c.heartbeat("a0", digest=_dg(6, 1.0, cf=5), hb_interval_ms=60000, job="alpha")
    after = c.status()["jobs"]["beta"]
    for key in ("quorum_id", "quorum_generation", "joins_total", "leaves_total"):
        assert after[key] == before[key], key
    assert after["fleet"]["anomaly_seq"] == before["fleet"]["anomaly_seq"]
    alpha = c.status()["jobs"]["alpha"]
    assert alpha["joins_total"] >= 2 and alpha["fleet"]["anomaly_seq"] >= 1
    a_fleet = c.fleet(job="alpha")
    assert a_fleet["job"] == "alpha"
    assert any(a["kind"] == "commit_stall" for a in a_fleet["anomalies"])
    assert set(a_fleet["replicas"]) == {"a0"}
    assert set(c.fleet(job="beta")["replicas"]) == {"b0", "b1"}
    c.close()


def test_job_wire_backcompat_default_namespace(lighthouse):
    c = LighthouseClient(lighthouse.address())
    c.heartbeat("old-style", digest=_dg(3, 1.0), hb_interval_ms=60000)
    fleet = c.fleet()
    assert "old-style" in fleet["replicas"] and fleet["job"] == "default"
    for key in ("ts_ms", "gen", "replicas", "agg", "anomalies", "anomaly_seq"):
        assert key in fleet, key
    assert "default" in fleet["jobs"] and "districts" in fleet
    assert Quorum.from_json({"quorum_id": 1, "participants": [], "created_ms": 0}).job == "default"
    q = {"quorum_id": 1, "participants": [], "created_ms": 0, "job": "alpha"}
    assert Quorum.from_json(q).job == "alpha"
    assert vars(Quorum.from_json(q)) == vars(jcoord.Quorum.from_json(q))
    scoped = json.loads(_http(lighthouse, "/fleet.json?job=alpha"))
    assert scoped["job"] == "alpha" and "old-style" not in scoped["replicas"]
    c.close()


def test_manager_job_knob_scopes_namespace(monkeypatch):
    server = LighthouseServer(min_replicas=1, join_timeout_ms=200, quorum_tick_ms=20,
                              fleet_snap_ms=0)
    try:
        ma = ManagerServer(replica_id="m-a", lighthouse_addr=server.address(),
                           store_address="store:1", world_size=1, heartbeat_interval_ms=50,
                           job="tenant-a")
        monkeypatch.setenv("TORCHFT_JOB", "tenant-b")
        mb = ManagerServer(replica_id="m-b", lighthouse_addr=server.address(),
                           store_address="store:2", world_size=1, heartbeat_interval_ms=50)
        try:
            results = []
            for mgr in (ma, mb):
                mc = ManagerClient(mgr.address())
                results.append(mc._quorum(group_rank=0, step=0, checkpoint_metadata="",
                                          shrink_only=False, timeout=10.0))
                mc.close()
            ra, rb = results
            assert [m.replica_id for m in ra.quorum.participants] == ["m-a"]
            assert [m.replica_id for m in rb.quorum.participants] == ["m-b"]
            assert (ra.quorum.job, rb.quorum.job) == ("tenant-a", "tenant-b")
        finally:
            ma.shutdown()
            mb.shutdown()
    finally:
        server.shutdown()
