"""The port's control plane and store: the twin of tests/test_coordination.py.

The port's ``LighthouseServer``, ``LighthouseClient``, ``ManagerServer``,
``ManagerClient`` and ``TCPStoreServer``/``StoreClient`` on the shared C++
binaries, live on ephemeral ports with threads as replica groups: quorum
and its timeout, heartbeat and status, the HTTP dashboard and ``/metrics``,
the manager's quorum and heal plan, the ``should_commit`` barrier, leave,
the store, the manager server's exit when the process that spawned it dies
(``--parent-pid``), and ``parse_addr``.

The framed wire is shared: the quorum, heal and barrier subjects also run
with one client of each package on the same servers, and the port's store
serves the JAX package's client. ``parse_addr`` must give the JAX
function's value, or raise its error, on every address form below."""

import select
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from torchft_tpu import _net as j_net
from torchft_tpu import coordination as jcoord
from torchft_tpu import store as jstore
from torchft_tpu_torch import _net as t_net
from torchft_tpu_torch import store as store_mod
from torchft_tpu_torch.coordination import (
    LighthouseClient,
    LighthouseServer,
    ManagerClient,
    ManagerServer,
)

REPO = Path(__file__).resolve().parent.parent
CLIENTS = {"torch": (LighthouseClient, ManagerClient),
           "jax": (jcoord.LighthouseClient, jcoord.ManagerClient)}
# Each pair's second client: the port's, or the JAX package's on the same
# servers.
PEERS = ("torch", "jax")


@pytest.fixture
def lighthouse():
    server = LighthouseServer(min_replicas=2, join_timeout_ms=200, quorum_tick_ms=20)
    yield server
    server.shutdown()


def _join_all(threads, timeout=15) -> None:
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive()


@pytest.mark.parametrize("peer", PEERS)
def test_lighthouse_quorum_two_replicas(lighthouse, peer) -> None:
    results = {}

    def join(name: str, pkg: str) -> None:
        client = CLIENTS[pkg][0](lighthouse.address())
        results[name] = client.quorum(replica_id=name, step=3, timeout=10.0,
                                      address=f"addr-{name}")
        client.close()

    _join_all([threading.Thread(target=join, args=("alpha", "torch")),
               threading.Thread(target=join, args=("beta", peer))])
    assert results["alpha"].quorum_id == results["beta"].quorum_id
    assert sorted(m.replica_id for m in results["alpha"].participants) == ["alpha", "beta"]
    assert ([m.to_json() for m in results["alpha"].participants]
            == [m.to_json() for m in results["beta"].participants])


def test_lighthouse_quorum_timeout(lighthouse) -> None:
    client = LighthouseClient(lighthouse.address())
    with pytest.raises(TimeoutError):
        client.quorum(replica_id="lonely", timeout=0.3)
    client.close()


def test_lighthouse_heartbeat_and_status(lighthouse) -> None:
    client = LighthouseClient(lighthouse.address())
    client.heartbeat("hb-replica")
    assert "hb-replica" in client.status()["heartbeat_ages_ms"]
    client.close()


def test_lighthouse_http_dashboard(lighthouse) -> None:
    client = LighthouseClient(lighthouse.address())
    client.heartbeat("dash-replica")
    client.close()
    with urllib.request.urlopen(f"http://{lighthouse.address()}/status", timeout=5) as resp:
        body = resp.read().decode()
    assert "torchft-tpu lighthouse" in body
    assert "/replica/dash-replica/kill" in body
    assert "/replica/dash-replica/drain" in body
    assert "/drain_all" in body
    # Side-effecting endpoints are POST-only.
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://{lighthouse.address()}/drain_all", timeout=5)
    assert err.value.code == 405
    with urllib.request.urlopen(f"http://{lighthouse.address()}/status.json",
                                timeout=5) as resp:
        assert b"quorum_id" in resp.read()


def test_lighthouse_prometheus_metrics(lighthouse) -> None:
    client = LighthouseClient(lighthouse.address())
    client.heartbeat("prom-replica")
    try:
        with urllib.request.urlopen(f"http://{lighthouse.address()}/metrics",
                                    timeout=5) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            body = resp.read().decode()
    finally:
        client.close()
    assert "# TYPE torchft_lighthouse_quorum_id gauge" in body
    assert 'torchft_lighthouse_heartbeat_age_ms{replica="prom-replica"}' in body
    assert "torchft_lighthouse_participants" in body


@pytest.mark.parametrize("peer", PEERS)
def test_manager_quorum_and_heal(lighthouse, peer) -> None:
    """Two groups; group A lags at step 0 and must heal from group B at
    step 5 (B's client is ``peer``'s): the heal plan, the store from the
    up-to-date primary, and the checkpoint metadata fetched from B."""
    mgr_a = ManagerServer(replica_id="groupA", lighthouse_addr=lighthouse.address(),
                          store_address="storeA:1", world_size=1)
    mgr_b = ManagerServer(replica_id="groupB", lighthouse_addr=lighthouse.address(),
                          store_address="storeB:1", world_size=1)
    results = {}

    def quorum(name: str, addr: str, step: int, pkg: str) -> None:
        client = CLIENTS[pkg][1](addr)
        results[name] = client._quorum(group_rank=0, step=step,
                                       checkpoint_metadata=f"ckpt-{name}",
                                       shrink_only=False, timeout=10.0)
        client.close()

    try:
        _join_all([threading.Thread(target=quorum, args=("a", mgr_a.address(), 0, "torch")),
                   threading.Thread(target=quorum, args=("b", mgr_b.address(), 5, peer))])
        assert results["a"].heal
        assert not results["b"].heal
        assert results["a"].max_step == 5
        assert results["a"].recover_src_manager_address == mgr_b.address()
        assert results["b"].recover_dst_replica_ranks == [results["a"].replica_rank]
        assert results["a"].store_address == "storeB:1"
        client = ManagerClient(results["a"].recover_src_manager_address)
        assert client._checkpoint_metadata(0) == "ckpt-b"
        client.close()
    finally:
        mgr_a.shutdown()
        mgr_b.shutdown()


def test_lighthouse_leave_shrinks_quorum_fast() -> None:
    """A leave removes the member at once (a tombstone keeps a late
    heartbeat from bringing it back), so the survivor's next quorum forms
    at tick speed against a 60 s heartbeat timeout."""
    server = LighthouseServer(min_replicas=1, join_timeout_ms=2000, quorum_tick_ms=20,
                              heartbeat_timeout_ms=60000)
    client = LighthouseClient(server.address())
    try:
        client.heartbeat("stay")
        client.heartbeat("goer")
        results = {}

        def join(name: str) -> None:
            c = LighthouseClient(server.address())
            results[name] = c.quorum(replica_id=name, step=1, timeout=10.0)
            c.close()

        _join_all([threading.Thread(target=join, args=(n,)) for n in ("stay", "goer")])
        assert len(results["stay"].participants) == 2
        client.leave("goer")
        status = client.status()
        assert "goer" not in status["heartbeat_ages_ms"]
        assert status["left"] == ["goer"]
        client.heartbeat("goer")
        assert "goer" not in client.status()["heartbeat_ages_ms"]
        t0 = time.monotonic()
        shrunk = client.quorum(replica_id="stay", step=2, timeout=10.0)
        elapsed = time.monotonic() - t0
        assert [m.replica_id for m in shrunk.participants] == ["stay"]
        assert shrunk.quorum_id > results["stay"].quorum_id
        assert elapsed < 2.0, f"shrink took {elapsed:.1f}s (tick speed expected)"
    finally:
        client.close()
        server.shutdown()


def test_manager_client_leave_stops_heartbeats() -> None:
    server = LighthouseServer(min_replicas=1, join_timeout_ms=2000, quorum_tick_ms=20,
                              heartbeat_timeout_ms=60000)
    mgr = ManagerServer(replica_id="drainer", lighthouse_addr=server.address(),
                        store_address="store:1", world_size=1, heartbeat_interval_ms=50)
    lh_client = LighthouseClient(server.address())
    mgr_client = ManagerClient(mgr.address())
    try:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if "drainer" in lh_client.status()["heartbeat_ages_ms"]:
                break
            time.sleep(0.05)
        assert "drainer" in lh_client.status()["heartbeat_ages_ms"]
        assert mgr_client.leave() is True
        time.sleep(0.3)
        assert mgr.is_alive()
        assert "drainer" not in lh_client.status()["heartbeat_ages_ms"]
    finally:
        lh_client.close()
        mgr_client.close()
        mgr.shutdown()
        server.shutdown()


@pytest.mark.parametrize("peer", PEERS)
def test_manager_should_commit_barrier(lighthouse, peer) -> None:
    """Two ranks of one group vote; one False makes both False, two True
    both True (rank 1's client is ``peer``'s)."""
    mgr = ManagerServer(replica_id="solo", lighthouse_addr=lighthouse.address(),
                        store_address="store:1", world_size=2)
    votes = {}

    def vote(rank: int, value: bool) -> None:
        client = CLIENTS["torch" if rank == 0 else peer][1](mgr.address())
        votes[rank] = client.should_commit(rank, step=1, should_commit=value, timeout=10.0)
        client.close()

    try:
        _join_all([threading.Thread(target=vote, args=(0, True)),
                   threading.Thread(target=vote, args=(1, False))])
        assert votes == {0: False, 1: False}
        _join_all([threading.Thread(target=vote, args=(0, True)),
                   threading.Thread(target=vote, args=(1, True))])
        assert votes == {0: True, 1: True}
    finally:
        mgr.shutdown()


@pytest.mark.parametrize("client_pkg", ["torch", "jax"])
def test_store_basic(client_pkg) -> None:
    """The port's store server with the port's client, and with the JAX
    package's (one protocol)."""
    client_cls = store_mod.StoreClient if client_pkg == "torch" else jstore.StoreClient
    server = store_mod.TCPStoreServer()
    client = client_cls(server.address())
    try:
        client.set("k", b"v1")
        assert client.get("k") == b"v1"
        assert client.check("k")
        assert not client.check("missing")
        with pytest.raises(TimeoutError):
            client.get("missing", timeout=0.2)
        assert client.add("ctr", 2) == 2
        assert client.add("ctr", 3) == 5
        assert client.delete("k")
        p1 = client.with_prefix("torchft/1/0")
        p2 = client.with_prefix("torchft/2/0")
        p1.set("rank0", b"a")
        assert not p2.check("rank0")
        assert p1.get("rank0") == b"a"
        result = {}

        def blocked_get() -> None:
            c = client_cls(server.address())
            result["v"] = c.get("late-key", timeout=5.0)
            c.close()

        t = threading.Thread(target=blocked_get)
        t.start()
        client.set("late-key", b"arrived")
        t.join(timeout=10)
        assert result["v"] == b"arrived"
    finally:
        client.close()
        server.shutdown()


def _alive(pid: int) -> bool:
    """/proc-based, so an unreaped zombie counts as dead."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
        return state not in ("Z", "X")
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False


def _spawn_manager_child(lh_addr: str, replica_id: str, extra: str, ready: str):
    """A Python process that starts the port's ``ManagerServer`` (the
    binary gets ``--parent-pid`` of that process) and prints ``ready``."""
    code = (
        f"import sys, time; sys.path.insert(0, {str(REPO)!r}); "
        "from torchft_tpu_torch.coordination import ManagerServer; "
        f"ms = ManagerServer(replica_id={replica_id!r}, lighthouse_addr={lh_addr!r}, "
        f"store_address='127.0.0.1:1/x', world_size=1{extra}); "
        f"print({ready}, flush=True); time.sleep(60)"
    )
    child = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True)
    ready_fds, _, _ = select.select([child.stdout], [], [], 30)
    assert ready_fds, "the child never printed"
    return child, child.stdout.readline()


def test_manager_server_dies_with_parent():
    """SIGKILL of the process that spawned the port's manager server: the
    server (``--parent-pid``) exits within 10 s instead of heartbeating on
    as an orphan."""
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1)
    child = None
    try:
        child, line = _spawn_manager_child(lh.address(), "orphan:x", "",
                                           "'PID', ms._server._proc.pid")
        assert line.startswith("PID"), line
        server_pid = int(line.split()[1])
        assert _alive(server_pid)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=10)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and _alive(server_pid):
            time.sleep(0.2)
        if _alive(server_pid):
            import os

            os.kill(server_pid, signal.SIGKILL)
            raise AssertionError(f"manager server {server_pid} survived parent SIGKILL")
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait(timeout=10)
        lh.shutdown()


def test_manager_leaves_lighthouse_when_parent_dies():
    """SIGKILL of the trainer process: its manager server's parent-death
    watchdog sends a leave first, so the lighthouse (60 s heartbeat
    timeout) drops the entry within seconds and lists it as left."""
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, heartbeat_timeout_ms=60000)
    client = LighthouseClient(lh.address())
    child = None
    try:
        child, line = _spawn_manager_child(lh.address(), "crasher:x",
                                           ", heartbeat_interval_ms=50", "'READY'")
        assert line.startswith("READY"), line
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if "crasher:x" in client.status()["heartbeat_ages_ms"]:
                break
            time.sleep(0.05)
        assert "crasher:x" in client.status()["heartbeat_ages_ms"]
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=10)
        deadline = time.monotonic() + 8
        while time.monotonic() < deadline:
            if "crasher:x" not in client.status()["heartbeat_ages_ms"]:
                break
            time.sleep(0.1)
        status = client.status()
        assert "crasher:x" not in status["heartbeat_ages_ms"]
        assert "crasher:x" in status["left"]
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait(timeout=10)
        client.close()
        lh.shutdown()


# The JAX test's forms, then more: bare ports, schemes with paths, IPv6 with
# and without a scheme, the wildcard hosts, and malformed input.
ADDR_FORMS = [
    "127.0.0.1:29510", "http://127.0.0.1:29510", "http://example.com:80/", "[::1]:9",
    ":8080", "0.0.0.0:1", "[::]:7", "tcp://host.example:65535/path/x",
    "https://[fe80::1]:443/", "localhost:0", "host:notaport", "noport", "[::1]",
    "http://", "",
]


@pytest.mark.parametrize("addr", ADDR_FORMS)
def test_parse_addr_accepts_reference_url_forms(addr):
    """The port's ``parse_addr`` gives the JAX function's value, or raises
    the same error, on each form; the JAX test's four forms keep their
    values."""
    def call(fn):
        try:
            return ("ok", fn(addr))
        except Exception as e:  # noqa: BLE001 - the error is the value here
            return ("error", type(e).__name__, str(e))

    assert call(t_net.parse_addr) == call(j_net.parse_addr)
    known = {"127.0.0.1:29510": ("127.0.0.1", 29510),
             "http://127.0.0.1:29510": ("127.0.0.1", 29510),
             "http://example.com:80/": ("example.com", 80), "[::1]:9": ("::1", 9)}
    if addr in known:
        assert t_net.parse_addr(addr) == known[addr]
