"""The port's control-plane HA, held to tests/test_lighthouse_ha.py: the
port's ``ManagerServer`` heartbeats every entry of its lighthouse list and
fails over down it when the active entry dies (connection refused, an
unresolvable entry), a drain racing the failover holds its tombstone at
the standby, the port's ``LighthouseServer`` resumes its epoch and quorum
ids across a warm restart from its state directory and a standby takeover
keeps quorum ids monotone; the port's Manager journals the manager
server's lighthouse counters as ``lh_failover``, ``lh_epoch`` and
``rpc_retry`` exactly as the JAX Manager does. Mixed: a JAX and a port
manager server fail over together and form one quorum at the standby.

Live in-process servers on ephemeral ports; every wait polls a condition."""

import threading
import time

import pytest

from torchft_tpu import coordination as jcoord
from torchft_tpu import manager as jmanager
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch.coordination import (
    LighthouseClient,
    LighthouseServer,
    ManagerClient,
    ManagerServer,
)

pytestmark = pytest.mark.timeout(60)


def _wait(pred, deadline_s: float = 10.0, tick_s: float = 0.05):
    """Polls ``pred()`` until truthy; returns its value or fails."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(tick_s)
    pytest.fail(f"condition not met within {deadline_s}s: {pred}")


def _lh(**kw) -> LighthouseServer:
    return LighthouseServer(min_replicas=kw.pop("min_replicas", 1), join_timeout_ms=200,
                            quorum_tick_ms=20, **kw)


def _mgr(replica_id, lh_list, lease_ms=500, cls=ManagerServer):
    return cls(
        replica_id=replica_id,
        lighthouse_addr=lh_list,
        store_address=f"store-{replica_id}:1",
        world_size=1,
        heartbeat_interval_ms=50,
        lighthouse_lease_ms=lease_ms,
    )


def _quorum(mc, step, timeout=15.0):
    return mc._quorum(group_rank=0, step=step, checkpoint_metadata="m",
                      shrink_only=False, timeout=timeout)


def _kill(server):
    server._server._proc.kill()
    server._server._proc.wait()


def _failed_over(mc):
    return lambda: (lambda i: i if int(i["lh"]["failovers"]) >= 1 else None)(mc.info())


class _Journal:
    """A Manager shell holding only what ``_journal_lh_transitions`` uses."""

    @staticmethod
    def of(manager_cls):
        m = manager_cls.__new__(manager_cls)
        m._lh_last = {}
        m.events = []
        m._journal = lambda event, **attrs: m.events.append((event, attrs))
        return m


def test_failover_on_connection_refused_mid_run():
    """The primary dies mid-run: the heartbeat loop fails over to the warm
    standby within the lease, the next quorum lands there under a bumped
    epoch, and the port's Manager journals the failover and the epoch from
    the quorum results' counters."""
    threads_before = threading.active_count()
    primary = _lh()
    standby = _lh(standby=True)
    mgr = _mgr("ha0", f"{primary.address()},{standby.address()}")
    mc = ManagerClient(mgr.address())
    try:
        lh_c = LighthouseClient(primary.address())
        _wait(lambda: "ha0" in lh_c.status()["heartbeat_ages_ms"])
        lh_c.close()
        r1 = _quorum(mc, 1)
        assert int(r1.lh.get("epoch", 0)) == 1

        _kill(primary)
        info = _wait(_failed_over(mc))
        assert int(info["lh"]["active"]) == 1
        assert info["lh"]["addr"] == standby.address()

        r2 = _quorum(mc, 2)
        assert int(r2.lh.get("epoch", 0)) == 2
        assert r2.quorum.quorum_id > r1.quorum.quorum_id
        sb_c = LighthouseClient(standby.address())
        st = sb_c.status()
        assert st["role"] == "active" and int(st["takeovers"]) == 1
        sb_c.close()
    finally:
        mc.close()
        mgr.shutdown()
        standby.shutdown()
        primary.shutdown()
    _wait(lambda: threading.active_count() <= threads_before)
    port = _Journal.of(tmanager.Manager)
    for lh in (r1.lh, r2.lh):
        port._journal_lh_transitions(lh)
    assert [e for e, _ in port.events] == ["lh_epoch", "lh_failover", "lh_epoch"]
    failover = port.events[1][1]
    assert failover["failovers"] == 1 and failover["lh_addr"] == standby.address()
    assert port.events[2][1]["epoch"] == 2 and port.events[2][1]["prev_epoch"] == 1


# Counter snapshots as a manager server reports them on quorum results:
# a failover with its evidence, an epoch bump, connect retries, a repeat.
LH_SNAPSHOTS = [
    {},
    {"active": 0, "addr": "a:1", "failovers": 0, "epoch": 1, "unreachable_retries": 0},
    {"active": 0, "addr": "a:1", "failovers": 0, "epoch": 1, "unreachable_retries": 0},
    {"active": 1, "addr": "b:2", "failovers": 1, "epoch": 1, "unreachable_retries": 3,
     "detect_ms": 412, "evidence": "lease"},
    {"active": 1, "addr": "b:2", "failovers": 1, "epoch": 2, "unreachable_retries": 3},
    {"active": 0, "addr": "a:1", "failovers": 2, "epoch": 3, "unreachable_retries": 7,
     "detect_ms": 90, "evidence": "evidence"},
    {"active": 0, "addr": "a:1", "failovers": 2, "epoch": 3, "unreachable_retries": 7},
]


def test_lh_transitions_journal_as_the_jax_manager_journals_them():
    port, ref = _Journal.of(tmanager.Manager), _Journal.of(jmanager.Manager)
    for lh in LH_SNAPSHOTS:
        port._journal_lh_transitions(lh)
        ref._journal_lh_transitions(lh)
    assert port.events == ref.events
    assert [e for e, _ in port.events] == [
        "lh_epoch", "lh_failover", "rpc_retry", "lh_epoch",
        "lh_failover", "lh_epoch", "rpc_retry",
    ]
    assert port.events[2][1] == {"rpc": "lighthouse_quorum", "retries": 3, "total_retries": 3}


def test_unresolvable_address_in_failover_list():
    """A garbage entry in the list costs one failover hop, not a wedge."""
    live = _lh()
    mgr = _mgr("ha-dns", f"host.invalid:19999,{live.address()}", lease_ms=400)
    mc = ManagerClient(mgr.address())
    try:
        lh_c = LighthouseClient(live.address())
        _wait(lambda: "ha-dns" in lh_c.status()["heartbeat_ages_ms"], 15.0)
        info = _wait(_failed_over(mc), 15.0)
        assert info["lh"]["addr"] == live.address()
        assert _quorum(mc, 1).quorum.quorum_id >= 1
        lh_c.close()
    finally:
        mc.close()
        mgr.shutdown()
        live.shutdown()


def test_drain_racing_failover_no_resurrection():
    """Kill the primary and drain at once: ``leave()`` walks the list to
    the standby, and the tombstone holds against in-flight heartbeats."""
    primary = _lh()
    standby = _lh(standby=True)
    mgr = _mgr("drainer", f"{primary.address()},{standby.address()}", lease_ms=400)
    mc = ManagerClient(mgr.address())
    try:
        lh_c = LighthouseClient(primary.address())
        _wait(lambda: "drainer" in lh_c.status()["heartbeat_ages_ms"])
        lh_c.close()
        _kill(primary)
        assert mc.leave(timeout=10.0) is True
        sb_c = LighthouseClient(standby.address())
        _wait(lambda: "drainer" not in sb_c.status()["heartbeat_ages_ms"])
        # Several heartbeat intervals later the tombstone still holds.
        time.sleep(0.5)
        assert "drainer" not in sb_c.status()["heartbeat_ages_ms"]
        sb_c.close()
    finally:
        mc.close()
        mgr.shutdown()
        standby.shutdown()
        primary.shutdown()


def test_warm_restart_monotone_quorum_ids(tmp_path):
    """Same state directory across a stop and start: the epoch survives
    and quorum ids resume strictly above the earlier ones."""
    state_dir = str(tmp_path / "lh_state")
    first = _lh(state_dir=state_dir)
    c = LighthouseClient(first.address())
    q1 = c.quorum(replica_id="wr0", timeout=10.0, address="a0")
    st1 = c.status()
    c.close()
    first.shutdown()
    assert int(st1["epoch"]) == 1

    second = _lh(state_dir=state_dir)
    try:
        c = LighthouseClient(second.address())
        st2 = c.status()
        assert int(st2["epoch"]) == 1 and st2["role"] == "active"
        q2 = c.quorum(replica_id="wr0", timeout=10.0, address="a0")
        assert q2.quorum_id > q1.quorum_id
        assert q2.epoch == q1.epoch == 1
        c.close()
    finally:
        second.shutdown()


def test_standby_takeover_resumes_quorum_numbering():
    """The heartbeat-carried quorum-id high-water mark keeps ids strictly
    monotone across a takeover by a standby that has no snapshot."""
    primary = _lh()
    standby = _lh(standby=True)
    mgr = _mgr("mono", f"{primary.address()},{standby.address()}", lease_ms=400)
    mc = ManagerClient(mgr.address())
    try:
        last = None
        for step in range(1, 4):
            last = _quorum(mc, step)
        sb_c = LighthouseClient(standby.address())
        _wait(lambda: int(sb_c.status()["observed_quorum_id"]) >= last.quorum.quorum_id)
        _kill(primary)
        _wait(lambda: int(mc.info()["lh"]["failovers"]) >= 1)
        r = _quorum(mc, 4)
        assert r.quorum.quorum_id > last.quorum.quorum_id
        assert r.quorum.epoch > last.quorum.epoch
        sb_c.close()
    finally:
        mc.close()
        mgr.shutdown()
        standby.shutdown()
        primary.shutdown()


def _joint_quorum(clients, step):
    """One quorum round of every client, each in its own thread."""
    out = [None] * len(clients)

    def run(i):
        out[i] = _quorum(clients[i], step, timeout=20.0)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert all(r is not None for r in out), out
    return out


def test_jax_and_port_managers_fail_over_together():
    """A JAX manager server and a port one against one primary and standby:
    one quorum of both at the primary, the primary killed, both fail over,
    and the next quorum of both forms at the standby under epoch 2, with
    one quorum id for the two."""
    primary = _lh(min_replicas=2)
    standby = _lh(min_replicas=2, standby=True)
    lh_list = f"{primary.address()},{standby.address()}"
    servers = [_mgr("mix-jax", lh_list, cls=jcoord.ManagerServer),
               _mgr("mix-port", lh_list)]
    clients = [jcoord.ManagerClient(servers[0].address()), ManagerClient(servers[1].address())]
    try:
        before = _joint_quorum(clients, 1)
        assert {int(r.lh.get("epoch", 0)) for r in before} == {1}
        assert len({r.quorum.quorum_id for r in before}) == 1
        _kill(primary)
        for mc in clients:
            assert _wait(_failed_over(mc))["lh"]["addr"] == standby.address()
        after = _joint_quorum(clients, 2)
        assert {int(r.lh.get("epoch", 0)) for r in after} == {2}
        assert len({r.quorum.quorum_id for r in after}) == 1
        assert after[0].quorum.quorum_id > before[0].quorum.quorum_id
        assert sorted(m.replica_id for m in after[1].quorum.participants) == [
            "mix-jax", "mix-port"
        ]
    finally:
        for mc in clients:
            mc.close()
        for s in servers:
            s.shutdown()
        standby.shutdown()
        primary.shutdown()
