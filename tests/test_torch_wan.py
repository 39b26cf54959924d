"""The port's degraded-network plane, held to tests/test_wan.py: the
per-peer link policy (``TORCHFT_LINKS``, parsed by the port's
``parse_links`` to the JAX package's ``LinkPolicy`` fields and errors), the
policy's plumbing into the shared C++ engine behind the port's
``ProcessGroupNative``, in-collective stripe failover (one stripe of four
killed mid-allreduce completes bit for bit, no abort, no latched error,
``stripe_failover`` on both ends), the background rejoin of a dead stripe,
the all-stripes abort and latch, and the two-region partition and heal; and
one engine world of a JAX rank and a port rank through the same stripe
kill.

Both packages load the one ``libtftcollectives.so``, so its chaos plane is
shared: ``_native.chaos_init`` from either arms the engine for both."""

import dataclasses
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torchft_tpu import chaos as jchaos
from torchft_tpu import process_group as jpg
from torchft_tpu_torch import _native, chaos, telemetry
from torchft_tpu_torch.process_group import (
    LinkPolicy,
    ProcessGroupNative,
    ProcessGroupSocket,
    ReduceOp,
    parse_links,
)
from torchft_tpu_torch.store import TCPStoreServer

native = pytest.mark.skipif(
    not _native.is_available(), reason="native collective engine unavailable"
)


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    monkeypatch.delenv("TORCHFT_CHAOS", raising=False)
    monkeypatch.delenv("TORCHFT_LINKS", raising=False)
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()
    if _native.is_available():
        _native.chaos_init(" ")


def _run_parallel(fns, timeout=90):
    with ThreadPoolExecutor(max_workers=len(fns)) as pool:
        futures = [pool.submit(fn) for fn in fns]
        return [f.result(timeout=timeout) for f in futures]


@pytest.fixture
def store():
    server = TCPStoreServer()
    yield server
    server.shutdown()


def _make_native(store, world, prefix, timeout=20.0, classes=None):
    classes = classes or [ProcessGroupNative] * world
    groups = [cls(timeout=timeout) for cls in classes]
    _run_parallel(
        [
            lambda r=r: groups[r].configure(f"{store.address()}/{prefix}", r, world)
            for r in range(world)
        ]
    )
    return groups


def _sum(group):
    return jpg.ReduceOp.SUM if isinstance(group, jpg.ProcessGroup) else ReduceOp.SUM


def _allreduce(groups, arrs, timeout=60):
    _run_parallel(
        [
            lambda r=r: groups[r].allreduce(arrs[r], _sum(groups[r])).wait(timeout=timeout)
            for r in range(len(groups))
        ]
    )


def _failovers(group):
    snap = group._engine.fr_snapshot(group._engine.fr_seq())
    return snap.get("failovers", [])


def _alive_masks(group):
    snap = group._engine.fr_snapshot(group._engine.fr_seq())
    return [int(p.get("alive_mask", -1)) for p in snap.get("peers", [])]


def _failing_allreduce(groups, n=256):
    """The errors of the ranks whose allreduce of ``n`` ones failed."""

    def run(rank):
        try:
            groups[rank].allreduce(np.ones(n, np.float32)).wait(timeout=20)
            return None
        except Exception as e:  # noqa: BLE001 - the point of the test
            return e

    return [e for e in _run_parallel([lambda r=r: run(r) for r in range(len(groups))]) if e]


def _reconfigure_and_sum(groups, store, prefix, n):
    def run(rank):
        groups[rank].configure(f"{store.address()}/{prefix}", rank, len(groups))
        arr = np.full(n, float(rank + 1), np.float32)
        groups[rank].allreduce(arr, _sum(groups[rank])).wait(timeout=30)
        return arr

    return _run_parallel([lambda r=r: run(r) for r in range(len(groups))])


# -- link-policy grammar: the same fields and the same errors ----------------

SPECS = [
    "*=wan,streams=8,io_ms=900;1=local,connect_ms=250;2=dcn,q8=1",
    "",
    "*=local",
    "*=local;2=wan,streams=2",
    "0=dcn,q8=0,io_ms=5;*=wan,connect_ms=1",
    " 3 = WAN , streams = 4 ; ",
]
BAD_SPECS = [
    "1",  # no '='
    "1=mars",  # unknown class
    "1=wan,streams",  # override without '='
    "1=wan,zz=3",  # unknown key
    "x=wan",  # non-integer peer
    "1=wan,streams=x",  # non-integer value
]


def _parsed(parse, spec):
    default, per_peer = parse(spec)
    return dataclasses.asdict(default), {
        r: dataclasses.asdict(p) for r, p in sorted(per_peer.items())
    }


@pytest.mark.parametrize("spec", SPECS)
def test_parse_links_equals_the_jax_package(spec):
    assert _parsed(parse_links, spec) == _parsed(jpg.parse_links, spec)


def test_parse_links_round_trip():
    default, per_peer = parse_links(
        "*=wan,streams=8,io_ms=900;1=local,connect_ms=250;2=dcn,q8=1"
    )
    assert default == LinkPolicy(cls="wan", connect_ms=15000, io_ms=900, streams=8, q8=True)
    assert per_peer[1] == LinkPolicy(cls="local", connect_ms=250, io_ms=0, streams=0, q8=False)
    assert per_peer[2].cls == "dcn" and per_peer[2].q8
    assert parse_links("") == (LinkPolicy(), {})


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_parse_links_rejects_what_the_jax_package_rejects(bad):
    with pytest.raises(ValueError) as port:
        parse_links(bad)
    with pytest.raises(ValueError) as ref:
        jpg.parse_links(bad)
    assert str(port.value) == str(ref.value)


def test_link_policy_selection(monkeypatch):
    monkeypatch.setenv("TORCHFT_LINKS", "*=local;2=wan,streams=2")
    pg, ref = ProcessGroupSocket(), jpg.ProcessGroupSocket()
    assert pg.link_policy(0).cls == "local"
    assert pg.link_policy(2).cls == "wan" and pg.link_policy(2).streams == 2
    for peer in range(4):
        assert dataclasses.asdict(pg.link_policy(peer)) == dataclasses.asdict(
            ref.link_policy(peer)
        )


# -- the policy in the engine ------------------------------------------------


@native
@pytest.mark.timeout(60)
def test_native_engine_applies_link_policy(store, monkeypatch):
    """A symmetric spec shows up in the engine's snapshot (link class, one
    health entry a stripe) and a wan/q8 link elevates the wire codec when
    TORCHFT_PG_WIRE pins none."""
    monkeypatch.setenv("TORCHFT_LINKS", "*=wan,streams=2,q8=1")
    monkeypatch.delenv("TORCHFT_PG_WIRE", raising=False)
    groups = _make_native(store, 2, prefix="lp")
    try:
        assert all(g._wire == "int8" for g in groups)
        arrs = [np.ones(4096, np.float32) * (r + 1) for r in range(2)]
        _allreduce(groups, arrs, timeout=20)
        np.testing.assert_allclose(arrs[0], 3.0)
        for g in groups:
            (peer,) = g._engine.fr_snapshot(g._engine.fr_seq()).get("peers", [])
            assert peer["link"] == "wan"
            assert len(peer["stripes"]) == 2
            assert int(peer["alive_mask"]) == 0b11
    finally:
        for g in groups:
            g.shutdown()


# -- in-collective stripe failover --------------------------------------------

# One of four stripes reset on every I/O of the second collective (tag c2).
STRIPE_KILL = "seed:7,spec:reset@data:match=c2|s1"


def _stripe_kill_run(store, prefix, classes, n):
    """A clean allreduce (the reference bits), then the same allreduce with
    ``STRIPE_KILL`` armed. Returns (reference, faulted, groups)."""
    groups = _make_native(store, 2, prefix=prefix, classes=classes)
    ref = [np.arange(n, dtype=np.float32) + r for r in range(2)]
    _allreduce(groups, ref)
    _native.chaos_init(STRIPE_KILL)
    arrs = [np.arange(n, dtype=np.float32) + r for r in range(2)]
    try:
        _allreduce(groups, arrs)
    finally:
        _native.chaos_init(" ")
    return ref, arrs, groups


def _assert_failed_over(groups, ref, arrs):
    for r in range(2):
        assert arrs[r].tobytes() == ref[r].tobytes()
    assert all(g.errored() is None for g in groups)
    for g in groups:
        evs = _failovers(g)
        assert any(
            f["stripe"] == 1 and f["tag"] == "c2" and f["to_stripe"] >= 0 for f in evs
        ), evs
        assert all(m & 0b10 == 0 or m == 0b1111 for m in _alive_masks(g))


@native
@pytest.mark.timeout(120)
def test_one_stripe_kill_mid_allreduce_completes_bitwise(store, tmp_path, monkeypatch):
    """Kill 1 of 4 stripes mid-64MiB allreduce: the collective completes
    with the unfaulted bits, no abort, no latched error, and both ends
    journal the handoff as ``stripe_failover``."""
    path = tmp_path / "journal.jsonl"
    monkeypatch.setenv("TORCHFT_JOURNAL_FILE", str(path))
    telemetry.reset_event_log()
    try:
        ref, arrs, groups = _stripe_kill_run(
            store, "wf", [ProcessGroupNative] * 2, 1 << 24
        )
        try:
            _assert_failed_over(groups, ref, arrs)
        finally:
            for g in groups:
                g.shutdown()
    finally:
        telemetry.reset_event_log()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    fails = [e["attrs"] for e in events if e["event"] == "stripe_failover"]
    # Rank 0's records name peer 1 and rank 1's peer 0: both ends.
    assert {f["peer"] for f in fails if f["tag"] == "c2" and f["stripe"] == 1} == {0, 1}
    assert not any(e["event"] == "pg_abort" for e in events)


@native
@pytest.mark.timeout(120)
def test_mixed_world_stripe_kill_completes_bitwise(store):
    """A JAX rank and a port rank in one engine world: the same stripe kill
    is absorbed on both ends, to the bits of the unfaulted run and to the
    bits of a world of JAX ranks alone."""
    n = 1 << 22
    ref, arrs, groups = _stripe_kill_run(
        store, "wfm", [jpg.ProcessGroupNative, ProcessGroupNative], n
    )
    try:
        _assert_failed_over(groups, ref, arrs)
    finally:
        for g in groups:
            g.shutdown()
    jax_only = [np.arange(n, dtype=np.float32) + r for r in range(2)]
    groups = _make_native(store, 2, prefix="wfj", classes=[jpg.ProcessGroupNative] * 2)
    try:
        _allreduce(groups, jax_only)
    finally:
        for g in groups:
            g.shutdown()
    assert arrs[0].tobytes() == arrs[1].tobytes() == jax_only[0].tobytes()


@native
@pytest.mark.timeout(90)
def test_dead_stripe_rejoins_in_background(store):
    """After a stripe dies, the janitor re-dials it and a later collective
    re-activates it: the alive mask returns to full, journaled as a
    ``dir=rejoin`` failover event."""
    groups = _make_native(store, 2, prefix="rj")
    try:
        _native.chaos_init("seed:7,spec:reset@data:match=c1|s2")
        _allreduce(groups, [np.ones(1 << 20, np.float32) for _ in range(2)], timeout=30)
        _native.chaos_init(" ")
        assert all(m == 0b1011 for g in groups for m in _alive_masks(g))
        healed = False
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and not healed:
            # Each probe is a collective boundary, where a re-dialed
            # stripe is re-activated.
            _allreduce(groups, [np.ones(512, np.float32) for _ in range(2)], timeout=20)
            healed = all(m == 0b1111 for g in groups for m in _alive_masks(g))
            if not healed:
                time.sleep(0.2)
        assert healed, [_alive_masks(g) for g in groups]
        assert any(f["dir"] == "rejoin" for f in _failovers(groups[0]))
    finally:
        _native.chaos_init(" ")
        for g in groups:
            g.shutdown()


@native
@pytest.mark.timeout(90)
def test_all_stripes_dead_still_aborts_and_latches(store):
    """Every stripe and every handoff dead: the collective fails,
    ``errored()`` latches, and a reconfigure recovers."""
    groups = _make_native(store, 2, prefix="wa")
    try:
        _native.chaos_init("seed:7,spec:reset@data:match=c1")
        assert _failing_allreduce(groups), "all-stripe kill must fail the collective"
        assert any(g.errored() is not None for g in groups)
        _native.chaos_init(" ")
        a, _ = _reconfigure_and_sum(groups, store, "wa2", 8)
        np.testing.assert_allclose(a, 3.0)
        assert all(g.errored() is None for g in groups)
    finally:
        _native.chaos_init(" ")
        for g in groups:
            g.shutdown()


@native
@pytest.mark.parametrize(
    "classes", [(ProcessGroupNative,) * 2, (jpg.ProcessGroupNative,) * 2], ids=["port", "jax"]
)
@pytest.mark.timeout(60)
def test_a_stripe_reset_on_one_end_aborts_in_the_shared_engine(store, classes):
    """A fault of the shared C++ engine, pinned for both packages (ROADMAP.md
    section 3): one reset of one stripe-1 leg, injected at one end only
    (``count=1``), is not absorbed by a 16 KiB allreduce. Alone, both ranks
    fail at once with "all stripes to peer dead"; under load one rank has
    been seen to finish while its peer waits out the collective deadline.
    Either way a rank fails and latches, and a reconfigure recovers. A
    reset at both ends (the tests above) is absorbed. When the engine
    absorbs this one too, this test fails: turn it into the
    bitwise-completion contract."""
    groups = _make_native(store, 2, prefix="one-end", classes=list(classes), timeout=5.0)
    try:
        _native.chaos_init("seed:7,spec:reset@data:match=c1|s1:count=1")
        errors = _failing_allreduce(groups, n=4096)
        assert errors, "a one-ended stripe reset was absorbed: the engine is fixed"
        assert all("all stripes to peer dead" in str(e) or isinstance(e, TimeoutError)
                   for e in errors), errors
        assert len(_native.chaos_snapshot()["events"]) == 1
        assert any(g.errored() is not None for g in groups)
        _native.chaos_init(" ")
        a, _ = _reconfigure_and_sum(groups, store, "one-end2", 8)
        np.testing.assert_allclose(a, 3.0)
    finally:
        _native.chaos_init(" ")
        for g in groups:
            g.shutdown()


# -- two-region partition and heal ------------------------------------------


@native
@pytest.mark.timeout(90)
def test_two_region_partition_and_heal(store, monkeypatch):
    """Two one-rank regions joined by a wan link: a link-scoped throttle
    paces the wire and fails nothing; a full partition (every stripe reset)
    fails the collective; the heal (reconfigure) restores agreement."""
    monkeypatch.setenv("TORCHFT_LINKS", "*=wan,streams=2,connect_ms=1000")
    monkeypatch.delenv("TORCHFT_PG_WIRE", raising=False)
    groups = _make_native(store, 2, prefix="tr")
    try:
        _native.chaos_init(
            "seed:11,spec:throttle@data:link=wan:rate=268435456:bucket=1048576"
        )
        arrs = [np.full(1 << 16, float(r + 1), np.float32) for r in range(2)]
        _allreduce(groups, arrs, timeout=30)
        np.testing.assert_allclose(arrs[0], 3.0)
        assert all(g.errored() is None for g in groups)
        assert any(e["kind"] == "throttle" for e in _native.chaos_snapshot()["events"])

        _native.chaos_init("seed:11,spec:reset@data:link=wan")
        assert _failing_allreduce(groups), "a full partition must fail collectives"

        _native.chaos_init(" ")
        a, b = _reconfigure_and_sum(groups, store, "tr2", 16)
        np.testing.assert_allclose(a, 3.0)
        np.testing.assert_allclose(b, 3.0)
        assert all(g.errored() is None for g in groups)
    finally:
        _native.chaos_init(" ")
        for g in groups:
            g.shutdown()
