"""The port's chaos plane, held to tests/test_chaos.py: the spec grammar
and every schedule rule of ``torchft_tpu_torch.chaos`` give the JAX
package's rules, errors and decisions (site by site, on a numpy-seeded
stream of visits, and in the journal), and the port's hooks fire where the
JAX package's do: the ctrl plane (the retried and journaled ``rpc_drop``,
the deadline-clipped ``rpc_delay``), the srv plane (the C++ lighthouse
armed from the environment), the heal plane (``ckpt_truncate`` in the
port's HTTP transport, read by either package), the data plane of the
port's socket group, and the engine's own plane through ``_native.chaos_*``
behind the port's ``ProcessGroupNative``, with the error latches of both
process groups. Mixed worlds: a JAX and a port socket group under one
seeded stall, a JAX and a port engine rank under one reset.

The decision-hash goldens are pinned in tests/test_torch_base.py."""

import dataclasses
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torchft_tpu import chaos as jchaos
from torchft_tpu import process_group as jpg
from torchft_tpu import telemetry as jtelemetry
from torchft_tpu_torch import _native, chaos, telemetry
from torchft_tpu_torch.process_group import (
    ProcessGroupNative,
    ProcessGroupSocket,
    ReduceOp,
)
from torchft_tpu_torch.store import TCPStoreServer

PACKAGES = {"torch": chaos, "jax": jchaos}

native = pytest.mark.skipif(
    not _native.is_available(), reason="native collective engine unavailable"
)


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    """Every test starts and ends with chaos disarmed on every plane."""
    monkeypatch.delenv("TORCHFT_CHAOS", raising=False)
    for mod in PACKAGES.values():
        mod.reset()
    yield
    for mod in PACKAGES.values():
        mod.reset()
    if _native.is_available():
        _native.chaos_init(" ")


def _run_parallel(fns, timeout=60):
    with ThreadPoolExecutor(max_workers=len(fns)) as pool:
        futures = [pool.submit(fn) for fn in fns]
        return [f.result(timeout=timeout) for f in futures]


@pytest.fixture
def store():
    server = TCPStoreServer()
    yield server
    server.shutdown()


def _rule(mod, kind="stall", plane="data", **kw):
    return mod.parse_rule(
        ":".join([f"{kind}@{plane}"] + [f"{k}={v}" for k, v in kw.items()]), 0
    )


def _both(fn):
    """``fn(module)`` for the port and the JAX package; asserts the two
    results equal and returns the port's."""
    port, ref = fn(chaos), fn(jchaos)
    assert port == ref
    return port


def _rules(rules):
    return [dataclasses.asdict(r) for r in rules]


# -- spec grammar --------------------------------------------------------------

FULL_SPEC = (
    "seed:7,spec:reset@ctrl:match=quorum:after=2:count=1;"
    "stall@data:peer=1:ms=250:every=4;"
    "partial_write@any:frac=0.25:step=3-9;"
    "rpc_drop@ctrl:p=0.5"
)


def test_parse_spec_full_grammar():
    seed, rules = _both(lambda m: (lambda s, r: (s, _rules(r)))(*m.parse_spec(FULL_SPEC)))
    assert seed == 7
    assert [r["kind"] for r in rules] == ["reset", "stall", "partial_write", "rpc_drop"]
    assert rules[0]["match"] == "quorum" and rules[0]["after"] == 2
    assert rules[0]["count"] == 1 and rules[0]["index"] == 0
    assert rules[1]["peer"] == "1" and rules[1]["ms"] == 250 and rules[1]["every"] == 4
    assert rules[2]["plane"] == "any" and rules[2]["frac"] == 0.25
    assert (rules[2]["step_lo"], rules[2]["step_hi"]) == (3, 9)
    assert rules[3]["p"] == 0.5 and rules[3]["index"] == 3


ROUNDTRIP_SPECS = [
    "seed:42,spec:stall@data:peer=0:ms=60:every=5:count=4;"
    "ckpt_truncate@heal:match=5:count=1:frac=0.5;"
    "rpc_delay@ctrl:step=2-:p=0.25:after=1:ms=120",
    "seed:3,spec:preempt@any:p=0.5:grace=90000",
    "seed:11,spec:throttle@data:link=wan:rate=268435456:bucket=1048576",
    "seed:7,spec:reset@data:match=c2|s1",
]


@pytest.mark.parametrize("text", ROUNDTRIP_SPECS)
def test_spec_roundtrip(text):
    def roundtrip(mod):
        seed, rules = mod.parse_spec(text)
        again_seed, again = mod.parse_spec(mod.Chaos(seed, rules).spec())
        assert again_seed == seed
        assert [r.spec() for r in again] == [r.spec() for r in rules]
        return mod.Chaos(seed, rules).spec()

    _both(roundtrip)


BAD_SPECS = [
    "reset@ctrl",  # missing seed prefix
    "seed:x,spec:reset@ctrl",  # non-integer seed
    "seed:1,spec:",  # no rules
    "seed:1,spec:;;",  # no rules after split
    "seed:1,spec:bogus@ctrl",  # unknown kind
    "seed:1,spec:reset@nowhere",  # unknown plane
    "seed:1,spec:reset",  # missing @plane
    "seed:1,spec:reset@ctrl:p=1.5",  # p outside [0,1]
    "seed:1,spec:reset@ctrl:frac=-1",  # frac outside [0,1]
    "seed:1,spec:reset@ctrl:junk",  # param without '='
    "seed:1,spec:reset@ctrl:zz=1",  # unknown param
    "seed:1,spec:reset@ctrl:after=x",  # non-integer param
    "seed:1,spec:preempt@any:grace=-1",  # negative grace window
]


@pytest.mark.parametrize("bad", BAD_SPECS)
def test_parse_spec_rejects_what_the_jax_package_rejects(bad):
    messages = []
    for mod in PACKAGES.values():
        with pytest.raises(mod.ChaosSpecError) as err:
            mod.parse_spec(bad)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_bad_env_spec_fails_init(monkeypatch):
    monkeypatch.setenv("TORCHFT_CHAOS", "seed:1,spec:bogus@ctrl")
    with pytest.raises(chaos.ChaosSpecError):
        chaos.init_from_env(force=True)


# -- schedule semantics: the same decisions -------------------------------------


def _fired(mod, rules, n, *args, **kw):
    st = mod.Chaos(1, rules(mod))
    return [v for v in range(n) if st.pick(*args, **kw) is not None]


def test_after_every_count_schedule():
    fired = _both(lambda m: _fired(
        m, lambda m: [_rule(m, after=2, every=3, count=2)], 12, "stall", "data", "send:0"
    ))
    assert fired == [2, 5]


def test_count_default_unlimited():
    assert _both(lambda m: _fired(
        m, lambda m: [_rule(m)], 20, "stall", "data", "send:0"
    )) == list(range(20))


def test_visit_counters_are_per_site():
    def run(mod):
        st = mod.Chaos(1, [_rule(mod, after=1)])
        return [
            None if inj is None else inj.visit
            for inj in (st.pick("stall", "data", s) for s in ("send:0", "send:1") * 2)
        ]

    assert _both(run) == [None, None, 1, 1]


def test_first_match_wins_but_all_counters_bump():
    def run(mod):
        rules = [_rule(mod, count=1), _rule(mod)]
        rules[1].index = 1
        st = mod.Chaos(1, rules)
        return [(i.rule, i.visit) for i in (st.pick("stall", "data", "send:0") for _ in range(2))]

    assert _both(run) == [(0, 0), (1, 1)]


def test_nonmatching_pick_does_not_bump_counter():
    def run(mod):
        st = mod.Chaos(1, [_rule(mod, kind="rpc_drop", plane="ctrl", match="quorum")])
        misses = [st.pick("rpc_drop", "ctrl", "rpc:x", match="heartbeat") for _ in range(3)]
        inj = st.pick("rpc_drop", "ctrl", "rpc:x", match="quorum")
        return misses, inj.visit

    assert _both(run) == ([None] * 3, 0)


def test_peer_filter_is_substring():
    def run(mod):
        st = mod.Chaos(1, [_rule(mod, peer="10.0.0.2")])
        return [
            st.pick("stall", "data", "s", peer=p) is not None
            for p in ("10.0.0.1", "10.0.0.2:1234")
        ]

    assert _both(run) == [False, True]


def test_step_window():
    def run(mod):
        st = mod.Chaos(1, [_rule(mod, step="5-7")])
        picks = [st.pick("stall", "data", "s", step=s) for s in (None, 4, 5, 8, 7)]
        return [None if i is None else i.visit for i in picks]

    # Windowed rules never fire (nor count visits) while the step is unknown.
    assert _both(run) == [None, None, 0, None, 1]


def test_plane_any_matches_everything():
    def run(mod):
        st = mod.Chaos(1, [_rule(mod, plane="any")])
        return [st.pick("stall", p, f"s:{p}") is not None for p in ("ctrl", "data", "heal", "srv")]

    assert _both(run) == [True] * 4


def test_set_step_notifies_listeners_once():
    seen = []
    chaos.on_step_change(seen.append)
    chaos.on_step_change(seen.append)  # deduped
    chaos.set_step(9)
    assert seen == [9]
    assert chaos.current_step() == 9


# A spec with every filter and schedule parameter, and the visits a numpy
# seed draws against it: the two packages must make each decision alike.
STREAM_SPEC = (
    "seed:1234,spec:stall@data:peer=1:ms=5:every=3;"
    "reset@data:match=c2:after=1:count=3;"
    "rpc_drop@ctrl:p=0.35:step=2-6;"
    "rpc_delay@ctrl:match=quorum:p=0.6:ms=40;"
    "partial_write@any:frac=0.25:every=2:count=5;"
    "ckpt_truncate@heal:match=7:count=1;"
    "throttle@data:link=wan:rate=1000:bucket=64;"
    "stall@srv:match=status:p=0.5:ms=1"
)
STREAM_KINDS = ("stall", "reset", "rpc_drop", "rpc_delay", "partial_write",
                "ckpt_truncate", "throttle")
STREAM_PLANES = ("data", "ctrl", "heal", "srv")
STREAM_MATCHES = (None, "c1", "c2", "c12", "quorum", "heartbeat", "status", "7")
STREAM_PEERS = (None, "0", "1", "10.0.0.1:5", "2")


def _visit_stream(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        step = int(rng.integers(-1, 9))
        out.append((
            STREAM_KINDS[rng.integers(len(STREAM_KINDS))],
            STREAM_PLANES[rng.integers(len(STREAM_PLANES))],
            f"site:{int(rng.integers(4))}",
            STREAM_PEERS[rng.integers(len(STREAM_PEERS))],
            STREAM_MATCHES[rng.integers(len(STREAM_MATCHES))],
            None if step < 0 else step,
        ))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decisions_equal_the_jax_package_site_by_site(seed):
    visits = _visit_stream(seed, 2000)

    def run(mod):
        mod.set_link_class("2", "wan")
        st = mod.Chaos(*mod.parse_spec(STREAM_SPEC))
        out = []
        for kind, plane, site, peer, match, step in visits:
            inj = st.pick(kind, plane, site, peer=peer, match=match, step=step)
            out.append(None if inj is None else dataclasses.asdict(inj))
        return out, st.injections_fired()

    decisions, fired = _both(run)
    assert 20 < fired < len(visits)
    assert {d["kind"] for d in decisions if d} >= {"stall", "reset", "rpc_drop", "partial_write"}


# -- determinism ------------------------------------------------------------------


def _p_visits(mod, seed, p, n=300, site="send:0"):
    st = mod.Chaos(seed, [_rule(mod, p=p)])
    return [v for v in range(n) if st.pick("stall", "data", site) is not None]


def test_probabilistic_rule_same_seed_identical():
    a = _both(lambda m: _p_visits(m, 42, 0.3))
    assert a == _p_visits(chaos, 42, 0.3)
    assert 0.15 < len(a) / 300 < 0.45


def test_probabilistic_rule_seed_changes_schedule():
    assert _both(lambda m: _p_visits(m, 1, 0.3)) != _both(lambda m: _p_visits(m, 2, 0.3))


def test_deterministic_across_thread_interleaving():
    """Concurrent visits at one site race for visit numbers, but the set of
    fired visits depends only on (seed, rule, site, visit): the JAX
    package's set."""

    def run(mod):
        st = mod.Chaos(9, [_rule(mod, p=0.4)])
        fired = []

        def worker():
            for _ in range(50):
                inj = st.pick("stall", "data", "send:0")
                if inj is not None:
                    fired.append(inj.visit)

        _run_parallel([worker] * 4)
        return sorted(fired)

    assert run(chaos) == run(chaos) == _p_visits(jchaos, 9, 0.4, n=200)


# -- off path -----------------------------------------------------------------------


def test_unset_env_means_no_state():
    assert chaos.init_from_env(force=True) is None
    assert chaos.active() is None
    assert chaos._STATE is None and chaos._INITED
    assert chaos.maybe("stall", "data", "s") is None
    assert chaos.maybe_stall("data", "s") is None
    chaos.check_connect("data", "peer")  # must not raise


def test_env_round_trip(monkeypatch):
    monkeypatch.setenv("TORCHFT_CHAOS", "seed:11,spec:reset@data:match=c1:count=1")
    st = chaos.init_from_env(force=True)
    assert st is not None and st.seed == 11
    assert chaos.active() is st
    monkeypatch.setenv("TORCHFT_CHAOS", "seed:12,spec:stall@data")
    assert chaos.init_from_env() is st


def test_scope_nests_and_restores():
    assert chaos._scope_ctx() is None
    with chaos.scope("ctrl", peer="a", match="quorum"):
        assert chaos._scope_ctx() == ("ctrl", "a", "quorum")
        with chaos.scope("data", peer="b"):
            assert chaos._scope_ctx() == ("data", "b", None)
        assert chaos._scope_ctx() == ("ctrl", "a", "quorum")
    assert chaos._scope_ctx() is None


# -- preempt ------------------------------------------------------------------------


def test_preempt_grace_param_roundtrip():
    def run(mod):
        seed, rules = mod.parse_spec("seed:3,spec:preempt@any:p=0.5:grace=90000")
        again = mod.parse_spec(mod.Chaos(seed, rules).spec())[1]
        plain = mod.parse_spec("seed:3,spec:preempt@any")[1][0].spec()
        return rules[0].kind, rules[0].grace, again[0].spec() == rules[0].spec(), plain

    kind, grace, same, plain = _both(run)
    assert (kind, grace, same) == ("preempt", 90000, True)
    assert "grace" not in plain


def test_preempt_injection_carries_grace():
    def run(mod):
        inj = mod.Chaos(1, [_rule(mod, kind="preempt", plane="any", grace=1500)]).pick(
            "preempt", "any", "drill/group0"
        )
        other = mod.Chaos(1, [_rule(mod, ms=5)]).pick("stall", "data", "s")
        return inj.kind, inj.grace, other.grace

    assert _both(run) == ("preempt", 1500, 0)


def test_preempt_seeded_victim_set_is_deterministic():
    def victims(mod, seed):
        st = mod.Chaos(seed, [_rule(mod, kind="preempt", plane="any", p=0.5)])
        return [g for g in range(8) if st.pick("preempt", "any", f"drill/group{g}") is not None]

    plan = _both(lambda m: victims(m, 77))
    assert plan == victims(chaos, 77)
    assert any(plan != _both(lambda m, s=s: victims(m, s)) for s in range(78, 90))


# -- journal attribution ------------------------------------------------------------


def _journaled_injection(mod, tel, path, monkeypatch):
    monkeypatch.setenv("TORCHFT_JOURNAL_FILE", str(path))
    tel.reset_event_log()
    try:
        mod.install(7, [_rule(mod, kind="rpc_delay", plane="ctrl", ms=1)])
        mod.set_step(3)
        assert mod.maybe("rpc_delay", "ctrl", "rpc:quorum", peer="lh", match="quorum")
    finally:
        tel.reset_event_log()
        mod.reset()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    [ev] = [e for e in events if e["event"] == "chaos_inject"]
    return ev


def test_injection_journaled_as_the_jax_package_journals_it(tmp_path, monkeypatch):
    ev = _journaled_injection(chaos, telemetry, tmp_path / "t.jsonl", monkeypatch)
    ref = _journaled_injection(jchaos, jtelemetry, tmp_path / "j.jsonl", monkeypatch)
    assert ev["step"] == 3
    attrs = ev["attrs"]
    assert attrs["kind"] == "rpc_delay" and attrs["plane"] == "ctrl"
    assert attrs["site"] == "rpc:quorum" and attrs["rule"] == 0
    assert attrs["visit"] == 0 and attrs["seq"] == 1
    assert attrs["peer"] == "lh" and attrs["match"] == "quorum"
    assert attrs == ref["attrs"]
    assert {k for k in ev if k != "ts"} == {k for k in ref if k != "ts"}


# -- ctrl plane: rpc faults and retry -------------------------------------------------


@pytest.mark.timeout(60)
def test_rpc_drop_is_retried_and_journaled(tmp_path, monkeypatch):
    from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer

    path = tmp_path / "journal.jsonl"
    monkeypatch.setenv("TORCHFT_JOURNAL_FILE", str(path))
    telemetry.reset_event_log()
    server = LighthouseServer(min_replicas=1, join_timeout_ms=200, quorum_tick_ms=20)
    try:
        chaos.install(3, [chaos.parse_rule("rpc_drop@ctrl:match=status:count=1", 0)])
        client = LighthouseClient(server.address())
        assert isinstance(client.status(), dict)  # first attempt dropped
        assert chaos.active().injections_fired() == 1
        client.close()
    finally:
        server.shutdown()
        telemetry.reset_event_log()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    retries = [e for e in events if e["event"] == "rpc_retry"]
    assert len(retries) == 1
    assert retries[0]["attrs"]["rpc"] == "status"
    assert retries[0]["attrs"]["attempt"] == 1
    assert "chaos" in retries[0]["attrs"]["error"]
    [inj] = [e for e in events if e["event"] == "chaos_inject"]
    assert inj["attrs"]["kind"] == "rpc_drop" and inj["attrs"]["match"] == "status"


@pytest.mark.timeout(60)
def test_rpc_delay_bounded_by_call_budget():
    from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer

    server = LighthouseServer(min_replicas=1, join_timeout_ms=200, quorum_tick_ms=20)
    try:
        chaos.install(3, [chaos.parse_rule("rpc_delay@ctrl:match=status:ms=10000", 0)])
        client = LighthouseClient(server.address())
        t0 = time.monotonic()
        try:
            client.status(timeout=1.5)
        except TimeoutError:
            pass  # the delay spent the budget: also acceptable
        assert time.monotonic() - t0 < 5.0
        client.close()
    finally:
        server.shutdown()


# -- srv plane: the C++ lighthouse armed from the environment -------------------------


@pytest.mark.timeout(60)
def test_lighthouse_server_injects_from_the_environment(monkeypatch):
    """The port's ``LighthouseServer`` hands ``TORCHFT_CHAOS`` to the C++
    binary, whose framed-RPC handler delays the first two ``status`` calls;
    the client's own plane stays off."""
    from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer

    monkeypatch.setenv("TORCHFT_CHAOS", "seed:7,spec:rpc_delay@srv:match=status:ms=400:count=2")
    server = LighthouseServer(min_replicas=1, join_timeout_ms=200, quorum_tick_ms=20)
    monkeypatch.delenv("TORCHFT_CHAOS")
    chaos.reset()
    try:
        client = LighthouseClient(server.address())
        walls = []
        for _ in range(3):
            t0 = time.monotonic()
            client.status(timeout=10.0)
            walls.append(time.monotonic() - t0)
        client.close()
    finally:
        server.shutdown()
    assert walls[0] >= 0.35 and walls[1] >= 0.35, walls
    assert walls[2] < 0.3, walls
    assert chaos.active() is None


# -- heal plane: a truncated checkpoint stream --------------------------------------


@pytest.mark.parametrize("receiver", ["torch", "jax"])
@pytest.mark.timeout(60)
def test_ckpt_truncate_fails_the_heal_fetch(receiver, tmp_path, monkeypatch):
    """A seeded ``ckpt_truncate`` cuts the port sender's stream partway:
    the port's and the JAX package's receivers both fail the fetch instead
    of handing back a torn state, and the injection is journaled on the
    heal plane. In both packages the receiver's metadata request visits the
    rule first and takes one firing (its reply is never truncated), so the
    rule needs ``count=2`` to reach the stream."""
    import torch

    from torchft_tpu.checkpointing.http_transport import HTTPTransport as JHTTPTransport
    from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

    path = tmp_path / "journal.jsonl"
    monkeypatch.setenv("TORCHFT_JOURNAL_FILE", str(path))
    telemetry.reset_event_log()
    chaos.install(5, [chaos.parse_rule("ckpt_truncate@heal:match=4:count=2:frac=0.5", 0)])
    state = {"w": torch.arange(1 << 16, dtype=torch.float32), "step": 4}
    sender = HTTPTransport(num_chunks=0)
    recv = (HTTPTransport if receiver == "torch" else JHTTPTransport)()
    try:
        sender.send_checkpoint([1], step=4, state_dict=state, timeout=10)
        with pytest.raises(EOFError):
            recv.recv_checkpoint(src_rank=0, metadata=sender.metadata(), step=4, timeout=10)
        # The rule is spent: the retry of the same heal gets the whole state.
        got = recv.recv_checkpoint(src_rank=0, metadata=sender.metadata(), step=4, timeout=10)
        np.testing.assert_array_equal(np.asarray(got["w"]), np.arange(1 << 16, dtype=np.float32))
    finally:
        recv.shutdown()
        sender.shutdown()
        telemetry.reset_event_log()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    injected = [e["attrs"] for e in events if e["event"] == "chaos_inject"]
    assert [(a["kind"], a["plane"], a["site"]) for a in injected] == [
        ("ckpt_truncate", "heal", "ckpt:metadata"), ("ckpt_truncate", "heal", "ckpt:full")
    ]


# -- data plane: the port's socket group ----------------------------------------------


def _make_groups(store, classes, prefix, timeout=10.0):
    groups = [cls(timeout=timeout) for cls in classes]
    ws = len(groups)
    _run_parallel(
        [lambda r=r: groups[r].configure(f"{store.address()}/{prefix}", r, ws) for r in range(ws)]
    )
    return groups


def _sum(group):
    return jpg.ReduceOp.SUM if isinstance(group, jpg.ProcessGroup) else ReduceOp.SUM


def _errors(groups, n=4, timeout=10):
    def run(rank):
        try:
            groups[rank].allreduce(np.ones(n, np.float32)).wait(timeout=timeout)
            return None
        except Exception as e:  # noqa: BLE001 - the point of the test
            return e

    return [e for e in _run_parallel([lambda r=r: run(r) for r in range(len(groups))]) if e]


def _reconfigured_sum(groups, store, prefix):
    def run(rank):
        groups[rank].configure(f"{store.address()}/{prefix}", rank, len(groups))
        arr = np.full(4, float(rank + 1), np.float32)
        groups[rank].allreduce(arr, _sum(groups[rank])).wait(timeout=30)
        return arr

    return _run_parallel([lambda r=r: run(r) for r in range(len(groups))])


@pytest.mark.parametrize(
    "classes", [(ProcessGroupSocket,) * 2, (jpg.ProcessGroupSocket, ProcessGroupSocket)],
    ids=["port", "mixed"],
)
@pytest.mark.timeout(60)
def test_socket_stall_delays_allreduce(store, classes):
    """One seeded stall of 300 ms on the data plane; in the mixed world the
    same spec is armed in both packages' planes, and exactly one of the
    ranks' sends takes it (each plane counts its own visits)."""
    groups = _make_groups(store, classes, "chst")
    armed = {chaos} if classes[0] is ProcessGroupSocket else {chaos, jchaos}
    for mod in armed:
        mod.install(5, [_rule(mod, kind="stall", ms=300, count=1)])

    def run(rank):
        arr = np.full(4, float(rank), np.float32)
        return groups[rank].allreduce(arr, _sum(groups[rank])).wait(timeout=30)[0]

    t0 = time.monotonic()
    for out in _run_parallel([lambda r=r: run(r) for r in range(2)]):
        np.testing.assert_allclose(out, 1.0)
    assert time.monotonic() - t0 >= 0.25
    assert chaos.active().injections_fired() == 1
    for g in groups:
        g.shutdown()


@pytest.mark.timeout(60)
def test_socket_reset_latches_error_and_reconfigure_recovers(store):
    groups = _make_groups(store, (ProcessGroupSocket,) * 2, "chrs")
    chaos.install(5, [_rule(chaos, kind="reset", match="c1", count=1)])
    assert _errors(groups), "chaos reset should fail at least one rank's allreduce"
    assert any(g.errored() is not None for g in groups)
    chaos.reset()
    a, _ = _reconfigured_sum(groups, store, "chrs2")
    np.testing.assert_allclose(a, 3.0)
    assert all(g.errored() is None for g in groups)
    for g in groups:
        g.shutdown()


# -- the engine's plane ----------------------------------------------------------------


@native
def test_native_abi_arm_disarm():
    with pytest.raises(ValueError):
        _native.chaos_init("seed:1,spec:bogus@ctrl")
    assert not _native.chaos_armed()
    _native.chaos_init("seed:1,spec:stall@data:ms=1")
    assert _native.chaos_armed()
    snap = _native.chaos_snapshot()
    assert snap["seq"] == 0 and snap["events"] == []
    _native.chaos_init(" ")
    assert not _native.chaos_armed()


@native
def test_native_grammar_accepts_preempt():
    _native.chaos_init("seed:1,spec:preempt@any:p=0.5:grace=90000")
    assert _native.chaos_armed()
    _native.chaos_init(" ")
    with pytest.raises(ValueError):
        _native.chaos_init("seed:1,spec:preempt@any:grace=-1")
    assert not _native.chaos_armed()


@native
@pytest.mark.parametrize(
    "classes", [(ProcessGroupNative,) * 2, (jpg.ProcessGroupNative, ProcessGroupNative)],
    ids=["port", "mixed"],
)
@pytest.mark.timeout(60)
def test_native_reset_latches_error_like_socket(store, classes):
    """An unlimited reset kills every stripe and handoff of the first
    collective: it fails, ``errored()`` latches on a port rank and, in the
    mixed world, on the JAX rank's group too, and a reconfigure recovers."""
    groups = _make_groups(store, classes, "nchr")
    _native.chaos_init("seed:5,spec:reset@data:match=c1")
    assert _errors(groups, n=256), "native chaos reset should fail at least one rank"
    assert any(g.errored() is not None for g in groups)
    assert any(
        e["kind"] == "reset" and e["plane"] == "data" for e in _native.chaos_snapshot()["events"]
    )
    _native.chaos_init(" ")
    a, b = _reconfigured_sum(groups, store, "nchr2")
    np.testing.assert_allclose(a, 3.0)
    np.testing.assert_allclose(b, 3.0)
    assert all(g.errored() is None for g in groups)
    for g in groups:
        g.shutdown()


@native
@pytest.mark.timeout(90)
def test_native_schedule_matches_python_hash_and_replays(store):
    """Every injection the engine fires for a p<1 rule behind the port's
    group is a visit the port's Python hash fires, and a same-seed rerun
    fires the identical (site, rule, visit) set."""
    spec = "seed:99,spec:stall@data:p=0.4:ms=1"

    def one_run(prefix):
        _native.chaos_init(spec)
        groups = _make_groups(store, (ProcessGroupNative,) * 2, prefix)
        for _ in range(6):
            _run_parallel(
                [lambda r=r: groups[r].allreduce(np.ones(1024, np.float32)).wait(timeout=30)
                 for r in range(2)]
            )
        snap = _native.chaos_snapshot()
        _native.chaos_init(" ")
        for g in groups:
            g.shutdown()
        return snap["events"]

    a, b = one_run("npar1"), one_run("npar2")
    assert a, "expected at least one native injection at p=0.4"
    for ev in a:
        unit = chaos._hash_unit(
            chaos.decision_hash(99, ev["rule"], chaos.fnv1a64(ev["site"]), ev["visit"])
        )
        assert unit < 0.4, f"native fired a visit Python would not: {ev}"
    key = lambda evs: sorted((e["site"], e["rule"], e["visit"]) for e in evs)  # noqa: E731
    assert key(a) == key(b)


@native
@pytest.mark.timeout(60)
def test_native_snapshot_since_seq(store, tmp_path, monkeypatch):
    """The engine's injection ring read incrementally, and drained by the
    port's group into its journal as ``chaos_inject`` of the data plane."""
    path = tmp_path / "journal.jsonl"
    monkeypatch.setenv("TORCHFT_JOURNAL_FILE", str(path))
    telemetry.reset_event_log()
    _native.chaos_init("seed:1,spec:stall@data:ms=1:count=2")
    groups = _make_groups(store, (ProcessGroupNative,) * 2, "nsnap")
    try:
        _run_parallel(
            [lambda r=r: groups[r].allreduce(np.ones(64, np.float32)).wait(timeout=30)
             for r in range(2)]
        )
        snap = _native.chaos_snapshot()
        assert snap["seq"] >= 1 and len(snap["events"]) >= 1
        assert _native.chaos_snapshot(since_seq=snap["seq"])["events"] == []
    finally:
        _native.chaos_init(" ")
        for g in groups:
            g.shutdown()
        telemetry.reset_event_log()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    injected = [e["attrs"] for e in events if e["event"] == "chaos_inject"]
    assert injected and all(a["kind"] == "stall" and a["plane"] == "data" for a in injected)


def test_a_heal_moves_the_chaos_step_to_the_healed_step():
    """``start_quorum`` pins the chaos step before the quorum; a heal then
    loads the peer's step. The port's ``Manager.load_state_dict`` moves the
    chaos step with it, so a healed replica's step-window rules (both
    chaos planes: the engine mirrors the step) cover the step it now runs.
    The JAX Manager leaves the pre-heal step (ROADMAP.md section 3)."""
    from torchft_tpu import manager as jmanager
    from torchft_tpu_torch import manager as tmanager

    for mod, manager_cls in ((chaos, tmanager.Manager), (jchaos, jmanager.Manager)):
        mod.set_step(0)  # what start_quorum pinned on the relaunched replica
        shell = manager_cls.__new__(manager_cls)
        manager_cls.load_state_dict(shell, {"step": 6, "batches_committed": 12})
        assert shell._step == 6
    assert chaos.current_step() == 6
    assert jchaos.current_step() == 0
