"""The Manager's unit contract, held to the JAX Manager: the twin of
``tests/test_manager.py``.

Each of that file's 31 functions is one test here, parametrised over
``("jax", "port")``. Both cases build a Manager with mocked
``ManagerServer``/``ManagerClient`` and checkpoint transport
(``make_manager``: the JAX one patches ``torchft_tpu.manager``, the port's
``torchft_tpu_torch.manager``, each over its own package's
``ProcessGroupDummy`` and ``QuorumResult``), feed it the same mocked quorum
results and the same inputs, and make the JAX test's assertions. Each
scenario also returns what it saw (``Seen``): commit votes,
``num_participants``, ``is_participating``, allreduce outputs, the order
of the state-dict calls and every client and transport RPC with its
arguments. The port case runs the JAX scenario beside its own and holds
the two to each other, outputs bit for bit.

The port case hands the allreduce torch tensors (the port's counterpart of
a jax array) made from the same numpy arrays, and reads the tensors it
gets back; numpy inputs to ``_ManagedWork`` stay numpy in both. Each
allreduce also carries one seeded array (``seeded``) beside the JAX
test's constants, so that the outputs are compared on data that is not
all one value. Timings (goodput seconds) are held to each test's bounds
in both cases but not to each other."""

from __future__ import annotations

import concurrent.futures
import json
import threading
import time
from types import SimpleNamespace
from unittest.mock import MagicMock, patch

import numpy as np
import pytest
import torch

PACKAGES = ("jax", "port")


def package(name: str) -> SimpleNamespace:
    """The modules a scenario needs, from one package."""
    if name == "jax":
        from torchft_tpu import coordination, manager, process_group, telemetry, work
        root = "torchft_tpu"
    else:
        from torchft_tpu_torch import (
            coordination,
            manager,
            process_group,
            telemetry,
            work,
        )
        root = "torchft_tpu_torch"
    return SimpleNamespace(
        name=name, root=root, coordination=coordination, manager=manager,
        pg=process_group, telemetry=telemetry, work=work,
    )


def seeded(n: int = 257, seed: int = 28) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


class Seen(dict):
    """What a scenario observed, compared across the packages."""

    def outputs(self, key: str, outs) -> None:
        self[key] = [np.asarray(o).copy() for o in outs]


def to_inputs(p, arrays):
    """The allreduce's inputs: numpy for the JAX Manager, CPU tensors of the
    same bits for the port's."""
    if p.name == "jax":
        return [a.copy() for a in arrays]
    return [torch.from_numpy(a.copy()) for a in arrays]


def to_numpy(p, outs) -> list:
    if p.name == "port":
        for o in outs:
            assert isinstance(o, torch.Tensor), type(o)
        return [o.numpy() for o in outs]
    return [np.asarray(o) for o in outs]


def make_quorum_result(p, **kwargs):
    defaults = dict(
        quorum_id=1,
        replica_rank=0,
        replica_world_size=2,
        recover_src_manager_address="",
        recover_src_replica_rank=None,
        recover_dst_replica_ranks=[],
        store_address="127.0.0.1:1234",
        max_step=0,
        max_replica_rank=0,
        max_world_size=2,
        heal=False,
        commit_failures=0,
    )
    defaults.update(kwargs)
    return p.coordination.QuorumResult(**defaults)


def make_manager(p, pg=None, quorum_result=None, **kwargs):
    """Builds a Manager with mocked ManagerServer/Client and transport
    (``tests/test_manager.py:39-67``, for either package)."""
    pg = pg if pg is not None else p.pg.ProcessGroupDummy()
    transport = MagicMock()
    transport.metadata.return_value = "http://127.0.0.1:0"
    with patch(f"{p.root}.manager.ManagerServer") as server_cls, patch(
        f"{p.root}.manager.ManagerClient"
    ) as client_cls:
        server_cls.return_value.address.return_value = "127.0.0.1:1"
        client = client_cls.return_value
        client._quorum.return_value = quorum_result or make_quorum_result(p)
        # Echo the local vote by default.
        client.should_commit.side_effect = (
            lambda rank, step, ok, timeout=None, trace_id="": ok
        )
        client.drain_status.return_value = False
        manager = p.manager.Manager(
            pg=pg,
            checkpoint_transport=transport,
            replica_id="test",
            lighthouse_addr="unused:1",
            group_rank=0,
            group_world_size=1,
            use_async_quorum=kwargs.pop("use_async_quorum", True),
            **kwargs,
        )
    manager._test_client = client  # type: ignore[attr-defined]
    manager._test_transport = transport  # type: ignore[attr-defined]
    return manager


def _norm(v):
    """An RPC argument in a form both packages can be compared on: numpy
    arrays as (dtype, shape, bytes), a QuorumResult as its fields."""
    if isinstance(v, np.ndarray):
        return ("ndarray", str(v.dtype), v.shape, v.tobytes())
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in sorted(v.items())}
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if hasattr(v, "__dataclass_fields__"):
        return {k: _norm(getattr(v, k)) for k in sorted(v.__dataclass_fields__)}
    return v


def rpcs(mock) -> list:
    """Every call made on ``mock`` (a client or a transport), in order, with
    its arguments. The digest the commit gate pushes holds wall-clock
    rates, so only its keys are kept; a ``timeout`` is what is left of a
    deadline, so it is kept to a tenth of a second."""
    out = []
    for name, args, kwargs in mock.mock_calls:
        if name == "set_digest":
            args = (sorted(args[0]),)
        if isinstance(kwargs.get("timeout"), float):
            kwargs = {**kwargs, "timeout": round(kwargs["timeout"], 1)}
        out.append((name, _norm(list(args)), _norm(dict(kwargs))))
    return out


def finish(m, seen: Seen) -> Seen:
    """Adds the manager's client and transport RPCs to ``seen``."""
    seen["client_rpcs"] = rpcs(m._test_client)
    seen["transport_rpcs"] = rpcs(m._test_transport)
    return seen


def assert_same(a, b, path="seen") -> None:
    """``a`` equals ``b``; arrays bit for bit (dtype, shape, bytes)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), f"{path}: {a} != {b}"
    elif isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), f"{path}: {sorted(a)} != {sorted(b)}"
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), f"{path}: {a} != {b}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def run(scenario, name: str, *args) -> Seen:
    """Runs ``scenario`` on package ``name``; the port case also runs it on
    the JAX package and holds the two to each other."""
    seen = scenario(package(name), *args)
    if name == "port":
        assert_same(seen, scenario(package("jax"), *args))
    return seen


def state_fns(log: list, key: str, save_value, loaded: dict = None):
    """A (save, load) pair that logs each call, in order."""
    def save():
        log.append(("save", key))
        return save_value

    def load(s):
        log.append(("load", key, _norm(s)))
        if loaded is not None:
            loaded.update(s)

    return save, load


# ---------------------------------------------------------------------------
# The departure path first: spares, the drain abort, the commit gates, heals
# ---------------------------------------------------------------------------


def fixed_with_spares_benches_extra_ranks(p) -> Seen:
    seen = Seen()
    m = make_manager(
        p,
        min_replica_size=2,
        world_size_mode=p.manager.WorldSizeMode.FIXED_WITH_SPARES,
        quorum_result=make_quorum_result(
            p, replica_rank=2, max_world_size=3, replica_world_size=3
        ),
    )
    try:
        m.start_quorum()
        m.wait_quorum()
        assert m.num_participants() == 2  # clamped to fixed size
        assert not m.is_participating()  # rank 2 is a spare
        seen.update(participants=m.num_participants(),
                    participating=m.is_participating(),
                    rank=m.participating_rank())
        arr = np.full(2, 5.0)
        out = to_numpy(p, m.allreduce(to_inputs(p, [arr, seeded()])).wait())
        np.testing.assert_allclose(out[0], 0.0)  # spare contributes zeros
        assert not out[1].any()
        seen.outputs("allreduce", out)
        seen["commit"] = m.should_commit()
        seen["step"] = m.current_step()
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_fixed_with_spares_benches_extra_ranks(pkg):
    """The port reads its allreduce output as tensors (the JAX test: numpy
    arrays of ``ProcessGroupDummy``'s echo)."""
    run(fixed_with_spares_benches_extra_ranks, pkg)


def abort_pending_quorum_interrupts_sync_wait(p) -> Seen:
    seen = Seen()
    m = make_manager(p, use_async_quorum=False)
    client = m._test_client
    wake = threading.Event()

    def blocked_quorum(**kw):
        wake.wait(30.0)
        raise p.coordination.RequestAborted("aborted")  # the killed socket

    client._quorum.side_effect = blocked_quorum
    client.abort.side_effect = wake.set
    try:
        errs = []

        def body():
            try:
                m.start_quorum()
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        t = threading.Thread(target=body, daemon=True)
        t.start()
        deadline = time.time() + 5.0
        while not m._quorum_rpc_pending:
            time.sleep(0.005)
            assert time.time() < deadline, "RPC never started"
        seen["aborted"] = m.abort_pending_quorum()
        assert seen["aborted"] is True
        t.join(5.0)
        assert not t.is_alive(), "sync quorum wait did not abort"
        assert isinstance(errs[0], p.coordination.RequestAborted)
        assert isinstance(m.errored(), p.coordination.RequestAborted)
        client.leave.return_value = True
        seen["left"] = m.leave()
        assert seen["left"] is True
        seen["errors"] = [type(e).__name__ for e in errs]
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_abort_pending_quorum_interrupts_sync_wait(pkg):
    run(abort_pending_quorum_interrupts_sync_wait, pkg)


def start_quorum_after_drain_abort_never_waits(p) -> Seen:
    seen = Seen()
    m = make_manager(p, use_async_quorum=False)
    try:
        seen["aborted"] = m.abort_pending_quorum()
        assert seen["aborted"] is False  # nothing in flight
        with pytest.raises(p.coordination.RequestAborted):
            m.start_quorum()
        m._test_client._quorum.assert_not_called()
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_start_quorum_after_drain_abort_never_waits(pkg):
    run(start_quorum_after_drain_abort_never_waits, pkg)


def drain_requested_falls_back_to_status_rpc_on_error(p) -> Seen:
    seen = Seen()
    m = make_manager(p)
    client = m._test_client
    try:
        seen["healthy"] = m.drain_requested()
        assert seen["healthy"] is False
        client.drain_status.assert_not_called()  # healthy: piggyback only
        m.report_error(RuntimeError("quorum failed"))
        client.drain_status.return_value = True
        seen["errored"] = m.drain_requested()
        assert seen["errored"] is True
        client.drain_status.assert_called_once()
        # Latched: no second RPC.
        seen["latched"] = m.drain_requested()
        assert seen["latched"] is True
        client.drain_status.assert_called_once()
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_drain_requested_falls_back_to_status_rpc_on_error(pkg):
    run(drain_requested_falls_back_to_status_rpc_on_error, pkg)


def drain_requested_journals_failed_status_probe(p, path) -> Seen:
    seen = Seen()
    p.telemetry.reset_event_log()
    try:
        m = make_manager(p)
        client = m._test_client
        try:
            m.report_error(RuntimeError("quorum failed"))
            client.drain_status.side_effect = TimeoutError("lighthouse gone")
            answers = [m.drain_requested(), m.drain_requested()]
            assert answers == [False, False]  # retried, not latched off
            assert client.drain_status.call_count == 2
            client.drain_status.side_effect = None
            client.drain_status.return_value = True
            answers.append(m.drain_requested())
            assert answers[-1] is True  # recovers once the RPC heals
            seen["answers"] = answers
        finally:
            m.shutdown()
    finally:
        p.telemetry.reset_event_log()

    with open(path) as fh:
        events = [json.loads(line) for line in fh]
    probes = [e for e in events if e["event"] == "rpc_retry"]
    assert len(probes) == 2
    assert probes[0]["attrs"]["rpc"] == "drain_status"
    assert probes[0]["attrs"]["cause"] == "TimeoutError"
    seen["probes"] = [sorted(e["attrs"].items()) for e in probes]
    seen["events"] = [e["event"] for e in events]
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_drain_requested_journals_failed_status_probe(pkg, tmp_path, monkeypatch):
    """Each case journals into a file of its own (the port case's JAX run
    into a second one)."""
    count = iter(range(2))

    def scenario(p):
        path = str(tmp_path / f"journal{next(count)}.jsonl")
        monkeypatch.setenv("TORCHFT_JOURNAL_FILE", path)
        return drain_requested_journals_failed_status_probe(p, path)

    run(scenario, pkg)


def min_replica_size_gates_commit(p) -> Seen:
    seen = Seen()
    m = make_manager(
        p,
        min_replica_size=3,
        quorum_result=make_quorum_result(p, replica_world_size=2, max_world_size=2),
    )
    try:
        m.start_quorum()
        m.wait_quorum()
        seen["commit"] = m.should_commit()
        assert not seen["commit"]  # 2 < 3
        seen.update(step=m.current_step(), participants=m.num_participants(),
                    participating=m.is_participating())
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_min_replica_size_gates_commit(pkg):
    run(min_replica_size_gates_commit, pkg)


def heal_quorum(p, max_step: int):
    return make_quorum_result(
        p,
        heal=True,
        max_step=max_step,
        recover_src_manager_address="127.0.0.1:9",
        recover_src_replica_rank=1,
    )


def async_heal_defers_user_state(p) -> Seen:
    seen = Seen()
    calls: list = []
    user_state = {"w": np.arange(3.0)}
    loaded: dict = {}
    m = make_manager(p, quorum_result=heal_quorum(p, 7))
    m._test_transport.recv_checkpoint.return_value = {
        "torchft": {"step": 7, "batches_committed": 14},
        "user": {"default": user_state},
    }
    m.register_state_dict_fn("default", *state_fns(calls, "default", user_state, loaded))
    with patch(f"{p.root}.manager.ManagerClient") as peer_cls:
        peer_cls.return_value._checkpoint_metadata.return_value = "http://peer"
        try:
            m.start_quorum()
            m.wait_quorum()
            # Healing rank doesn't participate in async mode.
            assert not m.is_participating()
            assert m.num_participants() == 2
            seen.update(participating=m.is_participating(),
                        participants=m.num_participants())
            # torchft state applied immediately; user state deferred.
            assert m.current_step() == 7
            assert not loaded
            seen["calls_before_commit"] = list(calls)
            seen["commit"] = m.should_commit()
            assert seen["commit"]
            assert loaded  # applied at commit time
            assert m.current_step() == 8
            seen["step"] = m.current_step()
            seen["peer_rpcs"] = rpcs(peer_cls)
        finally:
            m.shutdown()
    seen["calls"] = calls
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_async_heal_defers_user_state(pkg):
    run(async_heal_defers_user_state, pkg)


def sync_quorum_applies_state_immediately(p) -> Seen:
    seen = Seen()
    calls: list = []
    loaded: dict = {}
    m = make_manager(p, use_async_quorum=False, quorum_result=heal_quorum(p, 3))
    m._test_transport.recv_checkpoint.return_value = {
        "torchft": {"step": 3, "batches_committed": 6},
        "user": {"default": {"x": 1}},
    }
    m.register_state_dict_fn("default", *state_fns(calls, "default", {}, loaded))
    with patch(f"{p.root}.manager.ManagerClient") as peer_cls:
        peer_cls.return_value._checkpoint_metadata.return_value = "http://peer"
        try:
            m.start_quorum()  # sync: waits and applies
            assert loaded == {"x": 1}
            assert m.current_step() == 3
            # Sync mode participates even while healing.
            assert m.is_participating()
            seen.update(step=m.current_step(), participating=m.is_participating(),
                        participants=m.num_participants(),
                        peer_rpcs=rpcs(peer_cls))
        finally:
            m.shutdown()
    seen["calls"] = calls
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_sync_quorum_applies_state_immediately(pkg):
    run(sync_quorum_applies_state_immediately, pkg)


def commit_failures_reported_to_quorum(p) -> Seen:
    seen = Seen()
    m = make_manager(p)
    m._test_client.should_commit.side_effect = None
    m._test_client.should_commit.return_value = False
    try:
        m.start_quorum()
        seen["commit"] = m.should_commit()
        assert not seen["commit"]
        m.start_quorum()
        m.wait_quorum()
        kwargs = m._test_client._quorum.call_args.kwargs
        assert kwargs["commit_failures"] == 1
        seen["commit_failures"] = [
            c.kwargs["commit_failures"] for c in m._test_client._quorum.call_args_list
        ]
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_commit_failures_reported_to_quorum(pkg):
    run(commit_failures_reported_to_quorum, pkg)


# ---------------------------------------------------------------------------
# The rest of tests/test_manager.py, in its order
# ---------------------------------------------------------------------------


def happy_path_commit(p) -> Seen:
    seen = Seen()
    pg = p.pg.ProcessGroupDummy()
    m = make_manager(p, pg=pg)
    try:
        m.start_quorum()
        arr = np.full(4, 2.0, dtype=np.float32)
        out = to_numpy(p, m.allreduce(to_inputs(p, [arr, seeded()])).wait())
        # Dummy pg: sum = input; divided by num_participants (2).
        np.testing.assert_allclose(out[0], 1.0)
        seen.outputs("allreduce", out)
        seen["commit"] = m.should_commit()
        assert seen["commit"]
        assert m.current_step() == 1
        assert m.batches_committed() == 2
        assert pg.configure_count == 1  # quorum_id changed from -1 -> 1
        seen.update(step=m.current_step(), batches=m.batches_committed(),
                    configures=pg.configure_count, participants=m.num_participants(),
                    participating=m.is_participating())
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_happy_path_commit(pkg):
    """The port feeds and reads tensors (the JAX test: numpy arrays)."""
    run(happy_path_commit, pkg)


def pg_reconfigured_only_on_quorum_change(p) -> Seen:
    seen = Seen()
    pg = p.pg.ProcessGroupDummy()
    m = make_manager(p, pg=pg)
    counts = []
    try:
        m.start_quorum()
        m.wait_quorum()
        counts.append(pg.configure_count)
        # Same quorum id -> no reconfigure.
        m.start_quorum()
        m.wait_quorum()
        counts.append(pg.configure_count)
        # New quorum id -> reconfigure with prefixed store path.
        m._test_client._quorum.return_value = make_quorum_result(p, quorum_id=2)
        m.start_quorum()
        m.wait_quorum()
        counts.append(pg.configure_count)
        assert counts == [1, 1, 2]
        seen["configures"] = counts
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_pg_reconfigured_only_on_quorum_change(pkg):
    run(pg_reconfigured_only_on_quorum_change, pkg)


def send_checkpoint_to_recovering_peers(p) -> Seen:
    seen = Seen()
    calls: list = []
    m = make_manager(
        p, quorum_result=make_quorum_result(p, recover_dst_replica_ranks=[1], max_step=5)
    )
    m.register_state_dict_fn("default", *state_fns(calls, "default", {"w": seeded(7)}))
    try:
        m.start_quorum()
        m.wait_quorum()
        call = m._test_transport.send_checkpoint.call_args
        assert call.kwargs["dst_ranks"] == [1]
        assert call.kwargs["step"] == 5
    finally:
        m.shutdown()
    seen["calls"] = calls
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_send_checkpoint_to_recovering_peers(pkg):
    """Both cases register a seeded user state, so the transport calls
    compare the checkpoint's bytes too."""
    run(send_checkpoint_to_recovering_peers, pkg)


def allreduce_error_latches_and_commit_fails(p) -> Seen:
    seen = Seen()
    pg = MagicMock()
    pg.errored.return_value = None
    pg.allreduce.side_effect = RuntimeError("collective died")
    m = make_manager(p, pg=pg)
    try:
        m.start_quorum()
        arr = np.ones(2, dtype=np.float32)
        out = to_numpy(p, m.allreduce(to_inputs(p, [arr, seeded()])).wait())  # no raise
        seen.outputs("allreduce", out)  # the inputs, unreduced
        assert m.errored() is not None
        seen["commit"] = m.should_commit()
        assert not seen["commit"]
        assert m.current_step() == 0
        # Next quorum resets the error.
        pg.allreduce.side_effect = None
        m._test_client._quorum.return_value = make_quorum_result(p, quorum_id=1)
        m.start_quorum()
        m.wait_quorum()
        assert m.errored() is None
        calls = [name for name, _, _ in pg.mock_calls]
        if p.name == "port":
            # The port asks errored() only once the quorum has configured
            # the group; the JAX Manager asks before it waits for the
            # quorum, so its order races the quorum thread (ROADMAP.md
            # section 3, the fenced collective).
            assert calls.index("configure") < calls.index("errored"), calls
        seen["pg_calls"] = sorted(calls)
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_allreduce_error_latches_and_commit_fails(pkg):
    """The group's calls are compared as a multiset: the JAX Manager's
    ``errored()`` before the quorum (a reference fault the port fixes)
    lands before or after ``configure`` as the quorum thread runs."""
    run(allreduce_error_latches_and_commit_fails, pkg)


def pg_async_error_surfaces(p) -> Seen:
    seen = Seen()
    pg = p.pg.ProcessGroupDummy()
    m = make_manager(p, pg=pg)
    try:
        m.start_quorum()
        m.wait_quorum()
        pg_err = RuntimeError("async pg failure")
        pg.errored = lambda: pg_err  # type: ignore[method-assign]
        assert m.errored() is pg_err
        seen["commit"] = m.should_commit()
        assert not seen["commit"]
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_pg_async_error_surfaces(pkg):
    run(pg_async_error_surfaces, pkg)


def quorum_rpc_failure_is_latched(p) -> Seen:
    seen = Seen()
    m = make_manager(p)
    m._test_client._quorum.side_effect = TimeoutError("lighthouse down")
    try:
        m.start_quorum()
        out = to_numpy(p, m.allreduce(to_inputs(p, [np.ones(1), seeded()])).wait())
        seen.outputs("allreduce", out)  # no crash: the inputs come back
        assert isinstance(m.errored(), TimeoutError)
        seen["commit"] = m.should_commit()
        assert not seen["commit"]
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_quorum_rpc_failure_is_latched(pkg):
    run(quorum_rpc_failure_is_latched, pkg)


def max_retries_raises(p) -> Seen:
    seen = Seen()
    m = make_manager(p, max_retries=1)
    m._test_client.should_commit.side_effect = None
    m._test_client.should_commit.return_value = False
    try:
        m.start_quorum()
        seen["commit"] = m.should_commit()
        assert not seen["commit"]
        m.start_quorum()
        with pytest.raises(p.manager.ExceededMaxRetriesError):
            m.should_commit()
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_max_retries_raises(pkg):
    run(max_retries_raises, pkg)


def state_dict_roundtrip(p) -> Seen:
    m = make_manager(p)
    try:
        m.load_state_dict({"step": 42, "batches_committed": 84})
        assert m.current_step() == 42
        assert m.state_dict() == {"step": 42, "batches_committed": 84}
        seen = Seen(state=m.state_dict())
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_state_dict_roundtrip(pkg):
    run(state_dict_roundtrip, pkg)


def set_state_dict_fns_single_registry(p) -> Seen:
    m = make_manager(p)
    loaded = []
    try:
        m.set_state_dict_fns(loaded.append, lambda: {"w": 7})
        snap = m._manager_state_dict()
        assert snap["user"]["default"] == {"w": 7}
        m._load_state_dicts["default"]({"w": 9})
        assert loaded == [{"w": 9}]
        seen = Seen(snapshot=_norm(snap), loaded=loaded,
                    registry=sorted(m._load_state_dicts))
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_set_state_dict_fns_single_registry(pkg):
    run(set_state_dict_fns_single_registry, pkg)


def wrap_future_swallow_and_timeout(p) -> Seen:
    seen = Seen()
    m = make_manager(p)
    try:
        # Success passes through.
        ok = concurrent.futures.Future()
        ok.set_result(7)
        seen["ok"] = m.wrap_future(ok, default=-1).result(timeout=5)
        assert seen["ok"] == 7
        assert m.errored() is None

        # Failure: swallowed to default, error latched.
        bad = concurrent.futures.Future()
        bad.set_exception(RuntimeError("collective died"))
        seen["bad"] = m.wrap_future(bad, default=-1).result(timeout=5)
        assert seen["bad"] == -1
        assert m.errored() is not None
        seen["bad_error"] = type(m.errored()).__name__

        # Timeout: same contract.
        m2 = make_manager(p)
        try:
            never = concurrent.futures.Future()
            seen["never"] = m2.wrap_future(never, default=-2, timeout=0.2).result(
                timeout=5
            )
            assert seen["never"] == -2
            assert isinstance(m2.errored(), TimeoutError)
        finally:
            m2.shutdown()
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_wrap_future_swallow_and_timeout(pkg):
    run(wrap_future_swallow_and_timeout, pkg)


def goodput_accounting(p) -> Seen:
    seen = Seen()
    m = make_manager(p)
    try:
        votes = []
        m.start_quorum()
        votes.append(m.should_commit())  # first gate: unattributed
        time.sleep(0.05)
        m.start_quorum()
        votes.append(m.should_commit())  # ~50ms committed
        m.start_quorum()
        m.report_error(RuntimeError("injected"))
        time.sleep(0.05)
        votes.append(m.should_commit())  # ~50ms failed
        assert votes == [True, True, False]
        g = m.goodput()
        assert g["committed_steps"] == 2
        assert g["failed_commits"] == 1
        assert g["committed_s"] > 0 and g["failed_s"] > 0
        assert 0.0 < g["goodput_frac"] < 1.0
        assert g["heal_count"] == 0
        seen.update(votes=votes, keys=sorted(g), counts=[
            g["committed_steps"], g["failed_commits"], g["heal_count"]])
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_goodput_accounting(pkg):
    run(goodput_accounting, pkg)


def goodput_frac_none_before_first_gate(p) -> Seen:
    m = make_manager(p)
    try:
        g = m.goodput()
        assert g["goodput_frac"] is None
        assert g["committed_steps"] == 0 and g["failed_commits"] == 0
        assert g["committed_s"] == 0.0 and g["failed_s"] == 0.0
        assert g["heal_count"] == 0 and g["heal_s"] == 0.0
        # Still None after a quorum forms but before any gate.
        m.start_quorum()
        m.wait_quorum()
        g2 = m.goodput()
        assert g2["goodput_frac"] is None
        seen = Seen(before=_norm(g), keys=sorted(g2))
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_goodput_frac_none_before_first_gate(pkg):
    """Before any gate every bucket is an exact zero, so the first reading
    is compared whole."""
    run(goodput_frac_none_before_first_gate, pkg)


def goodput_commit_fail_heal_bucketing(p) -> Seen:
    seen = Seen()
    m = make_manager(p)
    try:
        votes = []
        # Gate 1 opens the accounting window; gate 2 commits ~40ms.
        m.start_quorum()
        votes.append(m.should_commit())
        time.sleep(0.04)
        m.start_quorum()
        votes.append(m.should_commit())
        # Latched error -> the next window is failed time.
        m.start_quorum()
        m.report_error(RuntimeError("injected"))
        time.sleep(0.04)
        votes.append(m.should_commit())

        # Heal quorum: recv_checkpoint sleeps so heal_s is measurable.
        def slow_recv(**kwargs):
            time.sleep(0.05)
            return {"torchft": {"step": 9, "batches_committed": 18}, "user": {}}

        m._test_transport.recv_checkpoint.side_effect = slow_recv
        m._test_client._quorum.return_value = make_quorum_result(
            p,
            quorum_id=2,
            heal=True,
            max_step=9,
            recover_src_manager_address="127.0.0.1:9",
            recover_src_replica_rank=1,
        )
        with patch(f"{p.root}.manager.ManagerClient") as peer_cls:
            peer_cls.return_value._checkpoint_metadata.return_value = "http://peer"
            m.start_quorum()
            m.wait_quorum()
        votes.append(m.should_commit())
        assert votes == [True, True, False, True]

        g = m.goodput()
        assert g["committed_steps"] == 3
        assert g["failed_commits"] == 1
        assert g["heal_count"] == 1
        assert g["heal_s"] >= 0.05
        assert g["committed_s"] > 0 and g["failed_s"] > 0
        # frac is consistent with the buckets, heal time in the denominator.
        denom = g["committed_s"] + g["failed_s"] + g["heal_s"]
        assert g["goodput_frac"] == round(g["committed_s"] / denom, 4)
        assert 0.0 < g["goodput_frac"] < 1.0
        seen.update(votes=votes, step=m.current_step(), counts=[
            g["committed_steps"], g["failed_commits"], g["heal_count"]])
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_goodput_commit_fail_heal_bucketing(pkg):
    run(goodput_commit_fail_heal_bucketing, pkg)


def goodput_ledger_tiles_wall_clock(p) -> Seen:
    seen = Seen()
    m = make_manager(p)
    shut = False
    try:
        votes = []
        m.start_quorum()
        votes.append(m.should_commit())  # first gate -> init_compile
        time.sleep(0.03)
        m.start_quorum()
        votes.append(m.should_commit())  # clean window -> compute
        m.start_quorum()
        m.report_error(RuntimeError("injected"))
        time.sleep(0.03)
        votes.append(m.should_commit())  # failed -> discarded_step
        assert votes == [True, True, False]

        g = m.goodput()
        badput = g["badput_s"]
        assert set(badput) == set(p.telemetry.BADPUT_KINDS)
        assert g["tiling_error_s"] < 1e-6
        assert badput["init_compile"] > 0.0
        assert badput["compute"] > 0.0
        assert badput["discarded_step"] > 0.0
        assert badput["quorum_wait"] >= 0.0
        assert 0.0 < g["ledger_goodput_frac"] < 1.0
        assert m._ledger.tiling_error_s() < 1e-6
        assert m._ledger.total_s() == pytest.approx(
            sum(m._ledger.totals().values()), abs=1e-6)

        # Shutdown accounts the tail window as drain.
        m.shutdown()
        shut = True
        t = m._ledger.totals()
        assert t["drain"] > 0.0
        assert m._ledger.tiling_error_s() < 1e-6
        seen.update(votes=votes, kinds=sorted(badput),
                    positive=sorted(k for k, v in t.items() if v > 0))
    finally:
        if not shut:
            m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_goodput_ledger_tiles_wall_clock(pkg):
    """Which ledger kinds hold time is compared across the packages, not
    their seconds."""
    run(goodput_ledger_tiles_wall_clock, pkg)


def wrap_future_completes_even_if_report_error_raises(p) -> Seen:
    m = make_manager(p)
    try:
        def boom(exc):
            raise ValueError("report_error itself blew up")

        m.report_error = boom
        bad = concurrent.futures.Future()
        bad.set_exception(RuntimeError("collective died"))
        seen = Seen(result=m.wrap_future(bad, default=-3).result(timeout=5))
        assert seen["result"] == -3
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_wrap_future_completes_even_if_report_error_raises(pkg):
    run(wrap_future_completes_even_if_report_error_raises, pkg)


def fenced_state_dict_excludes_snapshot_reads(p) -> Seen:
    calls: list = []
    m = make_manager(p)
    try:
        m.register_state_dict_fn("w", *state_fns(calls, "w", {"x": 1}))
        m._timeout = 0.5  # short lock timeout for the reader
        results = {}

        with m.fenced_state_dict():
            def reader():
                try:
                    results["snap"] = m._manager_state_dict()
                except Exception as e:  # noqa: BLE001
                    results["err"] = type(e).__name__

            t = threading.Thread(target=reader)
            t.start()
            t.join(timeout=5)
            assert not t.is_alive()
        # Reader could not snapshot inside the fence.
        assert "snap" not in results
        # After release, snapshots work again.
        assert m._manager_state_dict()["user"]["w"] == {"x": 1}
        seen = Seen(results=results, calls=calls)
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_fenced_state_dict_excludes_snapshot_reads(pkg):
    run(fenced_state_dict_excludes_snapshot_reads, pkg)


def disallow_state_dict_read_raises_on_timeout(p) -> Seen:
    m = make_manager(p)
    try:
        m._timeout = 0.3
        assert m._state_dict_lock.acquire_read(1.0)  # a stuck reader
        try:
            with pytest.raises(TimeoutError):
                m.disallow_state_dict_read()
        finally:
            m._state_dict_lock.release_read()
    finally:
        m.shutdown()
    return finish(m, Seen())


@pytest.mark.parametrize("pkg", PACKAGES)
def test_disallow_state_dict_read_raises_on_timeout(pkg):
    run(disallow_state_dict_read_raises_on_timeout, pkg)


def state_dict_lock_blocks_checkpoint_read(p) -> Seen:
    calls: list = []
    m = make_manager(p)
    try:
        m.register_state_dict_fn("default", *state_fns(calls, "default", {"x": 1}))
        m.disallow_state_dict_read()
        with pytest.raises(TimeoutError):
            m._state_dict_lock.r_lock(timeout=0.1).__enter__()
        m.allow_state_dict_read()
        assert m._manager_state_dict()["user"]["default"] == {"x": 1}
        seen = Seen(calls=calls)
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_state_dict_lock_blocks_checkpoint_read(pkg):
    run(state_dict_lock_blocks_checkpoint_read, pkg)


def hot_paths_emit_spans_and_metrics(p, path) -> Seen:
    seen = Seen()
    p.telemetry.reset_span_stats()
    m = make_manager(p)
    try:
        m.start_quorum()
        out = to_numpy(p, m.allreduce(to_inputs(p, [np.ones(4, np.float32), seeded()])).wait())
        seen.outputs("allreduce", out)
        seen["commit"] = m.should_commit()
        assert seen["commit"]
    finally:
        m.shutdown()
    stats = p.telemetry.span_stats()
    for name in (
        "torchft::manager::start_quorum",
        "torchft::manager::_async_quorum",
        "torchft::manager::allreduce",
        "torchft::manager::should_commit",
    ):
        assert stats[name]["count"] >= 1, name
    rec = json.loads(open(path).readline())
    assert rec["committed"] == 1.0 and rec["num_participants"] == 2.0
    seen["spans"] = sorted(n for n in stats if n.startswith("torchft::manager::"))
    seen["metrics"] = sorted(rec)
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_hot_paths_emit_spans_and_metrics(pkg, tmp_path, monkeypatch):
    """Each case writes its metrics file of its own."""
    count = iter(range(2))

    def scenario(p):
        path = str(tmp_path / f"metrics{next(count)}.jsonl")
        monkeypatch.setenv("TORCHFT_METRICS_FILE", path)
        return hot_paths_emit_spans_and_metrics(p, path)

    run(scenario, pkg)


# ---------------------------------------------------------------------------
# _ManagedWork (reference: managed_work_test.py)
# ---------------------------------------------------------------------------


def managed_work_divides_on_wait_only(p) -> Seen:
    seen = Seen()
    m = make_manager(p)
    try:
        arrays = [np.full(4, 6.0, np.float32), seeded()]
        raw = [a.copy() for a in arrays]
        work = p.manager._ManagedWork(m, p.work.DummyWork(arrays), arrays, scale=1.0 / 3)
        np.testing.assert_allclose(arrays[0], 6.0)  # not yet normalized
        assert_same(arrays, raw)
        out = work.wait(timeout=5)
        np.testing.assert_allclose(out[0], 2.0)
        seen.outputs("first", out)
        # Idempotent: a second wait must not divide again.
        out = work.wait(timeout=5)
        np.testing.assert_allclose(out[0], 2.0)
        seen.outputs("second", out)
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_managed_work_divides_on_wait_only(pkg):
    run(managed_work_divides_on_wait_only, pkg)


def managed_work_failure_latches_and_returns_inputs(p) -> Seen:
    seen = Seen()
    m = make_manager(p)
    try:
        arrays = [np.full(4, 5.0, np.float32), seeded()]
        work = p.manager._ManagedWork(
            m, p.work.ErrorWork(RuntimeError("ring died")), arrays, scale=0.5
        )
        out = work.wait(timeout=5)
        np.testing.assert_allclose(out[0], 5.0)  # unscaled originals
        assert_same(out[1], seeded())
        assert m.errored() is not None
        seen.outputs("out", out)
        seen["error"] = str(m.errored())
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_managed_work_failure_latches_and_returns_inputs(pkg):
    run(managed_work_failure_latches_and_returns_inputs, pkg)


def managed_work_replace_mode(p) -> Seen:
    seen = Seen()
    m = make_manager(p)
    try:
        inputs = [np.zeros(3, np.float32), np.zeros(257, np.float32)]
        result = [np.full(3, 9.0, np.float32), seeded()]
        work = p.manager._ManagedWork(
            m, p.work.DummyWork(result), inputs, scale=1.0, in_place=False
        )
        out = work.wait(timeout=5)
        np.testing.assert_allclose(out[0], 9.0)
        seen.outputs("out", out)
        seen["inputs_untouched"] = not any(a.any() for a in inputs)
    finally:
        m.shutdown()
    return finish(m, seen)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_managed_work_replace_mode(pkg):
    """in_place=False (the device path in both packages): wait() returns
    the work's result arrays, not the inputs."""
    run(managed_work_replace_mode, pkg)


def test_every_function_of_the_jax_file_has_its_twin():
    """The 31 functions of tests/test_manager.py, each here by its name."""
    import ast
    from pathlib import Path

    jax_file = Path(__file__).with_name("test_manager.py")
    names = {
        n.name for n in ast.parse(jax_file.read_text()).body
        if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
    }
    assert len(names) == 31
    missing = sorted(n for n in names if n not in globals())
    assert not missing, missing
