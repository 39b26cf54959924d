"""The port's socket process group: the twin of tests/test_process_group.py.

N ranks as threads sharing a store, over the full collective surface, the
failure paths (``_PeerConn``'s fail-fast and tombstone, aborts, crash and
reconfigure), the wrapper zoo (``ErrorSwallowingProcessGroupWrapper``,
``FakeProcessGroupWrapper``, ``ManagedProcessGroup``) and the futures
engine, and the quantized collectives: the host ``allreduce_quantized``
and ``reduce_scatter_quantized`` at int8 and int4, and the port's device
path ``allreduce_quantized_torch`` on CPU tensors (the kernels' plain
versions) in place of the JAX file's ``allreduce_quantized_jax``.

The wire is shared, so each collective runs in two worlds: every rank a
port group ("port"), and port and JAX groups alternating by rank
("mixed"). The quantized results must equal, bit for bit, the all-JAX
world's on the same payloads."""

import concurrent.futures
import socket as socket_mod
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu import _net as j_net
from torchft_tpu import collectives as jcoll
from torchft_tpu import process_group as jpg
from torchft_tpu import telemetry as jtelemetry
from torchft_tpu_torch import _net as t_net
from torchft_tpu_torch import collectives as tcoll
from torchft_tpu_torch import futures
from torchft_tpu_torch import process_group as tpg
from torchft_tpu_torch import telemetry as ttelemetry
from torchft_tpu_torch.process_group import (
    ErrorSwallowingProcessGroupWrapper,
    FakeProcessGroupWrapper,
    ManagedProcessGroup,
    ProcessGroupDummy,
    ProcessGroupSocket,
    ReduceOp,
    _CollectiveAborted,
    _PeerConn,
)
from torchft_tpu_torch.store import TCPStoreServer
from torchft_tpu_torch.work import DummyWork

PG = {"torch": tpg, "jax": jpg}
WORLDS = ("port", "mixed")


def _pkgs(world: str, ws: int) -> tuple:
    """Each rank's package: all port, or port and JAX alternating."""
    return tuple("jax" if world == "mixed" and r % 2 else "torch" for r in range(ws))


def _op(pkg: str, op: ReduceOp):
    return PG[pkg].ReduceOp[op.name]


def _run_parallel(fns):
    with ThreadPoolExecutor(max_workers=len(fns)) as pool:
        futs = [pool.submit(fn) for fn in fns]
        return [f.result(timeout=60) for f in futs]


@pytest.fixture
def store():
    server = TCPStoreServer()
    yield server
    server.shutdown()


def _make_group(store, pkgs, prefix, timeout=10.0):
    ws = len(pkgs)
    groups = [PG[p].ProcessGroupSocket(timeout=timeout) for p in pkgs]
    _run_parallel([lambda r=r: groups[r].configure(f"{store.address()}/{prefix}", r, ws)
                   for r in range(ws)])
    return groups


def _shutdown(groups) -> None:
    for g in groups:
        g.shutdown()


def _bits(a) -> bytes:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.dtype.str.encode() + a.tobytes()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("world_size", [2, 3, 4])
def test_allreduce_sum(store, world_size, world):
    pkgs = _pkgs(world, world_size)
    groups = _make_group(store, pkgs, f"ar{world_size}")

    def run(rank):
        arr = np.full((5, 3), float(rank), dtype=np.float32)
        return groups[rank].allreduce(arr, _op(pkgs[rank], ReduceOp.SUM)).wait(timeout=30)[0]

    for r in _run_parallel([lambda r=r: run(r) for r in range(world_size)]):
        np.testing.assert_allclose(r, sum(range(world_size)))
    _shutdown(groups)


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_avg_and_inplace(store, world):
    pkgs = _pkgs(world, 2)
    groups = _make_group(store, pkgs, "avg")

    def run(rank):
        arr = np.full(7, float(rank * 2), dtype=np.float32)
        groups[rank].allreduce(arr, _op(pkgs[rank], ReduceOp.AVG)).wait(timeout=30)
        return arr

    for a in _run_parallel([lambda: run(0), lambda: run(1)]):
        np.testing.assert_allclose(a, 1.0)
    _shutdown(groups)


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_max_min(store, world):
    pkgs = _pkgs(world, 3)
    groups = _make_group(store, pkgs, "maxmin")

    def run(rank, op):
        arr = np.array([float(rank)], dtype=np.float64)
        return groups[rank].allreduce(arr, _op(pkgs[rank], op)).wait(timeout=30)[0][0]

    assert all(m == 2.0 for m in _run_parallel([lambda r=r: run(r, ReduceOp.MAX)
                                                 for r in range(3)]))
    assert all(m == 0.0 for m in _run_parallel([lambda r=r: run(r, ReduceOp.MIN)
                                                 for r in range(3)]))
    _shutdown(groups)


@pytest.mark.parametrize("world", WORLDS)
def test_allgather_broadcast_reduce_scatter_alltoall_barrier(store, world):
    ws = 3
    pkgs = _pkgs(world, ws)
    groups = _make_group(store, pkgs, "suite")

    def run(rank):
        pg = groups[rank]
        gathered = pg.allgather(np.array([rank, rank + 10])).wait(timeout=30)
        assert [g[0][0] for g in gathered] == list(range(ws))
        arr = np.array([float(rank)], dtype=np.float64)
        pg.broadcast(arr, root=1).wait(timeout=30)
        assert arr[0] == 1.0
        inputs = [np.full(4, float(rank + j), dtype=np.float32) for j in range(ws)]
        shard = pg.reduce_scatter(inputs, _op(pkgs[rank], ReduceOp.SUM)).wait(timeout=30)
        np.testing.assert_allclose(shard, sum(r + rank for r in range(ws)))
        inputs = [np.array([rank * 10 + j]) for j in range(ws)]
        out = pg.alltoall(inputs).wait(timeout=30)
        assert [o[0] for o in out] == [j * 10 + rank for j in range(ws)]
        pg.barrier().wait(timeout=30)
        return True

    assert all(_run_parallel([lambda r=r: run(r) for r in range(ws)]))
    _shutdown(groups)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.float16])
def test_allreduce_dtype_sweep(store, dtype, world):
    """Any numpy dtype crosses the wire faithfully, odd sizes too."""
    pkgs = _pkgs(world, 2)
    groups = _make_group(store, pkgs, f"dt{np.dtype(dtype).name}")

    def run(rank):
        arr = np.full(37, rank + 1, dtype=dtype)
        groups[rank].allreduce(arr, _op(pkgs[rank], ReduceOp.SUM)).wait(timeout=30)
        return arr

    a, b = _run_parallel([lambda: run(0), lambda: run(1)])
    np.testing.assert_array_equal(a, np.full(37, 3, dtype=dtype))
    np.testing.assert_array_equal(b, a)
    assert a.dtype == np.dtype(dtype)
    _shutdown(groups)


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_noncontiguous_input(store, world):
    """A transposed array reduces in place through the ring's copy."""
    pkgs = _pkgs(world, 2)
    groups = _make_group(store, pkgs, "noncontig")

    def run(rank):
        view = np.full((6, 4), float(rank + 1), dtype=np.float32).T
        assert not view.flags.c_contiguous
        groups[rank].allreduce(view, _op(pkgs[rank], ReduceOp.SUM)).wait(timeout=30)
        return view

    for a in _run_parallel([lambda: run(0), lambda: run(1)]):
        np.testing.assert_allclose(a, 3.0)
    _shutdown(groups)


@pytest.mark.parametrize("world", WORLDS)
def test_send_recv(store, world):
    groups = _make_group(store, _pkgs(world, 2), "p2p")

    def sender():
        groups[0].send([np.arange(6, dtype=np.float32)], dst=1, tag="x").wait(30)

    def receiver():
        (arr,) = groups[1].recv(src=0, tag="x").wait(30)
        return arr

    _, arr = _run_parallel([sender, receiver])
    np.testing.assert_allclose(arr, np.arange(6))
    _shutdown(groups)


# The framing that feeds a _PeerConn: the port's own, or the JAX package's
# (one wire).
SENDERS = {"port": t_net, "jax": j_net}


@pytest.mark.parametrize("sender", sorted(SENDERS))
def test_peer_conn_recv_fails_fast_after_peer_death(sender):
    """A recv issued after the peer's connection died fails at once (not
    at the per-tag timeout); a message delivered before the death is still
    consumable; a recv pending when the death lands fails too."""
    net = SENDERS[sender]
    a, b = socket_mod.socketpair()
    conn = _PeerConn(a, peer=1)
    try:
        arr = np.arange(8, dtype=np.float32)
        net.send_json(b, {"tag": "pre", "dtype": "float32", "shape": [8]})
        net.send_frame(b, arr.tobytes())
        deadline = time.monotonic() + 5
        while conn.dead is None and "pre" not in conn._queues:
            assert time.monotonic() < deadline, "message never arrived"
            time.sleep(0.01)
        b.close()
        while conn.dead is None:
            assert time.monotonic() < deadline, "reader never observed peer death"
            time.sleep(0.01)
        np.testing.assert_array_equal(conn.recv("pre", timeout=5.0), arr)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="died"):
            conn.recv("never-sent", timeout=30.0)
        assert time.monotonic() - t0 < 1.0

        a2, b2 = socket_mod.socketpair()
        conn2 = _PeerConn(a2, peer=2)
        try:
            errs = []

            def waiter():
                t = time.monotonic()
                try:
                    conn2.recv("pending", timeout=30.0)
                except RuntimeError:
                    errs.append(time.monotonic() - t)

            th = threading.Thread(target=waiter)
            th.start()
            time.sleep(0.2)
            b2.close()
            th.join(timeout=5)
            assert not th.is_alive()
            assert errs and errs[0] < 2.0
        finally:
            conn2.close()
    finally:
        conn.close()
        try:
            b.close()
        except OSError:
            pass


@pytest.mark.parametrize("sender", sorted(SENDERS))
def test_peer_conn_abort_tombstone_cleared_by_fresh_data(sender):
    """An abort tombstone fails recvs under its prefix until fresh data
    under the tag starts a new generation, which clears it."""
    net = SENDERS[sender]
    a, b = socket_mod.socketpair()
    conn = _PeerConn(a, peer=1)
    try:
        net.send_json(b, {"tag": "t1", "abort": True, "error": "leg died"})
        net.send_frame(b, b"")
        deadline = time.monotonic() + 5
        while "t1" not in conn._aborted:
            assert time.monotonic() < deadline, "abort never registered"
            time.sleep(0.01)
        with pytest.raises(_CollectiveAborted):
            conn.recv("t1.0", timeout=5.0)
        arr = np.arange(6, dtype=np.float32)
        net.send_json(b, {"tag": "t1.0", "dtype": "float32", "shape": [6]})
        net.send_frame(b, arr.tobytes())
        while "t1" in conn._aborted:
            assert time.monotonic() < deadline, "fresh data never cleared the tombstone"
            time.sleep(0.01)
        np.testing.assert_array_equal(conn.recv("t1.0", timeout=5.0), arr)
        net.send_json(b, {"tag": "t1.1", "dtype": "float32", "shape": [6]})
        net.send_frame(b, arr.tobytes())
        np.testing.assert_array_equal(conn.recv("t1.1", timeout=5.0), arr)
    finally:
        conn.close()
        try:
            b.close()
        except OSError:
            pass


@pytest.mark.parametrize("world", WORLDS)
def test_collective_abort_propagates_to_live_peers(store, world):
    """Rank 2's alltoall fails locally; ranks 0 and 1, mid-allreduce on the
    same collective, fail fast through the abort broadcast (transitively
    for rank 1), not at the 30 s tag timeout."""
    pkgs = _pkgs(world, 3)
    groups = _make_group(store, pkgs, "abort3", timeout=30.0)
    t0 = time.monotonic()

    def survivor(r):
        work = groups[r].allreduce(np.ones(64, dtype=np.float32))
        with pytest.raises(Exception, match="aborted|died"):
            work.wait(timeout=60)

    def failer():
        work = groups[2].alltoall([np.ones(4, dtype=np.float32)])
        with pytest.raises(ValueError):
            work.wait(timeout=60)

    _run_parallel([lambda: survivor(0), lambda: survivor(1), failer])
    elapsed = time.monotonic() - t0
    assert elapsed < 10, f"abort took {elapsed:.1f}s to propagate"
    _shutdown(groups)


@pytest.mark.parametrize("world", WORLDS)
def test_crash_and_reconfigure(store, world):
    """The last rank dies; the survivors' collectives raise; a reconfigure
    under a new prefix with a world of two succeeds and clears the error."""
    pkgs = _pkgs(world, 3)
    groups = _make_group(store, pkgs, "crash1")
    groups[2].shutdown()

    def failing(rank):
        with pytest.raises((RuntimeError, OSError)):
            groups[rank].allreduce(np.ones(1024, dtype=np.float32)).wait(timeout=5)
        return True

    assert all(_run_parallel([lambda: failing(0), lambda: failing(1)]))

    def reconfigure(rank):
        groups[rank].configure(f"{store.address()}/crash2", rank, 2)
        arr = np.full(3, float(rank), dtype=np.float32)
        groups[rank].allreduce(arr).wait(timeout=30)
        return arr

    for a in _run_parallel([lambda: reconfigure(0), lambda: reconfigure(1)]):
        np.testing.assert_allclose(a, 1.0)
    assert groups[0].errored() is None
    _shutdown(groups[:2])


def test_abort_latches_error(store):
    groups = _make_group(store, ("torch", "torch"), "abort")
    groups[0].abort()
    assert groups[0].errored() is not None
    with pytest.raises(RuntimeError):
        groups[0].allreduce(np.ones(2)).wait(timeout=5)
    _shutdown(groups)


def test_world_size_one_noop():
    pg = ProcessGroupSocket()
    pg.configure("unused:0/solo", 0, 1)
    out = pg.allreduce(np.full(4, 7.0), ReduceOp.SUM).wait(timeout=5)
    np.testing.assert_allclose(out[0], 7.0)
    pg.shutdown()


def test_dummy_pg():
    pg = ProcessGroupDummy()
    out = pg.allreduce(np.ones(3)).wait()
    np.testing.assert_allclose(out[0], 1.0)
    pg.configure("x:1/y", 0, 1)
    assert pg.configure_count == 1
    assert isinstance(pg.barrier(), DummyWork)


def test_error_swallowing_wrapper(store):
    wrapper = ErrorSwallowingProcessGroupWrapper(ProcessGroupDummy())
    fake_err = RuntimeError("injected")
    wrapper.report_error(fake_err)
    assert wrapper.error() is fake_err
    out = wrapper.allreduce(np.ones(2)).wait()
    np.testing.assert_allclose(out[0], 1.0)
    wrapper.configure("x:1/y", 0, 1)
    assert wrapper.error() is None


def test_fake_wrapper_injects_error():
    wrapper = FakeProcessGroupWrapper(ProcessGroupDummy())
    wrapper.report_future_error(ValueError("boom"))
    with pytest.raises(ValueError, match="boom"):
        wrapper.allreduce(np.ones(1)).wait(timeout=5)
    wrapper.allreduce(np.ones(1)).wait(timeout=5)


def _managed_by_a_real_manager():
    """A ``ManagedProcessGroup`` over the port's ``Manager`` of one replica:
    its allreduce goes through the Manager (quorum, averaging over the
    live participants) and its size and rank are the Manager's."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager

    lighthouse = LighthouseServer(min_replicas=1, join_timeout_ms=100, quorum_tick_ms=20)
    manager = Manager(
        pg=ProcessGroupSocket(timeout=10.0), min_replica_size=1, use_async_quorum=False,
        timeout=10.0, quorum_timeout=20.0, replica_id="managed0",
        lighthouse_addr=lighthouse.address(), group_rank=0, group_world_size=1,
        init_sync=False,
    )
    try:
        manager.start_quorum()
        pg = ManagedProcessGroup(manager)
        (out,) = pg.allreduce(torch.full((3,), 4.0)).wait(timeout=30)
        assert isinstance(out, torch.Tensor) and out.tolist() == [4.0, 4.0, 4.0]
        assert manager.should_commit()
        assert (pg.size(), pg.rank(), pg.errored()) == (1, 0, None)
        assert pg.getBackendName() == "torchft-managed"
        with pytest.raises(RuntimeError, match="configured by its Manager"):
            pg.configure("x:1/y", 0, 1)
    finally:
        manager.shutdown()
        lighthouse.shutdown()


@pytest.mark.parametrize("manager", ["fake", "port"])
def test_managed_pg_delegates_to_manager(manager):
    if manager == "port":
        _managed_by_a_real_manager()
        return

    class FakeManager:
        def __init__(self):
            self.calls = 0

        def allreduce(self, tensors):
            self.calls += 1
            return DummyWork(tensors)

        def num_participants(self):
            return 5

        def participating_rank(self):
            return 2

        def errored(self):
            return None

    m = FakeManager()
    pg = ManagedProcessGroup(m)
    pg.allreduce(np.ones(1)).wait()
    assert m.calls == 1
    assert pg.size() == 5
    assert pg.rank() == 2


def test_futures_engine():
    fut = concurrent.futures.Future()
    with pytest.raises(TimeoutError):
        futures.future_timeout(fut, 0.2).result(timeout=5)
    fut2 = concurrent.futures.Future()
    wrapped2 = futures.future_timeout(fut2, 5.0)
    fut2.set_result(42)
    assert wrapped2.result(timeout=5) == 42
    fired = threading.Event()
    with futures.context_timeout(fired.set, 0.2):
        fired.wait(1.0)
    assert fired.is_set()
    not_fired = threading.Event()
    with futures.context_timeout(not_fired.set, 5.0):
        pass
    assert not not_fired.is_set()


# --- the quantized collectives ------------------------------------------------


def _quantized(store, pkgs, prefix, data, call):
    """``call(pkg, group, rank, payload)`` on every rank of a world of
    ``pkgs``; returns the ranks' results."""
    groups = _make_group(store, pkgs, prefix)
    try:
        return _run_parallel([lambda r=r: call(pkgs[r], groups[r], r, data[r])
                              for r in range(len(pkgs))])
    finally:
        _shutdown(groups)


def _host_allreduce(bits=8, op=ReduceOp.SUM):
    def call(pkg, group, rank, payload):
        coll = tcoll if pkg == "torch" else jcoll
        arr = payload.copy()
        coll.allreduce_quantized(group, [arr], op=_op(pkg, op), bits=bits).wait(timeout=60)
        return arr
    return call


def _same_as_jax(store, ws, prefix, data, call, world) -> list:
    """The world's results, each equal bit for bit to the all-JAX world's."""
    want = _quantized(store, ("jax",) * ws, f"{prefix}j", data, call)
    got = _quantized(store, _pkgs(world, ws), f"{prefix}{world}", data, call)
    for r, (g, w) in enumerate(zip(got, want)):
        gs = g if isinstance(g, (list, tuple)) else [g]
        ws_ = w if isinstance(w, (list, tuple)) else [w]
        assert [_bits(x) for x in gs] == [_bits(x) for x in ws_], f"rank {r}"
    return got


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_quantized_accuracy(store, world):
    """The int8 host path within the int8 tolerance of the exact sum, and
    the all-JAX world's bits."""
    rng = np.random.default_rng(0)
    data = [rng.standard_normal(2047).astype(np.float32) for _ in range(2)]
    expected = sum(d.copy() for d in data)
    results = _same_as_jax(store, 2, "quant", data, _host_allreduce(), world)
    for r in results:
        np.testing.assert_allclose(r, expected, atol=np.abs(expected).max() * 0.05)
    err = np.abs(results[0] - expected).mean() / (np.abs(expected).mean() + 1e-9)
    assert err < 0.02, f"mean relative error too high: {err}"


def _device_path(bits=8, scale=1.0, after_issue=None):
    """The device entry points: the port's ``allreduce_quantized_torch`` on
    CPU tensors, the JAX package's ``allreduce_quantized_jax``."""
    def call(pkg, group, rank, payload):
        leaves = payload if isinstance(payload, list) else [payload]
        if pkg == "torch":
            inputs = [torch.from_numpy(a.copy()) for a in leaves]
            work = tcoll.allreduce_quantized_torch(group, inputs, scale=scale, bits=bits)
            if after_issue is not None:
                after_issue(inputs, leaves)
            outs = work.wait(timeout=60)
            for o, i in zip(outs, inputs):
                assert isinstance(o, torch.Tensor) and o.data_ptr() != i.data_ptr()
            return [o.numpy().copy() for o in outs]
        outs = jcoll.allreduce_quantized_jax(group, [jnp.asarray(a) for a in leaves],
                                             scale=scale, bits=bits).wait(timeout=60)
        return [np.asarray(o) for o in outs]
    return call


def _count_wire_bytes(groups):
    sent = {"bytes": 0}
    for g in groups:
        inner = getattr(g, "_pg", g)
        for conn in inner._peers.values():
            orig = conn.send

            def wrapped(tag, arr, _orig=orig):
                sent["bytes"] += arr.nbytes
                return _orig(tag, arr)

            conn.send = wrapped
    return sent


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_quantized_torch_device_path(store, world):
    """The port's device path: quantize (plain version), int8 over the
    wire, dequantize; within the tolerance of the exact sum, the JAX device
    path's bits, and at least 3.5x fewer wire bytes than the fp32 ring."""
    ws, n = 2, 65536
    rng = np.random.default_rng(1)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(ws)]
    expected = sum(d.copy() for d in data)
    results = _same_as_jax(store, ws, "qdev", data, _device_path(), world)
    for (r,) in results:
        np.testing.assert_allclose(r, expected, atol=np.abs(expected).max() * 0.05)
    err = np.abs(results[0][0] - expected).mean() / (np.abs(expected).mean() + 1e-9)
    assert err < 0.02, f"mean relative error too high: {err}"

    pkgs = _pkgs(world, ws)
    groups = _make_group(store, pkgs, f"qbytes{world}")
    sent = _count_wire_bytes(groups)
    call = _device_path()
    _run_parallel([lambda r=r: call(pkgs[r], groups[r], r, data[r]) for r in range(ws)])
    quant_bytes, sent["bytes"] = sent["bytes"], 0
    _run_parallel([lambda r=r: groups[r].allreduce([data[r].copy()]).wait(timeout=60)
                   for r in range(ws)])
    reduction = sent["bytes"] / max(quant_bytes, 1)
    assert reduction >= 3.5, (reduction, sent["bytes"], quant_bytes)
    _shutdown(groups)


def test_allreduce_quantized_torch_keeps_its_inputs(store):
    """The port's contract where the JAX package's is a donated input: the
    inputs are not written, the outputs are new tensors, and the caller
    may overwrite its input as soon as the call returns (here zeroed at
    once) without changing the result: the JAX world's bits."""
    ws, n = 2, 4096
    rng = np.random.default_rng(7)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(ws)]

    untouched = []

    def check_then_zero(inputs, leaves):
        untouched.append(all(np.array_equal(i.numpy(), a) for i, a in zip(inputs, leaves)))
        for i in inputs:
            i.zero_()

    results = _same_as_jax(store, ws, "qkeep", data, _device_path(after_issue=check_then_zero),
                           "port")
    assert untouched == [True, True]
    expected = sum(d.copy() for d in data)
    for (r,) in results:
        np.testing.assert_allclose(r, expected, atol=np.abs(expected).max() * 0.05)


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_quantized_torch_scale_and_multi_array(store, world):
    """``scale`` (1/N) on the dequantized result; leaves of three shapes
    round-trip through one flat buffer."""
    ws = 2
    rng = np.random.default_rng(2)
    shapes = [(128, 33), (700,), (5, 5, 5)]
    data = {r: [rng.standard_normal(s).astype(np.float32) for s in shapes] for r in range(ws)}
    expected = [(data[0][i] + data[1][i]) / ws for i in range(len(shapes))]
    results = _same_as_jax(store, ws, "qmulti", data, _device_path(scale=1.0 / ws), world)
    for outs in results:
        assert [o.shape for o in outs] == shapes
        for o, e in zip(outs, expected):
            np.testing.assert_allclose(o, e, atol=np.abs(e).max() * 0.05)


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_quantized_mixed_entry_points_interop(store, world):
    """Rank 0 calls the numpy entry point, rank 1 the device one: one wire,
    one result, the all-JAX world's bits."""
    ws, n = 2, 4096
    rng = np.random.default_rng(3)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(ws)]
    host, device = _host_allreduce(), _device_path()

    def call(pkg, group, rank, payload):
        return [host(pkg, group, rank, payload)] if rank == 0 else device(pkg, group, rank, payload)

    results = _same_as_jax(store, ws, "qmix", data, call, world)
    expected = data[0] + data[1]
    for (r,) in results:
        np.testing.assert_allclose(r, expected, atol=np.abs(expected).max() * 0.05)


def _reduce_scatter(bits=8):
    def call(pkg, group, rank, payload):
        coll = tcoll if pkg == "torch" else jcoll
        shard, (start, end) = coll.reduce_scatter_quantized(
            group, [payload.copy()], bits=bits).wait(timeout=60)
        return [shard, np.array([start, end])]
    return call


@pytest.mark.parametrize("world", WORLDS)
def test_reduce_scatter_quantized(store, world):
    """Each rank's block-aligned reduced shard; the shards tile the buffer;
    a payload of fewer blocks than ranks takes the allgather branch; every
    shard the all-JAX world's bits."""
    ws, n = 3, 3000
    rng = np.random.default_rng(5)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(ws)]
    expected = sum(d.copy() for d in data)
    results = _same_as_jax(store, ws, "rsq", data, _reduce_scatter(), world)
    covered = np.zeros(n, bool)
    for shard, (start, end) in results:
        assert shard.shape == (end - start,)
        np.testing.assert_allclose(shard, expected[start:end], atol=np.abs(expected).max() * 0.05)
        covered[start:end] = True
    assert covered.all(), "shards do not tile the buffer"

    tiny = [d[:700] for d in data]
    results = _same_as_jax(store, ws, "rsqtiny", tiny, _reduce_scatter(), world)
    exp = expected[:700]
    covered = np.zeros(700, bool)
    for shard, (start, end) in results:
        end = min(end, 700)
        np.testing.assert_allclose(shard[: end - start], exp[start:end],
                                   atol=np.abs(exp).max() * 0.05)
        covered[start:end] = True
    assert covered.all()


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_quantized_int4_wire(store, world):
    """bits=4, the host entry point on rank 0 and the device one on rank
    1: within the int4 tolerance, the same bytes on both ranks, the
    all-JAX world's bits."""
    ws = 2
    n = 4 * 512 + 130
    rng = np.random.default_rng(11)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(ws)]
    expected = data[0] + data[1]
    host, device = _host_allreduce(bits=4), _device_path(bits=4)

    def call(pkg, group, rank, payload):
        return [host(pkg, group, rank, payload)] if rank == 0 else device(pkg, group, rank, payload)

    results = [r[0] for r in _same_as_jax(store, ws, "q4", data, call, world)]
    tol = 3 * max(np.abs(d).max() for d in data) / 7.0
    for r in results:
        assert np.abs(r - expected).max() <= tol
    np.testing.assert_allclose(results[0], results[1], rtol=1e-6, atol=1e-6)
    err = np.abs(results[0] - expected).mean() / (np.abs(expected).mean() + 1e-9)
    assert err < 0.3, f"mean relative error too high for int4: {err}"


@pytest.mark.parametrize("world", WORLDS)
def test_reduce_scatter_quantized_int4(store, world):
    """bits=4 reduce_scatter: two blocks a rank, within the int4
    tolerance, the all-JAX world's bits."""
    ws, n = 2, 4 * 512
    rng = np.random.default_rng(13)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(ws)]
    expected = data[0] + data[1]
    results = _same_as_jax(store, ws, "rs4", data, _reduce_scatter(bits=4), world)
    tol = 2 * max(np.abs(d).max() for d in data) / 7.0
    covered = []
    for shard, (start, end) in results:
        assert np.abs(shard[: end - start] - expected[start:end]).max() <= tol
        covered.append((int(start), int(end)))
    assert covered == [(0, 1024), (1024, 2048)]


@pytest.mark.parametrize("world", WORLDS)
def test_wire_byte_accounting_quantized_vs_fp32(store, world):
    """``pg_wire_tx`` (each package counts its own ranks' sends): an int4
    allreduce of 64k values moves under a quarter of the fp32 ring's
    bytes, and the fp32 ring at least one payload."""
    ws, n = 2, 1 << 16
    pkgs = _pkgs(world, ws)
    groups = _make_group(store, pkgs, f"bytes{world}")
    data = np.ones(n, np.float32)

    def tx() -> int:
        return sum(t.byte_stats().get("pg_wire_tx", 0) for t in (ttelemetry, jtelemetry))

    for t in (ttelemetry, jtelemetry):
        t.reset_byte_stats()
    _run_parallel([lambda r=r: groups[r].allreduce([data.copy()], _op(pkgs[r], ReduceOp.SUM))
                   .wait(timeout=30) for r in range(ws)])
    fp32_tx = tx()
    assert fp32_tx >= n * 4, fp32_tx
    if world == "port":
        assert jtelemetry.byte_stats().get("pg_wire_tx", 0) == 0
    for t in (ttelemetry, jtelemetry):
        t.reset_byte_stats()
    call = _host_allreduce(bits=4)
    _run_parallel([lambda r=r: call(pkgs[r], groups[r], r, data) for r in range(ws)])
    q4_tx = tx()
    assert 0 < q4_tx < fp32_tx * 0.25, (q4_tx, fp32_tx)
    _shutdown(groups)


@pytest.mark.parametrize("world", WORLDS)
def test_allreduce_quantized_int4_three_ranks_odd_size(store, world):
    """int4, three ranks, 2047 values: the nibble payload chunks on block
    boundaries, and every rank decodes the same average, the all-JAX
    world's bits."""
    ws, n = 3, 2047
    rng = np.random.default_rng(21)
    data = [rng.standard_normal(n).astype(np.float32) for _ in range(ws)]
    expected = sum(d.copy() for d in data) / ws
    results = _same_as_jax(store, ws, "q4x3", data, _host_allreduce(bits=4, op=ReduceOp.AVG),
                           world)
    np.testing.assert_array_equal(results[0], results[1])
    np.testing.assert_array_equal(results[0], results[2])
    tol = 2 * max(np.abs(d).max() for d in data) / 7.0
    np.testing.assert_allclose(results[0], expected, atol=tol)
