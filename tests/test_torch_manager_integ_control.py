"""The control-plane faults and the device-quantized allreduce of
tests/test_manager_integ.py on the port's ``Manager`` (one of the four
files of that twin; see tests/test_torch_manager_integ.py): the
lighthouse killed mid-run and restarted at the same address (a port and a
mixed world), a lighthouse that drops the first quorum connections, a
collective wedged past the Manager's deadline, and the quantized allreduce
of CPU tensors down the port's device path (``TORCHFT_FORCE_DEVICE_QUANT``,
the kernels' plain versions) held to the JAX device path's bits."""

import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_manager_integ import PACKAGES, WORLDS, _full, _host, _state_fns, pkgs_for
from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.process_group import FakeProcessGroupWrapper, ProcessGroupSocket


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_lighthouse_outage_and_restart(world) -> None:
    """The lighthouse process dies between two rounds: the in-flight
    quorums fail, both replicas' commits fail and no trainer raises; a new
    lighthouse at the same address brings the next round's commit back,
    with the average of 1.0 and 2.0."""
    pkgs = pkgs_for(world, 2)
    ws = 2
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=30000,
                          quorum_tick_ms=20)
    addr = lh.address()
    port = int(addr.rsplit(":", 1)[1])
    barrier = threading.Barrier(ws + 1)
    results: dict = {r: [] for r in range(ws)}

    def run(replica: int):
        P = PACKAGES[pkgs[replica]]
        manager = P.Manager(
            pg=P.Socket(timeout=10.0), min_replica_size=2, use_async_quorum=False,
            timeout=20.0, quorum_timeout=60.0, replica_id=f"lhout{replica}",
            lighthouse_addr=addr, group_rank=0, group_world_size=1, max_retries=5,
        )
        try:
            for rnd in range(3):
                barrier.wait(timeout=120)
                try:
                    manager.start_quorum(timeout=6.0 if rnd == 1 else 60.0)
                except Exception:
                    assert manager.errored() is not None
                arr = _full(pkgs[replica], (512,), float(replica + 1))
                (out,) = manager.allreduce(arr).wait(timeout=30)
                committed = manager.should_commit()
                results[replica].append((committed, float(_host(out)[0])))
        finally:
            manager.shutdown()

    def wait_round(futs) -> None:
        while barrier.n_waiting < ws:
            time.sleep(0.2)
            for f in futs:
                if f.done():
                    f.result()

    pool = ThreadPoolExecutor(max_workers=ws)
    try:
        futs = [pool.submit(run, r) for r in range(ws)]
        barrier.wait(timeout=60)  # round 0: healthy
        time.sleep(0.1)
        wait_round(futs)
        lh.shutdown()
        barrier.wait(timeout=60)  # round 1: the lighthouse is gone
        wait_round(futs)
        lh2 = LighthouseServer(bind=f"127.0.0.1:{port}", min_replicas=2,
                               join_timeout_ms=30000, quorum_tick_ms=20)
        try:
            barrier.wait(timeout=60)  # round 2: back at the same address
            for f in futs:
                f.result(timeout=180)
        finally:
            lh2.shutdown()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        lh.shutdown()

    for r in range(ws):
        assert len(results[r]) == 3
        committed, avg = results[r][0]
        assert committed and avg == 1.5, results[r]
        committed, _ = results[r][1]
        assert not committed, results[r]
        committed, avg = results[r][2]
        assert committed and avg == 1.5, results[r]


def test_quorum_retries_through_flaky_lighthouse() -> None:
    """With ``quorum_retries`` 4 the port's Manager rides out a lighthouse
    whose first two quorum connections a proxy resets: the manager
    server's per-attempt slices retry through them and the step commits."""
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=5000,
                          quorum_tick_ms=20)
    real_host, real_port = lh.address().rsplit(":", 1)
    drops = {"left": 2, "total": 0}
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(16)
    proxy_port = srv.getsockname()[1]
    stop = threading.Event()

    def pipe(a, b):
        try:
            while True:
                data = a.recv(65536)
                if not data:
                    break
                b.sendall(data)
        except OSError:
            pass
        finally:
            for s in (a, b):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def serve():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            # Only quorum connections drop: the heartbeat loop's connection
            # must not take the programmed failures.
            try:
                conn.settimeout(5.0)
                head = conn.recv(4096)
            except OSError:
                conn.close()
                continue
            if b'"quorum"' in head:
                drops["total"] += 1
                if drops["left"] > 0:
                    drops["left"] -= 1
                    conn.close()
                    continue
            conn.settimeout(None)
            try:
                up = socket.create_connection((real_host, int(real_port)), 5)
                up.sendall(head)
            except OSError:
                conn.close()
                continue
            threading.Thread(target=pipe, args=(conn, up), daemon=True).start()
            threading.Thread(target=pipe, args=(up, conn), daemon=True).start()

    threading.Thread(target=serve, daemon=True).start()
    manager = None
    try:
        manager = Manager(
            pg=ProcessGroupSocket(timeout=10.0), min_replica_size=1,
            use_async_quorum=False, timeout=20.0, quorum_timeout=30.0,
            replica_id="flaky0", lighthouse_addr=f"127.0.0.1:{proxy_port}",
            group_rank=0, group_world_size=1, quorum_retries=4,
        )
        t0 = time.monotonic()
        manager.start_quorum()
        manager.allreduce(torch.full((64,), 2.0)).wait(timeout=30)
        assert manager.should_commit()
        assert drops["left"] == 0 and drops["total"] >= 3, drops
        assert time.monotonic() - t0 < 30.0
    finally:
        if manager is not None:
            manager.shutdown()
        stop.set()
        srv.close()
        lh.shutdown()


# The wedged collective's deadlines. The JAX test is a known flaky one
# under a loaded suite (ROADMAP.md, "Flaky JAX tests"); its twin keeps the
# JAX test's bounds on the behaviour (the healthy replica's failed wait
# under 30 s, against a 60 s socket timeout) and gives the loaded suite
# room in the waits around it: the settle loop's 120 s and the test's own
# limit.
WEDGE_SETTLE_S = 120.0


@pytest.mark.timeout(300)
def test_wedged_collective_aborted_and_recovered() -> None:
    """Replica 1 stalls (not fails) its collective at step 1 for 8 s, past
    the 3 s Manager deadline; the timeout engine aborts the wedged group so
    replica 0's wait fails fast (not at the 60 s socket bound), the failed
    commit bumps the quorum, both reconfigure, and both end at step 3
    bitwise equal, with the failure in the goodput ledger."""
    n_steps = 3
    stall_at_step = 1
    lighthouse = LighthouseServer(min_replicas=1, join_timeout_ms=1000, quorum_tick_ms=50,
                                  heartbeat_timeout_ms=1000)
    done_flags = [threading.Event(), threading.Event()]

    def run(replica: int):
        params = {"w": torch.zeros(4)}
        state_dict, load_state = _state_fns("torch", params)
        pg = FakeProcessGroupWrapper(ProcessGroupSocket(timeout=60.0))
        manager = Manager(
            pg=pg, state_dict=state_dict, load_state_dict=load_state,
            min_replica_size=2, use_async_quorum=False, timeout=3.0,
            quorum_timeout=20.0, connect_timeout=10.0, replica_id=f"wedge{replica}",
            lighthouse_addr=lighthouse.address(), group_rank=0, group_world_size=1,
            max_retries=8,
        )
        commits = []
        try:
            while manager.current_step() < n_steps:
                manager.start_quorum()
                step = manager.current_step()
                if step >= n_steps:
                    break
                if replica == 1 and step == stall_at_step and not any(
                        c is False for c in commits):
                    pg.delay_work(8.0)
                grad = torch.full((4,), 1.0 + step)
                t0 = time.monotonic()
                manager.allreduce(grad).wait(timeout=None)
                elapsed = time.monotonic() - t0
                with manager.fenced_state_dict():
                    committed = manager.should_commit()
                    commits.append(committed)
                    if committed:
                        params["w"] -= 0.1 * grad
                if not committed and replica == 0:
                    assert elapsed < 30.0, f"wait took {elapsed:.1f}s"
            done_flags[replica].set()
            snapshot = params["w"].numpy().copy()
            # Settle: stay in the quorum with zero payloads until the peer
            # reaches n_steps too.
            deadline = time.monotonic() + WEDGE_SETTLE_S
            while not done_flags[1 - replica].is_set():
                if time.monotonic() > deadline:
                    break
                manager.start_quorum()
                manager.allreduce(torch.zeros(4)).wait(timeout=15)
                manager.should_commit()
            return {"params": snapshot, "commits": commits, "goodput": manager.goodput()}
        finally:
            done_flags[replica].set()
            manager.shutdown()

    pool = ThreadPoolExecutor(max_workers=2)
    try:
        futs = {r: pool.submit(run, r) for r in (0, 1)}
        results = {r: f.result(timeout=240) for r, f in futs.items()}
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        lighthouse.shutdown()

    assert any(c is False for c in results[0]["commits"]), results
    np.testing.assert_array_equal(results[0]["params"], results[1]["params"])
    g0 = results[0]["goodput"]
    assert g0["failed_commits"] >= 1 and g0["failed_s"] > 0, g0
    for r in (0, 1):
        g = results[r]["goodput"]
        if g["heal_count"]:
            assert g["heal_s"] > 0, g
        assert g["goodput_frac"] is None or 0 <= g["goodput_frac"] <= 1


QUANT_N = 4096


def _quantized_world(pkgs, monkeypatch) -> list:
    """Two replicas of ``pkgs`` each allreduce, quantized, the JAX test's
    constant leaf (r + 1) and a seeded normal leaf; returns each replica's
    outputs as numpy. The port's replicas pass CPU tensors down the device
    path (``TORCHFT_FORCE_DEVICE_QUANT``), the JAX ones jax arrays."""
    rng = np.random.default_rng(5)
    noise = [rng.standard_normal(QUANT_N - 1).astype(np.float32) for _ in range(2)]
    if "torch" in pkgs:
        monkeypatch.setenv("TORCHFT_FORCE_DEVICE_QUANT", "1")
    # Two members before any quorum: the JAX test's shared lighthouse (one
    # member, a 1 s join window) can form a quorum of one first, which it
    # retries around; this world cannot.
    lighthouse = LighthouseServer(min_replicas=2, join_timeout_ms=10000, quorum_tick_ms=20,
                                  heartbeat_timeout_ms=1000)

    def run(replica: int):
        P = PACKAGES[pkgs[replica]]
        manager = P.Manager(
            pg=P.Socket(timeout=10.0), min_replica_size=2, use_async_quorum=False,
            timeout=20.0, quorum_timeout=60.0, replica_id=f"qdev{replica}",
            lighthouse_addr=lighthouse.address(), group_rank=0, group_world_size=1,
        )
        try:
            manager.start_quorum()
            leaves = [np.full(QUANT_N, float(replica + 1), np.float32), noise[replica]]
            if pkgs[replica] == "torch":
                leaves = [torch.from_numpy(a.copy()) for a in leaves]
                from torchft_tpu_torch.collectives import takes_device_path
                assert takes_device_path(leaves)
            else:
                leaves = [jnp.asarray(a) for a in leaves]
            outs = manager.allreduce(leaves, should_quantize=True).wait(timeout=30)
            assert manager.should_commit()
            if pkgs[replica] == "torch":
                assert all(isinstance(o, torch.Tensor) for o in outs)
            return [_host(o) for o in outs]
        finally:
            manager.shutdown()

    pool = ThreadPoolExecutor(max_workers=2)
    try:
        futs = [pool.submit(run, r) for r in range(2)]
        results = [f.result(timeout=150) for f in futs]
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        lighthouse.shutdown()
    expected = (np.full(QUANT_N, 1.0, np.float32) + np.full(QUANT_N, 2.0, np.float32)) / 2
    for outs in results:
        np.testing.assert_allclose(outs[0], expected, atol=np.abs(expected).max() * 0.05)
    return results


_JAX_QUANT: list = []


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_manager_quantized_allreduce_device_path(world, monkeypatch) -> None:
    """``Manager.allreduce(..., should_quantize=True)`` on CPU tensors takes
    the port's device path (the kernels' plain versions) end to end across
    two replicas: int8 over the socket group, averaged over the
    participants; each replica's outputs equal the JAX device path's
    (``allreduce_quantized_jax`` on the CPU) bit for bit, in a port and a
    mixed world."""
    if not _JAX_QUANT:
        with monkeypatch.context() as m:
            m.delenv("TORCHFT_FORCE_DEVICE_QUANT", raising=False)
            _JAX_QUANT.extend(_quantized_world(("jax", "jax"), m))
    results = _quantized_world(pkgs_for(world, 2), monkeypatch)
    for r in range(2):
        for got, want in zip(results[r], _JAX_QUANT[r]):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert results[0][1].tobytes() == results[1][1].tobytes()
