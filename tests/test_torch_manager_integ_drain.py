"""The drains of tests/test_manager_integ.py on the port's ``Manager`` (one
of the four files of that twin; see tests/test_torch_manager_integ.py): a
graceful ``leave()``, the operator's ``request_drain`` seen through
``drain_requested()``, and one ``drain_all`` that reaches every replica."""

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import numpy as np
import pytest
import torch

from test_torch_manager_integ import _state_fns
from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.process_group import ProcessGroupSocket


def _grad(shape, value: float) -> torch.Tensor:
    return torch.full(shape, value)


def test_graceful_drain_leave() -> None:
    """Replica 1 drains by ``leave()`` after two commits of its own;
    replica 0 finishes alone without waiting out the 30 s heartbeat
    timeout (its 20 s quorum timeout would fail it), and a drained Manager
    refuses to rejoin."""
    server = LighthouseServer(min_replicas=1, join_timeout_ms=1000, quorum_tick_ms=50,
                              heartbeat_timeout_ms=30000)
    total_steps = 6
    drain_after_commits = 2
    results: Dict[int, Dict[str, np.ndarray]] = {}

    def run(replica: int) -> None:
        params = {"w": torch.zeros(4, 3), "b": torch.zeros(3)}
        state_dict, load_state = _state_fns("torch", params)
        manager = Manager(
            pg=ProcessGroupSocket(timeout=5.0), state_dict=state_dict,
            load_state_dict=load_state, min_replica_size=1, timeout=10.0,
            quorum_timeout=20.0, connect_timeout=10.0, replica_id=f"drain{replica}",
            lighthouse_addr=server.address(), group_rank=0, group_world_size=1,
        )
        my_commits = 0
        try:
            while manager.current_step() < total_steps:
                step = manager.current_step()
                if replica == 1 and my_commits >= drain_after_commits:
                    assert manager.leave() is True
                    with pytest.raises(RuntimeError, match="drained"):
                        manager.start_quorum()
                    break
                manager.start_quorum()
                grads = [_grad((4, 3), 1.0 + step), _grad((3,), 0.5 * (step + 1))]
                reduced = [manager.allreduce(g).wait(timeout=30)[0] for g in grads]
                with manager.fenced_state_dict():
                    if manager.should_commit():
                        for p, g in zip(params.values(), reduced):
                            p -= 0.1 * g
                        my_commits += 1
            results[replica] = {k: v.numpy().copy() for k, v in params.items()}
        finally:
            manager.shutdown()

    t0 = time.monotonic()
    pool = ThreadPoolExecutor(max_workers=2)
    try:
        futs = [pool.submit(run, r) for r in range(2)]
        for f in futs:
            f.result(timeout=120)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        server.shutdown()
    elapsed = time.monotonic() - t0
    assert not np.allclose(results[0]["w"], 0)
    assert not np.allclose(results[1]["w"], 0)
    assert elapsed < 60, f"drain path took {elapsed:.1f}s"


def _drain_run(server, replica: int, tag: str, min_replicas: int, total_steps: int,
               drains: bool, managers: Dict[int, Manager], training: threading.Event,
               outcome: Dict[int, Dict[str, Any]]) -> None:
    """One replica of the operator-drain tests: steps until it sees
    ``drain_requested()`` (when ``drains``), then leaves."""
    params = {"w": torch.zeros(4)}
    state_dict, load_state = _state_fns("torch", params)
    manager = Manager(
        pg=ProcessGroupSocket(timeout=10.0), state_dict=state_dict,
        load_state_dict=load_state, min_replica_size=min_replicas, timeout=10.0,
        quorum_timeout=20.0, replica_id=f"{tag}{replica}",
        lighthouse_addr=server.address(), group_rank=0, group_world_size=1,
    )
    managers[replica] = manager
    drained = False
    try:
        while manager.current_step() < total_steps:
            if drains and manager.drain_requested():
                assert manager.leave() is True
                drained = True
                break
            manager.start_quorum()
            step = manager.current_step()
            if step >= 2:
                training.set()
            (g,) = manager.allreduce(torch.full((4,), 1.0 + step)).wait(timeout=30)
            with manager.fenced_state_dict():
                if manager.should_commit():
                    params["w"] -= 0.01 * g
        outcome[replica] = {"drained": drained, "final_step": manager.current_step()}
    finally:
        manager.shutdown()


def test_operator_requested_drain() -> None:
    """``LighthouseClient.request_drain`` on replica 1 (the dashboard's
    drain button): it sees ``drain_requested()`` at its next quorum and
    leaves mid-run; replica 0 runs to the end."""
    server = LighthouseServer(min_replicas=1, join_timeout_ms=1000, quorum_tick_ms=50,
                              heartbeat_timeout_ms=30000)
    total_steps = 300
    outcome: Dict[int, Dict[str, Any]] = {}
    managers: Dict[int, Manager] = {}
    training = [threading.Event(), threading.Event()]
    pool = ThreadPoolExecutor(max_workers=2)
    try:
        futs = [pool.submit(_drain_run, server, r, "opdrain", 1, total_steps, r == 1,
                            managers, training[r], outcome) for r in range(2)]
        assert training[1].wait(timeout=60), "replica 1 never trained"
        client = LighthouseClient(server.address())
        client.request_drain(managers[1].replica_id())
        client.close()
        for f in futs:
            f.result(timeout=120)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        server.shutdown()
    assert outcome[1]["drained"], outcome
    assert 0 < outcome[1]["final_step"] < total_steps, outcome
    assert not outcome[0]["drained"]
    assert outcome[0]["final_step"] == total_steps


@pytest.mark.timeout(240)
def test_operator_drain_all() -> None:
    """One ``LighthouseClient.drain_all`` (the dashboard's drain ALL)
    reaches both replicas' managers: each sees ``drain_requested()`` at
    its next quorum and leaves mid-run."""
    server = LighthouseServer(min_replicas=2, join_timeout_ms=2000, quorum_tick_ms=50,
                              heartbeat_timeout_ms=30000)
    total_steps = 300
    outcome: Dict[int, Dict[str, Any]] = {}
    managers: Dict[int, Manager] = {}
    training = [threading.Event(), threading.Event()]
    pool = ThreadPoolExecutor(max_workers=2)
    try:
        futs = [pool.submit(_drain_run, server, r, "drainall", 2, total_steps, True,
                            managers, training[r], outcome) for r in range(2)]
        for ev in training:
            assert ev.wait(timeout=60), "a replica never trained"
        client = LighthouseClient(server.address())
        report = client.drain_all()
        client.close()
        assert report["n_members"] == 2, report
        assert report["n_sent"] == 2, report
        for f in futs:
            f.result(timeout=120)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        server.shutdown()
    for r in (0, 1):
        assert outcome[r]["drained"], outcome
        assert 0 < outcome[r]["final_step"] < total_steps, outcome
