"""The port's end-to-end fault-tolerance scenarios: the twin of
tests/test_manager_integ.py:214-1072, with the port's ``Manager`` over the
port's ``ProcessGroupSocket`` (``FakeProcessGroupWrapper`` for the injected
allreduce failures), CPU tensors for state and gradients, real C++ manager
servers, a real lighthouse and real HTTP heals.

The JAX file's subjects are split over four files so that each stays
under a minute: this one holds the scenarios that end in state (healthy,
crash and recovery, three replicas with one crash, upscale, ``reduce_op``
SUM) and the quorum's latency; tests/test_torch_manager_integ_retry.py the
allreduce retry; tests/test_torch_manager_integ_drain.py the drains;
tests/test_torch_manager_integ_control.py the lighthouse outage, the flaky
lighthouse, the wedged collective and the device-quantized allreduce.

Every scenario that ends in state runs three worlds: all port replicas,
all JAX replicas (the reference, run once a scenario and kept), and a
mixed world of port and JAX replicas on one lighthouse (the numpy wire is
shared). Each world's replicas must end bitwise equal, and the port's and
the mixed world's state must equal the JAX world's bit for bit. In a mixed
world with a crash the crashing or joining replica is the JAX one, so that
its heal source is a port replica (ROADMAP.md §3: the JAX Manager skips
the fencing collective)."""

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import pytest
import torch

from torchft_tpu import coordination as jcoord
from torchft_tpu import manager as jmanager
from torchft_tpu import process_group as jpg
from torchft_tpu_torch import coordination as tcoord
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch import process_group as tpg

logger = logging.getLogger(__name__)

PACKAGES = {
    "jax": SimpleNamespace(
        Manager=jmanager.Manager, Socket=jpg.ProcessGroupSocket,
        Fake=jpg.FakeProcessGroupWrapper, ReduceOp=jpg.ReduceOp,
        LighthouseServer=jcoord.LighthouseServer,
        LighthouseClient=jcoord.LighthouseClient,
    ),
    "torch": SimpleNamespace(
        Manager=tmanager.Manager, Socket=tpg.ProcessGroupSocket,
        Fake=tpg.FakeProcessGroupWrapper, ReduceOp=tpg.ReduceOp,
        LighthouseServer=tcoord.LighthouseServer,
        LighthouseClient=tcoord.LighthouseClient,
    ),
}


class InjectedFailure(Exception):
    pass


@dataclass
class Failure:
    """Hard crash of the replica (restarted by the Runner)."""


@dataclass
class AllreduceFailure:
    """The next allreduce on this replica fails (step retried, no restart)."""


class EventInjector:
    """Fires events at (replica, step), as the JAX file's injector does."""

    def __init__(self) -> None:
        self._events: Dict[tuple, object] = {}
        self.count = 0

    def fail_at(self, replica: int, step: int) -> "EventInjector":
        self._events[(replica, step)] = Failure()
        return self

    def fail_allreduce_at(self, replica: int, step: int) -> "EventInjector":
        self._events[(replica, step)] = AllreduceFailure()
        return self

    def check(self, replica: int, step: int, pg) -> None:
        # The target step or the first after it: a late joiner can heal
        # past the target without observing it.
        event = None
        for (rep, at_step), ev in sorted(self._events.items()):
            if rep == replica and step >= at_step:
                event = self._events.pop((rep, at_step))
                break
        if event is None:
            return
        self.count += 1
        if isinstance(event, Failure):
            raise InjectedFailure(f"injected failure replica={replica} step={step}")
        pg.report_future_error(RuntimeError(f"injected allreduce failure step={step}"))


def _zeros(pkg: str, shape) -> object:
    return torch.zeros(shape) if pkg == "torch" else np.zeros(shape, np.float32)


def _full(pkg: str, shape, value: float) -> object:
    a = np.full(shape, value, np.float32)
    return torch.from_numpy(a) if pkg == "torch" else a


def _host(v) -> np.ndarray:
    return v.numpy().copy() if isinstance(v, torch.Tensor) else np.array(v)


def _state_fns(pkg: str, params: dict):
    """(state_dict, load_state_dict) over ``params``: the port's are
    tensors, the JAX package's numpy arrays; a heal may bring either."""
    if pkg == "torch":
        def load(state):
            for k, v in state.items():
                params[k].copy_(torch.as_tensor(_host(v)))
        return (lambda: {k: v.clone() for k, v in params.items()}), load

    def load(state):
        for k, v in state.items():
            params[k][...] = _host(v)
    return (lambda: {k: v.copy() for k, v in params.items()}), load


@dataclass
class Runner:
    """One replica group of package ``pkg``, restarted up to ``attempts``
    times on an injected crash (the JAX file's Runner)."""

    replica: int
    lighthouse_addr: str
    injector: EventInjector
    pkg: str = "torch"
    total_steps: int = 6
    use_async_quorum: bool = True
    attempts: int = 3
    manager_ref: list = field(default_factory=list)
    participants_log: list = field(default_factory=list)
    post_quorum_hook: Optional[object] = None
    # Called with (runner, manager, step) right before start_quorum.
    pre_quorum_hook: Optional[object] = None

    def run(self) -> Dict[str, np.ndarray]:
        for attempt in range(self.attempts):
            try:
                return self._train()
            except InjectedFailure:
                logger.info("replica %d restarting (attempt %d)", self.replica, attempt)
        raise RuntimeError(f"replica {self.replica} exhausted attempts")

    def _train(self) -> Dict[str, np.ndarray]:
        P = PACKAGES[self.pkg]
        params = {"w": _zeros(self.pkg, (4, 3)), "b": _zeros(self.pkg, (3,))}
        state_dict, load_state = _state_fns(self.pkg, params)
        pg = P.Fake(P.Socket(timeout=5.0))
        manager = P.Manager(
            pg=pg,
            state_dict=state_dict,
            load_state_dict=load_state,
            min_replica_size=1,
            use_async_quorum=self.use_async_quorum,
            timeout=10.0,
            quorum_timeout=20.0,
            connect_timeout=10.0,
            replica_id=f"replica{self.replica}",
            lighthouse_addr=self.lighthouse_addr,
            group_rank=0,
            group_world_size=1,
            max_retries=8,
        )
        self.manager_ref.append(manager)
        try:
            while manager.current_step() < self.total_steps:
                self.injector.check(self.replica, manager.current_step(), pg)
                if self.pre_quorum_hook is not None:
                    self.pre_quorum_hook(self, manager, manager.current_step())
                manager.start_quorum()
                if self.post_quorum_hook is not None:
                    self.post_quorum_hook(self, manager, manager.current_step())
                step = manager.current_step()
                if step >= self.total_steps:
                    break  # a sync heal landed on the peer's final state
                grads = [_full(self.pkg, (4, 3), 1.0 + step),
                         _full(self.pkg, (3,), 0.5 * (step + 1))]
                works = [manager.allreduce(g) for g in grads]
                reduced = [w.wait(timeout=30)[0] for w in works]
                with manager.fenced_state_dict():
                    if manager.should_commit():
                        for p, g in zip(params.values(), reduced):
                            p -= 0.1 * g
                        self.participants_log.append(manager.num_participants())
            return {k: _host(v) for k, v in params.items()}
        finally:
            manager.shutdown()


def run_replicas(runners: List[Runner], timeout: float = 120) -> List[Dict[str, np.ndarray]]:
    # No `with`: a wedged replica must fail the test, not hang the suite.
    pool = ThreadPoolExecutor(max_workers=len(runners))
    try:
        futures = [pool.submit(r.run) for r in runners]
        return [f.result(timeout=timeout) for f in futures]
    except Exception:
        for r in runners:
            for m in r.manager_ref:
                try:
                    m.shutdown()
                except Exception:  # noqa: BLE001
                    pass
        raise
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def make_lighthouse(min_replicas: int = 1, **kw):
    """The JAX file's lighthouse (a 1 s join window, 1 s heartbeat
    timeout), here with ``min_replicas`` replicas in every quorum: the
    JAX file's one replica lets the first quorums form with one replica or
    two as the threads happen to start, and the state a scenario ends in
    depends on it (a replica that heals at a step contributes zeros to
    that step's average), so a run could not be held to another's bits."""
    args = dict(min_replicas=min_replicas, join_timeout_ms=1000, quorum_tick_ms=50,
                heartbeat_timeout_ms=1000)
    args.update(kw)
    return tcoord.LighthouseServer(**args)


def assert_params_equal(results: Sequence[Dict[str, np.ndarray]]) -> None:
    ref = results[0]
    for other in results[1:]:
        for k in ref:
            np.testing.assert_array_equal(ref[k], other[k])


def assert_bits_equal(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k


# The worlds each state scenario runs: the port alone, and port replicas
# beside JAX ones (the last replica JAX: it crashes, fails or joins).
WORLDS = {"port": "torch", "mixed": "jax"}

_JAX_RUNS: Dict[tuple, List[Dict[str, np.ndarray]]] = {}


def jax_reference(key: tuple, scenario) -> List[Dict[str, np.ndarray]]:
    """The all-JAX world's results for ``key`` (run once, kept)."""
    if key not in _JAX_RUNS:
        results = scenario(("jax",) * key[0])
        assert_params_equal(results)
        _JAX_RUNS[key] = results
    return _JAX_RUNS[key]


def pkgs_for(world: str, n: int) -> tuple:
    return ("torch",) * (n - 1) + (WORLDS[world],)


def held_to_jax(key: tuple, scenario, world: str) -> List[Dict[str, np.ndarray]]:
    """Runs ``scenario`` in ``world``, holds its replicas to each other and
    to the all-JAX world's bits; returns the results."""
    results = scenario(pkgs_for(world, key[0]))
    assert_params_equal(results)
    assert_bits_equal(results[0], jax_reference(key, scenario)[0])
    return results


def _scenario(injector_fn, n: int, total_steps: int, use_async: bool = True):
    """A world of ``n`` Runners on a fresh lighthouse; returns
    ``scenario(pkgs) -> results`` that also checks the injector fired as
    ``injector_fn`` planned."""
    def scenario(pkgs):
        injector = injector_fn()
        planned = len(injector._events)
        lighthouse = make_lighthouse(n)
        try:
            runners = [Runner(r, lighthouse.address(), injector, pkg=pkgs[r],
                              use_async_quorum=use_async, total_steps=total_steps)
                       for r in range(n)]
            results = run_replicas(runners)
        finally:
            lighthouse.shutdown()
        assert injector.count == planned
        return results
    return scenario


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("use_async", [True, False])
def test_healthy_two_replicas(use_async, world) -> None:
    scenario = _scenario(EventInjector, 2, 6, use_async)
    results = held_to_jax((2, "healthy", use_async), scenario, world)
    assert not np.allclose(results[0]["w"], 0)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("use_async", [True, False])
def test_replica_crash_and_recovery(use_async, world) -> None:
    """Replica 1 crashes at step 2, restarts, heals from replica 0's live
    checkpoint; both end bitwise equal, and equal to the JAX world."""
    scenario = _scenario(lambda: EventInjector().fail_at(replica=1, step=2), 2, 6, use_async)
    held_to_jax((2, "crash", use_async), scenario, world)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_three_replicas_one_crash(world) -> None:
    scenario = _scenario(lambda: EventInjector().fail_at(replica=2, step=1), 3, 5)
    held_to_jax((3, "three_one_crash"), scenario, world)


# The upscale's join step: replicas 0 and 1 hold before this step's quorum
# until the joiner's Manager is up, so that quorum holds all three.
UPSCALE_JOIN_STEP = 2


def _upscale(pkgs) -> List[Dict[str, np.ndarray]]:
    """Replicas 0 and 1 run (two a quorum); replica 2 starts once replica 0
    is at ``UPSCALE_JOIN_STEP``, which 0 and 1 do not pass until the
    joiner's Manager is up; the joiner heals and the world trains three
    wide. (The JAX file paces 0 and 1 with sleeps instead, so the join's
    step, and with it the state, depends on timing.)"""
    injector = EventInjector()
    joiner_up = threading.Event()

    def hold_for_joiner(runner, manager, step):
        if step == UPSCALE_JOIN_STEP:
            assert joiner_up.wait(60), "the joiner never heartbeat"

    def joiner_started(runner, manager, step):
        # The lighthouse must know the joiner (its first heartbeat) before
        # 0 and 1 ask for the join step's quorum, or it forms without it.
        client = tcoord.LighthouseClient(lighthouse.address())
        try:
            deadline = time.monotonic() + 30
            while not any(k.startswith("replica2")
                          for k in client.status()["heartbeat_ages_ms"]):
                assert time.monotonic() < deadline, "the joiner never heartbeat"
                time.sleep(0.02)
        finally:
            client.close()
        joiner_up.set()

    lighthouse = make_lighthouse(2, join_timeout_ms=10000)
    runners = [
        Runner(r, lighthouse.address(), injector, pkg=pkgs[r], total_steps=6,
               pre_quorum_hook=hold_for_joiner if r in (0, 1) else joiner_started)
        for r in range(3)
    ]
    pool = ThreadPoolExecutor(max_workers=3)
    try:
        futs = [pool.submit(runners[r].run) for r in (0, 1)]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            mgrs = runners[0].manager_ref
            if mgrs and mgrs[-1].current_step() >= UPSCALE_JOIN_STEP:
                break
            time.sleep(0.05)
        else:
            pytest.fail("first two replicas made no progress")
        futs.append(pool.submit(runners[2].run))
        results = [f.result(timeout=120) for f in futs]
    finally:
        for r in runners:
            for m in r.manager_ref:
                try:
                    m.shutdown()
                except Exception:  # noqa: BLE001
                    pass
        pool.shutdown(wait=False, cancel_futures=True)
        lighthouse.shutdown()
    assert runners[0].participants_log[:UPSCALE_JOIN_STEP] == [2] * UPSCALE_JOIN_STEP
    assert 3 in runners[0].participants_log, runners[0].participants_log
    return results


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_upscale_while_running(world) -> None:
    """A third replica that joins mid-run is admitted by a later quorum,
    heals, and all three end bitwise equal (and equal to the JAX world)."""
    held_to_jax((3, "upscale"), _upscale, world)


def _reduce_op_sum(pkgs) -> List[tuple]:
    """Two replicas: a SUM and an AVG allreduce of 1.0 and 3.0 (the JAX
    file's one-replica lighthouse, and its loop until both are in)."""
    lighthouse = make_lighthouse()
    results = {}

    def run(replica: int):
        pkg = pkgs[replica]
        P = PACKAGES[pkg]
        manager = P.Manager(
            pg=P.Socket(timeout=30.0), min_replica_size=2, use_async_quorum=False,
            timeout=20.0, quorum_timeout=60.0, replica_id=f"rop{replica}",
            lighthouse_addr=lighthouse.address(), group_rank=0, group_world_size=1,
        )
        try:
            deadline = time.monotonic() + 30
            while True:
                manager.start_quorum()
                if manager.num_participants() >= 2:
                    break
                assert time.monotonic() < deadline, "peer never joined"
            val = float(replica * 2 + 1)
            s = manager.allreduce(_full(pkg, (8,), val), reduce_op=P.ReduceOp.SUM
                                  ).wait(timeout=30)[0]
            a = manager.allreduce(_full(pkg, (8,), val)).wait(timeout=30)[0]
            assert manager.should_commit()
            results[replica] = {"sum": _host(s), "avg": _host(a)}
        finally:
            manager.shutdown()

    pool = ThreadPoolExecutor(max_workers=2)
    try:
        futs = [pool.submit(run, r) for r in range(2)]
        for f in futs:
            f.result(timeout=150)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        lighthouse.shutdown()
    return [results[0], results[1]]


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_allreduce_reduce_op_sum(world) -> None:
    """SUM returns the raw sum over the replicas, the AVG default divides
    by the live participants: (4.0, 2.0) on both, the JAX world's bits."""
    results = held_to_jax((2, "reduce_op_sum"), _reduce_op_sum, world)
    for r in results:
        assert (float(r["sum"][0]), float(r["avg"][0])) == (4.0, 2.0), results


def test_quorum_rpc_round_trip_under_one_second() -> None:
    """The steady quorum round trip of the port's Manager: after the first
    (the join window), the fastest of three under 1 s, every one under
    10 s, as the JAX file holds its Manager."""
    lighthouse = make_lighthouse()
    params = {"w": torch.zeros(2)}
    state_dict, load_state = _state_fns("torch", params)
    manager = tmanager.Manager(
        pg=tpg.ProcessGroupSocket(timeout=5.0), state_dict=state_dict,
        load_state_dict=load_state, min_replica_size=1, use_async_quorum=False,
        timeout=10.0, quorum_timeout=20.0, replica_id="latency0",
        lighthouse_addr=lighthouse.address(), group_rank=0, group_world_size=1,
    )
    try:
        durations = []
        for _ in range(4):
            t0 = time.monotonic()
            manager.start_quorum()
            durations.append(time.monotonic() - t0)
            assert manager.errored() is None
            assert manager.should_commit()
        assert durations[0] < 10.0, durations
        assert min(durations[1:]) < 1.0, durations
        assert all(dt < 10.0 for dt in durations), durations
    finally:
        manager.shutdown()
        lighthouse.shutdown()
