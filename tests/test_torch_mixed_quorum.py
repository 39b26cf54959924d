"""A mixed quorum: one JAX replica (``torchft_tpu``) and one port replica
(``torchft_tpu_torch``), in threads, sharing one C++ lighthouse; each uses
its own package's Manager and ``ProcessGroupSocket``, so the two packages
meet on one control plane and one process-group wire.

- The DiLoCo goldens (fp32, int8, int4 + error feedback, failure recovery):
  both replicas reproduce the fixture bit for bit, with each package as
  replica 0 in turn.
- The DDP golden ``ddp_int4ef`` the same way.
- ``manager.allreduce`` in fp32, int8 and int4: the port on its device
  path (``TORCHFT_FORCE_DEVICE_QUANT=1``, CPU tensors through the kernels'
  plain versions), JAX on its host quantizer; both commit every step and
  get equal results.

The harnesses are those of the port-only golden tests.
"""

import functools
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_ddp_regression import _golden as _ddp_golden
from test_torch_ddp_regression import _run_pair
from test_torch_diloco_regression import (
    _check_golden,
    _initial_params,
    _run_case,
    _snapshot,
)

ASSIGNMENTS = [("jax", "torch"), ("torch", "jax")]
CASES = {
    "diloco_f2_d1_a0.5": dict(n_fragments=2, delay=1, alpha=0.5),
    "diloco_f2_d1_a0.5_int8": dict(n_fragments=2, delay=1, alpha=0.5, quantize=True),
    "diloco_f2_d1_a0.5_int4ef": dict(
        n_fragments=2, delay=1, alpha=0.5, quantize=True, quantize_bits=4,
        error_feedback=True,
    ),
    "diloco_failure_recovery": dict(
        n_fragments=1, delay=0, alpha=0.0, fail_before_step=3, pg_timeout=3.0
    ),
}


@pytest.mark.parametrize("packages", ASSIGNMENTS, ids=lambda p: "-".join(p))
@pytest.mark.parametrize("name", list(CASES))
def test_mixed_diloco_golden(name, packages) -> None:
    history = _run_case(**CASES[name], packages=packages)
    if name == "diloco_failure_recovery":
        assert history[3] == _snapshot(_initial_params())
    _check_golden(name, history)


@pytest.mark.timeout(240)
@pytest.mark.parametrize("packages", ASSIGNMENTS, ids=lambda p: "-".join(p))
def test_mixed_ddp_golden_int4_error_feedback(packages) -> None:
    h0, h1 = _run_pair(quantize_bits=4, error_feedback=True, packages=packages)
    assert h0 == h1 == _ddp_golden()


ALLREDUCE_STEPS = 3
ALLREDUCE_N = 3000  # six quantizer blocks: the alltoall path, not the tiny one


def _values(replica: int, step: int) -> np.ndarray:
    rng = np.random.default_rng(100 * replica + step)
    return rng.standard_normal(ALLREDUCE_N).astype(np.float32)


def _allreduce_replica(package, replica, addr, barrier, quantize, bits):
    if package == "jax":
        from torchft_tpu.manager import Manager
        from torchft_tpu.process_group import ProcessGroupSocket

        hold, host = (lambda a: a), np.asarray
    else:
        from torchft_tpu_torch.manager import Manager
        from torchft_tpu_torch.process_group import ProcessGroupSocket

        hold, host = torch.from_numpy, (lambda t: t.numpy())
    manager = Manager(
        pg=ProcessGroupSocket(timeout=15.0),
        min_replica_size=2,
        use_async_quorum=False,
        timeout=15.0,
        quorum_timeout=30.0,
        replica_id=f"mixed{replica}",
        lighthouse_addr=addr,
        group_rank=0,
        group_world_size=1,
        init_sync=False,
    )
    out = []
    try:
        for step in range(ALLREDUCE_STEPS):
            barrier.wait(timeout=60)
            manager.start_quorum()
            work = manager.allreduce(
                hold(_values(replica, step)),
                should_quantize=quantize,
                quantize_bits=bits,
            )
            (reduced,) = work.wait()
            assert manager.should_commit(), f"{package} step {step} not committed"
            out.append(np.array(host(reduced), np.float32))
        assert manager.current_step() == ALLREDUCE_STEPS
    finally:
        manager.shutdown()
    return out


@pytest.mark.parametrize(
    "quantize, bits", [(False, 8), (True, 8), (True, 4)],
    ids=["fp32", "int8", "int4"],
)
def test_mixed_manager_allreduce_equal_on_both_sides(monkeypatch, quantize, bits):
    from torchft_tpu_torch import collectives as tcoll
    from torchft_tpu_torch.coordination import LighthouseServer

    monkeypatch.setenv("TORCHFT_FORCE_DEVICE_QUANT", "1")
    device_calls = []
    real = tcoll.allreduce_quantized_torch

    def spy(*args, **kwargs):
        device_calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tcoll, "allreduce_quantized_torch", spy)
    lighthouse = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=10000,
        quorum_tick_ms=20,
    )
    barrier = threading.Barrier(2)
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [
                pool.submit(
                    _allreduce_replica, package, r, lighthouse.address(),
                    barrier, quantize, bits,
                )
                for r, package in enumerate(("jax", "torch"))
            ]
            jax_out, torch_out = [f.result(timeout=120) for f in futs]
    finally:
        lighthouse.shutdown()
    # The port's quantized allreduces took its device path.
    assert len(device_calls) == (ALLREDUCE_STEPS if quantize else 0)
    for step in range(ALLREDUCE_STEPS):
        np.testing.assert_array_equal(torch_out[step], jax_out[step])
        exact = (_values(0, step) + _values(1, step)) / np.float32(2)
        if quantize:
            assert not np.array_equal(jax_out[step], exact)
            np.testing.assert_allclose(jax_out[step], exact, atol=0.5 if bits == 4 else 0.05)
        else:
            np.testing.assert_array_equal(jax_out[step], exact)


# Keys deliberately out of sorted order and of equal sizes: JAX flattens a
# dict in sorted key order, so a port that laid its leaves out in insertion
# order would average one package's ``wq`` with the other's ``emb`` and no
# length check would catch it.
LEAF_KEYS = ("wq", "emb", "b")
LEAF_N = 1536  # three quantizer blocks per leaf


def _leaf_values(replica: int, step: int) -> dict:
    rng = np.random.default_rng(1000 * replica + step)
    return {k: rng.standard_normal(LEAF_N).astype(np.float32) for k in LEAF_KEYS}


def _leaf_replica(package, replica, addr, barrier, kind, quantize):
    """One replica of the leaf-order cases: ``kind`` "ddp" averages a
    gradient dict through ``DistributedDataParallel.allreduce_grads``,
    "pure" through ``PureDistributedDataParallel.allreduce_grads``,
    "localsgd" a parameter dict through one ``LocalSGD`` sync. Returns the
    averaged dict of each step as numpy, by key."""
    if package == "jax":
        from torchft_tpu import ddp
        from torchft_tpu.local_sgd import LocalSGD
        from torchft_tpu.manager import Manager
        from torchft_tpu.process_group import ProcessGroupSocket

        hold, host = (lambda a: a), np.asarray
    else:
        from torchft_tpu_torch import ddp
        from torchft_tpu_torch.local_sgd import LocalSGD
        from torchft_tpu_torch.manager import Manager
        from torchft_tpu_torch.process_group import ProcessGroupSocket

        hold, host = torch.from_numpy, (lambda t: t.numpy())
    manager = Manager(
        pg=ProcessGroupSocket(timeout=15.0),
        min_replica_size=2,
        use_async_quorum=False,
        timeout=15.0,
        quorum_timeout=30.0,
        replica_id=f"leaves{replica}",
        lighthouse_addr=addr,
        group_rank=0,
        group_world_size=1,
        init_sync=False,
    )
    out = []
    try:
        if kind in ("ddp", "pure"):
            if kind == "ddp":
                average = functools.partial(
                    ddp.DistributedDataParallel(manager).allreduce_grads,
                    should_quantize=quantize,
                )
            else:
                average = ddp.PureDistributedDataParallel(manager).allreduce_grads
            for step in range(ALLREDUCE_STEPS):
                barrier.wait(timeout=60)
                manager.start_quorum()
                grads = {k: hold(v) for k, v in _leaf_values(replica, step).items()}
                reduced = average(grads)
                assert list(reduced) == list(grads) or package == "jax"
                assert manager.should_commit(), f"{package} step {step}"
                out.append({k: np.array(host(reduced[k])) for k in LEAF_KEYS})
        else:
            params = [{k: hold(v) for k, v in _leaf_values(replica, 0).items()}]
            local_sgd = LocalSGD(
                manager, lambda: params[0], lambda p: params.__setitem__(0, p),
                sync_every=1, should_quantize=quantize,
            )
            barrier.wait(timeout=60)
            assert local_sgd.step(), f"{package} LocalSGD sync not committed"
            assert package == "jax" or list(params[0]) == list(LEAF_KEYS)
            out.append({k: np.array(host(params[0][k])) for k in LEAF_KEYS})
    finally:
        manager.shutdown()
    return out


def run_leaf_pair(kind: str, quantize: bool) -> None:
    """Replica 0 on the JAX package, replica 1 on the port, through
    :func:`_leaf_replica`; raises unless every key's average is the two
    replicas' values of that key (exact in fp32; within the int8 wire's
    error, equal on both sides) on both."""
    from torchft_tpu_torch.coordination import LighthouseServer

    lighthouse = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=10000,
        quorum_tick_ms=20,
    )
    barrier = threading.Barrier(2)
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [
                pool.submit(
                    _leaf_replica, package, r, lighthouse.address(), barrier,
                    kind, quantize,
                )
                for r, package in enumerate(("jax", "torch"))
            ]
            jax_out, torch_out = [f.result(timeout=120) for f in futs]
    finally:
        lighthouse.shutdown()
    assert len(jax_out) == len(torch_out) > 0
    for step, (j, t) in enumerate(zip(jax_out, torch_out)):
        a, b = _leaf_values(0, step), _leaf_values(1, step)
        for k in LEAF_KEYS:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
            exact = (a[k] + b[k]) / np.float32(2)
            if quantize:
                np.testing.assert_allclose(t[k], exact, atol=0.05, err_msg=k)
            else:
                np.testing.assert_array_equal(t[k], exact, err_msg=k)


@pytest.mark.parametrize(
    "kind, quantize",
    [("ddp", False), ("ddp", True), ("localsgd", False), ("localsgd", True)],
    ids=["ddp-fp32", "ddp-int8", "localsgd-fp32", "localsgd-int8"],
)
def test_mixed_multi_leaf_dict_averages_leaf_with_leaf(monkeypatch, kind, quantize):
    """A multi-leaf dict whose keys are not in sorted order, one JAX and
    one port replica (the port's quantized path on its device path): every
    key is averaged with the same key of the other package, and the port
    returns the caller's keys in the caller's order."""
    monkeypatch.setenv("TORCHFT_FORCE_DEVICE_QUANT", "1")
    run_leaf_pair(kind, quantize)
