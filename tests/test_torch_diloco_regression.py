"""The port's DiLoCo against the golden fixtures, bit for bit (the twin of
tests/test_diloco_regression.py).

Two replica-group threads, each with its own Manager (C++ manager-server
subprocess), one real in-proc C++ lighthouse, and socket process groups
under ``FakeProcessGroupWrapper``, run deterministic inner updates; the full
per-inner-step parameter history must equal the committed JSON fixture. All
values are multiples of 2^-6 in float32, replicas run identical updates and
averaging two identical replicas is exact, so the comparison is exact.

``_run_case(..., packages=...)`` takes the package of each replica:
``"torch"`` runs the port (CPU tensors, ``torchft_tpu_torch``), ``"jax"``
the JAX package (numpy params, ``torchft_tpu``). This file runs two port
replicas; tests/test_torch_mixed_quorum.py runs one of each. The fixtures
are only read here.
"""

import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import pytest
import torch

FIXTURE_DIR = Path(__file__).parent / "fixtures"

INNER_STEPS = 8
DRIFT = 0.25  # inner update: p -= DRIFT each step (exact in fp32)
OUTER_LR = 0.5


def _initial_params() -> Dict[str, np.ndarray]:
    return {
        "w1": np.asarray([1.0, 2.0, 3.0, 4.0], np.float32),
        "w2": np.asarray([-1.0, 0.5], np.float32),
    }


def _snapshot(params) -> Dict[str, List[float]]:
    return {k: [float(x) for x in np.asarray(v)] for k, v in params.items()}


def _drift(p: np.ndarray, quantize: bool) -> np.ndarray:
    """The fixture's inner update. Quantized cases drift per element:
    constant pseudograds would quantize EXACTLY, making the int8 golden
    indistinguishable from fp32."""
    if quantize:
        ramp = np.float32(1.0) + np.arange(p.size, dtype=np.float32) / np.float32(4.0)
        return p - np.float32(DRIFT) * ramp
    return p - np.float32(DRIFT)


def _package(name: str) -> dict:
    """The classes of one package, and how its params are held."""
    if name == "jax":
        import optax

        from torchft_tpu.local_sgd import DiLoCo
        from torchft_tpu.manager import Manager
        from torchft_tpu.process_group import (
            FakeProcessGroupWrapper,
            ProcessGroupSocket,
        )

        return dict(
            DiLoCo=DiLoCo, Manager=Manager, Fake=FakeProcessGroupWrapper,
            PG=ProcessGroupSocket, outer=optax.sgd(OUTER_LR),
            hold=lambda a: np.asarray(a, np.float32),
            step=lambda t, quantize: _drift(t, quantize),
        )
    from torchft_tpu_torch.local_sgd import SGD, DiLoCo
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.process_group import (
        FakeProcessGroupWrapper,
        ProcessGroupSocket,
    )

    def step(t: torch.Tensor, quantize: bool) -> torch.Tensor:
        if quantize:
            ramp = 1.0 + torch.arange(t.numel(), dtype=torch.float32) / 4.0
            return t - DRIFT * ramp
        return t - DRIFT

    return dict(
        DiLoCo=DiLoCo, Manager=Manager, Fake=FakeProcessGroupWrapper,
        PG=ProcessGroupSocket, outer=SGD(OUTER_LR),
        hold=lambda a: torch.tensor(np.asarray(a, np.float32)),
        step=step,
    )


def _run_replica(
    package: str,
    replica: int,
    lighthouse_addr: str,
    n_fragments: int,
    delay: int,
    alpha: float,
    fail_before_step: Optional[int],
    barrier: threading.Barrier,
    pg_timeout: float,
    quantize: bool = False,
    quantize_bits: int = 8,
    error_feedback: bool = False,
) -> List[Dict[str, List[float]]]:
    pk = _package(package)
    params = {k: pk["hold"](v) for k, v in _initial_params().items()}

    def get_keys(keys):
        return lambda: {k: params[k] for k in keys}

    def set_keys(keys):
        def setter(p):
            for k in keys:
                params[k] = pk["hold"](p[k])

        return setter

    pg = pk["Fake"](pk["PG"](timeout=pg_timeout))
    manager = pk["Manager"](
        pg=pg,
        min_replica_size=2,
        use_async_quorum=False,
        timeout=15.0,
        quorum_timeout=30.0,
        replica_id=f"regr{replica}",
        lighthouse_addr=lighthouse_addr,
        group_rank=0,
        group_world_size=1,
        max_retries=5,
        # Replicas start from identical params: skip the step-0 force
        # recovery so no replica's local drift is overwritten by a heal.
        init_sync=False,
    )
    key_groups = [["w1", "w2"]] if n_fragments == 1 else [["w1"], ["w2"]]
    diloco = pk["DiLoCo"](
        manager,
        [(ks, get_keys(ks), set_keys(ks)) for ks in key_groups],
        sync_every=4,
        outer_optimizer=pk["outer"],
        fragment_sync_delay=delay,
        fragment_update_alpha=alpha,
        should_quantize=quantize,
        quantize_bits=quantize_bits,
        error_feedback=error_feedback,
    )
    history: List[Dict[str, List[float]]] = []
    try:
        for inner in range(INNER_STEPS):
            # Lockstep: keeps the replicas' quorums aligned per step so the
            # commit pattern (and thus the history) is deterministic.
            barrier.wait(timeout=60)
            if fail_before_step is not None and inner == fail_before_step:
                if replica == 1:
                    # The NEXT collective (this round's pseudograd
                    # allreduce) fails on this replica; the peer's ring
                    # times out; both commits fail and roll back.
                    pg.report_future_error(
                        RuntimeError("injected regression failure")
                    )
            for k in params:
                params[k] = pk["step"](params[k], quantize)
            diloco.step()
            history.append(_snapshot(params))
        return history
    finally:
        manager.shutdown()


def _run_case(
    n_fragments: int,
    delay: int,
    alpha: float,
    fail_before_step: Optional[int] = None,
    pg_timeout: float = 10.0,
    quantize: bool = False,
    quantize_bits: int = 8,
    error_feedback: bool = False,
    packages: Sequence[str] = ("torch", "torch"),
) -> List[Dict[str, List[float]]]:
    """Runs replicas 0 and 1 (of ``packages[0]`` and ``packages[1]``)
    against one lighthouse; asserts their histories are equal and returns
    one."""
    from torchft_tpu_torch.coordination import LighthouseServer

    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=2,
        join_timeout_ms=10000,
        quorum_tick_ms=20,
    )
    barrier = threading.Barrier(2)
    try:
        pool = ThreadPoolExecutor(max_workers=2)
        try:
            futs = [
                pool.submit(
                    _run_replica, packages[r], r, lighthouse.address(),
                    n_fragments, delay, alpha, fail_before_step, barrier,
                    pg_timeout, quantize, quantize_bits, error_feedback,
                )
                for r in (0, 1)
            ]
            histories = [f.result(timeout=120) for f in futs]
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
    finally:
        lighthouse.shutdown()
    assert histories[0] == histories[1], f"replica histories diverged ({packages})"
    return histories[0]


def _golden(name: str) -> List[Dict[str, List[float]]]:
    with open(FIXTURE_DIR / f"{name}.json") as f:
        return json.load(f)


def _check_golden(name: str, history: List[Dict[str, List[float]]]) -> None:
    assert history == _golden(name), (
        f"parameter history differs from the golden {name}"
    )


@pytest.mark.parametrize("n_fragments", [1, 2])
@pytest.mark.parametrize("delay", [0, 1])
@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_diloco_golden(n_fragments: int, delay: int, alpha: float) -> None:
    history = _run_case(n_fragments, delay, alpha)
    # Sanity: syncs happened (drift alone ends at initial - 8 * DRIFT).
    drift_only = {
        k: [float(np.float32(x) - np.float32(INNER_STEPS * DRIFT)) for x in v]
        for k, v in _snapshot(_initial_params()).items()
    }
    assert history[-1] != drift_only, "no outer sync ever applied"
    _check_golden(f"diloco_f{n_fragments}_d{delay}_a{alpha}", history)


def test_diloco_golden_quantized() -> None:
    """The int8 outer allreduce (host quantizer: blockwise quantize -> fp32
    reduce -> requantize) is deterministic, so its history is pinned bit
    for bit; it must differ from the exact one."""
    history = _run_case(2, 1, 0.5, quantize=True)
    exact = _run_case(2, 1, 0.5, quantize=False)
    assert history != exact, "quantized path produced exact-fp32 history"
    _check_golden("diloco_f2_d1_a0.5_int8", history)


def test_diloco_golden_int4_error_feedback() -> None:
    """The 4-bit wire + error feedback: nibble packing, the /7 scale grid
    and the residual carry, bit for bit; it must differ from int8."""
    history = _run_case(
        2, 1, 0.5, quantize=True, quantize_bits=4, error_feedback=True
    )
    assert history != _golden("diloco_f2_d1_a0.5_int8"), (
        "int4+EF path produced the int8 history"
    )
    _check_golden("diloco_f2_d1_a0.5_int4ef", history)


def test_diloco_golden_failure_recovery() -> None:
    """One injected collective error fails the first sync's commit on both
    replicas (rollback to the global backup), after which training
    recovers; the whole history, the rollback step included, is pinned."""
    history = _run_case(1, 0, 0.0, fail_before_step=3, pg_timeout=3.0)
    assert history[3] == _snapshot(_initial_params()), (
        "failed sync did not roll back to backup"
    )
    _check_golden("diloco_failure_recovery", history)
