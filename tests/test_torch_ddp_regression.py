"""The port's DistributedDataParallel on the int4 + error-feedback wire
against the golden fixture ``ddp_int4ef.json``, bit for bit (the twin of
tests/test_ddp_regression.py:136-140).

Two replica-group threads with real Managers (C++ manager-server
subprocesses), a real in-proc C++ lighthouse and socket process groups push
deterministic per-replica gradients (CPU tensors on the port's side)
through ``DistributedDataParallel.allreduce_grads`` every step; the per-step
parameter history must equal the fixture. The int4 wire is lossy but
deterministic, so the comparison is exact.

``_run_pair(packages=...)`` takes each replica's package (``"torch"`` or
``"jax"``); tests/test_torch_mixed_quorum.py runs one of each.
"""

import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence

import numpy as np
import pytest
import torch

FIXTURE_DIR = Path(__file__).parent / "fixtures"

STEPS = 6
N = 16  # param/grad width


def _grad(replica: int, step: int) -> np.ndarray:
    """Deterministic, replica-distinct, non-representable values (forces
    real quantization error so error feedback has work to do)."""
    base = np.sin(np.arange(N, dtype=np.float32) * 0.7 + step)
    return ((replica + 1) * 0.1 * base).astype(np.float32)


def _run_replica(
    package: str,
    replica: int,
    lighthouse_addr: str,
    barrier: threading.Barrier,
    quantize_bits: int,
    error_feedback: bool,
) -> List[List[float]]:
    if package == "jax":
        from torchft_tpu.ddp import DistributedDataParallel
        from torchft_tpu.manager import Manager
        from torchft_tpu.process_group import ProcessGroupSocket

        hold = lambda a: a  # noqa: E731
    else:
        from torchft_tpu_torch.ddp import DistributedDataParallel
        from torchft_tpu_torch.manager import Manager
        from torchft_tpu_torch.process_group import ProcessGroupSocket

        hold = torch.from_numpy
    params = hold(np.linspace(-2.0, 2.0, N, dtype=np.float32))
    manager = Manager(
        pg=ProcessGroupSocket(timeout=15.0),
        min_replica_size=2,
        use_async_quorum=False,
        timeout=15.0,
        quorum_timeout=30.0,
        replica_id=f"ddpregr{replica}",
        lighthouse_addr=lighthouse_addr,
        group_rank=0,
        group_world_size=1,
        init_sync=False,
    )
    ddp = DistributedDataParallel(
        manager, error_feedback=error_feedback, quantize_bits=quantize_bits
    )
    history: List[List[float]] = []
    try:
        for step in range(STEPS):
            barrier.wait(timeout=60)
            manager.start_quorum()
            out = ddp.allreduce_grads(
                {"w": hold(_grad(replica, step))}, should_quantize=True
            )
            if manager.should_commit():
                params = params - out["w"]
            history.append([float(v) for v in np.asarray(params)])
        if error_feedback:
            assert ddp._residuals, "EF run must record bucket residuals"
    finally:
        manager.shutdown()
    return history


def _run_pair(
    quantize_bits: int,
    error_feedback: bool,
    packages: Sequence[str] = ("torch", "torch"),
) -> List[List[List[float]]]:
    from torchft_tpu_torch.coordination import LighthouseServer

    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=2,
        join_timeout_ms=20000,
        quorum_tick_ms=50,
    )
    barrier = threading.Barrier(2)
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [
                pool.submit(
                    _run_replica, packages[r], r, lighthouse.address(),
                    barrier, quantize_bits, error_feedback,
                )
                for r in range(2)
            ]
            return [f.result(timeout=180) for f in futs]
    finally:
        lighthouse.shutdown()


def _golden() -> List[List[float]]:
    with open(FIXTURE_DIR / "ddp_int4ef.json") as f:
        return json.load(f)


@pytest.mark.timeout(240)
def test_ddp_golden_int4_error_feedback() -> None:
    h0, h1 = _run_pair(quantize_bits=4, error_feedback=True)
    assert h0 == h1, "replicas decoded different averaged gradients"
    assert h0 == _golden(), "parameter history differs from the golden ddp_int4ef"


@pytest.mark.timeout(240)
def test_ddp_int4_error_feedback_changes_the_stream() -> None:
    """Without feedback the int4 history leaves the golden: the residual
    hook fires on the port's DDP path (a dropped hook would make the
    golden vacuous)."""
    h_plain, _ = _run_pair(quantize_bits=4, error_feedback=False)
    assert h_plain != _golden()
