"""The port's Manager and DDP on CPU tensors: two replica groups (threads,
each with its own Manager and C++ manager server) against the port's
LighthouseServer — quorum, allreduce (AVG over live participants),
should_commit."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu_torch.coordination import LighthouseServer
from torchft_tpu_torch.ddp import DistributedDataParallel
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.process_group import ProcessGroupSocket
from torchft_tpu_torch.work import DummyWork


@pytest.fixture
def lighthouse():
    server = LighthouseServer(
        min_replicas=2,
        join_timeout_ms=1000,
        quorum_tick_ms=50,
        heartbeat_timeout_ms=1000,
    )
    yield server
    server.shutdown()


def _replica(rank: int, addr: str, steps: int, stale_pg_error=None):
    params = {"w": torch.zeros(4, 3), "b": torch.zeros(5, dtype=torch.bfloat16)}

    def load(state):
        for k, v in state.items():
            params[k].copy_(torch.from_numpy(v))

    manager = Manager(
        pg=ProcessGroupSocket(timeout=10.0),
        state_dict=lambda: {k: v.float().numpy().copy() for k, v in params.items()},
        load_state_dict=load,
        min_replica_size=2,
        use_async_quorum=True,
        timeout=20.0,
        quorum_timeout=20.0,
        connect_timeout=10.0,
        replica_id=f"replica{rank}",
        lighthouse_addr=addr,
        group_rank=0,
        group_world_size=1,
        max_retries=4,
    )
    ddp = DistributedDataParallel(manager)
    if stale_pg_error is not None:
        # What a peer's death leaves on the pg until the next quorum
        # reconfigures it.
        manager._pg._errored = stale_pg_error
    seen = []
    attempts = 0
    try:
        while manager.current_step() < steps:
            attempts += 1
            manager.start_quorum()
            step = manager.current_step()
            # Replica r contributes (r + 1) * (step + 1).
            w = torch.full((4, 3), (rank + 1.0) * (step + 1))
            (reduced,) = manager.allreduce(w).wait(timeout=30)
            grads = ddp.allreduce_grads(
                {"w": w, "b": torch.full((5,), rank + 1.0, dtype=torch.bfloat16)}
            )
            with manager.fenced_state_dict():
                if manager.should_commit():
                    seen.append(
                        (type(reduced), reduced.dtype, float(reduced[0, 0]),
                         grads["b"].dtype, float(grads["b"][0]),
                         manager.num_participants())
                    )
                    params["w"] += grads["w"]
                    params["b"] += grads["b"]
        return {k: v.clone() for k, v in params.items()}, seen, attempts
    finally:
        manager.shutdown()


def _two_replicas(addr: str, steps: int, stale_pg_error=None):
    pool = ThreadPoolExecutor(max_workers=2)
    try:
        futs = [
            pool.submit(_replica, r, addr, steps, stale_pg_error)
            for r in range(2)
        ]
        return [f.result(timeout=120) for f in futs]
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


# Covers a first-use build of the C++ binaries (~1 min) in a fresh checkout.
@pytest.mark.timeout(300)
def test_two_replicas_quorum_allreduce_commit(lighthouse):
    steps = 3
    (p0, seen0, _), (p1, seen1, _) = _two_replicas(lighthouse.address(), steps)
    for k in p0:
        torch.testing.assert_close(p0[k], p1[k], rtol=0, atol=0)
    assert len(seen0) == steps
    assert seen0 == seen1
    # Step 0's quorum heals replica 1 from replica 0 (both start at step
    # 0): the healing replica sends zeros, so the average over the two
    # participants is (1 + 0) / 2. From step 1 both contribute.
    expect = [(0.5, 0.5), (3.0, 1.5), (4.5, 1.5)]
    for (typ, dtype, val, b_dtype, b_val, n), (w, b) in zip(seen0, expect):
        assert typ is torch.Tensor and dtype == torch.float32
        assert b_dtype == torch.bfloat16
        assert (val, b_val, n) == (pytest.approx(w), pytest.approx(b), 2)
    assert float(p0["w"][0, 0]) == pytest.approx(0.5 + 3.0 + 4.5)


@pytest.mark.timeout(300)
def test_stale_pg_error_does_not_skip_heal_sources_collective(lighthouse):
    """Both groups start with the error a failed previous quorum leaves on
    the pg. allreduce waits for this step's quorum, whose reconfigure clears
    it, before it checks errored(): the heal source (replica 0 at step 0)
    runs the collective that holds it until replica 1 has fetched its
    checkpoint, and step 0 commits on the first attempt. Checked before the
    quorum, the stale error made the source skip the collective and vote
    against the commit."""
    stale = ConnectionResetError("peer closed the ring in the last quorum")
    (p0, seen0, tries0), (p1, seen1, tries1) = _two_replicas(
        lighthouse.address(), 1, stale
    )
    assert (tries0, tries1) == (1, 1)
    assert seen0 == seen1
    ((_, _, val, _, b_val, n),) = seen0
    assert (val, b_val, n) == (pytest.approx(0.5), pytest.approx(0.5), 2)
    for k in p0:
        torch.testing.assert_close(p0[k], p1[k], rtol=0, atol=0)


class _RecordingManager:
    """Stands in for a Manager: records each allreduce payload and returns
    it doubled."""

    _timeout = 5.0

    def __init__(self):
        self.payloads = []

    def allreduce(self, t, should_quantize=False, quantize_bits=8,
                  on_local_quantized=None):
        self.payloads.append(t.clone())
        return DummyWork([t * 2])


def test_ddp_buckets_flat_per_dtype():
    """One flat payload per bucket (bucketize's layout), values back in
    place, names and shapes preserved."""
    rec = _RecordingManager()
    ddp = DistributedDataParallel(rec, bucket_cap_mb=1e-3)  # ~1 KB buckets
    grads = {
        "a": torch.arange(200, dtype=torch.float32).view(20, 10),
        "n": torch.arange(3, dtype=torch.int32),
        "b": torch.ones(100),
        "c": torch.full((3, 4), 7.0),
    }
    out = ddp.allreduce_grads(grads)
    assert list(out) == list(grads)
    for k, g in grads.items():
        assert out[k].shape == g.shape and out[k].dtype == g.dtype
        torch.testing.assert_close(out[k], g * 2)
    from torchft_tpu_torch.collectives import bucketize

    layout = bucketize(list(grads.values()), int(1e-3 * 1024 * 1024))
    assert [p.numel() for p in rec.payloads] == [
        sum(list(grads.values())[i].numel() for i in idx) for idx in layout
    ]
    assert all(p.dim() == 1 for p in rec.payloads)


def test_numpy_inputs_keep_host_quantize_path():
    """Numpy inputs with should_quantize keep the host quantizer: a
    single-replica quantized allreduce returns numpy."""
    from torchft_tpu_torch.collectives import allreduce_quantized
    from torchft_tpu_torch.process_group import ProcessGroupDummy

    x = np.linspace(-1, 1, 1024, dtype=np.float32)
    (out,) = allreduce_quantized(ProcessGroupDummy(), [x.copy()]).wait()
    assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(out, x, atol=1e-2)


class _GateManager:
    """Stands in for a Manager's commit gate and state-dict registry."""

    def __init__(self, commit: bool):
        import contextlib

        self.commit = commit
        self.quorums = 0
        self.registered = {}
        self.fenced_state_dict = contextlib.nullcontext

    def start_quorum(self):
        self.quorums += 1

    def should_commit(self):
        return self.commit

    def register_state_dict_fn(self, key, save, load):
        self.registered[key] = (save, load)


def _adamw_model(seed):
    from torchft_tpu_torch.parallel.train import default_optimizer

    torch.manual_seed(seed)
    model = torch.nn.Linear(4, 3)
    return model, default_optimizer(model.parameters())


def test_optimizer_wrapper_gates_and_heals():
    from torchft_tpu_torch.optim import OptimizerWrapper

    model, opt = _adamw_model(0)
    before = [p.detach().clone() for p in model.parameters()]
    gate = _GateManager(commit=False)
    wrapped = OptimizerWrapper(gate, opt)
    wrapped.zero_grad()
    model(torch.ones(2, 4)).sum().backward()
    assert wrapped.step() is False and gate.quorums == 1
    for a, b in zip(before, model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    gate.commit = True
    assert wrapped.step() is True
    assert not torch.equal(before[0], model.weight)

    # Heal: a fresh replica (other initial weights, no optimizer state)
    # takes the registered state dict and then steps identically.
    save, _ = gate.registered["optimizer"]
    model2, opt2 = _adamw_model(1)
    peer = OptimizerWrapper(_GateManager(commit=True), opt2)
    peer.load_state_dict(save())
    for m in (model, model2):
        m.zero_grad()
        m(torch.ones(2, 4)).sum().backward()
    wrapped.step()
    peer.step()
    for a, b in zip(model.parameters(), model2.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
