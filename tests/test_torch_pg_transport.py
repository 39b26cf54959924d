"""The port's checkpoint wire beside the JAX package's: the bfloat16 repair
of ``_serialization``, the shard-aware split of ``checkpointing/sharded.py``
and ``PGTransport`` (plain and sharded) over the port's socket process
group (the twins of tests/test_checkpointing.py:130-358), and the commit
fence that makes the lazy sharded send safe."""

import time
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.checkpointing import _serialization as jser
from torchft_tpu.checkpointing import sharded as jsharded
from torchft_tpu_torch.checkpointing import _serialization as tser
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.pg_transport import PGTransport
from torchft_tpu_torch.checkpointing.sharded import (
    _ShardedRef,
    build_sharded_leaf,
    join_state_sharded,
    split_state_sharded,
)
from torchft_tpu_torch.process_group import ProcessGroupSocket
from torchft_tpu_torch.store import TCPStoreServer


def _values(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _bf16_pair(seed, shape):
    """The same bfloat16 values as a torch tensor and a JAX array."""
    x = torch.from_numpy(_values(seed, shape)).bfloat16()
    return x, jnp.asarray(x.float().numpy(), jnp.bfloat16)


# -- _serialization: bfloat16 ----------------------------------------------


def test_bf16_dumps_loads_same_bits_and_jax_bytes():
    """A bf16 CPU tensor round-trips through dumps/loads in the same bits
    (it raised TypeError before: numpy has no bfloat16), under the meta
    dtype "bfloat16", with the very bytes the JAX package's split_state
    writes for the same values."""
    x, xj = _bf16_pair(0, (3, 5))
    meta, bufs = tser.split_state({"w": x})
    jmeta, jbufs = jser.split_state({"w": xj})
    assert meta["w"].dtype == jmeta["w"].dtype == "bfloat16"
    assert meta["w"].shape == jmeta["w"].shape == (3, 5)
    assert bufs[0].tobytes() == jbufs[0].tobytes()
    got = tser.loads(tser.dumps({"w": x, "step": 3}))
    assert got["w"].dtype == torch.bfloat16 and got["step"] == 3
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))


def test_bf16_through_http_transport_same_bits():
    x, _ = _bf16_pair(1, (64, 7))
    state = {"w": x, "f": torch.arange(6.0), "step": 9}
    sender = HTTPTransport(num_chunks=2)
    receiver = HTTPTransport()
    try:
        sender.send_checkpoint([1], step=9, state_dict=state, timeout=10)
        got = receiver.recv_checkpoint(
            src_rank=0, metadata=sender.metadata(), step=9, timeout=10
        )
    finally:
        receiver.shutdown()
        sender.shutdown()
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), x.view(torch.int16))
    np.testing.assert_array_equal(got["f"], np.arange(6.0, dtype=np.float32))
    assert got["step"] == 9


# -- sharded split: meta and bytes against JAX ------------------------------


@pytest.mark.parametrize(
    "dtype, shape",
    [("float32", (16, 4)), ("bfloat16", (3, 5)), ("float32", ()),
     ("int32", (7,))],
)
def test_sharded_split_meta_and_bytes_equal_jax(dtype, shape):
    """A torch tensor is one whole-tensor shard: the same keys, shapes,
    slot_map, global_shape, dtype and buffer bytes as JAX's split of a
    single-device array of the same values (a 0-d leaf's key is ())."""
    if dtype == "bfloat16":
        x, xj = _bf16_pair(2, shape)
    else:
        v = np.asarray(_values(3, shape) * 100).astype(dtype)
        x, xj = torch.from_numpy(v), jnp.asarray(v)
    meta, bufs = split_state_sharded({"x": x})
    jmeta, jbufs = jsharded.split_state_sharded({"x": xj})
    m, jm = meta["x"], jmeta["x"]
    assert isinstance(m, _ShardedRef)
    assert m.keys == jm.keys
    assert m.shapes == jm.shapes
    assert m.slot_map == jm.slot_map == [0]
    assert m.global_shape == jm.global_shape == shape
    assert m.dtype == jm.dtype == dtype
    assert [b.tobytes() for b in bufs] == [b.tobytes() for b in jbufs]


def test_sharded_split_one_buffer_per_tensor_host_leaves_plain():
    """Each tensor moves once; a numpy leaf stays a plain ref and a host
    scalar stays in the meta."""
    state = {
        "w": torch.arange(64.0).reshape(16, 4),
        "rep": torch.full((3, 5), 2.0).bfloat16(),
        "host": np.ones((2, 2), np.float64),
        "step": 11,
    }
    meta, buffers = split_state_sharded(state)
    assert len(buffers) == 3
    assert len(meta["w"].shapes) == 1 and meta["w"].slot_map == [0]
    assert isinstance(meta["host"], tser._TensorRef)
    assert meta["step"] == 11


def _device_state(fill: float):
    return {
        "w": torch.arange(64.0).reshape(16, 4) + fill,
        "rep": torch.full((3, 5), fill + 2.0).bfloat16(),
        "s": torch.tensor(fill),
        "step": 11,
    }


def test_sharded_join_builds_fresh_leaves_and_frees_stale_storage():
    """join_state_sharded builds each leaf as a fresh tensor on the target
    leaf's device and dtype, equal bitwise, never in the target's storage;
    with delete_target_leaves the stale targets' storage is freed."""
    src = _device_state(5.0)
    target = _device_state(0.0)
    old_w = target["w"]
    meta, buffers = split_state_sharded(src)
    buffers = [b.reshape(-1) for b in buffers]  # as the wire delivers them
    got = join_state_sharded(meta, buffers, target=target)
    for k in ("w", "rep", "s"):
        assert torch.equal(got[k], src[k]) and got[k].dtype == src[k].dtype
        assert got[k].data_ptr() not in (src[k].data_ptr(), target[k].data_ptr())
    assert torch.equal(old_w, torch.arange(64.0).reshape(16, 4))  # unwritten
    assert got["step"] == 11
    got = join_state_sharded(meta, buffers, target=target, delete_target_leaves=True)
    assert torch.equal(got["w"], src["w"])
    assert old_w.untyped_storage().size() == 0  # stale storage freed


def test_sharded_leaf_refuses_other_shapes_and_missing_targets():
    meta, buffers = split_state_sharded({"w": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match=r"target shape \(3, 4\) != checkpoint shape \(4, 3\)"):
        build_sharded_leaf(meta["w"], buffers, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="needs a target tensor"):
        build_sharded_leaf(meta["w"], buffers, None)


# -- PGTransport over the socket process group ------------------------------


def _pgs(n, name, timeout=10.0):
    store = TCPStoreServer()
    pgs = [ProcessGroupSocket(timeout=timeout) for _ in range(n)]
    with ThreadPoolExecutor(max_workers=n) as pool:
        list(pool.map(
            lambda r: pgs[r].configure(f"{store.address()}/{name}", r, n),
            range(n),
        ))
    return store, pgs


def _close(store, pgs):
    for pg in pgs:
        pg.shutdown()
    store.shutdown()


def _host_state():
    return {
        "model": {
            "w1": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b1": np.zeros(4, dtype=np.float32),
            "deep": [np.ones((2, 2), dtype=np.float64), {"x": np.int32(7)}],
        },
        "step": 5,
        "name": "test",
    }


def test_pg_transport_roundtrip_in_place():
    store, pgs = _pgs(2, "ckpt")
    state = _host_state()
    prealloc = _host_state()
    prealloc["model"]["w1"].fill(0)
    sender = PGTransport(pgs[0], timeout=10.0)
    receiver = PGTransport(pgs[1], timeout=10.0, state_dict_fn=lambda: prealloc)
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            fs = pool.submit(sender.send_checkpoint, [1], 2, state, 10)
            fr = pool.submit(receiver.recv_checkpoint, 0, "<n/a>", 2, 10)
            fs.result(timeout=30)
            got = fr.result(timeout=30)
    finally:
        _close(store, pgs)
    np.testing.assert_array_equal(got["model"]["w1"], state["model"]["w1"])
    np.testing.assert_array_equal(got["model"]["deep"][0], state["model"]["deep"][0])
    assert (got["step"], got["name"]) == (5, "test")
    # The in-place receive wrote into the preallocated leaves.
    assert got["model"]["w1"] is prealloc["model"]["w1"]


def test_pg_transport_sharded_streaming_receive():
    """Sharded heal over the socket PG: the receiver builds each leaf on
    its own target's device, bitwise equal, without writing the target."""
    store, pgs = _pgs(2, "sharded")
    src = _device_state(9.0)
    target = _device_state(0.0)
    sender = PGTransport(pgs[0], timeout=10.0, sharded=True,
                         state_dict_fn=lambda: src)
    receiver = PGTransport(pgs[1], timeout=10.0, sharded=True,
                           state_dict_fn=lambda: target)
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            fs = pool.submit(sender.send_checkpoint, [1], 3, src, 30)
            fr = pool.submit(receiver.recv_checkpoint, 0, "<n/a>", 3, 30)
            fs.result(timeout=30)
            got = fr.result(timeout=30)
    finally:
        _close(store, pgs)
    for k in ("w", "rep", "s"):
        assert torch.equal(got[k], src[k]) and got[k].device == target[k].device
    assert float(target["s"]) == 0.0
    assert got["step"] == 11


def test_pg_transport_sharded_multi_dst(monkeypatch):
    """A heal with TWO recovering replicas: each leaf is pulled once and
    sent to both; both rebuild bitwise-equal states."""
    from torchft_tpu_torch.checkpointing import sharded

    store, pgs = _pgs(3, "multidst")
    src = _device_state(4.0)
    targets = [_device_state(0.0) for _ in range(2)]
    pulls = []
    real_pull = sharded._pull
    monkeypatch.setattr(
        sharded, "_pull", lambda t: (pulls.append(t.shape), real_pull(t))[1]
    )
    sender = PGTransport(pgs[0], timeout=10.0, sharded=True)
    receivers = [
        PGTransport(pgs[r + 1], timeout=10.0, sharded=True,
                    state_dict_fn=lambda r=r: targets[r])
        for r in range(2)
    ]
    try:
        with ThreadPoolExecutor(max_workers=3) as pool:
            fs = pool.submit(sender.send_checkpoint, [1, 2], 5, src, 30)
            frs = [
                pool.submit(receivers[r].recv_checkpoint, 0, "<n/a>", 5, 30)
                for r in range(2)
            ]
            fs.result(timeout=30)
            got = [f.result(timeout=30) for f in frs]
    finally:
        _close(store, pgs)
    assert len(pulls) == 3  # once per leaf, not once per destination
    for g in got:
        assert torch.equal(g["w"], src["w"]) and g["step"] == 11


def test_pg_transport_sharded_dead_dst_fails_fast():
    """A dead recovering replica latches the socket PG group-wide: the
    sharded send surfaces it as an exception promptly (the manager latches
    it and the next quorum re-heals), bounded by one wait."""
    store, pgs = _pgs(3, "deaddst", timeout=3.0)
    pgs[2].shutdown()  # dst 2 dies before the heal
    time.sleep(0.5)  # let rank 0's reader observe the EOF
    sender = PGTransport(pgs[0], timeout=3.0, sharded=True)
    t0 = time.monotonic()
    try:
        with pytest.raises(Exception):
            sender.send_checkpoint([1, 2], 8, _device_state(6.0), 10)
        assert time.monotonic() - t0 < 15
    finally:
        _close(store, pgs[:2])


def test_pg_transport_sharded_without_state_fn_raises_before_traffic():
    class NoTraffic:
        def recv(self, *a, **k):
            raise AssertionError("traffic before the check")

    with pytest.raises(ValueError, match="needs state_dict_fn"):
        PGTransport(NoTraffic(), sharded=True).recv_checkpoint(0, "<n/a>", 1, 5)


# -- the commit fence -------------------------------------------------------


@pytest.mark.timeout(300)
def test_slowed_sharded_send_during_commit_delivers_pre_step_state():
    """The lazy send reads the live tensors after the state-dict read lock
    is released. Replica 0 heals replica 1 at step 0 with every wire send
    slowed, while its main thread goes straight to the fenced commit that
    adds 100 to each tensor in place: the fence joins the quorum (and so
    the send) first, so replica 1 receives the pre-step values."""
    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.manager import Manager

    lighthouse = LighthouseServer(
        min_replicas=2, join_timeout_ms=1000, quorum_tick_ms=50,
        heartbeat_timeout_ms=1000,
    )
    received = []

    def replica(rank):
        params = {f"p{i}": torch.full((8,), 7.0 if rank == 0 else 0.0)
                  for i in range(4)}
        pg = ProcessGroupSocket(timeout=10.0)
        if rank == 0:
            send = pg.send

            def slow_send(tensors, dst, tag=""):
                if tag.startswith("ckpt"):
                    time.sleep(0.15)
                return send(tensors, dst, tag=tag)

            pg.send = slow_send
        manager = Manager(
            pg=pg,
            checkpoint_transport=PGTransport(
                pg, timeout=20.0, state_dict_fn=lambda: {"user": {"default": params}},
                sharded=True,
            ),
            state_dict=lambda: params,
            load_state_dict=lambda sd: (
                received.append({k: v.clone() for k, v in sd.items()}),
                [params[k].copy_(v) for k, v in sd.items()],
            ),
            min_replica_size=2, use_async_quorum=True, timeout=20.0,
            quorum_timeout=20.0, connect_timeout=10.0,
            replica_id=f"fence{rank}", lighthouse_addr=lighthouse.address(),
            group_rank=0, group_world_size=1, max_retries=4,
        )
        try:
            manager.start_quorum()
            with manager.fenced_state_dict():
                if manager.should_commit():
                    for p in params.values():
                        p += 100.0
            return {k: v.clone() for k, v in params.items()}
        finally:
            manager.shutdown()

    pool = ThreadPoolExecutor(max_workers=2)
    try:
        out = [f.result(timeout=120) for f in
               [pool.submit(replica, r) for r in range(2)]]
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        lighthouse.shutdown()
    assert len(received) == 1
    for k, v in received[0].items():
        assert torch.equal(v, torch.full((8,), 7.0)), (k, v)
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k])
        assert torch.equal(out[0][k], torch.full((8,), 107.0))
