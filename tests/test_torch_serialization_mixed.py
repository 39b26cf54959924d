"""Checkpoint meta that both packages read: a heal between a JAX replica and
a port replica moves real arrays, in either direction, over ``dumps`` /
``loads``, the HTTP transport and the ``pg`` transport, and the port loads
a JAX-made meta without importing JAX or the JAX package. A meta that holds
another class of the JAX stack (an optax state) is refused.

A bfloat16 leaf crosses the ``pg`` transport with its dtype and bits in
both directions: received fresh, in place (``state_dict_fn``) and sharded.
The port sends it as its bits under the JAX package's socket header
``"bfloat16"``, and reads that header back with no ``ml_dtypes``."""

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from torchft_tpu.checkpointing import _serialization as jser
from torchft_tpu.checkpointing.http_transport import HTTPTransport as JHTTP
from torchft_tpu.checkpointing.pg_transport import PGTransport as JPG
from torchft_tpu.process_group import ProcessGroupSocket as JSocket
from torchft_tpu_torch.checkpointing import _serialization as tser
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport as THTTP
from torchft_tpu_torch.checkpointing.pg_transport import PGTransport as TPG
from torchft_tpu_torch.process_group import ProcessGroupSocket as TSocket
from torchft_tpu_torch.store import TCPStoreServer

REPO = Path(__file__).resolve().parent.parent
KINDS = ("float32", "bfloat16", "int8", "nested")


def _values(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _states(kind: str, seed: int = 0):
    """The same state as the JAX package holds it (numpy, bfloat16 through
    ml_dtypes) and as the port holds it (torch tensors)."""
    x = _values(seed, (5, 7))
    if kind == "float32":
        return {"w": x, "step": 3}, {"w": torch.from_numpy(x.copy()), "step": 3}
    if kind == "bfloat16":
        t = torch.from_numpy(x).bfloat16()
        j = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return {"w": j.copy(), "step": 3}, {"w": t, "step": 3}
    if kind == "int8":
        q = np.random.default_rng(seed).integers(-127, 128, (9,), dtype=np.int8)
        return {"q": q}, {"q": torch.from_numpy(q.copy())}
    y = _values(seed + 1, (4,))
    jax_state = {
        "model": {"a": x, "layers": [y, {"b": y * 2}]},
        "pair": (np.arange(3, dtype=np.int8), "tag"),
        "step": 11,
    }
    port_state = {
        "model": {
            "a": torch.from_numpy(x.copy()),
            "layers": [torch.from_numpy(y.copy()), {"b": torch.from_numpy(y * 2)}],
        },
        "pair": (torch.arange(3, dtype=torch.int8), "tag"),
        "step": 11,
    }
    return jax_state, port_state


def _bits(x):
    """A leaf's raw bytes and dtype name, whichever package made it (a
    jax.Array as its host copy)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes(), "bfloat16", tuple(x.shape)
        return x.numpy().tobytes(), str(x.numpy().dtype), tuple(x.shape)
    if hasattr(x, "addressable_shards"):
        x = np.asarray(x)
    assert isinstance(x, np.ndarray), f"{type(x)} is not an array"
    return x.tobytes(), str(x.dtype), x.shape


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, (np.ndarray, torch.Tensor)):
        assert _bits(got) == _bits(want)
    else:
        assert got == want


@pytest.mark.parametrize("kind", KINDS)
def test_port_loads_a_jax_meta_as_real_arrays(kind):
    jax_state, port_state = _states(kind)
    got = tser.loads(jser.dumps(jax_state))
    _assert_same(got, port_state)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_loads_a_port_meta_as_real_arrays(kind):
    jax_state, port_state = _states(kind)
    got = jser.loads(tser.dumps(port_state))
    _assert_same(got, jax_state)


@pytest.mark.parametrize("num_chunks", [0, 2])
def test_port_http_receiver_heals_from_a_jax_sender(num_chunks):
    jax_state, port_state = _states("nested")
    sender = JHTTP(num_chunks=num_chunks)
    receiver = THTTP()
    try:
        sender.send_checkpoint([1], step=4, state_dict=jax_state, timeout=10)
        got = receiver.recv_checkpoint(
            src_rank=0, metadata=sender.metadata(), step=4, timeout=10
        )
    finally:
        receiver.shutdown()
        sender.shutdown()
    _assert_same(got, port_state)


def test_jax_http_receiver_heals_from_a_port_sender():
    jax_state, port_state = _states("bfloat16")
    sender = THTTP(num_chunks=2)
    receiver = JHTTP()
    try:
        sender.send_checkpoint([1], step=4, state_dict=port_state, timeout=10)
        got = receiver.recv_checkpoint(
            src_rank=0, metadata=sender.metadata(), step=4, timeout=10
        )
    finally:
        receiver.shutdown()
        sender.shutdown()
    _assert_same(got, jax_state)


def _pg_heal(port_sends, sent, **receiver_kw):
    """One world of 2 over the shared socket wire: rank 0 sends ``sent``
    with one package's ``PGTransport``, rank 1 receives with the other's
    (``receiver_kw`` to its constructor; ``sharded`` to both). Returns
    what rank 1 received."""
    store = TCPStoreServer()
    pgs = [TSocket(timeout=10.0), JSocket(timeout=10.0)]
    if not port_sends:
        pgs.reverse()
    sender_cls, receiver_cls = (TPG, JPG) if port_sends else (JPG, TPG)
    sharded = receiver_kw.get("sharded", False)
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            for f in [
                pool.submit(pg.configure, f"{store.address()}/mixed", r, 2)
                for r, pg in enumerate(pgs)
            ]:
                f.result(timeout=30)
            sender = sender_cls(pgs[0], timeout=10.0, sharded=sharded)
            receiver = receiver_cls(pgs[1], timeout=10.0, **receiver_kw)
            fs = pool.submit(sender.send_checkpoint, [1], 2, sent, 10)
            fr = pool.submit(receiver.recv_checkpoint, 0, "<n/a>", 2, 10)
            fs.result(timeout=30)
            return fr.result(timeout=30)
    finally:
        for pg in pgs:
            pg.shutdown()
        store.shutdown()


@pytest.mark.parametrize("port_sends", [False, True], ids=["jax_to_port", "port_to_jax"])
def test_pg_transport_between_the_packages(port_sends):
    """One world of 2 over the shared socket wire: rank 0 sends with one
    package's ``PGTransport``, rank 1 receives with the other's."""
    jax_state, port_state = _states("nested")
    sent, want = (port_state, jax_state) if port_sends else (jax_state, port_state)
    _assert_same(_pg_heal(port_sends, sent), want)


def _bf16_target(port: bool, sharded: bool):
    """A receiver's preallocated bf16 state of ``_states("bfloat16")``'s
    shape: zeros, as each package holds it (a jax.Array for JAX's sharded
    receiver, which builds onto the target's sharding)."""
    if port:
        return {"w": torch.zeros(5, 7, dtype=torch.bfloat16), "step": 0}
    if sharded:
        return {"w": jnp.zeros((5, 7), jnp.bfloat16), "step": 0}
    return {"w": np.zeros((5, 7), ml_dtypes.bfloat16), "step": 0}


@pytest.mark.parametrize("mode", ["fresh", "in_place", "sharded"])
@pytest.mark.parametrize("port_sends", [False, True], ids=["jax_to_port", "port_to_jax"])
def test_pg_transport_carries_a_bf16_leaf_between_the_packages(port_sends, mode):
    """The bf16 leaf arrives with the sender's dtype and bits: as a fresh
    receive, into the receiver's preallocated state (whose buffer then holds
    the bits too), and through ``sharded=True`` on both sides."""
    jax_state, port_state = _states("bfloat16")
    if mode == "sharded" and not port_sends:
        jax_state = {**jax_state, "w": jnp.asarray(jax_state["w"])}
    sent, want = (port_state, jax_state) if port_sends else (jax_state, port_state)
    kw = {}
    if mode != "fresh":
        target = _bf16_target(not port_sends, mode == "sharded")
        kw = {"state_dict_fn": lambda: target, "sharded": mode == "sharded"}
    got = _pg_heal(port_sends, sent, **kw)
    assert _bits(got["w"]) == _bits(want["w"])
    assert got["step"] == 3
    if mode == "in_place":
        assert _bits(target["w"]) == _bits(want["w"])


def test_loading_a_jax_meta_imports_nothing_of_jax(tmp_path):
    jax_state, _ = _states("nested")
    blob = tmp_path / "meta.bin"
    blob.write_bytes(jser.dumps({**jax_state, "bf": _states("bfloat16")[0]["w"]}))
    code = (
        "import sys\n"
        "from torchft_tpu_torch.checkpointing import _serialization as s\n"
        f"state = s.loads(open({str(blob)!r}, 'rb').read())\n"
        "assert type(state['model']['a']).__name__ == 'ndarray'\n"
        "assert str(state['bf'].dtype) == 'torch.bfloat16'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'torchft_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_port_reads_a_bfloat16_header_without_ml_dtypes(tmp_path):
    """A JAX ``ProcessGroupSocket`` sends a bf16 array, then a bf16 state
    by ``PGTransport``, to a port rank in a process that never imports
    ``ml_dtypes``: the array arrives with the sender's bits, and the state
    lands in a bf16 tensor with them."""
    jax_state, port_state = _states("bfloat16")
    want = tmp_path / "want.bin"
    want.write_bytes(_bits(port_state["w"])[0])
    store = TCPStoreServer()
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from torchft_tpu_torch.process_group import ProcessGroupSocket\n"
        "from torchft_tpu_torch.checkpointing.pg_transport import PGTransport\n"
        "pg = ProcessGroupSocket(timeout=60.0)\n"
        "pg.configure(sys.argv[1], 1, 2)\n"
        "(a,) = pg.recv(0, tag='raw').wait(60)\n"
        "want = open(sys.argv[2], 'rb').read()\n"
        "assert a.dtype.itemsize == 2 and a.tobytes() == want, a.dtype\n"
        "target = {'w': torch.zeros(5, 7, dtype=torch.bfloat16), 'step': 0}\n"
        "got = PGTransport(pg, timeout=60.0, state_dict_fn=lambda: target)"
        ".recv_checkpoint(0, '<n/a>', 2, 60)\n"
        "for t in (got['w'], target['w']):\n"
        "    assert t.dtype == torch.bfloat16, t.dtype\n"
        "    assert t.view(torch.int16).numpy().tobytes() == want\n"
        "pg.shutdown()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('ml_dtypes', 'jax', 'jaxlib', 'torchft_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    child = subprocess.Popen(
        [sys.executable, "-c", code, f"{store.address()}/nomld", str(want)],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
    )
    pg = JSocket(timeout=60.0)
    try:
        pg.configure(f"{store.address()}/nomld", 0, 2)
        pg.send([jax_state["w"]], 1, tag="raw").wait(60)
        JPG(pg, timeout=60.0).send_checkpoint([1], 2, jax_state, 60)
        out, _ = child.communicate(timeout=90)
    finally:
        if child.poll() is None:
            child.kill()
        pg.shutdown()
        store.shutdown()
    assert child.returncode == 0, out


def test_a_meta_with_an_optax_state_is_refused():
    """A JAX DiLoCo state holds optax NamedTuples; the port refuses it by
    name rather than import optax (and JAX) to build it."""
    blob = jser.dumps({"outer": optax.TraceState(trace={"w": np.ones(3, np.float32)})})
    with pytest.raises(pickle.UnpicklingError, match="optax.*TraceState"):
        tser.loads(blob)


def test_a_ref_with_other_fields_is_refused():
    ref = jser._TensorRef(0, "float32", (2,))
    ref.extra = 1
    blob = pickle.dumps({"w": ref})
    with pytest.raises(pickle.UnpicklingError, match="malformed _TensorRef"):
        tser.loads_meta(blob)


def test_the_port_writes_its_refs_under_the_jax_name():
    """What the port sends names the JAX class, and the port reads that
    name back as its own class: port-to-port heals are unchanged."""
    blob = tser.dumps_meta({"w": tser._TensorRef(0, "bfloat16", (2, 3))})
    assert b"torchft_tpu.checkpointing._serialization" in blob
    assert b"torchft_tpu_torch" not in blob
    got = tser.loads_meta(blob)["w"]
    assert type(got) is tser._TensorRef
    assert (got.index, got.dtype, got.shape) == (0, "bfloat16", (2, 3))
