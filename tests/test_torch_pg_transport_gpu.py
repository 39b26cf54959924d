"""The sharded PG heal and the durable restore onto the card: a state of
CUDA tensors (fp32, bf16, a 0-d leaf) sent leaf by leaf over the socket
process group is built on the receiver's CUDA device, bit for bit, and a
durable snapshot restores onto the device of its live twin. Imports no JAX,
so it runs where JAX is not installed; tests/conftest.py imports JAX, so
skip it there:

    python -m pytest --noconftest -m gpu tests/test_torch_pg_transport_gpu.py

Without a CUDA device the tests skip.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from torchft_tpu_torch.checkpointing import DurableCheckpointer
from torchft_tpu_torch.checkpointing.pg_transport import PGTransport
from torchft_tpu_torch.process_group import ProcessGroupSocket
from torchft_tpu_torch.store import TCPStoreServer


def _state(seed, device):
    gen = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(512, 384, generator=gen).to(device),
        "h": torch.randn(1000, generator=gen).bfloat16().to(device),
        "step": torch.tensor(float(seed)),  # AdamW's 0-d CPU step
        "n": seed,
    }


def _skip_without_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")


@pytest.mark.gpu
def test_sharded_pg_heal_builds_the_state_on_the_card():
    _skip_without_card()
    store = TCPStoreServer()
    pgs = [ProcessGroupSocket(timeout=30.0) for _ in range(2)]
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(
            lambda r: pgs[r].configure(f"{store.address()}/gpu", r, 2), range(2)
        ))
    src = _state(3, "cuda")
    target = _state(0, "cuda")
    sender = PGTransport(pgs[0], timeout=30.0, sharded=True)
    receiver = PGTransport(
        pgs[1], timeout=30.0, sharded=True, state_dict_fn=lambda: target
    )
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            fs = pool.submit(sender.send_checkpoint, [1], 3, src, 60)
            fr = pool.submit(receiver.recv_checkpoint, 0, "<n/a>", 3, 60)
            fs.result(timeout=60)
            got = fr.result(timeout=60)
    finally:
        for pg in pgs:
            pg.shutdown()
        store.shutdown()
    for k in ("w", "h", "step"):
        assert got[k].device == target[k].device and got[k].dtype == src[k].dtype
        assert torch.equal(got[k].cpu(), src[k].cpu()), k
        assert got[k].data_ptr() != target[k].data_ptr()
    assert got["n"] == 3
    assert torch.equal(target["w"], _state(0, "cuda")["w"])  # never written


@pytest.mark.gpu
def test_durable_restore_lands_on_the_card(tmp_path):
    _skip_without_card()
    live = _state(5, "cuda")
    ckpt = DurableCheckpointer(str(tmp_path), every=1)
    ckpt.save(1, live)
    ckpt.wait()
    got = ckpt.restore(abstract_state=_state(0, "cuda"))
    ckpt.close()
    for k in ("w", "h", "step"):
        assert got[k].device == live[k].device and got[k].dtype == live[k].dtype
        assert torch.equal(got[k].cpu(), live[k].cpu()), k
