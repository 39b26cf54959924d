"""The port's quantize and dequantize (``torchft_tpu_torch/ops/quantization.py``)
against the wire they must write: both packages' host quantizers
(``collectives.quantize_blockwise`` / ``dequantize_blockwise``) bit for bit,
and the JAX package's Pallas kernels in interpret mode. Inputs are made with
numpy from a seed. On the CPU the wrappers run the kernels' plain versions;
the kernels themselves are held to the same bits on the card
(tests/test_torch_quantization_gpu.py, chip_smoke.py)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu import collectives as jcoll
from torchft_tpu.ops import quantization as JQ
from torchft_tpu_torch import collectives as tcoll
from torchft_tpu_torch.ops import quantization as Q

SIZES = [1, 511, 512, 513, 4103]
QMAX = {8: 127.0, 4: 7.0}


def _seeded(n: int, seed: int) -> np.ndarray:
    """Normal values whose per-block magnitude spans 1e-8 to 1e3."""
    rng = np.random.default_rng(seed)
    blocks = -(-n // Q.BLOCK)
    mags = np.repeat(10.0 ** rng.uniform(-8, 3, size=blocks), Q.BLOCK)[:n]
    return (rng.standard_normal(n) * mags).astype(np.float32)


def _special(bits: int) -> np.ndarray:
    """One block per case: zeros, exact half-steps, +-0, subnormals, the
    +-qmax edges, a NaN block and an inf block."""
    qmax = QMAX[bits]
    rng = np.random.default_rng(bits)
    blocks = []
    blocks.append(np.zeros(Q.BLOCK))
    # scale = qmax * 2^-3 / qmax = 2^-3 exactly; x / scale = k + 0.5.
    half = (np.arange(Q.BLOCK) % (2 * qmax) - qmax + 0.5) * 0.125
    half[0] = qmax * 0.125
    blocks.append(half)
    signed_zero = np.zeros(Q.BLOCK)
    signed_zero[1::2] = -0.0
    blocks.append(signed_zero)
    blocks.append(rng.standard_normal(Q.BLOCK) * 1e-39)  # subnormal
    blocks.append(np.full(Q.BLOCK, 1e-45))  # absmax / qmax underflows to 0
    edges = rng.uniform(-1.0, 1.0, Q.BLOCK) * 3.0
    edges[:4] = [3.0, -3.0, 3.0 * (1 - 2**-24), -3.0 * (1 - 2**-24)]
    blocks.append(edges)
    nan = rng.standard_normal(Q.BLOCK)
    nan[7] = np.nan
    blocks.append(nan)
    inf = rng.standard_normal(Q.BLOCK)
    inf[3], inf[9] = np.inf, -np.inf
    blocks.append(inf)
    return np.concatenate(blocks).astype(np.float32)


def _bits_of(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32 if a.itemsize == 4 else np.uint8)


def _assert_bitwise(got, want, what: str) -> None:
    got = np.asarray(got).reshape(-1)
    want = np.asarray(want).reshape(-1)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        what, got.dtype, got.shape, want.dtype, want.shape,
    )
    diff = int((_bits_of(got) != _bits_of(want)).sum())
    assert diff == 0, f"{what}: {diff} of {got.size} differ in their bits"


def _port_quantize(x: np.ndarray, bits: int):
    q, s, n = Q.fused_quantize(torch.from_numpy(x), bits)
    assert n == x.size
    return q.numpy().reshape(-1), s.numpy()


def _host_quantize(x: np.ndarray, bits: int):
    with warnings.catch_warnings():  # non-finite blocks warn in numpy
        warnings.simplefilter("ignore", RuntimeWarning)
        qt, st = tcoll.quantize_blockwise(x, bits)
        qj, sj = jcoll.quantize_blockwise(x, bits)
    _assert_bitwise(qt, qj, "the two host quantizers' payloads")
    _assert_bitwise(st, sj, "the two host quantizers' scales")
    return qt, st


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", SIZES)
def test_plain_equals_host_quantizers(n, bits):
    x = _seeded(n, seed=n)
    qh, sh = _host_quantize(x, bits)
    q, s = _port_quantize(x, bits)
    _assert_bitwise(q, qh, "payload")
    _assert_bitwise(s, sh, "scales")
    back = Q.fused_dequantize(torch.from_numpy(q), torch.from_numpy(s), n, bits)
    want = tcoll.dequantize_blockwise(qh, sh, n, bits)
    _assert_bitwise(want, jcoll.dequantize_blockwise(qh, sh, n, bits), "host")
    _assert_bitwise(back.numpy(), want, "dequantized")


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_equals_host_quantizers_on_special_values(bits):
    x = _special(bits)
    qh, sh = _host_quantize(x, bits)
    q, s = _port_quantize(x, bits)
    _assert_bitwise(q, qh, "payload")
    _assert_bitwise(s, sh, "scales")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = tcoll.dequantize_blockwise(qh, sh, x.size, bits)
    back = Q.fused_dequantize(
        torch.from_numpy(q), torch.from_numpy(s), x.size, bits
    )
    _assert_bitwise(back.numpy(), want, "dequantized")


@pytest.mark.parametrize("bits", [8, 4])
def test_host_quantizer_on_special_blocks_pinned(bits):
    """What the wire carries for the blocks a plain formula leaves open, as
    the host quantizer writes it (the kernel is held to the same bits): an
    all-zero block and one whose absmax / qmax underflows get scale 1.0 and
    q 0; +-0 quantizes to 0; exact half-steps round to even; the +-absmax
    elements land on +-qmax; a subnormal block keeps a subnormal scale; a
    block holding a NaN gets scale NaN and one holding an inf scale inf,
    every q of both 0, so all of both dequantize to NaN."""
    x = _special(bits)
    qmax = QMAX[bits]
    q, s = _port_quantize(x, bits)
    if bits == 4:
        q = tcoll.unpack_nibbles(q, s.size * Q.BLOCK)
    q = q.reshape(-1, Q.BLOCK)
    zero, half, signed_zero, sub, under, edges, nan, inf = range(8)
    for b in (zero, signed_zero, under):
        assert s[b] == 1.0 and not q[b].any(), b
    assert s[half] == 0.125
    k = np.arange(Q.BLOCK) % (2 * qmax) - qmax + 0.5
    k[0] = qmax
    want = np.clip(np.where(np.floor(k) % 2 == 0, np.floor(k), np.ceil(k)), -qmax, qmax)
    np.testing.assert_array_equal(q[half], want.astype(np.int8))
    assert 0 < s[sub] < np.finfo(np.float32).tiny and q[sub].any()
    assert q[edges][0] == qmax and q[edges][1] == -qmax
    assert np.isnan(s[nan]) and np.isposinf(s[inf])
    assert not q[nan].any() and not q[inf].any()
    back = Q.fused_dequantize(
        *[torch.from_numpy(a) for a in _port_quantize(x, bits)], x.size, bits
    ).numpy().reshape(-1, Q.BLOCK)
    assert np.isnan(back[nan]).all() and np.isnan(back[inf]).all()
    assert np.isfinite(back[:nan]).all()


def _pallas_quantize(x: np.ndarray, bits: int):
    """The JAX package's Pallas quantize kernel in interpret mode, through
    ``fused_quantize`` and straight through ``_quantize_rows``; its row
    padding to the TPU tile dropped."""
    blocks = -(-x.size // Q.BLOCK)
    q, s, n = JQ.fused_quantize(jnp.asarray(x), bits)
    assert n == x.size
    bpb = Q.BLOCK if bits == 8 else Q.BLOCK // 2
    q = np.asarray(q).reshape(-1)[: blocks * bpb]
    s = np.asarray(s)[:blocks]
    x2d, _ = JQ._pad_blocks(jnp.asarray(x))
    q_rows, s_rows = JQ._quantize_rows(x2d, QMAX[bits])
    q_rows = np.asarray(q_rows)[:blocks]
    if bits == 4:
        q_rows = tcoll.pack_nibbles(q_rows.reshape(-1))
    _assert_bitwise(q_rows, q, "_quantize_rows vs fused_quantize")
    _assert_bitwise(np.asarray(s_rows)[:blocks, 0], s, "_quantize_rows scales")
    return q, s


def _assert_scales_against_pallas(port, pallas, x, qmax) -> None:
    """The port's scale is absmax / qmax, correctly rounded, as the host
    quantizer's; the Pallas kernel's, run by XLA on the CPU, is absmax times
    the rounded reciprocal of qmax (XLA rewrites a divide by a constant),
    and can differ in the last bit. ROADMAP.md §3 lists the difference."""
    blocks = port.size
    padded = np.zeros(blocks * Q.BLOCK, np.float32)
    padded[: x.size] = x
    absmax = np.abs(padded.reshape(blocks, Q.BLOCK)).max(axis=1)
    _assert_bitwise(port, absmax / np.float32(qmax), "port scale = absmax / qmax")
    _assert_bitwise(
        pallas, absmax * np.float32(1.0 / qmax), "Pallas scale = absmax * (1 / qmax)"
    )


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", SIZES)
def test_plain_quantize_against_pallas_kernel(n, bits):
    """Payload bit for bit; scales as _assert_scales_against_pallas says."""
    x = _seeded(n, seed=n)
    q, s = _port_quantize(x, bits)
    qp, sp = _pallas_quantize(x, bits)
    _assert_bitwise(q, qp, "payload vs Pallas")
    _assert_scales_against_pallas(s, sp, x, QMAX[bits])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", SIZES)
def test_plain_dequantize_equals_pallas_kernel(n, bits):
    """The Pallas dequantize kernel (interpret mode) and the port's plain
    version on the same host payload: bit for bit."""
    qh, sh = tcoll.quantize_blockwise(_seeded(n, seed=100 + n), bits)
    want = np.asarray(JQ.fused_dequantize(qh, sh, n, bits))
    back = Q.fused_dequantize(torch.from_numpy(qh), torch.from_numpy(sh), n, bits)
    _assert_bitwise(back.numpy(), want, "dequantized vs Pallas")


def test_pallas_kernel_flushes_subnormals_that_the_wire_keeps():
    """XLA on the CPU flushes subnormals to zero, so the Pallas kernel in
    interpret mode writes scale 1.0 and q 0 for a subnormal block, where the
    host quantizer (and the port, on the CPU and the card) keeps the
    subnormal scale. ROADMAP.md §3 lists the difference."""
    x = (np.random.default_rng(3).standard_normal(Q.BLOCK) * 1e-39).astype(np.float32)
    q, s = _port_quantize(x, 8)
    qh, sh = tcoll.quantize_blockwise(x, 8)
    _assert_bitwise(q, qh, "payload")
    _assert_bitwise(s, sh, "scales")
    qp, sp = _pallas_quantize(x, 8)
    assert sp[0] == 1.0 and not qp.any()
    assert 0 < s[0] < np.finfo(np.float32).tiny and q.any()


@pytest.mark.parametrize("bits", [8, 4])
def test_chunked_transfer_matches_single_shot(monkeypatch, bits):
    """Payloads above _TRANSFER_CHUNK go in chunks: the pulled layout is the
    single-shot one and the host quantizer's, bit for bit; the async pair
    gives the same bytes; the chunked dequantize inverts it exactly."""
    n = 3 * 4 * Q.BLOCK + 777
    x = torch.from_numpy(_seeded(n, seed=11))
    q1, s1, n1 = Q.quantize_for_transfer(x, bits)
    qh, sh = tcoll.quantize_blockwise(x.numpy(), bits)
    _assert_bitwise(q1, qh, "single-shot payload")
    _assert_bitwise(s1, sh, "single-shot scales")
    back1 = Q.dequantize_from_transfer(q1, s1, n1, bits, "cpu")

    monkeypatch.setattr(Q, "_TRANSFER_CHUNK", 4 * Q.BLOCK)
    chunks, n2, ready = Q.quantize_for_transfer_async(x, bits)
    assert len(chunks) == 4 and n2 == n and ready is None
    qa, sa, _ = Q.pull_transfer_chunks(chunks, n2, ready)
    assert chunks == [None] * 4  # released as pulled
    qc, sc, nc = Q.quantize_for_transfer(x, bits)
    for got_q, got_s in ((qa, sa), (qc, sc)):
        _assert_bitwise(got_q, q1, "chunked payload")
        _assert_bitwise(got_s, s1, "chunked scales")
    backc = Q.dequantize_from_transfer(qc, sc, nc, bits, "cpu")
    _assert_bitwise(backc.numpy(), back1.numpy(), "chunked dequantize")
    _assert_bitwise(
        backc.numpy(), tcoll.dequantize_blockwise(qh, sh, n, bits), "vs host"
    )


def test_zero_length_payload():
    q, s, n = Q.quantize_for_transfer(torch.zeros(0), 8)
    assert (q.size, s.size, n) == (0, 0, 0)
    assert Q.dequantize_from_transfer(q, s, 0, 8, "cpu").numel() == 0


def test_dequantize_rejects_a_payload_that_does_not_hold_n():
    q, s, _ = Q.fused_quantize(torch.ones(1000), 8)
    with pytest.raises(ValueError, match="does not hold"):
        Q.fused_dequantize(q, s, 1025, 8)


class _PG:
    def size(self):
        return 2


def _wire_leaves(seed: int):
    rng = np.random.default_rng(seed)
    return [
        rng.standard_normal((37, 5)).astype(np.float32),
        rng.standard_normal((300,)).astype(np.float32),
        rng.standard_normal((641,)).astype(np.float32),  # odd tail
    ]


def _capture_wire(monkeypatch, module, reply):
    captured = {}

    def fake_pipeline(pg, q_host, s_host, n, b):
        captured["wire"] = (np.array(q_host), np.array(s_host), int(n), int(b))
        return reply(module, q_host, s_host, n, b)

    monkeypatch.setattr(module, "_quantized_wire_pipeline", fake_pipeline)
    return captured


def _tiny(module, q, s, n, b):
    # Fewer blocks than ranks: the pipeline returns the fp32 sum itself.
    return module.dequantize_blockwise(q, s, n, b)


def _full(module, q, s, n, b):
    # The reduced payload, requantized (the peer contributes zeros).
    return q, s


@pytest.mark.parametrize("reply", [_tiny, _full], ids=["fp32-sum", "payload"])
@pytest.mark.parametrize("bits", [8, 4])
def test_device_path_wire_equals_host_and_jax(monkeypatch, bits, reply):
    """The port's device path (CPU tensors, so the plain versions) puts on
    the wire exactly the bytes quantize_blockwise gives for the bucket's
    concatenated flat, and the payload the JAX package's device path
    (Pallas interpreter, TORCHFT_FORCE_DEVICE_QUANT) captures for the same
    leaves; its scales differ from the JAX one's only as
    _assert_scales_against_pallas says. The result comes back as new
    tensors of the inputs' shapes and dtypes, times the scale."""
    leaves = _wire_leaves(7)
    flat = np.concatenate([a.reshape(-1) for a in leaves])
    n = flat.size
    qh, sh = tcoll.quantize_blockwise(flat, bits)

    port = _capture_wire(monkeypatch, tcoll, reply)
    tensors = [torch.from_numpy(a.copy()) for a in leaves]
    outs = tcoll.allreduce_quantized_torch(
        _PG(), tensors, scale=0.5, bits=bits
    ).wait(timeout=60)
    q_port, s_port, n_port, b_port = port["wire"]
    assert (n_port, b_port) == (n, bits)
    _assert_bitwise(q_port, qh, "port wire payload vs host")
    _assert_bitwise(s_port, sh, "port wire scales vs host")

    monkeypatch.setenv("TORCHFT_FORCE_DEVICE_QUANT", "1")
    jax_wire = _capture_wire(monkeypatch, jcoll, reply)
    jcoll.allreduce_quantized_jax(
        _PG(), [jnp.asarray(a) for a in leaves], bits=bits
    ).wait(timeout=120)
    q_jax, s_jax, n_jax, _ = jax_wire["wire"]
    assert n_jax == n
    _assert_bitwise(q_port, q_jax, "port wire payload vs JAX device path")
    _assert_scales_against_pallas(s_port, s_jax, flat, QMAX[bits])

    want = tcoll.dequantize_blockwise(qh, sh, n, bits) * np.float32(0.5)
    offset = 0
    for t, out in zip(tensors, outs):
        assert out.shape == t.shape and out.dtype == t.dtype
        assert out.data_ptr() != t.data_ptr()
        _assert_bitwise(
            out.numpy(), want[offset : offset + t.numel()], "result"
        )
        offset += t.numel()
    for t, a in zip(tensors, leaves):
        _assert_bitwise(t.numpy(), a, "inputs untouched")


def test_device_path_rebuilds_bf16_and_skips_the_wire_alone():
    """A bf16 bucket comes back in bf16; with one replica nothing is
    quantized and the scale is applied."""
    from torchft_tpu_torch.process_group import ProcessGroupDummy

    t = torch.arange(6, dtype=torch.bfloat16).view(2, 3)
    (out,) = tcoll.allreduce_quantized_torch(
        ProcessGroupDummy(), [t], scale=0.5
    ).wait()
    assert out.dtype == torch.bfloat16 and out.shape == t.shape
    torch.testing.assert_close(out, t * 0.5, rtol=0, atol=0)


def test_takes_device_path(monkeypatch):
    monkeypatch.delenv("TORCHFT_FORCE_DEVICE_QUANT", raising=False)
    cpu = [torch.zeros(3)]
    assert not tcoll.takes_device_path(cpu)
    assert not tcoll.takes_device_path([np.zeros(3)])
    monkeypatch.setenv("TORCHFT_FORCE_DEVICE_QUANT", "1")
    assert tcoll.takes_device_path(cpu)
    assert not tcoll.takes_device_path([torch.zeros(3), np.zeros(3)])
    assert not tcoll.takes_device_path([])


@pytest.mark.parametrize("path", ["device", "host"])
def test_quantized_wire_phases_run_in_issue_order(monkeypatch, path):
    """Buckets in flight together reach the wire in the order they were
    issued, however long each takes to quantize: the process group pairs
    the ranks' ops by the order they are called in, so a bucket that
    overtook another on one replica but not on its peer would be reduced
    against the wrong payload. Here the first bucket's quantize is held
    back until the second has had ample time to overtake it."""
    import threading
    import time

    order = []
    lock = threading.Lock()

    def fake_pipeline(pg, q_host, s_host, n, b):
        with lock:
            order.append(n)
        return tcoll.dequantize_blockwise(q_host, s_host, n, b)

    monkeypatch.setattr(tcoll, "_quantized_wire_pipeline", fake_pipeline)
    slow_n = 3 * Q.BLOCK
    pg = _PG()
    if path == "device":
        real_pull = Q.pull_transfer_chunks

        def slow_pull(chunks, n, *args):
            if n == slow_n:
                time.sleep(0.5)
            return real_pull(chunks, n, *args)

        monkeypatch.setattr(Q, "pull_transfer_chunks", slow_pull)
        issue = lambda n: tcoll.allreduce_quantized_torch(  # noqa: E731
            pg, [torch.ones(n)]
        )
    else:
        real_quantize = tcoll.quantize_blockwise

        def slow_quantize(flat, bits=8):
            if flat.size == slow_n:
                time.sleep(0.5)
            return real_quantize(flat, bits)

        monkeypatch.setattr(tcoll, "quantize_blockwise", slow_quantize)
        issue = lambda n: tcoll.allreduce_quantized(  # noqa: E731
            pg, [np.ones(n, np.float32)]
        )
    works = [issue(slow_n), issue(Q.BLOCK), issue(2 * Q.BLOCK)]
    for w in works:
        w.wait(timeout=30)
    assert order == [slow_n, Q.BLOCK, 2 * Q.BLOCK]
