"""Quantized collectives for the replica (DCN) axis.

Capability parity with the reference's ``torchft/collectives.py:159-415``:
``allreduce_quantized`` cuts outer-axis gradient traffic ~4x by sending
block-quantized int8 with per-block float scales instead of float32, using
the same alltoall -> local-reduce-in-full-precision -> allgather pipeline
(sums are computed in float32, so quantization error does not accumulate
across ranks; only one quantize->dequantize round trip per value).

The reference quantizes with Triton fp8 kernels on CUDA; here the host path
is vectorized numpy int8 (replica-axis transfers are host-driven), with the
same wire format as the JAX package's bit for bit. Quantizing on the device
before the device->host pull waits for the quantize-kernel slice of the port
(ROADMAP.md, kernel queue: quantize/dequantize).
"""

from __future__ import annotations

import os
import threading
from typing import Callable, List, Sequence, Tuple

import numpy as np

from torchft_tpu_torch import knobs
from torchft_tpu_torch.process_group import ProcessGroup, ReduceOp
from torchft_tpu_torch.work import DummyWork, FutureWork, Work

BLOCK = 512  # values per quantization scale


def _spawn_collective(fn) -> "concurrent.futures.Future":
    """One daemon thread per in-flight quantized collective. A bounded pool
    would deadlock when several ranks live in one process (tests, parameter
    server): every rank's pipeline must make progress concurrently for any
    alltoall to complete."""
    import concurrent.futures

    fut: concurrent.futures.Future = concurrent.futures.Future()

    def run() -> None:
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(fn())
        except BaseException as e:  # noqa: BLE001 - delivered via the future
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True, name="quant-collective").start()
    return fut


# Host-side (de)quantize runs chunk-parallel on threads: numpy ufuncs
# release the GIL on large arrays, so this scales with cores — measured
# 125M elements: 16.3s -> ~2s single-pass in-place math across 8 threads.
# Param-sized DiLoCo pseudograds make this the peer-side critical path of
# the quantized outer allreduce.
_HOST_QUANT_CHUNK = 8 * 1024 * 1024  # elements per parallel task
_host_pool = None
_host_pool_lock = threading.Lock()


def _pool():
    global _host_pool
    with _host_pool_lock:
        if _host_pool is None:
            import concurrent.futures

            _host_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 4),
                thread_name_prefix="quant-host",
            )
        return _host_pool


def _parallel_over_blocks(n_blocks: int, fn) -> None:
    """Runs fn(block_start, block_end) over block ranges in parallel."""
    blocks_per_task = max(_HOST_QUANT_CHUNK // BLOCK, 1)
    if n_blocks <= blocks_per_task:
        fn(0, n_blocks)
        return
    tasks = []
    for start in range(0, n_blocks, blocks_per_task):
        tasks.append(
            _pool().submit(fn, start, min(start + blocks_per_task, n_blocks))
        )
    for t in tasks:
        t.result()


def _qmax(bits: int) -> float:
    """Symmetric integer range: 127 for int8, 7 for int4."""
    if bits == 8:
        return 127.0
    if bits == 4:
        return 7.0
    raise ValueError(f"unsupported quantization width: {bits} bits")


def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """Packs int8 values in [-7, 7] two-per-byte (two's-complement 4-bit
    nibbles; even index -> low nibble). Wire format of the ``bits=4``
    codec — halves outer-axis bytes vs int8 (the reference's fp8 is
    8-bit; 4-bit matches the Streaming-DiLoCo-style compressed outer
    sync)."""
    u = q.astype(np.uint8) & 0xF
    return (u[0::2] | (u[1::2] << 4)).view(np.int8)


def unpack_nibbles(p: np.ndarray, n_vals: int) -> np.ndarray:
    """Inverse of :func:`pack_nibbles`; returns int8 values of length
    ``n_vals`` with sign extension."""
    u = p.view(np.uint8)
    out = np.empty(u.size * 2, dtype=np.uint8)
    out[0::2] = u & 0xF
    out[1::2] = u >> 4
    # Two's-complement sign extension of the 4-bit field.
    out = ((out ^ 8).astype(np.int8) - 8)
    return out[:n_vals]


def quantize_blockwise(
    flat: np.ndarray, bits: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """Block-quantizes a 1-D float array with one float32 scale per BLOCK
    values (the rowwise-fp8 analog of quantization.py:44-162). Returns
    (int8 payload, float32 scales); with ``bits=4`` the payload is
    nibble-packed (BLOCK/2 bytes per block)."""
    n = flat.size
    qmax = _qmax(bits)
    blocks = (n + BLOCK - 1) // BLOCK
    q = np.empty(blocks * BLOCK, dtype=np.int8)
    scales = np.empty(blocks, dtype=np.float32)
    flat = np.ascontiguousarray(flat, dtype=np.float32)

    def work(b0: int, b1: int) -> None:
        lo, hi = b0 * BLOCK, min(b1 * BLOCK, n)
        chunk = flat[lo:hi]
        pad = b1 * BLOCK - lo
        if pad != chunk.size:  # tail: pad to whole blocks
            padded = np.zeros(pad, dtype=np.float32)
            padded[: chunk.size] = chunk
            chunk = padded
        mat = chunk.reshape(b1 - b0, BLOCK)
        s = np.abs(mat).max(axis=1)
        s /= qmax
        np.copyto(s, 1.0, where=(s == 0))
        scales[b0:b1] = s
        # In-place pipeline: one fp32 temporary for the chunk only.
        buf = mat / s[:, None]
        np.rint(buf, out=buf)
        np.clip(buf, -qmax, qmax, out=buf)
        q[b0 * BLOCK : b1 * BLOCK] = buf.reshape(-1)

    _parallel_over_blocks(blocks, work)
    if bits == 4:
        return pack_nibbles(q), scales
    return q, scales


def dequantize_blockwise(
    q: np.ndarray, scales: np.ndarray, n: int, bits: int = 8
) -> np.ndarray:
    blocks = scales.size
    if bits == 4:
        q = unpack_nibbles(q, blocks * BLOCK)
    out = np.empty(blocks * BLOCK, dtype=np.float32)

    def work(b0: int, b1: int) -> None:
        mat = q[b0 * BLOCK : b1 * BLOCK].astype(np.float32).reshape(
            b1 - b0, BLOCK
        )
        mat *= scales[b0:b1, None]
        out[b0 * BLOCK : b1 * BLOCK] = mat.reshape(-1)

    _parallel_over_blocks(blocks, work)
    return out[:n]


def _flatten(arrays: Sequence[np.ndarray]) -> Tuple[np.ndarray, List[int]]:
    sizes = [a.size for a in arrays]
    flat = np.concatenate([a.reshape(-1).astype(np.float32) for a in arrays])
    return flat, sizes


def _unflatten_into(
    arrays: Sequence[np.ndarray], flat: np.ndarray, sizes: List[int]
) -> None:
    offset = 0
    for a, n in zip(arrays, sizes):
        a[...] = flat[offset : offset + n].reshape(a.shape).astype(
            a.dtype, copy=False
        )
        offset += n


def reduce_scatter_quantized(
    pg: ProcessGroup,
    arrays: Sequence[np.ndarray],
    op: ReduceOp = ReduceOp.SUM,
    bits: int = 8,
) -> Work:
    """Quantized reduce_scatter (reference: collectives.py:159-294): the
    alltoall + local-fp32-reduce half of the allreduce pipeline, WITHOUT the
    allgather — each rank keeps only its own reduced shard (block-aligned).

    Returns Work whose result is ``(shard, (start, end))``: this rank's
    fp32 reduced values covering flat elements ``[start, end)`` of the
    concatenated input.
    """
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"reduce_scatter_quantized supports SUM/AVG, got {op}")
    ws = pg.size()
    arrays = list(arrays)

    def run():
        flat, _sizes = _flatten(arrays)
        n = flat.size
        if ws <= 1:
            return flat, (0, n)
        q_host, s_host = quantize_blockwise(flat, bits)
        blocks = s_host.size
        me = pg.rank()
        counts = [len(c) for c in np.array_split(np.arange(blocks), ws)]
        starts = np.concatenate([[0], np.cumsum(counts)]) * BLOCK
        start, end = int(starts[me]), int(min(starts[me + 1], n))
        if blocks < ws:
            # Tiny payload: gather-all, reduce locally, slice my range.
            gathered = pg.allgather([q_host, s_host]).wait()
            acc = np.zeros(n, np.float32)
            for g_q, g_s in gathered:
                acc += dequantize_blockwise(g_q, g_s, n, bits)
            shard = acc[start:end]
        else:
            acc = _alltoall_chunk_reduce(pg, q_host, s_host, counts, bits)
            shard = acc[: end - start]
        if op == ReduceOp.AVG:
            shard = shard / ws
        return shard, (start, end)

    return FutureWork(_spawn_collective(run))


def bucketize(arrays: Sequence[np.ndarray], cap_bytes: int) -> List[List[int]]:
    """Greedy same-dtype buckets up to ``cap_bytes`` (reference: <=32 MiB
    flat buffers, local_sgd.py:466-560 / ddp bucketing). Returns index
    groups into ``arrays``."""
    by_dtype: dict = {}
    for i, a in enumerate(arrays):
        by_dtype.setdefault(a.dtype, []).append(i)
    buckets: List[List[int]] = []
    for idxs in by_dtype.values():
        cur: List[int] = []
        size = 0
        for i in idxs:
            nbytes = arrays[i].nbytes
            if cur and size + nbytes > cap_bytes:
                buckets.append(cur)
                cur, size = [], 0
            cur.append(i)
            size += nbytes
        if cur:
            buckets.append(cur)
    return buckets


class ErrorFeedback:
    """Replica-local error-feedback residual store for quantized
    collectives (host path).

    Each sync, the caller compensates its payload with the residual the
    previous sync's quantizer dropped, and the ``on_local_quantized``
    hook (running on the collective thread) records what THIS
    quantization drops.  Residuals never cross the wire — each replica
    ships its own compensated payload — so cross-replica bitwise
    equality of the reduced result is unaffected.

    Heal safety: ``clear()`` bumps a generation counter, and a hook
    created before the clear drops its write — an in-flight allreduce
    issued pre-heal cannot re-insert a stale pre-heal residual after
    the store was reset (the collective thread races the heal
    otherwise).  Reference ceiling is 8-bit fp8 with no feedback
    (torchft/collectives.py:297-415); feedback is what makes <=4-bit
    wire widths usable across many rounds.
    """

    def __init__(self, bits: int) -> None:
        self._bits = bits
        self._residuals: dict = {}
        self._generation = 0
        self._lock = threading.Lock()

    def compensate(self, key, flat: np.ndarray) -> np.ndarray:
        """Returns ``flat`` plus the stored residual for ``key`` (no-op
        when absent or shape-mismatched, e.g. after a re-bucketing)."""
        r = self._residuals.get(key)
        if r is not None and r.size == flat.size:
            return flat + r
        return flat

    def make_hook(self, key) -> Callable:
        """Builds the ``on_local_quantized(wire_flat, q, s)`` callback
        that stores the new residual, pinned to the CURRENT generation."""
        gen = self._generation

        def on_local_quantized(wire_flat, q, s):  # collective thread
            residual = wire_flat - dequantize_blockwise(
                q, s, wire_flat.size, self._bits
            )
            with self._lock:
                if self._generation == gen:
                    self._residuals[key] = residual

        return on_local_quantized

    def clear(self) -> None:
        """Drops all residuals AND invalidates in-flight hooks (heal)."""
        with self._lock:
            self._generation += 1
            self._residuals.clear()

    def __bool__(self) -> bool:
        return bool(self._residuals)


def _alltoall_chunk_reduce(
    pg: ProcessGroup,
    q_host: np.ndarray,
    s_host: np.ndarray,
    counts: "List[int]",
    bits: int,
) -> np.ndarray:
    """Shared wire step of both quantized collectives: split the payload
    into per-rank block-aligned chunks, alltoall, and dequantize-accumulate
    every peer's contribution for MY chunk in fp32. Returns the fp32 sum of
    this rank's chunk (counts[rank] * BLOCK values, padded)."""
    bpb = BLOCK // (8 // bits)  # payload bytes per block
    q_chunks, s_chunks = [], []
    off = 0
    for c in counts:
        q_chunks.append(q_host[off * bpb : (off + c) * bpb])
        s_chunks.append(s_host[off : off + c])
        off += c
    all_q = pg.alltoall(q_chunks).wait()
    all_s = pg.alltoall(s_chunks).wait()
    me = pg.rank()
    n_me = counts[me] * BLOCK
    acc = np.zeros(n_me, np.float32)
    for g_q, g_s in zip(all_q, all_s):
        acc += dequantize_blockwise(g_q, g_s, n_me, bits)
    return acc


def _quantized_wire_pipeline(
    pg: ProcessGroup,
    q_host: np.ndarray,
    s_host: np.ndarray,
    n: int,
    bits: int = 8,
):
    """The shared quantized-allreduce wire protocol: block-aligned alltoall
    of int8 chunks + scales -> local fp32 reduce -> requantize -> allgather.
    Every entry point uses this, so replicas may mix input types freely —
    the wire format never depends on the caller's local array type.

    Returns (q_final, s_final) int8+scales for the full buffer, or, for tiny
    payloads (fewer blocks than ranks: allgather-all fallback, no chunking),
    the fully-reduced fp32 array of length ``n`` directly.
    """
    ws = pg.size()
    blocks = s_host.size
    if blocks < ws:
        gathered = pg.allgather([q_host, s_host]).wait()
        acc = np.zeros(n, np.float32)
        for g_q, g_s in gathered:
            acc += dequantize_blockwise(g_q, g_s, n, bits)
        return acc
    # Contiguous block-aligned chunks so each chunk owns whole scales;
    # alltoall -> rank r reduces everyone's r-th chunk.
    counts = [len(c) for c in np.array_split(np.arange(blocks), ws)]
    acc = _alltoall_chunk_reduce(pg, q_host, s_host, counts, bits)
    rq, rs = quantize_blockwise(acc, bits)
    gathered = pg.allgather([rq, np.asarray(rs)]).wait()
    q_final = np.concatenate([g[0] for g in gathered])
    s_final = np.concatenate([g[1] for g in gathered])
    return q_final, s_final


def allreduce_quantized(
    pg: ProcessGroup,
    arrays: Sequence[np.ndarray],
    op: ReduceOp = ReduceOp.SUM,
    bits: int = 8,
    on_local_quantized: "Callable | None" = None,
) -> Work:
    """Quantized SUM/AVG allreduce, in place (reference:
    collectives.py:297-415). Returns async Work whose result is ``arrays``.
    ``bits=4`` nibble-packs the wire payload (half the bytes of int8).

    ``on_local_quantized(flat, q, scales)`` is invoked on the collective
    thread right after THIS rank's payload is quantized — DiLoCo's
    error-feedback residual (flat - dequantize(q, s)) hooks in here, so
    the payload is quantized exactly once and the residual math stays off
    the training thread. The callback sees the flat that actually hit the
    wire (zeros on a non-participating replica)."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(f"allreduce_quantized supports SUM/AVG, got {op}")
    ws = pg.size()
    if ws <= 1:
        return DummyWork(list(arrays))

    from torchft_tpu_torch.telemetry import trace_span

    def run() -> List[np.ndarray]:
        # Same span names as the JAX package's device path so telemetry
        # consumers see one uniform phase decomposition: "quantize_pull"
        # is the host quantize here (there is no device pull), "wire" the
        # alltoall-reduce-allgather pipeline, "dequant_push" the decode +
        # write-back.
        with trace_span("torchft::collectives::quantize_pull"):
            flat, sizes = _flatten(arrays)
            n = flat.size
            q_host, s_host = quantize_blockwise(flat, bits)
            if on_local_quantized is not None:
                on_local_quantized(flat, q_host, s_host)
        with trace_span("torchft::collectives::wire"):
            reduced = _quantized_wire_pipeline(pg, q_host, s_host, n, bits)
        with trace_span("torchft::collectives::dequant_push"):
            if isinstance(reduced, np.ndarray):
                result = reduced
            else:
                q_final, s_final = reduced
                result = dequantize_blockwise(q_final, s_final, n, bits)
            if op == ReduceOp.AVG:
                result /= ws
            _unflatten_into(arrays, result, sizes)
        return list(arrays)

    return FutureWork(_spawn_collective(run))
