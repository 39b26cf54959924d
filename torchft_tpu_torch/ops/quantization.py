"""Blockwise int8/int4 quantization of the replica-axis allreduce payload:
three hand-written CUDA kernels for Hopper.

The port of ``torchft_tpu/ops/quantization.py``'s Pallas TPU kernels
``_quantize_kernel``, ``_dequantize_kernel`` and ``_reduce_kernel``. The
fused int8 reduce has no production caller (the wire pipeline reduces on
the host, as the JAX package's does); the kernel harness
(``python -m torchft_tpu_torch.ops.bench_kernels``) runs it. The kernels live
in ``csrc/quantization.cu`` (built with ``nvcc`` for ``sm_90a`` at first
use, bound with ``ctypes``); the source says what bounds them on the H100.

The layout is the wire format of the host quantizer
(``collectives.quantize_blockwise``), bit for bit: one fp32 scale per 512
values, ``blocks = ceil(n / 512)`` rows with the tail row zero-padded, an
int8 payload of ``blocks * 512`` bytes, or ``blocks * 256`` with ``bits=4``
(two's-complement nibbles, even flat index in the low nibble). The JAX
package pads the row count to its TPU tile of 32; the port does not. The
nibble packing is plain torch bitwise ops outside the kernel, as the JAX
package packs outside Pallas.

Each kernel has a wrapper (``fused_quantize``, ``fused_dequantize``,
``fused_reduce_int8``) and a plain PyTorch version of the same math
(``quantize_rows_reference``, ``dequantize_rows_reference``,
``reduce_rows_reference``). A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises.
``LAUNCHES`` counts kernel launches per kernel.

The transfer functions move a payload of any size between the device and
the host in chunks of ``_TRANSFER_CHUNK`` values: the quantize kernels are
launched on the caller's thread (``quantize_for_transfer_async``) and pulled
on another (``pull_transfer_chunks``); the reduced payload goes back through
``dequantize_from_transfer``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch.collectives import _qmax as _bits_qmax

__all__ = [
    "BLOCK",
    "LAUNCHES",
    "dequantize_from_transfer",
    "dequantize_rows_reference",
    "fused_dequantize",
    "fused_quantize",
    "fused_reduce_int8",
    "host_to_device",
    "pull_transfer_chunks",
    "quantize_for_transfer",
    "quantize_for_transfer_async",
    "quantize_rows_reference",
    "reduce_rows_reference",
]

BLOCK = 512  # values per scale, as collectives.BLOCK
_SOURCE = "quantization.cu"

# Values per quantize-and-pull (and push-and-dequantize) chunk: bounds the
# device memory a transfer needs beyond its input and output.
_TRANSFER_CHUNK = 16 * 1024 * 1024

# Kernel launches since the last reset, by kernel name.
LAUNCHES: Dict[str, int] = {"quantize": 0, "dequantize": 0, "reduce": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


def quantize_rows_reference(
    x2d: torch.Tensor, qmax: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 [rows, 512] -> (int8 q [rows, 512], fp32 scales [rows]): the
    quantize kernel's math. Both divides are tensor by tensor, so they are
    correctly rounded on the CPU and the card alike (PyTorch's CUDA divide
    by a Python scalar multiplies by its reciprocal instead)."""
    absmax = x2d.abs().amax(dim=1)  # NaN if the row holds one
    scale = absmax / torch.full_like(absmax, qmax)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(x2d / scale[:, None]).clamp(-qmax, qmax)  # half to even
    # The host's float->int8 cast writes 0 for NaN (a row holding a NaN or
    # an inf); say so here rather than leave it to the cast.
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q)
    return q.to(torch.int8), scale


def dequantize_rows_reference(
    q2d: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """int8 [rows, 512] x fp32 scales [rows] -> fp32 [rows, 512]: the
    dequantize kernel's math."""
    return q2d.to(torch.float32) * scales[:, None]


def reduce_rows_reference(
    q: torch.Tensor, scales: torch.Tensor, avg: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 q [R, rows, 512] x fp32 scales [R, rows] -> (int8 [rows, 512],
    fp32 [rows]): the reduce kernel's math. Each rank's dequantized rows are
    added in rank order, every product and sum its own tensor op (one
    rounding each, as the host's ``acc += dequantize_blockwise(...)``); the
    divide by R is tensor by tensor; then the quantize kernel's math."""
    ranks = q.shape[0]
    acc = torch.zeros(q.shape[1:], dtype=torch.float32, device=q.device)
    for r in range(ranks):
        acc = acc + dequantize_rows_reference(q[r], scales[r])
    if avg:
        acc = acc / torch.full_like(acc, ranks)
    return quantize_rows_reference(acc, 127.0)


def _pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int8 [rows, 512] in [-7, 7] -> int8 [rows, 256], the layout of
    ``collectives.pack_nibbles`` (even flat index -> low nibble)."""
    u = q.view(torch.uint8) & 0xF
    return (u[:, 0::2] | (u[:, 1::2] << 4)).view(torch.int8)


def _unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    """int8 [rows, 256] -> int8 [rows, 512], sign-extending each nibble."""
    u = p.view(torch.uint8)
    both = torch.stack((u & 0xF, u >> 4), dim=-1).reshape(p.shape[0], -1)
    return (both ^ 8).view(torch.int8) - 8


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from torchft_tpu_torch.ops import _cuda_build

        lib = _cuda_build.load(_SOURCE)
        P, L, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
        lib.tft_quantize_rows.argtypes = [P, L, P, P, F, P]
        lib.tft_dequantize_rows.argtypes = [P, P, L, P, P]
        lib.tft_reduce_rows_int8.argtypes = [P, P, L, L, ctypes.c_int, P, P, P]
        lib.tft_quantize_rows.restype = ctypes.c_int
        lib.tft_dequantize_rows.restype = ctypes.c_int
        lib.tft_reduce_rows_int8.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda(name: str, *pairs: Tuple[torch.Tensor, torch.dtype]) -> None:
    """Raises unless every tensor lies on one CUDA device, is contiguous and
    has its dtype."""
    tensors = [t for t, _ in pairs]
    if not all(t.is_cuda for t in tensors) or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"{name}: tensors must all lie on one CUDA device (or all on the "
            f"CPU for the plain version), got {[str(t.device) for t in tensors]}"
        )
    for t, dtype in pairs:
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor, got {t.dtype}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}"
            )


def _launch(name: str, fn, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")
    LAUNCHES[name] += 1


def _quantize_rows(flat: torch.Tensor, qmax: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 [n] -> (int8 [blocks, 512], fp32 [blocks]); the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    n = flat.numel()
    blocks = -(-n // BLOCK)
    if flat.device.type == "cpu":
        padded = torch.zeros(blocks * BLOCK, dtype=torch.float32)
        padded[:n] = flat
        return quantize_rows_reference(padded.view(blocks, BLOCK), qmax)
    _check_cuda("quantize", (flat, torch.float32))
    q = torch.empty((blocks, BLOCK), dtype=torch.int8, device=flat.device)
    s = torch.empty((blocks,), dtype=torch.float32, device=flat.device)
    if blocks:
        _launch(
            "quantize", _library().tft_quantize_rows, flat.device,
            flat.data_ptr(), n, q.data_ptr(), s.data_ptr(), qmax,
        )
    return q, s


def _dequantize_into(
    q2d: torch.Tensor, scales: torch.Tensor, out: torch.Tensor
) -> None:
    """Writes the first ``out.numel()`` values of q2d [blocks, 512] x
    scales [blocks] into fp32 ``out``; the kernel on CUDA tensors, the plain
    version on CPU ones."""
    n = out.numel()
    blocks = scales.numel()
    if q2d.shape != (blocks, BLOCK) or blocks != -(-n // BLOCK):
        raise ValueError(
            f"dequantize: payload {tuple(q2d.shape)} with {blocks} scales "
            f"does not hold {n} values"
        )
    if q2d.device.type == "cpu" and scales.device.type == "cpu":
        out.copy_(dequantize_rows_reference(q2d, scales).view(-1)[:n])
        return
    _check_cuda(
        "dequantize", (q2d, torch.int8), (scales, torch.float32),
        (out, torch.float32),
    )
    if n:
        _launch(
            "dequantize", _library().tft_dequantize_rows, out.device,
            q2d.data_ptr(), scales.data_ptr(), n, out.data_ptr(),
        )


def fused_quantize(
    x: torch.Tensor, bits: int = 8
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Quantizes ``x`` (any shape, read as a flat fp32 array of n values) to
    (payload int8 [blocks, 512] or [blocks, 256] with ``bits=4``, fp32
    scales [blocks], n) on its device: the quantize kernel (replaces
    ``_quantize_kernel``) on a CUDA tensor."""
    flat = x.reshape(-1)
    if flat.dtype != torch.float32:
        flat = flat.float()
    q, s = _quantize_rows(flat, _bits_qmax(bits))
    if bits == 4:
        q = _pack_nibbles(q)
    return q, s, flat.numel()


def fused_dequantize(
    q: torch.Tensor, scales: torch.Tensor, n: int, bits: int = 8
) -> torch.Tensor:
    """Inverse of :func:`fused_quantize`: flat fp32 [n] on the payload's
    device, by the dequantize kernel (replaces ``_dequantize_kernel``) on
    CUDA tensors."""
    _bits_qmax(bits)  # rejects a width the wire does not have
    if bits == 4:
        q = _unpack_nibbles(q.reshape(-1, BLOCK // 2))
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    _dequantize_into(q.reshape(-1, BLOCK), scales.reshape(-1), out)
    return out


def fused_reduce_int8(
    q: torch.Tensor, scales: torch.Tensor, avg: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sums R int8-quantized copies of the same rows in fp32, in rank order,
    divides by R if ``avg``, and requantizes: q [R, rows, 512] int8, scales
    [R, rows] fp32 -> (q_out [rows, 512] int8, scales_out [rows] fp32), the
    host's bytes for the same sum. The reduce kernel (replaces
    ``_reduce_kernel``) on CUDA tensors; unlike the JAX function it neither
    pads the rows nor returns padded rows."""
    if q.dim() != 3 or q.shape[2] != BLOCK or tuple(scales.shape) != tuple(q.shape[:2]):
        raise ValueError(
            f"fused_reduce_int8: want q [R, rows, {BLOCK}] and scales [R, rows], "
            f"got {tuple(q.shape)} and {tuple(scales.shape)}"
        )
    if q.shape[0] == 0:
        raise ValueError("fused_reduce_int8: no ranks to reduce")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(
            f"fused_reduce_int8: want int8 q and float32 scales, got {q.dtype} "
            f"and {scales.dtype}"
        )
    if q.device.type == "cpu" and scales.device.type == "cpu":
        return reduce_rows_reference(q, scales, avg)
    _check_cuda("reduce", (q, torch.int8), (scales, torch.float32))
    ranks, rows = q.shape[:2]
    q_out = torch.empty((rows, BLOCK), dtype=torch.int8, device=q.device)
    s_out = torch.empty((rows,), dtype=torch.float32, device=q.device)
    if rows:
        _launch(
            "reduce", _library().tft_reduce_rows_int8, q.device,
            q.data_ptr(), scales.data_ptr(), ranks, rows, int(avg),
            q_out.data_ptr(), s_out.data_ptr(),
        )
    return q_out, s_out


# ---------------------------------------------------------------------------
# Chunked transfer between the device and the host
# ---------------------------------------------------------------------------


def quantize_for_transfer_async(
    x: torch.Tensor, bits: int = 8
) -> Tuple[List[tuple], int, Optional["torch.cuda.Event"]]:
    """Launches the quantize kernels of every ``_TRANSFER_CHUNK``-value
    chunk of ``x`` on the caller's current stream and returns without
    waiting: ``(chunks, n, ready)``, chunks ``[(q, s, m), ...]`` of device
    tensors, ``ready`` an event recorded after the last launch (None on the
    CPU). Finish with :func:`pull_transfer_chunks`, on any thread.

    Launching here, on the caller's thread, queues the kernels right behind
    the work that produced ``x``; the pull then waits for them alone. The
    chunks are views of ``x``: no copy of the input is made, and every chunk
    but the last is a whole number of rows, so the pulled chunks laid end
    to end are the single-shot layout."""
    flat = x.reshape(-1)
    if flat.dtype != torch.float32:
        flat = flat.float()
    n = flat.numel()
    chunks = []
    for start in range(0, n, _TRANSFER_CHUNK):
        m = min(_TRANSFER_CHUNK, n - start)
        q, s, _ = fused_quantize(flat[start : start + m], bits)
        chunks.append((q, s, m))
    ready = None
    if flat.is_cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(flat.device))
    return chunks, n, ready


def pull_transfer_chunks(
    chunks: List[tuple],
    n: int,
    ready: Optional["torch.cuda.Event"] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Copies the chunks of :func:`quantize_for_transfer_async` to the host:
    (int8 payload, fp32 scales, n) in ``collectives.quantize_blockwise``'s
    layout. Waits on ``ready`` first, then copies on a stream of its own, so
    neither waits for work queued after the kernels on the caller's stream
    (the legacy default stream would)."""
    if ready is not None:
        ready.synchronize()
    q_parts: List[np.ndarray] = []
    s_parts: List[np.ndarray] = []
    device = chunks[0][0].device if chunks else torch.device("cpu")
    side = (
        torch.cuda.stream(torch.cuda.Stream(device))
        if device.type == "cuda"
        else contextlib.nullcontext()
    )
    with side:
        for i, (q, s, _m) in enumerate(chunks):
            q_parts.append(q.reshape(-1).cpu().numpy())
            s_parts.append(s.cpu().numpy())
            # Release the device chunk as soon as it is on the host.
            chunks[i] = None
    if not q_parts:
        return np.empty(0, np.int8), np.empty(0, np.float32), n
    if len(q_parts) == 1:
        return q_parts[0], s_parts[0], n
    return np.concatenate(q_parts), np.concatenate(s_parts), n


def quantize_for_transfer(
    x: torch.Tensor, bits: int = 8
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Quantizes ``x`` on its device and pulls the payload to the host:
    (int8 payload, fp32 scales, n), the layout of
    ``collectives.quantize_blockwise``."""
    return pull_transfer_chunks(*quantize_for_transfer_async(x, bits))


def host_to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``. To a CUDA device through
    pinned memory, without waiting, on the current stream: a pageable copy
    would wait for everything queued on that stream first."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def dequantize_from_transfer(
    q: np.ndarray,
    scales: np.ndarray,
    n: int,
    bits: int = 8,
    device: "torch.device | str" = "cuda",
) -> torch.Tensor:
    """Host payload (``collectives.quantize_blockwise``'s layout) -> flat
    fp32 [n] on ``device``, chunk by chunk: each chunk's payload goes to the
    device and is dequantized into its slice of the output, so the device
    holds the output plus one chunk's payload. Runs on the current stream."""
    device = torch.device(device)
    bpb = BLOCK // (8 // bits)  # payload bytes per row
    rows = _TRANSFER_CHUNK // BLOCK
    blocks = scales.size
    out = torch.empty(n, dtype=torch.float32, device=device)
    for b0 in range(0, blocks, rows):
        b1 = min(b0 + rows, blocks)
        q_piece = host_to_device(q[b0 * bpb : b1 * bpb], device)
        s_piece = host_to_device(scales[b0:b1], device)
        if bits == 4:
            q_piece = _unpack_nibbles(q_piece.view(-1, BLOCK // 2))
        _dequantize_into(
            q_piece.view(-1, BLOCK), s_piece, out[b0 * BLOCK : min(b1 * BLOCK, n)]
        )
    return out
