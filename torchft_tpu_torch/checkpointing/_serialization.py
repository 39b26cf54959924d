"""Streaming (de)serialization of pytrees of arrays.

Role of the reference's ``torchft/checkpointing/_serialization.py`` +
the tensor/metadata split in ``pg_transport.py:27-141``: a state dict
(arbitrarily nested dicts/lists/tuples of torch tensors or numpy arrays plus plain
Python scalars) is split into a picklable *meta* skeleton and a flat list of
raw array buffers. That enables chunked streaming over HTTP, zero-copy sends
over a process group, and in-place receive into a preallocated state dict
(critical for large-model heal time).

Torch tensors are pulled to host as numpy on serialize; receivers get numpy
and move it to their device themselves — the transport layer never owns
device placement. A bfloat16 tensor, whose dtype numpy lacks, travels as
the raw bits of ``t.view(torch.int16)`` under the meta dtype ``"bfloat16"``
(the name the JAX package writes for the same bytes) and is rebuilt as a
bfloat16 tensor on the CPU.
"""

from __future__ import annotations

import io
import pickle
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, List, Optional, Tuple

import numpy as np

_LEN = struct.Struct(">Q")


def _is_array(x: Any) -> bool:
    if isinstance(x, np.ndarray):
        return True
    # torch.Tensor without importing torch at module load.
    t = type(x)
    mod = getattr(t, "__module__", "")
    return mod.startswith("torch") and hasattr(x, "detach") and hasattr(x, "shape")


# Checkpoint dtypes numpy lacks, each carried as the raw bits of an integer
# dtype of its width.
_RAW_DTYPES = {"bfloat16": np.int16}


def wire_dtype(name: str) -> np.dtype:
    """The numpy dtype a buffer of checkpoint dtype ``name`` travels as."""
    return np.dtype(_RAW_DTYPES.get(name, name))


def _is_torch_tensor(x: Any) -> bool:
    # torch.Tensor without importing torch at module load.
    mod = getattr(type(x), "__module__", "")
    return mod.startswith("torch") and hasattr(x, "untyped_storage")


def dtype_name(x: Any) -> str:
    """A tensor's or array's dtype as the checkpoint names it (numpy's
    names; ``"bfloat16"`` as the JAX package writes it)."""
    if _is_torch_tensor(x):
        return str(x.dtype).removeprefix("torch.")
    return str(np.dtype(x.dtype))


def _to_host(x: Any) -> Tuple[np.ndarray, str]:
    """``(host array, checkpoint dtype name)`` of an array leaf. A CPU
    tensor's array aliases the tensor (``.numpy()`` is zero-copy)."""
    if isinstance(x, np.ndarray):
        return x, str(x.dtype)
    import torch

    t = x.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy(), "bfloat16"
    return t.cpu().numpy(), dtype_name(t)


def from_wire(arr: np.ndarray, dtype: str) -> Any:
    """A received buffer as its leaf: the numpy array itself, or for a
    dtype numpy lacks a CPU tensor over the same bytes."""
    if dtype not in _RAW_DTYPES:
        return arr
    import torch

    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).view(getattr(torch, dtype))


@dataclass
class _TensorRef:
    """Placeholder for an array leaf inside the pickled meta skeleton."""

    index: int
    dtype: str
    shape: Tuple[int, ...]


def split_state(obj: Any) -> Tuple[Any, List[np.ndarray]]:
    """Replaces every array leaf with a `_TensorRef`; returns (meta, buffers)."""
    buffers: List[np.ndarray] = []

    def walk(x: Any) -> Any:
        if _is_array(x) and getattr(x, "ndim", 0) >= 0 and not np.isscalar(x):
            arr, dtype = _to_host(x)
            ref = _TensorRef(len(buffers), dtype, tuple(arr.shape))
            buffers.append(np.ascontiguousarray(arr))
            return ref
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple):
            mapped = [walk(v) for v in x]
            if hasattr(x, "_fields"):  # NamedTuple
                return type(x)(*mapped)
            return tuple(mapped)
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(obj), buffers


def join_state(
    meta: Any,
    buffers: List[Optional[np.ndarray]],
    inplace_into: Optional[Any] = None,
) -> Any:
    """Rebuilds the pytree from (meta, buffers). With ``inplace_into`` (a
    structurally-identical state dict), array data is copied into the existing
    leaves instead of allocating new ones (reference: pg_transport.py
    in-place receive, 230-298)."""
    inplace_leaves: List[Optional[np.ndarray]] = []
    if inplace_into is not None:
        _, inplace_leaves = split_state(inplace_into)  # type: ignore[assignment]

    def walk(x: Any) -> Any:
        if isinstance(x, _TensorRef):
            buf = buffers[x.index]
            assert buf is not None, f"missing buffer {x.index}"
            arr = buf.reshape(x.shape)
            if inplace_into is not None and x.index < len(inplace_leaves):
                dst = inplace_leaves[x.index]
                # Read-only leaves (views of immutable buffers) can't be
                # written in place; fall through to the fresh buffer.
                if (
                    dst is not None
                    and dst.shape == arr.shape
                    and dst.flags.writeable
                ):
                    np.copyto(dst, arr.astype(dst.dtype, copy=False))
                    return from_wire(dst, x.dtype)
            return from_wire(arr, x.dtype)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple):
            mapped = [walk(v) for v in x]
            if hasattr(x, "_fields"):  # NamedTuple (e.g. optax states)
                return type(x)(*mapped)
            return tuple(mapped)
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(meta)


def save_stream(obj: Any, fileobj: BinaryIO) -> None:
    """Streams (meta, buffers) as length-prefixed records: pickle(meta),
    then each raw buffer (no pickling of bulk data)."""
    meta, buffers = split_state(obj)
    blob = pickle.dumps(meta)
    fileobj.write(_LEN.pack(len(blob)))
    fileobj.write(blob)
    for buf in buffers:
        data = buf.tobytes()
        fileobj.write(_LEN.pack(len(data)))
        fileobj.write(data)


def _read_exact(fileobj: BinaryIO, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        chunk = fileobj.read(n - len(out))
        if not chunk:
            raise EOFError("stream ended mid-record")
        out += chunk
    return bytes(out)


def collect_refs(meta: Any) -> List[_TensorRef]:
    """All `_TensorRef`s in a meta skeleton, sorted by buffer index."""
    refs: List[_TensorRef] = []

    def collect(x: Any) -> None:
        if isinstance(x, _TensorRef):
            refs.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)

    collect(meta)
    refs.sort(key=lambda r: r.index)
    return refs


def load_stream(fileobj: BinaryIO, inplace_into: Optional[Any] = None) -> Any:
    meta_len = _LEN.unpack(_read_exact(fileobj, 8))[0]
    meta = pickle.loads(_read_exact(fileobj, meta_len))
    refs = collect_refs(meta)
    buffers: List[Optional[np.ndarray]] = [None] * len(refs)
    for ref in refs:
        size = _LEN.unpack(_read_exact(fileobj, 8))[0]
        raw = _read_exact(fileobj, size)
        buffers[ref.index] = np.frombuffer(raw, dtype=wire_dtype(ref.dtype)).copy()
    return join_state(meta, buffers, inplace_into)


def dumps(obj: Any) -> bytes:
    out = io.BytesIO()
    save_stream(obj, out)
    return out.getvalue()


def loads(data: bytes, inplace_into: Optional[Any] = None) -> Any:
    return load_stream(io.BytesIO(data), inplace_into)
