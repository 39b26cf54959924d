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
the raw bits of ``t.view(torch.int16)`` in the carrier of
``torchft_tpu_torch._raw_dtypes``, under the meta dtype and the socket
header ``"bfloat16"`` (the names the JAX package writes for the same
bytes), and is rebuilt as a bfloat16 tensor on the CPU. An in-place
receive copies a carrier's bits, never its integer values.

The meta skeleton is pickled by :func:`dumps_meta` and read by
:func:`loads_meta`, the one pair every transport uses, so a heal between the
two packages moves real arrays both ways: each `_TensorRef` is written under
the JAX package's class name (its loader resolves its own class; the port's
maps that name back to this class), and the port reads both names without
importing the JAX package, and refuses any other class of the JAX stack.
``sharded._ShardedRef`` is written and read the same way.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, ClassVar, Dict, List, Optional, Tuple

import numpy as np

from torchft_tpu_torch import _raw_dtypes

_LEN = struct.Struct(">Q")


def _is_array(x: Any) -> bool:
    if isinstance(x, np.ndarray):
        return True
    # torch.Tensor without importing torch at module load.
    t = type(x)
    mod = getattr(t, "__module__", "")
    return mod.startswith("torch") and hasattr(x, "detach") and hasattr(x, "shape")


def wire_dtype(name: str) -> np.dtype:
    """The numpy dtype a buffer of checkpoint dtype ``name`` travels as
    (the int16 carrier for ``"bfloat16"``)."""
    return _raw_dtypes.from_wire_name(name)


def _is_torch_tensor(x: Any) -> bool:
    # torch.Tensor without importing torch at module load.
    mod = getattr(type(x), "__module__", "")
    return mod.startswith("torch") and hasattr(x, "untyped_storage")


def dtype_name(x: Any) -> str:
    """A tensor's or array's dtype as the checkpoint names it (numpy's
    names; ``"bfloat16"`` as the JAX package writes it)."""
    if _is_torch_tensor(x):
        return str(x.dtype).removeprefix("torch.")
    return _raw_dtypes.wire_name(np.dtype(x.dtype))


def _to_host(x: Any) -> Tuple[np.ndarray, str]:
    """``(host array, checkpoint dtype name)`` of an array leaf. A CPU
    tensor's array aliases the tensor (``.numpy()`` is zero-copy); a
    bfloat16 leaf is its bits in the carrier, which the socket header names
    ``"bfloat16"``."""
    if isinstance(x, np.ndarray):
        arr = _raw_dtypes.as_carrier(x)
        return arr, _raw_dtypes.wire_name(arr.dtype)
    import torch

    t = x.detach()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).cpu().numpy()
        return bits.view(_raw_dtypes.BF16), "bfloat16"
    return t.cpu().numpy(), dtype_name(t)


def from_wire(arr: np.ndarray, dtype: str) -> Any:
    """A received buffer as its leaf: the numpy array itself, or for a
    dtype numpy lacks a CPU tensor over the same bytes."""
    if not _raw_dtypes.is_raw_name(dtype):
        return arr
    import torch

    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int16)).view(getattr(torch, dtype))


def copy_into(dst: np.ndarray, src: np.ndarray) -> bool:
    """Writes ``src`` into the same-shape ``dst`` for an in-place receive;
    False when ``dst`` cannot take it (read-only, another shape, or a
    dtype numpy lacks on one side only). A dtype numpy lacks is copied as
    its bits: casting its carrier's integers would change the values."""
    if dst.shape != src.shape or not dst.flags.writeable:
        return False
    if _raw_dtypes.is_raw(dst.dtype) or _raw_dtypes.is_raw(src.dtype):
        if _raw_dtypes.wire_name(dst.dtype) != _raw_dtypes.wire_name(src.dtype):
            return False
        np.copyto(dst.view(np.int16), src.view(np.int16))
        return True
    np.copyto(dst, src.astype(dst.dtype, copy=False))
    return True


def check_ref_state(cls: type, state: Any, types: Dict[str, Any]) -> None:
    """Raises unless ``state``, read off the wire by ``cls.__setstate__``
    from a ref either package wrote, holds exactly the fields ``types``
    names, each of its type (a tuple type: the field's type and that of
    its items); else the buffers would be misread."""

    def ok(v: Any, t: Any) -> bool:
        if isinstance(t, tuple):
            return isinstance(v, t[0]) and all(ok(x, t[1]) for x in v)
        return isinstance(v, t) and not (t is int and isinstance(v, bool))

    if not (
        isinstance(state, dict)
        and set(state) == set(types)
        and all(ok(state[k], t) for k, t in types.items())
    ):
        raise pickle.UnpicklingError(
            f"malformed {cls.__name__} state {state!r}"
        )


@dataclass
class _TensorRef:
    """Placeholder for an array leaf inside the pickled meta skeleton."""

    # The JAX package's class, whose name the ref is written under.
    WIRE_NAME: ClassVar[Tuple[str, str]] = (
        "torchft_tpu.checkpointing._serialization", "_TensorRef",
    )

    index: int
    dtype: str
    shape: Tuple[int, ...]

    def __setstate__(self, state: Any) -> None:
        check_ref_state(
            _TensorRef, state, {"index": int, "dtype": str, "shape": (tuple, int)}
        )
        self.__dict__.update(state)


# The JAX package's sharded ref, read as ``sharded._ShardedRef``.
SHARDED_WIRE_NAME = ("torchft_tpu.checkpointing.sharded", "_ShardedRef")
# Top-level packages of the JAX stack: the port reads none of their classes.
_FOREIGN_ROOTS = {"torchft_tpu", "jax", "jaxlib", "flax", "optax"}


class _MetaPickler(pickle._Pickler):
    """Writes each ref (a class with ``WIRE_NAME``) as the JAX package's
    class by name. The pure-Python pickler, because the C pickler's
    ``save_global`` imports the module a class names, and that module
    imports JAX."""

    def save(self, obj: Any, save_persistent_id: bool = True) -> None:
        wire = getattr(type(obj), "WIRE_NAME", None)
        if wire is None:
            super().save(obj, save_persistent_id)
            return
        # What the JAX package's pickle of its own dataclass holds:
        # the class, NEWOBJ with no arguments, then BUILD with the fields.
        self.save(wire[0])
        self.save(wire[1])
        self.write(pickle.STACK_GLOBAL)
        self.save(())
        self.write(pickle.NEWOBJ)
        self.save({f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})
        self.write(pickle.BUILD)


class _MetaUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str) -> Any:
        if (module, name) in (_TensorRef.WIRE_NAME, (__name__, "_TensorRef")):
            return _TensorRef
        if (module, name) == SHARDED_WIRE_NAME:
            from torchft_tpu_torch.checkpointing.sharded import _ShardedRef

            return _ShardedRef
        if module.split(".")[0] in _FOREIGN_ROOTS:
            raise pickle.UnpicklingError(
                f"checkpoint meta holds {module}.{name}, a class of the JAX "
                "stack that the port cannot load"
            )
        return super().find_class(module, name)


def dumps_meta(obj: Any) -> bytes:
    """Pickles a meta skeleton (or a header holding one) for the wire."""
    out = io.BytesIO()
    _MetaPickler(out, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return out.getvalue()


def loads_meta(data: bytes) -> Any:
    """Reads what :func:`dumps_meta` of either package wrote."""
    return _MetaUnpickler(io.BytesIO(data)).load()


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
                if dst is not None and copy_into(dst, arr):
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
    blob = dumps_meta(meta)
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
    meta = loads_meta(_read_exact(fileobj, meta_len))
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
