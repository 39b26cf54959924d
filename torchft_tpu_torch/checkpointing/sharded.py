"""Shard-aware checkpoint (de)serialization for device-resident state.

The twin of the JAX package's ``checkpointing/sharded.py`` (the role of the
reference's DTensor-aware PG transport, ``torchft/checkpointing/
pg_transport.py:230-298``): the unit of transfer is the **addressable
shard** of a device array, so a healing replica group never materializes
its whole state on the host. Each leaf moves device->host one at a time
(:func:`split_state_sharded_lazy`), and the receiver rebuilds each leaf on
its own device (:func:`build_sharded_leaf`).

In this package a leaf has ONE addressable shard on each rank, and its
``slot_map`` is ``[0]``:

- a torch tensor, on any device: the whole tensor, keyed by the
  whole-tensor slice, which is what JAX writes for a single-device array
  (``(("s", None, None, None),) * ndim``; ``()`` for a 0-d tensor);
- a DTensor (a parameter or AdamW moment FSDP2 shards over the group's
  ranks): its local shard, keyed by the shard's global slice in the form
  JAX writes for a device array's shard (``("s", start, stop, None)`` on a
  split dim, ``("s", None, None, None)`` on a whole one). Rank r of the
  sender sends to rank r of the receiver, which must hold the same slice.

A numpy leaf stays a plain ``_TensorRef``.

The receiver builds a FRESH tensor on the target leaf's device, in the
checkpoint's dtype (for a DTensor target, a fresh local shard wrapped with
the target's placements). It never writes into the target: the receive
runs on the manager's quorum thread while the main thread's autograd may
hold the live tensors, and the healed state applies on the main thread
(``Manager._apply_pending_state_dict``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

from torchft_tpu_torch._dtensor import is_dtensor
from torchft_tpu_torch.checkpointing._serialization import (
    _is_array,
    _is_torch_tensor,
    _TensorRef,
    _to_host,
    dtype_name,
    from_wire,
    wire_dtype,
)


@dataclass
class _ShardedRef:
    """Placeholder for a device array leaf. ``keys[k]`` is the normalized
    slice index of unique shard buffer k (what the receiver matches against
    its own leaf's shards); ``slot_map[k]`` names the buffer for the k-th
    addressable device."""

    first: int  # global buffer index of this leaf's first unique shard
    shapes: List[Tuple[int, ...]]  # per unique shard buffer
    slot_map: List[int]  # per device slot -> offset into shapes
    dtype: str
    global_shape: Tuple[int, ...]
    keys: List[Tuple]  # slice key per unique buffer


def _index_key(index: Tuple) -> Tuple:
    """Hashable form of a shard index (tuple of slices)."""
    out = []
    for s in index:
        if isinstance(s, slice):
            out.append(("s", s.start, s.stop, s.step))
        else:
            out.append(("i", s))
    return tuple(out)


def _whole_key(ndim: int) -> Tuple:
    """The shard key of a tensor's one shard: the whole-tensor slice."""
    return _index_key((slice(None),) * ndim)


def _shard_key(t: Any) -> Tuple:
    """The shard key of a leaf's one shard on this rank: a DTensor's local
    slice (a dim it holds whole as ``slice(None)``, as JAX writes it), or
    the whole-tensor slice."""
    if not is_dtensor(t):
        return _whole_key(len(t.shape))
    from torchft_tpu_torch.parallel.sharding import local_slices

    return _index_key(tuple(
        slice(None) if (s.start, s.stop) == (0, n) else s
        for s, n in zip(local_slices(t), t.shape)
    ))


def _pull(t: Any) -> np.ndarray:
    """One leaf device->host, as the contiguous wire buffer."""
    return np.ascontiguousarray(_to_host(t)[0])


def split_state_sharded_lazy(
    obj: Any,
    stats: Optional[List[dict]] = None,
) -> Tuple[Any, List]:
    """Like ``_serialization.split_state`` but each tensor leaf contributes
    one buffer per unique addressable shard (here: the tensor).

    Returns ``(meta, thunks)`` where each thunk pulls one wire buffer when
    called. Building the meta reads only shapes and dtypes; the
    device->host pulls happen thunk by thunk, so a streaming sender holds
    O(one leaf) on the host instead of the whole state.

    When ``stats`` is given, each thunk appends ``{"i", "nbytes",
    "pull_s"}`` as it runs: the per-stripe device->host accounting behind
    the transports' ``heal_xfer`` split (thunks may run on a prefetch
    thread; list appends are atomic)."""
    thunks: List = []

    def _accounted(fn, i: int):
        if stats is None:
            return fn

        def run():  # noqa: ANN202
            t0 = time.monotonic()
            buf = fn()
            stats.append({
                "i": i,
                "nbytes": int(buf.nbytes),
                "pull_s": time.monotonic() - t0,
            })
            return buf

        return run

    def walk(x: Any) -> Any:
        if _is_torch_tensor(x):
            local = x.to_local() if is_dtensor(x) else x
            first = len(thunks)
            thunks.append(_accounted(lambda t=local: _pull(t), first))
            return _ShardedRef(
                first, [tuple(local.shape)], [0], dtype_name(local),
                tuple(x.shape), [_shard_key(x)],
            )
        if _is_array(x) and not np.isscalar(x):
            arr = np.asarray(x)
            ref = _TensorRef(len(thunks), str(arr.dtype), tuple(arr.shape))
            thunks.append(_accounted(
                lambda arr=arr: np.ascontiguousarray(arr), len(thunks),
            ))
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

    return walk(obj), thunks


def split_state_sharded(obj: Any) -> Tuple[Any, List[np.ndarray]]:
    """Eager form of :func:`split_state_sharded_lazy` (all buffers
    materialized): for tests and small states."""
    meta, thunks = split_state_sharded_lazy(obj)
    return meta, [t() for t in thunks]


def build_sharded_leaf(
    m: _ShardedRef,
    bufs: List[np.ndarray],
    target_leaf: Any,
    delete_target_leaf: bool = False,
) -> Any:
    """Builds ONE leaf from its unique-shard host buffers: a fresh tensor on
    ``target_leaf``'s device, in the checkpoint's dtype (for a DTensor
    target, a fresh local shard wrapped as a DTensor with the target's
    placements). The target only names the device and the shard and is
    checked for shape; it is never written.

    ``delete_target_leaf=True`` frees the target's storage once the new
    leaf is built (peak device memory = old state + one leaf): only for a
    dedicated heal buffer that no other thread can still compute on."""
    import torch

    if target_leaf is None or not _is_torch_tensor(target_leaf):
        raise ValueError(
            "sharded leaf needs a target tensor on the destination device"
        )
    if tuple(target_leaf.shape) != tuple(m.global_shape):
        raise ValueError(
            f"target shape {tuple(target_leaf.shape)} != checkpoint "
            f"shape {tuple(m.global_shape)}"
        )
    if len(m.slot_map) != 1:
        raise ValueError(
            f"target has 1 addressable devices, checkpoint leaf has "
            f"{len(m.slot_map)} slots"
        )
    key = _shard_key(target_leaf)
    key_to_buf = {tuple(k): i for i, k in enumerate(m.keys)}
    if key not in key_to_buf:
        raise ValueError(
            f"target sharding needs slice {key} which the checkpoint "
            "does not contain (sender/receiver shardings differ)"
        )
    k = key_to_buf[key]
    buf = bufs[k]
    assert buf is not None, f"missing shard buffer {k}"
    host = buf.reshape(-1).view(wire_dtype(m.dtype)).reshape(m.shapes[k])
    leaf = from_wire(host, m.dtype)
    if not torch.is_tensor(leaf):
        if not leaf.flags.writeable:
            leaf = leaf.copy()
        leaf = torch.from_numpy(leaf)
    local = target_leaf.to_local() if is_dtensor(target_leaf) else target_leaf
    out = leaf.to(local.device, copy=leaf.device == local.device)
    if is_dtensor(target_leaf):
        from torch.distributed.tensor import DTensor

        out = DTensor.from_local(
            out, target_leaf.device_mesh, target_leaf.placements,
            shape=target_leaf.shape, stride=target_leaf.stride(),
        )
    if delete_target_leaf:
        local.untyped_storage().resize_(0)
    return out


def place_plain_leaf(
    m: _TensorRef, flat_buf: np.ndarray, target_leaf: Any
) -> Any:
    """Rebuilds one host (numpy) leaf, writing in place into a writable
    same-shape numpy ``target_leaf`` when possible (the ``join_state``
    in-place contract): shared by the batch join and the streaming
    receiver."""
    arr = flat_buf.reshape(m.shape)
    if (
        target_leaf is not None
        and isinstance(target_leaf, np.ndarray)
        and target_leaf.shape == arr.shape
        and target_leaf.flags.writeable
    ):
        np.copyto(target_leaf, arr.astype(target_leaf.dtype, copy=False))
        return target_leaf
    return from_wire(arr, m.dtype)


def collect_ref_target_pairs(
    meta: Any, target: Optional[Any]
) -> List[Tuple[Any, Any]]:
    """(ref, structurally corresponding target leaf) for every array ref,
    in buffer-index order: the walk a STREAMING receiver needs to build
    each leaf the moment its buffers arrive."""
    pairs: List[Tuple[Any, Any]] = []

    def walk(m: Any, t: Any) -> None:
        if isinstance(m, (_TensorRef, _ShardedRef)):
            pairs.append((m, t))
        elif isinstance(m, dict):
            for k, v in m.items():
                walk(v, t.get(k) if isinstance(t, dict) else None)
        elif isinstance(m, (list, tuple)):
            tt = (
                t
                if isinstance(t, (list, tuple)) and len(t) == len(m)
                else [None] * len(m)
            )
            for v, tv in zip(m, tt):
                walk(v, tv)

    walk(meta, target)
    pairs.sort(
        key=lambda p: (
            p[0].index if isinstance(p[0], _TensorRef) else p[0].first
        )
    )
    return pairs


def substitute_built_leaves(meta: Any, built: dict) -> Any:
    """Rebuilds the pytree from meta with already-built leaves, keyed by
    each ref's first buffer index."""

    def walk(m: Any) -> Any:
        if isinstance(m, _TensorRef):
            return built[m.index]
        if isinstance(m, _ShardedRef):
            return built[m.first]
        if isinstance(m, dict):
            return {k: walk(v) for k, v in m.items()}
        if isinstance(m, tuple):
            mapped = [walk(v) for v in m]
            if hasattr(m, "_fields"):
                return type(m)(*mapped)
            return tuple(mapped)
        if isinstance(m, list):
            return [walk(v) for v in m]
        return m

    return walk(meta)


def join_state_sharded(
    meta: Any,
    buffers: List[Optional[np.ndarray]],
    target: Optional[Any] = None,
    delete_target_leaves: bool = False,
) -> Any:
    """Rebuilds the pytree; each ``_ShardedRef`` leaf is built onto the
    device of the structurally corresponding leaf in ``target`` (required
    when any leaf is a tensor). With ``delete_target_leaves=True`` each
    stale target leaf's storage is freed as its replacement is built (see
    :func:`build_sharded_leaf`).

    Plain (host) leaves follow the ``join_state`` in-place contract:
    written into ``target``'s buffer when writable, else fresh."""
    refs = collect_ref_target_pairs(meta, target)
    built: dict = {}
    for ref, t in refs:
        if isinstance(ref, _ShardedRef):
            bufs = [buffers[ref.first + k] for k in range(len(ref.shapes))]
            built[ref.first] = build_sharded_leaf(
                ref, bufs, t, delete_target_leaf=delete_target_leaves
            )
        else:
            buf = buffers[ref.index]
            assert buf is not None, f"missing buffer {ref.index}"
            built[ref.index] = place_plain_leaf(ref, buf.reshape(-1), t)
    return substitute_built_leaves(meta, built)
