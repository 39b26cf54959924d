"""Checkpoint transport over process-group send/recv (reference:
torchft/checkpointing/pg_transport.py:163-300; the twin of the JAX
package's ``checkpointing/pg_transport.py``, with the same tags, events and
arguments).

Sends the pickled meta skeleton first, then each raw array buffer as its own
message (no bulk pickling), allowing the receiver to write **in place** into
an existing same-shape host state dict: the allocation-free path that
matters for multi-GB heal time. It rides the same sockets as the
replica-axis collectives.

With ``sharded=True`` the state's tensors stay on their devices end to end
(``checkpointing/sharded.py``): the sender pulls one leaf at a time, just
before its send, and the receiver builds each leaf as a fresh tensor on the
device of the matching leaf of ``state_dict_fn()``. The lazy send reads
the live tensors after ``Manager._manager_state_dict`` has released the
state-dict read lock. That is safe because ``Manager.fenced_state_dict``
joins the quorum, which includes this send, before it takes the write lock
for the optimizer's update.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Callable, List, Optional

import numpy as np

from torchft_tpu_torch.checkpointing._serialization import join_state, split_state
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.process_group import ProcessGroup
from torchft_tpu_torch.telemetry import get_event_log, timed


class PGTransport(CheckpointTransport):
    """Args:
    pg: the process group to send over (ranks = replica ranks).
    state_dict_fn: optional provider of a preallocated state dict to
        receive into (in-place heal; reference: pg_transport.py:230-298).
    sharded: when True, tensor leaves move as their ADDRESSABLE SHARDS
        (one per tensor) pulled leaf by leaf, and the receiver rebuilds
        each leaf directly onto the device of the structurally matching
        leaf from ``state_dict_fn()``: the DTensor-local-shard path of the
        reference (pg_transport.py:27-141). Requires ``state_dict_fn`` on
        the receiving side.
    """

    def __init__(
        self,
        pg: ProcessGroup,
        timeout: float = 60.0,
        state_dict_fn: Optional[Callable[[], Any]] = None,
        sharded: bool = False,
        delete_stale_leaves: bool = False,
    ) -> None:
        self._pg = pg
        self._timeout = timeout
        self._state_dict_fn = state_dict_fn
        self._sharded = sharded
        # Free each stale target leaf as its replacement lands (peak device
        # memory = old state + one leaf).  Only safe when the target buffers are
        # quiescent during the receive — a dedicated heal buffer qualifies;
        # a live trainer's params (still referenced by the main thread
        # until the pending state applies) do NOT.
        self._delete_stale = delete_stale_leaves

    def metadata(self) -> str:
        return "<n/a>"  # rendezvous comes from the quorum, not a URL

    @timed("torchft::pg_transport::send_checkpoint")
    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: Any, timeout: float
    ) -> None:
        if self._sharded:
            self._send_sharded_streaming(dst_ranks, step, state_dict, timeout)
            return
        t_ser0 = time.monotonic()
        meta, buffers = split_state(state_dict)
        blob = np.frombuffer(pickle.dumps(meta), dtype=np.uint8)
        ser_s = time.monotonic() - t_ser0
        wire_s = 0.0
        chunk_wire = [0.0] * len(buffers)
        for dst in dst_ranks:
            # Length-then-meta-then-buffers; tags keep steps distinct.
            t_w0 = time.monotonic()
            self._send_preamble(dst, step, blob, timeout)
            wire_s += time.monotonic() - t_w0
            for i, buf in enumerate(buffers):
                t_w0 = time.monotonic()
                self._pg.send([buf], dst, tag=f"ckpt{step}.t{i}").wait(timeout)
                dt = time.monotonic() - t_w0
                wire_s += dt
                chunk_wire[i] += dt
        log = get_event_log()
        if log is not None:
            nbytes = int(sum(b.nbytes for b in buffers))
            log.emit(
                "ckpt_send",
                step=step,
                transport="pg",
                dst_ranks=list(dst_ranks),
                nbytes=nbytes,
            )
            log.emit(
                "heal_xfer",
                step=step,
                transport="pg",
                dir="send",
                dst_ranks=list(dst_ranks),
                nbytes=nbytes,
                elapsed_s=ser_s + wire_s,
                wire_s=wire_s,
                ser_s=ser_s,
                lock_s=0.0,
                retries=0,
                chunks=[
                    {"i": i, "nbytes": int(b.nbytes), "wire_s": chunk_wire[i]}
                    for i, b in enumerate(buffers[:16])
                ],
            )

    def _send_preamble(
        self, dst: int, step: int, blob: np.ndarray, timeout: float
    ) -> None:
        """The wire preamble both send paths share: meta length, then the
        pickled meta skeleton."""
        self._pg.send([np.array([len(blob)], dtype=np.int64)],
                      dst, tag=f"ckpt{step}.len").wait(timeout)
        self._pg.send([blob], dst, tag=f"ckpt{step}.meta").wait(timeout)

    def _send_sharded_streaming(
        self, dst_ranks: List[int], step: int, state_dict: Any, timeout: float
    ) -> None:
        """Streams shard buffers: each device->host pull happens just
        before its wire send, with a 1-deep prefetch so the next pull
        overlaps the current send.  Peak host memory is O(two shards)
        instead of the whole state: a 32 GB heal must not need 32 GB of
        sender host RAM (the eager reference path stages a full CPU copy)."""
        from concurrent.futures import ThreadPoolExecutor

        from torchft_tpu_torch.checkpointing.sharded import (
            split_state_sharded_lazy,
        )

        pull_stats: List[dict] = []
        meta, thunks = split_state_sharded_lazy(state_dict, stats=pull_stats)
        blob = np.frombuffer(pickle.dumps(meta), dtype=np.uint8)
        wire_s = 0.0
        chunk_wire = [0.0] * len(thunks)
        for dst in dst_ranks:
            t_w0 = time.monotonic()
            self._send_preamble(dst, step, blob, timeout)
            wire_s += time.monotonic() - t_w0
        # Each shard is pulled device->host ONCE and sent to every dst
        # before its host copy is released (a multi-dst heal must not
        # re-pull the whole state per destination).  No per-dst failure
        # isolation on purpose: a dead member latches the socket PG
        # group-wide (every conn/send fails, not just the dead dst's), so
        # the correct recovery is the manager's — raise, latch the error,
        # fail the commit, and let the next quorum reconfigure without
        # the dead replica and re-run the heal.
        with ThreadPoolExecutor(max_workers=1) as prefetch:
            pending = None
            for i, thunk in enumerate(thunks):
                buf = pending.result() if pending is not None else thunk()
                if i + 1 < len(thunks):
                    pending = prefetch.submit(thunks[i + 1])
                else:
                    pending = None
                for dst in dst_ranks:
                    t_w0 = time.monotonic()
                    self._pg.send(
                        [buf], dst, tag=f"ckpt{step}.t{i}"
                    ).wait(timeout)
                    dt = time.monotonic() - t_w0
                    wire_s += dt
                    chunk_wire[i] += dt
                del buf  # release the host copy before the next pull
        log = get_event_log()
        if log is not None:
            # Per-stripe accounting: ser = device->host shard pulls (the
            # lazy thunks self-report), wire = socket send waits. The
            # 1-deep prefetch overlaps them, so elapsed <= ser + wire.
            by_i = {s["i"]: s for s in pull_stats}
            nbytes = int(sum(s["nbytes"] for s in pull_stats))
            log.emit(
                "heal_xfer",
                step=step,
                transport="pg",
                dir="send",
                sharded=True,
                dst_ranks=list(dst_ranks),
                nbytes=nbytes,
                elapsed_s=wire_s + sum(s["pull_s"] for s in pull_stats),
                wire_s=wire_s,
                ser_s=sum(s["pull_s"] for s in pull_stats),
                lock_s=0.0,
                retries=0,
                chunks=[
                    {
                        "i": i,
                        "nbytes": int(by_i[i]["nbytes"]) if i in by_i else 0,
                        "wire_s": chunk_wire[i],
                        "pull_s": by_i[i]["pull_s"] if i in by_i else 0.0,
                    }
                    for i in range(min(len(thunks), 16))
                ],
            )

    @timed("torchft::pg_transport::recv_checkpoint")
    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: float
    ) -> Any:
        if self._sharded and self._state_dict_fn is None:
            # Fail BEFORE any traffic: discovering this after a multi-GB
            # transfer would waste the whole heal window.
            raise ValueError(
                "sharded PGTransport receive needs state_dict_fn to "
                "supply the destination shardings"
            )
        t_all0 = time.monotonic()
        t_w0 = time.monotonic()
        (length,) = self._pg.recv(src_rank, tag=f"ckpt{step}.len").wait(timeout)
        (blob,) = self._pg.recv(src_rank, tag=f"ckpt{step}.meta").wait(timeout)
        wire_s = time.monotonic() - t_w0
        t_s0 = time.monotonic()
        meta = pickle.loads(blob.tobytes()[: int(length[0])])
        ser_s = time.monotonic() - t_s0

        if self._sharded:
            from torchft_tpu_torch.checkpointing.sharded import (
                _ShardedRef,
                build_sharded_leaf,
                collect_ref_target_pairs,
                place_plain_leaf,
                substitute_built_leaves,
            )

            # STREAMING receive: build each leaf the moment its shard
            # buffers arrive and free the host copies, so peak host
            # memory is O(one leaf), not the whole state — the receiving
            # half of the bounded-memory heal (sender half:
            # _send_sharded_streaming).
            target = self._state_dict_fn()
            built: dict = {}
            nbytes = 0
            stripes: List[dict] = []
            for ref, t_leaf in collect_ref_target_pairs(meta, target):
                if isinstance(ref, _ShardedRef):
                    bufs = []
                    t_w0 = time.monotonic()
                    leaf_bytes = 0
                    for k in range(len(ref.shapes)):
                        (buf,) = self._pg.recv(
                            src_rank, tag=f"ckpt{step}.t{ref.first + k}"
                        ).wait(timeout)
                        leaf_bytes += int(buf.nbytes)
                        bufs.append(buf.reshape(-1))
                    leaf_wire = time.monotonic() - t_w0
                    t_b0 = time.monotonic()
                    built[ref.first] = build_sharded_leaf(
                        ref, bufs, t_leaf,
                        delete_target_leaf=self._delete_stale,
                    )
                    leaf_build = time.monotonic() - t_b0
                    del bufs  # host copies released leaf-by-leaf
                else:
                    t_w0 = time.monotonic()
                    (buf,) = self._pg.recv(
                        src_rank, tag=f"ckpt{step}.t{ref.index}"
                    ).wait(timeout)
                    leaf_bytes = int(buf.nbytes)
                    leaf_wire = time.monotonic() - t_w0
                    t_b0 = time.monotonic()
                    built[ref.index] = place_plain_leaf(
                        ref, buf.reshape(-1), t_leaf
                    )
                    leaf_build = time.monotonic() - t_b0
                wire_s += leaf_wire
                ser_s += leaf_build
                nbytes += leaf_bytes
                if len(stripes) < 16:
                    stripes.append({
                        "i": getattr(ref, "first", getattr(ref, "index", 0)),
                        "nbytes": leaf_bytes,
                        "wire_s": leaf_wire,
                        "build_s": leaf_build,
                    })
            log = get_event_log()
            if log is not None:
                log.emit(
                    "ckpt_recv", step=step, transport="pg", peer=src_rank,
                    sharded=True,
                )
                log.emit(
                    "heal_xfer",
                    step=step,
                    transport="pg",
                    dir="recv",
                    sharded=True,
                    peer=src_rank,
                    nbytes=nbytes,
                    elapsed_s=time.monotonic() - t_all0,
                    wire_s=wire_s,
                    ser_s=ser_s,
                    lock_s=0.0,
                    retries=0,
                    chunks=stripes,
                )
            return substitute_built_leaves(meta, built)

        from torchft_tpu_torch.checkpointing._serialization import collect_refs

        refs = collect_refs(meta)
        buffers = [None] * len(refs)
        chunk_wire = []
        for ref in refs:
            t_w0 = time.monotonic()
            (buf,) = self._pg.recv(src_rank, tag=f"ckpt{step}.t{ref.index}").wait(
                timeout
            )
            dt = time.monotonic() - t_w0
            wire_s += dt
            if len(chunk_wire) < 16:
                chunk_wire.append({
                    "i": ref.index, "nbytes": int(buf.nbytes), "wire_s": dt,
                })
            buffers[ref.index] = buf.reshape(-1)
        nbytes = int(sum(b.nbytes for b in buffers if b is not None))
        log = get_event_log()
        if log is not None:
            log.emit(
                "ckpt_recv", step=step, transport="pg", peer=src_rank,
                nbytes=nbytes,
            )
        inplace = self._state_dict_fn() if self._state_dict_fn else None
        t_j0 = time.monotonic()
        out = join_state(meta, buffers, inplace_into=inplace)
        ser_s += time.monotonic() - t_j0
        if log is not None:
            log.emit(
                "heal_xfer",
                step=step,
                transport="pg",
                dir="recv",
                peer=src_rank,
                nbytes=nbytes,
                elapsed_s=time.monotonic() - t_all0,
                wire_s=wire_s,
                ser_s=ser_s,
                lock_s=0.0,
                retries=0,
                chunks=chunk_wire,
            )
        return out

    def disallow_checkpoint(self) -> None:
        pass  # nothing is served passively

    def shutdown(self, wait: bool = True) -> None:
        pass  # pg lifecycle is owned by the caller
