"""Reconfigurable process groups for the fault-tolerant replica axis.

Capability parity with the reference's ``torchft/process_group.py``: a
``ProcessGroup`` ABC with ``configure(store_addr, rank, world_size)`` /
``abort()`` / ``errored()`` / ``set_timeout()`` plus the collective surface
(allreduce, allgather, broadcast, reduce_scatter, alltoall, barrier,
send/recv), and the wrapper zoo (Dummy, ErrorSwallowing, Fake, Managed).

Design note: inner-axis collectives (within a replica group) are NOT here.
This layer carries only the *outer* fault-tolerant replica axis, which must
be resizable per-quorum, so it runs host-side over sockets on numpy buffers
(the wire is byte-identical to the JAX package's; torch tensors are converted
at the Manager edge, never inside the process group) (reference equivalent: Gloo/NCCL
on the replica dim, process_group.py:586-824). ``ProcessGroupSocket`` is a
full-mesh TCP backend with ring allreduce; aborting closes sockets so wedged
collectives fail fast instead of poisoning the XLA runtime (the NCCL-abort
analog, SURVEY.md hard-part #2).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import queue as queue_mod
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from torchft_tpu_torch import _net
from torchft_tpu_torch import chaos as _chaos
from torchft_tpu_torch import knobs
from torchft_tpu_torch.store import StoreClient
from torchft_tpu_torch.telemetry import (
    add_bytes,
    flight_recorder,
    get_event_log,
    observe_span,
)
from torchft_tpu_torch.work import DummyWork, ErrorWork, FutureWork, Work

import logging

logger = logging.getLogger(__name__)


class ReduceOp(enum.Enum):
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"


def _as_list(tensors: Any) -> List[np.ndarray]:
    if isinstance(tensors, (list, tuple)):
        return [np.asarray(t) for t in tensors]
    return [np.asarray(tensors)]


# -- per-peer link policy (TORCHFT_LINKS) ------------------------------------

# class -> (connect_ms, io_ms, q8). Streams always default to the engine's
# n_streams unless overridden per entry. ``wan`` turns the int8 wire codec on
# by default: a cross-region link is bandwidth-bound, so the 4x byte cut
# dominates the quantization cost.
_LINK_PRESETS: Dict[str, Tuple[int, int, bool]] = {
    "local": (2000, 0, False),
    "dcn": (5000, 0, False),
    "wan": (15000, 0, True),
}


@dataclasses.dataclass(frozen=True)
class LinkPolicy:
    """Transport budget for one peer link, by class.

    ``connect_ms`` clamps each individual dial attempt (both the python
    mesh's and the native engine's); ``io_ms`` bounds one stripe leg's
    transfer before it is declared stalled and failed over (0 = the
    collective deadline, i.e. a stall aborts); ``streams`` overrides the
    stripe count for this link (0 = engine default); ``q8`` elevates the
    wire codec to int8 blockwise when TORCHFT_PG_WIRE doesn't pin one.
    """

    cls: str = "dcn"
    connect_ms: int = 5000
    io_ms: int = 0
    streams: int = 0
    q8: bool = False


def parse_links(
    spec: Optional[str] = None,
) -> Tuple[LinkPolicy, Dict[int, LinkPolicy]]:
    """Parses TORCHFT_LINKS: ``<peer>=<class>[,k=v]...[;...]``.

    ``<peer>`` is a rank or ``*`` (the default for unlisted peers); class is
    ``local``/``dcn``/``wan``; override keys are ``connect_ms``, ``io_ms``,
    ``streams``, ``q8``. Returns ``(default, {rank: policy})``. The spec
    MUST be identical on every rank: stripe counts are negotiated nowhere —
    each side derives them from its own policy table, and the native mesh
    acceptor rejects a dialer whose count disagrees with its own.
    """
    if spec is None:
        spec = knobs.get_str("TORCHFT_LINKS")
    default = LinkPolicy()
    per_peer: Dict[int, LinkPolicy] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        peer_s, sep, rhs = entry.partition("=")
        if not sep:
            raise ValueError(f"bad TORCHFT_LINKS entry (no '='): {entry!r}")
        parts = [p.strip() for p in rhs.split(",")]
        cls = parts[0].lower()
        if cls not in _LINK_PRESETS:
            raise ValueError(
                f"bad TORCHFT_LINKS class {cls!r} in {entry!r} "
                f"(want local/dcn/wan)"
            )
        connect_ms, io_ms, q8 = _LINK_PRESETS[cls]
        streams = 0
        for kv in parts[1:]:
            k, s2, v = kv.partition("=")
            k, v = k.strip(), v.strip()
            if not s2 or not v:
                raise ValueError(
                    f"bad TORCHFT_LINKS override {kv!r} in {entry!r}"
                )
            if k == "connect_ms":
                connect_ms = int(v)
            elif k == "io_ms":
                io_ms = int(v)
            elif k == "streams":
                streams = int(v)
            elif k == "q8":
                q8 = v.lower() in ("1", "true", "yes", "on")
            else:
                raise ValueError(
                    f"unknown TORCHFT_LINKS key {k!r} in {entry!r}"
                )
        pol = LinkPolicy(
            cls=cls, connect_ms=connect_ms, io_ms=io_ms, streams=streams, q8=q8
        )
        peer_s = peer_s.strip()
        if peer_s == "*":
            default = pol
        else:
            per_peer[int(peer_s)] = pol
    return default, per_peer


class ProcessGroup:
    """ABC. All collectives return a :class:`Work`; results are the output
    arrays (reduced in place where possible)."""

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        """(Re)connects this group against a rendezvous prefix. ``store_addr``
        is ``host:port/prefix`` (reference: process_group.py:280-295); the
        Manager passes a fresh prefix per quorum id so stale members can
        never rendezvous into the new group."""
        raise NotImplementedError

    def allreduce(self, tensors: Any, op: ReduceOp = ReduceOp.SUM) -> Work:
        raise NotImplementedError

    def allgather(self, tensors: Any) -> Work:
        """Result: list over ranks, each a list of arrays."""
        raise NotImplementedError

    def broadcast(self, tensors: Any, root: int = 0) -> Work:
        raise NotImplementedError

    def reduce_scatter(self, inputs: Sequence[Any], op: ReduceOp = ReduceOp.SUM) -> Work:
        """``inputs``: one array per destination rank. Result: this rank's
        reduced shard."""
        raise NotImplementedError

    def alltoall(self, inputs: Sequence[Any]) -> Work:
        raise NotImplementedError

    def barrier(self) -> Work:
        raise NotImplementedError

    def send(self, tensors: Any, dst: int, tag: str = "") -> Work:
        raise NotImplementedError

    def recv(self, src: int, tag: str = "") -> Work:
        """Result: list of received arrays."""
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def rank(self) -> int:
        raise NotImplementedError

    def abort(self) -> None:
        """Kills in-flight work; the group is unusable until re-configure
        (reference: abort-based user-space timeouts, process_group.py:651-714)."""
        raise NotImplementedError

    def shutdown(self) -> None:
        self.abort()

    def errored(self) -> Optional[Exception]:
        """Latched async error, if any (reference: process_group.py:361-368)."""
        return None

    def set_trace_id(self, trace_id: str) -> None:
        """Step-scoped correlation id (the Manager mints one per quorum
        generation). Stamped on this group's journal events; the native
        backend additionally pushes it into the C++ engine so every
        flight record carries it."""
        self._trace_id = trace_id

    def set_timeout(self, timeout: float) -> None:
        raise NotImplementedError

    def getBackendName(self) -> str:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Socket backend
# ---------------------------------------------------------------------------


_LEN = struct.Struct(">I")


class _CollectiveAborted(RuntimeError):
    """A peer abandoned this collective (its own leg failed) and told us —
    waiting out the tag timeout would wedge the whole group's control plane
    behind one rank's data-plane stall."""


class _PeerConn:
    """One TCP connection to a peer rank with a tag-routing reader thread."""

    def __init__(
        self,
        sock: socket.socket,
        peer: int,
        policy: Optional[LinkPolicy] = None,
    ) -> None:
        # The connect/accept path may leave a short socket timeout armed; the
        # reader must block indefinitely on an IDLE connection (gaps between
        # collectives are unbounded, e.g. DiLoCo inner steps). Stall/death
        # detection belongs to recv()'s per-tag timeout, not the socket.
        sock.settimeout(None)
        self.sock = sock
        self.peer = peer
        self.policy = policy if policy is not None else LinkPolicy()
        self.send_lock = threading.Lock()
        self._queues: Dict[str, queue_mod.Queue] = {}
        self._queues_lock = threading.Lock()
        # Collective-tag prefixes this peer told us it abandoned (dies with
        # the connection at reconfigure; bounded by aborts per generation).
        self._aborted: Dict[str, str] = {}
        # Cross-plane fail-fast hook: ProcessGroupNative installs a callback
        # so an abort arriving on the python mesh can poison the native
        # engine too (whose collectives block in C, not on these queues).
        self.on_abort: Optional[Callable[[str, str], None]] = None
        self.dead: Optional[Exception] = None
        self._reader = threading.Thread(
            target=self._read_loop, name=f"pg-peer-{peer}", daemon=True
        )
        self._reader.start()

    def _queue(self, tag: str) -> queue_mod.Queue:
        with self._queues_lock:
            q = self._queues.get(tag)
            if q is None:
                q = self._queues[tag] = queue_mod.Queue()
            return q

    def _read_loop(self) -> None:
        try:
            while True:
                header = _net.recv_json(self.sock)
                payload = _net.recv_frame(self.sock)
                add_bytes("pg_wire_rx", len(payload))
                # Put under the lock so recv()'s delete-when-empty can never
                # strand a message in an unlinked queue.
                with self._queues_lock:
                    tag = header["tag"]
                    if header.get("abort"):
                        # The peer abandoned collective `tag`: fail every
                        # pending wait under it, and remember the prefix so
                        # recvs issued later fail too (same GIL ordering
                        # argument as self.dead in recv()).
                        err = _CollectiveAborted(
                            f"collective {tag!r} aborted by rank "
                            f"{self.peer}: {header.get('error', '')}"
                        )
                        self._aborted[tag] = header.get("error", "")
                        for t, q in self._queues.items():
                            if t == tag or t.startswith(tag + "."):
                                q.put(err)
                        cb = self.on_abort
                        if cb is not None:
                            cb(tag, header.get("error", ""))
                        continue
                    # Fresh data under a tombstoned tag means the peer started
                    # a NEW collective reusing it (long-lived p2p tags, e.g.
                    # the parameter server's fixed session tags). The abort
                    # belonged to the previous generation; letting it stick
                    # would fail every future collective under this tag.
                    if self._aborted:
                        for p in [
                            p
                            for p in self._aborted
                            if tag == p or tag.startswith(p + ".")
                        ]:
                            del self._aborted[p]
                    q = self._queues.get(tag)
                    if q is None:
                        q = self._queues[tag] = queue_mod.Queue()
                    q.put((header, payload))
        except Exception as e:  # noqa: BLE001 - propagate to all waiters
            self.dead = e if isinstance(e, Exception) else RuntimeError(str(e))
            with self._queues_lock:
                for q in self._queues.values():
                    q.put(self.dead)

    def send(self, tag: str, arr: np.ndarray) -> None:
        if self.dead is not None:
            raise RuntimeError(f"connection to rank {self.peer} dead: {self.dead}")
        header = {"tag": tag, "dtype": str(arr.dtype), "shape": list(arr.shape)}
        # Zero-copy: sendall consumes the array's buffer directly.
        arr_c = np.ascontiguousarray(arr)
        try:
            data = memoryview(arr_c).cast("B")
        except ValueError:
            # ml_dtypes (bfloat16, fp8) are outside the buffer protocol;
            # reinterpret as raw bytes — recv's frombuffer restores the
            # dtype from the header.
            data = memoryview(arr_c.view(np.uint8)).cast("B")
        with self.send_lock:
            # Data-plane chaos scope: stall/reset/partial_write rules fire
            # inside _net's frame I/O, attributed to (peer rank, tag).
            with _chaos.scope("data", peer=str(self.peer), match=tag):
                _net.send_json(self.sock, header)
                _net.send_frame(self.sock, data)
        # Data-plane wire accounting (payload only; the JSON header is
        # tens of bytes) — what makes the quantized codecs' byte cut
        # measurable on any backend (telemetry.byte_stats).
        add_bytes("pg_wire_tx", data.nbytes)

    def send_abort(self, tag: str, msg: str) -> None:
        """Best-effort: tell the peer we abandoned collective ``tag`` so its
        pending/future waits under it fail now instead of timing out (one
        rank's wedged tag wait otherwise holds the whole group's next
        quorum hostage — the peer can't re-register until it unblocks)."""
        try:
            with self.send_lock:
                _net.send_json(
                    self.sock, {"tag": tag, "abort": True, "error": msg}
                )
                _net.send_frame(self.sock, b"")
        except (OSError, RuntimeError):
            pass  # dead/closing conn: its reader death already fails waits

    def recv(self, tag: str, timeout: float) -> np.ndarray:
        if _chaos._STATE is not None or not _chaos._INITED:
            st = _chaos.active()
            if st is not None:
                peer = str(self.peer)
                site = f"pgrecv:{peer}"
                inj = st.pick("stall", "data", site, peer=peer, match=tag)
                if inj is not None:
                    time.sleep(inj.ms / 1000.0)
                inj = st.pick("reset", "data", site, peer=peer, match=tag)
                if inj is not None:
                    # Kill the transport; the reader thread dies and fails
                    # this (and every pending) wait through the real
                    # peer-death path.
                    self.close()
        q = self._queue(tag)
        try:
            # A message the peer delivered before dying must still be
            # consumable (FIFO: data sits ahead of any death marker).
            item = q.get_nowait()
        except queue_mod.Empty:
            # Dead-check AFTER creating the queue: the reader's death
            # broadcast only reaches queues that exist when it runs, so a
            # recv issued after the peer died would otherwise wait out the
            # full timeout on a queue nobody will ever fail (measured: a
            # SIGKILLed peer cost survivors two consecutive 30s timeout
            # rounds — the send side fails fast on self.dead, the recv side
            # silently waited). Ordering is airtight under the GIL: the
            # reader sets self.dead BEFORE its push loop takes
            # _queues_lock, and _queue() takes the same lock — either our
            # queue existed during the push (exception delivered) or it was
            # created after, in which case self.dead is already visible
            # here.
            if self.dead is not None:
                raise RuntimeError(
                    f"connection to rank {self.peer} died"
                ) from self.dead
            with self._queues_lock:  # reader inserts under the same lock
                aborted = list(self._aborted.items())
            for prefix, msg in aborted:
                if tag == prefix or tag.startswith(prefix + "."):
                    raise _CollectiveAborted(
                        f"collective {prefix!r} aborted by rank "
                        f"{self.peer}: {msg}"
                    )
            try:
                item = q.get(timeout=timeout)
            except queue_mod.Empty:
                raise TimeoutError(
                    f"timed out after {timeout}s waiting for tag {tag!r} "
                    f"from rank {self.peer}"
                ) from None
        if isinstance(item, Exception):
            # Re-queue so other waiters see it too.
            self._queue(tag).put(item)
            if isinstance(item, _CollectiveAborted):
                raise item
            raise RuntimeError(f"connection to rank {self.peer} died") from item
        header, payload = item
        # Tags are single-use per message: drop the drained queue so a long
        # stable-quorum run doesn't accumulate one dead Queue per collective.
        with self._queues_lock:
            q = self._queues.get(tag)
            if q is not None and q.empty():
                del self._queues[tag]
        # payload is a bytearray (writable buffer): frombuffer is already
        # a mutable array over it, no copy needed.
        return np.frombuffer(payload, dtype=np.dtype(header["dtype"])).reshape(
            header["shape"]
        )

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def _reduce(op: ReduceOp, acc: np.ndarray, other: np.ndarray) -> np.ndarray:
    if op in (ReduceOp.SUM, ReduceOp.AVG):
        acc += other
    elif op == ReduceOp.MAX:
        np.maximum(acc, other, out=acc)
    elif op == ReduceOp.MIN:
        np.minimum(acc, other, out=acc)
    return acc


class ProcessGroupSocket(ProcessGroup):
    """Full-mesh TCP process group (the CPU/DCN data plane for the replica
    axis; reference role: ProcessGroupGloo, process_group.py:586-648).

    Collectives execute on a single per-group executor thread (issue order =
    match order, as with any collective backend); payloads are numpy arrays.
    Ring allreduce for bandwidth-optimal large buffers.
    """

    WORK_POISONED = "process group aborted"

    def __init__(self, timeout: float = 60.0) -> None:
        self._timeout = timeout
        self._rank = -1
        self._world = 0
        # Per-peer link policies (TORCHFT_LINKS). Parsed at construction so a
        # malformed spec fails the PG build, not the first reconfigure.
        self._link_default, self._link_peers = parse_links()
        self._peers: Dict[int, _PeerConn] = {}
        self._executor: Optional[ThreadPoolExecutor] = None
        self._errored: Optional[Exception] = None
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._configure_lock = threading.Lock()
        self._trace_id = ""

    def link_policy(self, peer: int) -> LinkPolicy:
        """The effective policy for ``peer`` (its TORCHFT_LINKS entry, else
        the ``*`` default, else plain dcn)."""
        return self._link_peers.get(peer, self._link_default)

    # -- lifecycle ---------------------------------------------------------

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        _t0 = time.monotonic()
        with self._configure_lock:
            self._abort_locked()
            self._errored = None
            self._rank = rank
            self._world = world_size
            # Collective tags restart at every (re)configure: configure is a
            # quorum boundary, so all members agree on the sequence again —
            # a restarted member would otherwise never match a survivor's tags.
            with self._seq_lock:
                self._seq = 0
            if world_size == 1:
                self._executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="pg-exec"
                )
                log = get_event_log()
                if log is not None:
                    log.emit(
                        "pg_configure",
                        rank=rank,
                        world=world_size,
                        elapsed_s=time.monotonic() - _t0,
                    )
                return

            # Register every peer's link class with the chaos plane so
            # ``link:<class>``-scoped rules resolve during the mesh build
            # itself (chaos peers are rank strings on the data plane).
            for peer in range(world_size):
                if peer != rank:
                    _chaos.set_link_class(str(peer), self.link_policy(peer).cls)

            addr, _, prefix = store_addr.partition("/")
            store = StoreClient(addr, prefix=prefix, timeout=self._timeout)

            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            # Accepted sockets inherit these; must precede listen().
            _net.set_buffer_sizes(listener)
            listener.bind(("0.0.0.0", 0))
            listener.listen(world_size)
            port = listener.getsockname()[1]
            from torchft_tpu_torch.coordination import advertise_host

            store.set(f"addr_{rank}", f"{advertise_host()}:{port}")

            peers: Dict[int, _PeerConn] = {}
            try:
                # Deterministic full mesh: connect to lower ranks, accept from
                # higher ranks (avoids duplicate cross connections).
                for peer in range(rank):
                    peer_addr = store.get_str(f"addr_{peer}", timeout=self._timeout)
                    pol = self.link_policy(peer)
                    with _chaos.scope("data", peer=str(peer), match="configure"):
                        sock = _net.connect(
                            peer_addr,
                            self._timeout,
                            attempt_timeout=pol.connect_ms / 1000.0,
                        )
                    _net.send_json(sock, {"rank": rank})
                    peers[peer] = _PeerConn(sock, peer, policy=pol)
                listener.settimeout(self._timeout)
                for _ in range(world_size - rank - 1):
                    sock, _ = listener.accept()
                    _net.set_keepalive(sock)
                    hello = _net.recv_json(sock, timeout=self._timeout)
                    peers[hello["rank"]] = _PeerConn(
                        sock,
                        hello["rank"],
                        policy=self.link_policy(hello["rank"]),
                    )
            except (OSError, TimeoutError) as e:
                for c in peers.values():
                    c.close()
                log = get_event_log()
                if log is not None:
                    log.emit(
                        "pg_configure_failed",
                        rank=rank,
                        world=world_size,
                        error=str(e)[:200],
                        elapsed_s=time.monotonic() - _t0,
                    )
                raise RuntimeError(
                    f"rank {rank}: process group rendezvous failed: {e}"
                ) from e
            finally:
                listener.close()
                store.close()

            self._peers = peers
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="pg-exec"
            )
            log = get_event_log()
            if log is not None:
                log.emit(
                    "pg_configure",
                    rank=rank,
                    world=world_size,
                    elapsed_s=time.monotonic() - _t0,
                )

    def abort(self, _dump: bool = True) -> None:
        with self._configure_lock:
            if self._errored is None:
                self._errored = RuntimeError(self.WORK_POISONED)
            self._abort_locked()
        # In-flight op dump for post-mortem, gated exactly like the
        # reference's NCCL flight recorder (process_group.py:89-108).
        # Clean shutdown() passes _dump=False: teardown is not a failure.
        if _dump:
            log = get_event_log()
            if log is not None:
                log.emit(
                    "pg_abort", rank=self._rank, error=str(self._errored)[:200]
                )
            path = flight_recorder.maybe_dump_on_abort(
                f"pg abort: {self._errored}"
            )
            if path:
                logger.warning("flight recorder dumped to %s", path)

    def _abort_locked(self) -> None:
        for conn in self._peers.values():
            conn.close()
        self._peers = {}
        if self._executor is not None:
            self._executor.shutdown(wait=False, cancel_futures=True)
            self._executor = None

    def shutdown(self) -> None:
        self.abort(_dump=False)

    def errored(self) -> Optional[Exception]:
        return self._errored

    def set_timeout(self, timeout: float) -> None:
        self._timeout = timeout

    def size(self) -> int:
        return self._world

    def rank(self) -> int:
        return self._rank

    def getBackendName(self) -> str:
        return "torchft-socket"

    # -- op plumbing -------------------------------------------------------

    def _next_tag(self) -> str:
        with self._seq_lock:
            self._seq += 1
            return f"c{self._seq}"

    def _submit(
        self,
        fn: Callable[[], Any],
        op: str = "op",
        nbytes: int = 0,
        tag: Optional[str] = None,
    ) -> Work:
        executor = self._executor
        if executor is None or self._errored is not None:
            return ErrorWork(
                self._errored or RuntimeError("process group not configured")
            )
        seq = flight_recorder.record(
            op, tag=tag or "", nbytes=nbytes, rank=self._rank, world=self._world
        )

        def guarded() -> Any:
            t0 = time.monotonic()
            try:
                result = fn()
            except Exception as e:
                flight_recorder.complete(seq, error=str(e))
                self._journal_collective(
                    op, nbytes, tag, time.monotonic() - t0, ok=False
                )
                # Tell live peers we abandoned this collective so their
                # pending tag waits fail NOW: one rank wedged on a dead
                # peer's tag holds everyone else's next quorum hostage
                # (survivors can't re-register while blocked), which turned
                # one SIGKILL into back-to-back 30s timeout rounds before
                # this (HEAL_DRILL_r05 sigkill_control). TimeoutError is
                # exempt: a per-tag timeout can be a handled, retryable
                # event (the parameter server's idle keepalive recv), not
                # proof the collective is doomed — the peers' own timeouts
                # still bound them.
                if tag is not None and not isinstance(e, TimeoutError):
                    self._broadcast_abort(tag, e)
                if self._errored is None:
                    self._errored = e
                raise
            flight_recorder.complete(seq)
            self._journal_collective(
                op, nbytes, tag, time.monotonic() - t0, ok=True
            )
            return result

        try:
            return FutureWork(executor.submit(guarded))
        except RuntimeError as e:  # executor shut down concurrently
            flight_recorder.complete(seq, error=f"never ran: {e}")
            return ErrorWork(e)

    def _broadcast_abort(self, tag: str, exc: Exception) -> None:
        """Best-effort abort fan-out to every live peer connection."""
        for conn in list(self._peers.values()):
            conn.send_abort(tag, str(exc))

    def _journal_collective(
        self, op: str, nbytes: int, tag: Optional[str], dt: float, ok: bool
    ) -> None:
        """One journal line + one span sample per completed collective,
        IDENTICAL across backends (socket and native both route through
        _submit), so journals from differently-configured replicas can be
        diffed byte-for-byte per tag. No-ops beyond a span add unless the
        journal is enabled."""
        observe_span(f"pg::{self.getBackendName()}::{op}", dt)
        log = get_event_log()
        if log is not None:
            log.emit(
                "pg_collective",
                trace=self._trace_id or None,
                backend=self.getBackendName(),
                op=op,
                nbytes=int(nbytes),
                tag=tag or "",
                elapsed_s=dt,
                ok=ok,
            )

    # -- collectives -------------------------------------------------------

    def allreduce(self, tensors: Any, op: ReduceOp = ReduceOp.SUM) -> Work:
        arrays = _as_list(tensors)
        tag = self._next_tag()
        return self._submit(
            lambda: self._allreduce(arrays, op, tag),
            op="allreduce",
            nbytes=sum(a.nbytes for a in arrays),
            tag=tag,
        )

    def _allreduce(
        self, arrays: List[np.ndarray], op: ReduceOp, tag: str
    ) -> List[np.ndarray]:
        ws = self._world
        if ws > 1:
            for i, arr in enumerate(arrays):
                self._ring_allreduce_flat(arr, op, f"{tag}.{i}")
        if op == ReduceOp.AVG:
            for arr in arrays:
                arr /= ws
        return arrays

    def _ring_allreduce_flat(self, arr: np.ndarray, op: ReduceOp, tag: str) -> None:
        """Bandwidth-optimal ring: reduce-scatter then allgather over flat
        chunks; reduces in place."""
        ws, rank = self._world, self._rank
        flat = arr.reshape(-1)
        writes_through = np.shares_memory(flat, arr)
        chunks = np.array_split(flat, ws)
        right = self._peers[(rank + 1) % ws]
        left = self._peers[(rank - 1) % ws]
        # Reduce-scatter phase.
        for step in range(ws - 1):
            send_idx = (rank - step) % ws
            recv_idx = (rank - step - 1) % ws
            right.send(f"{tag}.rs{step}", chunks[send_idx])
            incoming = left.recv(f"{tag}.rs{step}", self._timeout)
            _reduce(op, chunks[recv_idx], incoming)
        # Allgather phase.
        for step in range(ws - 1):
            send_idx = (rank - step + 1) % ws
            recv_idx = (rank - step) % ws
            right.send(f"{tag}.ag{step}", chunks[send_idx])
            chunks[recv_idx][:] = left.recv(f"{tag}.ag{step}", self._timeout)
        if not writes_through:  # reshape copied (non-contiguous input)
            arr[...] = flat.reshape(arr.shape)

    def allgather(self, tensors: Any) -> Work:
        arrays = _as_list(tensors)
        tag = self._next_tag()

        def run() -> List[List[np.ndarray]]:
            out: List[Optional[List[np.ndarray]]] = [None] * self._world
            out[self._rank] = [a.copy() for a in arrays]
            for peer, conn in self._peers.items():
                for i, a in enumerate(arrays):
                    conn.send(f"{tag}.{i}", a)
            for peer, conn in self._peers.items():
                out[peer] = [
                    conn.recv(f"{tag}.{i}", self._timeout)
                    for i in range(len(arrays))
                ]
            return out  # type: ignore[return-value]

        return self._submit(
            run,
            op="allgather",
            nbytes=sum(a.nbytes for a in arrays),
            tag=tag,
        )

    def broadcast(self, tensors: Any, root: int = 0) -> Work:
        arrays = _as_list(tensors)
        tag = self._next_tag()

        def run() -> List[np.ndarray]:
            if self._rank == root:
                for conn in self._peers.values():
                    for i, a in enumerate(arrays):
                        conn.send(f"{tag}.{i}", a)
                return arrays
            conn = self._peers[root]
            for i, a in enumerate(arrays):
                received = conn.recv(f"{tag}.{i}", self._timeout)
                np.copyto(a, received.reshape(a.shape).astype(a.dtype, copy=False))
            return arrays

        return self._submit(
            run,
            op="broadcast",
            nbytes=sum(a.nbytes for a in arrays),
            tag=tag,
        )

    def reduce_scatter(
        self, inputs: Sequence[Any], op: ReduceOp = ReduceOp.SUM
    ) -> Work:
        arrays = _as_list(inputs)
        tag = self._next_tag()

        def run() -> np.ndarray:
            if len(arrays) != self._world:
                raise ValueError(
                    f"reduce_scatter needs one input per rank "
                    f"({self._world}), got {len(arrays)}"
                )
            acc = arrays[self._rank].astype(arrays[self._rank].dtype, copy=True)
            for peer, conn in self._peers.items():
                conn.send(tag, arrays[peer])
            for peer, conn in self._peers.items():
                _reduce(op, acc, conn.recv(tag, self._timeout).reshape(acc.shape))
            if op == ReduceOp.AVG:
                acc /= self._world
            return acc

        return self._submit(
            run,
            op="reduce_scatter",
            nbytes=sum(a.nbytes for a in arrays),
            tag=tag,
        )

    def alltoall(self, inputs: Sequence[Any]) -> Work:
        arrays = _as_list(inputs)
        tag = self._next_tag()

        def run() -> List[np.ndarray]:
            if len(arrays) != self._world:
                raise ValueError(
                    f"alltoall needs one input per rank ({self._world}), "
                    f"got {len(arrays)}"
                )
            out: List[Optional[np.ndarray]] = [None] * self._world
            out[self._rank] = arrays[self._rank].copy()
            for peer, conn in self._peers.items():
                conn.send(tag, arrays[peer])
            for peer, conn in self._peers.items():
                out[peer] = conn.recv(tag, self._timeout)
            return out  # type: ignore[return-value]

        return self._submit(run, op="alltoall", tag=tag)

    def barrier(self) -> Work:
        token = np.zeros(1, dtype=np.int32)
        return self.allreduce([token], ReduceOp.SUM)

    def send(self, tensors: Any, dst: int, tag: str = "") -> Work:
        arrays = _as_list(tensors)
        base = tag or self._next_tag()

        def run() -> None:
            conn = self._peers[dst]
            for i, a in enumerate(arrays):
                conn.send(f"p2p.{base}.{i}", a)

        return self._submit(run, op="send", tag=f"p2p.{base}")

    def recv(self, src: int, tag: str = "", num_tensors: int = 1) -> Work:
        base = tag or self._next_tag()

        def run() -> List[np.ndarray]:
            conn = self._peers[src]
            return [
                conn.recv(f"p2p.{base}.{i}", self._timeout)
                for i in range(num_tensors)
            ]

        return self._submit(run, op="recv", tag=f"p2p.{base}")


# ---------------------------------------------------------------------------
# Native backend
# ---------------------------------------------------------------------------


def _pack_arrays(arrays: List[np.ndarray]) -> Tuple[str, bytes]:
    """(meta_json, payload) wire form for the native allgather/broadcast:
    self-describing per-array headers plus concatenated raw bytes, the same
    dtype-string round trip as _PeerConn's JSON frame headers."""
    metas = [
        {"dtype": str(a.dtype), "shape": list(a.shape), "nbytes": int(a.nbytes)}
        for a in arrays
    ]
    payload = b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)
    return json.dumps(metas), payload


def _unpack_arrays(meta: str, data: bytearray) -> List[np.ndarray]:
    out: List[np.ndarray] = []
    off = 0
    view = memoryview(data)
    for m in json.loads(meta):
        nb = int(m["nbytes"])
        out.append(
            np.frombuffer(view[off : off + nb], dtype=np.dtype(m["dtype"]))
            .reshape(m["shape"])
        )
        off += nb
    return out


class ProcessGroupNative(ProcessGroupSocket):
    """Socket PG with the hot collectives offloaded to the C++ pipelined
    engine (``_cpp/collectives.cc`` via ``_native``): chunked ring allreduce,
    allgather and broadcast run over a dedicated striped-TCP mesh with
    receive-reduce pipelining, releasing the GIL for the whole transfer.

    Everything else — rendezvous store protocol, tag sequencing, the
    executor/Work surface, flight recorder, abort fan-out, p2p send/recv,
    reduce_scatter/alltoall — is inherited: the python mesh stays up as the
    control plane and the fallback data plane (non-native dtypes such as
    bfloat16 take the inherited ring). ``configure``/``abort``/``errored``
    semantics are identical, so Manager, DDP, DiLoCo and the wrapper zoo work
    unchanged; select it with ``TORCHFT_PG=native``.

    Wire compression: ``wire="int8"`` (or ``TORCHFT_PG_WIRE=int8``) routes
    fp32 SUM/AVG allreduces through the engine's int8 blockwise codec, which
    mirrors :mod:`torchft_tpu_torch.collectives`' quantization layout bit-for-bit.
    """

    def __init__(
        self,
        timeout: float = 60.0,
        n_streams: Optional[int] = None,
        pipeline_bytes: Optional[int] = None,
        wire: Optional[str] = None,
        fr_capacity: Optional[int] = None,
    ) -> None:
        super().__init__(timeout=timeout)
        from torchft_tpu_torch import _native

        _native._load()  # fail at construction, not first collective
        self._native = _native
        self._engine: Optional[Any] = None
        self._n_streams = int(
            n_streams
            if n_streams is not None
            else knobs.get_raw("TORCHFT_NATIVE_STREAMS")
        )
        self._pipeline_bytes = int(
            pipeline_bytes
            if pipeline_bytes is not None
            else knobs.get_raw("TORCHFT_NATIVE_PIPELINE_BYTES")
        )
        self._wire = (
            wire if wire is not None else knobs.get_str("TORCHFT_PG_WIRE")
        ).lower()
        # A q8-class link (e.g. a ``wan`` preset) elevates the wire codec
        # unless the caller or TORCHFT_PG_WIRE pinned one explicitly: the
        # 4x byte cut is the point of declaring a link bandwidth-bound.
        if (
            wire is None
            and knobs.get_raw("TORCHFT_PG_WIRE", None) is None
            and (
                self._link_default.q8
                or any(p.q8 for p in self._link_peers.values())
            )
        ):
            self._wire = "int8"
        # Engine flight-record ring size (records). 0 disables recording
        # (the always-on per-peer byte/busy counters remain); the default
        # keeps the last 256 collectives, enough to cover a full commit
        # window at a few records per step.
        self._fr_capacity = int(
            fr_capacity
            if fr_capacity is not None
            else knobs.get_raw("TORCHFT_NATIVE_FR_RING")
        )
        self._fr_last_seq = 0
        self._failover_last_seq = 0
        self._chaos_last_seq = 0

    # -- lifecycle ---------------------------------------------------------

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        engine = None
        store = None
        if world_size > 1:
            # Listen + advertise BEFORE the python-mesh rendezvous: naddr_r
            # is published ahead of addr_r on every rank, so once the socket
            # mesh is up (it reads addr_*), every naddr_* is in the store —
            # the inherited rendezvous doubles as the publication barrier.
            engine = self._native.NativeEngine(
                self._n_streams, self._pipeline_bytes, self._fr_capacity
            )
            # Push link policies BEFORE the mesh comes up (the engine
            # freezes them at connect), and mirror each peer's class into
            # both chaos planes so link:<class>-scoped rules agree.
            d = self._link_default
            engine.set_link(
                -1, d.cls, d.connect_ms, d.io_ms, d.streams, d.q8
            )
            for r, pol in sorted(self._link_peers.items()):
                if 0 <= r < world_size and r != rank:
                    engine.set_link(
                        r,
                        pol.cls,
                        pol.connect_ms,
                        pol.io_ms,
                        pol.streams,
                        pol.q8,
                    )
            for r in range(world_size):
                if r != rank:
                    self._native.chaos_set_link(
                        str(r), self.link_policy(r).cls
                    )
            try:
                port = engine.listen("0.0.0.0")
                addr, _, prefix = store_addr.partition("/")
                store = StoreClient(addr, prefix=prefix, timeout=self._timeout)
                from torchft_tpu_torch.coordination import advertise_host

                store.set(f"naddr_{rank}", f"{advertise_host()}:{port}")
            except Exception:
                engine.close()
                if store is not None:
                    store.close()
                raise
        try:
            # Also tears down the previous generation's engine via the
            # overridden _abort_locked.
            super().configure(store_addr, rank, world_size)
        except Exception:
            if engine is not None:
                engine.close()
            if store is not None:
                store.close()
            raise
        if engine is None:
            return
        try:
            peers = [
                store.get_str(f"naddr_{r}", timeout=self._timeout)
                for r in range(world_size)
            ]
            engine.connect(rank, world_size, peers, self._timeout)
        except Exception as e:
            engine.close()
            self.abort(_dump=False)
            self._errored = e
            raise RuntimeError(
                f"rank {rank}: native data plane rendezvous failed: {e}"
            ) from e
        finally:
            store.close()
        with self._configure_lock:
            self._engine = engine
            self._fr_last_seq = 0  # fresh engine, fresh record sequence
            self._failover_last_seq = 0
        if self._trace_id:
            engine.set_trace(self._trace_id)
        for conn in self._peers.values():
            conn.on_abort = self._on_peer_abort
        log = get_event_log()
        if log is not None:
            log.emit(
                "pg_native_mesh",
                rank=rank,
                world=world_size,
                streams=self._n_streams,
                wire=self._wire,
            )

    def _abort_locked(self) -> None:
        engine, self._engine = self._engine, None
        if engine is not None:
            # Drain completed flight records BEFORE aborting: the engine's
            # snapshot is safe against in-flight collectives, and the abort
            # cause lands in the in-flight record's own fr_end on the
            # worker thread — but this engine object is gone after close(),
            # so this is the last chance to journal what it saw.
            try:
                self._drain_flight_records(engine)
            except Exception:  # noqa: BLE001 - telemetry never blocks abort
                pass
            engine.abort("pg abort")
            # close() waits for in-flight native calls to drain before
            # freeing the C++ object; do that off-thread so abort/configure
            # never block behind a collective that is still unwinding.
            threading.Thread(
                target=engine.close, name="pg-native-close", daemon=True
            ).start()
        super()._abort_locked()

    def _on_peer_abort(self, tag: str, msg: str) -> None:
        # A peer abandoned a collective: our next/current native collective
        # with it can only time out, so fail it now. p2p tags are exempt —
        # they never touch the engine and can be benign/retryable (e.g. the
        # parameter server's session tags).
        if tag.startswith("p2p."):
            return
        engine = self._engine
        if engine is not None:
            engine.abort(f"collective {tag!r} aborted by a peer: {msg}")

    def getBackendName(self) -> str:
        return "torchft-native"

    # -- telemetry ---------------------------------------------------------

    def set_trace_id(self, trace_id: str) -> None:
        super().set_trace_id(trace_id)
        engine = self._engine
        if engine is not None:
            engine.set_trace(trace_id)

    def _stamp_trace(self, engine: Any, tag: str) -> None:
        """Engine flight records carry ``"<trace_id>|<collective tag>"``
        (e.g. ``q3.s17|c4``): the prefix joins the record to the step's
        control-plane journal events, the suffix to the specific
        ``pg_collective`` line. Runs on the single pg-exec thread, so the
        stamp can't race a concurrent collective's."""
        engine.set_trace(f"{self._trace_id}|{tag}" if self._trace_id else tag)

    def peer_gib_s(self) -> Dict[str, float]:
        """Effective per-peer throughput {peer rank: GiB/s} from the
        engine's always-on byte/busy counters — the live digest's ``bw``
        block. Uses a cursor-free snapshot at the current seq (counters
        only, no records), so reading it never consumes entries from the
        journal drain's incremental cursor. Empty when the engine is down
        or nothing has moved yet; cheap enough for a once-per-second
        digest build."""
        engine = self._engine
        if engine is None:
            return {}
        try:
            snap = engine.fr_snapshot(engine.fr_seq())
        except Exception:  # noqa: BLE001 - telemetry must not fail a step
            return {}
        n_streams = max(int(snap.get("n_streams", 1)), 1)
        out: Dict[str, float] = {}
        for p in snap.get("peers", []):
            busy_ns = int(p.get("tx_busy_ns", 0)) + int(p.get("rx_busy_ns", 0))
            nbytes = int(p.get("tx_bytes", 0)) + int(p.get("rx_bytes", 0))
            if busy_ns <= 0 or nbytes <= 0:
                continue
            # Lane busy-ns accumulate across n_streams parallel stripes;
            # wall time is busy/streams (same normalization obs_export
            # applies to native_counters).
            wall_s = busy_ns / n_streams / 1e9
            if wall_s > 0:
                out[str(p.get("peer", "?"))] = (
                    nbytes / float(1 << 30) / wall_s
                )
        return out

    def _drain_flight_records(self, engine: Any) -> None:
        """Moves completed engine flight records into the step-event
        journal as ``native_collective`` events (plus one
        ``native_counters`` summary for the exporter). Incremental: only
        records past the last drained seq are fetched. The snapshot RPC is
        skipped entirely when the journal is disabled, so benchmarks
        without TORCHFT_JOURNAL_* pay only the engine-side (pure C++)
        recording cost."""
        log = get_event_log()
        if log is None:
            return
        try:
            snap = engine.fr_snapshot(self._fr_last_seq)
        except Exception:  # noqa: BLE001 - telemetry must not fail a step
            return
        recs = snap.get("records", [])
        for r in recs:
            seq = int(r.get("seq", 0))
            if seq > self._fr_last_seq:
                self._fr_last_seq = seq
            tag = r.get("tag", "")
            trace, sep, ctag = tag.partition("|")
            if not sep:
                trace, ctag = "", tag
            log.emit(
                "native_collective",
                trace=trace or None,
                op=r.get("op"),
                status=r.get("status"),
                tag=ctag,
                nbytes=int(r.get("bytes", 0)),
                t_start_ns=int(r.get("t_start_ns", 0)),
                t_end_ns=int(r.get("t_end_ns", 0)),
                step_ns=r.get("step_ns", []),
                lanes=r.get("lanes", []),
                lanes_dropped=int(r.get("lanes_dropped", 0)),
                cause=r.get("cause", ""),
            )
        # Stripe failovers ride the same snapshot as a separate ring (the
        # engine keeps the last 256); the cursor is PG-side because
        # peer_gib_s() also snapshots and must not consume entries.
        for f in snap.get("failovers", []):
            seq = int(f.get("seq", 0))
            if seq <= self._failover_last_seq:
                continue
            self._failover_last_seq = seq
            tag = f.get("tag", "")
            trace, sep, ctag = tag.partition("|")
            if not sep:
                trace, ctag = "", tag
            log.emit(
                "stripe_failover",
                trace=trace or None,
                peer=int(f.get("peer", -1)),
                stripe=int(f.get("stripe", -1)),
                to_stripe=int(f.get("to_stripe", -1)),
                dir=f.get("dir", ""),
                nbytes=int(f.get("bytes", 0)),
                t_ns=int(f.get("t_ns", 0)),
                tag=ctag,
            )
        log.emit(
            "native_counters",
            trace=self._trace_id or None,
            seq=int(snap.get("seq", 0)),
            dropped=int(snap.get("dropped", 0)),
            spin_total=int(snap.get("spin_total", 0)),
            bytes_tx=int(snap.get("bytes_tx", 0)),
            bytes_rx=int(snap.get("bytes_rx", 0)),
            world=int(snap.get("world", 0)),
            n_streams=int(snap.get("n_streams", 0)),
            peers=snap.get("peers", []),
        )
        self._drain_chaos_events(log)

    def _drain_chaos_events(self, log: Any) -> None:
        """Injections fired inside libtftcollectives (the C++ chaos ring)
        land in the journal with the same ``chaos_inject`` shape the Python
        plane emits, tagged ``origin=native`` so the soak harness can merge
        both planes' sequences. The library ring is process-global (not
        per-engine), so the cursor lives on the PG, which survives engine
        generations."""
        if not self._native.chaos_armed():
            return
        try:
            snap = self._native.chaos_snapshot(self._chaos_last_seq)
        except Exception:  # noqa: BLE001 - telemetry must not fail a step
            return
        for ev in snap.get("events", []):
            seq = int(ev.get("seq", 0))
            if seq > self._chaos_last_seq:
                self._chaos_last_seq = seq
            step = int(ev.get("step", -1))
            log.emit(
                "chaos_inject",
                step=None if step < 0 else step,
                trace=self._trace_id or None,
                origin="native",
                kind=ev.get("kind"),
                plane=ev.get("plane"),
                site=ev.get("site"),
                rule=int(ev.get("rule", -1)),
                visit=int(ev.get("visit", 0)),
                seq=seq,
                ms=int(ev.get("ms", 0)),
                frac=ev.get("frac", 0.0),
                ts_ns=int(ev.get("ts_ns", 0)),
            )

    def _accounted(self, engine: Any, fn: Callable[[], None]) -> None:
        tx0, rx0 = engine.bytes_tx(), engine.bytes_rx()
        try:
            fn()
        finally:
            add_bytes("pg_wire_tx", engine.bytes_tx() - tx0)
            add_bytes("pg_wire_rx", engine.bytes_rx() - rx0)

    # -- collectives -------------------------------------------------------

    def _allreduce(
        self, arrays: List[np.ndarray], op: ReduceOp, tag: str
    ) -> List[np.ndarray]:
        engine = self._engine
        if self._world <= 1 or engine is None:
            return super()._allreduce(arrays, op, tag)
        self._stamp_trace(engine, tag)
        try:
            for i, arr in enumerate(arrays):
                if not self._native_allreduce_one(engine, arr, op):
                    # Dtype outside the engine's set (f16/bf16/fp8): the
                    # inherited python ring still carries it.
                    self._ring_allreduce_flat(arr, op, f"{tag}.{i}")
        finally:
            self._drain_flight_records(engine)
        if op == ReduceOp.AVG:
            for arr in arrays:
                arr /= self._world
        return arrays

    def _native_allreduce_one(
        self, engine: Any, arr: np.ndarray, op: ReduceOp
    ) -> bool:
        name = str(arr.dtype)
        use_q8 = (
            self._wire == "int8"
            and name == "float32"
            and op in (ReduceOp.SUM, ReduceOp.AVG)
        )
        if not use_q8 and name not in self._native.DTYPE_CODES:
            return False
        carr = np.ascontiguousarray(arr)
        flat = carr.reshape(-1)
        if use_q8:
            self._accounted(
                engine, lambda: engine.allreduce_q8(flat, self._timeout)
            )
        else:
            code = {
                ReduceOp.SUM: self._native.OP_SUM,
                ReduceOp.AVG: self._native.OP_SUM,
                ReduceOp.MAX: self._native.OP_MAX,
                ReduceOp.MIN: self._native.OP_MIN,
            }[op]
            self._accounted(
                engine, lambda: engine.allreduce(flat, code, self._timeout)
            )
        if carr is not arr:  # non-contiguous input: write the copy back
            arr[...] = flat.reshape(arr.shape)
        return True

    def allgather(self, tensors: Any) -> Work:
        arrays = _as_list(tensors)
        engine = self._engine
        if self._world <= 1 or engine is None:
            return super().allgather(tensors)
        tag = self._next_tag()

        def run() -> List[List[np.ndarray]]:
            meta, payload = _pack_arrays(arrays)
            self._stamp_trace(engine, tag)
            try:
                self._accounted(
                    engine,
                    lambda: engine.allgather(meta, payload, self._timeout),
                )
            finally:
                self._drain_flight_records(engine)
            out: List[Optional[List[np.ndarray]]] = [None] * self._world
            out[self._rank] = [a.copy() for a in arrays]
            for p in range(self._world):
                if p == self._rank:
                    continue
                pmeta, pdata = engine.result(p)
                out[p] = _unpack_arrays(pmeta, pdata)
            return out  # type: ignore[return-value]

        return self._submit(
            run,
            op="allgather",
            nbytes=sum(a.nbytes for a in arrays),
            tag=tag,
        )

    def broadcast(self, tensors: Any, root: int = 0) -> Work:
        arrays = _as_list(tensors)
        engine = self._engine
        if self._world <= 1 or engine is None:
            return super().broadcast(tensors, root)
        tag = self._next_tag()

        def run() -> List[np.ndarray]:
            self._stamp_trace(engine, tag)
            if self._rank == root:
                meta, payload = _pack_arrays(arrays)
                try:
                    self._accounted(
                        engine,
                        lambda: engine.broadcast(
                            meta, payload, root, self._timeout
                        ),
                    )
                finally:
                    self._drain_flight_records(engine)
                return arrays
            try:
                self._accounted(
                    engine,
                    lambda: engine.broadcast("", b"", root, self._timeout),
                )
            finally:
                self._drain_flight_records(engine)
            pmeta, pdata = engine.result(root)
            received = _unpack_arrays(pmeta, pdata)
            if len(received) != len(arrays):
                raise RuntimeError(
                    f"broadcast arity mismatch: root sent {len(received)} "
                    f"arrays, expected {len(arrays)}"
                )
            for a, r in zip(arrays, received):
                np.copyto(a, r.reshape(a.shape).astype(a.dtype, copy=False))
            return arrays

        return self._submit(
            run,
            op="broadcast",
            nbytes=sum(a.nbytes for a in arrays),
            tag=tag,
        )


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


class ProcessGroupDummy(ProcessGroup):
    """World-size-1 no-op group (reference: process_group.py:938-1057): inputs
    pass through unchanged; every op completes immediately. Soaks up
    init-time collectives and serves as a test double."""

    def __init__(self, rank: int = 0, world: int = 1) -> None:
        self._rank = rank
        self._world = world
        self.configure_count = 0

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self.configure_count += 1
        self._rank = rank
        self._world = world_size

    def allreduce(self, tensors: Any, op: ReduceOp = ReduceOp.SUM) -> Work:
        return DummyWork(_as_list(tensors))

    def allgather(self, tensors: Any) -> Work:
        return DummyWork([_as_list(tensors)])

    def broadcast(self, tensors: Any, root: int = 0) -> Work:
        return DummyWork(_as_list(tensors))

    def reduce_scatter(self, inputs: Sequence[Any], op: ReduceOp = ReduceOp.SUM) -> Work:
        return DummyWork(_as_list(inputs)[0])

    def alltoall(self, inputs: Sequence[Any]) -> Work:
        return DummyWork(_as_list(inputs))

    def barrier(self) -> Work:
        return DummyWork(None)

    def send(self, tensors: Any, dst: int, tag: str = "") -> Work:
        return DummyWork(None)

    def recv(self, src: int, tag: str = "") -> Work:
        return DummyWork([])

    def size(self) -> int:
        return self._world

    def rank(self) -> int:
        return self._rank

    def abort(self) -> None:
        pass

    def set_timeout(self, timeout: float) -> None:
        pass

    def getBackendName(self) -> str:
        return "torchft-dummy"


class _ErrorSwallowingWork(Work):
    """Wraps inner work; converts failures into a default result and reports
    them to the wrapper (reference: _ErrorSwallowingWork)."""

    def __init__(
        self, wrapper: "ErrorSwallowingProcessGroupWrapper", inner: Work, default: Any
    ) -> None:
        self._wrapper = wrapper
        self._inner = inner
        self._default = default

    def wait(self, timeout: Optional[float] = None) -> Any:
        try:
            return self._inner.wait(timeout)
        except Exception as e:  # noqa: BLE001
            self._wrapper.report_error(e)
            return self._default

    def done(self) -> bool:
        return self._inner.done()

    def exception(self) -> Optional[BaseException]:
        return None  # swallowed

    def add_done_callback(self, fn: Callable[[Work], None]) -> None:
        self._inner.add_done_callback(lambda _w: fn(self))


class ErrorSwallowingProcessGroupWrapper:
    """After the first error, collectives become no-ops until ``configure``
    resets (reference: process_group.py:1060-1153). Lets a training step
    finish (with garbage gradients that won't be committed) instead of
    crashing mid-backward.

    Deliberately not a ProcessGroup subclass: inherited concrete methods
    would shadow ``__getattr__`` delegation to the wrapped group."""

    def __init__(self, pg: ProcessGroup) -> None:
        self._pg = pg
        self._error: Optional[Exception] = None

    def error(self) -> Optional[Exception]:
        return self._error

    def report_error(self, e: Exception) -> None:
        self._error = e

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._error = None
        self._pg.configure(store_addr, rank, world_size)

    def allreduce(self, tensors: Any, op: ReduceOp = ReduceOp.SUM) -> Work:
        if self._error is not None:
            return DummyWork(_as_list(tensors))
        try:
            return _ErrorSwallowingWork(
                self, self._pg.allreduce(tensors, op), _as_list(tensors)
            )
        except Exception as e:  # noqa: BLE001
            self.report_error(e)
            return DummyWork(_as_list(tensors))

    def __getattr__(self, name: str) -> Any:
        return getattr(self._pg, name)


class FakeProcessGroupWrapper:
    """Test-only fault injector (reference: process_group.py:1156-1202):
    ``report_future_error`` makes the next collective fail; ``delay_work``
    makes it stall.

    Not a ProcessGroup subclass for the same delegation reason as
    ErrorSwallowingProcessGroupWrapper."""

    def __init__(self, pg: ProcessGroup) -> None:
        self._pg = pg
        self._next_error: Optional[Exception] = None
        self._next_delay: Optional[float] = None

    def report_future_error(self, e: Exception) -> None:
        self._next_error = e

    def delay_work(self, seconds: float) -> None:
        self._next_delay = seconds

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._pg.configure(store_addr, rank, world_size)

    def _intercept(self, make_work: Callable[[], Work]) -> Work:
        if self._next_error is not None:
            e, self._next_error = self._next_error, None
            return ErrorWork(e)
        if self._next_delay is not None:
            d, self._next_delay = self._next_delay, None
            time.sleep(d)
        return make_work()

    def allreduce(self, tensors: Any, op: ReduceOp = ReduceOp.SUM) -> Work:
        return self._intercept(lambda: self._pg.allreduce(tensors, op))

    def broadcast(self, tensors: Any, root: int = 0) -> Work:
        return self._intercept(lambda: self._pg.broadcast(tensors, root))

    def __getattr__(self, name: str) -> Any:
        return getattr(self._pg, name)


class ManagedProcessGroup(ProcessGroup):
    """PG facade whose allreduce goes through the Manager (so it participates
    in quorum/error handling) and whose size is the live participant count —
    how DDP-style code sees the FT dimension (reference:
    process_group.py:1205-1238)."""

    def __init__(self, manager: Any) -> None:
        self._manager = manager

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        raise RuntimeError("ManagedProcessGroup is configured by its Manager")

    def allreduce(self, tensors: Any, op: ReduceOp = ReduceOp.SUM) -> Work:
        return self._manager.allreduce(tensors)

    def size(self) -> int:
        return self._manager.num_participants()

    def rank(self) -> int:
        return self._manager.participating_rank() or 0

    def errored(self) -> Optional[Exception]:
        return self._manager.errored()

    def abort(self) -> None:
        pass

    def set_timeout(self, timeout: float) -> None:
        pass

    def getBackendName(self) -> str:
        return "torchft-managed"


# ---------------------------------------------------------------------------
# Backend selection
# ---------------------------------------------------------------------------


def make_process_group(timeout: float = 60.0) -> ProcessGroup:
    """Constructs the replica-axis data plane selected by ``TORCHFT_PG``:
    ``socket`` (default, pure-python mesh), ``native`` (C++ pipelined engine),
    or ``dummy`` (no-op test double). The env var — not a code change — is the
    switch so train scripts, drills and the process launcher all pick the
    backend uniformly, including across fork/spawn boundaries."""
    backend = knobs.get_str("TORCHFT_PG").strip().lower() or "socket"
    if backend == "socket":
        return ProcessGroupSocket(timeout=timeout)
    if backend == "native":
        return ProcessGroupNative(timeout=timeout)
    if backend == "dummy":
        return ProcessGroupDummy()
    raise ValueError(
        f"unknown TORCHFT_PG backend {backend!r} "
        "(expected socket, native, or dummy)"
    )
