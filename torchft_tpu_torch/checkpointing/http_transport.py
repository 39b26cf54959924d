"""HTTP checkpoint transport (reference: torchft/checkpointing/http_transport.py:39-299).

Each rank runs a threading HTTP server serving
``/checkpoint/{step}/full``, ``/checkpoint/{step}/metadata`` and
``/checkpoint/{step}/chunk_{i}``; the state dict is staged as host numpy
copies and fenced by an RWLock so a send can't observe a mid-mutation state
dict. Receivers fetch the full stream or N chunks in parallel threads and
reassemble. ``metadata()`` is the server URL.
"""

from __future__ import annotations

import pickle
import time

import numpy as np
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, List, Optional

from torchft_tpu_torch import chaos as _chaos
from torchft_tpu_torch.checkpointing._rwlock import RWLock
from torchft_tpu_torch.telemetry import get_event_log, timed, timeit
from torchft_tpu_torch.checkpointing._serialization import (
    _LEN,
    _read_exact,
    collect_refs,
    join_state,
    split_state,
)
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport


def _array_leaf_ids(obj: Any) -> set:
    """ids of every numpy array leaf in the caller's LIVE state dict —
    the set a staged buffer must not alias while peers fetch."""
    out: set = set()

    def walk(x: Any) -> None:
        if isinstance(x, np.ndarray):
            out.add(id(x))
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(obj)
    return out


def _raw_view(arr: Any) -> memoryview:
    """Byte view of a staged buffer; ml_dtypes (bfloat16/fp8) sit outside
    the buffer protocol and go through a uint8 reinterpret."""
    a = np.ascontiguousarray(arr)
    try:
        return memoryview(a).cast("B")
    except ValueError:
        return memoryview(a.view(np.uint8)).cast("B")


class _State:
    def __init__(self) -> None:
        self.lock = RWLock(timeout=60.0)
        self.step: Optional[int] = None
        self.meta: Any = None
        self.buffers: List[Any] = []
        self.num_chunks: int = 0


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt: str, *args: Any) -> None:  # silence
        pass

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        state: _State = self.server.ckpt_state  # type: ignore[attr-defined]
        parts = self.path.strip("/").split("/")
        # /checkpoint/{step}/{what}
        if len(parts) != 3 or parts[0] != "checkpoint":
            self.send_error(404, "unknown path")
            return
        try:
            step = int(parts[1])
        except ValueError:
            self.send_error(400, "bad step")
            return
        what = parts[2]
        t_lock0 = time.monotonic()
        if not state.lock.acquire_read(timeout=30.0):
            self.send_error(503, "checkpoint busy")
            return
        lock_s = time.monotonic() - t_lock0
        try:
            if state.step != step:
                self.send_error(
                    404, f"checkpoint for step {step} not available "
                         f"(serving {state.step})"
                )
                return
            # Seeded truncation fault: the stream stops partway through a
            # record, modelling a sender dying mid-transfer. The receiver
            # must surface EOFError, not hand back a torn state dict.
            trunc = _chaos.maybe(
                "ckpt_truncate", "heal", f"ckpt:{what}", match=str(step)
            )
            if what == "metadata":
                body = pickle.dumps({"num_chunks": state.num_chunks})
                self._respond_small(body)
            elif what == "full":
                # STREAMED: header pickle + each raw buffer written
                # straight to the socket as length-prefixed records — the
                # server never builds a payload-sized pickle blob (a 12 GB
                # state would otherwise spike to 2x its size per request).
                assigned = list(range(len(state.buffers)))
                stats = self._respond_stream(
                    state.meta,
                    assigned,
                    state.buffers,
                    truncate_frac=trunc.frac if trunc else None,
                )
                self._emit_xfer(step, what, lock_s, stats)
            elif what.startswith("chunk_"):
                idx = int(what[len("chunk_"):])
                if state.num_chunks == 0 or idx >= state.num_chunks:
                    self.send_error(404, "no such chunk")
                    return
                # Round-robin buffer split (reference: values[i::num_chunks],
                # http_transport.py:288-299); chunk 0 carries the meta skeleton.
                assigned = list(range(idx, len(state.buffers), state.num_chunks))
                stats = self._respond_stream(
                    state.meta if idx == 0 else None,
                    assigned,
                    state.buffers,
                    truncate_frac=trunc.frac if trunc else None,
                )
                self._emit_xfer(step, what, lock_s, stats)
            else:
                self.send_error(404, "unknown resource")
                return
        except OSError:
            # BrokenPipe/ConnectionReset from a receiver that died or was
            # chaos-reset mid-fetch: its manager latches the error; the
            # serving side just drops the connection.
            pass
        finally:
            state.lock.release_read()

    def _respond_small(self, body: bytes) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _emit_xfer(
        self, step: int, what: str, lock_s: float, stats: dict
    ) -> None:
        """Donor-side heal transfer accounting: one ``heal_xfer`` per
        served payload request, splitting the serve wall into lock-wait
        (RWLock read acquire), serialization (header pickle + raw views)
        and wire (socket writes)."""
        log = get_event_log()
        if log is None:
            return
        log.emit(
            "heal_xfer",
            step=step,
            transport="http",
            dir="send",
            what=what,
            nbytes=int(stats["nbytes"]),
            elapsed_s=lock_s + stats["ser_s"] + stats["wire_s"],
            wire_s=stats["wire_s"],
            ser_s=stats["ser_s"],
            lock_s=lock_s,
            retries=0,
            truncated=stats["truncated"],
        )

    def _respond_stream(
        self,
        meta: Any,
        assigned: List[int],
        buffers: List[Any],
        truncate_frac: Optional[float] = None,
    ) -> None:
        """Length-prefixed record stream: pickle({"meta", "indices"}),
        then each assigned buffer's raw bytes.  The exact Content-Length
        is computable without materializing anything payload-sized, so
        peak server memory per request is one small header.

        ``truncate_frac`` (chaos ``ckpt_truncate``) stops the stream after
        that fraction of the payload bytes — mid-record, with the full
        Content-Length already advertised — and force-closes the
        connection so the receiver sees a short read, not a clean end.

        Returns ``{nbytes, ser_s, wire_s, truncated}`` for the caller's
        ``heal_xfer`` accounting (bytes actually written; serialization =
        header pickle + raw-view construction; wire = socket writes)."""
        t_ser0 = time.monotonic()
        header = pickle.dumps(
            {"meta": meta, "indices": assigned},
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        views = [_raw_view(buffers[i]) for i in assigned]
        ser_s = time.monotonic() - t_ser0
        total = 8 + len(header) + sum(8 + v.nbytes for v in views)
        t_wire0 = time.monotonic()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(total))
        self.end_headers()
        self.wfile.write(_LEN.pack(len(header)))
        self.wfile.write(header)
        payload = sum(v.nbytes for v in views)
        budget = (
            int(payload * truncate_frac) if truncate_frac is not None else -1
        )
        sent = 0
        for v in views:
            self.wfile.write(_LEN.pack(v.nbytes))
            if budget >= 0 and v.nbytes > budget:
                self.wfile.write(v[:budget])
                self.wfile.flush()
                self.close_connection = True
                sent += budget
                return {
                    "nbytes": sent, "ser_s": ser_s,
                    "wire_s": time.monotonic() - t_wire0, "truncated": True,
                }
            self.wfile.write(v)
            sent += v.nbytes
            if budget >= 0:
                budget -= v.nbytes
        return {
            "nbytes": sent, "ser_s": ser_s,
            "wire_s": time.monotonic() - t_wire0, "truncated": False,
        }


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class HTTPTransport(CheckpointTransport):
    def __init__(self, timeout: float = 60.0, num_chunks: int = 0,
                 port: int = 0) -> None:
        self._timeout = timeout
        self._state = _State()
        self._state.num_chunks = num_chunks
        self._server = _HTTPServer(("0.0.0.0", port), _Handler)
        self._server.ckpt_state = self._state  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="ckpt-http", daemon=True
        )
        self._thread.start()
        self._port = self._server.server_address[1]

    def metadata(self) -> str:
        from torchft_tpu_torch.coordination import advertise_host

        return f"http://{advertise_host()}:{self._port}"

    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: Any, timeout: float
    ) -> None:
        # Stage host copies under the write lock, then publish the step
        # (reference: CPU copy on a side stream + allow_checkpoint,
        # http_transport.py:220-242). The copy is required: split_state
        # aliases contiguous numpy inputs, and the optimizer mutates those
        # same arrays while peers are still fetching.
        # Wall-time logged like the reference's _timeit (http_transport.py:31-36).
        with timeit("torchft::http_transport::stage_checkpoint") as t_stage:
            live_ids = _array_leaf_ids(state_dict)
            meta, buffers = split_state(state_dict)
            # Copy ONLY buffers that may alias memory the trainer can
            # mutate or free: the caller's live numpy leaves
            # (split_state's ascontiguousarray returns contiguous numpy
            # inputs as-is) and any non-owning view (.numpy() of a CPU
            # tensor is zero-copy over memory the trainer keeps updating).
            # A CUDA train state's buffers are real host pulls (owndata),
            # so it stages with zero extra payload-sized copies.
            buffers = [
                np.array(b, copy=True)
                if (id(b) in live_ids or not b.flags.owndata)
                else b
                for b in buffers
            ]
        t_lock0 = time.monotonic()
        with self._state.lock.w_lock(timeout):
            lock_s = time.monotonic() - t_lock0
            self._state.meta = meta
            self._state.buffers = buffers
            self._state.step = step
        log = get_event_log()
        if log is not None:
            nbytes = int(sum(b.nbytes for b in buffers))
            log.emit(
                "ckpt_send",
                step=step,
                transport="http",
                dst_ranks=list(dst_ranks),
                nbytes=nbytes,
            )
            # Staging accounting: ser = host copy/split under no lock,
            # lock = write-lock wait against in-flight peer fetches. The
            # wire time lands in the server handler's dir="send" events.
            log.emit(
                "heal_xfer",
                step=step,
                transport="http",
                dir="stage",
                nbytes=nbytes,
                elapsed_s=t_stage["elapsed_s"] + lock_s,
                wire_s=0.0,
                ser_s=t_stage["elapsed_s"],
                lock_s=lock_s,
                retries=0,
            )

    def disallow_checkpoint(self) -> None:
        with self._state.lock.w_lock(self._timeout):
            self._state.step = None
            self._state.meta = None
            self._state.buffers = []

    @timed("torchft::http_transport::recv_checkpoint")
    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: float
    ) -> Any:
        base = metadata.rstrip("/")
        info = pickle.loads(
            self._fetch(f"{base}/checkpoint/{step}/metadata", timeout)
        )
        num_chunks = info["num_chunks"]
        if num_chunks <= 1:
            meta, parts, stats = self._fetch_records(
                f"{base}/checkpoint/{step}/full", timeout
            )
            chunk_stats = [stats]
        else:
            # Parallel chunk fetch (reference: http_transport.py:244-267).
            with ThreadPoolExecutor(max_workers=num_chunks) as pool:
                chunks = list(
                    pool.map(
                        lambda i: self._fetch_records(
                            f"{base}/checkpoint/{step}/chunk_{i}", timeout
                        ),
                        range(num_chunks),
                    )
                )
            meta = next(m for m, _, _ in chunks if m is not None)
            parts = {}
            chunk_stats = []
            for _, p, s in chunks:
                parts.update(p)
                chunk_stats.append(s)
        # Raw record bytes -> typed flat arrays via the meta's refs
        # (frombuffer: no second copy).
        t_ser0 = time.monotonic()
        refs = collect_refs(meta)
        buffers: List[Optional[Any]] = [None] * len(refs)
        nbytes = 0
        for ref in refs:
            raw = parts.pop(ref.index)
            nbytes += len(raw)
            buffers[ref.index] = np.frombuffer(
                raw, dtype=np.dtype(ref.dtype)
            )
        rebuild_ser_s = time.monotonic() - t_ser0
        log = get_event_log()
        if log is not None:
            log.emit(
                "ckpt_recv",
                step=step,
                transport="http",
                peer=src_rank,
                nbytes=int(nbytes),
            )
            # Receiver-side heal transfer accounting: wall = first fetch
            # start -> now (the chunk fetches overlap in threads, so their
            # elapsed sums would double-count); wire/ser sum over chunks.
            t0 = min(s["t0"] for s in chunk_stats)
            log.emit(
                "heal_xfer",
                step=step,
                transport="http",
                dir="recv",
                peer=src_rank,
                nbytes=int(nbytes),
                elapsed_s=time.monotonic() - t0,
                wire_s=sum(s["wire_s"] for s in chunk_stats),
                ser_s=rebuild_ser_s + sum(s["ser_s"] for s in chunk_stats),
                lock_s=0.0,
                retries=sum(s["retries"] for s in chunk_stats),
                chunks=[
                    {
                        "i": i,
                        "nbytes": int(s["nbytes"]),
                        "elapsed_s": s["elapsed_s"],
                        "wire_s": s["wire_s"],
                        "retries": s["retries"],
                    }
                    for i, s in enumerate(chunk_stats[:16])
                ],
            )
        return join_state(meta, buffers)

    @staticmethod
    def _fetch_records(url: str, timeout: float):
        """Fetches one streamed response: pickle({"meta","indices"})
        header, then each buffer's raw bytes, read record-by-record off
        the socket (no payload-sized intermediate).  Same bounded 404
        retry as _fetch (sender staging can race the receiver's plan).

        Returns ``(meta, parts, stats)`` where stats carries the
        per-chunk ``heal_xfer`` accounting: wall window, wire time
        (socket reads), deserialize time (header unpickle), bytes, and
        the 404-poll retry count."""
        _chaos.maybe_stall("heal", "ckpt:fetch", match=url)
        deadline = time.monotonic() + timeout
        retries = 0
        while True:
            try:
                t0 = time.monotonic()
                wire_s = ser_s = 0.0
                nbytes = 0
                with urllib.request.urlopen(url, timeout=timeout) as resp:
                    t_r0 = time.monotonic()
                    hraw = _read_exact(resp, 8)
                    hlen = _LEN.unpack(hraw)[0]
                    hbody = _read_exact(resp, hlen)
                    wire_s += time.monotonic() - t_r0
                    t_s0 = time.monotonic()
                    header = pickle.loads(hbody)
                    ser_s += time.monotonic() - t_s0
                    parts = {}
                    for idx in header["indices"]:
                        t_r0 = time.monotonic()
                        blen = _LEN.unpack(_read_exact(resp, 8))[0]
                        # Into a WRITABLE bytearray: healed arrays get
                        # mutated in place by training (frombuffer over
                        # bytes would be read-only).
                        buf = bytearray(blen)
                        view = memoryview(buf)
                        got = 0
                        while got < blen:
                            n = resp.readinto(view[got:])
                            if not n:
                                raise EOFError("stream ended mid-record")
                            got += n
                        wire_s += time.monotonic() - t_r0
                        nbytes += blen
                        parts[idx] = buf
                    stats = {
                        "t0": t0,
                        "elapsed_s": time.monotonic() - t0,
                        "wire_s": wire_s,
                        "ser_s": ser_s,
                        "nbytes": nbytes,
                        "retries": retries,
                    }
                    return header["meta"], parts, stats
            except urllib.error.HTTPError as e:
                if e.code != 404 or time.monotonic() >= deadline:
                    raise
                retries += 1
                time.sleep(0.05)

    @staticmethod
    def _fetch(url: str, timeout: float) -> bytes:
        """GET with bounded retry on 404: sender and receiver learn the
        recovery plan from the same quorum result concurrently, so the
        receiver's first fetch can legitimately race the sender's
        ``allow_checkpoint`` staging — poll until the step is served or the
        deadline passes."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                with urllib.request.urlopen(url, timeout=timeout) as resp:
                    return resp.read()
            except urllib.error.HTTPError as e:
                if e.code != 404 or time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)

    def shutdown(self, wait: bool = True) -> None:
        self._server.shutdown()
        self._server.server_close()
