"""Socket helpers shared by the Python control-plane clients, the TCP store,
and the socket-based process groups.

Wire format matches the C++ side (torchft_tpu/_cpp/net.cc): frames are a
4-byte big-endian length followed by the payload (JSON for control messages,
raw bytes for tensor payloads).
"""

from __future__ import annotations

import json
import socket
import struct
import time
from typing import Any, Optional

from . import chaos as _chaos

MAX_FRAME = 1 << 30  # 1 GiB sanity cap, matches net.cc


def _chaos_armed() -> bool:
    """Fast chaos gate: two module-attribute reads when chaos is off and
    already initialised (the steady state), so the disabled hot path costs
    nothing measurable. Before the first init the slow path runs once to
    parse TORCHFT_CHAOS."""
    return _chaos._STATE is not None or not _chaos._INITED


def _chaos_io(sock: socket.socket, op: str, payload=None, timeout=None) -> None:
    """Applies a scoped chaos injection to one frame send/recv. ``stall``
    sleeps; ``reset`` closes the socket and raises; ``partial_write`` (send
    only) writes a prefix of the frame, closes, and raises — the peer sees a
    torn frame, this side sees a reset."""
    st = _chaos.active()
    ctx = _chaos._scope_ctx()
    if st is None or ctx is None:
        return
    plane, peer, match = ctx
    site = f"{op}:{peer or '?'}"
    inj = st.pick("stall", plane, site, peer=peer, match=match)
    if inj is not None:
        time.sleep(inj.ms / 1000.0)
    if payload is not None:
        # Token-bucket pacing: a fired throttle rule installs a bucket at
        # this site and every subsequent frame pays for its bytes.
        delay = st.throttle_delay(
            plane, site, len(payload), peer=peer, match=match
        )
        if delay > 0.0:
            time.sleep(delay)
    if op == "send" and payload is not None:
        inj = st.pick("partial_write", plane, site, peer=peer, match=match)
        if inj is not None:
            n = len(payload)
            cut = int(n * inj.frac)
            try:
                if timeout is not None:
                    sock.settimeout(timeout)
                sock.sendall(struct.pack(">I", n) + bytes(payload[:cut]))
            except OSError:
                pass
            sock.close()
            raise ConnectionResetError(f"[chaos] partial write: {inj}")
    inj = st.pick("reset", plane, site, peer=peer, match=match)
    if inj is not None:
        sock.close()
        raise ConnectionResetError(f"[chaos] connection reset: {inj}")


class FrameError(RuntimeError):
    pass


def set_keepalive(sock: socket.socket) -> None:
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)


def set_buffer_sizes(sock: socket.socket) -> None:
    """Multi-MB tensor frames: default 64-208KB kernel buffers force the
    sender into lockstep with the receiver's drain rate. 4MB windows keep
    the pipe full (the kernel clamps to net.core.*mem_max). MUST run before
    connect()/listen(): the receive window scale is fixed at the SYN
    handshake, and accepted sockets inherit the listener's sizes."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 << 20)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    except OSError:
        pass


def parse_addr(addr: str) -> tuple[str, int]:
    """Splits ``host:port`` (also ``[v6]:port``). A ``scheme://`` prefix and
    trailing ``/`` are accepted and stripped: the reference's
    TORCHFT_LIGHTHOUSE convention is a full URL like ``http://host:29510``
    (torchft manager.py:76-80), so both spellings must work here."""
    if "://" in addr:
        addr = addr.split("://", 1)[1]
    if not addr.startswith("["):  # keep [v6] brackets intact
        addr = addr.split("/", 1)[0]
    addr = addr.rstrip("/")
    if addr.startswith("["):
        host, _, port = addr[1:].partition("]:")
    else:
        host, _, port = addr.rpartition(":")
    if host in ("", "::", "0.0.0.0"):
        host = "127.0.0.1"
    return host, int(port)


def connect(
    addr: str, timeout: float, attempt_timeout: float = 5.0
) -> socket.socket:
    """Connects with exponential backoff retries until ``timeout`` seconds,
    mirroring the reference's net.rs connect() (100ms -> 10s, x1.5) with
    seeded full jitter on each retry sleep (chaos.backoff_jitter, mirroring
    tcp_connect_retry in _cpp/net.cc) so mass reconnects after a partition
    heal don't stampede in lockstep. ``attempt_timeout`` clamps each
    individual connect attempt — a link-policy budget: WAN links legitimately
    need more than the old hardcoded 5s, local links much less."""
    host, port = parse_addr(addr)
    if attempt_timeout <= 0:
        attempt_timeout = 5.0
    if _chaos_armed():
        st, ctx = _chaos.active(), _chaos._scope_ctx()
        if st is not None and ctx is not None:
            plane, peer, match = ctx
            inj = st.pick(
                "connect_refuse",
                plane,
                f"connect:{peer or addr}",
                peer=peer or addr,
                match=match,
            )
            if inj is not None:
                raise ConnectionRefusedError(f"[chaos] connection refused: {inj}")
    deadline = time.monotonic() + timeout
    backoff = 0.1
    attempt = 0
    jitter_key = f"{host}:{port}"
    last_err: Optional[Exception] = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(
                f"could not connect to {addr} within {timeout}s: {last_err}"
            )
        try:
            # Manual socket (not create_connection) so buffer sizes are
            # set BEFORE the handshake; getaddrinfo keeps IPv6 and
            # multi-address hostnames working.
            last_exc: Optional[OSError] = None
            for family, stype, proto, _, addr_tuple in socket.getaddrinfo(
                host, port, type=socket.SOCK_STREAM
            ):
                sock = socket.socket(family, stype, proto)
                set_buffer_sizes(sock)
                sock.settimeout(min(remaining, attempt_timeout))
                try:
                    sock.connect(addr_tuple)
                except OSError as exc:
                    sock.close()
                    last_exc = exc
                    continue
                set_keepalive(sock)
                return sock
            raise last_exc or OSError(f"no addresses for {host}")
        except OSError as e:  # noqa: PERF203
            last_err = e
            remaining = max(deadline - time.monotonic(), 0)
            cap = min(backoff, remaining)
            jittered = max(0.01, _chaos.backoff_jitter(jitter_key, attempt, cap))
            time.sleep(min(jittered, remaining))
            backoff = min(backoff * 1.5, 10.0)
            attempt += 1


def send_frame(
    sock: socket.socket,
    payload: "bytes | bytearray | memoryview",
    timeout: Optional[float] = None,
) -> None:
    if _chaos_armed():
        _chaos_io(sock, "send", payload=payload, timeout=timeout)
    if timeout is not None:
        sock.settimeout(timeout)
    n = len(payload)
    if n < 1 << 16:
        # Small frame: one syscall, one small copy.
        sock.sendall(struct.pack(">I", n) + bytes(payload))
    else:
        # Large tensor frame: never copy the payload to prepend 4 bytes.
        sock.sendall(struct.pack(">I", n))
        sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int, deadline: Optional[float]) -> bytearray:
    # Preallocated recv_into: no per-chunk allocations, no final copy. The
    # returned bytearray doubles as a WRITABLE numpy buffer downstream
    # (np.frombuffer(bytearray) is mutable), so tensor receives are
    # zero-copy end to end.
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("timed out receiving frame")
            sock.settimeout(remaining)
        r = sock.recv_into(view[got:], min(n - got, 4 << 20))
        if not r:
            raise FrameError("connection closed mid-frame")
        got += r
    return buf


def recv_frame(sock: socket.socket, timeout: Optional[float] = None) -> bytearray:
    if _chaos_armed():
        _chaos_io(sock, "recv")
    deadline = None if timeout is None else time.monotonic() + timeout
    header = _recv_exact(sock, 4, deadline)
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME:
        raise FrameError(f"frame too large: {length}")
    if _chaos_armed():
        # Throttle the receive side too, once the frame length is known —
        # an inbound WAN link is just as bandwidth-bound as the outbound one.
        st, ctx = _chaos.active(), _chaos._scope_ctx()
        if st is not None and ctx is not None:
            plane, peer, match = ctx
            delay = st.throttle_delay(
                plane, f"recv:{peer or '?'}", length, peer=peer, match=match
            )
            if delay > 0.0:
                time.sleep(delay)
    return _recv_exact(sock, length, deadline)


def send_json(sock: socket.socket, obj: Any, timeout: Optional[float] = None) -> None:
    send_frame(sock, json.dumps(obj).encode("utf-8"), timeout)


def recv_json(sock: socket.socket, timeout: Optional[float] = None) -> Any:
    return json.loads(recv_frame(sock, timeout).decode("utf-8"))


def call_json(sock: socket.socket, obj: Any, timeout: float) -> Any:
    deadline = time.monotonic() + timeout
    send_json(sock, obj, timeout)
    return recv_json(sock, max(deadline - time.monotonic(), 0.001))
