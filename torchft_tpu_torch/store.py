"""A small TCP key-value store used for rendezvous.

Plays the role torch's ``TCPStore``/``PrefixStore`` play in the reference
(torchft/process_group.py:111-130, torchft/manager.py:271-314): every replica
group runs one store server; process groups rendezvous against unique prefixes
``{store}/torchft/{quorum_id}/{group_rank}``; the manager address is published
under a well-known key. Values are bytes; ``wait``/``get`` block until a key
exists (with timeout).

Protocol: length-prefixed JSON frames (see torchft_tpu_torch/_net.py); values are
latin-1-encoded in JSON (control-plane values are tiny).
"""

from __future__ import annotations

import socket
import socketserver
import threading
from typing import Dict, Optional

from torchft_tpu_torch import _net


class _StoreState:
    def __init__(self) -> None:
        self.data: Dict[str, str] = {}
        self.cond = threading.Condition()


class _StoreHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        state: _StoreState = self.server.state  # type: ignore[attr-defined]
        sock = self.request
        try:
            while True:
                req = _net.recv_json(sock)
                op = req.get("op")
                resp = {"ok": True}
                if op == "set":
                    with state.cond:
                        state.data[req["key"]] = req["value"]
                        state.cond.notify_all()
                elif op == "get":
                    timeout = req.get("timeout", 0.0)
                    with state.cond:
                        ok = state.cond.wait_for(
                            lambda: req["key"] in state.data, timeout=timeout
                        )
                        if ok:
                            resp["value"] = state.data[req["key"]]
                        else:
                            resp = {"ok": False, "timeout": True,
                                    "error": f"key {req['key']} not set"}
                elif op == "check":
                    with state.cond:
                        resp["exists"] = req["key"] in state.data
                elif op == "delete":
                    with state.cond:
                        resp["deleted"] = state.data.pop(req["key"], None) is not None
                elif op == "add":
                    # Atomic counter add; returns the new value.
                    with state.cond:
                        try:
                            cur = int(state.data.get(req["key"], "0"))
                            cur += int(req["amount"])
                        except ValueError as e:
                            resp = {"ok": False,
                                    "error": f"add on non-integer key "
                                             f"{req['key']!r}: {e}"}
                        else:
                            state.data[req["key"]] = str(cur)
                            state.cond.notify_all()
                            resp["value"] = str(cur)
                elif op == "list":
                    with state.cond:
                        resp["keys"] = sorted(state.data.keys())
                else:
                    resp = {"ok": False, "error": f"unknown op {op!r}"}
                _net.send_json(sock, resp)
        except (_net.FrameError, OSError):
            pass  # client disconnected


class _ThreadingTCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class TCPStoreServer:
    """In-process store server. One per replica group (hosted by group rank 0)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0) -> None:
        self._server = _ThreadingTCPServer((host, port), _StoreHandler)
        self._server.state = _StoreState()  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tcp-store", daemon=True
        )
        self._thread.start()
        self.port = self._server.server_address[1]

    def address(self) -> str:
        from torchft_tpu_torch.coordination import advertise_host

        return f"{advertise_host()}:{self.port}"

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class StoreClient:
    """Client with an optional key prefix (the ``PrefixStore`` analog)."""

    def __init__(self, addr: str, prefix: str = "", timeout: float = 60.0) -> None:
        self._addr = addr
        self._prefix = prefix
        self._timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def with_prefix(self, prefix: str) -> "StoreClient":
        joined = f"{self._prefix}/{prefix}" if self._prefix else prefix
        return StoreClient(self._addr, joined, self._timeout)

    def _key(self, key: str) -> str:
        return f"{self._prefix}/{key}" if self._prefix else key

    def _call(self, req: dict, timeout: float, retry: bool = True) -> dict:
        with self._lock:
            if self._sock is None:
                self._sock = _net.connect(self._addr, self._timeout)
            try:
                resp = _net.call_json(self._sock, req, timeout + 5.0)
            except TimeoutError:
                # Never blind-retry a timed-out request: the server may have
                # applied it (matters for non-idempotent ops like `add`).
                self.close()
                raise
            except (OSError, _net.FrameError):
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
                if not retry:
                    raise
                # One reconnect attempt (idempotent ops only).
                self._sock = _net.connect(self._addr, self._timeout)
                resp = _net.call_json(self._sock, req, timeout + 5.0)
        if not resp.get("ok", False):
            if resp.get("timeout"):
                raise TimeoutError(resp.get("error"))
            raise RuntimeError(f"store op failed: {resp.get('error')}")
        return resp

    def set(self, key: str, value: bytes | str) -> None:
        if isinstance(value, bytes):
            value = value.decode("latin-1")
        self._call({"op": "set", "key": self._key(key), "value": value}, 10.0)

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        timeout = self._timeout if timeout is None else timeout
        resp = self._call(
            {"op": "get", "key": self._key(key), "timeout": timeout}, timeout
        )
        return resp["value"].encode("latin-1")

    def get_str(self, key: str, timeout: Optional[float] = None) -> str:
        return self.get(key, timeout).decode("latin-1")

    def check(self, key: str) -> bool:
        return self._call({"op": "check", "key": self._key(key)}, 10.0)["exists"]

    def delete(self, key: str) -> bool:
        return self._call({"op": "delete", "key": self._key(key)}, 10.0)["deleted"]

    def add(self, key: str, amount: int) -> int:
        # retry=False: a reconnect-resend could double-apply the increment.
        resp = self._call(
            {"op": "add", "key": self._key(key), "amount": amount}, 10.0,
            retry=False,
        )
        return int(resp["value"])

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None
