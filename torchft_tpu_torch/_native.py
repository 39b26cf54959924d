"""ctypes bindings for the native DCN collective engine.

``libtftcollectives.so`` (built from ``_cpp/collectives.cc``) implements the
chunked ring allreduce / allgather / broadcast data plane with
multi-connection striping, pipelined receive-reduce, and the optional int8
blockwise wire codec. This module loads it and wraps the C ABI in
:class:`NativeEngine`, the object :class:`~torchft_tpu_torch.process_group.\
ProcessGroupNative` drives.

Threading/ownership contract: ctypes releases the GIL for the duration of
every engine call, so a collective blocked on the wire never stalls Python.
``abort()`` only shuts the sockets down (unblocking those calls); the
underlying C++ object is freed by :meth:`NativeEngine.close`, which waits for
all in-flight calls to return first — the abort-vs-destroy race is resolved
here, not in C++.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

# Keep in sync with the dtype/op codes in _cpp/collectives.hpp.
DTYPE_CODES = {"float32": 0, "float64": 1, "int32": 2, "int64": 3}
OP_SUM, OP_MAX, OP_MIN = 0, 1, 2

_RC_OK, _RC_ERROR, _RC_TIMEOUT = 0, 1, 2

_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None
_lib_lock = threading.Lock()


def _declare(lib: ctypes.CDLL) -> None:
    P, I32, I64, U64, CP = (
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.c_uint64,
        ctypes.c_char_p,
    )
    lib.tft_coll_create.restype = P
    lib.tft_coll_create.argtypes = [I32, I64, I32]
    lib.tft_coll_destroy.restype = None
    lib.tft_coll_destroy.argtypes = [P]
    lib.tft_coll_listen.restype = I32
    lib.tft_coll_listen.argtypes = [P, CP]
    lib.tft_coll_connect.restype = I32
    lib.tft_coll_connect.argtypes = [P, I32, I32, CP, I64]
    lib.tft_coll_abort.restype = None
    lib.tft_coll_abort.argtypes = [P, CP]
    lib.tft_coll_set_link.restype = None
    lib.tft_coll_set_link.argtypes = [P, I32, CP, I64, I64, I32, I32]
    lib.tft_coll_allreduce.restype = I32
    lib.tft_coll_allreduce.argtypes = [P, P, U64, I32, I32, I64]
    lib.tft_coll_allreduce_q8.restype = I32
    lib.tft_coll_allreduce_q8.argtypes = [P, P, U64, I64]
    lib.tft_coll_allgather.restype = I32
    lib.tft_coll_allgather.argtypes = [P, CP, P, U64, I64]
    lib.tft_coll_broadcast.restype = I32
    lib.tft_coll_broadcast.argtypes = [P, CP, P, U64, I32, I64]
    lib.tft_coll_result_meta_len.restype = I64
    lib.tft_coll_result_meta_len.argtypes = [P, I32]
    lib.tft_coll_result_meta.restype = I32
    lib.tft_coll_result_meta.argtypes = [P, I32, P, I64]
    lib.tft_coll_result_size.restype = I64
    lib.tft_coll_result_size.argtypes = [P, I32]
    lib.tft_coll_result_copy.restype = I32
    lib.tft_coll_result_copy.argtypes = [P, I32, P, I64]
    lib.tft_coll_bytes_tx.restype = U64
    lib.tft_coll_bytes_tx.argtypes = [P]
    lib.tft_coll_bytes_rx.restype = U64
    lib.tft_coll_bytes_rx.argtypes = [P]
    lib.tft_coll_last_error.restype = None
    lib.tft_coll_last_error.argtypes = [P, P, I64]
    lib.tft_coll_set_trace.restype = None
    lib.tft_coll_set_trace.argtypes = [P, CP]
    lib.tft_coll_fr_seq.restype = U64
    lib.tft_coll_fr_seq.argtypes = [P]
    lib.tft_coll_fr_snapshot.restype = I64
    lib.tft_coll_fr_snapshot.argtypes = [P, U64, P, I64]
    lib.tft_chaos_init.restype = I32
    lib.tft_chaos_init.argtypes = [CP]
    lib.tft_chaos_armed.restype = I32
    lib.tft_chaos_armed.argtypes = []
    lib.tft_chaos_set_step.restype = None
    lib.tft_chaos_set_step.argtypes = [I64]
    lib.tft_chaos_seq.restype = I64
    lib.tft_chaos_seq.argtypes = []
    lib.tft_chaos_snapshot.restype = I64
    lib.tft_chaos_snapshot.argtypes = [I64, P, I64]
    lib.tft_chaos_set_link.restype = None
    lib.tft_chaos_set_link.argtypes = [CP, CP]


# The shared C++ runtime that this process already holds. A library that
# carries a static copy of it instead crashed in its first use of iostreams
# (``fr_snapshot`` formatting a double).
_CXX_RUNTIME = "libstdc++.so.6"

_SHT_DYNAMIC, _DT_NULL, _DT_NEEDED = 6, 0, 1


def needed_libraries(path) -> List[str]:
    """The ``DT_NEEDED`` entries of the 64-bit little-endian ELF file at
    ``path``: the shared libraries it links, read from its ``.dynamic``
    section and the string table that section names. Raises
    ``RuntimeError`` if the file is not such an ELF file."""
    import struct

    with open(path, "rb") as f:
        head = f.read(64)
        if head[:4] != b"\x7fELF" or head[4] != 2 or head[5] != 1:
            raise RuntimeError(f"{path} is not a 64-bit little-endian ELF file")
        shoff, = struct.unpack_from("<Q", head, 0x28)
        shentsize, shnum = struct.unpack_from("<HH", head, 0x3A)
        f.seek(shoff)
        table = f.read(shentsize * shnum)
        # (sh_type, sh_offset, sh_size, sh_link) of each section header.
        sections = []
        for i in range(shnum):
            fields = struct.unpack_from("<IIQQQQIIQQ", table, i * shentsize)
            sections.append((fields[1], fields[4], fields[5], fields[6]))

        def read(section):
            f.seek(section[1])
            return f.read(section[2])

        dynamic = [s for s in sections if s[0] == _SHT_DYNAMIC]
        if len(dynamic) != 1:
            raise RuntimeError(f"{path} has {len(dynamic)} dynamic sections")
        entries = read(dynamic[0])
        strtab = read(sections[dynamic[0][3]])
    names = []
    for tag, value in struct.iter_unpack("<qQ", entries):
        if tag == _DT_NULL:
            break
        if tag == _DT_NEEDED:
            names.append(strtab[value:strtab.index(b"\0", value)].decode())
    return names


def _load() -> ctypes.CDLL:
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_error is not None:
            raise RuntimeError(_lib_error)
        try:
            from torchft_tpu_torch import coordination

            coordination._ensure_built()
            path = coordination._BIN_DIR / coordination.ENGINE_LIBRARY
            if _CXX_RUNTIME not in needed_libraries(path):
                # Built by a compiler that linked its own copy of the C++
                # runtime (make rebuilt nothing when only CXX changed):
                # rebuild it, objects included, with Python's compiler.
                coordination._make(coordination.ENGINE_LIBRARY, always=True)
                if _CXX_RUNTIME not in needed_libraries(path):
                    raise RuntimeError(
                        f"{path} does not link the shared C++ runtime "
                        f"({_CXX_RUNTIME}), even rebuilt with Python's compiler"
                    )
            lib = ctypes.CDLL(str(path))
            _declare(lib)
        except (OSError, RuntimeError) as e:
            _lib_error = f"native collective engine unavailable: {e}"
            raise RuntimeError(_lib_error) from e
        # Arm the in-library chaos plane from TORCHFT_CHAOS (no-op, and the
        # hot-path hooks stay a single relaxed atomic load, when unset), and
        # keep its step window in lockstep with the Python plane's.
        lib.tft_chaos_init(b"")
        from torchft_tpu_torch import chaos as _chaos

        _chaos.on_step_change(lambda s: lib.tft_chaos_set_step(int(s)))
        cur = _chaos.current_step()
        if cur is not None:
            lib.tft_chaos_set_step(int(cur))
        _lib = lib
        return lib


# -- chaos plane (seeded fault injection inside the native engine) ----------


def chaos_armed() -> bool:
    """True iff the loaded library has an active TORCHFT_CHAOS spec."""
    if _lib is None:
        return False
    return bool(_lib.tft_chaos_armed())


def chaos_init(spec: str) -> None:
    """(Re)arm the native chaos plane from an explicit spec string; empty
    re-reads TORCHFT_CHAOS. Raises on a malformed spec."""
    lib = _load()
    if lib.tft_chaos_init(spec.encode()) != 0:
        raise ValueError(f"bad TORCHFT_CHAOS spec: {spec!r}")


def chaos_set_step(step: int) -> None:
    """Mirror the trainer's committed step into the library so step-windowed
    rules scope native injections too. Cheap; safe when chaos is off."""
    if _lib is not None:
        _lib.tft_chaos_set_step(int(step))


def chaos_seq() -> int:
    if _lib is None:
        return 0
    return int(_lib.tft_chaos_seq())


def chaos_snapshot(since_seq: int = 0) -> dict:
    """Injections recorded inside the library with seq > since_seq, as
    ``{"seq": N, "events": [...]}`` (bounded ring; oldest dropped first)."""
    import json

    lib = _load()
    cap = 16384
    for _ in range(4):
        buf = ctypes.create_string_buffer(cap)
        got = lib.tft_chaos_snapshot(int(since_seq), buf, cap)
        if got >= 0:
            return json.loads(buf.value.decode(errors="replace"))
        cap = -int(got) + 4096
    raise RuntimeError("native chaos_snapshot: buffer kept growing")


def chaos_set_link(peer: str, cls: str) -> None:
    """Register peer -> link class ("local"/"dcn"/"wan") in the native chaos
    plane so ``link:<class>``-scoped rules resolve identically to Python's
    registry. Safe when chaos is off (the map is only consulted by armed
    rules)."""
    if _lib is not None:
        _lib.tft_chaos_set_link(peer.encode(), cls.encode())


def is_available() -> bool:
    """True iff the native engine can be (or already was) loaded."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


class NativeEngine:
    """One C++ collective engine instance (one mesh generation).

    All methods raise ``TimeoutError`` on deadline expiry and ``RuntimeError``
    on any other failure (abort, peer death), mirroring the socket PG's error
    surface so ProcessGroupNative's callers can't tell the planes apart.
    """

    def __init__(
        self,
        n_streams: int = 4,
        pipeline_bytes: int = 1 << 20,
        fr_capacity: int = 256,
    ) -> None:
        self._lib = _load()
        self._handle: Optional[int] = self._lib.tft_coll_create(
            int(n_streams), int(pipeline_bytes), int(fr_capacity)
        )
        if not self._handle:
            raise RuntimeError("tft_coll_create failed")
        self._fr_capacity = int(fr_capacity)
        self._mu = threading.Condition()
        self._inflight = 0
        self._closed = False

    # -- in-flight accounting (abort-vs-destroy safety) --------------------

    def _begin(self) -> int:
        with self._mu:
            if self._closed or self._handle is None:
                raise RuntimeError("native engine closed")
            self._inflight += 1
            return self._handle

    def _end(self) -> None:
        with self._mu:
            self._inflight -= 1
            if self._inflight == 0:
                self._mu.notify_all()

    def abort(self, why: str = "abort") -> None:
        """Unblocks every in-flight and future call; non-blocking, callable
        from any thread while collectives are on the wire."""
        with self._mu:
            if self._handle is None:
                return
            h = self._handle
        self._lib.tft_coll_abort(h, why.encode())

    def close(self) -> None:
        """Aborts, waits for in-flight calls to drain, then frees the C++
        object. Idempotent."""
        with self._mu:
            if self._closed:
                return
            self._closed = True
            h = self._handle
        if h is None:
            return
        self._lib.tft_coll_abort(h, b"engine closed")
        with self._mu:
            while self._inflight > 0:
                self._mu.wait()
            self._handle = None
        self._lib.tft_coll_destroy(h)

    def __del__(self) -> None:  # best-effort for leaked engines
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    # -- errors ------------------------------------------------------------

    def _error(self, h: int) -> str:
        buf = ctypes.create_string_buffer(4096)
        self._lib.tft_coll_last_error(h, buf, len(buf))
        return buf.value.decode(errors="replace")

    def _check(self, h: int, rc: int, op: str) -> None:
        if rc == _RC_OK:
            return
        msg = self._error(h) or f"{op} failed"
        if rc == _RC_TIMEOUT:
            raise TimeoutError(f"native {op}: {msg}")
        raise RuntimeError(f"native {op}: {msg}")

    # -- mesh lifecycle ----------------------------------------------------

    def set_link(
        self,
        peer: int,
        cls: str,
        connect_ms: int,
        io_ms: int,
        n_streams: int,
        q8: bool,
    ) -> None:
        """Install the link policy for ``peer`` (-1 = default for peers
        without an explicit entry). Must be called before ``connect``; the
        engine freezes policies once the mesh is up."""
        h = self._begin()
        try:
            self._lib.tft_coll_set_link(
                h,
                int(peer),
                cls.encode(),
                int(connect_ms),
                int(io_ms),
                int(n_streams),
                1 if q8 else 0,
            )
        finally:
            self._end()

    def listen(self, host: str = "0.0.0.0") -> int:
        h = self._begin()
        try:
            port = self._lib.tft_coll_listen(h, host.encode())
        finally:
            self._end()
        if port <= 0:
            raise RuntimeError(f"native listen failed: {self._error(h)}")
        return int(port)

    def connect(
        self, rank: int, world: int, peers: List[str], timeout: float
    ) -> None:
        import json

        h = self._begin()
        try:
            rc = self._lib.tft_coll_connect(
                h, rank, world, json.dumps(peers).encode(), int(timeout * 1000)
            )
        finally:
            self._end()
        self._check(h, rc, "connect")

    # -- collectives -------------------------------------------------------

    def allreduce(
        self, arr: np.ndarray, op_code: int, timeout: float
    ) -> None:
        """In-place allreduce of a contiguous array whose dtype is in
        DTYPE_CODES. SUM/MAX/MIN only — AVG is SUM plus a caller-side
        divide, exactly like the socket ring."""
        dt = DTYPE_CODES[str(arr.dtype)]
        h = self._begin()
        try:
            rc = self._lib.tft_coll_allreduce(
                h,
                arr.ctypes.data_as(ctypes.c_void_p),
                arr.size,
                dt,
                op_code,
                int(timeout * 1000),
            )
        finally:
            self._end()
        self._check(h, rc, "allreduce")

    def allreduce_q8(self, arr: np.ndarray, timeout: float) -> None:
        """In-place SUM allreduce of a contiguous fp32 array over the int8
        blockwise wire codec (collectives.quantize_blockwise layout)."""
        h = self._begin()
        try:
            rc = self._lib.tft_coll_allreduce_q8(
                h,
                arr.ctypes.data_as(ctypes.c_void_p),
                arr.size,
                int(timeout * 1000),
            )
        finally:
            self._end()
        self._check(h, rc, "allreduce_q8")

    def allgather(self, meta: str, payload: bytes, timeout: float) -> None:
        h = self._begin()
        try:
            rc = self._lib.tft_coll_allgather(
                h,
                meta.encode(),
                ctypes.c_char_p(payload),
                len(payload),
                int(timeout * 1000),
            )
        finally:
            self._end()
        self._check(h, rc, "allgather")

    def broadcast(
        self, meta: str, payload: bytes, root: int, timeout: float
    ) -> None:
        h = self._begin()
        try:
            rc = self._lib.tft_coll_broadcast(
                h,
                meta.encode(),
                ctypes.c_char_p(payload),
                len(payload),
                root,
                int(timeout * 1000),
            )
        finally:
            self._end()
        self._check(h, rc, "broadcast")

    def result(self, slot: int) -> Tuple[str, bytearray]:
        """(meta, payload) received from rank ``slot`` by the last
        allgather/broadcast. The payload is writable so numpy views over it
        behave like the socket path's bytearray frames."""
        h = self._begin()
        try:
            mlen = self._lib.tft_coll_result_meta_len(h, slot)
            plen = self._lib.tft_coll_result_size(h, slot)
            if mlen < 0 or plen < 0:
                raise RuntimeError(f"native result: bad slot {slot}")
            mbuf = ctypes.create_string_buffer(max(1, int(mlen)))
            if mlen and self._lib.tft_coll_result_meta(h, slot, mbuf, mlen):
                raise RuntimeError(f"native result meta: slot {slot}")
            payload = bytearray(int(plen))
            if plen:
                cbuf = (ctypes.c_char * int(plen)).from_buffer(payload)
                if self._lib.tft_coll_result_copy(h, slot, cbuf, plen):
                    raise RuntimeError(f"native result copy: slot {slot}")
            return mbuf.raw[: int(mlen)].decode(errors="replace"), payload
        finally:
            self._end()

    # -- telemetry ---------------------------------------------------------

    def bytes_tx(self) -> int:
        with self._mu:
            if self._handle is None:
                return 0
            return int(self._lib.tft_coll_bytes_tx(self._handle))

    def bytes_rx(self) -> int:
        with self._mu:
            if self._handle is None:
                return 0
            return int(self._lib.tft_coll_bytes_rx(self._handle))

    # -- flight recorder ---------------------------------------------------

    def set_trace(self, tag: str) -> None:
        """Tag stamped onto subsequent flight records (trace id + collective
        tag). Cheap; callable per-collective."""
        with self._mu:
            if self._handle is None or self._closed:
                return
            h = self._handle
        self._lib.tft_coll_set_trace(h, tag.encode(errors="replace"))

    def fr_seq(self) -> int:
        with self._mu:
            if self._handle is None:
                return 0
            return int(self._lib.tft_coll_fr_seq(self._handle))

    def fr_snapshot(self, since_seq: int = 0) -> dict:
        """Flight-recorder snapshot: records with seq > since_seq plus the
        engine's cumulative counters. Safe to call from any thread while a
        collective is in flight (the C++ side tolerates torn in-flight
        records)."""
        import json

        h = self._begin()
        try:
            # One generous guess sized from the ring; grow on the rare race
            # where records land between the sizing call and the copy.
            cap = 8192 + 4096 * max(1, self._fr_capacity)
            for _ in range(4):
                buf = ctypes.create_string_buffer(cap)
                need = self._lib.tft_coll_fr_snapshot(h, int(since_seq), buf, cap)
                if need < cap:
                    return json.loads(buf.value.decode(errors="replace"))
                cap = int(need) + 65536
            raise RuntimeError("native fr_snapshot: buffer kept growing")
        finally:
            self._end()
