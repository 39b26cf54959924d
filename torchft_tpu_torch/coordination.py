"""Python interface to the C++ control plane (Lighthouse + Manager servers).

Capability parity with the reference's ``torchft.coordination`` /
``torchft._torchft`` pyo3 module (src/lib.rs:80-758 in tushar00jain/torchft):
``LighthouseServer``/``LighthouseClient``, ``ManagerServer``/``ManagerClient``,
``QuorumMember``/``Quorum``/``QuorumResult``. The servers here are the C++
binaries under ``torchft_tpu/_cpp`` spawned as subprocesses (the reference
embeds a tokio runtime in-process; a subprocess isolates the control plane
from a wedged trainer and from the Python GIL). Clients speak length-prefixed
JSON frames over TCP with per-request deadlines; timeouts surface as
``TimeoutError``, other failures as ``RuntimeError`` (matching the pyo3 error
mapping in lib.rs:670-682).

The binaries are framework-free and shared with the JAX package: this module
finds them by path in the sibling ``torchft_tpu/_cpp`` directory (built there
by the same ``make`` call), so a port replica and a JAX replica speak the
same wire.
"""

from __future__ import annotations

import atexit
import os
import socket
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from torchft_tpu_torch import _net
from torchft_tpu_torch import chaos as _chaos
from torchft_tpu_torch import knobs

# Client retry policy, shared by lighthouse and manager clients: bounded
# exponential backoff with FULL jitter (delay ~ U[0, min(max, base*2^n)]),
# mirroring the reference's retry.rs ExponentialBackoff. Jitter decorrelates
# replicas that all lost the same server — without it every client of a
# restarted lighthouse reconnect-storms in lockstep.
_RETRY_ATTEMPTS = max(1, knobs.get_int("TORCHFT_RPC_RETRIES"))
_RETRY_BASE_S = knobs.get_float("TORCHFT_RPC_BACKOFF_BASE_S")
_RETRY_MAX_S = knobs.get_float("TORCHFT_RPC_BACKOFF_MAX_S")

# The C++ sources live once, in the JAX package's tree; the port builds and
# runs the same binaries from there (no Python of that package is imported).
_CPP_DIR = Path(__file__).resolve().parent.parent / "torchft_tpu" / "_cpp"
_BIN_DIR = _CPP_DIR / "bin"
_BUILD_LOCK = threading.Lock()


_BUILT_THIS_PROCESS = False


def _ensure_built() -> None:
    """Builds the C++ control plane on first use (idempotent; safe across
    concurrent processes via a file lock on the build directory). Always
    invokes make — an incremental no-op when current — so stale binaries
    can't outlive a source change (a mere existence check would run old
    binaries that reject newer CLI flags)."""
    global _BUILT_THIS_PROCESS
    if _BUILT_THIS_PROCESS:
        return
    import fcntl
    import shutil

    if shutil.which("make") is None:
        # Toolchain-free deployment image: accept prebuilt binaries.
        binaries = [_BIN_DIR / "lighthouse", _BIN_DIR / "torchft_manager"]
        if all(b.exists() for b in binaries):
            _BUILT_THIS_PROCESS = True
            return
        raise RuntimeError(
            "torchft_tpu C++ control plane is not built and `make` is not "
            f"on PATH; prebuild {_BIN_DIR} or install a toolchain"
        )

    with _BUILD_LOCK:
        lock_path = _CPP_DIR / ".build.lock"
        with open(lock_path, "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                proc = subprocess.run(
                    ["make", "-j4", "all"],
                    cwd=_CPP_DIR,
                    capture_output=True,
                    text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        "failed to build torchft_tpu C++ control plane:\n"
                        f"{proc.stderr}"
                    )
                _BUILT_THIS_PROCESS = True
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)


def advertise_host() -> str:
    """Host other processes should use to reach servers on this machine."""
    host = knobs.get_raw("TORCHFT_HOST_ADDR")
    if host:
        return host
    return "127.0.0.1"


@dataclass
class QuorumMember:
    replica_id: str
    address: str = ""
    store_address: str = ""
    step: int = 0
    world_size: int = 1
    shrink_only: bool = False
    commit_failures: int = 0
    data: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "replica_id": self.replica_id,
            "address": self.address,
            "store_address": self.store_address,
            "step": self.step,
            "world_size": self.world_size,
            "shrink_only": self.shrink_only,
            "commit_failures": self.commit_failures,
            "data": self.data or {},
        }

    @staticmethod
    def from_json(j: Dict[str, Any]) -> "QuorumMember":
        return QuorumMember(
            replica_id=j.get("replica_id", ""),
            address=j.get("address", ""),
            store_address=j.get("store_address", ""),
            step=j.get("step", 0),
            world_size=j.get("world_size", 1),
            shrink_only=j.get("shrink_only", False),
            commit_failures=j.get("commit_failures", 0),
            data=j.get("data") or {},
        )


@dataclass
class Quorum:
    quorum_id: int
    participants: List[QuorumMember]
    created_ms: int = 0
    # Fencing epoch of the lighthouse that formed this quorum: bumped only on
    # standby takeover, so a resurrected stale primary's quorums carry a lower
    # epoch and are rejected manager-side (split-brain fence). 0 = pre-HA.
    epoch: int = 0
    # Quorum-generation counter, strictly monotone across lighthouse restarts
    # (persisted with reserve headroom). (epoch, generation) totally orders
    # every quorum the control plane ever delivered.
    generation: int = 0
    # Job namespace this quorum was formed in. A pre-namespace lighthouse
    # omits the key; it parses as "default", the island every untagged
    # frame lands in (wire back-compat, both directions).
    job: str = "default"

    @staticmethod
    def from_json(j: Dict[str, Any]) -> "Quorum":
        return Quorum(
            quorum_id=j.get("quorum_id", 0),
            participants=[
                QuorumMember.from_json(p) for p in j.get("participants", [])
            ],
            created_ms=j.get("created_ms", 0),
            epoch=j.get("epoch", 0),
            generation=j.get("generation", 0),
            job=j.get("job") or "default",
        )


@dataclass
class QuorumResult:
    """Per-rank recovery plan (reference: ManagerQuorumResponse /
    lib.rs QuorumResult, manager.rs:603-623)."""

    quorum_id: int
    replica_rank: int
    replica_world_size: int
    recover_src_manager_address: str
    recover_src_replica_rank: Optional[int]
    recover_dst_replica_ranks: List[int]
    store_address: str
    max_step: int
    max_replica_rank: Optional[int]
    max_world_size: int
    heal: bool
    commit_failures: int
    quorum: Optional[Quorum] = None
    # Operator asked this replica group to drain (dashboard drain button /
    # lighthouse "drain" RPC): the trainer should finish its step, call
    # Manager.leave(), and exit 0. Piggybacked on the quorum response — no
    # extra RPC per step.
    drain_requested: bool = False
    # Lighthouse-HA counters snapshot from the manager server ("lh" on the
    # quorum response): active index/addr, failovers, max accepted epoch,
    # stale_rejected, unreachable_retries. The Manager diffs consecutive
    # snapshots to journal lh_failover / lh_epoch / rpc_retry events.
    lh: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def from_json(j: Dict[str, Any], quorum: Optional[Quorum] = None) -> "QuorumResult":
        return QuorumResult(
            quorum_id=j["quorum_id"],
            replica_rank=j["replica_rank"],
            replica_world_size=j["replica_world_size"],
            recover_src_manager_address=j.get("recover_src_manager_address", ""),
            recover_src_replica_rank=j.get("recover_src_replica_rank"),
            recover_dst_replica_ranks=list(j.get("recover_dst_replica_ranks", [])),
            store_address=j.get("store_address", ""),
            max_step=j["max_step"],
            max_replica_rank=j.get("max_replica_rank"),
            max_world_size=j["max_world_size"],
            heal=j.get("heal", False),
            commit_failures=j.get("commit_failures", 0),
            quorum=quorum,
        )


class RequestAborted(RuntimeError):
    """A blocked RPC was deliberately interrupted via ``abort()`` (drain
    paths): distinct from transport failure so callers can translate it
    into a graceful exit instead of an error latch + retry."""


class _FramedClient:
    """Persistent framed-JSON connection with reconnect-on-error."""

    def __init__(self, addr: str, connect_timeout: float) -> None:
        self._addr = addr
        self._connect_timeout = connect_timeout
        # Chaos attribution uses the HOST only: servers bind ephemeral
        # ports, and a port-carrying site string would hash differently on
        # every run — breaking the chaos plane's replay-from-seed contract.
        self._chaos_peer = addr.rsplit(":", 1)[0]
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._aborted = False

    def abort(self) -> None:
        """Interrupts a blocked ``call`` from another thread (or a signal
        handler: takes NO locks — ``call`` holds ``_lock`` for its whole
        duration, so a locking abort would deadlock). The blocked recv
        fails on the closed socket and ``call`` raises RequestAborted
        instead of reconnect-retrying."""
        self._aborted = True
        sock = self._sock
        if sock is not None:
            try:
                # shutdown(), not just close(): close() of an fd another
                # thread is blocked in recv() on does not reliably wake
                # the recv; shutdown() delivers EOF to it immediately.
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def clear_abort(self) -> None:
        """Re-arms the client after an abort window closes (see
        Manager._async_quorum): without this, an abort that raced the
        RPC's completion would falsely kill the NEXT request. A still-set
        flag here means exactly that race happened — abort() killed the
        socket but no blocked recv was there to notice — so the dead
        socket is dropped too, or the next retry=False request
        (should_commit) would send into it and fail its single attempt."""
        with self._lock:
            if self._aborted:
                self._aborted = False
                self.close_unlocked()

    @property
    def addr(self) -> str:
        return self._addr

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def call(
        self, req: Dict[str, Any], timeout: float, retry: bool = True
    ) -> Dict[str, Any]:
        """Sends one request; raises TimeoutError on deadline expiry and
        RuntimeError on server-reported errors or transport failure.

        ``retry=False`` for non-idempotent requests (e.g. should_commit
        votes): a reconnect-resend could double-apply a request whose first
        copy the server already processed.

        Retries follow the shared backoff policy (``TORCHFT_RPC_RETRIES``
        attempts, full-jitter exponential delays) and every attempt is
        bounded by the *remaining* call deadline — backoff sleeps and
        reconnects spend the caller's budget, never extend it."""
        rpc = str(req.get("type"))
        deadline = time.monotonic() + timeout
        with self._lock:
            if self._aborted:
                # The socket (if any) was killed by abort(); drop it so
                # the caller after us reconnects cleanly.
                self._aborted = False
                self.close_unlocked()
                raise RequestAborted(f"request {rpc} to {self._addr} aborted")
            max_attempts = _RETRY_ATTEMPTS if retry else 1
            attempt = 0
            while True:
                attempt += 1
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"request {rpc} to {self._addr} timed out"
                    )
                try:
                    if _chaos._STATE is not None or not _chaos._INITED:
                        self._chaos_rpc(rpc, remaining)
                    with _chaos.scope("ctrl", peer=self._chaos_peer, match=rpc):
                        if self._sock is None:
                            # Reconnect bounded by the REMAINING per-call
                            # deadline too: a 2 s drain_status probe against
                            # a dead server must fail in ~2 s, not the full
                            # connect_timeout — and a slow connect must not
                            # eat the budget of the send/recv after it.
                            self._sock = _net.connect(
                                self._addr,
                                min(self._connect_timeout, remaining),
                            )
                            remaining = deadline - time.monotonic()
                        resp = _net.call_json(
                            self._sock, req, max(remaining, 0.001)
                        )
                    break
                except (TimeoutError, socket.timeout) as e:
                    self.close_unlocked()
                    if self._aborted:
                        self._aborted = False
                        raise RequestAborted(
                            f"request {rpc} to {self._addr} aborted"
                        ) from e
                    raise TimeoutError(
                        f"request {rpc} to {self._addr} timed out"
                    ) from e
                except (OSError, _net.FrameError) as e:
                    # FrameError covers the abort path's shutdown(): EOF
                    # mid-frame on the deliberately killed connection.
                    self.close_unlocked()
                    if self._aborted:
                        self._aborted = False
                        raise RequestAborted(
                            f"request {rpc} to {self._addr} aborted"
                        ) from e
                    if attempt >= max_attempts:
                        raise RuntimeError(
                            f"request {rpc} to {self._addr} failed "
                            f"after {attempt} attempts: {e}"
                        ) from e
                    self._retry_sleep(rpc, attempt, deadline, e)
        if not resp.get("ok", False):
            if resp.get("timeout"):
                raise TimeoutError(resp.get("error", "timed out"))
            raise RuntimeError(
                f"{req.get('type')} to {self._addr} failed: {resp.get('error')}"
            )
        return resp

    def _chaos_rpc(self, rpc: str, remaining: float) -> None:
        """Control-plane RPC injections: ``rpc_delay`` sleeps (bounded by
        the call's remaining budget); ``rpc_drop`` tears the connection
        with the request unsent — a lost request, the torn-RPC shape the
        retry policy must absorb."""
        st = _chaos.active()
        if st is None:
            return
        site = f"rpc:{rpc}"
        inj = st.pick("rpc_delay", "ctrl", site, peer=self._chaos_peer, match=rpc)
        if inj is not None:
            time.sleep(min(inj.ms / 1000.0, max(remaining - 0.001, 0.0)))
        inj = st.pick("rpc_drop", "ctrl", site, peer=self._chaos_peer, match=rpc)
        if inj is not None:
            self.close_unlocked()
            raise _net.FrameError(f"[chaos] rpc dropped: {inj}")

    def _retry_sleep(
        self, rpc: str, attempt: int, deadline: float, err: Exception
    ) -> None:
        """Full-jitter exponential backoff before attempt N+1, clipped to
        the remaining call budget; journaled so retry storms are visible.
        The jitter is seeded (chaos.backoff_jitter keyed on addr+rpc), not
        random.uniform: same-seed chaos replays must sleep the same amounts
        or the journal's rpc_retry delays diverge run to run."""
        cap = min(_RETRY_MAX_S, _RETRY_BASE_S * (2.0 ** (attempt - 1)))
        delay = min(
            _chaos.backoff_jitter(f"{self._addr}|{rpc}", attempt, cap),
            max(deadline - time.monotonic() - 0.001, 0.0),
        )
        from torchft_tpu_torch.telemetry import get_event_log

        log = get_event_log()
        if log is not None:
            log.emit(
                "rpc_retry",
                rpc=rpc,
                addr=self._addr,
                attempt=attempt,
                delay_s=round(delay, 4),
                error=str(err)[:200],
            )
            if attempt == 1:
                # Rise edge only (first failure of the call, not every
                # retry): connect refused/reset against a control-plane
                # peer is failure evidence in its own right.
                log.emit(
                    "failure_signal",
                    source="rpc_error",
                    subject=self._addr,
                    site=f"client:{rpc}",
                    detail=str(err)[:200],
                )
        if delay > 0:
            time.sleep(delay)

    def close_unlocked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class _ServerProcess:
    """A spawned control-plane binary that prints ``LISTENING <port>``.

    Every spawn passes ``--parent-pid`` so the binary self-terminates when
    its spawner dies: ``kill -9`` of a trainer must not orphan its manager
    server — a zombie heartbeater makes the lighthouse count it healthy
    forever and the split-brain majority guard then blocks every smaller
    quorum, wedging the cluster. (The reference's Rust server runs in-process
    via pyo3 and dies with the trainer implicitly; a child process needs this
    wired up. The binary polls getppid() against the passed pid — unlike
    PR_SET_PDEATHSIG it can't misfire when the spawning *thread* exits, and
    unlike a fork preexec hook it is safe in multithreaded parents.)
    """

    def __init__(self, argv: List[str], name: str) -> None:
        _ensure_built()
        self._name = name
        self._proc = subprocess.Popen(
            argv + ["--parent-pid", str(os.getpid())],
            stdout=subprocess.PIPE,
            stderr=None,  # inherit: server logs go to our stderr
            text=True,
        )
        self.port = self._read_port()
        atexit.register(self.shutdown)
        from torchft_tpu_torch.telemetry import get_event_log

        log = get_event_log()
        if log is not None:
            log.emit(
                "server_start",
                server=self._name,
                port=self.port,
                pid=self._proc.pid,
            )

    def _journal_stop(self) -> None:
        from torchft_tpu_torch.telemetry import get_event_log

        log = get_event_log()
        if log is not None:
            log.emit("server_stop", server=self._name, port=self.port)

    def _read_port(self, timeout: float = 10.0) -> int:
        assert self._proc.stdout is not None
        import select

        deadline = time.monotonic() + timeout
        buf = ""
        fd = self._proc.stdout.fileno()
        while time.monotonic() < deadline:
            # Poll the pipe so a silent-but-alive child can't block the
            # constructor past the deadline.
            ready, _, _ = select.select([fd], [], [], 0.2)
            if ready:
                chunk = os.read(fd, 4096).decode(errors="replace")
                if not chunk and self._proc.poll() is not None:
                    break
                buf += chunk
                # Parse complete lines only — a chunk boundary can split
                # "LISTENING <port>" mid-number.
                *complete, buf = buf.split("\n")
                for line in complete:
                    if line.startswith("LISTENING "):
                        return int(line.split()[1])
            elif self._proc.poll() is not None:
                break
        raise RuntimeError(
            f"{self._name} failed to start (rc={self._proc.poll()}, "
            f"output={buf!r})"
        )

    def is_alive(self) -> bool:
        return self._proc.poll() is None

    def shutdown(self) -> None:
        if self._proc.poll() is None:
            self._journal_stop()
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(timeout=5)


class LighthouseServer:
    """Spawns the C++ lighthouse (reference: LighthouseServer, lib.rs:606-668).

    Args mirror the reference CLI flags (lighthouse.rs:94-131); timeouts in
    milliseconds.
    """

    def __init__(
        self,
        bind: str = "0.0.0.0:0",
        min_replicas: int = 1,
        join_timeout_ms: int = 60000,
        quorum_tick_ms: int = 100,
        heartbeat_timeout_ms: int = 5000,
        fleet_snap_ms: Optional[int] = None,
        state_dir: Optional[str] = None,
        standby: bool = False,
        district: Optional[str] = None,
        root_addr: Optional[str] = None,
    ) -> None:
        host, port = _split_bind(bind)
        argv = [
            str(_BIN_DIR / "lighthouse"),
            "--bind-host",
            host,
            "--port",
            str(port),
            "--min-replicas",
            str(min_replicas),
            "--join-timeout-ms",
            str(join_timeout_ms),
            "--quorum-tick-ms",
            str(quorum_tick_ms),
            "--heartbeat-timeout-ms",
            str(heartbeat_timeout_ms),
        ]
        if fleet_snap_ms is not None:
            # /fleet.json staleness bound. None defers to the binary's
            # default (100 ms, or TORCHFT_FLEET_SNAP_MS); 0 rebuilds the
            # payload on every request (read-after-write determinism, the
            # "before" mode the fleet_load harness benchmarks against).
            argv += ["--fleet-snap-ms", str(fleet_snap_ms)]
        if state_dir:
            # Durable epoch/quorum-id snapshot dir: survives crash/restart so
            # quorum ids stay strictly monotone (see docs/FAULT_MODEL.md,
            # control plane). None = pre-HA volatile behavior.
            argv += ["--state-dir", str(state_dir)]
        if standby:
            # Warm standby: absorbs heartbeats read-only, takes over with a
            # bumped fencing epoch when the first quorum request arrives.
            argv += ["--standby"]
        if district:
            # Federation: this instance is the district lighthouse named
            # `district`; with root_addr set, the active instance reports
            # per-job fleet rollups upward on the heartbeat channel
            # (TORCHFT_LH_DISTRICT / TORCHFT_LH_ROOT are the env twins).
            argv += ["--district", str(district)]
        if root_addr:
            argv += ["--root", str(root_addr)]
        self._server = _ServerProcess(argv, "lighthouse")

    def address(self) -> str:
        return f"{advertise_host()}:{self._server.port}"

    def shutdown(self) -> None:
        self._server.shutdown()


class LighthouseClient:
    """Client for the lighthouse (reference: LighthouseClient, lib.rs:483-591)."""

    def __init__(self, addr: str, connect_timeout: float = 10.0) -> None:
        self._client = _FramedClient(addr, connect_timeout)

    def heartbeat(
        self,
        replica_id: str,
        timeout: float = 5.0,
        digest: Optional[Dict[str, Any]] = None,
        hb_interval_ms: int = 0,
        epoch: int = 0,
        job: str = "",
        signals: Optional[List[Dict[str, Any]]] = None,
    ) -> None:
        """One heartbeat, optionally carrying a :class:`~torchft_tpu_torch.
        telemetry.StepDigest` wire dict (``StepDigest.to_wire()``) plus
        the sender's nominal heartbeat interval and the max quorum epoch
        the sender has accepted (how standbys and resurrected stale
        primaries learn the fleet's current owner — there is no
        lighthouse-to-lighthouse channel). Old lighthouses read only
        the keys they know, so the extra fields are silently dropped —
        a new client never breaks an old fleet."""
        req: Dict[str, Any] = {
            "type": "heartbeat", "replica_id": replica_id,
            "timeout_ms": int(timeout * 1000),
        }
        if digest is not None:
            req["digest"] = digest
        if hb_interval_ms > 0:
            req["hb_interval_ms"] = int(hb_interval_ms)
        if epoch > 0:
            req["epoch"] = int(epoch)
        if job:
            req["job"] = job
        if signals:
            # Failure-evidence piggyback: observed signals ride the
            # heartbeat frame exactly like the C++ manager's outbox does
            # (source/replica_id/site/detail dicts). Old lighthouses drop
            # the key unread.
            req["signals"] = list(signals)
        self._client.call(req, timeout)

    def fleet(self, timeout: float = 5.0, job: str = "") -> Dict[str, Any]:
        """Live fleet-health table (the framed twin of ``GET
        /fleet.json``): per-replica digest rows, fleet aggregates, and
        the anomaly ring. ``job`` scopes the payload to one namespace;
        empty serves the default job's composite view (which carries
        per-job summaries under ``jobs`` plus federation ``districts``).
        See docs/OBSERVABILITY.md "live plane"."""
        req: Dict[str, Any] = {
            "type": "fleet", "timeout_ms": int(timeout * 1000),
        }
        if job:
            req["job"] = job
        return self._client.call(req, timeout)["fleet"]

    def quorum(
        self,
        replica_id: str,
        timeout: float = 60.0,
        address: str = "",
        store_address: str = "",
        step: int = 0,
        world_size: int = 1,
        shrink_only: bool = False,
        commit_failures: int = 0,
        data: Optional[Dict[str, Any]] = None,
        job: str = "",
    ) -> Quorum:
        member = QuorumMember(
            replica_id=replica_id,
            address=address,
            store_address=store_address,
            step=step,
            world_size=world_size,
            shrink_only=shrink_only,
            commit_failures=commit_failures,
            data=data or {},
        )
        req: Dict[str, Any] = {
            "type": "quorum",
            "timeout_ms": int(timeout * 1000),
            "requester": member.to_json(),
        }
        if job:
            req["job"] = job
        resp = self._client.call(req, timeout + 5.0)
        return Quorum.from_json(resp["quorum"])

    def status(self, timeout: float = 5.0) -> Dict[str, Any]:
        return self._client.call(
            {"type": "status", "timeout_ms": int(timeout * 1000)}, timeout
        )["status"]

    def kill(
        self, replica_id: str, timeout: float = 5.0, job: str = ""
    ) -> None:
        req: Dict[str, Any] = {
            "type": "kill", "replica_id": replica_id,
            "timeout_ms": int(timeout * 1000),
        }
        if job:
            req["job"] = job
        self._client.call(req, timeout)

    def leave(
        self, replica_id: str, timeout: float = 5.0, job: str = "",
        reason: str = "",
    ) -> None:
        """Graceful drain: removes the replica from the lighthouse's
        heartbeat/participant maps immediately (with a tombstone against
        in-flight heartbeats), so the survivors' next quorum forms at tick
        speed instead of waiting out the heartbeat timeout. No reference
        analog — the reference only has Kill → exit(1). ``reason`` is
        the evidence tag: a leave sent on a DEAD trainer's behalf uses
        ``"trainer died"``, which the lighthouse turns into a proc_death
        failure signal instead of treating it as a planned drain."""
        req: Dict[str, Any] = {
            "type": "leave", "replica_id": replica_id,
            "timeout_ms": int(timeout * 1000),
        }
        if reason:
            req["reason"] = reason
        if job:
            req["job"] = job
        self._client.call(req, timeout)

    def request_drain(
        self, replica_id: str, timeout: float = 5.0, job: str = ""
    ) -> None:
        """Operator-initiated drain (the dashboard drain button's RPC):
        forwards a request_drain to the replica's manager; the trainer sees
        ``Manager.drain_requested()`` on its next quorum and drains at a
        step boundary it knows is safe. No reference analog — the
        reference dashboard only has a kill button."""
        req: Dict[str, Any] = {
            "type": "drain", "replica_id": replica_id,
            "timeout_ms": int(timeout * 1000),
        }
        if job:
            req["job"] = job
        self._client.call(req, timeout)

    def drain_all(
        self, timeout: float = 15.0, job: str = ""
    ) -> Dict[str, Any]:
        """Operator-initiated FULL-job drain (the dashboard's
        ``drain ALL`` button / ``POST /drain_all``): forwards
        request_drain to every registered member's manager. Each trainer
        drains at its own safe boundary — with ``--durable-dir`` that
        includes a final durable snapshot, so the stopped job can later
        be relaunched and resume (the operator-triggered twin of a
        whole-pod preemption; see tools/drills.py preempt-all). ``job``
        scopes the drain to one namespace; empty drains every namespace
        (the pre-namespace whole-instance semantics). Returns
        ``{"sent": {replica_id: bool}, "n_sent": .., "n_members": ..}``.
        No reference analog."""
        req: Dict[str, Any] = {
            "type": "drain_all", "timeout_ms": int(timeout * 1000),
        }
        if job:
            req["job"] = job
        resp = self._client.call(req, timeout)
        return {
            "sent": resp.get("sent", {}),
            "n_sent": resp.get("n_sent", 0),
            "n_members": resp.get("n_members", 0),
        }

    def close(self) -> None:
        self._client.close()


class ManagerServer:
    """Spawns the per-replica-group C++ manager server (reference:
    ManagerServer, lib.rs:80-144 / src/manager.rs:118-174).

    ``lighthouse_addr`` may be an ordered comma list
    ``host:port[,host:port...]``: the first entry is the primary
    lighthouse, the rest warm standbys. The server heartbeats every entry
    and fails over down the list when the active entry's lease lapses
    (``lighthouse_lease_ms`` / TORCHFT_LH_LEASE_MS)."""

    def __init__(
        self,
        replica_id: str,
        lighthouse_addr: str,
        store_address: str,
        world_size: int,
        bind: str = "0.0.0.0:0",
        heartbeat_interval_ms: int = 100,
        connect_timeout_ms: int = 10000,
        quorum_retries: int = 0,
        lighthouse_lease_ms: Optional[int] = None,
        job: Optional[str] = None,
    ) -> None:
        host, port = _split_bind(bind)
        self.replica_id = replica_id
        argv = [
            str(_BIN_DIR / "torchft_manager"),
            "--replica-id",
            replica_id,
            "--lighthouse",
            lighthouse_addr,
            "--advertise-host",
            advertise_host(),
            "--bind-host",
            host,
            "--port",
            str(port),
            "--store-address",
            store_address,
            "--world-size",
            str(world_size),
            "--heartbeat-interval-ms",
            str(heartbeat_interval_ms),
            "--connect-timeout-ms",
            str(connect_timeout_ms),
            "--quorum-retries",
            str(quorum_retries),
        ]
        if lighthouse_lease_ms is not None:
            # Active-lighthouse lease before failing over down the comma
            # list in lighthouse_addr. None defers to the binary's default
            # (3000 ms, or TORCHFT_LH_LEASE_MS).
            argv += ["--lh-lease-ms", str(lighthouse_lease_ms)]
        if job:
            # Job namespace stamped on every frame to the lighthouse.
            # None defers to the binary's default ("default", or
            # TORCHFT_JOB).
            argv += ["--job", str(job)]
        self._server = _ServerProcess(argv, f"manager[{replica_id}]")

    def address(self) -> str:
        return f"{advertise_host()}:{self._server.port}"

    def is_alive(self) -> bool:
        return self._server.is_alive()

    def shutdown(self) -> None:
        self._server.shutdown()


class ManagerClient:
    """Client for a manager server (reference: ManagerClient, lib.rs:153-281)."""

    def __init__(self, addr: str, connect_timeout: float = 10.0) -> None:
        self._client = _FramedClient(addr, connect_timeout)

    @property
    def addr(self) -> str:
        return self._client.addr

    def abort(self) -> None:
        """Signal-handler-safe: interrupts a blocked RPC (see
        _FramedClient.abort)."""
        self._client.abort()

    def clear_abort(self) -> None:
        self._client.clear_abort()

    def _quorum(
        self,
        group_rank: int,
        step: int,
        checkpoint_metadata: str,
        shrink_only: bool,
        timeout: float,
        init_sync: bool = True,
        commit_failures: int = 0,
        trace_id: str = "",
    ) -> QuorumResult:
        req = {
            "type": "quorum",
            "group_rank": group_rank,
            "step": step,
            "checkpoint_metadata": checkpoint_metadata,
            "shrink_only": shrink_only,
            "init_sync": init_sync,
            "commit_failures": commit_failures,
            "timeout_ms": int(timeout * 1000),
        }
        # Correlation id for the step's control-plane path: the manager
        # server echoes it on the response and forwards it on its own
        # lighthouse quorum RPC, so packet captures / server logs of both
        # hops can be joined to the journal without guessing by timestamp.
        if trace_id:
            req["trace_id"] = trace_id
        resp = self._client.call(req, timeout + 5.0)
        quorum = Quorum.from_json(resp["quorum"]) if "quorum" in resp else None
        result = QuorumResult.from_json(resp["result"], quorum)
        result.drain_requested = bool(resp.get("drain_requested", False))
        result.lh = dict(resp.get("lh") or {})
        return result

    def drain_status(self, timeout: float = 2.0) -> bool:
        """Out-of-band read of the operator-drain flag. The quorum
        response piggyback only delivers on quorum SUCCESS — a trainer
        whose peers drained a beat earlier (its quorums now fail) reads
        the flag here after a failed step instead of retrying quorums it
        can never win."""
        resp = self._client.call(
            {"type": "drain_status", "timeout_ms": int(timeout * 1000)},
            timeout,
        )
        return bool(resp.get("drain_requested", False))

    def _checkpoint_metadata(self, rank: int, timeout: float = 10.0) -> str:
        resp = self._client.call(
            {"type": "checkpoint_metadata", "rank": rank,
             "timeout_ms": int(timeout * 1000)},
            timeout,
        )
        return resp["checkpoint_metadata"]

    def should_commit(
        self,
        group_rank: int,
        step: int,
        should_commit: bool,
        timeout: float,
        trace_id: str = "",
    ) -> bool:
        req = {
            "type": "should_commit",
            "group_rank": group_rank,
            "step": step,
            "should_commit": should_commit,
            "timeout_ms": int(timeout * 1000),
        }
        if trace_id:
            req["trace_id"] = trace_id  # echoed by the server, see _quorum
        resp = self._client.call(
            req,
            timeout + 5.0,
            retry=False,  # a resent vote would poison the next barrier round
        )
        return resp["should_commit"]

    def set_digest(self, digest: Dict[str, Any], timeout: float = 2.0) -> None:
        """Hands the manager server the latest health digest
        (``StepDigest.to_wire()``); the server's heartbeat loop attaches
        it to every lighthouse heartbeat until replaced. Fire-and-forget
        from the trainer's perspective: the digest is advisory telemetry,
        so callers swallow failures rather than perturb the step."""
        self._client.call(
            {"type": "set_digest", "digest": digest,
             "timeout_ms": int(timeout * 1000)},
            timeout,
            retry=False,  # next digest push supersedes this one anyway
        )

    def info(self, timeout: float = 2.0) -> Dict[str, Any]:
        """Identity probe: replica_id / address / world_size of the
        server behind this connection. Lets obs tooling confirm it is
        talking to the replica it thinks it is before issuing kill or
        drain."""
        return self._client.call(
            {"type": "info", "timeout_ms": int(timeout * 1000)}, timeout
        )

    def signal(
        self,
        source: str,
        replica_id: str = "",
        site: str = "",
        detail: Optional[Dict[str, Any]] = None,
        timeout: float = 2.0,
    ) -> None:
        """Queue a failure signal (``source`` in telemetry.SIGNAL_SOURCES)
        with the local manager server; it piggybacks on the next heartbeat
        to the active lighthouse. Fire-and-forget evidence: callers swallow
        failures rather than perturb the step they are reporting about."""
        req: Dict[str, Any] = {
            "type": "signal",
            "source": source,
            "timeout_ms": int(timeout * 1000),
        }
        if replica_id:
            req["replica_id"] = replica_id
        if site:
            req["site"] = site
        if detail:
            req["detail"] = detail
        self._client.call(req, timeout, retry=False)

    def evidence_status(self, timeout: float = 2.0) -> Dict[str, Any]:
        """Poll the manager's evidence cursor: the active lighthouse
        island's failure-signal seq (``signal_seq``), the last signal it
        acked back (``signal``), and the lighthouse HA attribution
        (``lh.detect_ms`` / ``lh.evidence``). The trainer-side evidence
        watcher uses a seq RISE with a hard source on a peer to abort a
        wedged collective early."""
        return self._client.call(
            {"type": "evidence_status", "timeout_ms": int(timeout * 1000)},
            timeout,
            retry=False,
        )

    def kill(self, msg: str = "") -> None:
        try:
            self._client.call({"type": "kill", "msg": msg, "timeout_ms": 2000}, 2.0)
        except (RuntimeError, TimeoutError):
            pass  # the victim exits without replying

    def leave(self, timeout: float = 5.0) -> bool:
        """Graceful drain of this replica group: the manager server stops
        its lighthouse heartbeats and forwards a leave, so peers re-quorum
        without us at tick speed. Returns whether the lighthouse confirmed
        the leave (False = best-effort: heartbeats stopped, peers will age
        us out on the heartbeat timeout instead)."""
        resp = self._client.call(
            {"type": "leave", "timeout_ms": int(timeout * 1000)}, timeout
        )
        return bool(resp.get("sent", False))

    def close(self) -> None:
        self._client.close()


def _split_bind(bind: str) -> tuple[str, int]:
    host, port = _net.parse_addr(bind) if ":" in bind else (bind, 0)
    if host == "127.0.0.1" and bind.startswith(("0.0.0.0", "[::]", "::")):
        host = "0.0.0.0"
    return host, port


def lighthouse_main() -> None:
    """CLI entry point: ``torchft_tpu_lighthouse`` (reference:
    torchft_lighthouse console script)."""
    import sys

    _ensure_built()
    os.execv(str(_BIN_DIR / "lighthouse"), [str(_BIN_DIR / "lighthouse")] + sys.argv[1:])
