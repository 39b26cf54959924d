"""Manager: the per-rank fault-tolerance runtime state machine.

Capability parity with the reference's ``torchft/manager.py:137-946``:
- ``start_quorum()`` runs the quorum asynchronously (overlapping forward/
  backward), reconfigures the process group when the quorum id changes, and
  drives live recovery (send/receive checkpoints) for lagging replicas.
- ``allreduce()`` gates gradient averaging on the quorum, zeroes the
  contribution of non-participating ranks, and normalizes by the *live*
  participant count (dynamic-world numerics).
- ``should_commit()`` is the distributed commit gate: errors anywhere in the
  step cause every replica to skip the optimizer update.
- Errors are latched (``report_error``/``errored``) so a failed collective
  poisons the step, not the process.

Port notes: tensors here are host numpy buffers or torch tensors (a CUDA
tensor is copied to a host numpy buffer at the manager boundary, reduced
through the numpy process group, and copied back to its device — the wire
stays byte-identical to the JAX package's); the recovery path runs on a
background thread (the reference's CUDA "recovery stream" analog); state
dicts are arbitrary nested containers.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import socket
import threading
import time
import uuid
from contextlib import contextmanager
from datetime import timedelta
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, TypeVar

import numpy as np

from torchft_tpu_torch import chaos as _chaos
from torchft_tpu_torch import futures as ft_futures
from torchft_tpu_torch import knobs
from torchft_tpu_torch.checkpointing._rwlock import RWLock
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.coordination import ManagerClient, ManagerServer, QuorumResult
from torchft_tpu_torch.process_group import ProcessGroup, ReduceOp
from torchft_tpu_torch.store import StoreClient, TCPStoreServer
from torchft_tpu_torch.telemetry import (
    DigestWindow,
    StepDigest,
    TimeLedger,
    get_event_log,
    get_metrics_logger,
    observe_span,
    set_default_replica_id,
    timeit,
    trace_span,
    traced,
)
from torchft_tpu_torch.work import DummyWork, Work

logger = logging.getLogger(__name__)

MANAGER_ADDR_KEY = "manager_addr"
REPLICA_ID_KEY = "replica_id"

T = TypeVar("T")


class WorldSizeMode(Enum):
    """How membership changes affect training numerics (reference:
    manager.py:112-127).

    DYNAMIC: gradients are averaged over however many replicas are live;
    batch size (and thus gradient variance) varies with membership.
    FIXED_WITH_SPARES: the participant count is fixed at ``min_replica_size``;
    extra healthy replicas are benched as spares contributing zeros.
    """

    DYNAMIC = "dynamic"
    FIXED_WITH_SPARES = "fixed_with_spares"


class ExceededMaxRetriesError(RuntimeError):
    pass


class Manager:
    def __init__(
        self,
        pg: ProcessGroup,
        load_state_dict: Optional[Callable[[Any], None]] = None,
        state_dict: Optional[Callable[[], Any]] = None,
        min_replica_size: int = 1,
        use_async_quorum: bool = True,
        timeout: float = 60.0,
        quorum_timeout: float = 120.0,
        connect_timeout: float = 20.0,
        replica_id: Optional[str] = None,
        lighthouse_addr: Optional[str] = None,
        store_addr: Optional[str] = None,
        group_rank: Optional[int] = None,
        group_world_size: Optional[int] = None,
        checkpoint_transport: Optional[CheckpointTransport] = None,
        init_sync: bool = True,
        max_retries: Optional[int] = None,
        world_size_mode: WorldSizeMode = WorldSizeMode.DYNAMIC,
        quorum_retries: int = 0,
        heartbeat_interval_ms: int = 100,
    ) -> None:
        """
        Args mirror the reference ctor (manager.py:151-333); env fallbacks:
        ``TORCHFT_LIGHTHOUSE``, ``TORCHFT_TIMEOUT_SEC``,
        ``TORCHFT_QUORUM_TIMEOUT_SEC``, ``TORCHFT_CONNECT_TIMEOUT_SEC``,
        ``TORCHFT_QUORUM_RETRIES``, ``REPLICA_GROUP_ID``, ``RANK``,
        ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``.

        ``pg`` carries the outer (replica) axis only; inner FSDP/TP axes live
        inside the replica group, not here.
        """
        self._pg = pg
        self._min_replica_size = min_replica_size
        self._use_async_quorum = use_async_quorum
        self._timeout = knobs.get_float("TORCHFT_TIMEOUT_SEC", timeout)
        self._quorum_timeout = knobs.get_float(
            "TORCHFT_QUORUM_TIMEOUT_SEC", quorum_timeout
        )
        self._connect_timeout = knobs.get_float(
            "TORCHFT_CONNECT_TIMEOUT_SEC", connect_timeout
        )
        quorum_retries = knobs.get_int(
            "TORCHFT_QUORUM_RETRIES", quorum_retries
        )
        self._init_sync = init_sync
        self._max_retries = max_retries
        self._world_size_mode = world_size_mode
        self._commit_failures = 0

        self._group_rank = int(
            group_rank if group_rank is not None else os.environ.get("RANK", 0)
        )
        self._group_world_size = int(
            group_world_size
            if group_world_size is not None
            else os.environ.get("WORLD_SIZE", 1)
        )

        # User state-dict registry (reference: manager.py:219-226, 349-368).
        self._user_state_dicts: Dict[str, Callable[[], Any]] = {}
        self._load_state_dicts: Dict[str, Callable[[Any], None]] = {}
        if state_dict is not None and load_state_dict is not None:
            self.register_state_dict_fn("default", state_dict, load_state_dict)
        self._state_dict_lock = RWLock(timeout=self._timeout)

        if checkpoint_transport is None:
            from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

            checkpoint_transport = HTTPTransport(timeout=self._timeout)
        self._checkpoint_transport = checkpoint_transport

        # Async quorum executor (one thread: quorum N must finish before N+1).
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="async_quorum"
        )
        self._quorum_future: Optional[concurrent.futures.Future] = None

        # Step/commit state.
        self._step = 0
        self._batches_committed = 0
        self._consecutive_commit_failures = 0
        self._participating_rank: Optional[int] = None
        self._participating_world_size: int = 0
        self._errored: Optional[Exception] = None
        self._healing = False
        self._pending_state_dict: Optional[Dict[str, Any]] = None
        self._quorum_id = -1
        # Step-scoped trace id, minted at quorum_ready as
        # "q{quorum_id}.s{max_step}": deterministic, so every replica in the
        # same quorum generation computes the SAME id with no extra RPC, and
        # a new generation (kill/heal/join) gets a new id. Stamped on every
        # journal event, forwarded on control-plane RPCs, and pushed into
        # the native engine's collective tags — one id joins
        # quorum -> heal -> allreduce -> commit across planes and replicas.
        self._trace_id = ""
        self._drained = False
        self._drain_requested = False
        # One-shot latch: the first healing quorum of a mid-run start is a
        # deliberate elastic join (journaled once as elastic_join).
        self._elastic_join_emitted = False
        # Last-seen lighthouse-HA counters from the manager server's "lh"
        # snapshot on quorum responses: diffed each quorum to journal
        # lh_failover / lh_epoch / rpc_retry exactly once per change.
        self._lh_last: Dict[str, int] = {}
        # Drain-abort of a blocked sync quorum (see abort_pending_quorum):
        # _quorum_rpc_pending brackets the client RPC so the abort only
        # fires into a live (or imminent) wait.
        self._quorum_rpc_pending = False
        self._local_drain_abort = False

        # Goodput accounting (no reference counterpart; the TPU-ecosystem
        # analog is the goodput library's productive-vs-lost split):
        # wall time between consecutive commit gates, bucketed by outcome,
        # plus heal transfer time.  Updated under _goodput_lock (the heal
        # timer runs on the quorum thread).
        self._goodput_lock = threading.Lock()
        self._goodput = {
            "committed_steps": 0,
            "failed_commits": 0,
            "committed_s": 0.0,
            "failed_s": 0.0,
            "heal_count": 0,
            "heal_s": 0.0,
        }
        self._last_gate_t: Optional[float] = None
        # Heal seconds inside the CURRENT inter-gate window: subtracted
        # from the window before bucketing so heal time isn't counted as
        # productive (or doubly as lost) time.
        self._heal_since_gate = 0.0
        # Allreduce-wait seconds inside the current window (accumulated by
        # _ManagedWork._finish): subtracting them from the gate dt leaves
        # the compute residual the live digest reports as its "c" phase.
        self._allreduce_since_gate = 0.0
        # Quorum-RPC-wait seconds inside the current window (accumulated
        # by _async_quorum): priced as quorum_wait in the ledger.
        self._quorum_since_gate = 0.0
        # Whether a heal completed inside the current window: the first
        # committed gate after a heal is replay/catch-up work, not steady
        # compute, so its residual is priced as replay_catchup.
        self._healed_since_gate = False
        # Closed-taxonomy wall-clock ledger (BADPUT_KINDS): every second
        # since construction lands in exactly one bucket, so the per-kind
        # accounts tile the process lifetime by construction. The legacy
        # _goodput dict above stays as the derived back-compat view.
        self._ledger = TimeLedger()

        # Live health digest (heartbeat-carried StepDigest): rolling
        # rate/goodput window fed at every commit gate, pushed to the
        # manager server (group rank 0) at most every
        # TORCHFT_DIGEST_INTERVAL_S so it rides the heartbeats to the
        # lighthouse. TORCHFT_DIGEST=0 turns the push off entirely.
        self._digest_enabled = knobs.get_raw("TORCHFT_DIGEST") != "0"
        try:
            self._digest_interval_s = knobs.get_float(
                "TORCHFT_DIGEST_INTERVAL_S"
            )
        except ValueError:
            self._digest_interval_s = 1.0
        self._digest_window = DigestWindow()
        self._digest_last_push = 0.0

        # Rendezvous store (replica-group local; reference uses torchrun's
        # TCPStore, manager.py:271-276).
        self._store_server: Optional[TCPStoreServer] = None
        if store_addr is None:
            if self._group_rank == 0:
                # Bind to MASTER_PORT when the launcher provides one so the
                # other local ranks' env-fallback path can find us.
                master_port = int(os.environ.get("MASTER_PORT", 0))
                self._store_server = TCPStoreServer(port=master_port)
                store_addr = self._store_server.address()
            else:
                master_addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
                master_port = os.environ.get("MASTER_PORT")
                if master_port is None:
                    raise ValueError(
                        "non-zero group_rank needs store_addr or "
                        "MASTER_ADDR/MASTER_PORT"
                    )
                store_addr = f"{master_addr}:{master_port}"
        self._store_addr = store_addr
        self._store = StoreClient(store_addr, timeout=self._connect_timeout)

        # Manager server on group rank 0 (reference: manager.py:287-314).
        self._manager_server: Optional[ManagerServer] = None
        if self._group_rank == 0:
            if replica_id is None:
                replica_id = os.environ.get("REPLICA_GROUP_ID", "")
            run_id = str(uuid.uuid4())
            full_replica_id = f"{replica_id}:{run_id}" if replica_id else run_id
            if lighthouse_addr is None:
                lighthouse_addr = knobs.require("TORCHFT_LIGHTHOUSE")
            self._manager_server = ManagerServer(
                replica_id=full_replica_id,
                lighthouse_addr=lighthouse_addr,
                store_address=store_addr,
                world_size=self._group_world_size,
                quorum_retries=quorum_retries,
                heartbeat_interval_ms=heartbeat_interval_ms,
                # Job namespace this training job's frames land in at the
                # lighthouse; empty/unset stays on the binary's "default"
                # island (pre-namespace behavior, bit-for-bit).
                job=knobs.get_str("TORCHFT_JOB") or None,
            )
            self._store.set(MANAGER_ADDR_KEY, self._manager_server.address())
            self._store.set(REPLICA_ID_KEY, full_replica_id)

        manager_addr = self._store.get_str(
            MANAGER_ADDR_KEY, timeout=self._connect_timeout
        )
        self._replica_id = self._store.get_str(
            REPLICA_ID_KEY, timeout=self._connect_timeout
        )
        # Pin the journal's default id so pg/transport events from this
        # process share the manager's timeline row in obs_report.
        set_default_replica_id(self._replica_id)
        self._client = ManagerClient(manager_addr, self._connect_timeout)
        self._logger = _ManagerLogger(self)

        # Trainer-side evidence watcher (failure-evidence plane): while a
        # managed collective blocks, a side thread polls the manager
        # server's evidence cursor over its OWN connection (the shared
        # client's lock can be held for seconds by the quorum thread) and
        # aborts the wedged pg on the first hard peer-failure signal —
        # reacting at heartbeat speed instead of waiting out the collective
        # timeout. TORCHFT_EVIDENCE_WATCH=0 disables.
        self._evidence_watcher: Optional[_EvidenceWatcher] = None
        if knobs.get_raw("TORCHFT_EVIDENCE_WATCH") != "0":
            self._evidence_watcher = _EvidenceWatcher(
                self, manager_addr, self._connect_timeout
            )
        # Replica ids of the CURRENT quorum (refreshed every formation).
        # The evidence watcher only reacts to hard signals about these:
        # evidence about a replica outside the quorum — e.g. the lapsed
        # heartbeat of a killed-and-relaunched peer's previous incarnation
        # being evicted — is about a failure this quorum already survived,
        # and aborting a healthy collective over it would turn forensics
        # into an outage.
        self._evidence_peers: set = set()

        ft_futures.start_watchdog()

    # ------------------------------------------------------------------
    # State-dict registry
    # ------------------------------------------------------------------

    def register_state_dict_fn(
        self,
        key: str,
        state_dict_fn: Callable[[], Any],
        load_state_dict_fn: Callable[[Any], None],
    ) -> None:
        self._user_state_dicts[key] = state_dict_fn
        self._load_state_dicts[key] = load_state_dict_fn

    def set_state_dict_fns(
        self,
        load_state_dict: Callable[[Any], None],
        state_dict: Callable[[], Any],
    ) -> None:
        """Single-registry variant of :meth:`register_state_dict_fn`
        (reference API parity: manager.py set_state_dict_fns) — the whole
        user checkpoint as one opaque value under the "default" key."""
        self.register_state_dict_fn("default", state_dict, load_state_dict)

    def _manager_state_dict(self) -> Dict[str, Any]:
        with self._state_dict_lock.r_lock(self._timeout):
            return {
                "user": {k: fn() for k, fn in self._user_state_dicts.items()},
                "torchft": self.state_dict(),
            }

    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step, "batches_committed": self._batches_committed}

    def load_state_dict(self, state_dict: Dict[str, int]) -> None:
        self._step = state_dict["step"]
        self._batches_committed = state_dict["batches_committed"]

    def disallow_state_dict_read(self) -> None:
        """Write-locks the state dict while the optimizer mutates parameters
        (reference: local_sgd.py:109-113 pre-hook). Raises TimeoutError
        rather than proceeding unfenced — a silent failure here would let a
        concurrent checkpoint send snapshot a torn (params, step) pair."""
        if not self._state_dict_lock.acquire_write(self._timeout):
            raise TimeoutError(
                f"could not write-lock the state dict within "
                f"{self._timeout}s (checkpoint read in progress?)"
            )

    def allow_state_dict_read(self) -> None:
        self._state_dict_lock.release_write()

    def wrap_future(
        self,
        fut: "concurrent.futures.Future",
        default: Any,
        timeout: Optional[float] = None,
    ) -> "concurrent.futures.Future":
        """Attaches the FT protections to any future (reference API parity:
        manager.py:473-515 ``wrap_future``): a deadline (``timeout`` or the
        manager default), and error swallowing — a failure or timeout is
        REPORTED (latching the error so ``should_commit`` votes no) and the
        returned future resolves to ``default`` instead of raising, letting
        the training step finish with discardable values."""
        timed = ft_futures.future_timeout(
            fut, timeout if timeout is not None else self._timeout
        )
        out: concurrent.futures.Future = concurrent.futures.Future()

        def on_done(f: "concurrent.futures.Future") -> None:
            # Runs on the timeout-engine/callback thread: `out` MUST be
            # completed no matter what report_error/logging do, or the
            # caller's wait() hangs to its own deadline instead of getting
            # the swallowed default.
            completed = False
            try:
                exc = f.exception()
                if exc is None:
                    out.set_result(f.result())
                    completed = True
                else:
                    # Not _logger.exception: this callback has no active
                    # exception context (exc came from the future), so log
                    # the instance itself to keep the real failure visible.
                    self._logger.warn(f"wrapped future failed: {exc!r}")
                    self.report_error(
                        exc
                        if isinstance(exc, Exception)
                        else RuntimeError(str(exc))
                    )
            finally:
                if not completed:
                    try:
                        out.set_result(default)
                    except concurrent.futures.InvalidStateError:
                        pass

        timed.add_done_callback(on_done)
        return out

    @contextmanager
    def fenced_state_dict(self):
        """Context manager form of disallow/allow_state_dict_read: wrap
        {should_commit + optimizer apply} so heal snapshots are consistent.

        Joins the async quorum BEFORE taking the write lock: the quorum
        thread's checkpoint-send path reads the state dict under the READ
        lock, so fencing while it still runs would stall it to the lock
        timeout and fail a peer's heal needlessly."""
        try:
            self.wait_quorum()
        except Exception:  # noqa: BLE001 - latched; should_commit sees it
            pass
        self.disallow_state_dict_read()
        try:
            yield
        finally:
            self.allow_state_dict_read()

    # ------------------------------------------------------------------
    # Quorum
    # ------------------------------------------------------------------

    @traced("torchft::manager::start_quorum")
    def _journal(self, event: str, **attrs: Any) -> None:
        """Emits a step-event journal record. No-op (one env read, no
        allocation) unless TORCHFT_JOURNAL_FILE/_DIR is set."""
        log = get_event_log()
        if log is not None:
            log.emit(
                event,
                step=self._step,
                replica_id=self._replica_id,
                trace=self._trace_id or None,
                **attrs,
            )

    def _journal_lh_transitions(self, lh: Dict[str, Any]) -> None:
        """Diffs the manager server's lighthouse-HA counters against the
        last quorum's snapshot and journals each transition once:
        ``lh_failover`` (active target advanced down the list),
        ``lh_epoch`` (a new fencing epoch was accepted — takeover), and
        ``rpc_retry`` (connect-level quorum retries absorbed by the
        seeded-jitter backoff before the round succeeded or latched)."""
        if not lh:
            return
        prev = self._lh_last
        failovers = int(lh.get("failovers", 0))
        if failovers > prev.get("failovers", 0):
            self._journal(
                "lh_failover",
                failovers=failovers,
                lh_active=int(lh.get("active", 0)),
                lh_addr=str(lh.get("addr", "")),
                # Detection attribution (failure-evidence plane): how long
                # the dead target went unacked before the server moved, and
                # which trigger won — "evidence" (hard transport streak) or
                # "lease" (the timeout fallback).
                detect_ms=int(lh.get("detect_ms", -1)),
                evidence=str(lh.get("evidence", "")),
            )
        epoch = int(lh.get("epoch", 0))
        if epoch > prev.get("epoch", 0):
            self._journal(
                "lh_epoch",
                epoch=epoch,
                prev_epoch=prev.get("epoch", 0),
                lh_addr=str(lh.get("addr", "")),
            )
        retries = int(lh.get("unreachable_retries", 0))
        if retries > prev.get("unreachable_retries", 0):
            self._journal(
                "rpc_retry",
                rpc="lighthouse_quorum",
                retries=retries - prev.get("unreachable_retries", 0),
                total_retries=retries,
            )
        self._lh_last = {
            "failovers": failovers,
            "epoch": epoch,
            "unreachable_retries": retries,
        }

    def start_quorum(
        self,
        allow_heal: bool = True,
        shrink_only: bool = False,
        timeout: Optional[float] = None,
    ) -> None:
        """Begins the (possibly async) quorum for this step (reference:
        manager.py:517-573). Call at the top of the step (e.g. from
        OptimizerWrapper.zero_grad)."""
        if self._drained:
            raise RuntimeError(
                "start_quorum after leave(): a drained manager must not "
                "rejoin the quorum (relaunch the process to rejoin)"
            )
        self._journal(
            "quorum_start", allow_heal=allow_heal, shrink_only=shrink_only
        )
        # Pin the step for chaos step-window rules (``step=a-b``); listeners
        # mirror it into the native engine's chaos plane.
        _chaos.set_step(self._step)
        self._errored = None
        self._healing = False
        self._quorum_future = self._executor.submit(
            self._async_quorum,
            allow_heal,
            shrink_only,
            timeout if timeout is not None else self._quorum_timeout,
        )
        if not self._use_async_quorum:
            self.wait_quorum()
            if self._healing:
                # Transport errors surfacing here (torn fetch, reset mid
                # checkpoint apply) latch like every other heal failure —
                # the commit gate skips the step instead of the raw
                # ConnectionResetError killing the trainer.
                try:
                    self._apply_pending_state_dict()
                except Exception as e:  # noqa: BLE001 - latched, gate skips
                    self._logger.exception(f"apply healed state failed: {e}")
                    self._journal(
                        "heal_failed", error=str(e)[:200],
                        cause=type(e).__name__, phase="apply",
                    )
                    self.report_error(e)

    def wait_quorum(self) -> None:
        assert self._quorum_future is not None, (
            "wait_quorum called before start_quorum"
        )
        self._quorum_future.result()

    @traced("torchft::manager::_async_quorum")
    def _async_quorum(
        self, allow_heal: bool, shrink_only: bool, timeout: float
    ) -> None:
        from torchft_tpu_torch.coordination import RequestAborted

        t_quorum0 = time.monotonic()
        try:
            self._quorum_rpc_pending = True
            try:
                if self._local_drain_abort:
                    # The drain signal won the race to before the RPC —
                    # don't enter a wait nobody will end.
                    raise RequestAborted("drain requested before quorum")
                result = self._client._quorum(
                    group_rank=self._group_rank,
                    step=self._step,
                    checkpoint_metadata=self._checkpoint_transport.metadata(),
                    shrink_only=shrink_only,
                    timeout=timeout,
                    init_sync=self._init_sync,
                    commit_failures=self._commit_failures,
                    # The PREVIOUS generation's id: the quorum RPC is the
                    # transition between generations, so its wire frames
                    # carry the id of the step that triggered it (empty on
                    # the very first quorum). The NEW id is minted below
                    # from the result.
                    trace_id=self._trace_id,
                )
            finally:
                self._quorum_rpc_pending = False
                self._client.clear_abort()
        except RequestAborted as e:
            # The trainer's drain path interrupted the wait (a peer that
            # already drained may mean this quorum can NEVER form again —
            # waiting it out would wedge the drain past any preemption
            # grace period). Latched so the async-quorum step path fails
            # fast (local_ok=False) and the trainer's loop-top drain
            # check fires next; logged at info, not exception — a
            # deliberate interrupt, not a fault.
            self._logger.info("quorum wait aborted by drain request")
            self._journal("quorum_abort", reason="drain")
            self.report_error(e)
            raise
        except Exception as e:
            self._logger.exception(f"quorum failed: {e}")
            self._journal("quorum_abort", reason=str(e)[:200])
            self.report_error(e)
            raise
        finally:
            # Ledger split: the quorum RPC wait (including a failed or
            # aborted one) is quorum_wait badput, not compute.
            with self._goodput_lock:
                self._quorum_since_gate += time.monotonic() - t_quorum0

        quorum_id_changed = result.quorum_id != self._quorum_id
        heal = result.heal and allow_heal
        # Mint the step-scoped trace id for this quorum generation. Every
        # replica derives the same value from the shared quorum result, so
        # cross-replica correlation needs no extra agreement round.
        self._trace_id = f"q{result.quorum_id}.s{result.max_step}"
        if result.quorum is not None and result.quorum.participants:
            self._evidence_peers = {
                m.replica_id for m in result.quorum.participants
            }
        set_trace = getattr(self._pg, "set_trace_id", None)
        if set_trace is not None:
            try:
                set_trace(self._trace_id)
            except Exception:  # noqa: BLE001 - tracing must never fail a step
                pass
        lh = getattr(result, "lh", None) or {}
        self._journal(
            "quorum_ready",
            quorum_id=result.quorum_id,
            replica_rank=result.replica_rank,
            replica_world_size=result.replica_world_size,
            max_step=result.max_step,
            heal=bool(heal),
            elapsed_s=time.monotonic() - t_quorum0,
            # Fencing epoch of the lighthouse that formed this quorum: the
            # drill's exactly-one-epoch-owner assertion joins on this.
            epoch=int(lh.get("epoch", 0)),
        )
        self._journal_lh_transitions(lh)
        # Operator-initiated drain flag (latched: a one-shot observation
        # must not be lost if a later quorum response races the trainer's
        # loop-top check).
        if getattr(result, "drain_requested", False):
            self._drain_requested = True

        # A replica group started mid-run heals into a live quorum whose
        # max_step is already past 0: that is a deliberate elastic join
        # (scale-up), not crash recovery of this process — journal it once
        # so the drill/forensics planes can time capacity changes.
        if heal and result.max_step > 0 and not self._elastic_join_emitted:
            self._elastic_join_emitted = True
            self._journal(
                "elastic_join",
                quorum_id=result.quorum_id,
                replica_rank=result.replica_rank,
                replica_world_size=result.replica_world_size,
                max_step=result.max_step,
            )

        # Participation (reference: manager.py:621-640). Async quorums train
        # with the max-step group only (healing ranks rejoin next step);
        # sync quorums include everyone because recovery completes in-step.
        if self._use_async_quorum:
            if heal:
                self._participating_rank = None
                self._participating_world_size = result.max_world_size
            else:
                self._participating_rank = result.replica_rank
                self._participating_world_size = result.max_world_size
        else:
            self._participating_rank = result.replica_rank
            self._participating_world_size = result.replica_world_size

        if self._world_size_mode == WorldSizeMode.FIXED_WITH_SPARES:
            # Bench ranks beyond the fixed size (they contribute zeros).
            fixed = self._min_replica_size
            self._participating_world_size = min(
                self._participating_world_size, fixed
            )
            if (
                self._participating_rank is not None
                and self._participating_rank >= fixed
            ):
                self._participating_rank = None

        if quorum_id_changed:
            store_prefixed = (
                f"{result.store_address}/torchft/{result.quorum_id}/"
                f"{self._group_rank}"
            )
            self._logger.info(
                f"reconfiguring pg: quorum {result.quorum_id}, rank "
                f"{result.replica_rank}/{result.replica_world_size}"
            )
            try:
                # A wedged reconfigure (peer half-joined, dead store) is
                # actively aborted rather than waiting on socket timeouts
                # (reference arms timeouts on every hot path,
                # manager.py:473-515 / futures.py context_timeout).
                with ft_futures.context_timeout(
                    self._abort_pg_on_stall, self._connect_timeout
                ):
                    self._pg.configure(
                        store_prefixed,
                        result.replica_rank,
                        result.replica_world_size,
                    )
                self._quorum_id = result.quorum_id
            except Exception as e:
                self._logger.exception(f"pg configure failed: {e}")
                self.report_error(e)
                return

        self._commit_failures = max(self._commit_failures, result.commit_failures)

        # Recovery (reference: manager.py:662-729, "recovery stream"). One
        # budget covers the whole heal (metadata RPC + transfer): each
        # nested call gets the *remaining* time, so a stalled metadata fetch
        # can't leave the checkpoint transfer with a fresh full timeout and
        # blow the step deadline to 2x.
        if allow_heal:
            heal_deadline = time.monotonic() + self._timeout

            def _heal_left() -> float:
                return max(heal_deadline - time.monotonic(), 0.001)

            # Which stage of the heal the exception escaped from; latched
            # into heal_failed so a retried heal shows why attempt 1 died.
            heal_phase = "plan"
            try:
                if result.recover_dst_replica_ranks:
                    inj = _chaos.maybe(
                        "abort_heal", "heal", "heal:send",
                        match=str(result.max_step),
                    )
                    if inj is not None:
                        raise _chaos.ChaosError(f"[chaos] heal aborted: {inj}")
                    heal_phase = "send"
                    self._logger.info(
                        f"sending checkpoint to {result.recover_dst_replica_ranks}"
                    )
                    self._journal(
                        "heal_send_start",
                        dst_ranks=list(result.recover_dst_replica_ranks),
                        max_step=result.max_step,
                    )
                    with timeit(
                        "torchft::manager::send_checkpoint", self._logger
                    ) as t_send:
                        self._checkpoint_transport.send_checkpoint(
                            dst_ranks=result.recover_dst_replica_ranks,
                            step=result.max_step,
                            state_dict=self._manager_state_dict(),
                            timeout=_heal_left(),
                        )
                    self._journal(
                        "heal_send_done",
                        dst_ranks=list(result.recover_dst_replica_ranks),
                        elapsed_s=t_send["elapsed_s"],
                    )
                    heal_phase = "plan"
                if heal:
                    self._healing = True
                    inj = _chaos.maybe(
                        "abort_heal", "heal", "heal:recv",
                        peer=str(result.recover_src_replica_rank),
                        match=str(result.max_step),
                    )
                    if inj is not None:
                        raise _chaos.ChaosError(f"[chaos] heal aborted: {inj}")
                    heal_phase = "metadata"
                    src_client = ManagerClient(
                        result.recover_src_manager_address,
                        min(self._connect_timeout, _heal_left()),
                    )
                    try:
                        metadata = src_client._checkpoint_metadata(
                            self._group_rank, timeout=_heal_left()
                        )
                    finally:
                        src_client.close()
                    self._logger.info(
                        f"healing from replica_rank="
                        f"{result.recover_src_replica_rank} at step "
                        f"{result.max_step}"
                    )
                    self._journal(
                        "heal_start",
                        peer=result.recover_src_replica_rank,
                        max_step=result.max_step,
                    )
                    heal_phase = "transfer"
                    with timeit(
                        "torchft::manager::recv_checkpoint", self._logger
                    ) as t_heal:
                        state = self._checkpoint_transport.recv_checkpoint(
                            src_rank=(result.recover_src_replica_rank or 0),
                            metadata=metadata,
                            step=result.max_step,
                            timeout=_heal_left(),
                        )
                    with self._goodput_lock:
                        self._goodput["heal_count"] += 1
                        self._goodput["heal_s"] += t_heal["elapsed_s"]
                        self._heal_since_gate += t_heal["elapsed_s"]
                        self._healed_since_gate = True
                    self._journal(
                        "heal_done",
                        peer=result.recover_src_replica_rank,
                        max_step=result.max_step,
                        elapsed_s=t_heal["elapsed_s"],
                    )
                    # torchft state applies immediately; user state is
                    # deferred to the main thread (manager.py:716-720).
                    heal_phase = "load"
                    self.load_state_dict(state["torchft"])
                    self._pending_state_dict = state["user"]
            except Exception as e:
                self._logger.exception(f"recovery failed: {e}")
                self._journal(
                    "heal_failed", error=str(e)[:200],
                    cause=type(e).__name__, phase=heal_phase,
                    max_step=result.max_step,
                )
                # Hard evidence about OURSELVES: peers blocked on a
                # collective with us learn via the signal bus that this
                # heal died, instead of waiting out their own timeouts.
                self._signal(
                    "native_abort",
                    site="trainer.heal",
                    detail=f"{heal_phase}: {type(e).__name__}",
                )
                self.report_error(e)

    def _apply_pending_state_dict(self) -> None:
        """Applies the healed user state from the main thread (reference:
        manager.py:731-758)."""
        if self._pending_state_dict is None:
            return
        with trace_span("torchft::manager::_apply_pending_state_dict"):
            self._apply_pending_inner()

    def _apply_pending_inner(self) -> None:
        # Split from _apply_pending_state_dict so the no-pending early
        # return above stays outside the span.
        self.wait_quorum()
        pending, self._pending_state_dict = self._pending_state_dict, None
        for key, value in pending.items():
            if key in self._load_state_dicts:
                self._load_state_dicts[key](value)
            else:
                self._logger.info(
                    f"no load_state_dict registered for healed key {key!r}"
                )

    # ------------------------------------------------------------------
    # Collectives
    # ------------------------------------------------------------------

    @traced("torchft::manager::allreduce")
    def allreduce(
        self,
        tensors: Any,
        should_quantize: bool = False,
        quantize_bits: int = 8,
        on_local_quantized: Any = None,
        reduce_op: ReduceOp = ReduceOp.AVG,
    ) -> Work:
        """Fault-tolerant allreduce across the replica axis (reference:
        manager.py:379-450). Accepts a numpy array, torch tensor, or list
        thereof. Returns completed-or-failed Work; errors are latched,
        never raised here.

        .. warning:: ``reduce_op`` semantics DIVERGE from the reference
           deliberately. The reference's default ``ReduceOp.SUM`` divides
           the reduced tensor by ``num_participants`` afterwards (i.e. its
           SUM *yields the average*; manager.py:430-437), and its AVG
           delegates averaging to the process group. Here the ops mean
           what they say: ``AVG`` (the default) divides by the live
           participant count — the FT-correct, membership-change-safe
           average — and ``SUM`` returns the raw unscaled sum. Code ported
           from the reference that explicitly passes ``ReduceOp.SUM`` and
           expects an average must pass ``ReduceOp.AVG`` here.

        Torch tensors are copied to host numpy at this edge (bf16 through
        fp32), reduced, and ``wait()`` returns tensors on each input's own
        device and dtype. ``should_quantize=True`` takes the host quantizer
        for numpy inputs only: on CUDA tensors it raises
        ``NotImplementedError`` (the device quantize kernels are the next
        slice of the port, ROADMAP.md kernel queue) rather than quietly
        pulling fp32 to the host quantizer. ``quantize_bits=4``
        nibble-packs the payload; all replicas must use the same width."""
        if reduce_op not in (ReduceOp.SUM, ReduceOp.AVG):
            raise ValueError(
                f"manager.allreduce supports SUM/AVG, got {reduce_op}"
            )
        items = list(tensors) if isinstance(tensors, (list, tuple)) else [tensors]
        if should_quantize and any(_is_cuda(t) for t in items):
            raise NotImplementedError(
                "quantized allreduce of CUDA tensors needs the device "
                "quantize/dequantize kernels, which are not ported yet "
                "(ROADMAP.md, kernel queue: quantize + dequantize)"
            )
        templates = [t if _is_tensor(t) else None for t in items]

        def to_mutable(t: Any) -> np.ndarray:
            if _is_tensor(t):
                return _tensor_to_host(t)
            a = np.asarray(t)
            if not a.flags.writeable:  # e.g. a read-only host view
                a = np.array(a)
            return a

        arrays: List[np.ndarray] = [to_mutable(t) for t in items]
        # Every return path keeps the contract: wait() -> list of arrays
        # (tensors where tensors came in).
        try:
            self.wait_quorum()
        except Exception:
            # error already latched by _async_quorum
            return _TensorWork(DummyWork(arrays), templates)
        # Checked only AFTER the quorum: errored() also reports the process
        # group's error, and until the pending quorum has reconfigured it the
        # pg still carries the previous step's failure. Checking first let a
        # heal source skip this step's collective — the barrier that holds
        # it until its healing peer has fetched the checkpoint — and drop
        # the staged checkpoint at the commit gate before the fetch.
        if self.errored() is not None:
            return _TensorWork(DummyWork(arrays), templates)
        # Non-participants (healing/spares) contribute zeros
        # (reference: manager.py:410-411); the collective quantizes the
        # zeroed arrays, so an error-feedback callback observes the zeros
        # that actually hit the wire (its residual resets — same contract
        # as a heal).
        if self._participating_rank is None:
            for a in arrays:
                a.fill(0)

        num_participants = max(self.num_participants(), 1)
        try:
            if should_quantize:
                from torchft_tpu_torch.collectives import allreduce_quantized

                work = allreduce_quantized(
                    self._pg,
                    arrays,
                    bits=quantize_bits,
                    on_local_quantized=on_local_quantized,
                )
            else:
                work = self._pg.allreduce(arrays, ReduceOp.SUM)
        except Exception as e:
            self._logger.exception(f"allreduce failed: {e}")
            self.report_error(e)
            return _TensorWork(DummyWork(arrays), templates)

        self._journal(
            "allreduce_issue",
            nbytes=int(sum(a.nbytes for a in arrays)),
            quantized=bool(should_quantize),
        )
        return _TensorWork(
            _ManagedWork(
                self,
                work,
                arrays,
                scale=(
                    1.0 / num_participants
                    if reduce_op == ReduceOp.AVG
                    else 1.0
                ),
            ),
            templates,
        )

    # ------------------------------------------------------------------
    # Errors / commit protocol
    # ------------------------------------------------------------------

    def report_error(self, e: Exception) -> None:
        """Latches an error: the step continues with no-op comms and
        should_commit votes False (reference: manager.py:452-471)."""
        self._errored = e

    def _signal(
        self, source: str, subject: str = "", site: str = "", detail: str = ""
    ) -> None:
        """Emits failure evidence: journals a ``failure_signal`` locally
        AND queues it with the manager server for heartbeat piggyback to
        the active lighthouse (where it feeds quorum re-evaluation and
        peers' evidence watchers). Best-effort on the RPC leg — reporting
        evidence must never make the failure it reports about worse."""
        subject = subject or self._replica_id
        self._journal(
            "failure_signal",
            source=source,
            subject=subject,
            site=site or f"trainer:{self._replica_id}",
            detail=detail[:200] if detail else None,
        )
        try:
            self._client.signal(
                source,
                replica_id=subject,
                site=site or f"trainer:{self._replica_id}",
                detail={"msg": detail[:200]} if detail else None,
            )
        except Exception:  # noqa: BLE001 - advisory evidence only
            pass

    @contextmanager
    def _evidence_guard(self):
        """Arms the evidence watcher for the duration of a blocking
        collective wait (no-op when the watcher is disabled)."""
        w = self._evidence_watcher
        if w is None:
            yield
        else:
            with w.armed():
                yield

    def _abort_pg_on_stall(self) -> None:
        """Timeout-engine callback: a collective or reconfigure exceeded its
        deadline without erroring (WEDGED, not failed). Abort the process
        group so every blocked wait fails fast and the next quorum
        reconfigures — the TPU-native form of the reference's Baby-PG /
        NCCL-abort crash isolation (process_group.py:651-714, 1241-1798)."""
        self._logger.info("timeout engine: aborting wedged process group")
        try:
            self._pg.abort()
        except Exception as e:  # noqa: BLE001 - abort must never throw
            self._logger.exception(f"pg abort failed: {e}")

    def errored(self) -> Optional[Exception]:
        pg_error = self._pg.errored()
        if pg_error is not None and self._errored is None:
            self._errored = pg_error
        return self._errored

    def should_commit(self, timeout: Optional[float] = None) -> bool:
        """Distributed commit gate (reference: manager.py:760-836)."""
        gated_step = self._step  # _should_commit_inner increments on commit
        t_gate0 = time.monotonic()
        answer = self._should_commit_inner(timeout)
        log = get_event_log()
        if log is not None:
            log.emit(
                "commit_gate",
                step=gated_step,
                replica_id=self._replica_id,
                trace=self._trace_id or None,
                committed=bool(answer),
                num_participants=self.num_participants(),
                elapsed_s=time.monotonic() - t_gate0,
            )
        metrics = get_metrics_logger()
        if metrics is not None:
            metrics.log(
                self._step,
                committed=float(answer),
                num_participants=self.num_participants(),
                batches_committed=self._batches_committed,
                replica_id=self._replica_id,
            )
        return answer

    @traced("torchft::manager::should_commit")
    def _should_commit_inner(self, timeout: Optional[float]) -> bool:
        # One budget for the whole gate: joining the quorum thread and
        # applying healed state eat into it, and the commit RPC gets what's
        # left — so a slow heal can't stretch the gate to heal + timeout.
        deadline = time.monotonic() + (
            timeout if timeout is not None else self._timeout
        )
        # Join the quorum thread if nothing else has (e.g. a step with no
        # allreduce); failures are latched, not raised.
        if self._quorum_future is not None:
            try:
                self.wait_quorum()
            except Exception:  # noqa: BLE001 - latched by _async_quorum
                pass
        # Apply healed user state before deciding (sync path applies in
        # start_quorum; async path applies here, manager.py:803-804). A
        # transport error surfacing here latches like any heal failure —
        # the gate votes no instead of the trainer dying on a raw reset.
        if self._healing:
            try:
                self._apply_pending_state_dict()
            except Exception as e:  # noqa: BLE001 - latched, gate skips
                self._logger.exception(f"apply healed state failed: {e}")
                self._journal(
                    "heal_failed", error=str(e)[:200],
                    cause=type(e).__name__, phase="apply",
                )
                self.report_error(e)

        err = self.errored()
        local_ok = (
            err is None
            and self._participating_world_size >= self._min_replica_size
        )
        t_gate_rpc0 = time.monotonic()
        try:
            answer = self._client.should_commit(
                self._group_rank,
                self._step,
                local_ok,
                timeout=max(deadline - time.monotonic(), 0.001),
                trace_id=self._trace_id,
            )
        except Exception as e:
            self._logger.exception(f"should_commit RPC failed: {e}")
            answer = False
        # Time blocked in the commit-gate barrier RPC: waiting on the
        # slowest peer to arrive — the ledger's straggler_idle split.
        commit_wait_s = max(time.monotonic() - t_gate_rpc0, 0.0)

        # Fence the serving checkpoint before mutating params
        # (manager.py:818). The staged checkpoint is an immutable host
        # snapshot, so a fence failure is not a correctness problem — latch
        # rather than crash the healthy trainer.
        try:
            self._checkpoint_transport.disallow_checkpoint()
        except Exception as e:  # noqa: BLE001
            self._logger.exception(f"disallow_checkpoint failed: {e}")

        # Goodput bookkeeping BEFORE the max-retries raise: the terminal
        # failure window is exactly the one a post-mortem wants counted.
        # Heal time inside the window is excluded from the outcome bucket
        # (it is accounted separately as heal_s).
        now = time.monotonic()
        gate_dt: Optional[float] = None
        with self._goodput_lock:
            first_gate = self._last_gate_t is None
            heal_in_window = self._heal_since_gate
            if self._last_gate_t is not None:
                dt = max(
                    now - self._last_gate_t - self._heal_since_gate, 0.0
                )
                if answer:
                    self._goodput["committed_s"] += dt
                else:
                    self._goodput["failed_s"] += dt
                gate_dt = dt
            self._last_gate_t = now
            self._heal_since_gate = 0.0
            allreduce_since_gate = self._allreduce_since_gate
            self._allreduce_since_gate = 0.0
            quorum_since_gate = self._quorum_since_gate
            self._quorum_since_gate = 0.0
            healed_in_window = self._healed_since_gate
            self._healed_since_gate = False
            if answer:
                self._goodput["committed_steps"] += 1
            else:
                self._goodput["failed_commits"] += 1

        # Ledger: close [frontier, now]. Named splits claim their measured
        # seconds; the residual kind absorbs the rest of the window, so the
        # accounts tile wall-clock by construction. The window before the
        # first gate is startup (compile/init); a discarded step's residual
        # is lost work; the first committed gate after a heal is replay.
        if first_gate:
            residual = "init_compile"
        elif not answer:
            residual = "discarded_step"
        elif healed_in_window:
            residual = "replay_catchup"
        else:
            residual = "compute"
        credited = self._ledger.account(
            {
                "heal": heal_in_window,
                "exposed_comm": allreduce_since_gate,
                "quorum_wait": quorum_since_gate,
                "straggler_idle": commit_wait_s,
            },
            residual,
            upto=now,
        )
        self._journal(
            "goodput_window",
            committed=bool(answer),
            residual=residual,
            dur_s=round(sum(credited.values()), 9),
            total_s=round(self._ledger.total_s(), 9),
            splits={k: round(v, 9) for k, v in credited.items()},
        )

        if gate_dt is not None:
            # Feed the live-digest window, and record the compute residual
            # (gate-to-gate time not spent waiting on the allreduce — the
            # digest's "c" phase; heal time is already excluded from dt).
            self._digest_window.note_gate(self._step, answer, gate_dt)
            observe_span(
                "torchft::manager::step_compute",
                max(gate_dt - allreduce_since_gate, 0.0),
            )

        if answer:
            self._step += 1
            self._batches_committed += self.num_participants()
            self._commit_failures = 0
            self._consecutive_commit_failures = 0
            self._healing = False
        else:
            self._commit_failures += 1
            self._consecutive_commit_failures += 1

        # Push the live digest AFTER the failure-streak bookkeeping (so a
        # commit_stall streak is visible to the lighthouse) and BEFORE the
        # max-retries raise (the terminal streak is exactly the one an
        # operator's dashboard must show).
        self._maybe_push_digest()

        if not answer and (
            self._max_retries is not None
            and self._consecutive_commit_failures > self._max_retries
        ):
            raise ExceededMaxRetriesError(
                f"exceeded max_retries={self._max_retries} consecutive "
                "commit failures"
            )
        self._logger.info(f"should_commit={answer} (local_ok={local_ok})")
        return answer

    def _maybe_push_digest(self) -> None:
        """Builds a :class:`StepDigest` and hands it to the manager server,
        which piggybacks it on every lighthouse heartbeat. Group rank 0
        only (the server lives there), rate-limited to
        ``TORCHFT_DIGEST_INTERVAL_S`` (default 1 s), and every failure is
        swallowed: the digest is advisory telemetry and must never perturb
        a training step."""
        if not self._digest_enabled or self._group_rank != 0:
            return
        now = time.monotonic()
        if now - self._digest_last_push < self._digest_interval_s:
            return
        self._digest_last_push = now
        try:
            peer_bw = None
            bw_fn = getattr(self._pg, "peer_gib_s", None)
            if callable(bw_fn):
                peer_bw = bw_fn()
            chaos_n = 0
            ch = _chaos.active()
            if ch is not None:
                chaos_n += ch.injections_fired()
            try:
                from torchft_tpu_torch import _native

                chaos_n += _native.chaos_seq()
            except Exception:  # noqa: BLE001 - native plane optional
                pass
            digest = StepDigest.collect(
                self._digest_window,
                peer_gib_s=peer_bw,
                errored=self.errored() is not None,
                chaos_injections=chaos_n,
                commit_failures=self._consecutive_commit_failures,
                ledger=self._ledger,
            )
            # to_json() enforces the ≤512 B heartbeat budget (dropping bw,
            # then phases, if ever needed); ship the bounded form.
            self._client.set_digest(json.loads(digest.to_json()))
        except Exception:  # noqa: BLE001 - advisory only, never raise
            pass

    def goodput(self) -> Dict[str, Any]:
        """Productive-vs-lost wall-time split since startup.

        The legacy 3-way split (committed_s/failed_s/heal_s, plus
        ``goodput_frac`` = committed / (committed + failed + heal)) is a
        derived view kept for back-compat: those buckets need NOT tile
        the run window (the pre-first-gate window is unattributed there).
        The authoritative accounting is the closed-taxonomy ledger:
        ``badput_s`` (per-:data:`~torchft_tpu_torch.telemetry.BADPUT_KINDS`
        seconds) tiles ``accounted_s`` — wall-clock from construction to
        the last commit gate / drain — within float noise
        (``tiling_error_s``); ``ledger_goodput_frac`` is the compute
        share of every accounted second."""
        with self._goodput_lock:
            out = dict(self._goodput)
        denom = out["committed_s"] + out["failed_s"] + out["heal_s"]
        out["goodput_frac"] = (
            round(out["committed_s"] / denom, 4) if denom > 0 else None
        )
        badput = self._ledger.totals()
        out["badput_s"] = {k: round(v, 4) for k, v in badput.items()}
        out["accounted_s"] = round(self._ledger.total_s(), 4)
        out["tiling_error_s"] = self._ledger.tiling_error_s()
        total = sum(badput.values())
        out["ledger_goodput_frac"] = (
            round(badput["compute"] / total, 4) if total > 0 else None
        )
        return out

    # ------------------------------------------------------------------
    # Introspection (reference: manager.py:896-946)
    # ------------------------------------------------------------------

    @property
    def use_async_quorum(self) -> bool:
        return self._use_async_quorum

    def current_step(self) -> int:
        return self._step

    def batches_committed(self) -> int:
        return self._batches_committed

    def num_participants(self) -> int:
        return self._participating_world_size

    def participating_rank(self) -> Optional[int]:
        return self._participating_rank

    def is_participating(self) -> bool:
        return self._participating_rank is not None

    def replica_id(self) -> str:
        return self._replica_id

    def drain_requested(self) -> bool:
        """True once an operator asked this replica group to drain (the
        lighthouse dashboard's drain button / ``drain`` RPC). The trainer
        should finish the current step, call :meth:`leave`, and exit 0 —
        the same flow as a preemption SIGTERM.

        Normally latched from the quorum-response piggyback (zero extra
        RPCs). After a FAILED step the piggyback may never deliver — a
        whole-job drain (``drain_all``) where a peer drained one beat
        earlier means this group's quorums keep failing — so an errored
        manager falls back to one cheap out-of-band ``drain_status``
        read per check."""
        if not self._drain_requested and self._errored is not None:
            try:
                self._drain_requested = self._client.drain_status()
            except (RuntimeError, TimeoutError) as e:
                # A dead lighthouse/manager server must not silently mask a
                # pending drain forever: journal the failed probe so the
                # forensics plane sees the drain signal went dark, and the
                # next drain_requested() call retries (idempotent read).
                self._journal(
                    "rpc_retry",
                    rpc="drain_status",
                    error=str(e)[:200],
                    cause=type(e).__name__,
                )
        return self._drain_requested

    def abort_pending_quorum(self) -> bool:
        """Interrupts a blocked sync-quorum wait so a drain can proceed.

        The full-job-preemption wedge this solves: every group gets
        SIGTERM within milliseconds, but a group already blocked in a
        sync ``start_quorum`` when its signal lands waits on a quorum
        that can never form again (its peers drained and left) — the
        drain would stall the whole quorum timeout, far past a typical
        preemption grace period. Safe to call from a signal handler: it
        only sets flags and shuts down the client socket (no locks).
        After the abort, ``start_quorum``/``wait_quorum`` raise
        ``coordination.RequestAborted``; the trainer's drain path
        catches it and calls :meth:`leave` (which still works — the
        framed client reconnects). Any later ``start_quorum`` on this
        manager also aborts immediately: once draining, never re-wait.
        Returns whether a live quorum RPC was interrupted."""
        self._local_drain_abort = True
        if self._quorum_rpc_pending:
            self._client.abort()
            return True
        return False

    def leave(self, timeout: float = 5.0) -> bool:
        """Gracefully drains this replica group out of the quorum (e.g. on a
        TPU maintenance-event / preemption SIGTERM): the manager server stops
        heartbeating and the lighthouse drops us immediately, so the
        survivors' next quorum forms at tick speed (~quorum_tick_ms) instead
        of stalling until our heartbeat expires (~heartbeat_timeout_ms, 5 s
        default). Call at a step boundary after the last commit; after this
        the manager cannot rejoin — relaunch the process to rejoin. Returns
        whether the lighthouse confirmed (False = heartbeats stopped anyway;
        peers age us out on the heartbeat timeout). With
        ``group_world_size > 1`` every local rank must drain at the SAME
        step boundary (the drain signal is per-process): the shared manager
        server refuses quorum registrations once draining, so a straggler
        rank fails fast instead of wedging, but coordinated shutdown is the
        trainer's job. No reference analog: the reference's only exit paths
        are Kill → exit(1) and silent death, both of which cost survivors
        the heartbeat stall."""
        if self._drained:
            return True
        # Ledger: everything since the last gate was spent getting out,
        # not training — close the window as drain.
        self._account_drain()
        # Let an in-flight async quorum settle first so its registration
        # cannot land after (and undo) the leave.
        if self._quorum_future is not None:
            try:
                self._quorum_future.result()
            except Exception:  # noqa: BLE001 - drain proceeds regardless
                pass
        self._drained = True
        try:
            sent = self._client.leave(timeout=timeout)
        except (RuntimeError, TimeoutError) as e:
            self._logger.warn(f"graceful leave failed (peers will age us out): {e}")
            self._journal(
                "elastic_leave", confirmed=False, error=str(e)[:200],
            )
            return False
        self._logger.info("left the quorum (graceful drain)")
        self._journal("elastic_leave", confirmed=bool(sent))
        return sent

    # ------------------------------------------------------------------

    def _account_drain(self) -> None:
        """Close the ledger's open tail window as ``drain`` and journal
        the window, so offline tiling checks cover teardown too. Never
        raises: accounting must not fail a drain or shutdown."""
        try:
            credited = self._ledger.account({}, "drain")
            self._journal(
                "goodput_window",
                committed=False,
                residual="drain",
                dur_s=round(sum(credited.values()), 9),
                total_s=round(self._ledger.total_s(), 9),
                splits={k: round(v, 9) for k, v in credited.items()},
            )
        except Exception:  # noqa: BLE001 - advisory only
            pass

    def shutdown(self) -> None:
        try:
            # Close the tail window (teardown is drain, not compute) so
            # the journaled final accounts tile up to this very call.
            self._account_drain()
            g = self.goodput()
            if g["committed_steps"] or g["failed_commits"]:
                self._logger.info(f"goodput: {g}")
                self._journal("goodput", **g)
        except Exception:  # noqa: BLE001 - shutdown must not fail on a log
            pass
        if self._evidence_watcher is not None:
            self._evidence_watcher.stop()
        self._executor.shutdown(wait=False, cancel_futures=True)
        self._checkpoint_transport.shutdown()
        self._client.close()
        if self._manager_server is not None:
            self._manager_server.shutdown()
        if self._store_server is not None:
            self._store_server.shutdown()


class _EvidenceWatcher:
    """Trainer-side reaction loop of the failure-evidence plane.

    While armed (a managed collective is blocking), a daemon thread polls
    the manager server's ``evidence_status`` over its OWN connection —
    the Manager's shared client lock can be held for seconds by the async
    quorum thread, which is exactly when this watcher must stay live. On a
    failure-signal seq RISE whose last signal has a HARD source
    (``native_abort`` / ``proc_death`` / ``hb_lapse``) about a PEER in
    the current quorum, it aborts the wedged process group immediately:
    the blocked wait fails in ~one heartbeat instead of the full
    collective timeout, and the next quorum reconfigures. Soft sources
    (``rpc_error``, ``lease_expiry``, ``digest_anomaly``) only advance
    the cursor — they are noisy enough that acting on them would abort
    healthy steps — and so do hard signals about NON-members (e.g. the
    evicted previous incarnation of a relaunched peer).

    The baseline seq is (re)taken at the first poll after arming, so stale
    evidence about faults that already recovered can't abort a healthy
    collective."""

    _HARD_SOURCES = ("native_abort", "proc_death", "hb_lapse")

    def __init__(
        self, manager: "Manager", addr: str, connect_timeout: float
    ) -> None:
        self._manager = manager
        self._addr = addr
        self._connect_timeout = connect_timeout
        try:
            self._poll_s = knobs.get_float("TORCHFT_EVIDENCE_POLL_S")
        except (TypeError, ValueError):
            self._poll_s = 0.1
        if not self._poll_s or self._poll_s <= 0:
            self._poll_s = 0.1
        self._client: Optional[ManagerClient] = None
        self._armed_ev = threading.Event()
        self._stop_ev = threading.Event()
        self._base_seq: Optional[int] = None
        self._fired = False
        self._thread: Optional[threading.Thread] = None

    @contextmanager
    def armed(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="evidence_watch", daemon=True
            )
            self._thread.start()
        self._base_seq = None
        self._fired = False
        self._armed_ev.set()
        try:
            yield
        finally:
            self._armed_ev.clear()

    def stop(self) -> None:
        self._stop_ev.set()
        self._armed_ev.clear()
        if self._client is not None:
            try:
                self._client.close()
            except Exception:  # noqa: BLE001
                pass
            self._client = None

    def _run(self) -> None:
        while not self._stop_ev.is_set():
            if not self._armed_ev.is_set():
                self._armed_ev.wait(0.2)
                continue
            try:
                self._poll_once()
            except Exception:  # noqa: BLE001 - never kill the step
                if self._client is not None:
                    try:
                        self._client.close()
                    except Exception:  # noqa: BLE001
                        pass
                    self._client = None
            self._stop_ev.wait(self._poll_s)

    def _poll_once(self) -> None:
        if self._client is None:
            self._client = ManagerClient(self._addr, self._connect_timeout)
        st = self._client.evidence_status(timeout=max(self._poll_s * 5, 1.0))
        seq = int(st.get("signal_seq", 0))
        if self._base_seq is None:
            self._base_seq = seq
            return
        if seq <= self._base_seq or self._fired:
            return
        sig = st.get("signal") or {}
        source = str(sig.get("source", ""))
        subject = str(sig.get("replica_id", ""))
        if (
            source in self._HARD_SOURCES
            and subject != self._manager._replica_id
            and subject in self._manager._evidence_peers
        ):
            self._fired = True
            self._manager._journal(
                "failure_signal",
                source=source,
                subject=subject,
                site="trainer.evidence_watch",
                seq=seq,
                reaction="pg_abort",
            )
            self._manager._logger.info(
                f"evidence watcher: hard signal {source!r} on {subject} "
                f"(seq {seq}) - aborting wedged pg"
            )
            self._manager._abort_pg_on_stall()
        else:
            # Soft (or self-referential) evidence: advance the cursor and
            # keep watching for something actionable.
            self._base_seq = seq


def _is_tensor(t: Any) -> bool:
    # torch.Tensor without importing torch for numpy-only callers.
    return type(t).__module__.startswith("torch") and hasattr(t, "detach")


def _is_cuda(t: Any) -> bool:
    return _is_tensor(t) and bool(getattr(t, "is_cuda", False))


def _tensor_to_host(t: Any) -> np.ndarray:
    """A writable host numpy copy of ``t`` (bf16/fp16 widen to fp32)."""
    import torch

    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    a = t.cpu().numpy()
    if t.device.type == "cpu":  # .numpy() aliases the caller's tensor
        a = a.copy()
    return a


def _host_to_like(a: np.ndarray, like: Any) -> Any:
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=like.device, dtype=like.dtype
    )


class _TensorWork(Work):
    """Presents a host-array Work's result as tensors on the inputs' own
    devices and dtypes (numpy inputs pass through unchanged)."""

    def __init__(self, work: Work, templates: List[Any]) -> None:
        self._work = work
        self._templates = templates

    def wait(self, timeout: Optional[float] = None) -> Any:
        arrays = self._work.wait(timeout)
        if not any(t is not None for t in self._templates):
            return arrays
        return [
            a if like is None else _host_to_like(a, like)
            for a, like in zip(arrays, self._templates)
        ]

    def done(self) -> bool:
        return self._work.done()

    def exception(self) -> Optional[BaseException]:
        return self._work.exception()

    def add_done_callback(self, fn: Callable[[Work], None]) -> None:
        self._work.add_done_callback(lambda _w: fn(self))


class _ManagedWork(Work):
    """Wraps a pg Work with deferred normalization and error latching
    (reference: _ManagedWork/_ManagedFuture, manager.py:973-1251): the
    divide-by-N runs when the caller waits, and any failure is converted to
    a latched manager error with the unreduced tensors returned."""

    def __init__(
        self,
        manager: Manager,
        work: Work,
        arrays: List[Any],
        scale: float,
        in_place: bool = True,
    ) -> None:
        self._manager = manager
        self._work = work
        self._arrays = arrays
        self._scale = scale
        # in_place=False: the work's result REPLACES arrays (scaling
        # already applied by the producer). On failure the original
        # inputs are returned.
        self._in_place = in_place
        self._finished = False
        self._lock = threading.Lock()

    def _finish(self, timeout: Optional[float]) -> None:
        with self._lock:
            if self._finished:
                return
            self._finished = True
            t = timeout if timeout is not None else self._manager._timeout
            t0 = time.monotonic()
            try:
                # Belt and braces: the wait carries a deadline, AND the
                # timeout engine aborts the pg if the wait wedges past it —
                # a stalled (non-erroring) peer mid-collective must fail
                # fast, not hang until socket timeouts (reference:
                # manager.py:473-515 wrap_future + stream timeouts).
                # The evidence watcher is armed for the duration of the
                # blocking wait: first hard peer-failure signal aborts the
                # pg at heartbeat speed; the timeout engine stays as the
                # evidence-free backstop.
                with self._manager._evidence_guard():
                    with ft_futures.context_timeout(
                        self._manager._abort_pg_on_stall, t
                    ):
                        result = self._work.wait(t)
                if self._in_place:
                    for a in self._arrays:
                        a *= self._scale
                else:
                    self._arrays = list(result)
                elapsed = time.monotonic() - t0
                self._note_allreduce_wait(elapsed)
                self._manager._journal(
                    "allreduce_complete",
                    ok=True,
                    elapsed_s=elapsed,
                )
            except Exception as e:  # noqa: BLE001
                self._manager._logger.exception(f"allreduce work failed: {e}")
                elapsed = time.monotonic() - t0
                self._note_allreduce_wait(elapsed)
                self._manager._journal(
                    "allreduce_complete",
                    ok=False,
                    elapsed_s=elapsed,
                    error=str(e)[:200],
                )
                self._manager.report_error(e)

    def _note_allreduce_wait(self, elapsed: float) -> None:
        # Backend-independent wall time the TRAINER spent blocked on the
        # allreduce: the live digest's "a" phase, and the amount the commit
        # gate subtracts from gate-to-gate time to get the compute residual.
        observe_span("torchft::manager::allreduce_wait", elapsed)
        with self._manager._goodput_lock:
            self._manager._allreduce_since_gate += elapsed

    def wait(self, timeout: Optional[float] = None) -> Any:
        self._finish(timeout)
        return self._arrays

    def done(self) -> bool:
        return self._finished or self._work.done()

    def exception(self) -> Optional[BaseException]:
        return None  # errors are latched on the manager

    def add_done_callback(self, fn: Callable[[Work], None]) -> None:
        self._work.add_done_callback(lambda _w: fn(self))


class _ManagerLogger:
    """Prefixed logger (reference: manager.py:949-966)."""

    def __init__(self, manager: Manager) -> None:
        self._manager = manager

    def _prefix(self) -> str:
        m = self._manager
        return (
            f"[{m._replica_id}/{m._group_rank} - step {m._step}]"
        )

    def info(self, msg: str) -> None:
        logger.info("%s %s", self._prefix(), msg)

    def warn(self, msg: str) -> None:
        logger.warning("%s %s", self._prefix(), msg)

    def exception(self, msg: str) -> None:
        logger.exception("%s %s", self._prefix(), msg)
