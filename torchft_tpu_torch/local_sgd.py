"""LocalSGD and (Streaming) DiLoCo: communication-reducing fault-tolerant
data parallelism over the replica axis.

The port of ``torchft_tpu/local_sgd.py``, with its semantics and its
validation messages:

- ``LocalSGD``: run ``sync_every`` local optimizer steps, then average the
  parameters across replica groups and commit iff the quorum agrees.
- ``DiLoCo`` / Streaming DiLoCo: keep a backup of the last globally-agreed
  parameters; every ``sync_every`` steps compute *pseudogradients*
  (backup - local), allreduce them across groups, feed them to an **outer
  optimizer** on the backup, and merge the result into the local params
  with ``fragment_update_alpha``. Streaming splits the model into fragments
  whose syncs are staggered round-robin and overlapped with
  ``fragment_sync_delay`` inner steps of compute.

Where the state lives: the parameters are the caller's tensors, on their
device; the GLOBAL state (each fragment's backup and its outer optimizer
state) lives on the host as numpy float32, as in the JAX package. The
pseudogradient is pulled to the host once per fragment sync, its allreduce
(quantized or not) runs on the host, and the outer update and the alpha
merge are numpy float32 expressions in the JAX package's order, so both
packages compute the same bits. ``LocalSGD`` hands its tensors to
``manager.allreduce`` as they are: CUDA tensors with ``should_quantize``
take the Manager's device path (the quantize and dequantize kernels of
``ops/quantization.py``).

Fault semantics: a failed sync restores the fragment to the last global
(backup) state, so every replica that commits step N has bitwise-identical
global state.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

from torchft_tpu_torch import futures as ft_futures
from torchft_tpu_torch.collectives import ErrorFeedback, bucketize
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.telemetry import get_event_log, traced

logger = logging.getLogger(__name__)

Arrays = Dict[str, Any]


def _host_f32(x: Any) -> np.ndarray:
    """A host float32 COPY of a tensor or array (never a view of the
    caller's memory: the backup must not follow later in-place updates)."""
    if isinstance(x, np.ndarray):
        return np.array(x, np.float32)
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True).numpy()
    return np.array(x, np.float32)


def _zeros_like(x: Any) -> Any:
    if isinstance(x, np.ndarray):
        return np.zeros_like(x)
    import torch

    return torch.zeros_like(x)


class SGD:
    """``optax.sgd(learning_rate, momentum, nesterov)`` over dicts of numpy
    arrays or tensors, in optax's order of operations, so its float32 bits
    are optax's (``torch.optim.SGD`` orders its momentum differently and
    differs in the last bits)::

        trace = g + momentum * trace       # trace starts at zero
        u = g + momentum * trace           # nesterov; else u = trace
        update = u * -learning_rate        # apply: params + update

    ``init(params)`` and ``update(grads, state, params)`` follow optax's
    GradientTransformation; the state is ``{"trace": {name: array}}`` with
    momentum and ``{}`` without."""

    def __init__(
        self,
        learning_rate: float,
        momentum: Optional[float] = None,
        nesterov: bool = False,
    ) -> None:
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, params: Arrays) -> Dict[str, Any]:
        if self.momentum is None:
            return {}
        return {"trace": {k: _zeros_like(v) for k, v in params.items()}}

    def update(
        self, grads: Arrays, state: Dict[str, Any], params: Any = None
    ) -> tuple:
        del params  # optax's signature; plain SGD reads no params
        if self.momentum is None:
            updates = grads
        else:
            m = self.momentum
            trace = {k: g + m * state["trace"][k] for k, g in grads.items()}
            state = {"trace": trace}
            updates = (
                {k: g + m * trace[k] for k, g in grads.items()}
                if self.nesterov
                else trace
            )
        step = -self.learning_rate
        return {k: u * step for k, u in updates.items()}, state


def apply_updates(params: Arrays, updates: Arrays) -> Arrays:
    """``optax.apply_updates``: ``params + updates`` leaf by leaf."""
    return {k: p + updates[k] for k, p in params.items()}


def alpha_merge(global_: Any, local: Any, alpha: float) -> Any:
    """``(1 - alpha) * global + alpha * local`` in the JAX package's order,
    in float32: two products and one sum, each rounded on its own
    (``torch.lerp`` rounds otherwise, and ``add(..., alpha=)`` may fuse to
    one multiply-add on the card)."""
    return (1.0 - alpha) * global_ + alpha * local


class LocalSGD:
    """Averages full parameters across replica groups every ``sync_every``
    local steps.

    Usage::

        local_sgd = LocalSGD(manager, get_params, set_params, sync_every=32)
        for batch in data:
            train_step(model, batch)     # on the device
            local_sgd.step()             # counts; syncs on schedule

    ``get_params`` returns a name -> tensor dict; ``set_params`` writes such
    a dict (tensors, or host arrays after a heal) into the model. This class
    never holds device state itself.
    """

    def __init__(
        self,
        manager: Manager,
        get_params: Callable[[], Arrays],
        set_params: Callable[[Arrays], None],
        sync_every: int,
        should_quantize: bool = False,
        quantize_bits: int = 8,
    ) -> None:
        assert sync_every >= 1
        if should_quantize and quantize_bits < 8:
            # LocalSGD quantizes ABSOLUTE parameter values (error is
            # O(param), recurring every sync, with nothing to cancel it);
            # sub-8-bit syncs belong to DiLoCo with error feedback.
            raise ValueError(
                "LocalSGD supports quantize_bits=8 only; for 4-bit syncs "
                "use DiLoCo(should_quantize=True, quantize_bits=4, "
                "error_feedback=True)"
            )
        self._manager = manager
        self._get = get_params
        self._set = set_params
        self._sync_every = sync_every
        self._should_quantize = should_quantize
        self._quantize_bits = quantize_bits
        self._local_step = 0
        manager.register_state_dict_fn(
            "LocalSGD",
            lambda: {k: _host_f32(v) for k, v in self._get().items()},
            lambda state: self._set(state),
        )

    def step(self) -> Optional[bool]:
        """Counts one local step; returns the commit decision on sync steps,
        None otherwise."""
        self._local_step += 1
        if self._local_step < self._sync_every:
            return None
        self._local_step = 0
        return self.sync()

    @traced("torchft::local_sgd::sync")
    def sync(self) -> bool:
        """Quorum + parameter average + conditional commit."""
        manager = self._manager
        log = get_event_log()
        if log is not None:
            log.emit(
                "local_sgd_sync",
                step=manager.current_step(),
                sync_every=self._sync_every,
            )
        manager.start_quorum()
        params = self._get()
        # Sorted names: the JAX package flattens the dict in key order, so
        # both packages put the same leaf at the same place on the wire.
        names = sorted(params)
        # The tensors go to the manager AS THEY ARE: Manager.allreduce
        # sends quantized CUDA tensors down its device path (the quantize
        # kernels before the device->host pull) and hosts everything else.
        work = manager.allreduce(
            [params[n] for n in names],
            should_quantize=self._should_quantize,
            quantize_bits=self._quantize_bits,
        )
        averaged = work.wait()
        # Fenced: a concurrent checkpoint send must not snapshot the
        # bumped step with pre-merge params.
        with manager.fenced_state_dict():
            if manager.should_commit():
                averaged = dict(zip(names, averaged))
                self._set({n: averaged[n] for n in params})
                return True
        return False


class _Fragment:
    """One model fragment's DiLoCo state machine.

    Keeps ``backup`` = the last globally-committed values of this fragment's
    params (host numpy float32); ``prepare_sync`` pulls the pseudogradients
    to the host and launches the outer allreduce; ``perform_sync`` votes,
    steps the outer optimizer on the backup, and merges the result into the
    live params.
    """

    def __init__(
        self,
        index: int,
        manager: Manager,
        keys: Sequence[str],
        get_fragment: Callable[[], Arrays],
        set_fragment: Callable[[Arrays], None],
        outer_optimizer: SGD,
        fragment_update_alpha: float,
        should_quantize: bool,
        bucket_cap_mb: float = 32.0,
        quantize_bits: int = 8,
        error_feedback: bool = False,
    ) -> None:
        self.index = index
        self._manager = manager
        self.keys = list(keys)
        self._get = get_fragment
        self._set = set_fragment
        self._opt = outer_optimizer
        self._alpha = fragment_update_alpha
        self._should_quantize = should_quantize
        self._quantize_bits = quantize_bits
        self._error_feedback = error_feedback
        self._residuals = ErrorFeedback(quantize_bits)
        self._bucket_cap = int(bucket_cap_mb * 1024 * 1024)

        self._backup: Dict[str, np.ndarray] = {
            k: _host_f32(v) for k, v in get_fragment().items()
        }
        self._opt_state = self._opt.init(self._backup)
        self._pending: List[tuple] = []
        self._pending_names: List[str] = []
        self._pending_leaves: List[np.ndarray] = []

        # Healed replicas must receive the *global* state: backup + outer
        # optimizer state.
        manager.register_state_dict_fn(
            f"DiLoCoFragment_{index}",
            self._state_dict,
            self._load_state_dict,
        )

    def _state_dict(self) -> Dict[str, Any]:
        return {"backup": self._backup, "opt_state": self._opt_state}

    def _load_state_dict(self, state: Dict[str, Any]) -> None:
        self._backup = state["backup"]
        self._opt_state = state["opt_state"]
        # The healed local params restart from the global state; the
        # error-feedback residuals tracked the PRE-heal local stream, so
        # they reset too (and clear() invalidates the hooks of any
        # allreduce still in flight from before the heal).
        self._residuals.clear()
        self._set(self._backup)

    def _local_on_host(self) -> Dict[str, np.ndarray]:
        """The live params as host float32, pulled once. The pull of CUDA
        tensors is guarded: if the device work feeding them never
        completes, the manager's error latches and the outer pg aborts, so
        the sync fails instead of wedging the trainer."""
        current = self._get()
        manager = self._manager

        def on_stall() -> None:
            manager.report_error(
                TimeoutError("pseudograd device->host pull stalled")
            )
            abort = getattr(manager, "_abort_pg_on_stall", None)
            if abort is not None:
                abort()

        ft_futures.array_timeout(
            list(current.values()), on_stall, getattr(manager, "_timeout", 60.0)
        )
        return {k: _host_f32(v) for k, v in current.items()}

    @traced("torchft::local_sgd::prepare_sync")
    def prepare_sync(self) -> None:
        """Pseudograd = backup - local, launched as async outer allreduces
        (one per bucket)."""
        local = self._local_on_host()
        # Sorted names: the JAX package flattens its dict in key order, so
        # both packages lay out the same buckets for the same names.
        names = sorted(self._backup)
        leaves = [self._backup[k] - local[k] for k in names]
        # Streaming buckets: <=32 MiB flat buffers per dtype, one async
        # allreduce each, unpacked at perform_sync.
        buckets = bucketize(leaves, self._bucket_cap)
        self._pending = []
        for b_idx, idx_list in enumerate(buckets):
            flat = np.concatenate([leaves[i].reshape(-1) for i in idx_list])
            on_quantized = None
            if self._error_feedback and self._should_quantize:
                # Add the part of the previous syncs' pseudograds this
                # replica's quantizer dropped, then store what THIS
                # quantization drops (on the collective thread, through the
                # on_local_quantized hook; replica-local, reset on heal).
                flat = self._residuals.compensate(b_idx, flat)
                on_quantized = self._residuals.make_hook(b_idx)
            work = self._manager.allreduce(
                flat,
                should_quantize=self._should_quantize,
                quantize_bits=self._quantize_bits,
                on_local_quantized=on_quantized,
            )
            self._pending.append((work, idx_list))
        self._pending_names = names
        self._pending_leaves = leaves
        log = get_event_log()
        if log is not None:
            log.emit(
                "fragment_prepare_sync",
                step=self._manager.current_step(),
                fragment=self.index,
                buckets=len(buckets),
            )

    @traced("torchft::local_sgd::perform_sync")
    def perform_sync(self) -> bool:
        """Waits the bucket allreduces, votes, and merges. Returns the
        commit decision."""
        if not self._pending:
            return self._manager.should_commit()
        out: List[Any] = [None] * len(self._pending_leaves)
        for work, idx_list in self._pending:
            (reduced,) = work.wait()
            offset = 0
            for i in idx_list:
                leaf = self._pending_leaves[i]
                out[i] = np.asarray(
                    reduced[offset : offset + leaf.size]
                ).reshape(leaf.shape)
                offset += leaf.size
        self._pending = []
        pseudograd = dict(zip(self._pending_names, out))
        log = get_event_log()
        if log is not None:
            log.emit(
                "fragment_perform_sync",
                step=self._manager.current_step(),
                fragment=self.index,
            )

        # Fenced: the commit decision (step bump) and the backup/param
        # merge must be one critical section vs checkpoint-send reads
        # (the backup IS the checkpointed fragment state).
        with self._manager.fenced_state_dict():
            if self._manager.should_commit():
                updates, self._opt_state = self._opt.update(
                    pseudograd, self._opt_state, self._backup
                )
                self._backup = apply_updates(self._backup, updates)
                if self._alpha <= 0.0:
                    merged = self._backup
                else:
                    # alpha = weight of the LOCAL params:
                    # local' = (1-alpha) * global + alpha * local
                    local = {k: _host_f32(v) for k, v in self._get().items()}
                    merged = {
                        k: alpha_merge(g, local[k], self._alpha)
                        for k, g in self._backup.items()
                    }
                self._set(merged)
                return True
            # Failed sync: reset to the last global state so all committed
            # replicas stay bitwise-identical.
            self._set(self._backup)
            return False


class DiLoCo:
    """(Streaming) DiLoCo: the sync schedule over the fragments.

    ``fragments`` is a list of ``(keys, get_fn, set_fn)`` triples
    partitioning the model (see :func:`partition_fragments`); with one
    fragment this is classic DiLoCo. ``get_fn`` returns the fragment's
    name -> tensor dict; ``set_fn`` writes a name -> host float32 array dict
    into the live params and must copy it (the arrays are the fragment's
    global state). Each inner step::

        diloco.step()

    drives the schedule: one sync round happens every
    ``sync_every // n_fragments`` inner steps with fragments taking turns
    round-robin by ``manager.current_step() % n_fragments``, so every
    fragment completes exactly one sync per ``sync_every`` inner steps.
    Within a round the pseudograd allreduce launches
    ``fragment_sync_delay`` steps early, overlapping that much inner
    compute.

    ``fragment_update_alpha`` is the weight of the LOCAL params in the
    post-commit merge (``local' = (1-alpha)*global + alpha*local``); the
    default 0.0 snaps local params to the new global state.
    """

    def __init__(
        self,
        manager: Manager,
        fragments: Sequence[tuple],
        sync_every: int,
        outer_optimizer: Optional[SGD] = None,
        fragment_sync_delay: int = 0,
        fragment_update_alpha: float = 0.0,
        should_quantize: bool = False,
        bucket_cap_mb: float = 32.0,
        quantize_bits: int = 8,
        error_feedback: bool = False,
    ) -> None:
        n = len(fragments)
        assert n >= 1, "need at least one fragment"
        if getattr(manager, "use_async_quorum", False):
            raise ValueError(
                "DiLoCo requires a Manager with use_async_quorum=False: an "
                "async quorum can heal (overwrite params) mid-inner-step "
                "(reference: local_sgd.py:616-620)"
            )
        if sync_every % n != 0:
            raise ValueError(f"sync_every={sync_every} % n_fragments={n} != 0")
        if fragment_sync_delay >= sync_every // n:
            raise ValueError(
                f"fragment_sync_delay={fragment_sync_delay} must be < "
                f"sync_every/n_fragments={sync_every // n}"
            )
        if not 0.0 <= fragment_update_alpha <= 1.0:
            raise ValueError("fragment_update_alpha must be in [0, 1]")

        self._manager = manager
        self._sync_every = sync_every
        # One fragment syncs per interval; with round-robin selection every
        # fragment completes one sync per `sync_every` inner steps.
        self._interval = sync_every // n
        self._delay = fragment_sync_delay
        outer_optimizer = outer_optimizer or SGD(0.7, momentum=0.9, nesterov=True)
        self._fragments = [
            _Fragment(
                i,
                manager,
                keys,
                get_fn,
                set_fn,
                outer_optimizer,
                fragment_update_alpha,
                should_quantize,
                bucket_cap_mb,
                quantize_bits,
                error_feedback,
            )
            for i, (keys, get_fn, set_fn) in enumerate(fragments)
        ]
        self._local_step = 0
        self._prepared: Optional[_Fragment] = None

    @property
    def fragments(self) -> List[_Fragment]:
        return self._fragments

    @property
    def sync_in_flight(self) -> bool:
        """True while a fragment sync is prepared but not yet performed
        (the ``fragment_sync_delay`` overlap window). A drain must NOT
        leave here — peers are counting on this collective — but equally
        must not WAIT for a future sync to drain: that sync needs a quorum
        the departing peers may never form again."""
        return self._prepared is not None

    def state_dict(self) -> Dict[str, Any]:
        """The GLOBAL state on the host: per-fragment backup + outer
        optimizer state — exactly what a healed replica receives
        (``DiLoCoFragment_{i}`` registrations)."""
        return {
            f"fragment_{f.index}": f._state_dict() for f in self._fragments
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restores the global state into every fragment (resetting local
        params to it, same as the heal path). Must be called at an outer
        boundary — no sync may be in flight."""
        assert self._prepared is None, "load_state_dict during a sync"

        def as_host(tree: Any) -> Any:
            if isinstance(tree, Mapping):
                return {k: as_host(v) for k, v in tree.items()}
            return _host_f32(tree)

        for f in self._fragments:
            f._load_state_dict(as_host(state[f"fragment_{f.index}"]))
        self._local_step = 0

    def _current_fragment(self) -> _Fragment:
        step = self._manager.current_step()
        return self._fragments[step % len(self._fragments)]

    def step(self) -> Optional[bool]:
        """One inner step tick; returns the commit decision when a sync
        completes, else None."""
        self._local_step += 1
        result: Optional[bool] = None
        if self._local_step == self._interval - self._delay:
            # Quorum overlaps the remaining `delay` inner steps. The
            # fragment is chosen AFTER the quorum: a replica that heals in
            # it takes the healed step, and so the fragment its peers sync
            # this round. (The JAX package chooses before: a relaunched
            # replica then syncs fragment 0 while its peers sync
            # ``step % n``, and the round fails by the collective's
            # timeout.)
            self._manager.start_quorum()
            frag = self._current_fragment()
            frag.prepare_sync()
            self._prepared = frag
            if self._delay == 0:
                result = self._finish_sync()
        elif self._local_step >= self._interval:
            result = self._finish_sync()
        return result

    def _finish_sync(self) -> bool:
        frag = self._prepared
        assert frag is not None, "sync finished without prepare"
        self._prepared = None
        self._local_step = 0
        committed = frag.perform_sync()
        if not committed:
            logger.warning(
                "DiLoCo sync of fragment %d failed; params reset to last "
                "global state",
                frag.index,
            )
        return committed


def _nbytes(x: Any) -> int:
    # torch dtypes and numpy dtypes both carry ``itemsize``.
    return int(np.prod(tuple(x.shape))) * x.dtype.itemsize


def partition_fragments(
    params: Mapping[str, Any], n_fragments: int
) -> List[List[str]]:
    """Splits a ``state_dict``-style name -> tensor dict into exactly
    ``n_fragments`` contiguous, NON-empty groups of names of roughly equal
    byte size.

    The unit is the top-level key, the text before a name's first dot
    (``embed``, ``final_norm``, ``layers``, ``lm_head`` for the Llama
    decoder): the keys of the JAX package's flax parameter tree, which its
    ``partition_fragments`` splits by the same byte rule. The keys are
    taken in sorted order, the order in which JAX flattens a dict (the JAX
    trainer's params come out of ``jit`` so), so each fragment holds the
    same weights in both packages. Raises if there are fewer top-level
    keys than fragments — an empty fragment would silently skew the sync
    cadence."""
    tops: Dict[str, List[str]] = {}
    for name in params:
        tops.setdefault(name.split(".", 1)[0], []).append(name)
    keys = sorted(tops)
    if n_fragments < 1:
        raise ValueError("n_fragments must be >= 1")
    if len(keys) < n_fragments:
        raise ValueError(
            f"cannot split {len(keys)} top-level params into "
            f"{n_fragments} fragments"
        )
    sizes = {k: sum(_nbytes(params[name]) for name in tops[k]) for k in keys}
    target = sum(sizes.values()) / n_fragments
    groups: List[List[str]] = [[] for _ in range(n_fragments)]
    gi = 0
    acc = 0
    for j, k in enumerate(keys):
        keys_left = len(keys) - j
        groups_after = n_fragments - gi - 1
        # Advance when the current group is full — or must, so every
        # remaining group still gets at least one key.
        if groups[gi] and gi < n_fragments - 1 and (
            acc >= target or keys_left <= groups_after
        ):
            gi += 1
            acc = 0
        groups[gi].append(k)
        acc += sizes[k]
    return [[name for k in group for name in tops[k]] for group in groups]
