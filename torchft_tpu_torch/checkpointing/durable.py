"""Durable (on-disk) periodic checkpoints: the twin of the JAX package's
``checkpointing/durable.py``.

Two recovery regimes compose in this framework:

- **live heal** (the Manager + CheckpointTransport): a recovering replica
  streams state from a healthy peer while the job is running; it covers
  single-group failures with zero disk I/O;
- **durable checkpoints** (this module): periodic snapshots to disk so a
  FULL-job failure (every replica gone, or a planned restart) resumes from
  the last committed step.

The JAX package writes orbax snapshots; orbax needs JAX, so this package
writes its own format: one file per step, ``<directory>/<step>.ckpt``, in
the heal wire's stream format (``_serialization.save_stream``: the pickled
meta skeleton, then each raw buffer). A save writes ``<step>.ckpt.tmp``,
fsyncs it and renames it into place, so a snapshot that a SIGKILL tore
never counts as a step. Each snapshot has a structure fingerprint sidecar,
``fingerprints/<step>.json``, as in the JAX package.

``save`` copies the state to host memory that it owns before it returns
(a CPU tensor's ``.numpy()`` aliases the parameter the optimizer mutates
in place); one writer thread then writes the file, so the train loop waits
only for the device->host copy. ``wait()`` and ``close()`` join the
writer; a failed write raises there (or at the next ``save``).

Typical wiring (one designated saver, since committed state is identical
across replica groups)::

    ckpt = DurableCheckpointer(dir, every=100)
    ...
    if manager.should_commit():
        optimizer.step()
        ckpt.maybe_save(manager.current_step(), lambda: {
            "optimizer": optimizer_state_dict(optimizer, device=True),
            "manager": manager.state_dict(),
        })
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from torchft_tpu_torch._dtensor import is_dtensor
from torchft_tpu_torch.checkpointing._serialization import (
    _is_torch_tensor,
    dtype_name,
    load_stream,
    save_stream,
)

logger = logging.getLogger(__name__)

_SNAPSHOT = re.compile(r"^(\d+)\.ckpt$")


def _flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves, treedef string) in ``jax.tree_util.tree_flatten``'s order:
    a dict's keys sorted, lists and tuples in order, ``None`` an empty
    node; every other value a leaf. The string follows ``str(treedef)``'s
    form for dicts, lists, tuples and ``None``."""
    leaves: List[Any] = []

    def walk(x: Any) -> str:
        if x is None:
            return "None"
        if isinstance(x, dict):
            parts = [f"{k!r}: {walk(x[k])}" for k in sorted(x)]
            return "{" + ", ".join(parts) + "}"
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            parts = [walk(v) for v in x]
            return f"{type(x).__name__}(" + ", ".join(parts) + ")"
        if isinstance(x, tuple):
            parts = [walk(v) for v in x]
            return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
        if isinstance(x, list):
            return "[" + ", ".join(walk(v) for v in x) + "]"
        leaves.append(x)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten_like(tree: Any, leaves: List[Any]) -> Any:
    """``tree``'s structure with its leaves (in :func:`_flatten`'s order)
    replaced by ``leaves``; a dict comes back in sorted key order, as
    ``jax.tree_util.tree_unflatten`` builds it."""
    it = iter(leaves)

    def walk(x: Any) -> Any:
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: walk(x[k]) for k in sorted(x)}
        if isinstance(x, tuple):
            mapped = [walk(v) for v in x]
            return type(x)(*mapped) if hasattr(x, "_fields") else tuple(mapped)
        if isinstance(x, list):
            return [walk(v) for v in x]
        return next(it)

    return walk(tree)


def structure_fingerprint(state: Any) -> Dict[str, Any]:
    """Structural identity of a state tree: treedef string plus per-leaf
    shape/dtype. Persisted beside every snapshot so a restore into a
    *different* model/optimizer structure fails loudly at the door instead
    of silently re-hanging leaves onto the wrong slots (``rehang_like``
    matches by flattened order only)."""
    leaves, treedef = _flatten(state)

    def leaf_sig(x: Any) -> Dict[str, Any]:
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return {"shape": list(x.shape), "dtype": dtype_name(x)}
        return {"shape": [], "dtype": type(x).__name__}

    return {"treedef": treedef, "leaves": [leaf_sig(x) for x in leaves]}


def check_fingerprint(saved: Dict[str, Any], live: Dict[str, Any]) -> None:
    """Raises ``ValueError`` describing the first divergences between a
    snapshot's saved fingerprint and the live restore target's."""
    problems = []
    if saved.get("treedef") != live.get("treedef"):
        problems.append(
            "treedef mismatch:\n"
            f"  saved: {saved.get('treedef')}\n"
            f"  live:  {live.get('treedef')}"
        )
    a, b = saved.get("leaves", []), live.get("leaves", [])
    if len(a) != len(b):
        problems.append(f"leaf count mismatch: saved {len(a)} vs live {len(b)}")
    for i, (sa, sb) in enumerate(zip(a, b)):
        if sa != sb:
            problems.append(f"leaf {i}: saved {sa} vs live {sb}")
            if len(problems) >= 6:
                problems.append("... (further leaf mismatches elided)")
                break
    if problems:
        raise ValueError(
            "durable checkpoint structure mismatch — refusing to restore "
            "into a different model/optimizer structure:\n"
            + "\n".join(problems)
        )


def _owned_host_copy(x: Any) -> Any:
    """``x`` with every array leaf copied to host memory that no one else
    holds: a device tensor is pulled (a fresh host tensor), a CPU tensor
    cloned, a numpy array copied; a DTensor is its local shard (each rank
    snapshots its own)."""
    if _is_torch_tensor(x):
        t = x.detach()
        if is_dtensor(t):
            t = t.to_local()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    if isinstance(x, np.ndarray):
        return np.array(x, copy=True)
    if isinstance(x, dict):
        return {k: _owned_host_copy(v) for k, v in x.items()}
    if isinstance(x, tuple):
        mapped = [_owned_host_copy(v) for v in x]
        return type(x)(*mapped) if hasattr(x, "_fields") else tuple(mapped)
    if isinstance(x, list):
        return [_owned_host_copy(v) for v in x]
    return x


def _place_like(cur: Any, new: Any) -> Any:
    """``new`` as a leaf like ``cur``: a tensor on ``cur``'s device in its
    dtype, else a numpy array in ``cur``'s dtype."""
    if _is_torch_tensor(cur):
        import torch

        t = new if torch.is_tensor(new) else torch.from_numpy(np.array(new))
        return t.to(device=cur.device, dtype=cur.dtype)
    return np.asarray(new).astype(np.asarray(cur).dtype, copy=False)


class DurableCheckpointer:
    """Periodic asynchronous checkpoints with retention.

    ``every``: save cadence in committed steps (``maybe_save``).
    ``keep``: snapshots retained (the oldest are pruned, sidecars too).
    """

    def __init__(
        self, directory: str, every: int = 100, keep: int = 3
    ) -> None:
        self._every = max(int(every), 1)
        self._keep = max(int(keep), 1)
        self._dir = Path(directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._queue: "queue.Queue[Optional[Tuple[int, Any, float]]]" = (
            queue.Queue()
        )
        self._error: Optional[BaseException] = None
        # One record per snapshot on disk: {"step", "copy_s" (the host copy
        # on the caller's thread), "write_s" (the writer's file, fsync and
        # rename), "nbytes" (the file's size)}.
        self.saves: List[Dict[str, Any]] = []
        self._closed = False
        self._writer = threading.Thread(
            target=self._write_loop, name="durable-writer", daemon=True
        )
        self._writer.start()

    @staticmethod
    def rehang_like(cur: Any, saved: Any) -> Any:
        """Re-hangs ``saved``'s leaves on ``cur``'s tree structure by
        flattened-leaf order (a dict's keys sorted, as JAX flattens),
        casting each leaf to the live leaf's dtype: a tensor onto the live
        leaf's device, anything else as numpy."""
        cur_leaves, _ = _flatten(cur)
        new_leaves, _ = _flatten(saved)
        if len(cur_leaves) != len(new_leaves):
            raise ValueError(
                f"state leaf count mismatch: live {len(cur_leaves)} vs "
                f"saved {len(new_leaves)}"
            )
        return _unflatten_like(
            cur, [_place_like(c, n) for c, n in zip(cur_leaves, new_leaves)]
        )

    def maybe_save(self, step: int, state: Any) -> bool:
        """Saves iff ``step`` is on the cadence. Returns whether it saved.

        ``state`` may be a zero-arg callable, invoked only on cadence
        steps, so callers whose state construction is expensive build it
        only when a save actually happens."""
        if step % self._every != 0:
            return False
        self.save(step, state() if callable(state) else state)
        return True

    def save(self, step: int, state: Any) -> None:
        """Copies ``state`` (a tree of tensors, numpy arrays and scalars)
        to owned host memory, then writes it on the writer thread. Returns
        once the copy is made; ``wait()`` blocks until the file is in
        place."""
        self._raise_pending()
        if self._closed:
            raise RuntimeError("DurableCheckpointer is closed")
        t0 = time.monotonic()
        owned = _owned_host_copy(state)
        self._queue.put((int(step), owned, time.monotonic() - t0))

    # -- the writer -------------------------------------------------------

    def _path(self, step: int) -> Path:
        return self._dir / f"{step}.ckpt"

    def _write_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                if self._error is None:
                    self._write(*item)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e
            finally:
                self._queue.task_done()

    def _write(self, step: int, state: Any, copy_s: float) -> None:
        t0 = time.monotonic()
        path = self._path(step)
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            save_stream(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self._dir)
        self.saves.append({
            "step": step, "copy_s": copy_s,
            "write_s": time.monotonic() - t0, "nbytes": path.stat().st_size,
        })
        self._write_fingerprint(step, state)
        for old in self.all_steps()[: -self._keep]:
            self._path(old).unlink(missing_ok=True)
            self._fingerprint_path(old).unlink(missing_ok=True)

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"durable snapshot write failed: {err!r}") from err

    # -- structure fingerprints -------------------------------------------

    def _fingerprint_path(self, step: int) -> Path:
        return self._dir / "fingerprints" / f"{step}.json"

    def _write_fingerprint(self, step: int, state: Any) -> None:
        try:
            fp = structure_fingerprint(state)
            fpdir = self._dir / "fingerprints"
            fpdir.mkdir(parents=True, exist_ok=True)
            self._fingerprint_path(step).write_text(json.dumps(fp))
        except Exception as e:  # noqa: BLE001 - sidecar must never fail a save
            logger.warning("could not write structure fingerprint: %s", e)

    def _load_fingerprint(self, step: int) -> Optional[Dict[str, Any]]:
        path = self._fingerprint_path(step)
        try:
            if not path.exists():
                return None  # snapshot without a sidecar
            return json.loads(path.read_text())
        except Exception as e:  # noqa: BLE001 - torn/unreadable sidecar
            logger.warning("unreadable structure fingerprint %s: %s", path, e)
            return None

    # -- reading ----------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Steps with a complete snapshot on disk, ascending (a ``.tmp``
        left by a torn save is not one)."""
        steps = []
        for f in self._dir.iterdir():
            m = _SNAPSHOT.match(f.name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self, abstract_state: Any = None, step: Optional[int] = None
    ) -> Any:
        """Restores the given (or latest) step.

        ``abstract_state``: a tree like the saved one (live tensors or
        arrays); its fingerprint is checked against the snapshot's first,
        and each restored leaf lands on the device and in the dtype of the
        matching leaf. With ``None``, array leaves restore as host numpy
        (bfloat16 ones as CPU tensors)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        path = self._path(step)
        if not path.exists():
            raise FileNotFoundError(f"no checkpoint for step {step} at {path}")
        if abstract_state is not None:
            saved_fp = self._load_fingerprint(step)
            if saved_fp is not None:
                check_fingerprint(saved_fp, structure_fingerprint(abstract_state))
        with open(path, "rb") as f:
            state = load_stream(f)
        if abstract_state is None:
            return state
        return self.rehang_like(abstract_state, state)

    def wait(self) -> None:
        """Blocks until every queued save is on disk; raises if one
        failed."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._queue.put(None)
            self._writer.join()
        self._raise_pending()


def _fsync_dir(directory: Path) -> None:
    """Makes a rename in ``directory`` durable."""
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
