"""Helpers shared by the port's trainers (``train_hsdp``, ``train_diloco``,
``train_ddp``): the device check, the preemption-drain signal, the durable
regime and the replica group's data seed. The port's copies of the repo
root ``_train_common.py``'s ``drain_signal``, ``DurableRegime`` and
``group_data_seed``; the JAX trainers' CPU pinning and perf helpers are not
ported (ROADMAP.md queue 1)."""

from __future__ import annotations

import os
import zlib


def trainer_device(name: str, prog: str):
    """``torch.device(name)``, a CUDA one with its index resolved: torchrun's
    ``LOCAL_RANK`` where the launcher set it (each rank of a group on a
    card of its own), else the current device. Exits naming ``--device
    cpu`` when ``name`` is CUDA and no card is visible, and when
    ``LOCAL_RANK`` names a card that is not there: the trainers never fall
    back on their own."""
    import torch

    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(
                f"{prog}: no CUDA device visible; pass --device cpu to run "
                "on the CPU"
            )
        if device.index is None:
            local_rank = os.environ.get("LOCAL_RANK")
            index = (
                int(local_rank) if local_rank is not None
                else torch.cuda.current_device()
            )
            if index >= torch.cuda.device_count():
                raise SystemExit(
                    f"{prog}: LOCAL_RANK={index} but {torch.cuda.device_count()} "
                    "CUDA devices are visible; run one rank per card"
                )
            device = torch.device("cuda", index)
    return device


def drain_signal(enabled: bool = True, on_signal=None):
    """Installs the preemption-drain SIGTERM handler and returns a zero-arg
    callable reading the flag: the loop drains at its next step boundary
    (finish the step, ``manager.leave()``, exit 0). A second SIGTERM
    escalates to default kill semantics.

    ``on_signal``: optional zero-arg callable run inside the handler (flags
    and socket shutdowns only). ``train_diloco`` passes
    ``manager.abort_pending_quorum`` through a late-bound holder, so a
    trainer blocked in a quorum wait when the SIGTERM lands drains at once
    instead of waiting out a quorum that may never form again."""
    import signal

    flag = [False]
    if enabled:

        def _on_sigterm(_signum, _frame):
            flag[0] = True
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            if on_signal is not None:
                try:
                    on_signal()
                except Exception:  # noqa: BLE001 - never die in a handler
                    pass

        signal.signal(signal.SIGTERM, _on_sigterm)
    return lambda: flag[0]


def group_data_seed(replica_group: str) -> int:
    """Deterministic data-shard seed for a replica group id: stable ACROSS
    process incarnations (``hash()`` is per-process randomized, which would
    hand a relaunched group an unrelated stream) and across the trainers
    (DistributedSampler semantics, reference data.py)."""
    seed = (
        int(replica_group)
        if replica_group.isdigit()
        else zlib.crc32(replica_group.encode())
    )
    return seed % (2**31)


class DurableRegime:
    """The durable-snapshot wiring shared by the train scripts: periodic
    snapshots on a committed-step cadence, a final snapshot on drain,
    restore at boot (``checkpointing/durable.py``). Composes with live
    heal: a snapshot holds the state the heal path ships, so restore
    reuses the heal loaders; what durable adds is survival of a FULL-job
    preemption (every replica drains; no live peer is left to heal from).

    ``state_factory`` must return the snapshot tree; it is called only when
    a save actually happens (off-cadence steps pay nothing). The snapshot
    copies the state before ``save`` returns, so the factory may hand over
    live tensors.

    ``rank``: the rank in a replica group whose state is sharded over its
    ranks; each rank snapshots its own shards under ``group<id>/rank<r>``.
    None (a group that holds its state whole) uses ``group<id>``."""

    def __init__(
        self, directory, replica_group: str, every: int,
        rank: "int | None" = None,
    ):
        from torchft_tpu_torch.checkpointing import DurableCheckpointer

        path = os.path.join(directory, f"group{replica_group}")
        if rank is not None:
            path = os.path.join(path, f"rank{rank}")
        self._ckpt = DurableCheckpointer(path, every=every)
        self._group = replica_group

    def restore_if_any(self):
        """Latest snapshot as a host tree, or None on a fresh boot."""
        if self._ckpt.latest_step() is None:
            return None
        return self._ckpt.restore()

    @staticmethod
    def rehang_like(cur, saved):
        """See ``DurableCheckpointer.rehang_like``: re-hangs ``saved``'s
        leaves on ``cur``'s live tree structure."""
        from torchft_tpu_torch.checkpointing.durable import DurableCheckpointer

        return DurableCheckpointer.rehang_like(cur, saved)

    @staticmethod
    def restore_manager(manager, snap) -> None:
        """Loads the manager scalars from a snapshot (the Manager stores
        plain ints)."""
        manager.load_state_dict(
            {k: int(v) for k, v in snap["manager"].items()}
        )

    def log_resumed(self, step: int) -> None:
        # Exact phrase is load-bearing: the preemption drills grep
        # "resumed from durable step N" to prove the resume source.
        print(
            f"[group {self._group}] resumed from durable step {step}",
            flush=True,
        )

    def on_commit(self, step: int, state_factory) -> None:
        self._ckpt.maybe_save(step, state_factory)

    def on_drain(self, step: int, state_factory) -> None:
        """Final synchronous snapshot at the drain boundary (skipped when
        the cadence already captured this exact step)."""
        self._ckpt.wait()
        if self._ckpt.latest_step() == step:
            return
        self._ckpt.save(step, state_factory())
        self._ckpt.wait()
        print(
            f"[group {self._group}] durable snapshot at step {step}",
            flush=True,
        )

    @property
    def saves(self):
        """``DurableCheckpointer.saves``: each snapshot's copy and write
        seconds and bytes."""
        return self._ckpt.saves

    def close(self) -> None:
        self._ckpt.close()
