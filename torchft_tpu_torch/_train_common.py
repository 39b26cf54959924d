"""Helpers shared by the port's trainers (``train_hsdp``, ``train_diloco``,
``train_ddp``): the flags not ported yet, the device check, the
preemption-drain signal and the replica group's data seed. The port's
copies of the repo root ``_train_common.py``'s ``drain_signal`` and
``group_data_seed``; the JAX trainers' CPU pinning, durable regime and perf
helpers are not ported (ROADMAP.md queue 1)."""

from __future__ import annotations

import zlib

# Flags the JAX trainers have whose paths are not ported yet, with the
# ROADMAP.md item that ports them.
UNPORTED = {
    "pg-sharded": "queue 1: checkpointing/pg_transport + sharded",
    "durable_dir": "queue 1: checkpointing/durable",
}


def trainer_device(name: str, prog: str):
    """``torch.device(name)``, a CUDA one with its index resolved. Exits
    naming ``--device cpu`` when ``name`` is CUDA and no card is visible:
    the trainers never fall back to the CPU on their own."""
    import torch

    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(
                f"{prog}: no CUDA device visible; pass --device cpu to run "
                "on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
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
