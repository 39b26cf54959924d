"""Data sharding across the fault-tolerant replica axis.

The port of ``torchft_tpu/data.py`` (numpy only, copied so the port imports
nothing of the JAX package): the same index streams for the same
(dataset length, rank, world, seed, epoch) walks.

Reference: ``torchft/data.py:24-77`` — a DistributedSampler that treats the
job as ``num_replica_groups x num_replicas`` workers with
``global_rank = group_rank + num_replicas * replica_rank``; documented as
lossy under faults (a failed group's shard for that step is simply dropped).

The sampler yields index streams (or shards a numpy array of indices)
usable by any host data pipeline, a torch ``DataLoader`` included. For
replica-group-local determinism, pair with the Manager's
``batches_committed()`` to resume the stream after heal (the reference
recommends torchdata StatefulDataLoader for the same reason, data.py:13-14).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class DistributedSampler:
    """Shards ``dataset_len`` indices over the global worker grid.

    Args:
        dataset_len: number of examples.
        replica_rank: this replica group's rank on the FT axis.
        num_replica_groups: total replica groups (the FT world size the job
            was *launched* with; membership changes drop shards, they don't
            reshuffle).
        group_rank / num_replicas: position inside the replica group (the
            inner DP axis), matching the reference's rank/num_replicas.
        shuffle / seed: epoch-deterministic shuffling shared by all workers.
    """

    def __init__(
        self,
        dataset_len: int,
        replica_rank: int,
        num_replica_groups: int,
        group_rank: int = 0,
        num_replicas: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ) -> None:
        if num_replica_groups < 1 or num_replicas < 1:
            raise ValueError("world dims must be >= 1")
        self._len = dataset_len
        self.global_rank = group_rank + num_replicas * replica_rank
        self.global_world_size = num_replicas * num_replica_groups
        if self.global_rank >= self.global_world_size:
            raise ValueError(
                f"global_rank {self.global_rank} >= world "
                f"{self.global_world_size}"
            )
        self._shuffle = shuffle
        self._seed = seed
        self._drop_last = drop_last
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def reshard(
        self,
        replica_rank: int,
        num_replica_groups: int,
        group_rank: int = 0,
        num_replicas: int = 1,
    ) -> None:
        """Re-points this sampler at a new position in a RESIZED global
        worker grid (elastic scale-up/down at a quorum boundary).

        The epoch-level permutation (:meth:`global_order`) depends only on
        ``(seed, epoch, dataset_len)`` — never on the grid — so resharding
        just re-partitions it: every worker that calls ``reshard`` with the
        same new grid at the same global stream position keeps the
        exactly-once-per-epoch property (see :class:`ElasticDataIterator`,
        which tracks that position). Call at a step boundary, on every
        surviving worker, with the quorum's agreed grid."""
        if num_replica_groups < 1 or num_replicas < 1:
            raise ValueError("world dims must be >= 1")
        global_rank = group_rank + num_replicas * replica_rank
        global_world_size = num_replicas * num_replica_groups
        if global_rank >= global_world_size:
            raise ValueError(
                f"global_rank {global_rank} >= world {global_world_size}"
            )
        self.global_rank = global_rank
        self.global_world_size = global_world_size

    def __len__(self) -> int:
        if self._drop_last:
            return self._len // self.global_world_size
        return (self._len + self.global_world_size - 1) // self.global_world_size

    def indices(self) -> np.ndarray:
        order = self.global_order()
        if self._drop_last:
            usable = len(self) * self.global_world_size
            order = order[:usable]
        else:
            # Cyclic repeat covers pads larger than the dataset itself
            # (tiny datasets on large worlds), so every rank gets exactly
            # len(self) indices and loops stay in lockstep.
            order = np.resize(order, len(self) * self.global_world_size)
        return order[self.global_rank :: self.global_world_size]

    def global_order(self) -> np.ndarray:
        """The full epoch permutation, before any grid partitioning.

        World-size independent by construction (seed + epoch + length
        only): the anchor that makes elastic resharding deterministic —
        a worker that joins mid-epoch computes the IDENTICAL order as the
        incumbents and picks up its slice of the unconsumed tail."""
        order = np.arange(self._len)
        if self._shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(order)
        return order

    def __iter__(self) -> Iterator[int]:
        return iter(self.indices().tolist())


class StatefulDataIterator:
    """Resumable batch iterator over a :class:`DistributedSampler`.

    The reference points users at torchdata's ``StatefulDataLoader`` for
    per-replica-group dataloader state (torchft/data.py:13-14,
    train_ddp.py:67-70); this is the in-repo equivalent: a
    batch-index stream whose position is a tiny ``state_dict`` that can be
    registered with the Manager so a healed replica resumes EXACTLY where
    the checkpoint source was (no repeated or skipped batches), and that
    durable checkpoints capture for full-job restarts.

    Wiring:

        it = StatefulDataIterator(sampler, batch_size=8)
        manager.register_state_dict_fn(
            "data", it.state_dict, it.load_state_dict)
        for batch_idx in it:   # yields np.ndarray of dataset indices
            ...
    """

    def __init__(self, sampler: DistributedSampler, batch_size: int) -> None:
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if batch_size > len(sampler):
            raise ValueError(
                f"batch_size {batch_size} exceeds the per-rank shard "
                f"({len(sampler)} examples): every epoch would be empty"
            )
        self._sampler = sampler
        self._batch = batch_size
        self._pos = 0  # batches consumed within the current epoch
        self._cached_epoch: Optional[int] = None
        self._cached_indices: Optional[np.ndarray] = None

    def _indices(self) -> np.ndarray:
        """Epoch permutation, computed once per epoch (recomputing the
        full shuffle per batch would dominate the host input path)."""
        if self._cached_epoch != self._sampler._epoch:
            self._cached_indices = self._sampler.indices()
            self._cached_epoch = self._sampler._epoch
        return self._cached_indices

    def batches_per_epoch(self) -> int:
        return len(self._sampler) // self._batch

    def state_dict(self) -> dict:
        return {"epoch": self._sampler._epoch, "pos": self._pos}

    def load_state_dict(self, state: dict) -> None:
        self._sampler.set_epoch(int(state["epoch"]))
        self._pos = int(state["pos"])

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if self._pos >= self.batches_per_epoch():
            # Epoch boundary: reshuffle deterministically, restart stream.
            self._sampler.set_epoch(self._sampler._epoch + 1)
            self._pos = 0
        idx = self._indices()
        start = self._pos * self._batch
        self._pos += 1
        return idx[start : start + self._batch]


class ElasticDataIterator:
    """Reshard-aware batch iterator: exactly-once-per-epoch under any
    world-size walk (2 -> 8 -> 3, mid-epoch joins included).

    Where :class:`StatefulDataIterator` addresses the stream by per-rank
    batch position (fixed grid for the sampler's lifetime), this iterator
    addresses it by GLOBAL position: ``gpos`` counts indices of the
    epoch's :meth:`DistributedSampler.global_order` consumed by the whole
    fleet. Each ``__next__`` claims the next ``batch * world`` global
    indices as one lockstep fleet-batch and returns this rank's strided
    slice of it; the epoch's tail fleet-batch may be short (some ranks get
    fewer — or zero — indices rather than duplicating any).

    Elasticity contract: all participants advance in lockstep (one
    ``__next__`` per committed step), so ``gpos`` agrees fleet-wide at
    every step boundary. A resize is then just
    ``sampler.reshard(new_rank, new_world)`` between steps — the
    unconsumed tail ``order[gpos:]`` re-partitions across the new grid
    with no index lost or duplicated, and a joiner that heals
    ``state_dict()`` from an incumbent (epoch + gpos travel with the
    checkpoint) starts claiming its slice at exactly the fleet's
    position. Determinism: the yielded sequence is a pure function of
    (seed, epoch walk, reshard walk, gpos walk) — no wall clock, no
    process state."""

    def __init__(self, sampler: DistributedSampler, batch_size: int) -> None:
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self._sampler = sampler
        self._batch = batch_size
        self._gpos = 0  # global indices consumed within the current epoch
        self._cached_epoch: Optional[int] = None
        self._cached_order: Optional[np.ndarray] = None

    def _order(self) -> np.ndarray:
        if self._cached_epoch != self._sampler._epoch:
            self._cached_order = self._sampler.global_order()
            self._cached_epoch = self._sampler._epoch
        return self._cached_order

    def epoch_len(self) -> int:
        return self._sampler._len

    def batches_left(self) -> int:
        """Fleet-batches remaining this epoch at the CURRENT world size
        (the tail short batch counts as one)."""
        left = self.epoch_len() - self._gpos
        stride = self._batch * self._sampler.global_world_size
        return (left + stride - 1) // stride

    def state_dict(self) -> dict:
        return {"epoch": self._sampler._epoch, "gpos": self._gpos}

    def load_state_dict(self, state: dict) -> None:
        self._sampler.set_epoch(int(state["epoch"]))
        self._gpos = int(state["gpos"])

    def __iter__(self) -> "ElasticDataIterator":
        return self

    def __next__(self) -> np.ndarray:
        if self._gpos >= self.epoch_len():
            # Epoch boundary: reshuffle deterministically, restart stream.
            self._sampler.set_epoch(self._sampler._epoch + 1)
            self._gpos = 0
        order = self._order()
        world = self._sampler.global_world_size
        take = min(self._batch * world, self.epoch_len() - self._gpos)
        segment = order[self._gpos : self._gpos + take]
        self._gpos += take
        return segment[self._sampler.global_rank :: world]
