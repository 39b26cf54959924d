"""CheckpointTransport ABC (reference: torchft/checkpointing/transport.py:14-69).

A transport moves a live state dict from an up-to-date replica to recovering
peers during a quorum (the "heal" path, SURVEY.md §3.3). Implementations:
:class:`~torchft_tpu_torch.checkpointing.http_transport.HTTPTransport` (default)
and :class:`~torchft_tpu_torch.checkpointing.pg_transport.PGTransport`.
"""

from __future__ import annotations

from typing import Any, Generic, List, TypeVar

T = TypeVar("T")


class CheckpointTransport(Generic[T]):
    def metadata(self) -> str:
        """Opaque string a recovering peer needs to fetch from this node
        (e.g. a URL). Sent to the manager server at quorum time."""
        raise NotImplementedError

    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: T, timeout: float
    ) -> None:
        """Makes ``state_dict`` (at ``step``) available to ``dst_ranks``."""
        raise NotImplementedError

    def disallow_checkpoint(self) -> None:
        """Fences the checkpoint: after this, peers can no longer read it
        (the state dict is about to be mutated by the optimizer)."""

    def recv_checkpoint(
        self, src_rank: int, metadata: str, step: int, timeout: float
    ) -> T:
        """Fetches the state dict for ``step`` from the peer described by
        ``metadata``."""
        raise NotImplementedError

    def shutdown(self, wait: bool = True) -> None:
        """Releases resources (sockets, threads)."""
