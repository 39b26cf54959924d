"""Fault-tolerant data parallelism across replica groups.

Reference: ``torchft/ddp.py:32-105`` routes each gradient bucket through
``manager.allreduce`` via a DDP comm hook. Here the gradients of one
replica group's step come as a name -> tensor dict; this module averages
them *across replica groups*, bucketed exactly as the JAX package buckets
(``collectives.bucketize``: flat per-dtype buckets up to ``bucket_cap_mb``),
flattened on the device, one device->host copy per bucket, with the buckets'
allreduces in flight together.

A gradient may be a DTensor (a replica group sharded by FSDP2,
``parallel/train.py``): each rank puts its local shard on the wire, so rank
r of every replica group averages the same slice, and gets back a DTensor
with the gradient's placements.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from torchft_tpu_torch.collectives import takes_device_path
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch._dtensor import is_dtensor, local as _local

Grads = Dict[str, torch.Tensor]


def _like(g: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` as ``g`` is: a DTensor with ``g``'s placements where ``g``
    is one, else itself."""
    if not is_dtensor(g):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        local, g.device_mesh, g.placements, shape=g.shape, stride=g.stride()
    )


class DistributedDataParallel:
    """Averages gradient dicts across the fault-tolerant replica axis.

    Usage::

        ddp = DistributedDataParallel(manager)
        loss, grads = grad_step(model, batch)
        grads = ddp.allreduce_grads(grads)      # average over replica groups
    """

    def __init__(
        self,
        manager: Manager,
        bucket_cap_mb: float = 32.0,
        error_feedback: bool = False,
        quantize_bits: int = 8,
    ) -> None:
        self._manager = manager
        self._bucket_cap = int(bucket_cap_mb * 1024 * 1024)
        self._error_feedback = error_feedback
        self._quantize_bits = quantize_bits
        from torchft_tpu_torch.collectives import ErrorFeedback

        self._residuals = ErrorFeedback(quantize_bits)

    def allreduce_grads(
        self,
        grads: Grads,
        should_quantize: bool = False,
        quantize_bits: Optional[int] = None,
    ) -> Grads:
        """Flattens ``grads`` into <=bucket_cap flat buffers per dtype on
        their device, issues async manager allreduces for all buckets, waits,
        and rebuilds the dict (values averaged over live participants, on
        the gradients' own device).

        With ``should_quantize=True``:

        - CUDA gradients (or CPU ones with ``TORCHFT_FORCE_DEVICE_QUANT``)
          ride the manager's DEVICE quantize path: the CUDA kernels shrink
          each bucket to int8/int4 before the device->host pull, and the
          sum is dequantized on the device. Each bucket's leaves go down as
          a list in the host path's ``bucketize`` layout, so a device-path
          replica stays collective-for-collective symmetric with a
          host-path peer, and the device path concatenates them into the
          same flat payload.
        - With ``error_feedback=True`` (ctor) every bucket takes the host
          quantizer, CUDA gradients included, as in the JAX package: the
          residual hook needs the host-side (flat, q, s) of one
          quantization, which the chunked device path never has. Each
          bucket is compensated with the residual the previous step's
          quantizer dropped."""
        if quantize_bits is None:
            quantize_bits = self._quantize_bits
        elif (
            should_quantize
            and self._error_feedback
            and quantize_bits != self._quantize_bits
        ):
            raise ValueError(
                f"quantize_bits={quantize_bits} differs from the "
                f"error-feedback width {self._quantize_bits} pinned at "
                "construction; pass the width once, in the ctor"
            )
        # The wire layout takes the names sorted, as the JAX package's
        # ``tree_flatten`` takes a dict's keys, so a port replica and a JAX
        # replica fill the same buckets with the same leaves.
        names = sorted(grads)
        leaves = [_local(grads[n].detach()) for n in names]
        buckets = self._bucketize(leaves)
        if should_quantize and not self._error_feedback and takes_device_path(
            leaves
        ):
            works = [
                (
                    self._manager.allreduce(
                        [leaves[i] for i in idx_list],
                        should_quantize=True,
                        quantize_bits=quantize_bits,
                    ),
                    idx_list,
                )
                for idx_list in buckets
            ]
            out: Grads = {}
            for work, idx_list in works:
                for i, reduced in zip(idx_list, work.wait()):
                    out[names[i]] = reduced
            return {n: _like(grads[n], out[n]) for n in grads}
        flats = [
            torch.cat([leaves[i].reshape(-1) for i in idx_list])
            for idx_list in buckets
        ]
        if any(f.is_cuda for f in flats):
            # Guard the device->host pulls: if the device work feeding the
            # grads never completes, the timeout engine latches an error and
            # aborts the outer pg so the step fails fast instead of wedging
            # the trainer (reference: manager.py:473-515 stream timeouts).
            from torchft_tpu_torch import futures as ft_futures

            manager = self._manager

            def on_stall() -> None:
                manager.report_error(
                    TimeoutError("gradient device->host pull stalled")
                )
                abort = getattr(manager, "_abort_pg_on_stall", None)
                if abort is not None:
                    abort()

            ft_futures.array_timeout(
                flats, on_stall, getattr(manager, "_timeout", 60.0)
            )

        works: List[Tuple[object, List[int]]] = []
        for b_idx, (flat, idx_list) in enumerate(zip(flats, buckets)):
            on_quantized = None
            if should_quantize and self._error_feedback:
                # A host array: the manager quantizes it on the host.
                flat = self._residuals.compensate(
                    b_idx, flat.float().cpu().numpy()
                )
                on_quantized = self._residuals.make_hook(b_idx)
            work = self._manager.allreduce(
                flat,
                should_quantize=should_quantize,
                quantize_bits=quantize_bits,
                on_local_quantized=on_quantized,
            )
            works.append((work, idx_list))

        out = {}
        for work, idx_list in works:
            (reduced,) = work.wait()
            like = leaves[idx_list[0]]
            if not isinstance(reduced, torch.Tensor):  # error feedback
                reduced = torch.from_numpy(reduced).to(like.device, like.dtype)
            offset = 0
            for i in idx_list:
                n = leaves[i].numel()
                out[names[i]] = reduced[offset : offset + n].view(
                    leaves[i].shape
                )
                offset += n
        return {n: _like(grads[n], out[n]) for n in grads}

    def _bucketize(self, tensors: List[torch.Tensor]) -> List[List[int]]:
        from torchft_tpu_torch.collectives import bucketize

        return bucketize(tensors, self._bucket_cap)


class PureDistributedDataParallel:
    """One allreduce per gradient leaf, no buckets (reference:
    ``torchft/ddp.py:82-105``): the naive variant, for debugging numerics.
    The leaves go in sorted name order, as the JAX package's
    ``PureDistributedDataParallel`` flattens them."""

    def __init__(self, manager: Manager) -> None:
        self._manager = manager

    def allreduce_grads(self, grads: Grads) -> Grads:
        works = {
            n: self._manager.allreduce(_local(grads[n].detach()))
            for n in sorted(grads)
        }
        return {n: _like(grads[n], works[n].wait()[0]) for n in grads}
