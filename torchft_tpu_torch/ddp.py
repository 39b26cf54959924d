"""Fault-tolerant data parallelism across replica groups.

Reference: ``torchft/ddp.py:32-105`` routes each gradient bucket through
``manager.allreduce`` via a DDP comm hook. Here the gradients of one
replica group's step come as a name -> tensor dict; this module averages
them *across replica groups*, bucketed exactly as the JAX package buckets
(``collectives.bucketize``: flat per-dtype buckets up to ``bucket_cap_mb``),
flattened on the device, one device->host copy per bucket, with the buckets'
allreduces in flight together.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from torchft_tpu_torch.manager import Manager

Grads = Dict[str, torch.Tensor]


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

        ``should_quantize=True`` on CUDA gradients raises
        ``NotImplementedError``: the device quantize kernels are not ported
        yet (ROADMAP.md kernel queue). On CPU gradients it takes the host
        quantizer, with ``error_feedback`` (ctor) compensating each bucket
        with the residual the previous step's quantizer dropped."""
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
        names = list(grads)
        leaves = [grads[n] for n in names]
        if should_quantize and any(t.is_cuda for t in leaves):
            raise NotImplementedError(
                "quantized gradient allreduce of CUDA tensors needs the "
                "device quantize/dequantize kernels, which are not ported yet "
                "(ROADMAP.md, kernel queue: quantize + dequantize)"
            )
        buckets = self._bucketize(leaves)
        flats = [
            torch.cat([leaves[i].detach().reshape(-1) for i in idx_list])
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
                flat = torch.from_numpy(
                    self._residuals.compensate(b_idx, flat.numpy())
                )
                on_quantized = self._residuals.make_hook(b_idx)
            work = self._manager.allreduce(
                flat,
                should_quantize=should_quantize,
                quantize_bits=quantize_bits,
                on_local_quantized=on_quantized,
            )
            works.append((work, idx_list))

        out: Grads = {}
        for work, idx_list in works:
            (reduced,) = work.wait()
            offset = 0
            for i in idx_list:
                n = leaves[i].numel()
                out[names[i]] = reduced[offset : offset + n].view(
                    leaves[i].shape
                )
                offset += n
        return {n: out[n] for n in names}

    def _bucketize(self, tensors: List[torch.Tensor]) -> List[List[int]]:
        from torchft_tpu_torch.collectives import bucketize

        return bucketize(tensors, self._bucket_cap)
