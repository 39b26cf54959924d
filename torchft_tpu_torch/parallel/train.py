"""The inner training step of one replica group: loss, gradients, optimizer.

The port of ``torchft_tpu/parallel/train.py`` without its sharding:
``build_model`` (binds ring attention to a mesh), the chunked vocab loss,
``grad_step`` (the DDP variant: the optimizer applies after the Manager's
replica-axis gradient allreduce) and the default AdamW. Sharding parameters
and batches inside a replica group is not ported yet (ROADMAP.md queue 1,
``parallel/sharding.py`` + FSDP2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torchft_tpu_torch import knobs as _knobs
from torchft_tpu_torch.models.llama import LlamaConfig, Transformer
from torchft_tpu_torch.parallel.mesh import Mesh
from torchft_tpu_torch.parallel.ring_attention import make_ring_attention

Batch = Dict[str, torch.Tensor]


def build_model(cfg: LlamaConfig, mesh: Optional[Mesh] = None) -> Transformer:
    """The model of ``cfg``, with ring attention bound to ``mesh`` when
    ``cfg.attn_impl == 'ring'`` (the JAX package's ``build_model``;
    'ulysses' is not ported and the model raises)."""
    if cfg.attn_impl == "ring":
        if mesh is None:
            raise ValueError("ring attention requires a mesh")
        cfg = dataclasses.replace(cfg, attn_fn=make_ring_attention(mesh))
    return Transformer(cfg)


def default_optimizer(params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
    """AdamW matching ``optax.adamw(3e-4, b1=0.9, b2=0.95,
    weight_decay=0.1)`` (eps 1e-8, decoupled decay on every parameter)."""
    return torch.optim.AdamW(
        params, lr=3e-4, betas=(0.9, 0.95), weight_decay=0.1, eps=1e-8
    )


# Tokens per chunked-loss slice: the [B,S,V] fp32 logits of a 32k-vocab
# model at B=8, S=1024 are >1 GB and their log_softmax + backward multiply
# that. Chunking bounds the transient at [B, chunk, V], each chunk's logits
# recomputed in the backward (torch.utils.checkpoint).
_LOSS_CHUNK = _knobs.get_int("TORCHFT_LOSS_CHUNK")


def _chunk_loss(
    h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    logits = F.linear(h, w).float()  # [B, C, V], exists only in this chunk
    losses = F.cross_entropy(
        logits.flatten(0, 1), targets.flatten(), reduction="none"
    )
    return (losses * mask.flatten()).sum()


def _loss_fn(
    model: Transformer,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Mean next-token cross entropy over ``mask``. The vocab projection
    runs in ``cfg.dtype`` (the JAX package accumulates its logits straight
    into fp32; here a bf16 projection rounds them to bf16 first)."""
    cfg = model.cfg
    B, S = inputs.shape
    C = min(_LOSS_CHUNK, S)
    mask_f = mask.float()
    denom = mask_f.sum().clamp_min(1.0)
    if S % C != 0:  # odd seq len: the plain full-logits path
        logits = model(inputs)
        losses = F.cross_entropy(
            logits.flatten(0, 1), targets.flatten(), reduction="none"
        )
        return (losses * mask_f.flatten()).sum() / denom

    h = model(inputs, return_hidden=True)
    w = model.head_weight().to(cfg.dtype)
    total = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, C):
        sl = slice(c0, c0 + C)
        total = total + checkpoint(
            _chunk_loss,
            h[:, sl].to(cfg.dtype),
            w,
            targets[:, sl],
            mask_f[:, sl],
            use_reentrant=False,
        )
    return total / denom


def grad_step(
    model: Transformer, batch: Batch
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, grads): the loss of ``batch`` ({"inputs", "targets", "mask"},
    each [B,S]) and the gradient of every parameter by name, left unapplied
    for the replica-axis allreduce."""
    model.zero_grad(set_to_none=True)
    loss = _loss_fn(model, batch["inputs"], batch["targets"], batch["mask"])
    loss.backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    return loss.detach(), grads
