"""The inner training step of one replica group: loss, gradients, optimizer.

The port of ``torchft_tpu/parallel/train.py`` without its sharding:
``build_model`` (binds ring or Ulysses attention to a mesh), the chunked
vocab loss with the MoE router's aux term, ``grad_step`` (the DDP variant:
the optimizer applies after the Manager's replica-axis gradient allreduce)
and the default AdamW. Sharding parameters and batches inside a replica
group is not ported yet (ROADMAP.md queue 1, ``parallel/sharding.py`` +
FSDP2).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torchft_tpu_torch import knobs as _knobs
from torchft_tpu_torch.models.llama import LlamaConfig, Transformer
from torchft_tpu_torch.parallel.mesh import Mesh
from torchft_tpu_torch.parallel.pipeline import make_pipeline_loss
from torchft_tpu_torch.parallel.ring_attention import make_ring_attention
from torchft_tpu_torch.parallel.ulysses import make_ulysses_attention

Batch = Dict[str, torch.Tensor]


def build_model(cfg: LlamaConfig, mesh: Optional[Mesh] = None) -> Transformer:
    """The model of ``cfg``, with the context-parallel attention bound to
    ``mesh`` when ``cfg.attn_impl`` asks for one: ``ring`` (k/v streaming)
    or ``ulysses`` (all-to-all between sequence and heads). The JAX
    package's ``build_model``."""
    make = {"ring": make_ring_attention, "ulysses": make_ulysses_attention}
    if cfg.attn_impl in make:
        if mesh is None:
            raise ValueError(f"{cfg.attn_impl} attention requires a mesh")
        cfg = dataclasses.replace(cfg, attn_fn=make[cfg.attn_impl](mesh))
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
    """Mean next-token cross entropy over ``mask``, plus
    ``cfg.router_aux_coef`` times the MoE layers' mean load-balancing term
    (nothing for a dense model). The vocab projection runs in ``cfg.dtype``
    (the JAX package accumulates its logits straight into fp32; here a
    bf16 projection rounds them to bf16 first)."""
    cfg = model.cfg
    B, S = inputs.shape
    C = min(_LOSS_CHUNK, S)
    mask_f = mask.float()
    denom = mask_f.sum().clamp_min(1.0)

    def with_aux(loss: torch.Tensor) -> torch.Tensor:
        aux = model.router_aux()
        return loss if aux is None else loss + cfg.router_aux_coef * aux

    if S % C != 0:  # odd seq len: the plain full-logits path
        logits = model(inputs)
        losses = F.cross_entropy(
            logits.flatten(0, 1), targets.flatten(), reduction="none"
        )
        return with_aux((losses * mask_f.flatten()).sum() / denom)

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
    return with_aux(total / denom)


def grad_step(
    model: Transformer,
    batch: Batch,
    loss_fn: Optional[Callable[[Transformer, Batch], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, grads): the loss of ``batch`` ({"inputs", "targets", "mask"},
    each [B,S]) and the gradient of every parameter by name, left unapplied
    for the replica-axis allreduce. ``loss_fn(model, batch)`` replaces the
    chunked loss (``parallel.pipeline.make_pipeline_loss`` builds one)."""
    model.zero_grad(set_to_none=True)
    if loss_fn is None:
        loss = _loss_fn(model, batch["inputs"], batch["targets"], batch["mask"])
    else:
        loss = loss_fn(model, batch)
    loss.backward()
    grads = {name: p.grad for name, p in model.named_parameters()}
    return loss.detach(), grads


def pipeline_grad_step(
    model: Transformer, batch: Batch, mesh: Mesh, n_micro: int
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`grad_step` with ``model.layers`` run as a GPipe pipeline over
    ``mesh``'s ``pp`` axis in ``n_micro`` microbatches. A loop of steps
    builds the loss once and passes it to :func:`grad_step` instead."""
    return grad_step(model, batch, make_pipeline_loss(model.cfg, mesh, n_micro))
