"""Pipeline parallelism over the mesh's ``pp`` axis (GPipe schedule).

The port of ``torchft_tpu/parallel/pipeline.py``. There the stacked layer
dim of the parameters is sharded over ``pp`` and the schedule is a
``lax.scan`` over ticks inside ``shard_map``, each stage ``ppermute``-ing its
activation to the next. Here the pipeline runs over the port's
:class:`~torchft_tpu_torch.models.llama.Transformer` itself: its ``layers``
are split into ``pp`` contiguous stages, so the gradients keep the dense
model's parameter names and the replica-axis allreduce, the heal and
``params_to_jax`` need nothing new.

:func:`gpipe_loop` runs the ``n_micro + pp - 1`` ticks; within a tick the
stages run one after another, each on its own device, and an activation
moves to the next stage's device with ``.to()`` (a no-op on a mesh that
repeats one device). Autograd through the loop is the backward schedule, as
reverse-mode AD through the scan is in JAX, with the same bubble:
(pp - 1) / (n_micro + pp - 1) of the ticks. The JAX loop also runs every
stage in its bubble ticks, on inputs no output depends on; here those
ticks are skipped.

The embedding runs once before the trunk and the head and loss once after
the last stage, on full logits (not the chunked loss), as in JAX. ``dp``
is a process axis (``parallel/mesh.py``): each rank pipelines its own rows
of the batch, and its loss takes the whole batch's token count as
``denom``. A pipeline whose stages sit on other ranks is not ported
(``sharding.TP_EP_ITEM``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torchft_tpu_torch.models.llama import (
    LlamaConfig,
    Transformer,
    _linear,
    rope_table,
)
from torchft_tpu_torch.parallel.mesh import Mesh


def gpipe_loop(
    stage_fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
    x_all: torch.Tensor,
    devices: Sequence[torch.device],
) -> torch.Tensor:
    """The GPipe tick loop over ``len(stage_fns)`` stages.

    ``x_all``: [n_micro, mb, ...] stage-0 inputs. Each ``stage_fns[s]``
    must be shape-preserving (a homogeneous trunk) and run on
    ``devices[s]``. At tick t stage s takes microbatch t - s: stage 0 from
    ``x_all``, stage s > 0 what stage s - 1 sent at tick t - 1. Returns
    [n_micro, mb, ...], the last stage's outputs, on its device."""
    n_stages, n_micro = len(stage_fns), x_all.shape[0]
    recv: List[Optional[torch.Tensor]] = [None] * n_stages
    outs: List[Optional[torch.Tensor]] = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        sent: List[Optional[torch.Tensor]] = [None] * n_stages
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:  # a bubble tick of this stage
                continue
            x_in = x_all[m].to(devices[0]) if s == 0 else recv[s]
            y = stage_fns[s](x_in)
            if s == n_stages - 1:
                outs[m] = y
            else:
                sent[s + 1] = y.to(devices[s + 1])
        recv = sent
    return torch.stack(outs)


def _check_cfg(cfg: LlamaConfig, n_stages: int) -> None:
    if cfg.num_layers % n_stages != 0:
        raise ValueError(
            f"num_layers {cfg.num_layers} not divisible by pp={n_stages}"
        )
    if cfg.tie_embeddings:
        raise ValueError("pipeline: tie_embeddings unsupported (head lives "
                         "on the last stage, embed on the first)")
    if cfg.num_experts > 0:
        raise ValueError("pipeline: MoE aux-loss sow is not plumbed "
                         "through shard_map; use the ep axis instead")
    if cfg.attn_impl in ("ring", "ulysses"):
        raise ValueError("pipeline: compose with sp later; use dense/flash")


def make_pipeline_loss(
    cfg: LlamaConfig, mesh: Mesh, n_micro: int
) -> Callable[[Transformer, Dict[str, torch.Tensor]], torch.Tensor]:
    """Returns ``loss(model, batch, denom=None)``: the next-token cross
    entropy of ``batch`` ({"inputs", "targets", "mask"}, each [B, S]) over
    ``mask``, summed and divided by ``denom`` (default the batch's mask
    count: its mean), with ``model.layers`` pipelined over the mesh's
    ``pp`` axis in ``n_micro`` microbatches. Stage s's layers must live on
    the mesh's stage-s device."""
    n_stages = mesh.shape["pp"]
    _check_cfg(cfg, n_stages)
    devices = mesh.axis_devices("pp")
    per_stage = cfg.num_layers // n_stages
    H = cfg.hidden_size

    def loss_fn(
        model: Transformer,
        batch: Dict[str, torch.Tensor],
        denom: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        inputs = batch["inputs"].to(devices[0])
        B, S = inputs.shape
        if B % n_micro != 0:
            raise ValueError(f"local batch {B} not divisible by n_micro {n_micro}")
        mb = B // n_micro
        x = F.embedding(inputs, model.embed.weight.to(cfg.dtype))
        positions = torch.arange(S, device=devices[0]).expand(mb, S)
        cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)

        def stage_fn(s: int):
            blocks = model.layers[s * per_stage:(s + 1) * per_stage]
            c, sn = cos.to(devices[s]), sin.to(devices[s])

            def run(h: torch.Tensor) -> torch.Tensor:
                for block in blocks:
                    if cfg.remat and torch.is_grad_enabled():
                        h = checkpoint(block, h, c, sn, use_reentrant=False)
                    else:
                        h = block(h, c, sn)
                return h

            return run

        h_all = gpipe_loop(
            [stage_fn(s) for s in range(n_stages)],
            x.reshape(n_micro, mb, S, H),
            devices,
        )
        h = model.final_norm(h_all.reshape(B, S, H))
        logits = _linear(h, model.head_weight(), cfg.dtype).float()
        last = devices[-1]
        losses = F.cross_entropy(
            logits.flatten(0, 1), batch["targets"].to(last).flatten(),
            reduction="none",
        )
        mask_f = batch["mask"].to(last).float()
        if denom is None:
            denom = mask_f.sum().clamp_min(1.0)
        return (losses * mask_f.flatten()).sum() / denom.to(last)

    return loss_fn
