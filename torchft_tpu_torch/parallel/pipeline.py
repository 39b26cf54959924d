"""Pipeline parallelism over the mesh's ``pp`` axis (GPipe schedule).

The port of ``torchft_tpu/parallel/pipeline.py``. There the stacked layer
dim of the parameters is sharded over ``pp`` and the schedule is a
``lax.scan`` over ticks inside ``shard_map``, each stage ``ppermute``-ing its
activation to the next. Here the pipeline runs over the port's
:class:`~torchft_tpu_torch.models.llama.Transformer` itself: its ``layers``
are split into ``pp`` contiguous stages, so the gradients keep the dense
model's parameter names and the replica-axis allreduce, the heal and
``params_to_jax`` need nothing new.

The schedule runs ``n_micro + pp - 1`` ticks; at tick t stage s runs
microbatch t - s. Autograd through the loop is the backward schedule, as
reverse-mode AD through the scan is in JAX, with the same bubble:
(pp - 1) / (n_micro + pp - 1) of the ticks. The JAX loop also runs every
stage in its bubble ticks, on inputs no output depends on; here those
ticks are skipped. The stages run in one of two ways.

- **Across the ranks of a group of processes** (the mesh's
  ``process_rank`` set, ``pp`` above 1; the JAX trainer's ``make_mesh(pp=2,
  dp=n/2)``): the rank at pp coordinate s holds stage s's layers
  (``parallel.train.init_train_state``: ``layers.<i>`` for i in [s L/pp,
  (s+1) L/pp), the dense model's names) and the embedding, final norm and
  head, replicated over pp as JAX's ``pipeline_param_specs`` replicates
  them. :func:`gpipe_rank_loop` runs its stage; an activation goes to
  stage s + 1 over the group's ``pp`` subgroup inside :class:`_SendNext`
  and :class:`_RecvPrev`, whose backwards send its gradient back to stage
  s. Stage 0 embeds; the last stage takes the head and the loss. The
  replicated parameters' gradients are summed over pp after the backward
  (``parallel.train``). pp composes with dp only, as JAX's v1 does.
- **In one process that holds the whole mesh**: :func:`gpipe_loop` runs
  every stage within a tick, one after another, each on its own device, and
  an activation moves to the next stage's device with ``.to()`` (a no-op
  on a mesh that repeats one device).

The embedding runs once before the trunk and the head and loss once after
the last stage, on full logits (not the chunked loss), as in JAX. Each
rank pipelines its own rows of the batch (dp is a process axis), and its
loss takes the whole batch's token count as ``denom``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torchft_tpu_torch.models.llama import (
    LlamaConfig,
    Transformer,
    _linear,
    rope_table,
)
from torchft_tpu_torch.parallel.mesh import Mesh, axis_group, exchange


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


class _SendNext(torch.autograd.Function):
    """Stage s's output ``y`` of microbatch ``tag`` sent to group rank s +
    1; returns a zero fp32 scalar (the loss's dtype) for the stage's loss
    to carry, whose backward receives the gradient of ``y`` from stage s +
    1."""

    @staticmethod
    def forward(ctx: Any, y: torch.Tensor, group: Any, peer: int, tag: int):
        ctx.like = (tuple(y.shape), y.dtype, y.device)
        ctx.args = (group, peer, tag)
        exchange(group, [(y, peer)], [], tag)
        return y.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx: Any, _: torch.Tensor):
        shape, dtype, device = ctx.like
        group, peer, tag = ctx.args
        buf = torch.empty(shape, dtype=dtype, device=device)
        (grad,) = exchange(group, [], [(buf, peer)], tag)
        return grad, None, None, None


class _RecvPrev(torch.autograd.Function):
    """Microbatch ``tag``'s activation received from group rank s - 1, in
    a fresh tensor of ``like``'s shape; the backward sends its gradient
    back. ``anchor`` (a
    tensor that requires grad) puts the received activation on the
    autograd graph."""

    @staticmethod
    def forward(ctx: Any, anchor: torch.Tensor, like: torch.Tensor,
                group: Any, peer: int, tag: int) -> torch.Tensor:
        ctx.args = (group, peer, tag)
        (x,) = exchange(group, [], [(torch.empty_like(like), peer)], tag)
        return x

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor):
        group, peer, tag = ctx.args
        exchange(group, [(grad, peer)], [], tag)
        return None, None, None, None, None


def gpipe_rank_loop(
    stage_fn: Callable[[torch.Tensor], torch.Tensor],
    x_all: Optional[torch.Tensor],
    like: torch.Tensor,
    n_micro: int,
    group: Any,
) -> tuple:
    """This rank's stage of the GPipe tick loop over the ranks of
    ``group`` (the pp subgroup; stage s = group rank s). At tick t it runs
    microbatch t - s: stage 0 from ``x_all`` ([n_micro, mb, ...]), stage s
    > 0 on what stage s - 1 sent, received into ``like``'s shape (one
    microbatch's). Returns ``(outs, carry)``: the last stage's outputs
    [n_micro, mb, ...] (None elsewhere), and the sum of the zero scalars
    the sends return (None on the last stage), which the stage's loss must
    carry for the gradients to flow back."""
    import torch.distributed as dist

    n_stages, s = dist.get_world_size(group), dist.get_rank(group)
    anchor = like.new_zeros((), requires_grad=True)
    outs, carry = [], None
    for t in range(n_micro + n_stages - 1):
        m = t - s
        if not 0 <= m < n_micro:  # a bubble tick of this stage
            continue
        x_in = x_all[m] if s == 0 else _RecvPrev.apply(anchor, like, group, s - 1, m)
        y = stage_fn(x_in)
        if s == n_stages - 1:
            outs.append(y)
        else:
            sent = _SendNext.apply(y, group, s + 1, m)
            carry = sent if carry is None else carry + sent
    return (torch.stack(outs) if outs else None), carry


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


def _stage_runner(cfg: LlamaConfig, blocks, cos: torch.Tensor, sin: torch.Tensor):
    """``run(h)``: ``blocks`` applied in turn (each recomputed in the
    backward under ``cfg.remat``)."""

    def run(h: torch.Tensor) -> torch.Tensor:
        for block in blocks:
            if cfg.remat and torch.is_grad_enabled():
                h = checkpoint(block, h, cos, sin, use_reentrant=False)
            else:
                h = block(h, cos, sin)
        return h

    return run


def _microbatch_rope(cfg: LlamaConfig, inputs: torch.Tensor, n_micro: int, device):
    """(mb, cos, sin): one microbatch's rows and RoPE tables on
    ``device``; raises where the rows do not split into ``n_micro``."""
    B, S = inputs.shape
    if B % n_micro != 0:
        raise ValueError(f"local batch {B} not divisible by n_micro {n_micro}")
    mb = B // n_micro
    positions = torch.arange(S, device=device).expand(mb, S)
    return (mb, *rope_table(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype))


def _head_loss(
    cfg: LlamaConfig,
    model: Transformer,
    h_all: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    denom: Optional[torch.Tensor],
) -> torch.Tensor:
    """The last stage's outputs [n_micro, mb, S, H] through the final norm
    and the head to the masked cross entropy's sum over ``denom`` (default
    the batch's mask count), on their device."""
    B, S = batch["inputs"].shape
    dev = h_all.device
    h = model.final_norm(h_all.reshape(B, S, cfg.hidden_size))
    logits = _linear(h, model.head_weight(), cfg.dtype).float()
    losses = F.cross_entropy(
        logits.flatten(0, 1), batch["targets"].to(dev).flatten(), reduction="none"
    )
    mask_f = batch["mask"].to(dev).float()
    if denom is None:
        denom = mask_f.sum().clamp_min(1.0)
    return (losses * mask_f.flatten()).sum() / denom.to(dev)


def make_pipeline_loss(
    cfg: LlamaConfig, mesh: Mesh, n_micro: int
) -> Callable[[Transformer, Dict[str, torch.Tensor]], torch.Tensor]:
    """Returns ``loss(model, batch, denom=None)``: the next-token cross
    entropy of ``batch`` ({"inputs", "targets", "mask"}, each [B, S]) over
    ``mask``, summed and divided by ``denom`` (default the batch's mask
    count: its mean), with ``model.layers`` pipelined over the mesh's
    ``pp`` axis in ``n_micro`` microbatches.

    Over a group of processes with pp above 1, ``model`` holds this rank's
    stage (``parallel.train.init_train_state``) and the loss is the last
    stage's; the other stages return a zero that carries their sends
    (:func:`gpipe_rank_loop`). Else stage s's layers must live on the
    mesh's stage-s device."""
    n_stages = mesh.shape["pp"]
    _check_cfg(cfg, n_stages)
    if mesh.process_rank is not None and n_stages > 1:
        return _ranks_pipeline_loss(cfg, mesh, n_micro)
    devices = mesh.axis_devices("pp")
    per_stage = cfg.num_layers // n_stages

    def loss_fn(
        model: Transformer,
        batch: Dict[str, torch.Tensor],
        denom: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        inputs = batch["inputs"].to(devices[0])
        mb, cos, sin = _microbatch_rope(cfg, inputs, n_micro, devices[0])
        x = model.embed_tokens(inputs)
        h_all = gpipe_loop(
            [
                _stage_runner(
                    cfg, list(model.layers.values())[s * per_stage:(s + 1) * per_stage],
                    cos.to(devices[s]), sin.to(devices[s]),
                )
                for s in range(n_stages)
            ],
            x.reshape((n_micro, mb) + tuple(x.shape[1:])),
            devices,
        )
        return _head_loss(cfg, model, h_all, batch, denom)

    return loss_fn


def check_pipeline_mesh(mesh: Mesh) -> None:
    """Raises where a group of processes with pp above 1 has another axis
    above 1 but dp: the pipeline composes with dp only, as JAX's v1
    does."""
    other = {a: n for a, n in mesh.shape.items() if a not in ("dp", "pp") and n > 1}
    if mesh.process_rank is not None and mesh.shape["pp"] > 1 and other:
        raise ValueError(
            f"pipeline over pp={mesh.shape['pp']} composes with dp only, "
            f"not with {other}"
        )


def gather_stages(
    named: Dict[str, torch.Tensor], mesh: Mesh, num_layers: int
) -> Dict[str, torch.Tensor]:
    """The whole model's {name: tensor} from each pp rank's ``named``: its
    stage's layers under their names in the whole model (``layers.<i>.``,
    then anything, as ``layers.3.attn.wq.weight/exp_avg``) and the leaves
    every stage holds (equal on every stage: their gradients are summed
    over pp). Collective over ``mesh``'s pp subgroup: every rank lists its
    tensors in the same order (the stages are alike, so the k-th tensor of
    each has one shape and dtype), and each k-th tensor is gathered with
    c10d's ``all_gather_into_tensor`` on its own device. Plain tensors:
    gather a DTensor's shards first."""
    import torch.distributed as dist

    pp = mesh.shape["pp"]
    per_stage = num_layers // pp
    group = axis_group(mesh, ("pp",))
    out = {}
    for name, t in named.items():
        flat = t.detach().contiguous().reshape(-1)
        every = flat.new_empty(pp * flat.numel())
        dist.all_gather_into_tensor(every, flat, group=group)
        parts = [part.view(t.shape) for part in every.chunk(pp)]
        if not name.startswith("layers."):
            out[name] = parts[0]
            continue
        _, i, rest = name.split(".", 2)
        j = int(i) % per_stage
        for s, part in enumerate(parts):
            out[f"layers.{s * per_stage + j}.{rest}"] = part
    return out


def _ranks_pipeline_loss(
    cfg: LlamaConfig, mesh: Mesh, n_micro: int
) -> Callable[..., torch.Tensor]:
    check_pipeline_mesh(mesh)

    def loss_fn(
        model: Transformer,
        batch: Dict[str, torch.Tensor],
        denom: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        import torch.distributed as dist

        group = axis_group(mesh, ("pp",))
        s, n_stages = dist.get_rank(group), dist.get_world_size(group)
        inputs = batch["inputs"]
        mb, cos, sin = _microbatch_rope(cfg, inputs, n_micro, inputs.device)
        x_all = None
        if s == 0:
            x = model.embed_tokens(inputs)
            x_all = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
        like = torch.empty(
            (mb, inputs.shape[1], cfg.hidden_size), dtype=cfg.dtype, device=inputs.device
        )
        h_all, carry = gpipe_rank_loop(
            _stage_runner(cfg, list(model.layers.values()), cos, sin), x_all, like, n_micro, group
        )
        if s != n_stages - 1:
            return carry
        return _head_loss(cfg, model, h_all, batch, denom)

    return loss_fn
