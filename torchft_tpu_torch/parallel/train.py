"""The inner training step of one replica group: loss, gradients, optimizer.

The port of ``torchft_tpu/parallel/train.py``: ``build_model`` (binds ring
or Ulysses attention to a mesh), the chunked vocab loss with the MoE
router's aux term and the default AdamW, in two forms.

- **Sharded** (the JAX package's pjit step): :func:`init_train_state`
  builds the state born sharded over the group's process axes: the
  tensor-parallel plan over (ep, tp), then FSDP2 over (dp, fsdp),
  replicated over sp, and split by stage over pp; and
  :func:`make_train_step` (``accum_steps``),
  :func:`make_grad_step` (the DDP variant ``train_hsdp`` runs: the
  optimizer applies after the Manager's replica-axis gradient allreduce)
  and :func:`make_eval_step` run on each rank's rows of the global batch.
  The group is the default torch process group
  (``parallel.mesh.init_group``).
- **Mesh-free**: :func:`grad_step` and :func:`pipeline_grad_step` on a
  plain model, for callers that pass no mesh.

The losses of the ranks of a group add up to the global batch's: each rank
normalizes its block's token losses by the whole batch's mask count and
scales by the size of its batch group (the ranks of (dp, fsdp, sp) at its
own (pp, ep, tp) coordinate, which hold the batch's blocks between them),
because FSDP2 averages the gradients over that group: the DeviceMesh's
``dp`` dim spans the (dp, sp) ranks (``parallel.mesh.group_device_mesh``;
the parameters are replicated over sp, so this is JAX's implied psum of
the rank's share). The ranks of (ep,
tp) at one (dp, fsdp, sp) coordinate hold the same block and compute the
same loss. Over ``pp`` the last stage computes the loss; the embedding,
final norm and head, replicated over pp, have their gradients summed over
the ``pp`` subgroup after the backward (each stage holds its part: the
embedding's on stage 0, the head's on the last), and the reported loss is
summed over pp as well, so every rank logs and votes the same number.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from torchft_tpu_torch import knobs as _knobs
from torchft_tpu_torch.models.llama import (
    Block,
    LlamaConfig,
    RMSNorm,
    Transformer,
    _linear,
    _SumOverGroups,
    _to_groups,
)
from torchft_tpu_torch.parallel.mesh import Mesh, axis_group, group_device_mesh
from torchft_tpu_torch.parallel.pipeline import check_pipeline_mesh, make_pipeline_loss
from torchft_tpu_torch.parallel.ring_attention import make_ring_attention
from torchft_tpu_torch.parallel.sharding import (
    batch_sharding,
    param_placements,
    param_specs,
    placement,
    shard_dim,
    spec_for,
    tp_plan,
    tree_specs_like,
)
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


def _vocab_parallel_losses(
    logits: torch.Tensor, targets: torch.Tensor, v0: int, group: Any
) -> torch.Tensor:
    """Per-token cross entropy [N] from each rank's block of the vocab's
    fp32 logits [N, V/tp] (vocab ids ``v0`` onward): the max and the sum of
    exponentials taken over the group's blocks, the target's logit from the
    block that holds it. Differentiable; every rank gets the same losses."""
    import torch.distributed as dist

    m = logits.detach().amax(-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    z = logits - m[:, None]
    total = _SumOverGroups.apply(z.exp().sum(-1), (group,))
    ids = targets - v0
    hit = (ids >= 0) & (ids < logits.shape[-1])
    picked = z.gather(-1, ids.clamp(0, logits.shape[-1] - 1)[:, None])[:, 0]
    picked = _SumOverGroups.apply(torch.where(hit, picked, 0.0), (group,))
    return total.log() - picked


def _chunk_loss(
    h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
    group: Any = None, v0: int = 0,
) -> torch.Tensor:
    logits = F.linear(h, w).float()  # [B, C, V], exists only in this chunk
    if group is None:
        losses = F.cross_entropy(
            logits.flatten(0, 1), targets.flatten(), reduction="none"
        )
    else:
        losses = _vocab_parallel_losses(
            logits.flatten(0, 1), targets.flatten(), v0, group
        )
    return (losses * mask.flatten()).sum()


def _loss_body(
    model: Transformer,
    inputs: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    denom: Optional[torch.Tensor] = None,
    group: Any = None,
) -> torch.Tensor:
    """The loss of :func:`_loss_fn`, run inside ``model.call``. ``denom``:
    the token count the losses are normalized by (default this batch's
    mask count). ``group``: the torch process group of ranks that each hold
    rows of one batch; the loss is then scaled by its size and the MoE aux
    term taken over the whole batch (see the module docstring).

    A model bound to a tensor-parallel group holds its head in blocks of
    vocab rows: the chunked loss computes each rank's block of the logits
    and a vocab-parallel softmax (a max and a sum over the group,
    :func:`_vocab_parallel_losses`), and the hidden states' gradient is
    summed over the group; the full-logits path of an odd sequence length
    gathers the head (``Transformer.head_weight``)."""
    cfg = model.cfg
    B, S = inputs.shape
    C = min(_LOSS_CHUNK, S)
    mask_f = mask.float()
    if denom is None:
        denom = mask_f.sum().clamp_min(1.0)

    def finish(total: torch.Tensor) -> torch.Tensor:
        loss = total / denom
        if group is not None:
            loss = loss * torch.distributed.get_world_size(group)
        aux = model.router_aux(group)
        return loss if aux is None else loss + cfg.router_aux_coef * aux

    if S % C != 0:  # odd seq len: the plain full-logits path
        logits = _linear(model.hidden(inputs), model.head_weight(), cfg.dtype)
        losses = F.cross_entropy(
            logits.float().flatten(0, 1), targets.flatten(), reduction="none"
        )
        return finish((losses * mask_f.flatten()).sum())

    tp = model.tp_group
    h = model.hidden(inputs)
    if tp is not None:
        h = _to_groups(h, (tp,))
    w, v0 = model.head_block()
    w = w.to(cfg.dtype)
    total = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, S, C):
        sl = slice(c0, c0 + C)
        total = total + checkpoint(
            _chunk_loss,
            h[:, sl].to(cfg.dtype),
            w,
            targets[:, sl],
            mask_f[:, sl],
            tp,
            v0,
            use_reentrant=False,
        )
    return finish(total)


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
    return model.call(_loss_body, inputs, targets, mask)


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
        loss = model.call(loss_fn, batch)
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


# ---------------------------------------------------------------------------
# The sharded step: state born sharded over the group's process axes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    """One rank's training state: the count of applied steps, the model
    (its parameters DTensors over ``device_mesh``), its optimizer, the
    group's :class:`Mesh` and torch ``DeviceMesh``, and process groups:
    this rank's batch group (the (dp, fsdp, sp) ranks at its (pp, ep, tp)
    coordinate), its loss group (the batch group's ranks at every pp
    coordinate) and its ``pp`` subgroup; each None where it is this rank
    alone."""

    step: int
    model: Transformer
    optimizer: torch.optim.Optimizer
    mesh: Mesh
    device_mesh: Any
    batch_group: Any = None
    loss_group: Any = None
    pp_group: Any = None


def _fsdp_mesh(device_mesh: Any) -> Any:
    """What ``fully_shard`` takes: the ("dp", "fsdp") mesh for HSDP (dp x
    sp replicas of an fsdp-sharded state) where the mesh has a dp dim,
    else its fsdp dim alone (FSDP)."""
    if "dp" in device_mesh.mesh_dim_names:
        return device_mesh["dp", "fsdp"]
    return device_mesh["fsdp"]


def _group_of(mesh: Mesh, axes: Tuple[str, ...]) -> Any:
    """:func:`parallel.mesh.axis_group` over ``axes``, or None where it
    is this rank alone (no collective: a sum over one rank is the
    value)."""
    if int(np.prod([mesh.shape[a] for a in axes])) == 1:
        return None
    return axis_group(mesh, axes)


def _place(module: torch.nn.Module, prefix: str, plan: Dict[str, Any],
           mesh: Mesh, device_mesh: Any) -> None:
    """The tensor-parallel plan applied to the parameters of ``module``
    (named ``prefix`` + their name): each becomes a DTensor over the plan's
    (ep, tp) mesh dims, ``Shard(d)`` over each its spec names and
    ``Replicate()`` over the other (``sharding.model_dims``), this rank's
    block of the whole parameter as its local shard (every rank made the
    whole one from the same seed)."""
    from torch.distributed.tensor import DTensor

    coord = mesh.process_coordinate()
    for name, p in list(module.named_parameters()):
        dims = plan.get(prefix + name)
        if dims is None:
            continue
        local = p.detach()
        for axis, d in dims:
            if d is not None:
                local = local.chunk(mesh.shape[axis], d)[coord[axis]]
        axes = tuple(a for a, _ in dims)
        sub = device_mesh[axes[0]] if len(axes) == 1 else device_mesh[axes]
        owner, _, leaf = name.rpartition(".")
        setattr(
            module.get_submodule(owner) if owner else module, leaf,
            torch.nn.Parameter(DTensor.from_local(
                local.clone(memory_format=torch.contiguous_format), sub,
                tuple(placement(d) for _, d in dims), run_check=False,
                shape=p.shape, stride=p.stride(),
            )),
        )


def state_shardings(model: Transformer, device_mesh: Any) -> Dict[str, Any]:
    """The placements of a :class:`TrainState`'s tensors over the group's
    ``device_mesh`` (FSDP2's mesh: its (dp, fsdp) dims followed by the
    plan's): ``params`` by name (``sharding.param_placements``),
    ``opt_state`` by name, where AdamW's ``exp_avg`` and ``exp_avg_sq``
    follow their parameter and its ``step`` (a CPU scalar) is replicated,
    and the replicated ``step``."""
    from torch.distributed.tensor import Replicate

    placements = param_placements(model, device_mesh)
    replicated = (Replicate(),)
    moments = {name: None for name in placements}
    specs = tree_specs_like(
        {"exp_avg": moments, "exp_avg_sq": moments, "step": None},
        param_specs(model),
    )
    place = lambda spec, name: (  # noqa: E731
        replicated if spec == () else placements[name]
    )
    return {
        "step": replicated,
        "params": placements,
        "opt_state": {
            name: {
                "step": place(specs["step"], name),
                "exp_avg": place(specs["exp_avg"][name], name),
                "exp_avg_sq": place(specs["exp_avg_sq"][name], name),
            }
            for name in placements
        },
    }


def check_model_mesh(cfg: LlamaConfig, mesh: Mesh) -> None:
    """Raises ``ValueError`` where ``mesh`` does not split the model of
    ``cfg``: its q or kv heads over ``tp``, or a dim the tensor-parallel
    plan shards over ``ep`` or ``tp`` (``sharding.tp_plan`` names the
    parameter, the dim and the axis). Runs no collective, so a trainer
    refuses such a group before its rendezvous; the JAX package refuses
    the same mesh when it places the state."""
    tp = mesh.shape["tp"]
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(
            f"{cfg.num_heads} q and {cfg.num_kv_heads} kv heads do not split "
            f"over tp={tp}"
        )
    with torch.device("meta"):
        # The parameters are the same for every attention.
        model = Transformer(dataclasses.replace(cfg, attn_impl="dense", attn_fn=None))
    tp_plan(model, mesh)


def init_train_state(
    cfg: LlamaConfig,
    mesh: Mesh,
    device: torch.device,
    seed: int = 0,
) -> Tuple[TrainState, Dict[str, Any]]:
    """The state of this rank, born sharded, and its placements
    (:func:`state_shardings`). The group's torch world must be up
    (``parallel.mesh.init_group``) with one rank for every coordinate of
    ``mesh``.

    The model is made on the meta device, then its parts are made for real
    in the order ``Transformer.__init__`` makes them, each initialised on
    the host from ``torch.manual_seed(seed)``'s stream and moved to
    ``device``: the embedding, then each :class:`Block`, then the final
    norm and the head, then the root. Each part is placed by the
    tensor-parallel plan as it is made (``sharding.tp_plan``: this rank's
    block of each parameter with an ep or tp dim), and each block is
    ``fully_shard``-ed at once, FSDP2 composing with the plan. Peak memory
    is the sharded blocks, the root's own parameters and one whole block.
    Gathered, the parameters are those of ``torch.manual_seed(seed);
    build_model(cfg, mesh).to(device)``, bit for bit, at any group size;
    at one rank each local shard is the whole tensor. Over ``pp`` the rank
    at coordinate s is born holding only stage s's layers (``layers.<i>``
    for i in [s L/pp, (s+1) L/pp); the other blocks are made on the host
    to keep the stream's order, and dropped) besides the embedding, final
    norm and head; over ``sp`` every rank holds the same parameters.

    A batch group of one rank is one FSDP2 unit, the root: a unit per block
    would free no memory (its shard is the whole block) and overlap no
    communication (there is none), and each unit costs its hooks' host
    time in every forward and backward. FSDP2 averages the gradients over
    the batch group (``group_device_mesh``'s dp dim spans dp and sp)."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    check_pipeline_mesh(mesh)
    check_model_mesh(cfg, mesh)
    device_mesh = group_device_mesh(mesh)
    fsdp_mesh = _fsdp_mesh(device_mesh)
    # Every rank makes every group, in this order.
    batch_group = _group_of(mesh, ("dp", "fsdp", "sp"))
    sp_group = _group_of(mesh, ("sp",))
    pp_group = _group_of(mesh, ("pp",))
    loss_group = (
        batch_group if pp_group is None else _group_of(mesh, ("dp", "pp", "fsdp", "sp"))
    )
    torch.manual_seed(seed)
    with torch.device("meta"):
        model = build_model(cfg, mesh)
    cfg = model.cfg  # with the mesh's attention bound
    pp = mesh.shape["pp"] if mesh.process_rank is not None else 1
    per_stage = cfg.num_layers // pp
    first = mesh.process_coordinate()["pp"] * per_stage
    if pp > 1:
        model.layers = torch.nn.ModuleDict({
            str(i): model.layers[str(i)] for i in range(first, first + per_stage)
        })
    plan = tp_plan(model, mesh)

    def shard(module: torch.nn.Module, named: Iterable[Tuple[str, Any]]) -> None:
        place = {id(p): Shard(shard_dim(spec_for(n, p.dim()))) for n, p in named}
        fully_shard(
            module, mesh=fsdp_mesh, shard_placement_fn=lambda p: place[id(p)]
        )

    def made(module: torch.nn.Module, prefix: str) -> torch.nn.Module:
        module = module.to(device)
        _place(module, prefix, plan, mesh, device_mesh)
        return module

    unit_per_block = fsdp_mesh.size() > 1
    model.embed = made(torch.nn.Embedding(cfg.vocab_size, cfg.hidden_size), "embed.")
    for i in range(cfg.num_layers):
        if not first <= i < first + per_stage:  # another stage's: the stream only
            Block(cfg)
            continue
        block = model.layers[str(i)] = made(Block(cfg), f"layers.{i}.")
        if unit_per_block:
            shard(block, (
                (f"layers.{i}.{n}", p) for n, p in block.named_parameters()
            ))
    model.final_norm = made(RMSNorm(cfg.hidden_size, cfg.norm_eps), "final_norm.")
    if not cfg.tie_embeddings:
        model.lm_head = made(torch.nn.Linear(
            cfg.hidden_size, cfg.vocab_size, bias=False
        ), "lm_head.")
    shard(model, (
        (n, p) for n, p in model.named_parameters()
        if not (unit_per_block and n.startswith("layers."))
    ))
    model.bind_model_parallel(
        *(device_mesh.get_group(a) if mesh.shape[a] > 1 else None for a in ("tp", "ep")),
        sp_group=sp_group,
    )
    # The losses read the head (and a pipeline the embedding) outside
    # forward: model.call gathers the root's parameters for them.
    register_fsdp_forward_method(model, "call")
    state = TrainState(
        step=0,
        model=model,
        optimizer=default_optimizer(model.parameters()),
        mesh=mesh,
        device_mesh=device_mesh,
        batch_group=batch_group,
        loss_group=loss_group,
        pp_group=pp_group,
    )
    return state, state_shardings(model, device_mesh)


def _global_mean(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """The batch's loss from the ranks' (scaled) losses: summed over the
    loss group (the batch group's ranks at every pp coordinate, where only
    the last stage's is not zero) and divided by the batch group's
    size."""
    import torch.distributed as dist

    loss = loss.detach().clone()
    if state.loss_group is not None:
        dist.all_reduce(loss, group=state.loss_group)
    if state.batch_group is not None:
        loss = loss / dist.get_world_size(state.batch_group)
    return loss


def _microbatches(
    state: TrainState, batch: Batch, accum_steps: int
) -> Iterable[Tuple[Batch, torch.Tensor]]:
    """(this rank's block of microbatch k, microbatch k's global token
    count) for k < ``accum_steps``: microbatch k is the global rows
    ``k::accum_steps`` (JAX's interleaved split), so each rank's part of it
    is its own rows ``k::accum_steps``, at its own block of the sequence."""
    rows, cols = batch_sharding(
        state.mesh, state.mesh.process_rank or 0, tuple(batch["inputs"].shape)
    )
    local = rows.stop - rows.start
    if local % accum_steps:
        raise ValueError(
            f"{local} rows a rank not divisible by accum_steps={accum_steps}"
        )
    for k in range(accum_steps):
        part = {key: v[rows, cols][k::accum_steps] for key, v in batch.items()}
        denom = batch["mask"][k::accum_steps].float().sum().clamp_min(1.0)
        yield part, denom


def _rank_loss(
    state: TrainState,
    part: Batch,
    denom: torch.Tensor,
    loss_fn: Optional[Callable[..., torch.Tensor]],
) -> torch.Tensor:
    import torch.distributed as dist

    group = state.batch_group
    if loss_fn is None:
        return state.model.call(
            _loss_body, part["inputs"], part["targets"], part["mask"], denom,
            group,
        )
    loss = state.model.call(loss_fn, part, denom)
    return loss if group is None else loss * dist.get_world_size(group)


def _reduce_replicas(state: TrainState) -> None:
    """After the backward, the gradients of the parameters every pipeline
    stage holds (the embedding, final norm and head) summed over the
    ``pp`` subgroup, a stage that did not use one adding zeros: one
    all-reduce of a flat fp32 buffer of the local shards. (FSDP2 has
    averaged every gradient over dp, fsdp and sp.)"""
    import torch.distributed as dist

    if state.pp_group is None:
        return
    params = [
        p for n, p in state.model.named_parameters() if not n.startswith("layers.")
    ]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    locals_ = [p.grad.to_local() for p in params]
    flat = torch.cat([g.reshape(-1) for g in locals_])
    dist.all_reduce(flat, group=state.pp_group)
    with torch.no_grad():
        for g, part in zip(locals_, flat.split([g.numel() for g in locals_])):
            g.copy_(part.view_as(g))


def make_grad_step(
    state: TrainState,
    loss_fn: Optional[Callable[..., torch.Tensor]] = None,
) -> Callable[[Batch], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """``grad_step(batch) -> (loss, grads)`` over the global batch
    ({"inputs", "targets", "mask"}, each [B, S], the same on every rank):
    this rank's rows forward and backward, the batch's loss, and the
    gradient of every parameter by name as this rank's DTensor shard (the
    group's average), left unapplied for the replica-axis allreduce: the
    DDP variant. ``loss_fn(model, rows, denom)`` replaces the chunked loss
    (``make_pipeline_loss`` builds one)."""

    def grad_step(batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        model = state.model
        model.zero_grad(set_to_none=True)
        ((part, denom),) = _microbatches(state, batch, 1)
        loss = _rank_loss(state, part, denom, loss_fn)
        loss.backward()
        _reduce_replicas(state)
        grads = {name: p.grad for name, p in model.named_parameters()}
        return _global_mean(state, loss), grads

    return grad_step


def _grad_norm(state: TrainState, params: Iterable[Tuple[str, Any]]) -> torch.Tensor:
    """The global norm of the gradients of ``params`` (name, parameter):
    the square root of the sum of the squares over the whole tensors, from
    each rank's local shards summed over the group's ranks, each shard's
    square weighted by one over the number of ranks holding a copy of it
    (the world over the ranks its ``Shard`` placements split it over):
    the dp and sp ranks, the ep and tp ranks of a parameter the plan does
    not split (the norms, the router), the ep ranks of one it replicates
    over ep (the attention, embedding and head at ep x tp), and the pp
    ranks of a parameter every stage holds (the embedding, final norm and
    head). Each element counts once."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    world = dist.get_world_size()
    pp = state.mesh.shape["pp"] if state.mesh.process_rank is not None else 1
    sq = []
    for name, p in params:
        g = p.grad
        held = int(np.prod([
            g.device_mesh.size(i) for i, pl in enumerate(g.placements)
            if isinstance(pl, Shard)
        ])) * (pp if name.startswith("layers.") else 1)
        s = torch.linalg.vector_norm(g.to_local(), dtype=torch.float32).square()
        sq.append(s if held == world else s * (held / world))
    total = torch.stack(sq).sum()
    dist.all_reduce(total)
    return total.sqrt()


def make_train_step(
    state: TrainState, accum_steps: int = 1
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch) -> (state, metrics)``: gradients of the global
    batch and one optimizer step, metrics ``{"loss", "grad_norm"}``.

    ``accum_steps > 1`` accumulates gradients over that many microbatches
    (the global rows ``k::accum_steps``, :func:`_microbatches`), each
    normalized by its own token count, in fp32 (FSDP2 adds each
    microbatch's reduced gradient into the sharded one); the gradients and
    the loss are then averaged over the microbatches and the optimizer
    applies once, as the JAX step does."""

    def step(state: TrainState, batch: Batch):
        model = state.model
        model.zero_grad(set_to_none=True)
        loss_sum = None
        for part, denom in _microbatches(state, batch, accum_steps):
            loss = _rank_loss(state, part, denom, None)
            loss.backward()
            loss = _global_mean(state, loss)
            loss_sum = loss if loss_sum is None else loss_sum + loss
        _reduce_replicas(state)
        params = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            with torch.no_grad():
                for _, p in params:
                    p.grad.mul_(inv)
            loss_sum = loss_sum * inv
        grad_norm = _grad_norm(state, params)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss_sum, "grad_norm": grad_norm}

    return step


def make_eval_step(
    state: TrainState,
) -> Callable[[TrainState, Batch], torch.Tensor]:
    """``eval_step(state, batch) -> loss``: the global batch's loss, each
    rank computing its rows, without gradients."""

    def eval_step(state: TrainState, batch: Batch) -> torch.Tensor:
        with torch.no_grad():
            ((part, denom),) = _microbatches(state, batch, 1)
            return _global_mean(state, _rank_loss(state, part, denom, None))

    return eval_step
