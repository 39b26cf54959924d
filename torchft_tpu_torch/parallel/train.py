"""The inner training step of one replica group: loss, gradients, optimizer.

The port of ``torchft_tpu/parallel/train.py``: ``build_model`` (binds ring
or Ulysses attention to a mesh), the chunked vocab loss with the MoE
router's aux term and the default AdamW, in two forms.

- **Sharded** (the JAX package's pjit step): :func:`init_train_state`
  builds the state born sharded over the group's process axes (dp, fsdp)
  with FSDP2, and :func:`make_train_step` (``accum_steps``),
  :func:`make_grad_step` (the DDP variant ``train_hsdp`` runs: the
  optimizer applies after the Manager's replica-axis gradient allreduce)
  and :func:`make_eval_step` run on each rank's rows of the global batch.
  The group is the default torch process group
  (``parallel.mesh.init_group``).
- **Mesh-free**: :func:`grad_step` and :func:`pipeline_grad_step` on a
  plain model, for callers that pass no mesh.

The losses of the ranks of a group add up to the global batch's: each rank
normalizes its rows' token losses by the whole batch's mask count and
scales by the group size, because FSDP2 averages the group's gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

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
)
from torchft_tpu_torch.parallel.mesh import Mesh, group_device_mesh
from torchft_tpu_torch.parallel.pipeline import make_pipeline_loss
from torchft_tpu_torch.parallel.ring_attention import make_ring_attention
from torchft_tpu_torch.parallel.sharding import (
    batch_sharding,
    check_process_mesh,
    param_placements,
    param_specs,
    shard_dim,
    spec_for,
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


def _chunk_loss(
    h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    logits = F.linear(h, w).float()  # [B, C, V], exists only in this chunk
    losses = F.cross_entropy(
        logits.flatten(0, 1), targets.flatten(), reduction="none"
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
    term taken over the whole batch (see the module docstring)."""
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

    h = model.hidden(inputs)
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
    (its parameters FSDP2 DTensors over ``device_mesh``), its optimizer,
    the group's :class:`Mesh` and torch ``DeviceMesh``."""

    step: int
    model: Transformer
    optimizer: torch.optim.Optimizer
    mesh: Mesh
    device_mesh: Any


def _fsdp_mesh(mesh: Mesh, device_mesh: Any) -> Any:
    """What ``fully_shard`` takes: the ("dp", "fsdp") mesh for HSDP (dp
    replicas of an fsdp-sharded state) when dp is above 1, else its fsdp
    dim alone (FSDP)."""
    return device_mesh if mesh.shape["dp"] > 1 else device_mesh["fsdp"]


def state_shardings(model: Transformer, device_mesh: Any) -> Dict[str, Any]:
    """The placements of a :class:`TrainState`'s tensors over
    ``device_mesh`` (the mesh ``fully_shard`` took): ``params`` by
    name (``sharding.param_placements``), ``opt_state`` by name, where
    AdamW's ``exp_avg`` and ``exp_avg_sq`` follow their parameter and its
    ``step`` (a CPU scalar) is replicated, and the replicated ``step``."""
    from torch.distributed.tensor import Replicate

    placements = param_placements(model, device_mesh)
    replicated = (Replicate(),) * len(device_mesh.mesh_dim_names)
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


def init_train_state(
    cfg: LlamaConfig,
    mesh: Mesh,
    device: torch.device,
    seed: int = 0,
) -> Tuple[TrainState, Dict[str, Any]]:
    """The state of this rank, born sharded, and its placements
    (:func:`state_shardings`). The group's torch world must be up
    (``parallel.mesh.init_group``) with ``mesh``'s dp*fsdp ranks.

    The model is made on the meta device, then its parts are made for real
    in the order ``Transformer.__init__`` makes them, each initialised on
    the host from ``torch.manual_seed(seed)``'s stream and moved to
    ``device``: the embedding, then each :class:`Block`, which is
    ``fully_shard``-ed at once, then the final norm and the head, then the
    root. Peak memory is the sharded blocks, the root's own parameters and
    one whole block. At one rank the parameters are those of
    ``torch.manual_seed(seed); build_model(cfg, mesh).to(device)``, bit for
    bit.

    A group of one rank is one FSDP2 unit, the root: a unit per block would
    free no memory (its shard is the whole block) and overlap no
    communication (there is none), and each unit costs its hooks' host
    time in every forward and backward."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
    from torch.distributed.tensor import Shard

    check_process_mesh(mesh)
    device_mesh = group_device_mesh(mesh)
    fsdp_mesh = _fsdp_mesh(mesh, device_mesh)
    torch.manual_seed(seed)
    with torch.device("meta"):
        model = build_model(cfg, mesh)
    cfg = model.cfg  # with the mesh's attention bound

    def shard(module: torch.nn.Module, named: Iterable[Tuple[str, Any]]) -> None:
        place = {id(p): Shard(shard_dim(spec_for(n, p.dim()))) for n, p in named}
        fully_shard(
            module, mesh=fsdp_mesh, shard_placement_fn=lambda p: place[id(p)]
        )

    unit_per_block = mesh.shape["dp"] * mesh.shape["fsdp"] > 1
    model.embed = torch.nn.Embedding(cfg.vocab_size, cfg.hidden_size).to(device)
    for i in range(cfg.num_layers):
        block = model.layers[i] = Block(cfg).to(device)
        if unit_per_block:
            shard(block, (
                (f"layers.{i}.{n}", p) for n, p in block.named_parameters()
            ))
    model.final_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps).to(device)
    if not cfg.tie_embeddings:
        model.lm_head = torch.nn.Linear(
            cfg.hidden_size, cfg.vocab_size, bias=False
        ).to(device)
    shard(model, (
        (n, p) for n, p in model.named_parameters()
        if not (unit_per_block and n.startswith("layers."))
    ))
    # The losses read the head (and a pipeline the embedding) outside
    # forward: model.call gathers the root's parameters for them.
    register_fsdp_forward_method(model, "call")
    state = TrainState(
        step=0,
        model=model,
        optimizer=default_optimizer(model.parameters()),
        mesh=mesh,
        device_mesh=device_mesh,
    )
    return state, state_shardings(model, fsdp_mesh)


def _group() -> Tuple[Any, int]:
    import torch.distributed as dist

    return dist.group.WORLD, dist.get_world_size()


def _global_mean(loss: torch.Tensor, n: int) -> torch.Tensor:
    """The group's mean of the ranks' (scaled) losses: the batch's loss."""
    import torch.distributed as dist

    loss = loss.detach().clone()
    dist.all_reduce(loss)
    return loss / n


def _microbatches(
    state: TrainState, batch: Batch, accum_steps: int
) -> Iterable[Tuple[Batch, torch.Tensor]]:
    """(this rank's rows of microbatch k, microbatch k's global token count)
    for k < ``accum_steps``: microbatch k is the global rows
    ``k::accum_steps`` (JAX's interleaved split), so each rank's part of it
    is its own rows ``k::accum_steps``."""
    B = batch["inputs"].shape[0]
    rows = batch_sharding(state.mesh, state.mesh.process_rank or 0, B)
    local = rows.stop - rows.start
    if local % accum_steps:
        raise ValueError(
            f"{local} rows a rank not divisible by accum_steps={accum_steps}"
        )
    for k in range(accum_steps):
        part = {key: v[rows][k::accum_steps] for key, v in batch.items()}
        denom = batch["mask"][k::accum_steps].float().sum().clamp_min(1.0)
        yield part, denom


def _rank_loss(
    state: TrainState,
    part: Batch,
    denom: torch.Tensor,
    loss_fn: Optional[Callable[..., torch.Tensor]],
) -> torch.Tensor:
    group, n = _group()
    if loss_fn is None:
        return state.model.call(
            _loss_body, part["inputs"], part["targets"], part["mask"], denom,
            group,
        )
    return state.model.call(loss_fn, part, denom) * n


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
    _, n = _group()

    def grad_step(batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        model = state.model
        model.zero_grad(set_to_none=True)
        ((part, denom),) = _microbatches(state, batch, 1)
        loss = _rank_loss(state, part, denom, loss_fn)
        loss.backward()
        grads = {name: p.grad for name, p in model.named_parameters()}
        return _global_mean(loss, n), grads

    return grad_step


def _grad_norm(state: TrainState, grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """The global norm of the gradients: the square root of the sum of the
    squares over the whole tensors, from each rank's local shards summed
    over the fsdp ranks (the dp ranks hold copies)."""
    import torch.distributed as dist

    local = [g.to_local() if hasattr(g, "to_local") else g for g in grads]
    sq = torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in local]
    ).square().sum()
    dist.all_reduce(sq, group=state.device_mesh.get_group("fsdp"))
    return sq.sqrt()


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
    _, n = _group()

    def step(state: TrainState, batch: Batch):
        model = state.model
        model.zero_grad(set_to_none=True)
        loss_sum = None
        for part, denom in _microbatches(state, batch, accum_steps):
            loss = _rank_loss(state, part, denom, None)
            loss.backward()
            loss = _global_mean(loss, n)
            loss_sum = loss if loss_sum is None else loss_sum + loss
        params = [p for p in model.parameters() if p.grad is not None]
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            with torch.no_grad():
                for p in params:
                    p.grad.mul_(inv)
            loss_sum = loss_sum * inv
        grad_norm = _grad_norm(state, (p.grad for p in params))
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss_sum, "grad_norm": grad_norm}

    return step


def make_eval_step(
    state: TrainState,
) -> Callable[[TrainState, Batch], torch.Tensor]:
    """``eval_step(state, batch) -> loss``: the global batch's loss, each
    rank computing its rows, without gradients."""
    _, n = _group()

    def eval_step(state: TrainState, batch: Batch) -> torch.Tensor:
        with torch.no_grad():
            ((part, denom),) = _microbatches(state, batch, 1)
            return _global_mean(_rank_loss(state, part, denom, None), n)

    return eval_step
