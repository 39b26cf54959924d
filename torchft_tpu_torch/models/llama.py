"""Llama-3-style decoder-only transformer as ``nn.Module``s.

The port of ``torchft_tpu/models/llama.py``: same configs, same routing, same
numerics contract. Parameters are fp32 and every projection computes in
``cfg.dtype`` (bf16 by default): input and weight are cast to ``cfg.dtype``
and multiplied there, as flax's ``DenseGeneral(dtype=bf16,
param_dtype=fp32)`` does. Layout stays ``[B, S, H, D]`` through attention.

Weights follow PyTorch's idiom (``nn.Linear`` weights are ``[out, in]``, one
module per layer); :func:`params_from_jax` carries a flax parameter tree (the
layer stack scanned with a leading ``[num_layers]`` dim) into a
``state_dict``, and :func:`params_to_jax` carries it back, so tests can make
both packages compute the same function.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchft_tpu_torch._dtensor import local as _local
from torchft_tpu_torch.ops.flash_attention import flash_attention, supports


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    # Compute dtype; parameters are fp32.
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    # Recompute each block in the backward pass (torch.utils.checkpoint).
    remat: bool = True
    # 'dense' | 'flash' | 'ring' | 'ulysses'. flash = the hand-written CUDA
    # kernels (ops/flash_attention.py), dense for lengths the flash gate
    # refuses; ring (k/v streaming) and ulysses (all-to-all between
    # sequence and heads) shard the sequence over the mesh's 'sp' axis
    # (attn_fn).
    attn_impl: str = "dense"
    # Below this sequence length the 'flash' impl routes to dense.
    flash_min_seq: int = 2048
    # The flash gate's block sizes (supports()); the CUDA tile is the
    # kernel's own.
    flash_block_q: int = 512
    flash_block_k: int = 512
    # Mixture of experts: num_experts == 0 -> dense MLP, else MoEMLP (top-k
    # routing, dense one-hot dispatch and combine). Over an 'ep' process
    # axis each rank holds and runs its own experts
    # (parallel.train.init_train_state).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # Per-sequence expert buffer = capacity_factor * S * k / E tokens;
    # overflow tokens pass through the residual only (GShard drop).
    expert_capacity_factor: float = 1.25
    # Switch/GShard load-balancing aux loss coefficient: the train loss adds
    # coef * the mean over layers of each MoEMLP's aux term
    # (parallel/train.py:_loss_fn).
    router_aux_coef: float = 0.01
    # Bound by parallel.train.build_model when attn_impl is 'ring' or
    # 'ulysses'.
    attn_fn: Optional[Callable[..., torch.Tensor]] = None

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


def llama3_8b(**overrides: Any) -> LlamaConfig:
    return dataclasses.replace(LlamaConfig(), **overrides)


def llama_small(**overrides: Any) -> LlamaConfig:
    """~125M model for single-chip benchmarking."""
    cfg = LlamaConfig(
        vocab_size=32000,
        hidden_size=768,
        intermediate_size=2048,
        num_layers=12,
        num_heads=12,
        num_kv_heads=4,
        head_dim=64,
        max_seq_len=2048,
    )
    return dataclasses.replace(cfg, **overrides)


def llama_moe_debug(**overrides: Any) -> LlamaConfig:
    """Tiny MoE config (4 experts, top-2) for tests and the MoE drill."""
    cfg = llama_debug(num_experts=4, num_experts_per_tok=2)
    return dataclasses.replace(cfg, **overrides)


def llama_debug(**overrides: Any) -> LlamaConfig:
    """Tiny config for tests (CPU-friendly)."""
    cfg = LlamaConfig(
        vocab_size=256,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        max_seq_len=128,
        remat=False,
    )
    return dataclasses.replace(cfg, **overrides)


def rope_table(
    positions: torch.Tensor, head_dim: int, theta: float, dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [..., head_dim/2] for given positions."""
    exponent = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim
    )
    freqs = 1.0 / (theta**exponent)
    angles = positions[..., None].to(torch.float32) * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on the last dim of x: [B, S, H, Dh]."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)


def dense_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Plain causal GQA attention. q: [B,S,Hq,Dh], k/v: [B,S,Hkv,Dh]; scores
    in q's dtype, softmax in fp32."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * dh**-0.5
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, s, hq, dh)


def _linear(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), weight.to(dtype))


# ---------------------------------------------------------------------------
# Tensor and expert parallelism across the ranks of a group
# ---------------------------------------------------------------------------
#
# A module bound to a tensor-parallel group (``tp_group``; the experts also
# ``ep_group``: ``Transformer.bind_model_parallel``) holds its parameters as
# DTensors sharded over those groups (``parallel/sharding.py``'s plan) and
# computes with each rank's local shard. Its input is the same on every rank
# of the groups; each rank computes its part of a sum (its heads, its
# feature columns, its experts), and the parts are summed over the groups:
# Megatron-LM's two operators, ``_ToGroups`` where the replicated input
# enters and ``_SumOverGroups`` where the sum leaves.


class _ToGroups(torch.autograd.Function):
    """Identity forward; the gradient summed over the ranks of each group
    (every rank used the input for its own part of a sum)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, groups: tuple) -> torch.Tensor:
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(grad, group=group)
        return grad, None


class _SumOverGroups(torch.autograd.Function):
    """The sum of each rank's part over the ranks of each group; the
    gradient passes through (every rank's output is the same sum)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, groups: tuple) -> torch.Tensor:
        import torch.distributed as dist

        out = x.contiguous().clone()
        for group in groups:
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor):
        return grad, None


class _GatherRows(torch.autograd.Function):
    """The whole tensor from each rank's block of rows (dim 0, in group rank
    order); the gradient is this rank's block of the whole one's (every
    rank computed the same function of the whole tensor)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        import torch.distributed as dist

        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.rows, ctx.rank = x.shape[0], r
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor):
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def _groups(*groups: Any) -> tuple:
    return tuple(g for g in groups if g is not None)


def _to_groups(x: torch.Tensor, groups: tuple) -> torch.Tensor:
    return _ToGroups.apply(x, groups) if groups else x


def _sum_over_groups(x: torch.Tensor, groups: tuple) -> torch.Tensor:
    return _SumOverGroups.apply(x, groups) if groups else x


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        x = x.float()
        norm = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(dtype)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        if cfg.attn_impl not in ("dense", "flash", "ring", "ulysses"):
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
        if cfg.attn_impl in ("ring", "ulysses") and cfg.attn_fn is None:
            raise ValueError(
                f"{cfg.attn_impl} attention needs cfg.attn_fn: build the "
                "model with parallel.train.build_model(cfg, mesh)"
            )
        self.cfg = cfg
        H, Dh = cfg.hidden_size, cfg.head_dim
        self.wq = nn.Linear(H, cfg.num_heads * Dh, bias=False)
        self.wk = nn.Linear(H, cfg.num_kv_heads * Dh, bias=False)
        self.wv = nn.Linear(H, cfg.num_kv_heads * Dh, bias=False)
        self.wo = nn.Linear(cfg.num_heads * Dh, H, bias=False)
        # Bound by Transformer.bind_model_parallel: q, k and v are then
        # this rank's contiguous block of heads (colwise), wo its block of
        # input columns (rowwise), and the output is summed over the group.
        self.tp_group: Any = None
        # Bound likewise: the sequence is then split over this group's
        # ranks, and the dense and flash attention gather k and v over it.
        self.sp_group: Any = None
        # Set by bind_model_parallel in an MoE model bound to both groups:
        # the output's sum over tp is then taken in fp32 and rounded once.
        self.fp32_sums = False

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        groups = _groups(self.tp_group)
        x = _to_groups(x, groups)
        # The head counts are the local projections': at tp the rank's
        # blocks of q and kv heads, GQA's q-per-kv kept.
        heads = lambda t: t.view(B, S, -1, cfg.head_dim)  # noqa: E731
        q = heads(_linear(x, _local(self.wq.weight), cfg.dtype))
        k = heads(_linear(x, _local(self.wk.weight), cfg.dtype))
        v = heads(_linear(x, _local(self.wv.weight), cfg.dtype))
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cfg.attn_impl in ("ring", "ulysses"):
            out = cfg.attn_fn(q, k, v)
        elif self.sp_group is not None:
            # JAX's dense attention on a sequence-sharded batch: XLA
            # gathers k and v. The blocks fold at their global offsets.
            from torchft_tpu_torch.parallel.ring_attention import gathered_attention

            out = gathered_attention(q, k, v, self.sp_group)
        elif (
            cfg.attn_impl == "flash"
            and S >= cfg.flash_min_seq
            and supports(S, cfg.flash_block_q, cfg.flash_block_k)
        ):
            out = flash_attention(
                q, k, v,
                block_q=cfg.flash_block_q,
                block_k=cfg.flash_block_k,
            )
        else:
            out = dense_attention(q, k, v)
        if self.fp32_sums and groups:
            # The one-rank model's bits up to fp32's order of addition: the
            # rank's part of wo's contraction in fp32 (bf16 products are
            # exact there), summed over tp in fp32, rounded once.
            out = F.linear(
                out.reshape(B, S, -1).float(),
                _local(self.wo.weight).to(cfg.dtype).float(),
            )
            return _sum_over_groups(out, groups).to(cfg.dtype)
        out = _linear(out.reshape(B, S, -1), _local(self.wo.weight), cfg.dtype)
        return _sum_over_groups(out, groups)


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.cfg = cfg
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.gate = nn.Linear(H, I, bias=False)
        self.up = nn.Linear(H, I, bias=False)
        self.down = nn.Linear(I, H, bias=False)
        # Bound by Transformer.bind_model_parallel: gate and up colwise,
        # down rowwise, the output summed over the group.
        self.tp_group: Any = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        groups = _groups(self.tp_group)
        x = _to_groups(x, groups)
        gate = _linear(x, _local(self.gate.weight), dt)
        up = _linear(x, _local(self.up.weight), dt)
        out = _linear(F.silu(gate) * up, _local(self.down.weight), dt)
        return _sum_over_groups(out, groups)


def _lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two deviations, scaled
    so its variance is 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def top_k_lower_index(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest values in
    descending order, and their indices, a tie going to the lower index
    (``torch.topk`` promises no order among ties; a stable descending sort
    keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoEMLP(nn.Module):
    """Mixture-of-experts MLP: top-k routing with GShard-style dense
    dispatch, the twin of the JAX package's ``MoEMLP``.

    The router runs in fp32 on fp32 input. Each expert takes at most
    ``C = max(int(capacity_factor * S * K / E), 1)`` tokens per sequence;
    the k-th choices queue after every (k-1)-th choice, tokens in sequence
    order, and a token beyond its expert's capacity passes through the
    residual only. Dispatch and combine are one-hot ``[B,S,E,C]`` einsums in
    ``cfg.dtype``, with no scatter: atomics would change the bits from run
    to run. ``forward`` keeps the layer's Switch load-balancing term in
    ``self.aux`` (``E * sum_e f_e * p_e``), which the JAX model sows, and
    its two factors (the top-1 share ``f`` and the mean probability ``p``
    of each expert) in ``self.load``, so that ranks holding parts of one
    batch can average them first.

    Bound to an expert-parallel group (``ep_group``), a rank holds and runs
    its own contiguous block of experts; bound to a tensor-parallel group
    (``tp_group``), its block of each expert's feature columns. The tokens
    are the same on every rank of both groups (the batch shards over dp and
    fsdp only, as in the JAX mesh), the router runs whole on each, and the
    combine is summed over both groups.

    Bound to both, a rank holds its tensor-parallel block of the columns
    of its expert-parallel block of experts, and the model takes its sums
    over ranks in fp32 (``fp32_sums``, set by
    ``Transformer.bind_model_parallel``): each expert's output summed over
    tp and rounded to ``cfg.dtype`` once, where the one-rank model rounds
    it, then the combine summed over ep and rounded once; the attention's
    output likewise over tp. The top-k is discontinuous in the router's
    input: with the parts rounded to bf16 before the sums, the router read
    other bits than one rank's and a token near a tie went to another
    expert (one token a layer in 512 at llama_moe_debug on the CPU). With
    fp32 sums it reads one rank's bits up to fp32's order of addition.
    The router's input is the same bits on every rank of both groups
    either way (each rank's sums add the same parts in the same order)."""

    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        E, K = cfg.num_experts, cfg.num_experts_per_tok
        if K > E:
            raise ValueError(f"num_experts_per_tok ({K}) > num_experts ({E})")
        self.cfg = cfg
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.router = nn.Linear(H, E, bias=False)
        # [E, in, out], as flax keeps them; lecun_normal's fan_in on a 3-D
        # shape counts the leading expert dim: in * E.
        self.experts_gate = nn.Parameter(_lecun_normal_(torch.empty(E, H, I), H * E))
        self.experts_up = nn.Parameter(_lecun_normal_(torch.empty(E, H, I), H * E))
        self.experts_down = nn.Parameter(_lecun_normal_(torch.empty(E, I, H), I * E))
        self.aux: Optional[torch.Tensor] = None
        self.load: Optional[tuple] = None
        self.tp_group: Any = None
        self.ep_group: Any = None
        self.fp32_sums = False

    def first_expert(self, n: int) -> int:
        """The index of this rank's first expert when it holds ``n``: its
        block over the expert-parallel group (the same block at every
        tensor-parallel rank, which holds its columns of those experts)."""
        if self.ep_group is None:
            return 0
        import torch.distributed as dist

        return n * dist.get_rank(self.ep_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        E, K = cfg.num_experts, cfg.num_experts_per_tok
        B, S, _ = x.shape
        C = max(int(cfg.expert_capacity_factor * S * K / E), 1)
        f32 = torch.float32

        probs = torch.softmax(F.linear(x.float(), self.router.weight.float()), dim=-1)
        gate_vals, gate_idx = top_k_lower_index(probs, K)  # [B,S,K]
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

        top1 = F.one_hot(gate_idx[..., 0], E).to(f32)
        self.load = (top1.mean(dim=(0, 1)), probs.mean(dim=(0, 1)))
        self.aux = E * torch.sum(self.load[0] * self.load[1])

        counts = x.new_zeros((B, E), dtype=f32)
        dispatch = x.new_zeros((B, S, E, C), dtype=f32)
        combine = x.new_zeros((B, S, E, C), dtype=f32)
        for k in range(K):
            mk = F.one_hot(gate_idx[..., k], E).to(f32)
            pos = counts[:, None, :] + torch.cumsum(mk, dim=1) - mk  # [B,S,E]
            keep = mk * (pos < C)
            counts = counts + keep.sum(dim=1)
            pos_tok = (pos * keep).sum(-1).long()  # [B,S]
            slot = F.one_hot(pos_tok, C).to(f32)  # [B,S,C]
            disp_k = keep[..., None] * slot[:, :, None, :]  # [B,S,E,C]
            dispatch = dispatch + disp_k
            combine = combine + disp_k * gate_vals[..., k][..., None, None]

        dt = cfg.dtype
        groups = _groups(self.ep_group, self.tp_group)
        w_gate, w_up, w_down = (
            _local(w) for w in (self.experts_gate, self.experts_up, self.experts_down)
        )
        x_e = x
        # The groups over whose ranks the combine's weights enter parts of
        # a sum: with fp32 sums each tp rank combines the whole (summed)
        # expert outputs, so only the ep ranks' parts add up.
        combined = _groups(self.ep_group) if self.fp32_sums else groups
        if groups:
            # This rank's experts; x and the combine weights carry
            # gradients of this rank's part of the sum only.
            n = w_gate.shape[0]
            e0 = self.first_expert(n)
            x_e = _to_groups(x, groups)
            dispatch = dispatch[:, :, e0:e0 + n]
            combine = _to_groups(combine, combined)[:, :, e0:e0 + n]
        xe = torch.einsum("bsec,bsh->bech", dispatch.to(dt), x_e.to(dt))
        hidden = F.silu(
            torch.einsum("bech,ehi->beci", xe, w_gate.to(dt))
        ) * torch.einsum("bech,ehi->beci", xe, w_up.to(dt))
        if self.fp32_sums:
            ye = torch.einsum("beci,eih->bech", hidden.float(), w_down.to(dt).float())
            ye = _sum_over_groups(ye, _groups(self.tp_group)).to(dt)
            out = torch.einsum("bsec,bech->bsh", combine.to(dt).float(), ye.float())
            return _sum_over_groups(out, combined).to(x.dtype)
        ye = torch.einsum("beci,eih->bech", hidden, w_down.to(dt))
        out = torch.einsum("bsec,bech->bsh", combine.to(dt), ye)
        return _sum_over_groups(out, groups).to(x.dtype)


class _GroupMean(torch.autograd.Function):
    """The mean of a tensor over the ranks of a process group, each rank
    holding its own; differentiable (the gradient of each rank's input is
    the group's mean of the gradients of the output)."""

    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Any) -> torch.Tensor:
        import torch.distributed as dist

        ctx.group = group
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor):
        import torch.distributed as dist

        out = grad.detach().clone()
        dist.all_reduce(out, group=ctx.group)
        return out / dist.get_world_size(ctx.group), None


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)
        self.attn = Attention(cfg)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)
        self.mlp = MoEMLP(cfg) if cfg.num_experts > 0 else MLP(cfg)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attn_norm(x), cos, sin)
        return x + self.mlp(self.mlp_norm(x))


class Transformer(nn.Module):
    """Decoder-only LM. forward(tokens [B,S], positions [B,S]) -> fp32
    logits [B,S,V]; ``return_hidden=True`` returns the post-final-norm
    hidden states [B,S,H] in cfg.dtype instead (the chunked-loss path)."""

    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        # Keyed by the block's index in the whole model, so a pipeline
        # stage's run of blocks keeps the dense model's names
        # (``layers.<i>.``, ``parallel/train.py``).
        self.layers = nn.ModuleDict({str(i): Block(cfg) for i in range(cfg.num_layers)})
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)
        self.lm_head = (
            None
            if cfg.tie_embeddings
            else nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        )
        # Bound by bind_model_parallel: the embedding and the head are then
        # this rank's block of vocab rows; the tokens this rank's block of
        # the sequence.
        self.tp_group: Any = None
        self.sp_group: Any = None

    def bind_model_parallel(
        self, tp_group: Any = None, ep_group: Any = None, sp_group: Any = None
    ) -> None:
        """Binds the model to the torch process groups of its tensor-,
        expert- and sequence-parallel ranks
        (``parallel.train.init_train_state``, after the plan has placed the
        parameters): every projection, the embedding, the head and the
        experts then compute with this rank's shards and sum over the
        tensor- and expert-parallel groups; the tokens are this rank's
        block of the sequence (the sequence-parallel group's rank r holds
        block r), the RoPE positions start at the block's first position
        and the dense and flash attention gather k and v over the group.
        None: no such axis."""
        self.tp_group = tp_group
        self.sp_group = sp_group
        # Bound to both, the routed model sums over ranks in fp32 (MoEMLP).
        fp32_sums = tp_group is not None and ep_group is not None
        for m in self.modules():
            if isinstance(m, (Attention, MLP, MoEMLP)):
                m.tp_group = tp_group
            if isinstance(m, (Attention, MoEMLP)):
                m.fp32_sums = fp32_sums
            if isinstance(m, Attention):
                m.sp_group = sp_group
            if isinstance(m, MoEMLP):
                m.ep_group = ep_group

    def sequence_offset(self, seq_len: int) -> int:
        """The global position of this rank's first token when it holds
        block r of ``seq_len`` tokens of a sequence split over the
        sequence-parallel group (r its rank there): r * seq_len; 0 with no
        such group."""
        if self.sp_group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.sp_group) * seq_len

    def router_aux(self, group: Any = None) -> Optional[torch.Tensor]:
        """The mean over layers of the MoE layers' load-balancing terms from
        the last forward (what the JAX model sows as ``router_aux``); None
        for a dense model. With ``group`` (the torch process group of ranks
        that each ran the forward on their rows of one batch) each layer's
        ``f`` and ``p`` are averaged over the group first, through a
        differentiable all-reduce, so every rank gets the whole batch's
        term, as the JAX model computes it over its sharded batch."""
        if self.cfg.num_experts <= 0:
            return None
        if group is None:
            return torch.stack([b.mlp.aux for b in self.layers.values()]).mean()
        terms = []
        for block in self.layers.values():
            f, p = (_GroupMean.apply(t, group) for t in block.mlp.load)
            terms.append(self.cfg.num_experts * torch.sum(f * p))
        return torch.stack(terms).mean()

    def router_names(self) -> List[str]:
        """The MoE routers' weight names in layer order; empty for a dense
        model."""
        return [
            f"{name}.router.weight"
            for name, m in self.named_modules() if isinstance(m, MoEMLP)
        ]

    def head_block(self) -> tuple:
        """(this rank's block of the vocab projection's rows, the vocab id
        of its first row): the whole [V, H] (the tied embedding or lm_head)
        and 0 where the model is bound to no tensor-parallel group."""
        w = self.embed.weight if self.lm_head is None else self.lm_head.weight
        if self.tp_group is None:
            return w, 0
        import torch.distributed as dist

        w = _local(w)
        return w, w.shape[0] * dist.get_rank(self.tp_group)

    def head_weight(self) -> torch.Tensor:
        """The vocab projection [V, H] (the tied embedding or lm_head).
        Bound to a tensor-parallel group, whose ranks each hold a block of
        its vocab rows, the blocks are gathered (the gradient of a block is
        its part of the whole one's: every rank computes the same function
        of it). The chunked loss reads :meth:`head_block` instead."""
        w, _ = self.head_block()
        if self.tp_group is None:
            return w
        return _GatherRows.apply(w, self.tp_group)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """The embeddings [B,S,H] of ``tokens`` in cfg.dtype. Bound to a
        tensor-parallel group, each rank looks up the tokens in its block of
        vocab rows (zero elsewhere) and the blocks' rows are summed over
        the group: one nonzero term each, so the sum is exact."""
        dt = self.cfg.dtype
        if self.tp_group is None:
            return F.embedding(tokens, self.embed.weight.to(dt))
        import torch.distributed as dist

        w = _local(self.embed.weight)
        n = w.shape[0]
        ids = tokens - n * dist.get_rank(self.tp_group)
        hit = ((ids >= 0) & (ids < n))[..., None]
        x = F.embedding(ids.clamp(0, n - 1), w.to(dt))
        return _SumOverGroups.apply(torch.where(hit, x, 0), (self.tp_group,))

    def call(self, fn: Callable[..., Any], *args: Any) -> Any:
        """``fn(self, *args)``: a loss or a schedule that reads the model's
        own parameters outside :meth:`forward` (the vocab head, the
        embedding of a pipeline's first stage). Under FSDP2 this method is
        registered as a forward method of the root
        (``parallel.train.init_train_state``), so the root's parameters are
        gathered for all of ``fn`` and its gradients reduced after it."""
        return fn(self, *args)

    def hidden(
        self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """The post-final-norm hidden states [B,S,H] in cfg.dtype. The
        positions default to the tokens' own: ``sequence_offset`` onward.
        A model that holds one pipeline stage's layers runs only through
        ``parallel.pipeline.make_pipeline_loss``."""
        cfg = self.cfg
        if len(self.layers) != cfg.num_layers:
            raise ValueError(
                f"this model holds {len(self.layers)} of {cfg.num_layers} "
                "layers (one pipeline stage): run it through "
                "parallel.pipeline.make_pipeline_loss"
            )
        if positions is None:
            S = tokens.shape[1]
            positions = self.sequence_offset(S) + torch.arange(S, device=tokens.device)
            positions = positions.expand(tokens.shape)
        x = self.embed_tokens(tokens)
        cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
        for block in self.layers.values():
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    block, x, cos, sin, use_reentrant=False
                )
            else:
                x = block(x, cos, sin)
        return self.final_norm(x)

    def forward(
        self,
        tokens: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        return_hidden: bool = False,
    ) -> torch.Tensor:
        x = self.hidden(tokens, positions)
        if return_hidden:
            return x
        return _linear(x, self.head_weight(), self.cfg.dtype).float()


# ---------------------------------------------------------------------------
# Parameter trees across the two packages
# ---------------------------------------------------------------------------

# (torch name inside a block, flax path inside "layers", how to convert)
_DENSE = "dense"  # flax kernel [in, out] -> torch weight [out, in]
_QKV = "qkv"  # flax [H, heads, Dh] -> torch [heads*Dh, H]
_OUT = "out"  # flax [heads, Dh, H] -> torch [H, heads*Dh]
_VEC = "vec"  # carried as it is (norm scales; experts [E, in, out])
_BLOCK_PARAMS = (
    ("attn_norm.scale", ("attn_norm", "scale"), _VEC),
    ("attn.wq.weight", ("attn", "wq", "kernel"), _QKV),
    ("attn.wk.weight", ("attn", "wk", "kernel"), _QKV),
    ("attn.wv.weight", ("attn", "wv", "kernel"), _QKV),
    ("attn.wo.weight", ("attn", "wo", "kernel"), _OUT),
    ("mlp_norm.scale", ("mlp_norm", "scale"), _VEC),
)
_MLP_PARAMS = (
    ("mlp.gate.weight", ("mlp", "gate", "kernel"), _DENSE),
    ("mlp.up.weight", ("mlp", "up", "kernel"), _DENSE),
    ("mlp.down.weight", ("mlp", "down", "kernel"), _DENSE),
)
_MOE_PARAMS = (
    ("mlp.router.weight", ("mlp", "router", "kernel"), _DENSE),
    ("mlp.experts_gate", ("mlp", "experts_gate"), _VEC),
    ("mlp.experts_up", ("mlp", "experts_up"), _VEC),
    ("mlp.experts_down", ("mlp", "experts_down"), _VEC),
)


def _block_params(moe: bool) -> tuple:
    return _BLOCK_PARAMS + (_MOE_PARAMS if moe else _MLP_PARAMS)


def _get(tree: Any, path: tuple) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def _to_torch_layout(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == _QKV:
        return a.reshape(a.shape[0], -1).T
    if kind == _OUT:
        return a.reshape(-1, a.shape[-1]).T
    if kind == _DENSE:
        return a.T
    return a


def params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``Transformer`` parameter tree (numpy leaves; ``layers``
    stacked with a leading [num_layers] dim by ``nn.scan``) as a
    ``state_dict`` for :class:`Transformer`."""
    if "params" in params:
        params = params["params"]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    out = {
        "embed.weight": t(params["embed"]["embedding"]),
        "final_norm.scale": t(params["final_norm"]["scale"]),
    }
    if "lm_head" in params:
        out["lm_head.weight"] = t(np.asarray(params["lm_head"]["kernel"]).T)
    layers = params["layers"]
    n = np.asarray(layers["attn_norm"]["scale"]).shape[0]
    for i in range(n):
        for name, path, kind in _block_params("router" in layers["mlp"]):
            a = np.asarray(_get(layers, path))[i]
            out[f"layers.{i}.{name}"] = t(_to_torch_layout(a, kind))
    return out


def flax_leaf_names(names: Iterable[str]) -> List[List[str]]:
    """The port parameter names behind each leaf of the flax parameter
    tree of the same model, in ``jax.tree_util.tree_leaves`` order (sorted
    paths): a leaf of the layer stack (``nn.scan``'s leading [num_layers]
    dim) lists its per-layer names in layer order, so each leaf's size is
    the sum of its names' sizes."""
    names = set(names)
    paths = {
        ("embed", "embedding"): ["embed.weight"],
        ("final_norm", "scale"): ["final_norm.scale"],
    }
    if "lm_head.weight" in names:
        paths[("lm_head", "kernel")] = ["lm_head.weight"]
    n_layers = len({n.split(".")[1] for n in names if n.startswith("layers.")})
    moe = any(".mlp.router." in n for n in names)
    for name, path, _ in _block_params(moe):
        paths[("layers",) + path] = [
            f"layers.{i}.{name}" for i in range(n_layers)
        ]
    return [paths[p] for p in sorted(paths)]


def params_to_jax(
    tensors: Dict[str, torch.Tensor], cfg: LlamaConfig
) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax` for a ``state_dict`` (or a
    name -> gradient dict of the same keys): a flax-shaped tree of numpy
    arrays with the layer stack's leading [num_layers] dim."""
    a = {k: v.detach().float().cpu().numpy() for k, v in tensors.items()}
    heads = {
        "attn.wq.weight": cfg.num_heads,
        "attn.wk.weight": cfg.num_kv_heads,
        "attn.wv.weight": cfg.num_kv_heads,
    }
    layers: Dict[str, Any] = {}
    for name, path, kind in _block_params(cfg.num_experts > 0):
        stack = []
        for i in range(cfg.num_layers):
            w = a[f"layers.{i}.{name}"]
            if kind == _QKV:
                w = w.T.reshape(cfg.hidden_size, heads[name], cfg.head_dim)
            elif kind == _OUT:
                w = w.T.reshape(cfg.num_heads, cfg.head_dim, cfg.hidden_size)
            elif kind == _DENSE:
                w = w.T
            stack.append(w)
        node = layers
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(stack)
    out: Dict[str, Any] = {
        "embed": {"embedding": a["embed.weight"]},
        "final_norm": {"scale": a["final_norm.scale"]},
        "layers": layers,
    }
    if "lm_head.weight" in a:
        out["lm_head"] = {"kernel": a["lm_head.weight"].T}
    return out
