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
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

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
    # 'dense' | 'flash'. flash = the hand-written CUDA kernels
    # (ops/flash_attention.py), dense for lengths the flash gate refuses.
    # 'ring' and 'ulysses' are not ported yet (ROADMAP.md, parallel/*).
    attn_impl: str = "dense"
    # Below this sequence length the 'flash' impl routes to dense.
    flash_min_seq: int = 2048
    # The flash gate's block sizes (supports()); the CUDA tile is the
    # kernel's own.
    flash_block_q: int = 512
    flash_block_k: int = 512
    # Mixture of experts is not ported yet (ROADMAP.md, MoE); must stay 0.
    num_experts: int = 0

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
        if cfg.attn_impl not in ("dense", "flash"):
            raise NotImplementedError(
                f"attn_impl={cfg.attn_impl!r} is not ported yet "
                "(ROADMAP.md queue 1: parallel/* ring and ulysses attention)"
            )
        self.cfg = cfg
        H, Dh = cfg.hidden_size, cfg.head_dim
        self.wq = nn.Linear(H, cfg.num_heads * Dh, bias=False)
        self.wk = nn.Linear(H, cfg.num_kv_heads * Dh, bias=False)
        self.wv = nn.Linear(H, cfg.num_kv_heads * Dh, bias=False)
        self.wo = nn.Linear(cfg.num_heads * Dh, H, bias=False)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        heads = lambda t, n: t.view(B, S, n, cfg.head_dim)  # noqa: E731
        q = heads(_linear(x, self.wq.weight, cfg.dtype), cfg.num_heads)
        k = heads(_linear(x, self.wk.weight, cfg.dtype), cfg.num_kv_heads)
        v = heads(_linear(x, self.wv.weight, cfg.dtype), cfg.num_kv_heads)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if (
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
        return _linear(out.reshape(B, S, -1), self.wo.weight, cfg.dtype)


class MLP(nn.Module):
    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        self.cfg = cfg
        H, I = cfg.hidden_size, cfg.intermediate_size
        self.gate = nn.Linear(H, I, bias=False)
        self.up = nn.Linear(H, I, bias=False)
        self.down = nn.Linear(I, H, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        gate = _linear(x, self.gate.weight, dt)
        up = _linear(x, self.up.weight, dt)
        return _linear(F.silu(gate) * up, self.down.weight, dt)


class Block(nn.Module):
    def __init__(self, cfg: LlamaConfig) -> None:
        super().__init__()
        if cfg.num_experts > 0:
            raise NotImplementedError(
                "num_experts > 0 (MoE) is not ported yet (ROADMAP.md queue 1: "
                "MoE / expert parallelism)"
            )
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)
        self.attn = Attention(cfg)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)
        self.mlp = MLP(cfg)

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
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps)
        self.lm_head = (
            None
            if cfg.tie_embeddings
            else nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        )

    def head_weight(self) -> torch.Tensor:
        """The vocab projection [V, H] (the tied embedding or lm_head)."""
        return self.embed.weight if self.lm_head is None else self.lm_head.weight

    def forward(
        self,
        tokens: torch.Tensor,
        positions: Optional[torch.Tensor] = None,
        return_hidden: bool = False,
    ) -> torch.Tensor:
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
            positions = positions.expand(tokens.shape)
        x = F.embedding(tokens, self.embed.weight.to(cfg.dtype))
        cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta, cfg.dtype)
        for block in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    block, x, cos, sin, use_reentrant=False
                )
            else:
                x = block(x, cos, sin)
        x = self.final_norm(x)
        if return_hidden:
            return x
        return _linear(x, self.head_weight(), cfg.dtype).float()


# ---------------------------------------------------------------------------
# Parameter trees across the two packages
# ---------------------------------------------------------------------------

# (torch name inside a block, flax path inside "layers", how to convert)
_DENSE = "dense"  # flax kernel [in, out] -> torch weight [out, in]
_QKV = "qkv"  # flax [H, heads, Dh] -> torch [heads*Dh, H]
_OUT = "out"  # flax [heads, Dh, H] -> torch [H, heads*Dh]
_VEC = "vec"
_BLOCK_PARAMS = (
    ("attn_norm.scale", ("attn_norm", "scale"), _VEC),
    ("attn.wq.weight", ("attn", "wq", "kernel"), _QKV),
    ("attn.wk.weight", ("attn", "wk", "kernel"), _QKV),
    ("attn.wv.weight", ("attn", "wv", "kernel"), _QKV),
    ("attn.wo.weight", ("attn", "wo", "kernel"), _OUT),
    ("mlp_norm.scale", ("mlp_norm", "scale"), _VEC),
    ("mlp.gate.weight", ("mlp", "gate", "kernel"), _DENSE),
    ("mlp.up.weight", ("mlp", "up", "kernel"), _DENSE),
    ("mlp.down.weight", ("mlp", "down", "kernel"), _DENSE),
)


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
        for name, path, kind in _BLOCK_PARAMS:
            a = np.asarray(_get(layers, path))[i]
            out[f"layers.{i}.{name}"] = t(_to_torch_layout(a, kind))
    return out


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
    for name, path, kind in _BLOCK_PARAMS:
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
