"""Causal GQA flash attention: three hand-written CUDA kernels for Hopper.

The port of ``torchft_tpu/ops/flash_attention.py``'s Pallas TPU kernels
(``_flash_kernel``, ``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``).
The kernels live in ``csrc/flash_attention.cu`` (built with ``nvcc`` for
``sm_90a`` at first use, bound with ``ctypes``); the source says what bounds
them on the H100 and how the design answers it.

Layout is the model's ``[B, S, H, D]`` in and out (the kernels read it
through strides; no transpose), ``lse``/``delta`` are fp32 ``[B, Hq, S]``.
Scores, softmax and every sum are fp32 whatever the input dtype (bf16 or
fp32); P and dS are rounded to the input dtype before their products, as
the TPU kernels do.

Each kernel has a wrapper (``flash_fwd``, ``flash_bwd_dq``,
``flash_bwd_dkv``) and a plain PyTorch version of the same math
(``flash_attention_fwd_reference``, ``flash_bwd_dq_reference``,
``flash_bwd_dkv_reference``; ``flash_attention_bwd_reference`` runs both
backward parts). A wrapper takes the plain version only for tensors on the
CPU; for CUDA tensors it launches its kernel or raises. ``LAUNCHES`` counts
kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

__all__ = [
    "FlashAttentionFunction",
    "LAUNCHES",
    "flash_attention",
    "flash_attention_bwd_reference",
    "flash_attention_fwd_reference",
    "flash_attention_term_sums",
    "flash_bwd_dkv",
    "flash_bwd_dkv_reference",
    "flash_bwd_dq",
    "flash_bwd_dq_reference",
    "flash_fwd",
    "supports",
]

_NEG_INF = -1e30
_SOURCE = "flash_attention.cu"
_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset, by kernel name.
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
}


def supports(seq_len: int, block_q: int = 512, block_k: int = 512) -> bool:
    """Whether the flash path handles this sequence length (the caller
    falls back to dense attention otherwise). Same gate as the JAX
    package's: ``block_q``/``block_k`` are the TPU block sizes the model
    config names; the CUDA kernels' own tile (64) handles any length."""
    bq = min(block_q, seq_len)
    bk = min(block_k, seq_len)
    return (
        seq_len % bq == 0
        and seq_len % bk == 0
        and bq % 16 == 0
        and bk % 16 == 0
    )


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


def _heads_first(x: torch.Tensor, group: int = 1) -> torch.Tensor:
    """[B,S,H,D] -> fp32 [B,H*group,S,D] (kv heads repeated for GQA)."""
    x = x.float().permute(0, 2, 1, 3)
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _scores(qf, kf, causal: bool, scale: float) -> torch.Tensor:
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        S = s.shape[-1]
        keep = torch.ones(S, S, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,S,Hq,D] in q's dtype, lse fp32 [B,Hq,S]); the forward
    kernel's math on whole rows: fp32 scores, lse, P rounded to v's dtype
    before the P.V product."""
    D = q.shape[-1]
    g = q.shape[2] // k.shape[2]
    s = _scores(_heads_first(q), _heads_first(k, g), causal, 1.0 / math.sqrt(D))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype).float()
    out = torch.matmul(p, _heads_first(v, g))
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse.contiguous()


def _bwd_terms(q, k, v, dout, lse, delta, causal):
    """fp32 [B,Hq,S,*] operands of the backward: (qf, kf, dof, P, dS), P and
    dS rounded to the input dtype as the kernels round them before their
    products."""
    g = q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = _heads_first(q), _heads_first(k, g), _heads_first(v, g)
    dof = _heads_first(dout)
    p = torch.exp(_scores(qf, kf, causal, scale) - lse[..., None])
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    return qf, kf, dof, p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal=True) -> torch.Tensor:
    """dq [B,S,Hq,D] of the dq kernel's math: dS.K * scale."""
    _, kf, _, _, ds = _bwd_terms(q, k, v, dout, lse, delta, causal)
    dq = torch.matmul(ds, kf) / math.sqrt(q.shape[-1])
    return dq.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def flash_bwd_dkv_reference(
    q, k, v, dout, lse, delta, causal=True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,S,Hkv,D] of the dk/dv kernel's math: dS^T.Q * scale and
    P^T.dO, each summed over the kv head's GQA group."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qf, _, dof, p, ds = _bwd_terms(q, k, v, dout, lse, delta, causal)

    def kv_grad(x: torch.Tensor) -> torch.Tensor:
        x = x.view(B, Hkv, Hq // Hkv, S, D).sum(dim=2)
        return x.permute(0, 2, 1, 3).to(k.dtype).contiguous()

    dk = torch.matmul(ds.transpose(-1, -2), qf) / math.sqrt(D)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return kv_grad(dk), kv_grad(dv)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the inputs' layouts and dtypes; the backward
    kernels' math: P from lse, dS = P * (dO.V^T - delta), P and dS rounded
    to the input dtype before their products, dk/dv summed over the GQA
    group."""
    dq = flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal)
    dk, dv = flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal)
    return dq, dk, dv


def flash_attention_term_sums(
    q, k, v, dout, lse, delta, causal: bool = True
) -> Dict[str, torch.Tensor]:
    """For each element of out, dq, dk and dv, the sum of the absolute
    values of the product terms that make it: |P|.|V|, |dS|.|K| * scale,
    |dS|^T.|Q| * scale and |P|^T.|dO| (GQA groups summed), fp32 in the
    outputs' layouts. Two implementations of this math that round P or dS
    to bf16 at different points (the kernel rounds the online softmax's
    unnormalised P, the plain version the normalised one) differ by up to
    2^-7 of it (each rounding is off by up to 2^-8) before their outputs
    are rounded; where terms cancel it is far larger than the element
    itself."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qf, kf, dof, p, ds = _bwd_terms(q, k, v, dout, lse, delta, causal)
    vf = _heads_first(v, g)
    ds = ds.abs()

    def layout(x: torch.Tensor, heads: int) -> torch.Tensor:
        if heads != Hq:
            x = x.view(B, heads, g, S, D).sum(dim=2)
        return x.permute(0, 2, 1, 3).contiguous()

    return {
        "out": layout(torch.matmul(p, vf.abs()), Hq),
        "dq": layout(torch.matmul(ds, kf.abs()) * scale, Hq),
        "dk": layout(torch.matmul(ds.transpose(-1, -2), qf.abs()) * scale, Hkv),
        "dv": layout(torch.matmul(p.transpose(-1, -2), dof.abs()), Hkv),
    }


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from torchft_tpu_torch.ops import _cuda_build

        lib = _cuda_build.load(_SOURCE)
        P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        shape = [I, I, I, I, I]  # B, S, Hq, Hkv, D
        strides = [L] * 6
        tail = [I, I, F, P]  # causal, dtype, scale, stream
        lib.tft_flash_fwd.argtypes = [P] * 5 + shape + strides + tail
        lib.tft_flash_bwd_dq.argtypes = [P] * 7 + shape + strides + tail
        lib.tft_flash_bwd_dkv.argtypes = [P] * 8 + shape + strides + tail
        for fn in (lib.tft_flash_fwd, lib.tft_flash_bwd_dq, lib.tft_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(
    name: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_like: Tuple[torch.Tensor, ...] = (),
    rows: Tuple[torch.Tensor, ...] = (),
) -> None:
    """Raises unless the kernel takes these tensors: all on one CUDA
    device, q/k/v (and ``q_like``) contiguous [B,S,H,D] in one of fp32 or
    bf16 with D in (16, 32, 64, 128) and Hq % Hkv == 0, ``rows`` (lse,
    delta) contiguous fp32 [B,Hq,S]."""
    tensors = (q, k, v, *q_like, *rows)
    if not all(t.is_cuda for t in tensors) or len(
        {t.device for t in tensors}
    ) != 1:
        raise ValueError(
            f"{name}: tensors must all lie on one CUDA device (or all on "
            f"the CPU for the plain version), got "
            f"{[str(t.device) for t in tensors]}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"{name}: want q [B,S,Hq,D] and k, v [B,S,Hkv,D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, Hq, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if Hq % k.shape[2] != 0:
        raise ValueError(f"{name}: Hq={Hq} not a multiple of Hkv={k.shape[2]}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not in fp32/bf16")
    for t in (k, v, *q_like):
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: mixed dtypes {q.dtype} and {t.dtype}")
    for t in q_like:
        if t.shape != q.shape:
            raise ValueError(f"{name}: {tuple(t.shape)} != q {tuple(q.shape)}")
    for t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, Hq, S):
            raise ValueError(
                f"{name}: lse/delta must be fp32 {(B, Hq, S)}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: tensors must be contiguous and aligned")


def _launch(name: str, fn, q: torch.Tensor, k: torch.Tensor, ptrs, causal):
    B, S, Hq, D = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            *ptrs,
            B, S, Hq, k.shape[2], D,
            *q.stride()[:3], *k.stride()[:3],
            int(causal), _DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(D), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")
    LAUNCHES[name] += 1


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel (replaces ``_flash_kernel``): (out, lse)."""
    if _on_cpu(q, k, v):
        return flash_attention_fwd_reference(q, k, v, causal)
    _check("flash_fwd", q, k, v)
    B, S, Hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    ptrs = [t.data_ptr() for t in (q, k, v, out, lse)]
    _launch("flash_fwd", _library().tft_flash_fwd, q, k, ptrs, causal)
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True) -> torch.Tensor:
    """Backward dq kernel (replaces ``_flash_bwd_dq_kernel``)."""
    if _on_cpu(q, k, v, dout, lse, delta):
        return flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal)
    _check("flash_bwd_dq", q, k, v, q_like=(dout,), rows=(lse, delta))
    dq = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta, dq)]
    _launch("flash_bwd_dq", _library().tft_flash_bwd_dq, q, k, ptrs, causal)
    return dq


def flash_bwd_dkv(
    q, k, v, dout, lse, delta, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward dk/dv kernel (replaces ``_flash_bwd_dkv_kernel``)."""
    if _on_cpu(q, k, v, dout, lse, delta):
        return flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal)
    _check("flash_bwd_dkv", q, k, v, q_like=(dout,), rows=(lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta, dk, dv)]
    _launch("flash_bwd_dkv", _library().tft_flash_bwd_dkv, q, k, ptrs, causal)
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Differentiable flash attention over the three kernels (the JAX
    package's ``custom_vjp``). Backward computes delta = rowsum(dO * O) in
    plain torch, as the JAX code does outside its kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True):
        out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (
            (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
        )
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Causal GQA flash attention, differentiable. q: [B,S,Hq,D]; k/v:
    [B,S,Hkv,D] with Hq % Hkv == 0. Returns [B,S,Hq,D] in q's dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    assert Hq % Hkv == 0, (Hq, Hkv)
    block_q = min(block_q, S)
    block_k = min(block_k, S)
    if not supports(S, block_q, block_k):
        raise ValueError(
            f"flash_attention: seq_len {S} not divisible by blocks "
            f"({block_q},{block_k}); use dense_attention"
        )
    return FlashAttentionFunction.apply(q, k, v, causal)
