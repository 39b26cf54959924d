"""GQA flash attention: six hand-written CUDA kernels for Hopper.

The port of ``torchft_tpu/ops/flash_attention.py``'s Pallas TPU kernels:
causal attention over a whole sequence (``_flash_kernel``,
``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``) and the offset-block
variant ring attention folds with (``_flash_block_fwd_kernel``,
``_flash_block_bwd_dq_kernel``, ``_flash_block_bwd_dkv_kernel``): a q shard
against one k/v block, causal at global positions ``q_offset + i >=
k_offset + j``. The kernels live in ``csrc/flash_attention.cu`` (built with
``nvcc`` for ``sm_90a`` at first use, bound with ``ctypes``); the source
says what bounds them on the H100 and how the design answers it. The
library routes by dtype: in bf16 all three kernels run on the tensor cores
(``wgmma``), in fp32 on FMA bodies; a call that cannot launch raises,
whatever the dtype.

Layout is the model's ``[B, S, H, D]`` in and out (the kernels read it
through strides; no transpose), ``lse``/``delta``/``dlse`` are fp32
``[B, Hq, S]``. Scores, softmax and every sum are fp32 whatever the input
dtype (bf16 or fp32); P and dS are rounded to the input dtype before their
products, as the TPU kernels do.

Each kernel has a wrapper (``flash_fwd``, ``flash_bwd_dq``,
``flash_bwd_dkv``; ``flash_block_fwd``, ``flash_block_bwd_dq``,
``flash_block_bwd_dkv``) and a plain PyTorch version of the same math (the
``*_reference`` functions; ``flash_attention_bwd_reference`` runs both
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
    "FlashBlockFunction",
    "LAUNCHES",
    "flash_attention",
    "flash_attention_block",
    "flash_attention_bwd_reference",
    "flash_attention_fwd_reference",
    "flash_attention_term_sums",
    "flash_block_bwd_dkv",
    "flash_block_bwd_dkv_reference",
    "flash_block_bwd_dq",
    "flash_block_bwd_dq_reference",
    "flash_block_fwd",
    "flash_block_fwd_reference",
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
# Offsets the kernels take: global positions stay far inside int32.
_MAX_OFFSET = 1 << 30

# Kernel launches since the last reset, by kernel name.
LAUNCHES: Dict[str, int] = {
    "flash_fwd": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "flash_block_fwd": 0,
    "flash_block_bwd_dq": 0,
    "flash_block_bwd_dkv": 0,
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


def _keep(q, k, causal: bool, q_offset: int = 0, k_offset: int = 0):
    """bool [Sq, Skv]: key j is visible to query i (``q_offset + i >=
    k_offset + j``), or None when nothing is masked."""
    if not causal:
        return None
    rows = torch.arange(q.shape[1], device=q.device) + int(q_offset)
    cols = torch.arange(k.shape[1], device=q.device) + int(k_offset)
    return rows[:, None] >= cols[None, :]


def _scores(qf, kf, keep, scale: float) -> torch.Tensor:
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    return s if keep is None else s.masked_fill(~keep, _NEG_INF)


def _probs(s: torch.Tensor, lse: torch.Tensor, keep) -> torch.Tensor:
    """P = exp(s - lse), 0 wherever the key is masked. A row that sees no
    key has lse = -1e30, so exp(s - lse) would be 1 there; the kernels
    skip such a row's tiles and leave it 0."""
    p = torch.exp(s - lse[..., None])
    return p if keep is None else p.masked_fill(~keep, 0.0)


def _fwd(q, k, v, keep) -> Tuple[torch.Tensor, torch.Tensor]:
    D = q.shape[-1]
    g = q.shape[2] // k.shape[2]
    s = _scores(_heads_first(q), _heads_first(k, g), keep, 1.0 / math.sqrt(D))
    lse = torch.logsumexp(s, dim=-1)
    p = _probs(s, lse, keep)
    if keep is not None:  # rows that see no key: out 0, lse -1e30
        lse = lse.masked_fill(~keep.any(dim=-1), _NEG_INF)
    out = torch.matmul(p.to(v.dtype).float(), _heads_first(v, g))
    return out.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse.contiguous()


def flash_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,S,Hq,D] in q's dtype, lse fp32 [B,Hq,S]); the forward
    kernel's math on whole rows: fp32 scores, lse, P rounded to v's dtype
    before the P.V product."""
    return _fwd(q, k, v, _keep(q, k, causal))


def flash_block_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_offset: int, k_offset: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,Sq,Hq,D] in q's dtype, lse fp32 [B,Hq,Sq]) of q [B,Sq,Hq,D]
    against k/v [B,Skv,Hkv,D], causal at global positions; the block
    forward kernel's math. A row that sees no key gets out 0 and lse
    -1e30."""
    return _fwd(q, k, v, _keep(q, k, True, q_offset, k_offset))


def _bwd_terms(q, k, v, dout, lse, delta, keep, dlse=None):
    """fp32 [B,Hq,S,*] operands of the backward: (qf, kf, dof, P, dS), P and
    dS rounded to the input dtype as the kernels round them before their
    products; dS = P * (dO.V^T - delta + dlse)."""
    g = q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = _heads_first(q), _heads_first(k, g), _heads_first(v, g)
    dof = _heads_first(dout)
    p = _probs(_scores(qf, kf, keep, scale), lse, keep)
    dsum = torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None]
    if dlse is not None:
        dsum = dsum + dlse[..., None]
    ds = p * dsum
    return qf, kf, dof, p.to(q.dtype).float(), ds.to(q.dtype).float()


def _dq(q, k, v, dout, lse, delta, keep, dlse=None) -> torch.Tensor:
    _, kf, _, _, ds = _bwd_terms(q, k, v, dout, lse, delta, keep, dlse)
    dq = torch.matmul(ds, kf) / math.sqrt(q.shape[-1])
    return dq.permute(0, 2, 1, 3).to(q.dtype).contiguous()


def _kv_heads(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """fp32 [B,Hq,Skv,D] summed over each kv head's GQA group ->
    [B,Skv,Hkv,D]."""
    B, Hq, S, D = x.shape
    x = x.view(B, Hkv, Hq // Hkv, S, D).sum(dim=2)
    return x.permute(0, 2, 1, 3)


def _dkv(q, k, v, dout, lse, delta, keep, dlse=None):
    qf, _, dof, p, ds = _bwd_terms(q, k, v, dout, lse, delta, keep, dlse)
    dk = torch.matmul(ds.transpose(-1, -2), qf) / math.sqrt(q.shape[-1])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    Hkv = k.shape[2]
    return tuple(
        _kv_heads(x, Hkv).to(k.dtype).contiguous() for x in (dk, dv)
    )


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal=True) -> torch.Tensor:
    """dq [B,S,Hq,D] of the dq kernel's math: dS.K * scale."""
    return _dq(q, k, v, dout, lse, delta, _keep(q, k, causal))


def flash_bwd_dkv_reference(
    q, k, v, dout, lse, delta, causal=True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,S,Hkv,D] of the dk/dv kernel's math: dS^T.Q * scale and
    P^T.dO, each summed over the kv head's GQA group."""
    return _dkv(q, k, v, dout, lse, delta, _keep(q, k, causal))


def flash_block_bwd_dq_reference(
    q, k, v, dout, lse, delta, dlse, q_offset: int, k_offset: int
) -> torch.Tensor:
    """dq [B,Sq,Hq,D] of the block dq kernel's math: the lse cotangent
    folded into dS = P * (dO.V^T - delta + dlse), then dS.K * scale."""
    keep = _keep(q, k, True, q_offset, k_offset)
    return _dq(q, k, v, dout, lse, delta, keep, dlse)


def flash_block_bwd_dkv_reference(
    q, k, v, dout, lse, delta, dlse, q_offset: int, k_offset: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,Skv,Hkv,D] of the block dk/dv kernel's math, with the
    same fold."""
    keep = _keep(q, k, True, q_offset, k_offset)
    return _dkv(q, k, v, dout, lse, delta, keep, dlse)


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
    q, k, v, dout, lse, delta, causal: bool = True,
    q_offset: int = 0, k_offset: int = 0, dlse=None,
) -> Dict[str, torch.Tensor]:
    """For each element of out, dq, dk and dv, the sum of the absolute
    values of the product terms that make it: |P|.|V|, |dS|.|K| * scale,
    |dS|^T.|Q| * scale and |P|^T.|dO| (GQA groups summed), fp32 in the
    outputs' layouts. Two implementations of this math that round P or dS
    to bf16 at different points (the kernel rounds the online softmax's
    unnormalised P, the plain version the normalised one) differ by up to
    2^-7 of it (each rounding is off by up to 2^-8) before their outputs
    are rounded; where terms cancel it is far larger than the element
    itself. With offsets (and ``dlse``) the terms are the block kernels':
    the mask at global positions, the lse cotangent folded into dS."""
    Hq, Hkv = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    keep = _keep(q, k, causal, q_offset, k_offset)
    qf, kf, dof, p, ds = _bwd_terms(q, k, v, dout, lse, delta, keep, dlse)
    vf = _heads_first(v, Hq // Hkv)
    ds = ds.abs()
    q_layout = lambda x: x.permute(0, 2, 1, 3).contiguous()  # noqa: E731
    kv_layout = lambda x: _kv_heads(x, Hkv).contiguous()  # noqa: E731
    return {
        "out": q_layout(torch.matmul(p, vf.abs())),
        "dq": q_layout(torch.matmul(ds, kf.abs()) * scale),
        "dk": kv_layout(torch.matmul(ds.transpose(-1, -2), qf.abs()) * scale),
        "dv": kv_layout(torch.matmul(p.transpose(-1, -2), dof.abs())),
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
        strides = [L] * 6
        # B, S, Hq, Hkv, D, strides, causal, dtype, scale, stream
        tail = [I] * 5 + strides + [I, I, F, P]
        lib.tft_flash_fwd.argtypes = [P] * 5 + tail
        lib.tft_flash_bwd_dq.argtypes = [P] * 7 + tail
        lib.tft_flash_bwd_dkv.argtypes = [P] * 8 + tail
        # B, Sq, Skv, Hq, Hkv, D, strides, q_off, k_off, dtype, scale, stream
        block_tail = [I] * 6 + strides + [I, I, I, F, P]
        lib.tft_flash_block_fwd.argtypes = [P] * 5 + block_tail
        lib.tft_flash_block_bwd_dq.argtypes = [P] * 8 + block_tail
        lib.tft_flash_block_bwd_dkv.argtypes = [P] * 9 + block_tail
        for fn in (
            lib.tft_flash_fwd, lib.tft_flash_bwd_dq, lib.tft_flash_bwd_dkv,
            lib.tft_flash_block_fwd, lib.tft_flash_block_bwd_dq,
            lib.tft_flash_block_bwd_dkv,
        ):
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
    same_len: bool = True,
) -> None:
    """Raises unless the kernel takes these tensors: all on one CUDA
    device, q (and ``q_like``) contiguous [B,Sq,Hq,D] and k, v [B,Skv,Hkv,D]
    in one of fp32 or bf16 with D in (16, 32, 64, 128), Hq % Hkv == 0 and,
    unless ``same_len`` is False, Sq == Skv; ``rows`` (lse, delta, dlse)
    contiguous fp32 [B,Hq,Sq]."""
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
    if (
        k.shape[0] != B or k.shape[3] != D
        or (same_len and k.shape[1] != S) or k.shape[1] == 0 or S == 0
    ):
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
                f"{name}: lse/delta/dlse must be fp32 {(B, Hq, S)}, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f"{name}: tensors must be contiguous and aligned")


def _offsets(name: str, q_offset, k_offset) -> Tuple[int, int]:
    offs = (int(q_offset), int(k_offset))
    if not all(-_MAX_OFFSET < o < _MAX_OFFSET for o in offs):
        raise ValueError(f"{name}: offsets {offs} outside +-2^30")
    return offs


def _launch(name: str, fn, q: torch.Tensor, k: torch.Tensor, ptrs, shape, mask):
    """Launches ``fn`` on q's device and current stream: ``ptrs``, then
    ``shape`` ((B, S, Hq, Hkv, D), or (B, Sq, Skv, Hq, Hkv, D) for a block
    kernel), the strides, ``mask`` ((causal,), or (q_off, k_off)), dtype,
    scale and stream; counts the launch."""
    D = q.shape[-1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            *ptrs, *shape,
            *q.stride()[:3], *k.stride()[:3],
            *mask, _DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(D), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")
    LAUNCHES[name] += 1


def _shape(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, ...]:
    B, S, Hq, D = q.shape
    return (B, S, Hq, k.shape[2], D)


def _block_shape(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, ...]:
    B, Sq, Hq, D = q.shape
    return (B, Sq, k.shape[1], Hq, k.shape[2], D)


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
    _launch("flash_fwd", _library().tft_flash_fwd, q, k, ptrs, _shape(q, k),
            (int(causal),))
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool = True) -> torch.Tensor:
    """Backward dq kernel (replaces ``_flash_bwd_dq_kernel``)."""
    if _on_cpu(q, k, v, dout, lse, delta):
        return flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal)
    _check("flash_bwd_dq", q, k, v, q_like=(dout,), rows=(lse, delta))
    dq = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta, dq)]
    _launch("flash_bwd_dq", _library().tft_flash_bwd_dq, q, k, ptrs,
            _shape(q, k), (int(causal),))
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
    _launch("flash_bwd_dkv", _library().tft_flash_bwd_dkv, q, k, ptrs,
            _shape(q, k), (int(causal),))
    return dk, dv


def flash_block_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset, k_offset
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block forward kernel (replaces ``_flash_block_fwd_kernel``): (out,
    lse) of q [B,Sq,Hq,D] against k/v [B,Skv,Hkv,D] at global offsets."""
    if _on_cpu(q, k, v):
        return flash_block_fwd_reference(q, k, v, q_offset, k_offset)
    offs = _offsets("flash_block_fwd", q_offset, k_offset)
    _check("flash_block_fwd", q, k, v, same_len=False)
    B, Sq, Hq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    ptrs = [t.data_ptr() for t in (q, k, v, out, lse)]
    _launch("flash_block_fwd", _library().tft_flash_block_fwd, q, k, ptrs,
            _block_shape(q, k), offs)
    return out, lse


def flash_block_bwd_dq(
    q, k, v, dout, lse, delta, dlse, q_offset, k_offset
) -> torch.Tensor:
    """Block backward dq kernel (replaces ``_flash_block_bwd_dq_kernel``)."""
    if _on_cpu(q, k, v, dout, lse, delta, dlse):
        return flash_block_bwd_dq_reference(
            q, k, v, dout, lse, delta, dlse, q_offset, k_offset
        )
    offs = _offsets("flash_block_bwd_dq", q_offset, k_offset)
    _check("flash_block_bwd_dq", q, k, v, q_like=(dout,),
           rows=(lse, delta, dlse), same_len=False)
    dq = torch.empty_like(q)
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta, dlse, dq)]
    _launch("flash_block_bwd_dq", _library().tft_flash_block_bwd_dq, q, k,
            ptrs, _block_shape(q, k), offs)
    return dq


def flash_block_bwd_dkv(
    q, k, v, dout, lse, delta, dlse, q_offset, k_offset
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block backward dk/dv kernel (replaces
    ``_flash_block_bwd_dkv_kernel``)."""
    if _on_cpu(q, k, v, dout, lse, delta, dlse):
        return flash_block_bwd_dkv_reference(
            q, k, v, dout, lse, delta, dlse, q_offset, k_offset
        )
    offs = _offsets("flash_block_bwd_dkv", q_offset, k_offset)
    _check("flash_block_bwd_dkv", q, k, v, q_like=(dout,),
           rows=(lse, delta, dlse), same_len=False)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta, dlse, dk, dv)]
    _launch("flash_block_bwd_dkv", _library().tft_flash_block_bwd_dkv, q, k,
            ptrs, _block_shape(q, k), offs)
    return dk, dv


def _delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) as fp32 [B,Hq,S], computed outside the kernels as
    the JAX code does."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


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
        delta = _delta(dout, out)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.causal)
        return dq, dk, dv, None


class FlashBlockFunction(torch.autograd.Function):
    """Differentiable offset-block attention over the three block kernels
    (the JAX package's ``_flash_block`` ``custom_vjp``). Both outputs carry
    cotangents, since the ring merge uses lse: backward folds dlse into dS
    inside the kernels and computes delta = rowsum(dO * O) in plain torch.
    The offsets get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, k_offset: int):
        out, lse = flash_block_fwd(q, k, v, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.offsets = (q_offset, k_offset)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = _delta(dout, out)
        dlse = dlse.float().contiguous()
        args = (q, k, v, dout, lse, delta, dlse, *ctx.offsets)
        dq = flash_block_bwd_dq(*args)
        dk, dv = flash_block_bwd_dkv(*args)
        return dq, dk, dv, None, None


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


def flash_attention_block(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_offset,
    k_offset,
    block_q: int = 512,
    block_k: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One causal-at-global-positions attention block: q [B,Sq,Hq,D]
    against k/v [B,Skv,Hkv,D], where q row i has global position
    ``q_offset + i`` and k row j has ``k_offset + j`` (ints). Returns
    ``(out [B,Sq,Hq,D], lse [B,Hq,Sq] fp32)``; merge streamed blocks with
    the online-softmax combine (``parallel/ring_attention.py``).
    Differentiable in both outputs (the offsets get no gradient)."""
    Sq, Skv = q.shape[1], k.shape[1]
    block_q = min(block_q, Sq)
    block_k = min(block_k, Skv)
    if not (supports(Sq, block_q, block_q) and supports(Skv, block_k, block_k)):
        raise ValueError(
            f"flash_attention_block: shapes (Sq={Sq}, Skv={Skv}) not "
            f"block-divisible; use the dense fold"
        )
    return FlashBlockFunction.apply(q, k, v, int(q_offset), int(k_offset))
