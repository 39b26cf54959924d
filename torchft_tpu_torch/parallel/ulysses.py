"""Ulysses-style all-to-all sequence (context) parallelism.

The port of ``torchft_tpu/parallel/ulysses.py``, the second context-parallel
mode beside ring attention (``ring_attention.py``): instead of streaming k/v
blocks around a ring, two all-to-alls re-shard the activations from
sequence-sharded to head-sharded and back::

    [B, S/sp, H, D]  --all_to_all-->  [B, S, H/sp, D]
        (attention over the FULL sequence, H/sp heads per rank)
    [B, S, H/sp, D]  --all_to_all-->  [B, S/sp, H, D]

Each rank then runs ordinary attention over the whole sequence for its head
subset, so the whole-sequence flash kernels apply unchanged. In JAX the ranks
run in one SPMD program and ``jax.lax.all_to_all`` moves the pieces. Here
:func:`make_ulysses_attention` runs the ranks' bodies one after another,
each on its own device, and spells the tiled all-to-all out: after the first
one rank ``i`` holds ``cat_j(shard_j.chunk(sp, dim=2)[i], dim=1)``, after
the second rank ``j`` holds ``cat_i(out_i.chunk(sp, dim=1)[j], dim=2)``,
each piece moved to the receiving rank's device with ``.to()`` (a no-op on a
mesh that repeats one device). Both are differentiable; their transposes are
the reverse re-shards, as in JAX.

GQA: k/v heads are repeated up to the smallest multiple that divides evenly
over ``sp`` and divides the q-head count (:func:`_kv_expand_factor`), with
``repeat_interleave`` (``jnp.repeat``), so q head h keeps its kv head
h // (Hq / Hkv) on every rank.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from torchft_tpu_torch.models.llama import dense_attention
from torchft_tpu_torch.ops.flash_attention import flash_attention, supports
from torchft_tpu_torch.parallel.mesh import Mesh
from torchft_tpu_torch.parallel.sharding import TP_EP_ITEM


def _kv_expand_factor(h_q: int, h_kv: int, sp: int) -> int:
    """Smallest r such that sp divides h_kv*r and h_kv*r divides h_q
    (falls back to full MHA expansion r = h_q/h_kv)."""
    for r in range(1, h_q // h_kv + 1):
        hk = h_kv * r
        if h_q % hk == 0 and hk % sp == 0:
            return r
    return h_q // h_kv


def ulysses_attention_shard(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    use_flash: Optional[bool] = None,
) -> torch.Tensor:
    """One rank's attention between the two all-to-alls: q [B, S, Hq/sp, D]
    and k/v [B, S, Hk/sp, D] hold the FULL sequence for this rank's heads.
    The JAX body's gate: the flash kernels when ``use_flash`` says so, or
    by default when causal with S >= 1024, and only for lengths the flash
    gate ``supports``; dense attention otherwise. Returns q's dtype."""
    s = q.shape[1]
    flash = use_flash
    if flash is None:
        flash = causal and s >= 1024
    if flash and supports(s):
        out = flash_attention(q, k, v, causal=causal)
    else:
        out = dense_attention(q, k, v, causal=causal)
    return out.to(q.dtype)


def _seq_to_heads(
    shards: Sequence[torch.Tensor], devices: Sequence[torch.device]
) -> List[torch.Tensor]:
    # Rank i receives head block i of every rank's sequence shard, in rank
    # (= sequence) order: split heads (dim 2), gather the sequence (dim 1).
    n = len(devices)
    pieces = [s.chunk(n, dim=2) for s in shards]
    return [
        torch.cat([p[i].to(devices[i]) for p in pieces], dim=1) for i in range(n)
    ]


def _heads_to_seq(
    outs: Sequence[torch.Tensor], devices: Sequence[torch.device]
) -> List[torch.Tensor]:
    # Rank j receives sequence block j of every rank's heads, in rank (=
    # head) order: split the sequence (dim 1), gather heads (dim 2).
    n = len(devices)
    pieces = [o.chunk(n, dim=1) for o in outs]
    return [
        torch.cat([p[j].to(devices[j]) for p in pieces], dim=2) for j in range(n)
    ]


def make_ulysses_attention(mesh: Mesh, use_flash: Optional[bool] = None):
    """Returns causal ``attn_fn(q, k, v)`` over [B, S, H, Dh]: the sequence split
    over the mesh's ``sp`` devices, re-sharded to heads, attended, re-sharded
    back and gathered on q's device. Differentiable. The all-to-all
    counterpart of :func:`make_ring_attention`, with the same limits: the
    batch is this rank's rows (dp and fsdp are process axes), and head
    sharding (the JAX version's tp axis) is not ported: tp above 1
    raises."""
    if mesh.shape["tp"] > 1:
        raise NotImplementedError(
            f"Ulysses attention on a mesh with tp={mesh.shape['tp']}: head sharding "
            f"across ranks is not ported ({TP_EP_ITEM})"
        )
    devices = mesh.axis_devices("sp")
    n = len(devices)

    def attn_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if n == 1:  # a degenerate axis: no re-shard, as in JAX
            out = ulysses_attention_shard(
                q.to(devices[0]), k.to(devices[0]), v.to(devices[0]),
                use_flash=use_flash,
            )
            return out.to(q.device)
        h_q, h_kv = q.shape[2], k.shape[2]
        if h_q % n:
            raise ValueError(
                f"Ulysses needs heads ({h_q}) divisible by the sp axis ({n}); "
                "use ring attention otherwise"
            )
        if q.shape[1] % n or k.shape[1] % n:
            raise ValueError(
                f"Ulysses attention: seq lens {q.shape[1]}, {k.shape[1]} not "
                f"divisible by sp={n}"
            )
        r = _kv_expand_factor(h_q, h_kv, n)
        if r > 1:
            k = torch.repeat_interleave(k, r, dim=2)
            v = torch.repeat_interleave(v, r, dim=2)
        shard = lambda x: [  # noqa: E731
            c.to(d) for c, d in zip(x.chunk(n, dim=1), devices)
        ]
        qh, kh, vh = (_seq_to_heads(shard(x), devices) for x in (q, k, v))
        outs = [
            ulysses_attention_shard(qh[i], kh[i], vh[i], use_flash=use_flash)
            for i in range(n)
        ]
        back = _heads_to_seq(outs, devices)
        return torch.cat([b.to(q.device) for b in back], dim=1)

    return attn_fn
