"""Ring attention: exact causal attention with the sequence sharded over the
mesh's ``sp`` axis (context parallelism for long sequences).

The port of ``torchft_tpu/parallel/ring_attention.py``. Each ``sp`` rank
holds one query shard and sees every key/value shard pass by, one hop of the
ring at a time, folding each into an online softmax in fp32. In JAX the
ranks run in one SPMD program and ``ppermute`` moves the blocks. Here
:func:`make_ring_attention` runs the ranks' bodies one after another, each on
its own device, and the rotate step moves a block to the receiving rank's
device with ``.to()``: a no-op on a mesh that repeats one device (the
one-card stand-in for the JAX tests' virtual devices). A ring across
distinct cards, with the rotation overlapping the fold, is not ported
(ROADMAP.md).

Two per-shard bodies, as in JAX: :func:`ring_attention_shard_flash` folds
each block with the offset-block flash kernels
(``ops.flash_attention.flash_attention_block``) and merges ``(out, lse)``
pairs; :func:`ring_attention_shard` is the dense fold, plain torch, for
shards too small for the flash gate. Each body takes its rank ``idx``, the
ring size and ``rotate(k_blk, v_blk) -> (k_blk, v_blk)``, which stands for
the ``ppermute`` of one hop: the rank sends its block to ``idx + 1`` and
receives ``idx - 1``'s.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from torchft_tpu_torch.ops.flash_attention import flash_attention_block, supports
from torchft_tpu_torch.parallel.mesh import Mesh
from torchft_tpu_torch.parallel.sharding import TP_EP_ITEM

Rotate = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _flash_fold_supported(sq: int, skv: int) -> bool:
    # The flash fold needs block-divisible shard lengths; tiny shards
    # (tests, debug models) stay on the dense fold.
    return sq >= 256 and skv >= 256 and supports(sq) and supports(skv)


def ring_attention_shard_flash(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    idx: int,
    axis_size: int,
    rotate: Optional[Rotate] = None,
) -> torch.Tensor:
    """Rank ``idx``'s ring body with the flash fold: each block is folded
    with :func:`flash_attention_block` (attention at GLOBAL positions) and
    merged by the online-softmax combine in fp32. Same semantics as
    :func:`ring_attention_shard`. The block's ``out`` is rounded to q's
    dtype before the merge, as in JAX."""
    b, sq, hq, dh = q.shape
    skv = k.shape[1]
    q_off = idx * sq
    out = torch.zeros((b, sq, hq, dh), dtype=torch.float32, device=q.device)
    # -inf meets only finite block lses: a block whose keys all lie in the
    # future returns lse = -1e30, never -inf, so no NaN enters a gradient.
    lse = torch.full((b, hq, sq), float("-inf"), device=q.device)

    def fold(i, k_blk, v_blk, out, lse):
        src = (idx - i) % axis_size  # the rank this block started on
        o_blk, lse_blk = flash_attention_block(q, k_blk, v_blk, q_off, src * skv)
        new_lse = torch.logaddexp(lse, lse_blk)
        safe = torch.where(torch.isfinite(new_lse), new_lse, 0.0)
        w_old = torch.where(torch.isfinite(lse), torch.exp(lse - safe), 0.0)
        w_new = torch.where(
            torch.isfinite(lse_blk), torch.exp(lse_blk - safe), 0.0
        )
        wt = lambda w: w.transpose(1, 2)[..., None]  # noqa: E731
        return out * wt(w_old) + o_blk.float() * wt(w_new), new_lse

    k_blk, v_blk = k, v
    # Rotate axis_size - 1 times; the last block folds after the loop.
    for i in range(axis_size - 1):
        out, lse = fold(i, k_blk, v_blk, out, lse)
        k_blk, v_blk = rotate(k_blk, v_blk)
    out, _ = fold(axis_size - 1, k_blk, v_blk, out, lse)
    return out.to(q.dtype)


def ring_attention_shard(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    idx: int,
    axis_size: int,
    rotate: Optional[Rotate] = None,
) -> torch.Tensor:
    """Rank ``idx``'s ring body with the dense fold, causal. q:
    [B, Sq, Hq, Dh] local shard; k/v: [B, Skv, Hkv, Dh] local shard.
    Returns [B, Sq, Hq, Dh] in q's dtype."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = dh**-0.5
    qg = q.reshape(b, sq, hkv, g, dh).float() * scale
    q_pos = idx * sq + torch.arange(sq, device=q.device)

    m = torch.full((b, hkv, g, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dh), device=q.device)

    def fold(i, k_blk, v_blk, m, l, acc):
        # After i hops this rank holds the block that started on rank
        # (idx - i) mod axis_size.
        src = (idx - i) % axis_size
        scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_blk.float())
        k_pos = src * skv + torch.arange(skv, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        scores = scores.masked_fill(~mask, float("-inf"))
        new_m = torch.maximum(m, scores.amax(dim=-1))
        safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
        correction = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        probs = torch.exp(scores - safe_m[..., None])  # masked -> 0
        l = l * correction + probs.sum(dim=-1)
        acc = acc * correction[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", probs, v_blk.float()
        )
        return new_m, l, acc

    k_blk, v_blk = k, v
    for i in range(axis_size - 1):
        m, l, acc = fold(i, k_blk, v_blk, m, l, acc)
        k_blk, v_blk = rotate(k_blk, v_blk)
    _, l, acc = fold(axis_size - 1, k_blk, v_blk, m, l, acc)
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)
    return out.to(q.dtype)


def _receiver(
    idx: int,
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    device: torch.device,
) -> Rotate:
    """Rank ``idx``'s rotate step. In the SPMD ring every rank sends its
    block to the next at each hop, so after ``h`` hops rank ``idx`` holds
    the block that started on rank ``(idx - h) mod n``; run one after
    another, each rank receives exactly that block, moved to its device.
    What it sends is what its successor receives at the same hop."""
    n = len(ks)
    hops = 0

    def rotate(k_blk: torch.Tensor, v_blk: torch.Tensor):
        nonlocal hops
        hops += 1
        src = (idx - hops) % n
        return ks[src].to(device), vs[src].to(device)

    return rotate


def make_ring_attention(mesh: Mesh, use_flash: Optional[bool] = None):
    """Returns causal ``attn_fn(q, k, v)`` over [B, S, H, Dh]: the sequence
    split over the mesh's ``sp`` devices, the ring run across them, the
    output gathered back on q's device. Differentiable.

    ``use_flash``: fold each block with the flash kernels instead of the
    dense fold; None picks them for shards the flash gate takes (>= 256
    tokens, block-divisible). The batch is this rank's rows: dp and fsdp
    are process axes (``parallel/mesh.py``). Head sharding (the JAX ring's
    tp axis) is not ported: tp above 1 raises."""
    if mesh.shape["tp"] > 1:
        raise NotImplementedError(
            f"ring attention on a mesh with tp={mesh.shape['tp']}: head sharding "
            f"across ranks is not ported ({TP_EP_ITEM})"
        )
    devices = mesh.axis_devices("sp")
    n = len(devices)

    def attn_fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if q.shape[1] % n or k.shape[1] % n:
            raise ValueError(
                f"ring attention: seq lens {q.shape[1]}, {k.shape[1]} not "
                f"divisible by sp={n}"
            )
        sq, skv = q.shape[1] // n, k.shape[1] // n
        flash = use_flash
        if flash is None:
            flash = _flash_fold_supported(sq, skv)
        shard = lambda x: [  # noqa: E731
            c.to(d).contiguous() for c, d in zip(x.chunk(n, dim=1), devices)
        ]
        qs, ks, vs = shard(q), shard(k), shard(v)
        outs = []
        for idx in range(n):
            rotate = _receiver(idx, ks, vs, devices[idx])
            body = ring_attention_shard_flash if flash else ring_attention_shard
            outs.append(body(qs[idx], ks[idx], vs[idx], idx, n, rotate).to(q.device))
        return outs[0] if n == 1 else torch.cat(outs, dim=1)

    return attn_fn
