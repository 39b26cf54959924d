"""Kernel harness of the port: every hand-written CUDA kernel of
``torchft_tpu_torch.ops`` on the card, held against the host quantizer or
dense attention, timed, and reported as one JSON line.

The twin of the JAX package's ``torchft_tpu/ops/bench_kernels.py``: the same
sections in the same order at the same sizes (int8 quantize and dequantize,
int4, the fused int8 reduce, flash attention against dense, the long
sequence, the two-block merge against dense), and the same keys, so the two
lines can be diffed. It adds keys of its own:

- ``device``: the card's name and its power limit (from ``nvidia-smi``);
- bit counts against the host quantizer (``scale_mismatch_bits``,
  ``reduce_payload_mismatch_bytes``, ``reduce_scale_mismatch_bits``): the
  port's kernels write the host quantizer's bytes, so its limits are 0;
- ``grad_rel_err_vs_dense`` for flash attention and the block merge, whose
  backward runs the three backward kernels of each;
- ``launches``: each kernel's launch count in this run, so that a caller in
  another process sees that every kernel ran.

``ok`` holds: quantize with 0 level differences and 0 scale mismatches, a
bit-exact dequantize and the roundtrip within half a step; int4 with 0
packed-byte mismatches and a bit-exact dequantize; the reduce with 0 payload
and 0 scale mismatches and ``rel_err < 0.02``; flash and the block merge
with ``rel_err_vs_dense < 0.03`` and gradients within 0.05 of dense's (the
bf16 gradient limit of the JAX package's ``test_flash_gradients_bf16_tolerance``);
on the card, every kernel launched. Exit code 1 when ``ok`` is false.

Run:  python -m torchft_tpu_torch.ops.bench_kernels               # the card
      python -m torchft_tpu_torch.ops.bench_kernels --device cpu  # plain versions

It runs on the card by default and raises where there is none: only
``--device cpu`` takes the plain PyTorch versions, and then it says
``"compiled": false`` and its times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

# Sizes of the JAX harness; module constants so that a test can shrink them.
QUANT_N = 4 * 1024 * 1024  # values quantized, int8 and int4
REDUCE_RANKS = 4
REDUCE_N = 512 * 256  # values per rank in the fused reduce
FLASH_SHAPE = (2, 1024, 8, 64)  # B, S, H, D; bf16, causal
LONG_S = 8192  # the long-sequence point: B=1, H and D of FLASH_SHAPE
REPS = 20  # timed calls per median, after one warm-up call

# The port's limits (module docstring).
REL_ERR_LIMIT = {"reduce": 0.02, "attention": 0.03, "gradient": 0.05}


def _time_call(fn: Callable[[], object], device: torch.device) -> float:
    """Median ms of REPS calls of ``fn`` after one warm-up call: CUDA events
    around each call on the card, the host clock on the CPU."""
    fn()
    times: List[float] = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def _device_record(device: torch.device) -> dict:
    """The device's name and, on the card, its power limit as nvidia-smi
    reports it (None where nvidia-smi does not answer)."""
    if device.type == "cpu":
        return {"name": "cpu", "power_limit": None}
    power = None
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=60,
        )
        if proc.returncode == 0 and proc.stdout.strip():
            power = proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return {"name": torch.cuda.get_device_name(device), "power_limit": power}


def _mismatched_bits(a: np.ndarray, b: np.ndarray) -> int:
    """Elements whose bits differ (fp32 compared as uint32)."""
    a, b = np.ascontiguousarray(a).reshape(-1), np.ascontiguousarray(b).reshape(-1)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    return int(np.count_nonzero(a != b))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _grads(fn: Callable, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Gradients of sum(fn(*leaves)^2) in fp32, the loss of the JAX
    package's bf16 gradient test."""
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    fn(*leaves).float().square().sum().backward()
    return [t.grad.float() for t in leaves]


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def _merge(o1, l1, o2, l2) -> torch.Tensor:
    """Online-softmax merge of two blocks' (out [B,S,H,D], lse [B,H,S]),
    as the JAX harness's ``merge``: fp32 [B,S,H,D]."""
    m = torch.maximum(l1, l2)
    w1 = torch.exp(l1 - m)[..., None]
    w2 = torch.exp(l2 - m)[..., None]
    o1 = o1.transpose(1, 2).float()
    o2 = o2.transpose(1, 2).float()
    return ((o1 * w1 + o2 * w2) / (w1 + w2)).transpose(1, 2)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="cuda (the default) runs the kernels; cpu their plain versions",
    )
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bench_kernels: no CUDA device; this harness measures the card's "
            "kernels (--device cpu runs their plain versions instead)"
        )

    from torchft_tpu_torch import collectives as C
    from torchft_tpu_torch.models.llama import dense_attention
    from torchft_tpu_torch.ops import flash_attention as F
    from torchft_tpu_torch.ops import quantization as Q

    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    compiled = device.type == "cuda"
    for counts in (F.LAUNCHES, Q.LAUNCHES):
        for name in counts:
            counts[name] = 0
    record = _device_record(device)
    result: dict = {
        "backend": device.type,
        "device_kind": record["name"],
        "compiled": compiled,
        "device": record,
    }
    rng = np.random.default_rng(0)

    # ---- int8 quantize/dequantize vs the host quantizer -----------------
    # The port's kernels are exact: the same payload and scale bits as the
    # host quantizer, and a bit-exact dequantize.
    n = QUANT_N
    x_host = rng.standard_normal(n).astype(np.float32)
    x = torch.from_numpy(x_host).to(device)
    q, s, _ = Q.fused_quantize(x, 8)
    q_ref, s_ref = C.quantize_blockwise(x_host)
    q_dev = _host(q).reshape(-1)
    s_dev = _host(s)
    level_diff = np.abs(q_dev.astype(np.int32) - q_ref.astype(np.int32))
    scale_rel_err = float((np.abs(s_dev - s_ref) / (np.abs(s_ref) + 1e-30)).max())
    dd = _host(Q.fused_dequantize(q, s, n, 8))
    dh = C.dequantize_blockwise(q_dev, s_dev, n)
    per_elem_scale = np.repeat(s_dev, Q.BLOCK)[:n]
    result["quantize"] = {
        "n": n,
        "dequantize_bit_exact": _mismatched_bits(dd, dh) == 0,
        "quantize_max_level_diff_vs_host": int(level_diff.max()),
        "quantize_level_diff_count": int(np.count_nonzero(level_diff)),
        "scale_rel_err_vs_host": scale_rel_err,
        "scale_mismatch_bits": _mismatched_bits(s_dev, s_ref),
        "roundtrip_within_half_step": bool(
            (np.abs(dd - x_host) <= 0.501 * per_elem_scale + 1e-7).all()
        ),
        "quantize_ms": _time_call(lambda: Q.fused_quantize(x, 8), device),
        "dequantize_ms": _time_call(lambda: Q.fused_dequantize(q, s, n, 8), device),
    }

    # ---- int4 codec (nibble-packed wire) --------------------------------
    q4, s4, _ = Q.fused_quantize(x, 4)
    q4_ref, s4_ref = C.quantize_blockwise(x_host, bits=4)
    dd4 = Q.fused_dequantize(
        torch.from_numpy(q4_ref).to(device), torch.from_numpy(s4_ref).to(device),
        n, 4,
    )
    dh4 = C.dequantize_blockwise(q4_ref, s4_ref, n, bits=4)
    result["quantize_int4"] = {
        "payload_bytes_per_value": 0.5,
        "pack_mismatch_byte_count": _mismatched_bits(_host(q4), q4_ref),
        "scale_mismatch_bits": _mismatched_bits(_host(s4), s4_ref),
        "dequantize_bit_exact": _mismatched_bits(_host(dd4), dh4) == 0,
        "quantize_ms": _time_call(lambda: Q.fused_quantize(x, 4), device),
    }

    # ---- fused reduce vs the host's fp32 sum ----------------------------
    # The host reduces by summing each rank's dequantized payload in rank
    # order and requantizing; the kernel must write those bytes.
    ranks = REDUCE_RANKS
    xs = rng.standard_normal((ranks, REDUCE_N)).astype(np.float32)
    qs, ss = zip(*(C.quantize_blockwise(xs[r]) for r in range(ranks)))
    q3 = torch.from_numpy(np.stack([qq.reshape(-1, Q.BLOCK) for qq in qs])).to(device)
    s3 = torch.from_numpy(np.stack(ss)).to(device)
    qo, so = Q.fused_reduce_int8(q3, s3)
    qo, so = _host(qo).reshape(-1), _host(so)
    want = np.zeros(REDUCE_N, np.float32)
    for r in range(ranks):
        want += C.dequantize_blockwise(qs[r], ss[r], REDUCE_N)
    qh, sh = C.quantize_blockwise(want)
    got = C.dequantize_blockwise(qo, so, REDUCE_N)
    result["fused_reduce"] = {
        "ranks": ranks,
        "rel_err": float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9)),
        "reduce_payload_mismatch_bytes": _mismatched_bits(qo, qh),
        "reduce_scale_mismatch_bits": _mismatched_bits(so, sh),
        "reduce_ms": _time_call(lambda: Q.fused_reduce_int8(q3, s3), device),
    }

    # ---- flash attention vs dense ---------------------------------------
    B, S, H, D = FLASH_SHAPE

    def bf16(shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)
        ).to(device, torch.bfloat16)

    qkv = [bf16((B, S, H, D)) for _ in range(3)]
    flash = lambda q_, k_, v_: F.flash_attention(q_, k_, v_, causal=True)  # noqa: E731
    dense = lambda q_, k_, v_: dense_attention(q_, k_, v_, causal=True)  # noqa: E731
    with torch.no_grad():
        dense_out = dense(*qkv)
        flash_out = flash(*qkv)
    dense_grads = _grads(dense, qkv)
    flash_grads = _grads(flash, qkv)
    result["flash_attention"] = {
        "shape": [B, S, H, D],
        "rel_err_vs_dense": _rel_err(flash_out, dense_out),
        "grad_rel_err_vs_dense": max(
            _rel_err(a, b) for a, b in zip(flash_grads, dense_grads)
        ),
        "flash_ms": _time_call(lambda: flash(*qkv), device),
        "dense_ms": _time_call(lambda: dense(*qkv), device),
    }

    # The long point, where the O(S^2) work dominates. Dense materializes
    # the fp32 scores (8 * S^2 * 4 bytes, about 2 GB at S=8192); if that
    # fails, the harness fails with it.
    qkv_long = [bf16((1, LONG_S, H, D)) for _ in range(3)]
    with torch.no_grad():
        result["flash_attention_long"] = {
            "shape": [1, LONG_S, H, D],
            "flash_ms": _time_call(lambda: flash(*qkv_long), device),
            "dense_ms": _time_call(lambda: dense(*qkv_long), device),
        }
    del qkv_long

    # ---- offset-block kernel (ring attention's per-step fold) -----------
    # Causal attention assembled from two kv blocks by the online-softmax
    # merge must match dense, forward and backward (the backward sends a
    # cotangent into both blocks' lse).
    half = S // 2

    def two_blocks(q_, k_, v_):
        o1, l1 = F.flash_attention_block(
            q_, k_[:, :half].contiguous(), v_[:, :half].contiguous(), 0, 0
        )
        o2, l2 = F.flash_attention_block(
            q_, k_[:, half:].contiguous(), v_[:, half:].contiguous(), 0, half
        )
        return _merge(o1, l1, o2, l2)

    with torch.no_grad():
        block_out = two_blocks(*qkv)
    block_grads = _grads(two_blocks, qkv)
    q_, k_, v_ = qkv
    q_lo, q_hi = q_[:, :half].contiguous(), q_[:, half:].contiguous()
    k_lo, v_lo = k_[:, :half].contiguous(), v_[:, :half].contiguous()
    with torch.no_grad():
        result["flash_block_merge"] = {
            "kv_blocks": 2,
            "rel_err_vs_dense": _rel_err(block_out, dense_out),
            "grad_rel_err_vs_dense": max(
                _rel_err(a, b) for a, b in zip(block_grads, dense_grads)
            ),
            # The diagonal block (causal, a ring's first step) and a block
            # wholly in the past (no mask, every later step).
            "block_diag_ms": _time_call(
                lambda: F.flash_attention_block(q_lo, k_lo, v_lo, 0, 0), device
            ),
            "block_past_ms": _time_call(
                lambda: F.flash_attention_block(q_hi, k_lo, v_lo, half, 0), device
            ),
        }

    launches = {**F.LAUNCHES, **Q.LAUNCHES}
    result["launches"] = launches
    quant, int4, red = (
        result["quantize"], result["quantize_int4"], result["fused_reduce"]
    )
    ok = (
        quant["dequantize_bit_exact"]
        and quant["quantize_level_diff_count"] == 0
        and quant["scale_mismatch_bits"] == 0
        and quant["roundtrip_within_half_step"]
        and int4["dequantize_bit_exact"]
        and int4["pack_mismatch_byte_count"] == 0
        and int4["scale_mismatch_bits"] == 0
        and red["reduce_payload_mismatch_bytes"] == 0
        and red["reduce_scale_mismatch_bits"] == 0
        and red["rel_err"] < REL_ERR_LIMIT["reduce"]
        and all(
            result[k]["rel_err_vs_dense"] < REL_ERR_LIMIT["attention"]
            and result[k]["grad_rel_err_vs_dense"] < REL_ERR_LIMIT["gradient"]
            for k in ("flash_attention", "flash_block_merge")
        )
        and (not compiled or all(v > 0 for v in launches.values()))
    )
    result["ok"] = bool(ok)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
