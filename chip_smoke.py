"""On-card smoke of the PyTorch port (torchft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure exits non-zero and prints no result line:

1. The card's name and power limit (nvidia-smi); build every CUDA kernel of
   the training path from ``torchft_tpu_torch/ops/csrc`` with nvcc, one
   nvcc per source, all started together; then ``cuobjdump -sass`` of the
   flash library must show HGMMA (wgmma) instructions in the bf16 forward,
   dq and dk/dv bodies at every head_dim (counts and ptxas' registers and
   spills in ``sass_check.json``).
2. Flash kernels: each kernel against its plain PyTorch version on the card,
   element by element (``TOL``), at the training path's shapes
   (llama_small: B=8, S=1024, Hq=12, Hkv=4, D=64, bf16) and at further
   shapes (fp32 D=64 and D=128, non-causal, a ragged length); timed with
   CUDA events beside its plain version, the one-call PyTorch equivalent
   (``F.scaled_dot_product_attention``, a yardstick the port never calls)
   and the least time the card could take. Also the model with flash
   attention against the model with dense attention on the same weights.
3. Block flash kernels (ring attention's fold): each against its plain
   version element by element (``TOL``; out only on rows that see a key) at
   the ring path's shapes (B=8, Sq=Skv=1024, llama_small's heads, bf16) and
   offsets (0,0), (1024,0), (1024,512), (0,1024) (all masked: out 0, lse
   <= -1e29, zero gradients), one fp32 case and one ragged case; timed at
   (0,0) and (1024,0). Then ``make_ring_attention`` at sp=4 on a mesh that
   repeats the card (B=2, S=4096): out, dq, dk, dv against the plain
   full-sequence versions within the ring limit derived beside
   ``RING_SLACK``, 16 launches of each block kernel.
4. Quantize kernels: the quantize and dequantize kernels, int8 and int4,
   against their plain versions on the card AND against the host quantizer
   that defines the wire (``collectives.quantize_blockwise`` /
   ``dequantize_blockwise``), bit for bit: 0 differing payload bytes, scale
   bits and dequantized bits, at the quantized path's bucket sizes (the
   chunked embedding and lm_head buckets included) and on special values.
   Timed at a 32 MiB bucket beside the plain versions and their bound.
5. Fused reduce kernel and the kernel harness: the int8 reduce against its
   plain version on the card AND against the host's reduce (each rank's
   payload dequantized and summed in rank order, divided by R if averaging,
   requantized by ``collectives.quantize_blockwise``), bit for bit, for
   R = 2, 3, 4 with and without averaging, on 1, 5 and 4096 rows and on
   special rows; timed at a 32 MiB bucket with R = 2 and R = 4 beside its
   plain version and its bound. Then ``python -m
   torchft_tpu_torch.ops.bench_kernels`` in a process of its own: exit 0,
   ``ok`` true and every kernel of ``ops`` launched in it (the harness is
   the one path that runs the reduce: the training path reduces on the
   host).
6. Path: the C++ lighthouse and two replica groups of
   ``python -m torchft_tpu_torch.train_hsdp --model small --attn flash
   --batch 8 --seq 1024 --steps 8`` on the card; group 1 is SIGKILLed after
   step 3 and restarted, heals from group 0, and both must end at step 8
   with bitwise-equal parameters, finite losses, and every flash kernel
   launched in both groups.
7. Quantized path: the same drill with ``--quantize`` (int8); both
   quantize kernels must launch in both groups too, and the final
   parameters must differ from the unquantized drill's.
8. Ring path: the same drill with ``--attn ring`` (sp=1 on one card: one
   block per layer); the three block kernels must launch in both groups,
   the whole-sequence flash kernels never, and it must end in the flash drill's
   parameters (at sp=1 the block kernels compute the whole-sequence
   kernels' bits: one body serves both).
9. The ``{"kernels": [...]}`` line, the card line, and the last line:
   ``{"ok": true, "device": {...}}``.

Logs and details go to ``chiprun_out/chip_smoke/``. Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / "chiprun_out" / "chip_smoke"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor
# cores, fp32 outside the tensor cores, HBM bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 1: build
# ---------------------------------------------------------------------------

SOURCES = ("flash_attention.cu", "quantization.cu")


def build_kernels() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from torchft_tpu_torch.ops import _cuda_build

    def build(source: str) -> float:
        t0 = time.monotonic()
        _cuda_build.build(source)
        return time.monotonic() - t0

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        seconds = list(pool.map(build, SOURCES))
    for source, secs in zip(SOURCES, seconds):
        ptxas = _cuda_build.BUILD_DIR / f"{Path(source).stem}.ptxas.txt"
        if ptxas.exists():
            (OUT / ptxas.name).write_text(ptxas.read_text())
        print(f"build: {source} {secs:.1f}s", flush=True)


# The bf16 bodies that must run on the tensor cores, built at every head_dim.
TENSOR_CORE_KERNELS = (
    "flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
    "flash_bwd_dkv_wgmma_kernel",
)
HEAD_DIMS = (16, 32, 64, 128)


def ptxas_report(text: str) -> dict:
    """{mangled name: {registers, stack, spill_stores, spill_loads}} from
    ``nvcc -Xptxas -v`` output, and ptxas' warnings and performance notices
    (a wgmma it had to serialize)."""
    import re

    report, warnings, name = {}, [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            report[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            report[name].update(stack=int(m[1]), spill_stores=int(m[2]),
                                spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m[1])
        if "warning" in line.lower() or "Performance Loss" in line:
            warnings.append(line.strip())
    return {"functions": report, "warnings": warnings}


def sass_check() -> dict:
    """``cuobjdump -sass`` of the built flash library: raises unless the
    bf16 forward, dq and dk/dv bodies hold HGMMA (wgmma) instructions at
    every head_dim. Writes each kernel instantiation's HGMMA and HMMA
    counts with ptxas' registers, stack and spill bytes to
    ``sass_check.json`` and prints them."""
    import re

    from torchft_tpu_torch.ops import _cuda_build

    lib = _cuda_build.library_path("flash_attention.cu")
    cuobjdump = Path(_cuda_build._nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"cuobjdump -sass failed: {proc.stderr[-2000:]}")
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name and "HGMMA" in line:
            counts[name]["HGMMA"] += 1
        elif name and "HMMA" in line:
            counts[name]["HMMA"] += 1
    ptxas = ptxas_report(
        (_cuda_build.BUILD_DIR / "flash_attention.ptxas.txt").read_text()
    )
    table = {}
    for mangled, c in counts.items():
        m = re.search(r"(flash_[a-z_]+_kernel)ILi(\d+)EE", mangled)
        if not m:
            continue
        # The tensor-core bodies take bf16 only, the FMA bodies fp32 only.
        dtype = "bf16" if "_wgmma_" in m[1] else "fp32"
        key = f"{m[1]}<{dtype}, D={m[2]}>"
        table[key] = {**c, **ptxas["functions"].get(mangled, {})}
    missing = [
        f"{k}<bf16, D={d}>" for k in TENSOR_CORE_KERNELS for d in HEAD_DIMS
        if table.get(f"{k}<bf16, D={d}>", {}).get("HGMMA", 0) <= 0
    ]
    result = {"kernels": table, "ptxas_warnings": ptxas["warnings"]}
    (OUT / "sass_check.json").write_text(json.dumps(result, indent=1))
    for key, rec in sorted(table.items()):
        print(f"sass: {key}: " + ", ".join(f"{k} {v}" for k, v in rec.items()),
              flush=True)
    for w in ptxas["warnings"]:
        print(f"ptxas: {w}", flush=True)
    if missing:
        raise AssertionError(f"no HGMMA in the SASS of {missing}")
    return result


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def causal_pairs(S: int, causal: bool) -> int:
    return S * (S + 1) // 2 if causal else S * S


def bounds(B, S, Hq, Hkv, D, dtype_name, causal, Skv=None, pairs=None,
           names=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), rows_in=2):
    """Least time (ms) and its binding resource per kernel: the larger of
    the operations this call needs over the peak rate for its dtype and
    the bytes it must move (each input read once, each output written
    once) over the HBM rate. Matrix-product flops per (q row, kv column)
    pair the mask keeps: forward QK^T + PV = 4D; dq: QK^T, dO.V^T,
    dS.K = 6D; dk/dv: QK^T, dO.V^T, P^T.dO, dS^T.Q = 8D. ``pairs``: the
    visible pairs per (batch, head) where the mask is not causal at zero
    offsets; ``rows_in``: the fp32 rows the backward reads (lse and delta;
    3 with dlse); ``names``: the forward, dq and dk/dv kernels' names."""
    e = 2 if dtype_name == "bfloat16" else 4
    Skv = S if Skv is None else Skv
    pairs = B * Hq * (causal_pairs(S, causal) if pairs is None else pairs)
    q_bytes = B * S * Hq * D * e
    kv_bytes = B * Skv * Hkv * D * e
    row_bytes = B * Hq * S * 4
    fwd, dq, dkv = names
    work = {
        fwd: (4 * D * pairs, q_bytes + 2 * kv_bytes + q_bytes + row_bytes),
        dq: (
            6 * D * pairs,
            2 * q_bytes + 2 * kv_bytes + rows_in * row_bytes + q_bytes,
        ),
        dkv: (
            8 * D * pairs,
            2 * q_bytes + 2 * kv_bytes + rows_in * row_bytes + 2 * kv_bytes,
        ),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        out[name] = (
            max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        )
    return out


# Element-wise limit: |kernel - plain| <= tol * (|plain| + T) + 1e-5 *
# rms(plain), T the element's sum of |product terms|
# (flash_attention_term_sums; 1 for lse, a log). In bf16 the two sides
# round P or dS at different points (the kernel the online softmax's
# unnormalised P) and each rounds its output once, each rounding off by up
# to 2^-8 of its value, so they may differ by 2^-7 * (|plain| + T): tol is
# 1.28 * 2^-7. Where terms cancel, T is far larger than the element. fp32
# outputs and every lse (fp32 on both sides) differ by summation order and
# __expf only. The rms floor covers elements whose plain value and T are
# exactly 0 (dS = 0 in row 0).
TOL = {"bfloat16": 1e-2, "float32": 1e-5}
RMS_FLOOR = 1e-5


def compare(a, b, terms, tol: float) -> dict:
    """max abs error, rms of the plain output, and the worst share of its
    allowed error any element uses (> 1 fails)."""
    import torch

    a, b = a.float(), b.float()
    if not torch.isfinite(a).all():
        raise AssertionError("kernel output not finite")
    diff = (a - b).abs()
    rms = float(b.square().mean().sqrt())
    allowed = tol * (b.abs() + terms) + RMS_FLOOR * rms
    # An exact match is share 0, also where everything is 0 (all masked).
    share = torch.where(diff == 0, 0.0, diff / allowed)
    return {
        "max_abs_err": float(diff.max()),
        "ref_rms": rms,
        "share": float(share.max()),
    }


def check_case(B, S, Hq, Hkv, D, dtype, causal, timed: bool, seed: int):
    """Runs the three kernels and their plain versions on one input set;
    returns {kernel: record}. Raises where any element of any output lies
    outside its limit (``TOL``; lse always at the fp32 one)."""
    import torch
    import torch.nn.functional as F

    from torchft_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(  # noqa: E731
        *shape, generator=g, device=dev, dtype=torch.float32
    ).to(dtype)
    q, k, v = mk(B, S, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)
    dout = mk(B, S, Hq, D)

    out, lse = fa.flash_fwd(q, k, v, causal)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, dout, lse, delta, causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, dout, lse, delta, causal)
    torch.cuda.synchronize()
    out_r, lse_r = fa.flash_attention_fwd_reference(q, k, v, causal)
    dq_r = fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal)
    dk_r, dv_r = fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal)

    terms = fa.flash_attention_term_sums(q, k, v, dout, lse, delta, causal)
    dtype_name = str(dtype)[6:]
    tol, tol32 = TOL[dtype_name], TOL["float32"]
    outputs = {
        "flash_fwd": {
            "out": (out, out_r, terms["out"], tol),
            "lse": (lse, lse_r, 1.0, tol32),
        },
        "flash_bwd_dq": {"dq": (dq, dq_r, terms["dq"], tol)},
        "flash_bwd_dkv": {
            "dk": (dk, dk_r, terms["dk"], tol),
            "dv": (dv, dv_r, terms["dv"], tol),
        },
    }
    case = f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} {dtype_name} causal={causal}"
    records = {}
    readings = []
    for name, outs in outputs.items():
        got = {o: compare(*args) for o, args in outs.items()}
        for o, r in got.items():
            readings.append(
                f"{o} err {r['max_abs_err']:.3g} rms {r['ref_rms']:.3g} "
                f"share {r['share']:.3g}"
            )
            if not r["share"] <= 1.0:
                raise AssertionError(
                    f"{name} disagrees with its plain version at {case}: "
                    f"{o} |kernel - plain| reaches {r['share']:.3g}x of "
                    f"{outs[o][3]} * (|plain| + T) + {RMS_FLOOR} * rms(plain) "
                    f"(max abs err {r['max_abs_err']}, rms {r['ref_rms']})"
                )
        records[name] = {
            "max_abs_err": max(r["max_abs_err"] for r in got.values()),
            "tol_share": max(r["share"] for r in got.values()),
        }
    print(f"kernels ok at {case}: " + ", ".join(readings), flush=True)
    if not timed:
        return records

    iters = 20
    plain_iters = 3
    records["flash_fwd"]["ms"] = time_ms(lambda: fa.flash_fwd(q, k, v, causal), iters)
    records["flash_bwd_dq"]["ms"] = time_ms(
        lambda: fa.flash_bwd_dq(q, k, v, dout, lse, delta, causal), iters
    )
    records["flash_bwd_dkv"]["ms"] = time_ms(
        lambda: fa.flash_bwd_dkv(q, k, v, dout, lse, delta, causal), iters
    )
    records["flash_fwd"]["plain_ms"] = time_ms(
        lambda: fa.flash_attention_fwd_reference(q, k, v, causal), plain_iters, 1
    )
    records["flash_bwd_dq"]["plain_ms"] = time_ms(
        lambda: fa.flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal),
        plain_iters, 1,
    )
    records["flash_bwd_dkv"]["plain_ms"] = time_ms(
        lambda: fa.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal),
        plain_iters, 1,
    )
    # Yardstick only: PyTorch's fused attention on the same inputs
    # ([B,H,S,D] copies made outside the timing). Forward for the forward
    # kernel; its backward (dq, dk and dv in one call) for both backward
    # kernels.
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(  # noqa: E731
        a, b, c, is_causal=causal, enable_gqa=True
    )
    records["flash_fwd"]["library_ms"] = time_ms(lambda: sdpa(qt, kt, vt), iters)
    records["flash_fwd"]["library_call"] = "F.scaled_dot_product_attention forward"
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    o = sdpa(qg, kg, vg)
    bwd_ms = time_ms(
        lambda: torch.autograd.grad(o, (qg, kg, vg), dot, retain_graph=True),
        iters,
    )
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        records[name]["library_ms"] = bwd_ms
        records[name]["library_call"] = (
            "F.scaled_dot_product_attention backward (dq, dk, dv together)"
        )
    for name, (b_ms, b_by) in bounds(
        B, S, Hq, Hkv, D, str(dtype)[6:], causal
    ).items():
        records[name]["bound_ms"] = b_ms
        records[name]["bound_by"] = b_by
    return records


def model_check() -> None:
    """The model with flash attention against the same weights with dense
    attention, on the card, at llama_small's widths cut to 2 layers."""
    import dataclasses

    import torch

    from torchft_tpu_torch.models import Transformer, llama_small

    dev = torch.device("cuda")
    cfg = llama_small(num_layers=2, remat=False)
    torch.manual_seed(0)
    dense = Transformer(cfg).to(dev)
    flash = Transformer(
        dataclasses.replace(cfg, attn_impl="flash", flash_min_seq=1024)
    ).to(dev)
    flash.load_state_dict(dense.state_dict())
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g, device=dev)
    with torch.no_grad():
        a, b = dense(tokens), flash(tokens)
    if a.shape != (2, 1024, cfg.vocab_size) or not torch.isfinite(b).all():
        raise AssertionError(f"flash model logits bad: {b.shape}")
    err = float((a - b).abs().max())
    scale = float(a.abs().max())
    # bf16 activations: the two attention paths round at different places.
    if not err <= 5e-2 * scale:
        raise AssertionError(
            f"flash model logits differ from dense: {err} vs max {scale}"
        )
    print(f"model ok: flash vs dense logits max abs err {err:.3g} "
          f"(max |logit| {scale:.3g})", flush=True)


def kernel_phase() -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, fp32 = torch.bfloat16, torch.float32
    # The training path's shape, timed.
    main = check_case(8, 1024, 12, 4, 64, bf16, True, timed=True, seed=0)
    # Further shapes: the path's head_dim in fp32, fp32 at D=128,
    # non-causal, a ragged length, D=16/32.
    check_case(2, 1024, 12, 4, 64, fp32, True, timed=False, seed=5)
    check_case(2, 1024, 8, 2, 128, fp32, True, timed=False, seed=1)
    check_case(2, 512, 4, 4, 64, bf16, False, timed=False, seed=2)
    check_case(1, 200, 4, 2, 32, fp32, True, timed=False, seed=3)
    check_case(2, 128, 4, 2, 16, bf16, True, timed=False, seed=4)
    model_check()
    return main


# ---------------------------------------------------------------------------
# Phase 3: the block kernels and the ring
# ---------------------------------------------------------------------------

BLOCK_KERNELS = ("flash_block_fwd", "flash_block_bwd_dq", "flash_block_bwd_dkv")
BLOCK_OFFSETS = ((0, 0), (1024, 0), (1024, 512), (0, 1024))


def check_block_case(B, Sq, Skv, Hq, Hkv, D, dtype, q_off, k_off, timed: bool,
                     seed: int, device: str = "cuda"):
    """The three block kernels against their plain versions on one input
    set, with a random lse cotangent; returns {kernel: record}. Every
    element of dq, dk, dv and lse is held to ``TOL``; out on the rows that
    see at least one key (a row that sees none is out 0 and lse <= -1e29;
    where no row sees a key, every gradient is 0)."""
    import torch
    import torch.nn.functional as F

    from torchft_tpu_torch.ops import flash_attention as fa

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(  # noqa: E731
        *shape, generator=g, device=dev, dtype=torch.float32
    ).to(dtype)
    q, k, v = mk(B, Sq, Hq, D), mk(B, Skv, Hkv, D), mk(B, Skv, Hkv, D)
    dout = mk(B, Sq, Hq, D)
    dlse = torch.randn(B, Hq, Sq, generator=g, device=dev)
    offs = (q_off, k_off)

    out, lse = fa.flash_block_fwd(q, k, v, *offs)
    delta = fa._delta(dout, out)
    args = (q, k, v, dout, lse, delta, dlse, *offs)
    dq = fa.flash_block_bwd_dq(*args)
    dk, dv = fa.flash_block_bwd_dkv(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out_r, lse_r = fa.flash_block_fwd_reference(q, k, v, *offs)
    dq_r = fa.flash_block_bwd_dq_reference(*args)
    dk_r, dv_r = fa.flash_block_bwd_dkv_reference(*args)
    terms = fa.flash_attention_term_sums(
        q, k, v, dout, lse, delta, True, q_off, k_off, dlse
    )
    # Rows that see at least one key see key 0.
    seen = torch.arange(Sq, device=dev) + q_off >= k_off
    case = (f"B={B} Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} D={D} "
            f"{str(dtype)[6:]} offsets {offs}")
    blind = ~seen
    if blind.any():
        if out[:, blind].abs().max() != 0 or not (
            torch.isfinite(lse[..., blind]).all()
            and (lse[..., blind] <= -1e29).all()
        ):
            raise AssertionError(f"rows that see no key are not out 0, lse <= -1e29 at {case}")
    if not seen.any() and any(x.abs().max() != 0 for x in (dq, dk, dv)):
        raise AssertionError(f"gradients not 0 where every key is masked at {case}")
    tol, tol32 = TOL[str(dtype)[6:]], TOL["float32"]
    outputs = {
        "flash_block_fwd": {
            "out": (out[:, seen], out_r[:, seen], terms["out"][:, seen], tol),
            "lse": (lse, lse_r, 1.0, tol32),
        },
        "flash_block_bwd_dq": {"dq": (dq, dq_r, terms["dq"], tol)},
        "flash_block_bwd_dkv": {
            "dk": (dk, dk_r, terms["dk"], tol),
            "dv": (dv, dv_r, terms["dv"], tol),
        },
    }
    records, readings = {}, []
    for name, outs in outputs.items():
        got = {o: compare(*a) for o, a in outs.items() if a[0].numel()}
        for o, r in got.items():
            readings.append(f"{o} err {r['max_abs_err']:.3g} share {r['share']:.3g}")
            if not r["share"] <= 1.0:
                raise AssertionError(
                    f"{name} disagrees with its plain version at {case}: {o} "
                    f"reaches {r['share']:.3g}x of its limit (max abs err "
                    f"{r['max_abs_err']}, rms {r['ref_rms']})"
                )
        records[name] = {
            "max_abs_err": max(r["max_abs_err"] for r in got.values()),
            "tol_share": max(r["share"] for r in got.values()),
        }
    print(f"block kernels ok at {case}: " + ", ".join(readings), flush=True)
    if not timed:
        return records

    iters, plain_iters = 20, 3
    for name, kernel, plain in (
        ("flash_block_fwd", lambda: fa.flash_block_fwd(q, k, v, *offs),
         lambda: fa.flash_block_fwd_reference(q, k, v, *offs)),
        ("flash_block_bwd_dq", lambda: fa.flash_block_bwd_dq(*args),
         lambda: fa.flash_block_bwd_dq_reference(*args)),
        ("flash_block_bwd_dkv", lambda: fa.flash_block_bwd_dkv(*args),
         lambda: fa.flash_block_bwd_dkv_reference(*args)),
    ):
        records[name]["ms"] = time_ms(kernel, iters)
        records[name]["plain_ms"] = time_ms(plain, plain_iters, 1)
    # Yardstick for out only: SDPA has no lse cotangent, so no backward
    # call computes the block kernels' gradients. At (0,0) the block is
    # causal, at (1024,0) every key is visible.
    causal = q_off < k_off + Skv - 1
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    records["flash_block_fwd"]["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True
        ), iters,
    )
    records["flash_block_fwd"]["library_call"] = (
        f"F.scaled_dot_product_attention forward, is_causal={causal}"
    )
    for name in BLOCK_KERNELS[1:]:
        records[name]["library_ms"] = None
        records[name]["library_call"] = (
            "none: no PyTorch call takes the lse cotangent"
        )
    visible = int(fa._keep(q, k, True, q_off, k_off).sum())
    for name, (b_ms, b_by) in bounds(
        B, Sq, Hq, Hkv, D, str(dtype)[6:], True, Skv=Skv, pairs=visible,
        names=BLOCK_KERNELS, rows_in=3,
    ).items():
        records[name]["bound_ms"] = b_ms
        records[name]["bound_by"] = b_by
    print(f"timing block kernels at offsets {offs}: " + ", ".join(
        f"{n} {r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, bound "
        f"{r['bound_ms']:.4f} {r['bound_by']})" for n, r in records.items()
    ) + f", SDPA fwd {records['flash_block_fwd']['library_ms']:.4f} ms", flush=True)
    return records


# Ring limit, |ring - plain| <= 1.28 * 2^-8 * (c_T * T + c_x * |plain|)
# + 1e-5 * rms(plain), element by element, against the full-sequence plain
# version in bf16. Beside the roundings that both sides make (P or dS and
# the output, each up to 2^-8 of its terms, as in ``TOL``), the ring rounds
# once more per block: each block's out is rounded to bf16 before the fp32
# merge (2^-8 of sum_b w_b |o_b| <= T), and in the backward the cotangent
# that reaches each block's out is rounded to bf16 (2^-8 of each dO term),
# and each shard's sp block gradients are summed in bf16 (sp - 1 roundings
# of up to 2^-8 of sum_b |grad_b| <= T). So out: c_T = 3, c_x = 2; dq, dk,
# dv: c_T = sp + 3, c_x = 1, with T for dq and dk taken over the terms of dS
# itself (``ring_term_sums``): the rounded cotangent enters dS through dP,
# delta and dlse before they cancel. 1.28 is ``TOL``'s slack.
RING_SLACK = 1.28


def ring_term_sums(q, k, v, dout, lse, delta, sp: int) -> dict:
    """``flash_attention_term_sums`` of the full sequence, with dq's and
    dk's |dS| replaced by P * (A + Abar): A = |dO|.|V|^T, the terms of dP,
    and Abar the P-weighted mean of A over the keys of each ring block,
    which bounds the terms of that block's delta and dlse."""
    import math

    import torch

    from torchft_tpu_torch.ops import flash_attention as fa

    Hq, Hkv = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    terms = fa.flash_attention_term_sums(q, k, v, dout, lse, delta)
    qf, kf = fa._heads_first(q), fa._heads_first(k, Hq // Hkv)
    vf, dof = fa._heads_first(v, Hq // Hkv), fa._heads_first(dout)
    keep = fa._keep(q, k, True)
    p = fa._probs(fa._scores(qf, kf, keep, scale), lse, keep)
    a = torch.matmul(dof.abs(), vf.abs().transpose(-1, -2))
    n = k.shape[1] // sp
    for b in range(sp):
        blk = slice(b * n, (b + 1) * n)
        pb = p[..., blk]
        mean = (pb * a[..., blk]).sum(-1, keepdim=True) / pb.sum(
            -1, keepdim=True
        ).clamp_min(1e-30)
        a[..., blk] += mean
    e = p * a
    terms["dq"] = (torch.matmul(e, kf.abs()) * scale).permute(0, 2, 1, 3)
    terms["dk"] = fa._kv_heads(
        torch.matmul(e.transpose(-1, -2), qf.abs()) * scale, Hkv
    )
    return terms


def check_ring(B, S, Hq, Hkv, D, sp, device, seed):
    """``make_ring_attention`` on a mesh that repeats ``device`` sp times,
    bf16, out and the gradients of <out, dO> against the plain
    full-sequence versions; returns the block kernels' launches in the
    ring's forward and backward and each output's reading against the ring
    limit."""
    import torch

    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.parallel import make_mesh, make_ring_attention

    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(  # noqa: E731
        *shape, generator=g, device=dev
    ).to(torch.bfloat16)
    q, k, v, dout = mk(B, S, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D), mk(B, S, Hq, D)
    ring = make_ring_attention(make_mesh(sp=sp, devices=[dev] * sp))
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    for name in fa.LAUNCHES:
        fa.LAUNCHES[name] = 0
    out = ring(qg, kg, vg)
    out.backward(dout)
    launches = dict(fa.LAUNCHES)
    out_r, lse_r = fa.flash_attention_fwd_reference(q, k, v)
    delta_r = fa._delta(dout, out_r)
    ref = (out_r, *fa.flash_attention_bwd_reference(q, k, v, dout, lse_r, delta_r))
    terms = ring_term_sums(q, k, v, dout, lse_r, delta_r, sp)
    outputs = {}
    for name, got, plain in zip(("out", "dq", "dk", "dv"),
                                (out.detach(), qg.grad, kg.grad, vg.grad), ref):
        c_t, c_x = (3, 2) if name == "out" else (sp + 3, 1)
        # compare()'s limit is tol * (|plain| + T'): tol carries c_x.
        outputs[name] = compare(
            got, plain, c_t * terms[name] / c_x, RING_SLACK * 2.0**-8 * c_x
        )
    return {"launches": launches, "outputs": outputs}


def block_phase() -> dict:
    import torch

    bf16, fp32 = torch.bfloat16, torch.float32
    main = {}
    for i, offs in enumerate(BLOCK_OFFSETS):
        rec = check_block_case(8, 1024, 1024, 12, 4, 64, bf16, *offs,
                               timed=offs in ((0, 0), (1024, 0)), seed=10 + i)
        if offs == (0, 0):
            main = rec
        elif offs == (1024, 0):
            (OUT / "block_timing_1024_0.json").write_text(json.dumps(rec, indent=1))
    check_block_case(2, 1024, 1024, 12, 4, 64, fp32, 1024, 512, timed=False, seed=20)
    check_block_case(1, 200, 328, 4, 2, 32, fp32, 300, 100, timed=False, seed=21)

    sp = 4
    ring = check_ring(2, 4096, 12, 4, 64, sp, "cuda", seed=22)
    for name in BLOCK_KERNELS:
        if ring["launches"][name] != sp * sp:
            raise AssertionError(
                f"ring: {name} launched {ring['launches'][name]} times, "
                f"want {sp * sp}: {ring['launches']}"
            )
    for name, r in ring["outputs"].items():
        if not r["share"] <= 1.0:
            raise AssertionError(
                f"ring sp={sp} {name} reaches {r['share']:.3g}x of the ring "
                f"limit (max abs err {r['max_abs_err']}, rms {r['ref_rms']})"
            )
    print(f"ring ok: sp={sp} B=2 S=4096 bf16, launches "
          f"{ {n: ring['launches'][n] for n in BLOCK_KERNELS} }, " + ", ".join(
              f"{n} err {r['max_abs_err']:.3g} share {r['share']:.3g}"
              for n, r in ring["outputs"].items()
          ), flush=True)
    return main


# ---------------------------------------------------------------------------
# Phase 4: the quantize kernels against their plain versions and the wire
# ---------------------------------------------------------------------------

QMAX = {8: 127.0, 4: 7.0}
# The quantized path's bucket sizes on llama_small: embed.weight and
# lm_head.weight each fill a bucket alone (24,576,000 values: one 16M-value
# transfer chunk and a 7,798,784-value tail), a layer bucket, and a whole
# 32 MiB bucket plus a ragged tail.
QUANT_SIZES = {
    "embed/lm_head bucket, chunked": 24_576_000,
    "layer bucket": 7_867_392,
    "32 MiB + 333": 8_388_608 + 333,
}
TIMED_N = 8_388_608  # one 32 MiB fp32 bucket


def seeded_values(n: int, seed: int):
    """Normal values whose per-512-block magnitude spans 1e-8 to 1e3."""
    import numpy as np

    rng = np.random.default_rng(seed)
    blocks = -(-n // 512)
    mags = np.repeat(10.0 ** rng.uniform(-8, 3, size=blocks), 512)[:n]
    return (rng.standard_normal(n, dtype=np.float32) * mags).astype(np.float32)


def special_values(bits: int):
    """One block per case: zeros, exact half-steps (scale 2^-3), +-0,
    subnormals, an absmax whose scale underflows, the +-qmax edges, a block
    holding a NaN and one holding +-inf."""
    import numpy as np

    qmax = QMAX[bits]
    rng = np.random.default_rng(bits)
    half = (np.arange(512) % (2 * qmax) - qmax + 0.5) * 0.125
    half[0] = qmax * 0.125
    signed_zero = np.zeros(512)
    signed_zero[1::2] = -0.0
    edges = rng.uniform(-1.0, 1.0, 512) * 3.0
    edges[:4] = [3.0, -3.0, 3.0 * (1 - 2**-24), -3.0 * (1 - 2**-24)]
    nan = rng.standard_normal(512)
    nan[7] = np.nan
    inf = rng.standard_normal(512)
    inf[3], inf[9] = np.inf, -np.inf
    return np.concatenate([
        np.zeros(512), half, signed_zero, rng.standard_normal(512) * 1e-39,
        np.full(512, 1e-45), edges, nan, inf,
    ]).astype(np.float32)


def mismatches(a, b) -> int:
    """Elements whose bits differ; any NaN equals any NaN (a NaN's payload
    bits are the platform's: the card writes the canonical NaN)."""
    import numpy as np

    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    if a.dtype.kind != "f":
        return int(np.count_nonzero(a != b))
    differ = a.view(np.uint32) != b.view(np.uint32)
    return int(np.count_nonzero(differ & ~(np.isnan(a) & np.isnan(b))))


def quantize_case(name: str, x_host, bits: int) -> float:
    """The kernels on ``x_host`` through the transfer functions the path
    calls, against their plain versions on the card and the host quantizer;
    raises unless every count is 0. Returns the largest |kernel - plain|
    over payload levels, finite scales and finite dequantized values."""
    import warnings

    import numpy as np
    import torch

    from torchft_tpu_torch import collectives as C
    from torchft_tpu_torch.ops import quantization as Q

    dev = torch.device("cuda")
    n = x_host.size
    blocks = -(-n // 512)
    x = torch.from_numpy(x_host).to(dev)
    q_k, s_k, n_k = Q.quantize_for_transfer(x, bits)
    padded = torch.zeros(blocks * 512, device=dev)
    padded[:n] = x
    q_p, s_p = Q.quantize_rows_reference(padded.view(blocks, 512), QMAX[bits])
    q_p_levels = q_p.cpu().numpy().reshape(-1)
    if bits == 4:
        q_p = Q._pack_nibbles(q_p)
    q_p, s_p = q_p.cpu().numpy().reshape(-1), s_p.cpu().numpy()
    with warnings.catch_warnings():  # numpy warns on non-finite blocks
        warnings.simplefilter("ignore", RuntimeWarning)
        q_h, s_h = C.quantize_blockwise(x_host, bits)
        d_h = C.dequantize_blockwise(q_h, s_h, n, bits)
    d_k = Q.dequantize_from_transfer(q_h, s_h, n, bits, dev)
    q_h_dev = torch.from_numpy(q_h).to(dev)
    if bits == 4:
        q_h_dev = Q._unpack_nibbles(q_h_dev.view(-1, 256))
    d_p = Q.dequantize_rows_reference(
        q_h_dev.view(-1, 512), torch.from_numpy(s_h).to(dev)
    ).view(-1)[:n]
    torch.cuda.synchronize()
    d_k, d_p = d_k.cpu().numpy(), d_p.cpu().numpy()
    counts = {
        "payload vs plain": mismatches(q_k, q_p),
        "scales vs plain": mismatches(s_k, s_p),
        "payload vs numpy": mismatches(q_k, q_h),
        "scales vs numpy": mismatches(s_k, s_h),
        "dequantized vs plain": mismatches(d_k, d_p),
        "dequantized vs numpy": mismatches(d_k, d_h),
    }
    if n_k != n:
        raise AssertionError(f"{name}: pulled n {n_k} != {n}")
    q_k_levels = q_k if bits == 8 else C.unpack_nibbles(q_k, blocks * 512)
    finite = np.isfinite(s_p)
    err = max(
        float(np.abs(q_k_levels.astype(np.int32) - q_p_levels).max(initial=0)),
        float(np.abs(s_k[finite] - s_p[finite]).max(initial=0.0)),
        float(np.abs(d_k - d_p)[np.isfinite(d_p)].max(initial=0.0)),
    )
    print(f"quantize ok: {name} int{bits} n={n}: "
          + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    if any(counts.values()):
        raise AssertionError(f"{name} int{bits} n={n}: mismatches {counts}")
    return err


def time_cold(fn, inputs, iters: int) -> tuple:
    """(device ms, host ms) per call of fn(inputs[i % len(inputs)]): CUDA
    events around the calls, and the host's clock around issuing them. The
    fp32 inputs together exceed the 50 MB L2, so each call reads its input
    from HBM, as the path does a bucket the backward wrote earlier. Where
    the host ms reaches the device ms, the device waited for the host and
    the device ms measures the issue rate, not the kernel."""
    import torch

    for a in inputs:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def quantize_timing() -> dict:
    """Each kernel at one 32 MiB bucket (int8): launched straight through
    its C entry point on preallocated buffers (``ms``; the issue costs the
    host a few microseconds), and through its wrapper as the path calls it
    (``wrapper_ms``: output allocation, checks and the launch; int4 adds
    the torch nibble packing). Beside them the plain version and, for
    dequantize, the one PyTorch call that computes the same function."""
    import torch

    from torchft_tpu_torch.ops import quantization as Q

    dev = torch.device("cuda")
    n = TIMED_N
    blocks = n // 512
    xs = [(torch.from_numpy(seeded_values(n, 20 + i)).to(dev),) for i in range(4)]
    qs = [Q.fused_quantize(x, 8)[:2] for (x,) in xs]
    q4s = [Q.fused_quantize(x, 4)[:2] for (x,) in xs]
    lib = Q._library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    q_out = torch.empty((blocks, 512), dtype=torch.int8, device=dev)
    s_out = torch.empty(blocks, device=dev)
    d_out = torch.empty(n, device=dev)
    raw_q = [(x.data_ptr(), n, q_out.data_ptr(), s_out.data_ptr(), 127.0, stream)
             for (x,) in xs]
    raw_d = [(q.data_ptr(), s.data_ptr(), n, d_out.data_ptr(), stream)
             for q, s in qs]
    rcs = []
    iters, plain_iters = 50, 10
    quantize, dequantize = {}, {}
    for rec, key, fn, args, it in (
        (quantize, "ms", lambda *a: rcs.append(lib.tft_quantize_rows(*a)),
         raw_q, iters),
        (quantize, "wrapper_ms", lambda x: Q._quantize_rows(x, 127.0), xs, iters),
        (quantize, "int4_wrapper_ms", lambda x: Q.fused_quantize(x, 4), xs, iters),
        (quantize, "plain_ms",
         lambda x: Q.quantize_rows_reference(x.view(blocks, 512), 127.0),
         xs, plain_iters),
        (dequantize, "ms", lambda *a: rcs.append(lib.tft_dequantize_rows(*a)),
         raw_d, iters),
        (dequantize, "wrapper_ms",
         lambda q, s: Q.fused_dequantize(q, s, n, 8), qs, iters),
        (dequantize, "int4_wrapper_ms",
         lambda q, s: Q.fused_dequantize(q, s, n, 4), q4s, iters),
        (dequantize, "plain_ms", Q.dequantize_rows_reference, qs, plain_iters),
        (dequantize, "library_ms", lambda q, s: torch.mul(q, s[:, None]), qs, iters),
    ):
        rec[key], rec[key.replace("ms", "host_ms")] = time_cold(fn, args, it)
    if any(rcs):
        raise AssertionError(f"a timed launch failed: CUDA errors {set(rcs)}")
    quantize["library_ms"] = None
    quantize["library_call"] = "none: no single PyTorch call computes it"
    dequantize["library_call"] = "torch.mul(q.view(-1, 512), scales[:, None])"
    # Bytes each must move (inputs read once, outputs written once) over
    # HBM, against its fp32 operations (quantize: |x|, max, divide, rint, two
    # compares per value; dequantize: one multiply) over the fp32 rate.
    moved = 4 * n + n + 4 * blocks
    for rec, ops in ((quantize, 6 * n), (dequantize, n)):
        t_bytes = moved / PEAK_BYTES * 1e3
        t_ops = ops / PEAK_FLOPS["float32"] * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    for name, rec in (("quantize", quantize), ("dequantize", dequantize)):
        print(f"timing {name} n={n}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec.items() if isinstance(v, float)
        ) + f" ({rec['bound_by']} bound)", flush=True)
    return {"quantize": quantize, "dequantize": dequantize}


def quantize_phase() -> dict:
    err = 0.0
    seed = 0
    for bits in (8, 4):
        for name, n in QUANT_SIZES.items():
            seed += 1
            err = max(err, quantize_case(name, seeded_values(n, seed), bits))
        err = max(err, quantize_case("special values", special_values(bits), bits))
    records = quantize_timing()
    for rec in records.values():
        rec["max_abs_err"] = err
    return records


# ---------------------------------------------------------------------------
# Phase 5: the fused reduce kernel, and the kernel harness
# ---------------------------------------------------------------------------

REDUCE_RANKS = (2, 3, 4)
REDUCE_ROWS = (1, 5, 4096)
TIMED_RANKS = (2, 4)  # the drills' two groups, and the harness's four


def reduce_inputs(ranks: int, rows: int, seed: int) -> tuple:
    """Each rank's wire payload for ``rows`` rows of seeded values (the
    host quantizer's bytes): int8 q [ranks, rows, 512], fp32 scales
    [ranks, rows]."""
    import numpy as np

    from torchft_tpu_torch import collectives as C

    qs, ss = zip(*(
        C.quantize_blockwise(seeded_values(rows * 512, seed * 16 + r))
        for r in range(ranks)
    ))
    return np.stack([q.reshape(rows, 512) for q in qs]), np.stack(ss)


def reduce_special_inputs(ranks: int) -> tuple:
    """Five rows of every rank's payload: a NaN scale in rank 0 (what the
    wire carries for a block that held a NaN), a row that is zero in every
    rank (scale 1.0, as the host writes it), subnormal scales, a row at
    +-127 in every rank, and a row of seeded values."""
    import numpy as np

    q, s = reduce_inputs(ranks, 5, seed=99)
    rng = np.random.default_rng(ranks)
    s[0, 0] = np.nan
    q[:, 1], s[:, 1] = 0, 1.0
    s[:, 2] = rng.uniform(1e-41, 1e-40, ranks).astype(np.float32)
    q[:, 3] = np.where(np.arange(512) % 3 == 0, -127, 127).astype(np.int8)
    return q, s


def reduce_host(q, s, avg: bool) -> tuple:
    """The host's reduce of int8 payloads q [R, rows, 512], scales [R, rows]:
    each rank dequantized and added in rank order in fp32, divided by
    np.float32(R) if ``avg``, then requantized. (int8 [rows * 512], fp32
    [rows])."""
    import warnings

    import numpy as np

    from torchft_tpu_torch import collectives as C

    ranks, rows = s.shape
    n = rows * 512
    acc = np.zeros(n, np.float32)
    with warnings.catch_warnings():  # a NaN row warns in numpy
        warnings.simplefilter("ignore", RuntimeWarning)
        for r in range(ranks):
            acc += C.dequantize_blockwise(q[r].reshape(-1), s[r], n)
        if avg:
            acc = acc / np.float32(ranks)
        return C.quantize_blockwise(acc)


def reduce_case(name: str, q_host, s_host, avg: bool) -> float:
    """The reduce kernel on q_host, s_host against its plain version on the
    card and the host's reduce; raises unless every count is 0. Returns the
    largest |kernel - plain| over payload levels and finite scales."""
    import numpy as np
    import torch

    from torchft_tpu_torch.ops import quantization as Q

    dev = torch.device("cuda")
    q = torch.from_numpy(q_host).to(dev)
    s = torch.from_numpy(s_host).to(dev)
    q_k, s_k = Q.fused_reduce_int8(q, s, avg)
    q_p, s_p = Q.reduce_rows_reference(q, s, avg)
    torch.cuda.synchronize()
    q_k, s_k = q_k.cpu().numpy().reshape(-1), s_k.cpu().numpy()
    q_p, s_p = q_p.cpu().numpy().reshape(-1), s_p.cpu().numpy()
    q_h, s_h = reduce_host(q_host, s_host, avg)
    counts = {
        "payload vs plain": mismatches(q_k, q_p),
        "scales vs plain": mismatches(s_k, s_p),
        "payload vs numpy": mismatches(q_k, q_h),
        "scales vs numpy": mismatches(s_k, s_h),
    }
    ranks, rows = s_host.shape
    print(f"reduce ok: {name} R={ranks} rows={rows} avg={avg}: "
          + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    if any(counts.values()):
        raise AssertionError(f"reduce {name} R={ranks} avg={avg}: mismatches {counts}")
    finite = np.isfinite(s_p)
    return max(
        float(np.abs(q_k.astype(np.int32) - q_p).max(initial=0)),
        float(np.abs(s_k[finite] - s_p[finite]).max(initial=0.0)),
    )


def reduce_timing() -> dict:
    """The reduce kernel at one 32 MiB bucket (TIMED_N values) for each R in
    TIMED_RANKS, cycling over four inputs (at R = 2 together 67 MB, more
    than the 50 MB L2): launched straight through its C entry point on
    preallocated outputs (``ms``), through its wrapper (``wrapper_ms``), and
    its plain version. Its bound: (R + 1) * (n + 4n/512) bytes over HBM
    against about 3R + 6 fp32 operations per value (per rank a convert, a
    multiply and an add; the divide, |x|, max, divide, rint and clamp of the
    requantize) over the fp32 rate. The R = 2 record is the kernel's; the
    R = 4 one rides in it under ``ranks_4``."""
    import torch

    from torchft_tpu_torch.ops import quantization as Q

    dev = torch.device("cuda")
    n = TIMED_N
    rows = n // 512
    lib = Q._library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    q_out = torch.empty((rows, 512), dtype=torch.int8, device=dev)
    s_out = torch.empty(rows, device=dev)
    rcs = []
    records = {}
    for ranks in TIMED_RANKS:
        inputs = []
        for i in range(4):
            q, s = reduce_inputs(ranks, rows, seed=40 + 4 * ranks + i)
            inputs.append((torch.from_numpy(q).to(dev), torch.from_numpy(s).to(dev)))
        raw = [(q.data_ptr(), s.data_ptr(), ranks, rows, 0, q_out.data_ptr(),
                s_out.data_ptr(), stream) for q, s in inputs]
        rec = {}
        for key, fn, args, iters in (
            ("ms", lambda *a: rcs.append(lib.tft_reduce_rows_int8(*a)), raw, 50),
            ("wrapper_ms", Q.fused_reduce_int8, inputs, 50),
            ("plain_ms", Q.reduce_rows_reference, inputs, 10),
        ):
            rec[key], rec[key.replace("ms", "host_ms")] = time_cold(fn, args, iters)
        t_bytes = (ranks + 1) * (n + 4 * rows) / PEAK_BYTES * 1e3
        t_ops = (3 * ranks + 6) * n / PEAK_FLOPS["float32"] * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"timing reduce R={ranks} n={n}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec.items() if isinstance(v, float)
        ) + f" ({rec['bound_by']} bound)", flush=True)
        records[ranks] = rec
        del inputs, raw
    if any(rcs):
        raise AssertionError(f"a timed launch failed: CUDA errors {set(rcs)}")
    reduce = dict(records[TIMED_RANKS[0]])
    reduce["ranks"] = TIMED_RANKS[0]
    reduce["ranks_4"] = records[4]
    reduce["library_ms"] = None
    reduce["library_call"] = "none: no single PyTorch call computes it"
    return reduce


def harness_phase() -> dict:
    """``python -m torchft_tpu_torch.ops.bench_kernels`` on the card in a
    process of its own (its launch counts start at 0): raises unless it
    exits 0 with ``ok`` true and every kernel launched. Returns its JSON."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.ops.bench_kernels"],
        cwd=str(REPO), capture_output=True, text=True, timeout=600,
    )
    (OUT / "bench_kernels.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(
            f"bench_kernels exited {proc.returncode}: {proc.stdout[-2000:]}"
            f"{proc.stderr[-4000:]}"
        )
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    (OUT / "bench_kernels.json").write_text(json.dumps(result, indent=1))
    idle = [k for k, v in result["launches"].items() if v <= 0]
    if not result["ok"] or idle or len(result["launches"]) != 9:
        raise AssertionError(
            f"bench_kernels: ok {result['ok']}, never launched {idle}, "
            f"launches {result['launches']}"
        )
    print(f"bench_kernels ok in {time.monotonic() - t0:.1f}s: "
          + json.dumps(result), flush=True)
    return result


def reduce_phase() -> tuple:
    """Phase 5: (the reduce kernel's record, the harness's JSON)."""
    t0 = time.monotonic()
    err = 0.0
    for ranks in REDUCE_RANKS:
        for avg in (False, True):
            for rows in REDUCE_ROWS:
                err = max(err, reduce_case(
                    "seeded", *reduce_inputs(ranks, rows, seed=ranks * 10 + rows),
                    avg,
                ))
            err = max(err, reduce_case(
                "special rows", *reduce_special_inputs(ranks), avg
            ))
    record = reduce_timing()
    record["max_abs_err"] = err
    harness = harness_phase()
    print(f"reduce phase ok in {time.monotonic() - t0:.1f}s", flush=True)
    return record, harness


# ---------------------------------------------------------------------------
# Phases 6 to 8: the fault-tolerant training path
# ---------------------------------------------------------------------------

PATH_ARGS = [
    "--model", "small", "--attn", "flash", "--batch", "8", "--seq", "1024",
    "--steps", "8", "--device", "cuda",
]
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
QUANT_KERNELS = ("quantize", "dequantize")
RING_ARGS = [a if a != "flash" else "ring" for a in PATH_ARGS]


def path_phase(name: str, args, kernels, absent=()) -> dict:
    """One kill/heal drill of two groups; raises unless both end at step 8
    with equal parameters and finite losses, every kernel in ``kernels``
    launched in both groups and none in ``absent``. Each group's process
    counts its own launches from 0, so the counts are this drill's
    alone."""
    import shutil

    from torchft_tpu_torch.drill import kill_heal_drill
    from torchft_tpu_torch.ops import flash_attention, quantization

    result_dir = OUT / name
    shutil.rmtree(result_dir, ignore_errors=True)
    # The counts of this run only; the groups' processes start theirs at 0.
    for counts in (flash_attention.LAUNCHES, quantization.LAUNCHES):
        for kernel in counts:
            counts[kernel] = 0
    t0 = time.monotonic()
    results = kill_heal_drill(
        args, str(result_dir), str(result_dir / "logs"),
        kill_after_step=3, timeout_s=400.0,
    )
    wall = time.monotonic() - t0
    for g, r in results.items():
        if r["final_step"] != 8:
            raise AssertionError(f"{name}: group {g} ended at step {r['final_step']}")
        if not all(math.isfinite(x) for x in r["losses"]) or not r["losses"]:
            raise AssertionError(f"{name}: group {g} losses not finite: {r['losses']}")
        for kernel in kernels:
            if r["kernel_launches"][kernel] <= 0:
                raise AssertionError(f"{name}: group {g} never launched {kernel}")
        for kernel in absent:
            if r["kernel_launches"][kernel] != 0:
                raise AssertionError(
                    f"{name}: group {g} launched {kernel} "
                    f"{r['kernel_launches'][kernel]} times"
                )
    if results[0]["param_sha256"] != results[1]["param_sha256"]:
        raise AssertionError(
            f"{name}: groups disagree after kill + heal: "
            f"{results[0]['param_sha256']} vs {results[1]['param_sha256']}"
        )
    for g, r in results.items():
        med = r["median_step_ms"]
        print(
            f"{name} group {g}: final_step {r['final_step']} losses "
            f"{[round(x, 4) for x in r['losses']]} launches "
            f"{r['kernel_launches']} median step {med:.1f} ms "
            f"({r['tokens_per_step'] / (med / 1e3):.0f} tokens/s) phases "
            + json.dumps({k: round(v, 1) for k, v in r["median_phase_ms"].items()}),
            flush=True,
        )
    print(f"{name} ok: param_sha256 equal {results[0]['param_sha256'][:16]}, "
          f"drill wall {wall:.1f}s", flush=True)
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    sys.path.insert(0, str(REPO))
    try:
        import torchft_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"torchft_tpu_torch not importable next to this script: {e}")
    OUT.mkdir(parents=True, exist_ok=True)

    card = card_line()
    print(f"card: {card}", flush=True)
    build_kernels()
    sass_check()

    records = kernel_phase()
    records.update(block_phase())
    records.update(quantize_phase())
    records["reduce"], harness = reduce_phase()
    path = path_phase("path", PATH_ARGS, FLASH_KERNELS)
    quantized = path_phase(
        "quantized path", [*PATH_ARGS, "--quantize"], FLASH_KERNELS + QUANT_KERNELS
    )
    if quantized[0]["param_sha256"] == path[0]["param_sha256"]:
        raise AssertionError(
            "the quantized drill ended in the unquantized drill's parameters: "
            "the gradients were not quantized"
        )
    ring = path_phase("ring path", RING_ARGS, BLOCK_KERNELS, absent=FLASH_KERNELS)
    if ring[0]["param_sha256"] != path[0]["param_sha256"]:
        raise AssertionError(
            "the ring drill (sp=1) ended in other parameters than the flash "
            f"drill ({ring[0]['param_sha256']} vs {path[0]['param_sha256']}): "
            "the block and whole-sequence entry points no longer compute "
            "the same bits"
        )
    for g in (0, 1):
        a, b, c = path[g], quantized[g], ring[g]
        print(f"group {g} median step: unquantized {a['median_step_ms']:.1f} ms "
              f"{json.dumps(a['median_phase_ms'])}, int8 {b['median_step_ms']:.1f} ms "
              f"{json.dumps(b['median_phase_ms'])}, ring {c['median_step_ms']:.1f} ms "
              f"{json.dumps(c['median_phase_ms'])}", flush=True)

    kernels = []
    for name, rec in records.items():
        if name == "reduce":
            # No training step reduces on the card: the harness's launches.
            launches = harness["launches"][name]
        else:
            drill = (quantized if name in QUANT_KERNELS
                     else ring if name in BLOCK_KERNELS else path)
            launches = sum(r["kernel_launches"][name] for r in drill.values())
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "torchft_tpu_torch/ops/csrc/"
            + ("quantization.cu" if name in QUANT_KERNELS + ("reduce",)
               else "flash_attention.cu"),
            "replaces": {
                "flash_fwd": "torchft_tpu/ops/flash_attention.py:202",
                "flash_bwd_dq": "torchft_tpu/ops/flash_attention.py:245",
                "flash_bwd_dkv": "torchft_tpu/ops/flash_attention.py:284",
                "quantize": "torchft_tpu/ops/quantization.py:70",
                "dequantize": "torchft_tpu/ops/quantization.py:138",
                "flash_block_fwd": "torchft_tpu/ops/flash_attention.py:549",
                "flash_block_bwd_dq": "torchft_tpu/ops/flash_attention.py:587",
                "flash_block_bwd_dkv": "torchft_tpu/ops/flash_attention.py:620",
                "reduce": "torchft_tpu/ops/quantization.py:189",
            }[name],
            "launches": launches,
            **rec,
        })
    (OUT / "kernels.json").write_text(json.dumps(kernels, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SystemExit:
        raise
    except BaseException as e:  # noqa: BLE001 - any phase failure fails the run
        import traceback

        traceback.print_exc()
        fail(f"{type(e).__name__}: {e}")
