"""On-card smoke of the PyTorch port (torchft_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure exits non-zero and prints no result line:

1. The card's name and power limit (nvidia-smi); build every CUDA kernel of
   the training path from ``torchft_tpu_torch/ops/csrc`` with nvcc.
2. Kernels: each kernel against its plain PyTorch version on the card,
   element by element (``TOL``), at the training path's shapes
   (llama_small: B=8, S=1024, Hq=12, Hkv=4, D=64, bf16) and at further
   shapes (fp32 D=64 and D=128, non-causal, a ragged length); timed with CUDA events beside its plain version, the one-call
   PyTorch equivalent (``F.scaled_dot_product_attention``, a yardstick the
   port never calls) and the least time the card could take. Prints one
   ``{"kernels": [...]}`` line. Also the model with flash attention against
   the model with dense attention on the same weights.
3. Path: the C++ lighthouse and two replica groups of
   ``python -m torchft_tpu_torch.train_hsdp --model small --attn flash
   --batch 8 --seq 1024 --steps 8`` on the card; group 1 is SIGKILLed after
   step 3 and restarted, heals from group 0, and both must end at step 8
   with bitwise-equal parameters, finite losses, and every flash kernel
   launched in both groups.
4. The last line: ``{"ok": true, "device": {...}}``.

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

SOURCE = "flash_attention.cu"


def build_kernels() -> None:
    from torchft_tpu_torch.ops import _cuda_build

    t0 = time.monotonic()
    _cuda_build.build(SOURCE)
    seconds = time.monotonic() - t0
    ptxas = _cuda_build.BUILD_DIR / f"{Path(SOURCE).stem}.ptxas.txt"
    if ptxas.exists():
        (OUT / ptxas.name).write_text(ptxas.read_text())
    print(f"build: {SOURCE} {seconds:.1f}s", flush=True)


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


def bounds(B, S, Hq, Hkv, D, dtype_name, causal):
    """Least time (ms) and its binding resource per kernel: the larger of
    the operations this call needs over the peak rate for its dtype and
    the bytes it must move (each input read once, each output written
    once) over the HBM rate. Matrix-product flops per (q row, kv column)
    pair the causal mask keeps: forward QK^T + PV = 4D; dq: QK^T, dO.V^T,
    dS.K = 6D; dk/dv: QK^T, dO.V^T, P^T.dO, dS^T.Q = 8D."""
    e = 2 if dtype_name == "bfloat16" else 4
    pairs = B * Hq * causal_pairs(S, causal)
    q_bytes = B * S * Hq * D * e
    kv_bytes = B * S * Hkv * D * e
    row_bytes = B * Hq * S * 4
    work = {
        "flash_fwd": (4 * D * pairs, q_bytes + 2 * kv_bytes + q_bytes + row_bytes),
        "flash_bwd_dq": (
            6 * D * pairs, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + q_bytes
        ),
        "flash_bwd_dkv": (
            8 * D * pairs, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + 2 * kv_bytes
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
    return {
        "max_abs_err": float(diff.max()),
        "ref_rms": rms,
        "share": float((diff / allowed).max()),
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
# Phase 3: the fault-tolerant training path
# ---------------------------------------------------------------------------

PATH_ARGS = [
    "--model", "small", "--attn", "flash", "--batch", "8", "--seq", "1024",
    "--steps", "8", "--device", "cuda",
]


def path_phase() -> dict:
    import shutil

    from torchft_tpu_torch.drill import kill_heal_drill
    from torchft_tpu_torch.ops.flash_attention import LAUNCHES

    result_dir = OUT / "path"
    shutil.rmtree(result_dir, ignore_errors=True)
    for name in LAUNCHES:  # counts of this run only (the groups' own start at 0)
        LAUNCHES[name] = 0
    t0 = time.monotonic()
    results = kill_heal_drill(
        PATH_ARGS, str(result_dir), str(result_dir / "logs"),
        kill_after_step=3, timeout_s=700.0,
    )
    wall = time.monotonic() - t0
    for g, r in results.items():
        if r["final_step"] != 8:
            raise AssertionError(f"group {g} ended at step {r['final_step']}")
        if not all(math.isfinite(x) for x in r["losses"]) or not r["losses"]:
            raise AssertionError(f"group {g} losses not finite: {r['losses']}")
        for name, n in r["kernel_launches"].items():
            if n <= 0:
                raise AssertionError(f"group {g} never launched {name}")
    if results[0]["param_sha256"] != results[1]["param_sha256"]:
        raise AssertionError(
            "groups disagree after kill + heal: "
            f"{results[0]['param_sha256']} vs {results[1]['param_sha256']}"
        )
    for g, r in results.items():
        med = r["median_step_ms"]
        print(
            f"path group {g}: final_step {r['final_step']} losses "
            f"{[round(x, 4) for x in r['losses']]} launches "
            f"{r['kernel_launches']} median step {med:.1f} ms "
            f"({r['tokens_per_step'] / (med / 1e3):.0f} tokens/s) phases "
            + json.dumps({k: round(v, 1) for k, v in r["median_phase_ms"].items()}),
            flush=True,
        )
    print(f"path ok: param_sha256 equal {results[0]['param_sha256'][:16]}, "
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

    records = kernel_phase()
    path = path_phase()

    kernels = []
    for name, rec in records.items():
        launches = sum(r["kernel_launches"][name] for r in path.values())
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "torchft_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": {
                "flash_fwd": "torchft_tpu/ops/flash_attention.py:202",
                "flash_bwd_dq": "torchft_tpu/ops/flash_attention.py:245",
                "flash_bwd_dkv": "torchft_tpu/ops/flash_attention.py:284",
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
