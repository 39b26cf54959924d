"""Step-level MFU accounting: the port's twin of ``torchft_tpu/perf.py``.

Three layers, shared by ``bench.py`` and the trainers under
``TORCHFT_PERF``:

- **Analytic estimate**: :func:`flops_per_step` is the standard 6ND dense
  estimate plus the causal-attention term, the JAX package's formula
  unchanged, so both packages report the same FLOPs for the same model and
  batch.
- **Measured cost**: :func:`count_step_flops` runs one step under
  ``torch.utils.flop_counter.FlopCounterMode``. The counter cannot see the
  flash kernels (a ``torch.autograd.Function`` over ``ctypes`` calls), so
  their matrix-product FLOPs are added from their shapes
  (``ops.flash_attention.count_flops``); on the CPU the counter does see
  the kernels' plain versions, and what it counted inside them is taken
  back out, so the card and the CPU count the same work. PyTorch has no
  counterpart of XLA's ``bytes accessed``: ``bytes_accessed`` is None and
  so are ``ai`` and ``roofline_frac``.
- **Peaks/roofline**: dense bf16 TFLOP/s and HBM GB/s of the H100 parts,
  keyed by ``torch.cuda.get_device_name()``, and :func:`roofline`.

:func:`record_step_cost` is the trainer entry point: gated on the
``TORCHFT_PERF`` knob, it counts one step, leaves the model, the optimizer
and the RNG as it found them, stores the cost in a process-local registry
and journals a ``perf_model`` event, so ``tools/perf_report.py`` can put
MFU next to ms.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from torchft_tpu_torch import knobs
from torchft_tpu_torch.telemetry import get_event_log

__all__ = [
    "PEAK_BF16_TFLOPS",
    "PEAK_FP32_TFLOPS",
    "PEAK_HBM_GBPS",
    "peak_tflops",
    "peak_fp32_tflops",
    "peak_hbm_gbps",
    "flops_per_step",
    "count_step_flops",
    "perf_enabled",
    "record_step_cost",
    "step_metrics",
    "format_step_metrics",
    "get_step_cost",
    "reset_step_costs",
    "roofline",
]

# Published dense (non-sparse) peaks per card, by lower-cased
# torch.cuda.get_device_name() substring, first match wins. NVIDIA H100
# Tensor Core GPU data sheet and the H100 architecture white paper: SXM5
# ("NVIDIA H100 80GB HBM3") bf16 989.4 TFLOP/s, fp32 67, HBM3 3.35 TB/s;
# PCIe bf16 756.5, fp32 51, HBM2e 2.0 TB/s; NVL bf16 835.5, fp32 60, HBM3
# 3.9 TB/s (the data sheet's bf16 figures are with sparsity, twice these).
# The rates assume the card's full power limit (700 W for the SXM part).
PEAK_BF16_TFLOPS = [
    ("h100 pcie", 756.5),
    ("h100 nvl", 835.5),
    ("h100 80gb hbm3", 989.4),
]

# float32 outside the tensor cores, same rules.
PEAK_FP32_TFLOPS = [
    ("h100 pcie", 51.0),
    ("h100 nvl", 60.0),
    ("h100 80gb hbm3", 67.0),
]

# HBM bandwidth (GB/s), for the roofline's memory ceiling.
PEAK_HBM_GBPS = [
    ("h100 pcie", 2000.0),
    ("h100 nvl", 3900.0),
    ("h100 80gb hbm3", 3350.0),
]


def _lookup(table, device_kind: str) -> Optional[float]:
    kind = (device_kind or "").lower()
    for key, val in table:
        if key in kind:
            return val
    return None


def peak_tflops(device_kind: str) -> Optional[float]:
    """Dense bf16 peak TFLOP/s for a ``torch.cuda.get_device_name()``;
    None for any other device (a CPU run reports raw FLOP/s but no MFU:
    there is no honest peak)."""
    return _lookup(PEAK_BF16_TFLOPS, device_kind)


def peak_fp32_tflops(device_kind: str) -> Optional[float]:
    """float32 peak TFLOP/s outside the tensor cores; None off the table."""
    return _lookup(PEAK_FP32_TFLOPS, device_kind)


def peak_hbm_gbps(device_kind: str) -> Optional[float]:
    """HBM GB/s; None off the table."""
    return _lookup(PEAK_HBM_GBPS, device_kind)


def flops_per_step(n_params: int, cfg, B: int, S: int) -> float:
    """Standard 6ND estimate + causal attention term (fwd+bwd)."""
    dense = 6.0 * n_params * B * S
    attn = 6.0 * cfg.num_layers * B * S * S * cfg.num_heads * cfg.head_dim
    return dense + attn


def roofline(
    flops: float,
    bytes_accessed: Optional[float],
    dt_s: float,
    device_kind: str,
    n_devices: int = 1,
) -> Dict[str, Any]:
    """Achieved FLOP/s vs the device roofline.

    ``mfu`` is achieved / bf16-peak. ``roofline_frac`` is achieved /
    min(peak_flops, AI * peak_bw); it needs the step's bytes, so it stays
    None where ``bytes_accessed`` is None or 0 (always, for a counted
    torch step). Off the peak table both are None; tflops_per_s is always
    reported."""
    out: Dict[str, Any] = {
        "tflops_per_s": (flops / dt_s / 1e12) if dt_s > 0 else None,
        "mfu": None,
        "roofline_frac": None,
        "ai": (flops / bytes_accessed) if bytes_accessed else None,
    }
    peak_tf = peak_tflops(device_kind)
    if dt_s <= 0 or peak_tf is None:
        return out
    achieved = flops / dt_s  # flops/s
    peak_flops_s = peak_tf * 1e12 * n_devices
    out["mfu"] = achieved / peak_flops_s
    bw = peak_hbm_gbps(device_kind)
    if bw is not None and out["ai"] is not None:
        attainable = min(peak_flops_s, out["ai"] * bw * 1e9 * n_devices)
        if attainable > 0:
            out["roofline_frac"] = achieved / attainable
    return out


# ---------------------------------------------------------------------------
# Measured cost: one step under the FLOP counter
# ---------------------------------------------------------------------------


def _walk(obj: Any) -> Iterable[Any]:
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _walk(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _walk(v)
    else:
        yield obj


def _device_kind(objs: Iterable[Any]) -> str:
    """``torch.cuda.get_device_name`` of the first CUDA tensor or module
    among ``objs`` (nested dicts, lists and tuples walked), else "cpu"."""
    import torch

    for obj in _walk(list(objs)):
        if isinstance(obj, torch.nn.Module):
            obj = next(obj.parameters(), None)
        if isinstance(obj, torch.Tensor):
            if obj.is_cuda:
                return torch.cuda.get_device_name(obj.device)
            return "cpu"
    return "cpu"


class _Snapshot:
    """Copies of what one counted step may change: every parameter, buffer
    and gradient of ``modules``, the state and hyperparameters of
    ``optimizers``, and the CPU and CUDA RNG states. :meth:`restore` puts
    them back, the tensors in place (FSDP2's parameters are views into its
    own buffers).

    FSDP2's units are resharded first: after a forward without gradients
    (an eval step) the root's registered parameters are its unsharded
    tensors, whose storage the counted step's backward frees. The copies
    are of the sharded parameters the optimizer holds."""

    def __init__(self, keep: Iterable[Any]) -> None:
        import torch

        keep = list(keep)
        modules = [m for m in keep if isinstance(m, torch.nn.Module)]
        optimizers = [o for o in keep if isinstance(o, torch.optim.Optimizer)]
        if torch.distributed.is_available():
            from torch.distributed.fsdp import FSDPModule

            for m in modules:
                for unit in m.modules():
                    if isinstance(unit, FSDPModule):
                        unit.reshard()
        clone = lambda v: (  # noqa: E731
            v.detach().clone() if isinstance(v, torch.Tensor) else v
        )
        with torch.no_grad():
            self._tensors = [
                (t, t.detach().clone())
                for m in modules
                for t in [*m.parameters(), *m.buffers()]
            ]
            self._grads = [
                (p, None if p.grad is None else p.grad.detach().clone())
                for m in modules
                for p in m.parameters()
            ]
            self._optimizers = [
                (
                    opt,
                    {p: {k: clone(v) for k, v in s.items()}
                     for p, s in opt.state.items()},
                    [{k: v for k, v in g.items() if k != "params"}
                     for g in opt.param_groups],
                )
                for opt in optimizers
            ]
        self._rng = torch.random.get_rng_state()
        self._cuda_rng = (
            torch.cuda.get_rng_state_all()
            if torch.cuda.is_initialized() else None
        )

    def restore(self) -> None:
        import torch

        with torch.no_grad():
            for t, saved in self._tensors:
                t.copy_(saved)
        for p, g in self._grads:
            p.grad = g
        for opt, state, groups in self._optimizers:
            opt.state.clear()
            opt.state.update(state)
            for group, saved in zip(opt.param_groups, groups):
                group.update(saved)
        torch.random.set_rng_state(self._rng)
        if self._cuda_rng is not None:
            torch.cuda.set_rng_state_all(self._cuda_rng)


def count_step_flops(
    fn, *args, preserve: Tuple[Any, ...] = (), **kwargs
) -> Dict[str, float]:
    """Runs ``fn(*args, **kwargs)`` once under ``FlopCounterMode`` and
    returns ``{"flops", "counted_flops", "kernel_flops"}``: ``flops`` =
    what the counter saw outside the flash kernels' plain versions plus the
    flash kernels' own FLOPs (``kernel_flops``; ``counted_flops`` is the
    counter's raw total). The modules and optimizers in ``preserve`` and
    the RNG are restored afterwards, even if ``fn`` raises; the device is
    synchronised first."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from torchft_tpu_torch.ops.flash_attention import count_flops

    snap = _Snapshot(preserve)
    try:
        with FlopCounterMode(display=False) as counter, count_flops() as flash:
            fn(*args, **kwargs)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    finally:
        snap.restore()
    counted = float(counter.get_total_flops())
    return {
        "flops": counted - flash.plain + flash.kernel,
        "counted_flops": counted,
        "kernel_flops": float(flash.kernel),
    }


# Process-local registry of counted step costs, keyed by the name the
# trainer registered ("ddp_step", "diloco_inner_step", ...).
_COST_LOCK = threading.Lock()
_STEP_COSTS: Dict[str, Dict[str, Any]] = {}


def perf_enabled() -> bool:
    return knobs.get_bool("TORCHFT_PERF")


def get_step_cost(name: str) -> Optional[Dict[str, Any]]:
    with _COST_LOCK:
        rec = _STEP_COSTS.get(name)
        return dict(rec) if rec else None


def reset_step_costs() -> None:
    with _COST_LOCK:
        _STEP_COSTS.clear()


def record_step_cost(
    name: str,
    fn,
    *args,
    tokens_per_step: Optional[int] = None,
    preserve: Tuple[Any, ...] = (),
    force: bool = False,
    **kwargs,
) -> Optional[Dict[str, Any]]:
    """Counts one step of ``fn`` on ``args`` (:func:`count_step_flops`;
    ``preserve``: the modules and optimizers ``fn`` changes), records its
    FLOPs, and journals a ``perf_model`` event.

    No-op returning None unless the ``TORCHFT_PERF`` knob is set (or
    ``force``): runs that don't ask for MFU pay nothing. A step that
    raises degrades to None (what it changed is restored): accounting must
    never kill a trainer. ``n_devices`` is 1: a process drives one device,
    and counts the work of its own rows."""
    if not (force or perf_enabled()):
        return None
    try:
        cost = count_step_flops(fn, *args, preserve=preserve, **kwargs)
    except Exception:  # noqa: BLE001 - accounting is best-effort
        return None
    rec: Dict[str, Any] = {
        "name": name,
        "device_kind": _device_kind([*args, *kwargs.values(), *preserve]),
        "n_devices": 1,
        "tokens_per_step": tokens_per_step,
        "bytes_accessed": None,
        "temp_bytes": None,
        **cost,
    }
    with _COST_LOCK:
        _STEP_COSTS[name] = rec
    log = get_event_log()
    if log is not None:
        log.emit(
            "perf_model",
            name=name,
            flops=rec["flops"],
            kernel_flops=rec["kernel_flops"],
            bytes_accessed=None,
            temp_bytes=None,
            device_kind=rec["device_kind"],
            n_devices=rec["n_devices"],
            tokens_per_step=tokens_per_step,
        )
    return rec


def step_metrics(name: str, dt_s: float) -> Optional[Dict[str, Any]]:
    """MFU for one wall-clock step of the registered step; None when the
    cost was never recorded (knob off, or the counting step failed). Off
    the peak table ``mfu`` stays None and callers print the raw TFLOP/s
    instead of inventing a peak."""
    rec = get_step_cost(name)
    if rec is None or dt_s <= 0:
        return None
    out = roofline(
        float(rec.get("flops") or 0.0),
        rec.get("bytes_accessed"),
        dt_s,
        rec.get("device_kind", ""),
        int(rec.get("n_devices") or 1),
    )
    tok = rec.get("tokens_per_step")
    out["tokens_per_s"] = (tok / dt_s) if tok else None
    return out


def format_step_metrics(m: Optional[Dict[str, Any]]) -> str:
    """One-line suffix for trainer step logs: empty when accounting is
    off, else e.g. `` perf[0.42 TF/s mfu=1.2% 8000 tok/s]``."""
    if not m:
        return ""
    parts: List[str] = []
    if m.get("tflops_per_s") is not None:
        parts.append(f"{m['tflops_per_s']:.3g} TF/s")
    if m.get("mfu") is not None:
        parts.append(f"mfu={m['mfu'] * 100:.2f}%")
    if m.get("roofline_frac") is not None:
        parts.append(f"roofline={m['roofline_frac'] * 100:.1f}%")
    if m.get("tokens_per_s"):
        parts.append(f"{m['tokens_per_s']:.0f} tok/s")
    return f" perf[{' '.join(parts)}]" if parts else ""
