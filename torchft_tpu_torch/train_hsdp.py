"""Fault-tolerant training of the Llama decoder on one device per replica
group: the PyTorch twin of the repo root's ``train_hsdp.py`` loop with an
inner mesh of one device.

Per step: ``manager.start_quorum()``, the grad step, the replica-axis
gradient average (``DistributedDataParallel.allreduce_grads``, the call
``ManagedMesh.allreduce_grads`` delegates to), the fenced
``manager.should_commit()``, and the AdamW apply. A killed group restarts,
heals params + optimizer state from a healthy peer (host numpy over the HTTP
checkpoint transport) and rejoins; groups that commit step k hold
bitwise-identical parameters.

Run two replica groups against one lighthouse (both may share one card)::

    torchft_tpu/_cpp/bin/lighthouse --min-replicas 2 --port 29510 &
    for i in 0 1; do
      TORCHFT_LIGHTHOUSE=127.0.0.1:29510 REPLICA_GROUP_ID=$i \\
      python -m torchft_tpu_torch.train_hsdp --model small --attn flash \\
          --batch 8 --seq 1024 --min-replicas 2 --steps 8 --result-dir out &
    done

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import logging
import os
import statistics
import sys
import time

# Flags the JAX trainer has whose paths are not ported yet, with the
# ROADMAP.md item that ports them.
_UNPORTED = {
    "quantize": "kernel queue: quantize + dequantize (device-side "
    "quantized outer allreduce)",
    "pg-sharded": "queue 1: checkpointing/pg_transport + sharded",
    "durable_dir": "queue 1: checkpointing/durable",
    "moe": "queue 1: MoE / expert parallelism",
    "pipeline": "queue 1: parallel/pipeline",
    "ring": "kernel queue: ring-attention block kernels + parallel/*",
    "ulysses": "queue 1: parallel/ulysses",
}


def drain_signal(enabled: bool = True):
    """Installs the preemption-drain SIGTERM handler and returns a zero-arg
    callable reading the flag: the loop drains at its next step boundary
    (finish the step, ``manager.leave()``, exit 0). A second SIGTERM
    escalates to default kill semantics."""
    import signal

    flag = [False]
    if enabled:

        def _on_sigterm(_signum, _frame):
            flag[0] = True
            signal.signal(signal.SIGTERM, signal.SIG_DFL)

        signal.signal(signal.SIGTERM, _on_sigterm)
    return lambda: flag[0]


def _parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m torchft_tpu_torch.train_hsdp")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument(
        "--model", choices=["debug", "small", "moe", "pipeline"], default="debug"
    )
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=64)
    parser.add_argument("--min-replicas", type=int, default=1)
    parser.add_argument("--quantize", action="store_true",
                        help="quantize the outer gradient allreduce")
    parser.add_argument(
        "--attn", choices=["default", "flash", "ring", "ulysses"],
        default="default",
        help="'flash': the CUDA flash-attention kernels from S >= 1024; "
        "'default' keeps the model preset's impl",
    )
    parser.add_argument("--quantize-bits", type=int, default=8, choices=(8, 4))
    parser.add_argument(
        "--ckpt-transport", choices=["http", "pg-sharded"], default="http"
    )
    parser.add_argument("--result-dir", type=str, default=None)
    parser.add_argument(
        "--drain-on-sigterm", action=argparse.BooleanOptionalAction,
        default=True,
        help="on SIGTERM, finish the step, leave the quorum, exit 0",
    )
    parser.add_argument("--durable-dir", type=str, default=None)
    parser.add_argument("--durable-every", type=int, default=10)
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device of this replica group (default cuda)",
    )
    args = parser.parse_args(argv)
    unported = [
        key for key, on in (
            ("quantize", args.quantize),
            ("pg-sharded", args.ckpt_transport == "pg-sharded"),
            ("durable_dir", args.durable_dir is not None),
            ("moe", args.model == "moe"),
            ("pipeline", args.model == "pipeline"),
            ("ring", args.attn == "ring"),
            ("ulysses", args.attn == "ulysses"),
        ) if on
    ]
    if unported:
        parser.error(
            "not ported to torchft_tpu_torch yet: "
            + "; ".join(f"{k} (ROADMAP.md {_UNPORTED[k]})" for k in unported)
        )
    return args


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "train_hsdp: no CUDA device visible; pass --device cpu to run "
            "on the CPU"
        )
    return device


def main(argv=None) -> int:
    args = _parse(argv)
    logging.basicConfig(level=logging.INFO)
    sigterm_drain = drain_signal(args.drain_on_sigterm)

    import torch

    from torchft_tpu_torch import telemetry
    from torchft_tpu_torch.ddp import DistributedDataParallel
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import Transformer, llama_debug, llama_small
    from torchft_tpu_torch.ops.flash_attention import LAUNCHES
    from torchft_tpu_torch.optim import (
        load_optimizer_state_dict,
        optimizer_state_dict,
    )
    from torchft_tpu_torch.parallel.train import default_optimizer, grad_step
    from torchft_tpu_torch.process_group import make_process_group

    device = _device(args.device)
    group = os.environ.get("REPLICA_GROUP_ID", "0")
    B, S = args.batch, args.seq
    cfg = {"debug": llama_debug, "small": llama_small}[args.model]()
    if args.attn == "flash":
        # bench.py's flash setting: the kernels from S >= 1024.
        cfg = dataclasses.replace(cfg, attn_impl="flash", flash_min_seq=1024)
    # No block recompute: one replica group's activations at these sizes
    # fit the card, and recompute would run every block's forward (and its
    # attention kernel) twice per step.
    cfg = dataclasses.replace(cfg, remat=False)

    torch.manual_seed(0)  # same initial weights in every group
    model = Transformer(cfg).to(device)
    optimizer = default_optimizer(model.parameters())
    params = dict(model.named_parameters())

    pg = make_process_group(timeout=30.0)
    manager = Manager(
        pg=pg,
        state_dict=lambda: optimizer_state_dict(optimizer),
        load_state_dict=lambda sd: load_optimizer_state_dict(optimizer, sd),
        min_replica_size=args.min_replicas,
        use_async_quorum=True,
        timeout=60.0,
        quorum_timeout=60.0,
        connect_timeout=30.0,
        max_retries=20,
    )
    ddp = DistributedDataParallel(manager)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    metrics = telemetry.get_metrics_logger()
    losses = []
    step_ms = []
    # Per committed step, ms: grad step (forward + backward, synchronized),
    # replica-axis allreduce (device->host, wire, host->device), commit
    # gate + optimizer apply.
    phase_ms = {"grad": [], "allreduce": [], "commit_apply": []}
    drained = False
    try:
        while manager.current_step() < args.steps:
            step = manager.current_step()
            if sigterm_drain() or manager.drain_requested():
                logging.info(
                    "[group %s] draining at step %d (%s)", group, step,
                    "SIGTERM" if sigterm_drain() else "operator request",
                )
                manager.leave()
                drained = True
                break
            t0 = time.perf_counter()
            telemetry.trace_window(step)
            manager.start_quorum()
            # Deterministic batch per step: every group that commits step k
            # computes identical params (bitwise) — heal-invariant.
            gen = torch.Generator(device=device).manual_seed(step)
            inputs = torch.randint(
                0, cfg.vocab_size, (B, S), generator=gen, device=device
            )
            batch = {
                "inputs": inputs,
                "targets": torch.roll(inputs, -1, 1),
                "mask": torch.ones((B, S), dtype=torch.int32, device=device),
            }
            loss, grads = grad_step(model, batch)
            sync()
            t_grad = time.perf_counter()
            grads = ddp.allreduce_grads(grads)
            t_ar = time.perf_counter()
            # Fenced: the commit decision + param/opt update must be one
            # critical section vs concurrent checkpoint sends (async
            # quorum), or a healed peer snapshots a torn (params, step).
            with manager.fenced_state_dict():
                committed = manager.should_commit()
                if committed:
                    for name, p in params.items():
                        p.grad = grads[name]
                    optimizer.step()
            sync()
            if committed:
                t_end = time.perf_counter()
                step_ms.append((t_end - t0) * 1e3)
                phase_ms["grad"].append((t_grad - t0) * 1e3)
                phase_ms["allreduce"].append((t_ar - t_grad) * 1e3)
                phase_ms["commit_apply"].append((t_end - t_ar) * 1e3)
                losses.append(float(loss))
                logging.info(
                    "[group %s] step %d loss %.4f participants %d "
                    "step_ms %.1f",
                    group, step, losses[-1], manager.num_participants(),
                    step_ms[-1],
                )
                if metrics is not None:
                    metrics.log(
                        step,
                        loss=losses[-1],
                        num_participants=manager.num_participants(),
                        committed=1.0,
                    )
        if args.result_dir:
            os.makedirs(args.result_dir, exist_ok=True)
            host = [p.detach().cpu().numpy() for p in params.values()]
            # Steady-state steps only: the first committed step of a process
            # also pays one-time set-up (kernel build and load, allocator).
            steady = step_ms[1:] or step_ms
            result = {
                "group": group,
                "final_step": manager.current_step(),
                "param_l1": float(sum(abs(h).sum() for h in host)),
                "param_sha256": hashlib.sha256(
                    b"".join(h.tobytes() for h in host)
                ).hexdigest(),
                "losses": losses[-5:],
                "drained": drained,
                "device": (
                    torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"
                ),
                "kernel_launches": dict(LAUNCHES),
                "committed_steps": len(step_ms),
                "step_ms": step_ms,
                "median_step_ms": statistics.median(steady) if steady else None,
                "median_phase_ms": {
                    k: statistics.median(v[1:] or v) if v else None
                    for k, v in phase_ms.items()
                },
                "tokens_per_step": B * S,
            }
            with open(
                os.path.join(args.result_dir, f"group{group}.json"), "w"
            ) as f:
                json.dump(result, f)
        return 0
    finally:
        manager.shutdown()


if __name__ == "__main__":
    sys.exit(main())
