"""Fault-tolerant DDP training, one device per replica group: the PyTorch
twin of the repo root's ``train_ddp.py``.

Each replica group trains a vision model on synthetic data: the small CNN
``Net`` (32x32, 10 classes), ``resnet-tiny``, or ``resnet50`` (BASELINE
config #3's model; ``--image-size 224 --num-classes 1000`` for the
ImageNet-shaped workload). Gradients are averaged across replica groups
through the Manager; a group that dies and restarts heals params, Adam
state and BatchNorm statistics from a healthy peer, and the job goes on.

Run two replica groups against one lighthouse (both may share one card)::

    torchft_tpu/_cpp/bin/lighthouse --min-replicas 2 --port 29510 &
    for i in 0 1; do
      TORCHFT_LIGHTHOUSE=127.0.0.1:29510 REPLICA_GROUP_ID=$i \\
      python -m torchft_tpu_torch.train_ddp --model resnet50 \\
          --image-size 224 --num-classes 1000 --batch-size 32 \\
          --min-replicas 2 --steps 8 --quantize --result-dir out &
    done

Each group draws its batches from a ``torch.Generator`` on its device
seeded by ``group_data_seed(group)`` and the step, so a relaunched group
that heals to step N resumes at batch N. ``--quantize`` quantizes the
gradient allreduce: CUDA gradients with the kernels of
``ops/quantization.py`` before the device->host pull (without
``--error-feedback``), host gradients with the host quantizer.

``--durable-dir DIR`` (``--durable-every N``, default 50) adds durable
snapshots (``checkpointing/durable.py``) under ``DIR/group<id>``: params,
Adam state, BatchNorm statistics and the manager's step every N committed
steps and at a SIGTERM drain, restored at boot through the heal loaders.

Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import statistics
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchft_tpu_torch._train_common import (
    DurableRegime,
    drain_signal,
    group_data_seed,
    trainer_device,
)
from torchft_tpu_torch.models.resnet import Conv, Dense, ResNet


class Net(nn.Module):
    """The small CNN of ``train_ddp.py:52-66``, fp32, on NHWC
    ``[B, 32, 32, 3]``. Module names are flax's, so
    ``models.resnet.params_from_jax`` maps its weights."""

    def __init__(self) -> None:
        super().__init__()
        self.Conv_0 = Conv(3, 16, 3, bias=True, dtype=torch.float32)
        self.Conv_1 = Conv(16, 32, 3, bias=True, dtype=torch.float32)
        self.Dense_0 = Dense(8 * 8 * 32, 64, dtype=torch.float32)
        self.Dense_1 = Dense(64, 10, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2)
        # flax flattens NHWC: Dense_0 sees the features in H, W, C order.
        x = x.permute(0, 2, 3, 1).flatten(1)
        return self.Dense_1(F.relu(self.Dense_0(x)))


def build_model(name: str, image_size: int, num_classes: int) -> nn.Module:
    if name == "cnn":
        if image_size != 32 or num_classes != 10:
            raise SystemExit("--model cnn is fixed at 32x32 / 10 classes")
        return Net()
    from torchft_tpu_torch.models import resnet50, resnet_tiny

    return (resnet50 if name == "resnet50" else resnet_tiny)(num_classes=num_classes)


def loss_and_grads(
    model: nn.Module, x: torch.Tensor, y: torch.Tensor
) -> Tuple[torch.Tensor, Optional[dict], Dict[str, torch.Tensor]]:
    """Mean softmax cross entropy of ``model(x)`` against the integer labels
    ``y`` and its gradients by parameter name. A ResNet also returns its
    BatchNorm layers' batch ``(mean, var)``, for
    :meth:`ResNet.update_batch_stats`; other models None."""
    for p in model.parameters():
        p.grad = None
    out = model(x)
    logits, batch = out if isinstance(model, ResNet) else (out, None)
    loss = F.cross_entropy(logits, y)
    loss.backward()
    return loss.detach(), batch, {n: p.grad for n, p in model.named_parameters()}


def adam(params, lr: float) -> torch.optim.Adam:
    """Adam with ``optax.adam(lr)``'s defaults: b1 0.9, b2 0.999, eps 1e-8."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def synthetic_batch(
    key: Tuple[int, int], batch_size: int, image_size: int, num_classes: int,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """NHWC normal images and uniform labels from a generator on
    ``device``, seeded by ``key`` (the group's data seed and the step)
    mixed into 32 bits: the CPU generator keeps only a seed's low 32 bits,
    so a seed that put the group in the high bits would hand every group
    the same batches there."""
    seed = int(np.random.SeedSequence(key).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(
        (batch_size, image_size, image_size, 3), generator=gen, device=device
    )
    y = torch.randint(0, num_classes, (batch_size,), generator=gen, device=device)
    return x, y


def sha256_of(tensors: Dict[str, torch.Tensor]) -> str:
    """sha256 over the tensors' fp32 bytes in sorted-name order."""
    h = hashlib.sha256()
    for n in sorted(tensors):
        h.update(np.ascontiguousarray(tensors[n].detach().float().cpu().numpy()).tobytes())
    return h.hexdigest()


def _parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m torchft_tpu_torch.train_ddp")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--min-replicas", type=int, default=1)
    parser.add_argument(
        "--model", choices=["cnn", "resnet-tiny", "resnet50"], default="cnn",
        help="cnn = the reference-shaped toy CNN; resnet50 = BASELINE "
             "config #3's model (pass --image-size 224 --num-classes 1000 "
             "for the ImageNet-shaped workload); resnet-tiny for CPU runs",
    )
    parser.add_argument(
        "--image-size", type=int, default=32,
        help="synthetic image side; BASELINE #3 at full scale uses 224",
    )
    parser.add_argument("--num-classes", type=int, default=10)
    parser.add_argument(
        "--result-dir", type=str, default=None,
        help="write group{N}.json with final step + param sha256 (the "
        "kill/heal bitwise-equality check, BASELINE #3)",
    )
    parser.add_argument("--quantize", action="store_true")
    parser.add_argument(
        "--quantize-bits", type=int, default=8, choices=(8, 4),
        help="wire width for --quantize (4 = nibble-packed, half the bytes)",
    )
    parser.add_argument(
        "--error-feedback", action="store_true",
        help="carry per-bucket quantization residuals into the next step "
        "(recommended with --quantize-bits 4)",
    )
    parser.add_argument(
        "--drain-on-sigterm", action=argparse.BooleanOptionalAction,
        default=True,
        help="on SIGTERM (maintenance event / preemption notice), finish the "
        "current step, gracefully leave the quorum, and exit 0",
    )
    parser.add_argument(
        "--durable-dir", type=str, default=None,
        help="durable-snapshot directory (a group<id> subdirectory is "
        "added): snapshots on the --durable-every cadence and at a drain, "
        "restored at boot",
    )
    parser.add_argument("--durable-every", type=int, default=50)
    parser.add_argument(
        "--step-min-s", type=float, default=0.0,
        help="minimum wall seconds per step (drill pacing; 0 = full speed)",
    )
    parser.add_argument(
        "--world-size-mode", choices=("dynamic", "fixed_with_spares"),
        default="dynamic",
        help="fixed_with_spares: the effective participant count is pinned "
        "at --min-replicas; extra replica groups run as hot spares",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device of this replica group (default cuda)",
    )
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    logging.basicConfig(level=logging.INFO)
    replica_group = os.environ.get("REPLICA_GROUP_ID", "0")
    sigterm_drain = drain_signal(args.drain_on_sigterm)

    from torchft_tpu_torch import telemetry
    from torchft_tpu_torch.ddp import DistributedDataParallel
    from torchft_tpu_torch.manager import Manager, WorldSizeMode
    from torchft_tpu_torch.ops import flash_attention, quantization
    from torchft_tpu_torch.optim import OptimizerWrapper, optimizer_state_dict
    from torchft_tpu_torch.process_group import make_process_group

    device = trainer_device(args.device, "train_ddp")
    S_img, n_cls, B = args.image_size, args.num_classes, args.batch_size
    torch.manual_seed(0)  # same initial weights in every group
    model = build_model(args.model, S_img, n_cls).to(device)
    params = dict(model.named_parameters())
    has_stats = isinstance(model, ResNet)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # Pay the device's one-time set-up before joining the quorum, so the
    # group's first step does not hold up its peers.
    loss_and_grads(model, *synthetic_batch((2**31, 0), B, S_img, n_cls, device))
    sync()

    manager = Manager(
        pg=make_process_group(timeout=30.0),
        min_replica_size=args.min_replicas,
        replica_id=f"train_ddp_{replica_group}",
        group_rank=0,
        group_world_size=1,
        world_size_mode=WorldSizeMode(args.world_size_mode),
    )
    opt = OptimizerWrapper(manager, adam(model.parameters(), args.lr))
    ddp = DistributedDataParallel(
        manager,
        error_feedback=args.error_feedback,
        quantize_bits=args.quantize_bits,
    )
    if has_stats:
        # BatchNorm statistics heal with the params, so a recovered group's
        # normalization matches its checkpoint source.
        manager.register_state_dict_fn(
            "batch_stats",
            lambda: {
                n: {k: v.cpu().numpy() for k, v in kv.items()}
                for n, kv in model.batch_stats().items()
            },
            model.load_batch_stats,
        )

    # Durable regime (composes with live heal): a snapshot holds what the
    # heal ships, so restore reuses the heal loaders. Groups may snapshot
    # one step apart (each drains at its own boundary); the behind group
    # live-heals forward at the first post-resume quorum.
    ckpt = None

    def durable_state():
        state = {
            "optimizer": optimizer_state_dict(opt.optimizer, device=True),
            "manager": manager.state_dict(),
        }
        if has_stats:
            state["batch_stats"] = model.batch_stats()
        return state

    if args.durable_dir:
        ckpt = DurableRegime(
            args.durable_dir, replica_group, every=args.durable_every
        )
        snap = ckpt.restore_if_any()
        if snap is not None:
            opt.load_state_dict(snap["optimizer"])
            if snap.get("batch_stats") is not None:
                model.load_batch_stats(snap["batch_stats"])
            ckpt.restore_manager(manager, snap)
            ckpt.log_resumed(manager.current_step())

    # Step-addressed data stream: stable across incarnations, resumable.
    data_seed = group_data_seed(replica_group)
    metrics = telemetry.get_metrics_logger()
    losses = []
    step_ms = []
    # Per committed step, ms: grad step (forward + backward, synchronized),
    # replica-axis allreduce (with --quantize on CUDA also the quantize and
    # dequantize kernels), commit gate + Adam apply + statistics update.
    phase_ms = {"grad": [], "allreduce": [], "commit_apply": []}
    # sha256 of the BatchNorm statistics each committed step started from,
    # by step: equal across groups at a healed group's first step.
    stats_sha: Dict[str, str] = {}
    drained = False
    try:
        while manager.current_step() < args.steps:
            if sigterm_drain() or manager.drain_requested():
                why = "SIGTERM" if sigterm_drain() else "operator request"
                print(
                    f"[group {replica_group}] draining at step "
                    f"{manager.current_step()} ({why})",
                    flush=True,
                )
                manager.leave()  # unblock peers first; the save is local
                if ckpt is not None:
                    ckpt.on_drain(manager.current_step(), durable_state)
                drained = True
                break
            step = manager.current_step()
            t0 = time.perf_counter()
            telemetry.trace_window(step)
            x, y = synthetic_batch((data_seed, step), B, S_img, n_cls, device)
            opt.zero_grad()  # quorum (async; overlaps with forward/backward)
            loss, batch, grads = loss_and_grads(model, x, y)
            sync()
            t_grad = time.perf_counter()
            grads = ddp.allreduce_grads(grads, should_quantize=args.quantize)
            t_ar = time.perf_counter()
            for n, p in params.items():
                p.grad = grads[n]

            def on_commit() -> None:
                # Inside the commit fence, after any heal has been applied:
                # the statistics step from what this group now holds.
                stats_sha[str(manager.current_step() - 1)] = sha256_of({
                    f"{n}.{k}": v
                    for n, kv in model.batch_stats().items()
                    for k, v in kv.items()
                })
                model.update_batch_stats(batch)

            committed = opt.step(on_commit=on_commit if has_stats else None)
            sync()
            t_end = time.perf_counter()
            print(
                f"[group {replica_group}] step={step} loss={float(loss):.4f} "
                f"participants={manager.num_participants()} "
                f"committed={committed} t={time.time():.3f}",
                flush=True,
            )
            if committed:
                losses.append(float(loss))
                step_ms.append((t_end - t0) * 1e3)
                phase_ms["grad"].append((t_grad - t0) * 1e3)
                phase_ms["allreduce"].append((t_ar - t_grad) * 1e3)
                phase_ms["commit_apply"].append((t_end - t_ar) * 1e3)
            if metrics is not None:
                metrics.log(
                    step,
                    loss=float(loss),
                    num_participants=manager.num_participants(),
                    committed=float(committed),
                )
            if committed and ckpt is not None:
                # The factory, not the state: built only on cadence steps.
                ckpt.on_commit(manager.current_step(), durable_state)
            if args.step_min_s > 0:
                time.sleep(max(0.0, args.step_min_s - (time.perf_counter() - t0)))

        if ckpt is not None:
            ckpt.close()  # every snapshot on disk before the result is written
        if args.result_dir:
            os.makedirs(args.result_dir, exist_ok=True)
            # Steady-state steps only: a process's first committed step also
            # pays one-time set-up (kernel build and load, allocator).
            steady = step_ms[1:] or step_ms
            result = {
                "group": replica_group,
                "final_step": manager.current_step(),
                # Params only: BatchNorm statistics are fed by each group's
                # own data and legitimately diverge (see batch_stats_sha).
                "param_sha256": sha256_of(params),
                "drained": drained,
                "device": str(device),
                "kernel_launches": {
                    **flash_attention.LAUNCHES, **quantization.LAUNCHES
                },
                "losses": losses[-5:],
                "quantize": args.quantize,
                "bits": args.quantize_bits if args.quantize else None,
                "committed_steps": len(step_ms),
                "step_ms": step_ms,
                "median_step_ms": statistics.median(steady) if steady else None,
                "median_phase_ms": {
                    k: statistics.median(v[1:] or v) if v else None
                    for k, v in phase_ms.items()
                },
                "images_per_step": B,
                "batch_stats_sha": stats_sha,
                # Each durable snapshot's host copy and write seconds, bytes.
                "durable_saves": ckpt.saves if ckpt is not None else [],
            }
            with open(
                os.path.join(args.result_dir, f"group{replica_group}.json"), "w"
            ) as f:
                json.dump(result, f)
        print(f"[group {replica_group}] done at step {manager.current_step()}")
        return 0
    finally:
        if ckpt is not None:
            ckpt.close()
        manager.shutdown()


if __name__ == "__main__":
    sys.exit(main())
