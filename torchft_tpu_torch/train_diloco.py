"""Streaming DiLoCo training of the Llama decoder, one device per replica
group: the PyTorch twin of the repo root's ``train_diloco.py``.

Each replica group runs ``--sync-every`` *inner* steps (AdamW, mean
next-token cross entropy) on its own device, then exchanges fragment
pseudogradients with the other groups through the Manager. Fragments sync
round-robin with ``--fragment-sync-delay`` inner steps of overlap, and a
failed sync rolls the fragment back to the last global state instead of
crashing the job. The global state (fragment backups and the outer
optimizer) lives on the host; a killed group restarts, heals it from a
healthy peer, and every group that commits outer step k holds the same
global state, bit for bit (``global_sha`` in ``--result-dir``).

Run two replica groups against one lighthouse (both may share one card)::

    torchft_tpu/_cpp/bin/lighthouse --min-replicas 2 --port 29510 &
    for i in 0 1; do
      TORCHFT_LIGHTHOUSE=127.0.0.1:29510 REPLICA_GROUP_ID=$i \\
      python -m torchft_tpu_torch.train_diloco --min-replicas 2 \\
          --outer-steps 10 --result-dir out &
    done

Each group draws its tokens from a ``torch.Generator`` on its device seeded
by ``group_data_seed(group)`` and the inner step, so a relaunched group
replays its stream. ``--quantize`` quantizes the pseudogradients on the
host, as the JAX package does.

``--durable-dir DIR`` (``--durable-every N`` outer steps, default 10) adds
durable snapshots (``checkpointing/durable.py``) under ``DIR/group<id>``:
the global state (``DiLoCo.state_dict``), the inner params and AdamW state,
the position in the group's inner stream and the manager's step, at
committed syncs on the cadence and at a SIGTERM drain. At boot the inner
state restores over the fragment reset and the inner stream resumes where
the snapshot left it.

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
from typing import Dict, Iterable, List

import numpy as np
import torch
import torch.nn.functional as F

from torchft_tpu_torch._train_common import (
    DurableRegime,
    drain_signal,
    group_data_seed,
    trainer_device,
)


def _parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m torchft_tpu_torch.train_diloco")
    parser.add_argument("--steps", type=int, default=200, help="inner steps")
    parser.add_argument(
        "--outer-steps", type=int, default=0,
        help="if >0, run until manager.current_step() reaches this OUTER "
        "step instead of a fixed inner count — the restart-safe loop (a "
        "relaunched incarnation's inner counter restarts, but every "
        "incarnation converges to the same outer target)",
    )
    parser.add_argument(
        "--result-dir", type=str, default=None,
        help="write group{REPLICA_GROUP_ID}.json with a sha256 over the "
        "GLOBAL state (fragment backups + outer optimizer) at exit — the "
        "cross-group bitwise-equality contract",
    )
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=64)
    parser.add_argument("--inner-lr", type=float, default=3e-4)
    parser.add_argument("--outer-lr", type=float, default=0.7)
    parser.add_argument("--sync-every", type=int, default=20)
    parser.add_argument("--n-fragments", type=int, default=2)
    parser.add_argument("--fragment-sync-delay", type=int, default=2)
    parser.add_argument("--fragment-update-alpha", type=float, default=0.0,
                        help="weight of LOCAL params in the post-commit merge")
    parser.add_argument("--min-replicas", type=int, default=1)
    parser.add_argument("--quantize", action="store_true")
    parser.add_argument(
        "--quantize-bits", type=int, default=8, choices=(8, 4),
        help="wire width for --quantize (4 = nibble-packed, half the bytes)",
    )
    parser.add_argument(
        "--error-feedback", action="store_true",
        help="carry quantization residuals into the next sync "
        "(recommended with --quantize-bits 4)",
    )
    parser.add_argument(
        "--drain-on-sigterm", action=argparse.BooleanOptionalAction,
        default=True,
        help="on SIGTERM (maintenance event / preemption), finish the inner "
        "step, gracefully leave the quorum at an outer boundary, exit 0",
    )
    parser.add_argument(
        "--durable-dir", type=str, default=None,
        help="durable-snapshot directory (a group<id> subdirectory is "
        "added): snapshots at committed syncs on the --durable-every "
        "OUTER-step cadence and at a drain, restored at boot",
    )
    parser.add_argument("--durable-every", type=int, default=10)
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device of this replica group (default cuda)",
    )
    return parser.parse_args(argv)


def inner_optimizer(
    params: Iterable[torch.nn.Parameter], lr: float
) -> torch.optim.AdamW:
    """AdamW with ``optax.adamw(lr)``'s defaults: b1 0.9, b2 0.999, eps
    1e-8, decoupled weight decay 1e-4 on every parameter."""
    return torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


def inner_tokens(
    key, batch_size: int, seq_len: int, vocab_size: int, device: torch.device
) -> torch.Tensor:
    """The inner step's tokens [batch_size, seq_len], uniform over the
    vocab, from a generator on ``device`` seeded by ``key`` (the group's
    data seed and the inner step) mixed into 32 bits: the CPU generator
    keeps only a seed's low 32 bits, so a seed that put the group in the
    high bits would hand every group the same batches there."""
    seed = int(np.random.SeedSequence(key).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(
        0, vocab_size, (batch_size, seq_len), generator=gen, device=device
    )


def inner_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    x: torch.Tensor,
    y: torch.Tensor,
) -> torch.Tensor:
    """One inner step: mean softmax cross entropy of ``model(x)`` against
    ``y`` over every position, backward, AdamW apply. Returns the loss."""
    optimizer.zero_grad(set_to_none=True)
    logits = model(x)
    loss = F.cross_entropy(logits.flatten(0, 1), y.flatten())
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_fragment(params: Dict[str, torch.nn.Parameter], names: List[str]):
    """A DiLoCo fragment ``(keys, get_fn, set_fn)`` over the named live
    parameters: get returns the tensors, set copies host arrays into them
    in place (on their device and dtype)."""

    def get() -> Dict[str, torch.Tensor]:
        return {n: params[n] for n in names}

    def set_(values) -> None:
        with torch.no_grad():
            for n in names:
                params[n].copy_(torch.as_tensor(values[n]))

    return (names, get, set_)


def global_sha(diloco) -> str:
    """sha256 over the GLOBAL state: each fragment's backup (names sorted)
    and then its outer optimizer state, as float32 bytes."""
    h = hashlib.sha256()

    def leaves(tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k])
        else:
            yield tree

    for frag in diloco.fragments:
        for name in sorted(frag.keys):
            h.update(np.ascontiguousarray(frag._backup[name], np.float32).tobytes())
        for leaf in leaves(frag._opt_state):
            h.update(np.ascontiguousarray(leaf, np.float32).tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    args = _parse(argv)
    logging.basicConfig(level=logging.INFO)
    replica_group = os.environ.get("REPLICA_GROUP_ID", "0")
    # Late-bound: filled with manager.abort_pending_quorum once the Manager
    # exists, so a SIGTERM landing while this process is blocked in a sync
    # quorum wait interrupts the wait instead of riding it out.
    abort_hook = [lambda: None]
    sigterm_drain = drain_signal(
        args.drain_on_sigterm, on_signal=lambda: abort_hook[0]()
    )

    from torchft_tpu_torch import telemetry
    from torchft_tpu_torch.coordination import RequestAborted
    from torchft_tpu_torch.local_sgd import SGD, DiLoCo, partition_fragments
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import Transformer, llama_debug
    from torchft_tpu_torch.ops import flash_attention, quantization
    from torchft_tpu_torch.optim import (
        load_optimizer_state_dict,
        optimizer_state_dict,
    )
    from torchft_tpu_torch.process_group import make_process_group

    device = trainer_device(args.device, "train_diloco")
    cfg = llama_debug()
    torch.manual_seed(0)  # same initial weights in every group
    model = Transformer(cfg).to(device)
    optimizer = inner_optimizer(model.parameters(), args.inner_lr)
    params = dict(model.named_parameters())

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    groups = partition_fragments(params, args.n_fragments)
    manager = Manager(
        pg=make_process_group(timeout=30.0),
        min_replica_size=args.min_replicas,
        use_async_quorum=False,  # DiLoCo requires a sync quorum
        replica_id=f"train_diloco_{replica_group}",
        group_rank=0,
        group_world_size=1,
    )
    abort_hook[0] = manager.abort_pending_quorum
    diloco = DiLoCo(
        manager,
        [make_fragment(params, g) for g in groups],
        sync_every=args.sync_every,
        outer_optimizer=SGD(args.outer_lr, momentum=0.9, nesterov=True),
        fragment_sync_delay=args.fragment_sync_delay,
        fragment_update_alpha=args.fragment_update_alpha,
        should_quantize=args.quantize,
        quantize_bits=args.quantize_bits,
        error_feedback=args.error_feedback,
    )

    # Step-addressed data stream: stable across incarnations, resumable.
    data_seed = group_data_seed(replica_group)
    metrics = telemetry.get_metrics_logger()

    # Durable regime: the global state (fragment backups + outer optimizer),
    # this group's inner params and AdamW state, the next inner step of its
    # stream, and the manager's step. Snapshots happen with no sync in
    # flight (at committed syncs, and at a drain, which may land mid-window:
    # the inner params then sit a few inner steps past the fragment
    # backups), so restore needs no in-flight-sync handling.
    ckpt = None
    next_inner = [0]

    def durable_state():
        return {
            "diloco": diloco.state_dict(),
            "inner": optimizer_state_dict(optimizer, device=True),
            "inner_step": next_inner[0],
            "manager": manager.state_dict(),
        }

    if args.durable_dir:
        ckpt = DurableRegime(
            args.durable_dir, replica_group, every=args.durable_every
        )
        snap = ckpt.restore_if_any()
        if snap is not None:
            diloco.load_state_dict(snap["diloco"])
            # The inner state restores OVER the fragment reset: the saved
            # inner params may sit ahead of the fragment backups (a drain
            # snapshot taken mid-window).
            load_optimizer_state_dict(optimizer, snap["inner"])
            next_inner[0] = int(snap["inner_step"])
            ckpt.restore_manager(manager, snap)
            ckpt.log_resumed(manager.current_step())

    def inner_iter():
        i = next_inner[0]
        if args.outer_steps > 0:
            while manager.current_step() < args.outer_steps:
                yield i
                i += 1
        else:
            yield from range(i, args.steps)

    drained = False

    def maybe_drain() -> bool:
        # Drain whenever NO sync is in flight: the leave never abandons a
        # collective peers are counting on, and never WAITS for a future
        # sync either (that sync needs a quorum that may never form again
        # when every group is draining). Checked right before diloco.step(),
        # the call that may block on a new quorum.
        if not (sigterm_drain() or manager.drain_requested()):
            return False
        if diloco.sync_in_flight:
            return False
        print(
            f"[group {replica_group}] draining at outer step "
            f"{manager.current_step()} "
            f"({'SIGTERM' if sigterm_drain() else 'operator request'})",
            flush=True,
        )
        manager.leave()
        if ckpt is not None:
            ckpt.on_drain(manager.current_step(), durable_state)
        return True

    losses: List[float] = []
    inner_ms: List[float] = []
    sync_ms: List[float] = []
    try:
        for inner in inner_iter():
            telemetry.trace_window(inner)
            x = inner_tokens(
                (data_seed, inner), args.batch_size, args.seq_len,
                cfg.vocab_size, device,
            )
            y = torch.roll(x, -1, 1)
            t0 = time.perf_counter()
            loss = inner_step(model, optimizer, x, y)
            sync()
            t1 = time.perf_counter()
            inner_ms.append((t1 - t0) * 1e3)
            next_inner[0] = inner + 1
            if maybe_drain():
                drained = True
                break
            try:
                committed = diloco.step()
            except RequestAborted:
                # A SIGTERM mid-wait aborted the blocked quorum: start_quorum
                # raised BEFORE the fragment prepared, so no sync is in
                # flight and the global state is the untouched last
                # boundary. Only this exception resolves to a drain.
                if maybe_drain():
                    drained = True
                    break
                raise
            if committed is not None:
                sync()
                sync_ms.append((time.perf_counter() - t1) * 1e3)
                losses.append(float(loss))
                print(
                    f"[group {replica_group}] inner={inner} outer_step="
                    f"{manager.current_step()} loss={losses[-1]:.4f} "
                    f"committed={committed} "
                    f"participants={manager.num_participants()}",
                    flush=True,
                )
                if metrics is not None:
                    metrics.log(
                        manager.current_step(),
                        loss=losses[-1],
                        num_participants=manager.num_participants(),
                        committed=float(committed),
                        inner_step=inner,
                    )
                if ckpt is not None and committed:
                    ckpt.on_commit(manager.current_step(), durable_state)
                if maybe_drain():
                    drained = True
                    break

        if ckpt is not None:
            ckpt.close()  # every snapshot on disk before the result is written
        final_outer = manager.current_step()
        if args.result_dir:
            os.makedirs(args.result_dir, exist_ok=True)
            # Steady state only: a process's first inner step also pays its
            # one-time set-up (allocator, kernel selection).
            steady = inner_ms[1:] or inner_ms
            result = {
                "final_outer_step": final_outer,
                "global_sha": global_sha(diloco),
                "drained": drained,
                "device": str(device),
                "kernel_launches": {
                    **flash_attention.LAUNCHES, **quantization.LAUNCHES
                },
                "losses": losses[-5:],
                "inner_steps": len(inner_ms),
                "syncs": len(sync_ms),
                "median_inner_ms": statistics.median(steady) if steady else None,
                "median_sync_ms": statistics.median(sync_ms) if sync_ms else None,
                "tokens_per_inner_step": args.batch_size * args.seq_len,
                # Each durable snapshot's host copy and write seconds, bytes.
                "durable_saves": ckpt.saves if ckpt is not None else [],
            }
            with open(
                os.path.join(args.result_dir, f"group{replica_group}.json"), "w"
            ) as f:
                json.dump(result, f)
        print(f"[group {replica_group}] done at outer step {final_outer}", flush=True)
        return 0
    finally:
        if ckpt is not None:
            ckpt.close()
        manager.shutdown()


if __name__ == "__main__":
    sys.exit(main())
