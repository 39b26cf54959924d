"""Fault-tolerant HSDP training of the Llama decoder: the PyTorch twin of
the repo root's ``train_hsdp.py`` loop.

A replica group is ``WORLD_SIZE`` processes, one device each, launched as
torchrun launches them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; default
one process; ``--device cuda`` takes the card ``LOCAL_RANK`` names). Their
torch world rendezvouses at ``GROUP_INIT_METHOD``
(``parallel.mesh.init_group``; ``MASTER_PORT`` is rank 0's Manager store).
The group's mesh is the JAX trainer's for that many devices
(``parallel.mesh.group_mesh``): ``auto_mesh(WORLD_SIZE)`` for the dense
models (2 ranks: fsdp 2; 4: fsdp 2 x tp 2; 8: fsdp 2 x tp 2 x sp 2),
``make_mesh(pp=2, dp=n/2)`` for ``--model pipeline`` on an even world, ep
2 for ``--model moe`` (2 ranks: ep 2; 4: fsdp 2 x ep 2; 8: fsdp 2 x ep 2 x
tp 2). Every axis is a process axis: the state is born
sharded over the ranks (``parallel.train.init_train_state``: FSDP2 over
(dp, fsdp), the tensor-parallel plan over (ep, tp), replicated over sp, a
pipeline stage's layers at each pp coordinate) and each rank takes its
block of every step's global batch (its rows over (dp, fsdp), its sequence
block over sp). A mesh that does not split the model (``--model moe`` at
6 ranks: ep 2 x tp 3, and 4 heads do not split over 3) raises
``ValueError`` before any rendezvous.

Per step: ``manager.start_quorum()``, the grad step, the replica-axis
gradient average (``ManagedMesh.allreduce_grads``, which delegates to
``DistributedDataParallel.allreduce_grads``: each rank averages its own
shards with the same rank of the other groups), the fenced
``manager.should_commit()``, and the AdamW apply. A killed group restarts
(every rank), each rank heals its shards of the params + optimizer state
from the same rank of a healthy group (host numpy over the HTTP checkpoint
transport) and rejoins; groups that commit step k hold bitwise-identical
parameters.

Run two replica groups of one rank against one lighthouse (both may share
one card)::

    torchft_tpu/_cpp/bin/lighthouse --min-replicas 2 --port 29510 &
    for i in 0 1; do
      TORCHFT_LIGHTHOUSE=127.0.0.1:29510 REPLICA_GROUP_ID=$i \\
      python -m torchft_tpu_torch.train_hsdp --model small --attn flash \\
          --batch 8 --seq 1024 --min-replicas 2 --steps 8 --result-dir out &
    done

Two ranks a group on the CPU (gloo), each rank its own process::

    for r in 0 1; do
      TORCHFT_LIGHTHOUSE=127.0.0.1:29510 REPLICA_GROUP_ID=0 RANK=$r \
      WORLD_SIZE=2 LOCAL_RANK=$r MASTER_PORT=29520 \
      GROUP_INIT_METHOD=tcp://127.0.0.1:29521 \
      python -m torchft_tpu_torch.train_hsdp --device cpu --steps 8 &
    done

``--attn ring`` runs attention as ring attention over the mesh's ``sp``
axis (``parallel/ring_attention.py``); at ``sp`` 1 each layer folds one
block with the offset-block flash kernels, as the JAX trainer does on one
chip. ``--attn ulysses`` runs the all-to-all mode (``parallel/ulysses.py``);
at ``sp`` 1 each layer is one whole-sequence attention, the flash kernels
from S >= 1024 (the Ulysses gate). At ``sp`` above 1 the default and flash
attention gather k and v over the ``sp`` ranks
(``ring_attention.gathered_attention``).

``--model moe`` trains ``llama_moe_debug`` (4 experts, top-2, the router's
aux loss in the loss); ``--model pipeline`` trains ``llama_debug`` with 4
layers through the GPipe schedule (``parallel/pipeline.py``) in 2
microbatches over the mesh's ``pp`` axis: on an even world each rank holds
and runs one stage, and a group of one rank runs the whole pipeline.

``--quantize`` (``--quantize-bits 4`` for int4) quantizes the replica-axis
gradient allreduce: on CUDA gradients with the CUDA kernels of
``ops/quantization.py`` before the device->host pull, on CPU gradients with
the host quantizer (the same wire bytes). Every group must pass the same
flags.

``--ckpt-transport pg-sharded`` heals over the process group instead of
HTTP (``checkpointing/pg_transport.py`` with ``sharded=True``): params and
AdamW state stay torch tensors on the card end to end; the sender pulls one
leaf at a time and the receiver builds each leaf as a fresh tensor on its
own device, which the main thread loads at the next step.

``--durable-dir DIR`` (``--durable-every N``, default 10) adds durable
snapshots (``checkpointing/durable.py``) under ``DIR/group<id>/rank<r>``
(each rank its own shards): params,
AdamW state and the manager's step every N committed steps and at a
SIGTERM drain, restored at boot through the heal loader, so a job whose
every group was preempted resumes where it drained
(``drill.preempt_all_drill``).

Each rank writes its result JSON (``group<id>.json`` for rank 0,
``group<id>_rank<r>.json`` for the others); ``param_sha256`` is taken over
the gathered full parameters in ``named_parameters`` order, so it means
the same at every group size.

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

from torchft_tpu_torch._train_common import (
    DurableRegime,
    drain_signal,
    perf_note_step,
    perf_step_suffix,
    trainer_device,
)


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
        "'ring': ring attention over the mesh's sp axis (the CUDA block "
        "kernels for shards of 256 tokens or more); 'ulysses': all-to-all "
        "between sequence and heads over sp (the flash kernels from a "
        "whole sequence of 1024); 'default' keeps the model preset's impl",
    )
    parser.add_argument("--quantize-bits", type=int, default=8, choices=(8, 4))
    parser.add_argument(
        "--ckpt-transport", choices=["http", "pg-sharded"], default="http",
        help="heal transport: 'http' (host numpy) or 'pg-sharded' (the "
        "tensors leaf by leaf over the process group, built on the device)",
    )
    parser.add_argument("--result-dir", type=str, default=None)
    parser.add_argument(
        "--drain-on-sigterm", action=argparse.BooleanOptionalAction,
        default=True,
        help="on SIGTERM, finish the step, leave the quorum, exit 0",
    )
    parser.add_argument(
        "--durable-dir", type=str, default=None,
        help="durable-snapshot directory (a group<id> subdirectory is "
        "added): snapshots on the --durable-every cadence and at a drain, "
        "restored at boot",
    )
    parser.add_argument("--durable-every", type=int, default=10)
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device of this replica group (default cuda)",
    )
    return parser.parse_args(argv)


def _gathered_state(cfg, mesh, params, optimizer) -> tuple:
    """(parameters, AdamW state leaves) of the whole model as host numpy,
    in the whole model's ``named_parameters`` order (each parameter's state
    in sorted key order): each DTensor gathered over the group's
    DeviceMesh, and over ``pp`` each stage's layers gathered from the rank
    that holds them (``parallel.pipeline.gather_stages``). Collectives:
    every rank calls it."""
    import torch

    from torchft_tpu_torch.models.llama import Transformer
    from torchft_tpu_torch.parallel.pipeline import gather_stages

    full = {}
    for name, p in params.items():
        full[name] = p.detach().full_tensor()
        for key, v in sorted(optimizer.state[p].items()):
            full[f"{name}/{key}"] = (v.full_tensor() if v.dim() else v).to(full[name].device)
    if mesh.shape["pp"] > 1:
        full = gather_stages(full, mesh, cfg.num_layers)
    with torch.device("meta"):
        whole = Transformer(dataclasses.replace(cfg, attn_impl="dense", attn_fn=None))
    names = [n for n, _ in whole.named_parameters()]
    state = {n: sorted(k for k in full if k.startswith(n + "/")) for n in names}
    return (
        [full[n].cpu().numpy() for n in names],
        [full[k].cpu().numpy() for n in names for k in state[n]],
    )


def main(argv=None) -> int:
    args = _parse(argv)
    logging.basicConfig(level=logging.INFO)
    sigterm_drain = drain_signal(args.drain_on_sigterm)

    import torch
    import torch.distributed as dist

    from torchft_tpu_torch import telemetry
    from torchft_tpu_torch.device_mesh import ft_init_device_mesh
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import llama_debug, llama_moe_debug, llama_small
    from torchft_tpu_torch.ops import flash_attention, quantization
    from torchft_tpu_torch.optim import (
        init_adam_state,
        load_optimizer_state_dict,
        optimizer_state_dict,
    )
    from torchft_tpu_torch.parallel import make_pipeline_loss
    from torchft_tpu_torch.parallel.mesh import group_env, group_mesh, init_group
    from torchft_tpu_torch.parallel.train import (
        check_model_mesh,
        init_train_state,
        make_grad_step,
    )
    from torchft_tpu_torch.process_group import make_process_group

    device = trainer_device(args.device, "train_hsdp")
    group = os.environ.get("REPLICA_GROUP_ID", "0")
    rank, world_size = group_env()
    # The JAX trainer's mesh for this many devices and this model.
    mesh = group_mesh(world_size, rank, device, args.model)
    B, S = args.batch, args.seq
    cfg = {
        "debug": llama_debug,
        "small": llama_small,
        "moe": llama_moe_debug,
        # The JAX trainer's pipeline model (train_hsdp.py), 2 microbatches.
        "pipeline": lambda: llama_debug(num_layers=4),
    }[args.model]()
    if args.attn == "flash":
        # bench.py's flash setting: the kernels from S >= 1024.
        cfg = dataclasses.replace(cfg, attn_impl="flash", flash_min_seq=1024)
    elif args.attn in ("ring", "ulysses"):
        cfg = dataclasses.replace(cfg, attn_impl=args.attn)
    # No block recompute: one replica group's activations at these sizes
    # fit the card, and recompute would run every block's forward (and its
    # attention kernel) twice per step.
    cfg = dataclasses.replace(cfg, remat=False)
    # A mesh that does not split the model raises before any rendezvous.
    check_model_mesh(cfg, mesh)
    init_group(device)
    logging.info(
        "[group %s] rank %d of %d, mesh %s", group, rank, world_size,
        {a: n for a, n in mesh.shape.items() if n > 1} or {"fsdp": 1},
    )
    # The pipeline's loss, built (and its config refused) before the group
    # joins a quorum; None is the chunked loss.
    loss_fn = (
        make_pipeline_loss(cfg, mesh, n_micro=2)
        if args.model == "pipeline" else None
    )

    # Same initial weights in every group, born sharded over its ranks.
    state, _ = init_train_state(cfg, mesh, device, seed=0)
    model, optimizer = state.model, state.optimizer
    grad_step = make_grad_step(state, loss_fn)
    params = dict(model.named_parameters())

    # TORCHFT_PERF: count one grad step's FLOPs (the loop's shapes; model,
    # optimizer and RNG restored) so step logs carry MFU. Each rank counts
    # its own rows. The guard keeps the off path free of the probe batch.
    from torchft_tpu_torch import perf

    if perf.perf_enabled():
        gen = torch.Generator(device=device).manual_seed(2**31)
        probe = torch.randint(
            0, cfg.vocab_size, (B, S), generator=gen, device=device
        )
        perf_note_step(
            "hsdp_grad_step", grad_step,
            {
                "inputs": probe,
                "targets": torch.roll(probe, -1, 1),
                "mask": torch.ones((B, S), dtype=torch.int32, device=device),
            },
            # This rank's tokens: the batch splits over (dp, fsdp) and the
            # sequence over sp; the ep and tp ranks of one block each count
            # their own shards, the pp ranks their own stage.
            tokens_per_step=B * S // (
                mesh.shape["dp"] * mesh.shape["fsdp"] * mesh.shape["sp"]
            ),
            preserve=(model, optimizer),
        )

    # Heal contract. http: the recovering group receives params + AdamW
    # state as host numpy. pg-sharded: they stay tensors on the device end
    # to end; the sender pulls one leaf at a time and the receiver builds
    # each leaf on the device of the matching leaf of ckpt_target().
    sharded_heal = args.ckpt_transport == "pg-sharded"
    pg = make_process_group(timeout=30.0)
    checkpoint_transport = None
    if sharded_heal:
        from torchft_tpu_torch.checkpointing.pg_transport import PGTransport

        # torch's AdamW makes its state at the first step; the receiver's
        # target needs every leaf before that (the same zeros: no bit moves).
        init_adam_state(optimizer)

        def ckpt_target():
            # Structure mirrors Manager._manager_state_dict(); the
            # "torchft" scalars need no device target.
            return {
                "user": {"default": optimizer_state_dict(optimizer, device=True)}
            }

        checkpoint_transport = PGTransport(
            pg, timeout=60.0, state_dict_fn=ckpt_target, sharded=True
        )
    manager = Manager(
        pg=pg,
        checkpoint_transport=checkpoint_transport,
        state_dict=lambda: optimizer_state_dict(optimizer, device=sharded_heal),
        load_state_dict=lambda sd: load_optimizer_state_dict(optimizer, sd),
        min_replica_size=args.min_replicas,
        use_async_quorum=True,
        timeout=60.0,
        quorum_timeout=60.0,
        connect_timeout=30.0,
        max_retries=20,
    )
    mm = ft_init_device_mesh(manager, mesh=mesh)
    # Mesh-relative views, as the JAX trainer logs them: the HSDP selection
    # pairs the dynamic replica axis with the fsdp shard axis; "world"
    # flattens every axis for a composite rank and size.
    hsdp_view = mm[("replica", "fsdp")]
    world = mm.flatten(name="world")
    logging.info(
        "managed mesh: %r; hsdp view %s (size %d); world size %d rank %s",
        mm, hsdp_view.shape(), hsdp_view.size(), world.size(), world.rank(),
    )

    # Durable regime: params + AdamW state + the manager's scalars. Restore
    # goes through the heal loader.
    ckpt = None

    def durable_state_fn():
        return {
            "optimizer": optimizer_state_dict(optimizer, device=True),
            "manager": manager.state_dict(),
        }

    if args.durable_dir:
        ckpt = DurableRegime(
            args.durable_dir, group, every=args.durable_every, rank=rank
        )
        snap = ckpt.restore_if_any()
        if snap is not None:
            load_optimizer_state_dict(optimizer, snap["optimizer"])
            ckpt.restore_manager(manager, snap)
            ckpt.log_resumed(manager.current_step())

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def drain_now() -> bool:
        """Whether to drain at this step boundary. The signal reaches each
        rank on its own; every rank of the group must drain at the same
        boundary (a straggler would wait in FSDP2's collectives for ranks
        that left), so the ranks agree on it first."""
        drain = sigterm_drain() or manager.drain_requested()
        if world_size == 1:
            return drain
        flag = torch.tensor([float(drain)], device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    metrics = telemetry.get_metrics_logger()
    losses = []
    step_ms = []
    # Per committed step, ms: grad step (forward + backward, synchronized),
    # replica-axis allreduce (device->host, wire, host->device; with
    # --quantize also the quantize and dequantize kernels), commit gate +
    # optimizer apply.
    phase_ms = {"grad": [], "allreduce": [], "commit_apply": []}
    drained = False
    # MoE: the routers' gradients of the last committed step.
    router_names = model.router_names()
    router_grads = []
    try:
        while manager.current_step() < args.steps:
            step = manager.current_step()
            if drain_now():
                logging.info(
                    "[group %s] draining at step %d (%s)", group, step,
                    "SIGTERM" if sigterm_drain() else "operator or group request",
                )
                manager.leave()
                if ckpt is not None:
                    ckpt.on_drain(manager.current_step(), durable_state_fn)
                drained = True
                break
            t0 = time.perf_counter()
            telemetry.trace_window(step)
            manager.start_quorum()
            # Deterministic global batch per step: every group that commits
            # step k computes identical params (bitwise) — heal-invariant.
            # Each rank takes its rows of it (make_grad_step).
            gen = torch.Generator(device=device).manual_seed(step)
            inputs = torch.randint(
                0, cfg.vocab_size, (B, S), generator=gen, device=device
            )
            batch = {
                "inputs": inputs,
                "targets": torch.roll(inputs, -1, 1),
                "mask": torch.ones((B, S), dtype=torch.int32, device=device),
            }
            loss, grads = grad_step(batch)
            sync()
            t_grad = time.perf_counter()
            grads = mm.allreduce_grads(
                grads,
                should_quantize=args.quantize,
                quantize_bits=args.quantize_bits,
            )
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
                router_grads = [grads[n] for n in router_names]
                logging.info(
                    "[group %s] step %d loss %.4f participants %d "
                    "step_ms %.1f%s",
                    group, step, losses[-1], manager.num_participants(),
                    step_ms[-1],
                    perf_step_suffix("hsdp_grad_step", t_end - t0),
                )
                if metrics is not None:
                    metrics.log(
                        step,
                        loss=losses[-1],
                        num_participants=manager.num_participants(),
                        committed=1.0,
                    )
                if ckpt is not None:
                    ckpt.on_commit(manager.current_step(), durable_state_fn)
        if ckpt is not None:
            ckpt.close()  # every snapshot on disk before the result is written
        if args.result_dir:
            os.makedirs(args.result_dir, exist_ok=True)
            # The gathered full parameters and AdamW state (collectives:
            # every rank), in the whole model's named_parameters order.
            host, opt_host = _gathered_state(cfg, mesh, params, optimizer)
            # Steady-state steps only: the first committed step of a process
            # also pays one-time set-up (kernel build and load, allocator).
            steady = step_ms[1:] or step_ms
            result = {
                "group": group,
                "rank": rank,
                "world_size": world_size,
                "mesh": mesh.shape,
                "final_step": manager.current_step(),
                "param_l1": float(sum(abs(h).sum() for h in host)),
                "param_sha256": hashlib.sha256(
                    b"".join(h.tobytes() for h in host)
                ).hexdigest(),
                "opt_sha256": hashlib.sha256(
                    b"".join(h.tobytes() for h in opt_host)
                ).hexdigest(),
                "losses": losses[-5:],
                "drained": drained,
                "device": (
                    torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"
                ),
                "kernel_launches": {
                    **flash_attention.LAUNCHES, **quantization.LAUNCHES
                },
                "quantize": args.quantize,
                "bits": args.quantize_bits if args.quantize else None,
                "committed_steps": len(step_ms),
                "step_ms": step_ms,
                "median_step_ms": statistics.median(steady) if steady else None,
                "median_phase_ms": {
                    k: statistics.median(v[1:] or v) if v else None
                    for k, v in phase_ms.items()
                },
                "tokens_per_step": B * S,
                # MoE: sum of |router gradient| of the last committed step.
                "router_grad_l1": (
                    float(sum(g.full_tensor().abs().sum() for g in router_grads))
                    if router_grads else None
                ),
                "ckpt_transport": args.ckpt_transport,
                # Each durable snapshot's host copy and write seconds, bytes.
                "durable_saves": ckpt.saves if ckpt is not None else [],
            }
            name = f"group{group}" + (f"_rank{rank}" if rank else "")
            with open(os.path.join(args.result_dir, f"{name}.json"), "w") as f:
                json.dump(result, f)
        return 0
    finally:
        if ckpt is not None:
            ckpt.close()
        manager.shutdown()
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
