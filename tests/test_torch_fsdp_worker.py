"""The rank side of ``tests/test_torch_fsdp.py``,
``tests/test_torch_tp_ep.py`` and ``tests/test_torch_sp_pp.py``: one
process of a gloo world, run as ``python tests/test_torch_fsdp_worker.py
OUT_DIR [fsdp|tp_ep|sp_pp]`` with ``RANK``, ``WORLD_SIZE`` and
``GROUP_INIT_METHOD`` set (:func:`run_world` starts them). JAX-free:
``tests/conftest.py`` imports JAX, so the ranks run this file as a script,
read their inputs from ``OUT_DIR/inputs.npz`` (parameters made by flax and
carried by ``params_from_jax``, tokens made with numpy) and write what
they computed to ``OUT_DIR/world<n>_rank<r>.npz``, which the pytest
process holds against the JAX package.

Every case runs the port's sharded step on the CPU in fp32. The ``fsdp``
cases run at the world's fsdp size: gradients, train steps at
``accum_steps`` 1, 2 and 4, the eval step, the MoE model, block recompute,
ring and Ulysses attention at sp 1, the GPipe pipeline over ``dp`` (one
stage a rank), the optimizer state's round trip and the sharded heal's
keys. The ``tp_ep`` cases run the group's meshes with tensor and expert
parallelism and the pipeline at pp 2 x dp 2 (:func:`_tp_ep_cases`), the
``sp_pp`` cases sequence and pipeline parallelism across the ranks
(:func:`_sp_pp_cases`)."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict

import numpy as np

# The chunked loss's chunk, read when parallel.train is imported.
LOSS_CHUNK = 32


def run_world(
    world: int, out_dir: Path, timeout_s: float = 240.0, cases: str = "fsdp"
) -> None:
    """Runs ``world`` ranks of this file over ``out_dir`` with ``cases``
    (``fsdp``, ``tp_ep`` or ``sp_pp``) and waits for them; raises with the
    ranks' output if one fails."""
    store = out_dir / f"world{world}.store"
    store.unlink(missing_ok=True)
    repo = Path(__file__).resolve().parent.parent
    env = {
        **os.environ,
        "WORLD_SIZE": str(world),
        "GROUP_INIT_METHOD": f"file://{store.resolve()}",
        "TORCHFT_LOSS_CHUNK": str(LOSS_CHUNK),
        "OMP_NUM_THREADS": "1",
        "PYTHONPATH": os.pathsep.join(
            p for p in (str(repo), os.environ.get("PYTHONPATH", "")) if p
        ),
    }
    procs = []
    for r in range(world):
        log = open(out_dir / f"world{world}_rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(out_dir), cases],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=log, stderr=subprocess.STDOUT,
        ), log))
    deadline = time.monotonic() + timeout_s
    try:
        for proc, _ in procs:
            rc = proc.wait(timeout=max(deadline - time.monotonic(), 1.0))
            if rc != 0:
                raise RuntimeError(_logs(out_dir, world))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def _logs(out_dir: Path, world: int) -> str:
    return "\n".join(
        (out_dir / f"world{world}_rank{r}.log").read_text()[-4000:]
        for r in range(world)
    )


# ---------------------------------------------------------------------------
# The rank side
# ---------------------------------------------------------------------------


def _load_full(model, params: Dict[str, np.ndarray]) -> None:
    """Writes full parameters into a sharded model: each rank its slice."""
    import torch

    from torchft_tpu_torch.parallel.sharding import local_slices

    with torch.no_grad():
        for name, p in model.named_parameters():
            full = torch.from_numpy(params[name])
            p.to_local().copy_(full[local_slices(p)])


def _full(t) -> np.ndarray:
    return t.detach().full_tensor().numpy()


def _params(inputs, prefix: str) -> Dict[str, np.ndarray]:
    return {
        k[len(prefix):]: inputs[k] for k in inputs.files if k.startswith(prefix)
    }


def _batch(inputs):
    import torch

    x = torch.from_numpy(inputs["tokens"]).long()
    return {
        "inputs": x,
        "targets": torch.from_numpy(inputs["targets"]).long(),
        "mask": torch.from_numpy(inputs["mask"]),
    }


def _cases(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    import torch

    from torchft_tpu_torch.checkpointing.sharded import (
        build_sharded_leaf,
        split_state_sharded,
    )
    from torchft_tpu_torch.ddp import DistributedDataParallel
    from torchft_tpu_torch.models import llama_debug, llama_moe_debug
    from torchft_tpu_torch.optim import (
        load_optimizer_state_dict,
        optimizer_state_dict,
    )
    from torchft_tpu_torch.parallel import (
        init_train_state,
        make_eval_step,
        make_mesh,
        make_pipeline_loss,
        make_train_step,
    )
    from torchft_tpu_torch.parallel.mesh import group_mesh
    from torchft_tpu_torch.parallel.train import make_grad_step

    cpu = torch.device("cpu")
    out: Dict[str, np.ndarray] = {}
    batch = _batch(inputs)
    f32 = dict(dtype=torch.float32)

    def state_of(cfg, params, mesh=None):
        mesh = mesh or group_mesh(world, rank, cpu)
        state, _ = init_train_state(cfg, mesh, cpu, seed=0)
        if params is not None:
            _load_full(state.model, params)
        return state

    def grads_case(tag, cfg, params, mesh=None, loss_fn=None):
        state = state_of(cfg, params, mesh)
        loss, grads = make_grad_step(state, loss_fn)(batch)
        out[f"{tag}/loss"] = loss.numpy()
        for name, g in grads.items():
            out[f"{tag}/grad/{name}"] = _full(g)
        return state

    dense = llama_debug(**f32)
    params = _params(inputs, "p/")

    # Born sharded: seed 0's parameters, gathered; the placements
    # state_shardings reports are the ones FSDP2 gave them.
    born, shardings = init_train_state(dense, group_mesh(world, rank, cpu), cpu, seed=0)
    for name, p in born.model.named_parameters():
        out[f"init/{name}"] = _full(p)
    out["shardings"] = np.array(all(
        p.placements == shardings["params"][name]
        and born.optimizer.param_groups[0]["params"][i] is p
        for i, (name, p) in enumerate(born.model.named_parameters())
    ))

    state = grads_case("grad", dense, params)
    out["eval/loss"] = make_eval_step(state)(state, batch).numpy()

    for accum in (1, 2, 4):
        state = state_of(dense, params)
        state, metrics = make_train_step(state, accum_steps=accum)(state, batch)
        out[f"train{accum}/loss"] = metrics["loss"].numpy()
        out[f"train{accum}/grad_norm"] = metrics["grad_norm"].numpy()
        for name, p in state.model.named_parameters():
            out[f"train{accum}/param/{name}"] = _full(p)
            out[f"train{accum}/grad/{name}"] = _full(p.grad)

    # The optimizer state round trip, host and device forms, into a fresh
    # state; a payload of another layout raises.
    state1 = state
    sd_host = optimizer_state_dict(state1.optimizer)
    sd_dev = optimizer_state_dict(state1.optimizer, device=True)
    for form, sd in (("host", sd_host), ("device", sd_dev)):
        fresh = state_of(dense, None)
        load_optimizer_state_dict(fresh.optimizer, sd)
        same = all(
            torch.equal(a.to_local(), b.to_local())
            for a, b in zip(fresh.model.parameters(), state1.model.parameters())
        )
        for a, b in zip(fresh.model.parameters(), state1.model.parameters()):
            sa, sb = fresh.optimizer.state[a], state1.optimizer.state[b]
            same &= set(sa) == set(sb) and all(
                torch.equal(
                    sa[k].to_local() if sa[k].dim() else sa[k],
                    sb[k].to_local() if sb[k].dim() else sb[k],
                )
                and type(sa[k]) is type(sb[k])
                for k in sa
            )
        out[f"opt_roundtrip/{form}"] = np.array(same)
    bad = dict(sd_host, layout=dict(sd_host["layout"]))
    key = next(iter(bad["layout"]))
    bad["layout"][key] = tuple((a + 1, b + 1) for a, b in bad["layout"][key])
    try:
        load_optimizer_state_dict(state_of(dense, None).optimizer, bad)
        out["opt_mismatch_raises"] = np.array(False)
    except ValueError:
        out["opt_mismatch_raises"] = np.array(True)

    # The replica average over DTensor shards, with a stand-in Manager
    # whose peer group holds 3x this group's gradients: the average is 2x.
    class _Work:
        def __init__(self, value):
            self.value = value

        def wait(self):
            return self.value if isinstance(self.value, list) else [self.value]

    class _Manager:
        def allreduce(self, x, should_quantize=False, quantize_bits=8, **_):
            if isinstance(x, list):
                return _Work([t * 2 for t in x])
            return _Work(x * 2)

    grads = {n: p.grad for n, p in state1.model.named_parameters()}
    os.environ["TORCHFT_FORCE_DEVICE_QUANT"] = "1"
    for tag, quant in (("fp32", False), ("int8", True)):
        avg = DistributedDataParallel(_Manager()).allreduce_grads(
            grads, should_quantize=quant
        )
        ok = list(avg) == list(grads) and all(
            type(avg[n]) is type(g) and avg[n].placements == g.placements
            and torch.equal(avg[n].full_tensor(), 2 * g.full_tensor())
            for n, g in grads.items()
        )
        out[f"allreduce/{tag}"] = np.array(ok)
    del os.environ["TORCHFT_FORCE_DEVICE_QUANT"]

    # The sharded heal's keys for a [8, 16] leaf over fsdp; a target of
    # another layout refuses.
    from torch.distributed.tensor import DTensor, Shard

    dmesh = state1.device_mesh["fsdp"]
    full = torch.arange(128, dtype=torch.float32).reshape(8, 16)
    leaf = DTensor.from_local(
        full.chunk(world, 0)[rank].clone(), dmesh, (Shard(0),)
    )
    meta, bufs = split_state_sharded({"w": leaf})
    out["heal/keys"] = np.array(repr(meta["w"].keys))
    built = build_sharded_leaf(meta["w"], bufs, leaf)
    out["heal/rebuilt"] = np.array(
        torch.equal(built.full_tensor(), full) and built.placements == leaf.placements
        and built.to_local().data_ptr() != leaf.to_local().data_ptr()
    )
    other = DTensor.from_local(
        full.chunk(world, 1)[rank].clone(), dmesh, (Shard(1),)
    )
    try:
        build_sharded_leaf(meta["w"], bufs, other)
        out["heal/mismatch_raises"] = np.array(world == 1)
    except ValueError:
        out["heal/mismatch_raises"] = np.array(True)

    # The MoE model, block recompute, and ring and Ulysses at the group's
    # fsdp mesh (sp 1: each rank's ring folds its one block; the ring and
    # Ulysses across sp ranks are the sp_pp cases).
    grads_case("moe", llama_moe_debug(**f32), _params(inputs, "moe/"))
    grads_case("remat", llama_debug(remat=True, **f32), params)
    for attn in ("ring", "ulysses"):
        grads_case(attn, llama_debug(attn_impl=attn, **f32), params)

    # GPipe over dp (each rank pipelines its rows), one stage a rank, 2
    # microbatches.
    pcfg = llama_debug(num_layers=4, **f32)
    mesh = make_mesh(dp=world, devices=[cpu] * world)
    mesh.process_rank = rank
    grads_case(
        "pipeline", pcfg, _params(inputs, "pipe/"), mesh,
        make_pipeline_loss(pcfg, mesh, n_micro=2),
    )
    return out


def _sp_pp_cases(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    """Sequence and pipeline parallelism across the ranks: at world 2
    llama_debug at ``make_mesh(sp=2)`` with the default attention (k and
    v gathered), ring and Ulysses (gradients; the default also one train
    step), the 4-layer llama_debug at ``make_mesh(pp=2)`` (gradients and
    one AdamW step, 2 microbatches) and the heal's keys over sp and pp; at
    world 8 llama_debug at ``auto_mesh(8)``, fsdp 2 x tp 2 x sp 2, with the
    default attention, ring and Ulysses (gradients), and llama_moe_debug at
    the JAX trainer's MoE mesh for eight devices, fsdp 2 x ep 2 x tp 2
    (:func:`_moe_ep_tp_case`)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from torchft_tpu_torch.checkpointing.sharded import split_state_sharded
    from torchft_tpu_torch.models import llama_debug
    from torchft_tpu_torch.parallel import (
        init_train_state,
        make_mesh,
        make_pipeline_loss,
        make_train_step,
    )
    from torchft_tpu_torch.parallel.mesh import group_mesh
    from torchft_tpu_torch.parallel.train import make_grad_step

    cpu = torch.device("cpu")
    out: Dict[str, np.ndarray] = {}
    batch = _batch(inputs)
    f32 = dict(dtype=torch.float32)
    params = _params(inputs, "p/")

    def state_of(cfg, params, mesh):
        state, _ = init_train_state(cfg, mesh, cpu, seed=0)
        _load_full(state.model, params)
        return state

    def record(tag, state, loss, grads):
        out[f"{tag}/loss"] = np.asarray(float(loss))
        out[f"{tag}/mesh"] = np.array(repr(state.mesh.shape))
        for name, g in grads.items():
            out[f"{tag}/grad/{name}"] = _full(g)

    if world == 8:
        mesh = group_mesh(world, rank, cpu)
        for attn in ("dense", "ring", "ulysses"):
            state = state_of(llama_debug(attn_impl=attn, **f32), params, mesh)
            record(f"sp/{attn}", state, *make_grad_step(state)(batch))
        # A [8, 16] leaf over fsdp (dim 0) and tp (dim 1), replicated over
        # sp (the DeviceMesh's dp dim): the heal's keys.
        c = mesh.process_coordinate()
        full = torch.arange(128, dtype=torch.float32).reshape(8, 16)
        leaf = DTensor.from_local(
            full.chunk(2, 0)[c["fsdp"]].chunk(2, 1)[c["tp"]].clone(),
            state.device_mesh, (Replicate(), Shard(0), Shard(1)),
        )
        out["heal/keys"] = np.array(repr(split_state_sharded({"w": leaf})[0]["w"].keys))
        out.update(_moe_ep_tp_case(inputs, rank, world))
        return out

    mesh = make_mesh(sp=2, devices=[cpu] * 2)
    mesh.process_rank = rank
    for attn in ("dense", "ring", "ulysses"):
        state = state_of(llama_debug(attn_impl=attn, **f32), params, mesh)
        record(f"sp/{attn}", state, *make_grad_step(state)(batch))
    state = state_of(llama_debug(**f32), params, mesh)
    state, metrics = make_train_step(state)(state, batch)
    out["sp_train/loss"] = metrics["loss"].numpy()
    out["sp_train/grad_norm"] = metrics["grad_norm"].numpy()
    for name, p in state.model.named_parameters():
        out[f"sp_train/param/{name}"] = _full(p)
        out[f"sp_train/grad/{name}"] = _full(p.grad)
    # A leaf replicated over sp (the DeviceMesh's dp and fsdp dims): each
    # rank's one shard is the whole leaf.
    leaf = DTensor.from_local(
        torch.zeros(8, 16), state.device_mesh, (Replicate(), Replicate())
    )
    out["heal/sp_keys"] = np.array(repr(split_state_sharded({"w": leaf})[0]["w"].keys))

    pcfg = llama_debug(num_layers=4, **f32)
    mesh = group_mesh(world, rank, cpu, "pipeline")
    state = state_of(pcfg, _params(inputs, "pipe/"), mesh)
    loss, grads = make_grad_step(state, make_pipeline_loss(pcfg, mesh, n_micro=2))(batch)
    record("pp", state, loss, grads)
    state.optimizer.step()
    for name, p in state.model.named_parameters():
        out[f"pp_train/param/{name}"] = _full(p)
    # The heal's keys of this stage's state: every leaf whole, one layer a
    # leaf, the stage's layers only.
    meta, _ = split_state_sharded(dict(state.model.named_parameters()))
    out["heal/pp_layers"] = np.array(sorted({
        int(n.split(".")[1]) for n in meta if n.startswith("layers.")
    }))
    out["heal/pp_whole"] = np.array(all(
        ref.keys == [tuple(("s", None, None, None) for _ in ref.global_shape)]
        for ref in meta.values()
    ))
    return out


def _moe_ep_tp_case(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    """llama_moe_debug at ``group_mesh(8, rank, cpu, "moe")``, fsdp 2 x ep
    2 x tp 2: the gradients, with the sha of every MoE layer's router input
    on this rank; one train step (its loss, global gradient norm, and the
    norm of the gathered gradients computed here, which pins the norm's
    weighting of the ep-replicated attention), its parameters and
    gradients; and the heal's keys for an expert-like [4, 8, 16] leaf over
    (ep, fsdp, tp), dims 0, 1, 2, and an attention-like [8, 16] leaf
    sharded over tp and fsdp, replicated over ep."""
    import hashlib

    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from torchft_tpu_torch.checkpointing.sharded import split_state_sharded
    from torchft_tpu_torch.models import llama_moe_debug
    from torchft_tpu_torch.models.llama import MoEMLP
    from torchft_tpu_torch.parallel import init_train_state, make_train_step
    from torchft_tpu_torch.parallel.mesh import group_mesh
    from torchft_tpu_torch.parallel.train import make_grad_step

    cpu = torch.device("cpu")
    out: Dict[str, np.ndarray] = {}
    batch = _batch(inputs)
    cfg = llama_moe_debug(dtype=torch.float32)
    params = _params(inputs, "moe/")
    mesh = group_mesh(world, rank, cpu, "moe")

    def state_of():
        state, _ = init_train_state(cfg, mesh, cpu, seed=0)
        _load_full(state.model, params)
        return state

    state = state_of()
    shas = []
    for m in state.model.modules():
        if isinstance(m, MoEMLP):
            m.register_forward_pre_hook(lambda _, args: shas.append(
                hashlib.sha256(args[0].detach().contiguous().numpy().tobytes()).hexdigest()
            ))
    loss, grads = make_grad_step(state)(batch)
    out["moe/loss"] = np.asarray(float(loss))
    out["moe/mesh"] = np.array(repr(mesh.shape))
    out["moe/router_sha"] = np.array(repr(shas))
    for name, g in grads.items():
        out[f"moe/grad/{name}"] = _full(g)

    state = state_of()
    state, metrics = make_train_step(state)(state, batch)
    out["moe_train/loss"] = metrics["loss"].numpy()
    out["moe_train/grad_norm"] = metrics["grad_norm"].numpy()
    gathered = 0.0
    for name, p in state.model.named_parameters():
        out[f"moe_train/param/{name}"] = _full(p)
        out[f"moe_train/grad/{name}"] = g = _full(p.grad)
        gathered += float(np.square(g.astype(np.float64)).sum())
    out["moe_train/grad_norm_gathered"] = np.asarray(gathered ** 0.5)

    c = mesh.process_coordinate()
    full = torch.arange(512, dtype=torch.float32).reshape(4, 8, 16)
    experts = DTensor.from_local(
        full.chunk(2, 0)[c["ep"]].chunk(2, 1)[c["fsdp"]].chunk(2, 2)[c["tp"]].clone(),
        state.device_mesh, (Shard(1), Shard(0), Shard(2)),
    )
    attn = DTensor.from_local(
        full[0].chunk(2, 1)[c["fsdp"]].chunk(2, 0)[c["tp"]].clone(),
        state.device_mesh, (Shard(1), Replicate(), Shard(0)),
    )
    meta, _ = split_state_sharded({"experts": experts, "attn": attn})
    out["heal/moe_keys"] = np.array(repr({k: meta[k].keys for k in meta}))
    return out


def _tp_ep_cases(inputs, rank: int, world: int) -> Dict[str, np.ndarray]:
    """The JAX trainer's meshes with tensor and expert parallelism: at
    world 4 llama_debug at fsdp 2 x tp 2 (the born-sharded parameters, the
    placements, gradients, train steps at ``accum_steps`` 1 and 2, the eval
    step, the full logits, one grad step's counted FLOPs, the replica
    average and the heal over 2-D placements) and
    llama_moe_debug at fsdp 2 x ep 2; at world 2 llama_moe_debug at ep 2."""
    import torch
    from torch.distributed.tensor import DTensor, Shard

    from torchft_tpu_torch.checkpointing.sharded import (
        build_sharded_leaf,
        split_state_sharded,
    )
    from torchft_tpu_torch.models import llama_debug, llama_moe_debug
    from torchft_tpu_torch.parallel import init_train_state, make_eval_step, make_train_step
    from torchft_tpu_torch.parallel.mesh import group_mesh
    from torchft_tpu_torch.parallel.train import make_grad_step

    cpu = torch.device("cpu")
    out: Dict[str, np.ndarray] = {}
    batch = _batch(inputs)
    f32 = dict(dtype=torch.float32)

    def state_of(cfg, params, moe=False):
        state, _ = init_train_state(cfg, group_mesh(world, rank, cpu, "moe" if moe else "dense"), cpu, seed=0)
        _load_full(state.model, params)
        return state

    def grads_case(tag, cfg, params, moe=False):
        state = state_of(cfg, params, moe)
        loss, grads = make_grad_step(state)(batch)
        out[f"{tag}/loss"] = loss.numpy()
        for name, g in grads.items():
            out[f"{tag}/grad/{name}"] = _full(g)
        out[f"{tag}/mesh"] = np.array(repr(state.mesh.shape))
        return state

    grads_case("moe", llama_moe_debug(**f32), _params(inputs, "moe/"), moe=True)
    if world == 2:
        return out

    dense = llama_debug(**f32)
    params = _params(inputs, "p/")
    born, shardings = init_train_state(dense, group_mesh(world, rank, cpu), cpu, seed=0)
    for name, p in born.model.named_parameters():
        out[f"init/{name}"] = _full(p)
    out["shardings"] = np.array(all(
        p.placements == shardings["params"][name]
        for name, p in born.model.named_parameters()
    ))
    out["tp_split"] = np.array(
        born.model.layers["0"].attn.wq.weight.to_local().shape
        == (dense.num_heads * dense.head_dim // 2, dense.hidden_size // 2)
    )

    # TORCHFT_PERF's count of one grad step on this rank's rows and shards,
    # on a fresh state, as the trainer counts it.
    from torchft_tpu_torch import perf
    from torchft_tpu_torch.perf import count_step_flops

    state = state_of(dense, params)
    out["perf/flops"] = np.array(count_step_flops(
        make_grad_step(state), batch, preserve=(state.model, state.optimizer)
    )["flops"])
    # The count after an eval step: a forward without gradients leaves
    # FSDP2's root unsharded, and the count must snapshot and restore the
    # sharded parameters. Every parameter and AdamW leaf (after one step,
    # so the moments exist) is as it was before, bit for bit.
    state = state_of(dense, params)
    state, _ = make_train_step(state)(state, batch)

    def leaves(state):
        out = []
        for p in state.model.parameters():
            out.append(p.detach().to_local().clone())
            for _, v in sorted(state.optimizer.state[p].items()):
                out.append((v.to_local() if v.dim() else v).clone())
        return out

    before = leaves(state)
    make_eval_step(state)(state, batch)
    rec = perf.record_step_cost(
        "after_eval", make_grad_step(state), batch, force=True,
        preserve=(state.model, state.optimizer),
    )
    after = leaves(state)
    out["perf/after_eval"] = np.array(
        rec is not None and rec["flops"] > 0 and len(after) == len(before)
        and all(torch.equal(a, b) for a, b in zip(after, before))
    )

    state = grads_case("grad", dense, params)
    out["eval/loss"] = make_eval_step(state)(state, batch).numpy()
    with torch.no_grad():  # the full logits: the head's vocab blocks gathered
        out["logits"] = state.model(batch["inputs"]).numpy()
    for accum in (1, 2):
        state = state_of(dense, params)
        state, metrics = make_train_step(state, accum_steps=accum)(state, batch)
        out[f"train{accum}/loss"] = metrics["loss"].numpy()
        out[f"train{accum}/grad_norm"] = metrics["grad_norm"].numpy()
        for name, p in state.model.named_parameters():
            out[f"train{accum}/param/{name}"] = _full(p)
            out[f"train{accum}/grad/{name}"] = _full(p.grad)

    # The replica average of gradients over (fsdp, tp) placements, with a
    # stand-in Manager whose peer holds 3x this group's gradients.
    from torchft_tpu_torch.ddp import DistributedDataParallel

    class _Work:
        def __init__(self, value):
            self.value = value

        def wait(self):
            return self.value if isinstance(self.value, list) else [self.value]

    class _Manager:
        def allreduce(self, x, should_quantize=False, quantize_bits=8, **_):
            return _Work([t * 2 for t in x] if isinstance(x, list) else x * 2)

    grads = {n: p.grad for n, p in state.model.named_parameters()}
    os.environ["TORCHFT_FORCE_DEVICE_QUANT"] = "1"
    for tag, quant in (("fp32", False), ("int8", True)):
        avg = DistributedDataParallel(_Manager()).allreduce_grads(
            grads, should_quantize=quant
        )
        out[f"allreduce/{tag}"] = np.array(list(avg) == list(grads) and all(
            avg[n].placements == g.placements
            and torch.equal(avg[n].full_tensor(), 2 * g.full_tensor())
            for n, g in grads.items()
        ))
    del os.environ["TORCHFT_FORCE_DEVICE_QUANT"]

    # The sharded heal's keys for a [8, 16] leaf over (fsdp, tp), dims 0
    # and 1; rebuilt as a fresh local shard.
    dmesh = state.device_mesh
    full = torch.arange(128, dtype=torch.float32).reshape(8, 16)
    c = state.mesh.process_coordinate()
    leaf = DTensor.from_local(
        full.chunk(2, 0)[c["fsdp"]].chunk(2, 1)[c["tp"]].clone(), dmesh,
        (Shard(0), Shard(1)),
    )
    meta, bufs = split_state_sharded({"w": leaf})
    out["heal/keys"] = np.array(repr(meta["w"].keys))
    built = build_sharded_leaf(meta["w"], bufs, leaf)
    out["heal/rebuilt"] = np.array(
        torch.equal(built.full_tensor(), full) and built.placements == leaf.placements
        and built.to_local().data_ptr() != leaf.to_local().data_ptr()
    )

    # The JAX trainer's pipeline mesh for four devices, pp 2 x dp 2: the
    # 4-layer llama_debug in 2 microbatches, each dp rank its rows, each pp
    # rank its stage.
    from torchft_tpu_torch.parallel import make_pipeline_loss

    pcfg = llama_debug(num_layers=4, **f32)
    pmesh = group_mesh(world, rank, cpu, "pipeline")
    state, _ = init_train_state(pcfg, pmesh, cpu, seed=0)
    _load_full(state.model, _params(inputs, "pipe/"))
    loss, grads = make_grad_step(state, make_pipeline_loss(pcfg, pmesh, n_micro=2))(batch)
    out["pipeline/loss"] = loss.numpy()
    out["pipeline/mesh"] = np.array(repr(pmesh.shape))
    for name, g in grads.items():
        out[f"pipeline/grad/{name}"] = _full(g)
    return out


def main(out_dir: str, cases: str = "fsdp") -> None:
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.parallel.mesh import init_group

    torch.set_num_threads(1)
    rank, world = init_group(torch.device("cpu"))
    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    out = {"tp_ep": _tp_ep_cases, "sp_pp": _sp_pp_cases, "fsdp": _cases}[cases](
        inputs, rank, world
    )
    np.savez(os.path.join(out_dir, f"world{world}_rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
