"""The rank side of ``tests/test_torch_fsdp.py``: one process of a gloo
world, run as ``python tests/test_torch_fsdp_worker.py OUT_DIR`` with
``RANK``, ``WORLD_SIZE`` and ``GROUP_INIT_METHOD`` set (:func:`run_world`
starts them). JAX-free: ``tests/conftest.py`` imports JAX, so the ranks run
this file as a script, read their inputs from ``OUT_DIR/inputs.npz``
(parameters made by flax and carried by ``params_from_jax``, tokens made
with numpy) and write what they computed to
``OUT_DIR/world<n>_rank<r>.npz``, which the pytest process holds against
the JAX package.

Every case runs the port's sharded step at the world's fsdp size on the
CPU in fp32: gradients, train steps at ``accum_steps`` 1, 2 and 4, the
eval step, the MoE model, block recompute, ring and Ulysses attention at
sp=2 in-process, the GPipe pipeline over ``dp`` (a process axis) and pp=2,
the optimizer state's round trip and the sharded heal's keys."""

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


def run_world(world: int, out_dir: Path, timeout_s: float = 240.0) -> None:
    """Runs ``world`` ranks of this file over ``out_dir`` and waits for
    them; raises with the ranks' output if one fails."""
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
            [sys.executable, __file__, str(out_dir)],
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

    # The MoE model, block recompute, ring and Ulysses at sp=2 in-process.
    grads_case("moe", llama_moe_debug(**f32), _params(inputs, "moe/"))
    grads_case("remat", llama_debug(remat=True, **f32), params)
    for attn in ("ring", "ulysses"):
        mesh = make_mesh(fsdp=world, sp=2, devices=[cpu] * (2 * world))
        mesh.process_rank = rank
        grads_case(attn, llama_debug(attn_impl=attn, **f32), params, mesh)

    # GPipe: dp is the process axis, pp=2 in-process, 2 microbatches.
    pcfg = llama_debug(num_layers=4, **f32)
    mesh = make_mesh(dp=world, pp=2, devices=[cpu] * (2 * world))
    mesh.process_rank = rank
    grads_case(
        "pipeline", pcfg, _params(inputs, "pipe/"), mesh,
        make_pipeline_loss(pcfg, mesh, n_micro=2),
    )
    return out


def main(out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from torchft_tpu_torch.parallel.mesh import init_group

    torch.set_num_threads(1)
    rank, world = init_group(torch.device("cpu"))
    inputs = np.load(os.path.join(out_dir, "inputs.npz"))
    out = _cases(inputs, rank, world)
    np.savez(os.path.join(out_dir, f"world{world}_rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
