"""The port's sharded step (FSDP2 over a group's process axes) against the
JAX package's pjit step, on the CPU at llama_debug size in fp32.

Two gloo worlds (fsdp 2 and fsdp 1) of ``tests/test_torch_fsdp_worker.py``
run the cases once per module; each rank starts from the parameters flax
initialised, carried by ``params_from_jax``, on a batch made with numpy.
JAX runs in this process on its virtual CPU devices at ``make_mesh(fsdp=2)``
(``make_mesh(fsdp=2, sp=2)`` for ring and Ulysses, ``make_mesh(dp=2,
pp=2)`` for GPipe). Bars: the loss to rtol 1e-5 and every gradient leaf to
relative 1e-4 (``tests/test_torch_llama.py``); parameters after one AdamW
step to the bound ``tests/test_torch_local_sgd.py`` derives for AdamW on
cancelled gradients; ``accum_steps`` 2 and 4 against 1 to the JAX test's
own bars (loss rtol 1e-5; parameters rtol 2e-4, atol 1e-6,
``tests/test_parallel.py``). fsdp 2 against fsdp 1 in the port is held to
the same bars."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_fsdp_worker import LOSS_CHUNK, run_world
from torchft_tpu.checkpointing.sharded import split_state_sharded as jax_split
from torchft_tpu.models.llama import llama_debug as jax_llama_debug
from torchft_tpu.models.llama import llama_moe_debug as jax_llama_moe_debug
from torchft_tpu.parallel import make_mesh as jax_make_mesh
from torchft_tpu.parallel import train as jtrain
from torchft_tpu.parallel.pipeline import make_pipeline_loss as jax_pipeline_loss
from torchft_tpu_torch.models.llama import (
    Transformer,
    llama_debug,
    params_from_jax,
    params_to_jax,
)

B, S = 8, 64
LR, ADAM_EPS = 3e-4, 1e-8
GRAD_CASES = ["grad", "moe", "remat", "ring", "ulysses", "pipeline"]


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / (np.abs(ref).max() + 1e-12))


def _batch():
    x = np.random.default_rng(3).integers(0, 256, (B, S)).astype(np.int32)
    mask = np.ones_like(x)
    mask[:, -3:] = 0
    return {"inputs": x, "targets": np.roll(x, -1, axis=1), "mask": mask}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads_of(cfg, mesh, params, batch):
    """(loss, grads) of JAX's sharded grad step on ``params``."""
    model = jtrain.build_model(cfg, mesh)
    shardings = jtrain.state_shardings(model, mesh, (B, S))
    params = jax.device_put(params, shardings.params)
    loss, grads = jtrain.make_grad_step(model, mesh, shardings)(params, _jbatch(batch))
    return float(loss), _host(grads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": the JAX references, 1 and 2: {rank: the port's results}}."""
    saved = jtrain._LOSS_CHUNK
    jtrain._LOSS_CHUNK = LOSS_CHUNK
    try:
        return _runs(tmp_path_factory.mktemp("fsdp"))
    finally:
        jtrain._LOSS_CHUNK = saved


def _runs(out):
    batch = _batch()
    f32 = dict(dtype=jnp.float32)
    cfg = jax_llama_debug(**f32)
    mesh = jax_make_mesh(fsdp=2)
    model = jtrain.build_model(cfg, mesh)
    state, shardings = jtrain.init_train_state(model, mesh, jax.random.PRNGKey(0), (B, S))
    params = _host(state.params)
    moe_cfg = jax_llama_moe_debug(**f32)
    moe_params = _host(jtrain.init_train_state(
        jtrain.build_model(moe_cfg, mesh), mesh, jax.random.PRNGKey(1), (B, S)
    )[0].params)
    pipe_cfg = jax_llama_debug(num_layers=4, **f32)
    pipe_params = _host(jtrain.init_train_state(
        jtrain.build_model(pipe_cfg, mesh), mesh, jax.random.PRNGKey(2), (B, S)
    )[0].params)

    ref = {"params": params}
    ref["grad"] = _grads_of(cfg, mesh, params, batch)
    ref["remat"] = ref["grad"]
    ref["moe"] = _grads_of(moe_cfg, mesh, moe_params, batch)
    for attn in ("ring", "ulysses"):
        ref[attn] = _grads_of(
            dataclasses.replace(cfg, attn_impl=attn), jax_make_mesh(fsdp=2, sp=2),
            params, batch,
        )
    loss, grads = jax.jit(jax.value_and_grad(
        jax_pipeline_loss(pipe_cfg, jax_make_mesh(dp=2, pp=2), n_micro=2)
    ))(pipe_params, _jbatch(batch))
    ref["pipeline"] = (float(loss), _host(grads))
    ref["eval"] = float(jtrain.make_eval_step(model, mesh, shardings)(
        state.params, _jbatch(batch)
    ))
    micro_grad = jax.jit(jax.grad(
        lambda p, x, t, m: jtrain._loss_fn(model, p, x, t, m)
    ))
    for accum in (1, 2, 4):
        step = jtrain.make_train_step(
            model, mesh, shardings, donate=False, accum_steps=accum
        )
        new, metrics = step(state, _jbatch(batch))
        # The gradients this step applied (the mean over its interleaved
        # microbatches), for the cancelled-gradient mask.
        micro = [
            micro_grad(params, *(
                jnp.asarray(batch[n][k::accum]) for n in ("inputs", "targets", "mask")
            ))
            for k in range(accum)
        ]
        g = jax.tree_util.tree_map(lambda *a: sum(a) / accum, *micro)
        ref[f"train{accum}"] = (
            float(metrics["loss"]), float(metrics["grad_norm"]),
            _host(new.params), _host(g),
        )

    inputs = {"tokens": batch["inputs"], "targets": batch["targets"], "mask": batch["mask"]}
    for prefix, p in (("p/", params), ("moe/", moe_params), ("pipe/", pipe_params)):
        inputs.update({prefix + k: v.numpy() for k, v in params_from_jax(p).items()})
    np.savez(out / "inputs.npz", **inputs)
    result = {"jax": ref}
    for world in (2, 1):
        run_world(world, out)
        result[world] = {
            r: dict(np.load(out / f"world{world}_rank{r}.npz"))
            for r in range(world)
        }
    return result


def _port_tree(res, prefix, tcfg):
    """The port's gathered tensors under ``prefix`` as a flax tree."""
    tensors = {
        k[len(prefix):]: torch.from_numpy(v)
        for k, v in res.items() if k.startswith(prefix)
    }
    return dict(jax.tree_util.tree_leaves_with_path(params_to_jax(tensors, tcfg)))


def _tcfg(case):
    if case == "moe":
        return llama_debug(num_experts=4, num_experts_per_tok=2, dtype=torch.float32)
    if case == "pipeline":
        return llama_debug(num_layers=4, dtype=torch.float32)
    return llama_debug(dtype=torch.float32)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("world", [1, 2])
def test_born_sharded_params_equal_the_mesh_free_model(runs, world):
    """init_train_state gathers to torch.manual_seed(0)'s Transformer, bit
    for bit, at one rank and at two."""
    torch.manual_seed(0)
    ref = Transformer(llama_debug(dtype=torch.float32))
    res = runs[world][0]
    for name, p in ref.named_parameters():
        np.testing.assert_array_equal(res[f"init/{name}"], p.detach().numpy(), err_msg=name)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("case", GRAD_CASES)
def test_grad_step_at_fsdp2_matches_jax_and_fsdp1(runs, case):
    tcfg = _tcfg(case)
    ref_loss, ref_grads = runs["jax"][case]
    for world in (2, 1):
        res = runs[world][0]
        np.testing.assert_allclose(float(res[f"{case}/loss"]), ref_loss, rtol=1e-5)
        got = _port_tree(res, f"{case}/grad/", tcfg)
        ref = jax.tree_util.tree_leaves_with_path(ref_grads)
        assert len(got) == len(ref)
        for path, leaf in ref:
            assert _rel(got[path], leaf) < 1e-4, (world, jax.tree_util.keystr(path))
    for key in runs[2][0]:
        if key.startswith(f"{case}/grad/"):
            assert _rel(runs[2][0][key], runs[1][0][key]) < 1e-4, key


def _adamw_close(got, want, g_port, g_ref):
    """|port - JAX| <= 1e-5, and <= 1e-5 + 2 lr where the gradient fell
    below AdamW's eps on either side and differed (its step is then set by
    rounding noise), for at most one element in 10,000."""
    err = np.abs(got - want)
    mask = (np.minimum(np.abs(g_port), np.abs(g_ref)) < ADAM_EPS) & (g_port != g_ref)
    assert err[~mask].max(initial=0.0) <= 1e-5
    assert err[mask].max(initial=0.0) <= 1e-5 + 2 * LR
    return int(mask.sum())


@pytest.mark.timeout(300)
@pytest.mark.parametrize("accum", [1, 2, 4])
def test_train_step_accum_matches_jax(runs, accum):
    tcfg = _tcfg("grad")
    ref_loss, ref_norm, ref_params, ref_g = runs["jax"][f"train{accum}"]
    ref_g = dict(jax.tree_util.tree_leaves_with_path(ref_g))
    for world in (2, 1):
        res = runs[world][0]
        np.testing.assert_allclose(float(res[f"train{accum}/loss"]), ref_loss, rtol=1e-5)
        np.testing.assert_allclose(float(res[f"train{accum}/grad_norm"]), ref_norm, rtol=1e-4)
        got = _port_tree(res, f"train{accum}/param/", tcfg)
        g_port = _port_tree(res, f"train{accum}/grad/", tcfg)
        masked, size = 0, 0
        for path, want in jax.tree_util.tree_leaves_with_path(ref_params):
            masked += _adamw_close(got[path], want, g_port[path], np.asarray(ref_g[path]))
            size += want.size
        assert masked <= size // 10_000, masked
        # The JAX test's own bars for accumulation against one step.
        one = runs[world][0]
        np.testing.assert_allclose(
            float(one[f"train{accum}/loss"]), float(one["train1/loss"]), rtol=1e-5
        )
        np.testing.assert_allclose(
            one[f"train{accum}/param/embed.weight"], one["train1/param/embed.weight"],
            rtol=2e-4, atol=1e-6,
        )


@pytest.mark.timeout(300)
def test_eval_step_matches_jax(runs):
    for world in (2, 1):
        np.testing.assert_allclose(float(runs[world][0]["eval/loss"]), runs["jax"]["eval"], rtol=1e-5)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("check", [
    "shardings", "opt_roundtrip/host", "opt_roundtrip/device", "opt_mismatch_raises",
    "allreduce/fp32", "allreduce/int8", "heal/rebuilt", "heal/mismatch_raises",
])
def test_sharded_state_checks_on_every_rank(runs, check):
    """Each rank's own check (tests/test_torch_fsdp_worker.py): the
    parameters' placements are those state_shardings reports; AdamW state
    over DTensors round-trips through the host and device forms bit for
    bit and a payload of another layout raises; the replica average over
    DTensor shards (fp32 buckets and the quantized path's leaf lists)
    gives the full gradients' average with the gradients' placements; the
    sharded heal rebuilds a DTensor as a fresh local shard and a target of
    another layout refuses."""
    for world in (2, 1):
        for r, res in runs[world].items():
            assert bool(res[check]), (world, r, check)


@pytest.mark.timeout(300)
def test_sharded_heal_keys_match_jax(runs):
    """A [8, 16] leaf over fsdp 2: the two ranks' keys are the keys JAX's
    split_state_sharded writes for the same array over make_mesh(fsdp=2)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    arr = jax.device_put(
        jnp.arange(128, dtype=jnp.float32).reshape(8, 16),
        NamedSharding(jax_make_mesh(fsdp=2), P("fsdp", None)),
    )
    meta, _ = jax_split({"w": arr})
    port = set()
    for res in runs[2].values():
        port |= set(eval(str(res["heal/keys"])))  # noqa: S307 - our own repr
    assert port == set(map(tuple, meta["w"].keys))
    assert eval(str(runs[1][0]["heal/keys"])) == [(("s", None, None, None),) * 2]  # noqa: S307


@pytest.mark.timeout(120)
def test_chip_smoke_train_step_check_holds_on_cpu():
    """chip_smoke.py's train-step check, rehearsed on the CPU at one rank
    (fp32 llama_debug): ``make_train_step`` at accum 1 and 2 equals the
    mesh-free model doing the same arithmetic bit for bit, and each planted
    fault moves the gradients past the limit."""
    import torch.distributed as dist

    import chip_smoke
    from torchft_tpu_torch.parallel.mesh import group_mesh, init_group
    from torchft_tpu_torch.parallel.train import (
        build_model,
        init_train_state,
        make_train_step,
    )

    cpu = torch.device("cpu")
    cfg = llama_debug(dtype=torch.float32)
    np_batch = _batch()
    batch = {k: torch.from_numpy(v).long() for k, v in np_batch.items()}
    batch["mask"] = batch["mask"].int()
    init_group(cpu)
    try:
        mesh = group_mesh(1, 0, cpu)
        got = {}
        for accum in (1, 2):
            state, _ = init_train_state(cfg, mesh, cpu, seed=0)
            state, metrics = make_train_step(state, accum_steps=accum)(state, batch)
            named = list(state.model.named_parameters())
            got[accum] = (
                float(metrics["loss"]),
                {n: p.grad.full_tensor().clone() for n, p in named},
                {n: p.detach().full_tensor().clone() for n, p in named},
            )
        torch.manual_seed(0)
        model = build_model(cfg, mesh)
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        halves = [slice(0, None, 2), slice(1, None, 2)]
        ref = chip_smoke.train_step_reference
        diffs = {
            1: chip_smoke.step_diff(got[1], ref(
                model, init, batch, [slice(None)], lambda parts: parts[0]
            )),
            2: chip_smoke.step_diff(got[2], ref(
                model, init, batch, halves, chip_smoke.halved_sum
            )),
        }
        for fault, combine in chip_smoke.TRAIN_STEP_FAULTS.items():
            diffs[fault] = chip_smoke.step_diff(
                got[2], ref(model, init, batch, halves, combine)
            )
    finally:
        dist.destroy_process_group()
    for accum in (1, 2):
        assert max(diffs[accum].values()) <= chip_smoke.ACCUM_LIMIT, diffs
    for fault in chip_smoke.TRAIN_STEP_FAULTS:
        assert diffs[fault]["grad"] > chip_smoke.ACCUM_LIMIT, diffs
