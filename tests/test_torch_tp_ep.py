"""The port's tensor and expert parallelism across the ranks of a replica
group against the JAX package's pjit step at the same ``make_mesh``, on the
CPU at llama_debug size in fp32.

Two gloo worlds of ``tests/test_torch_fsdp_worker.py`` (its ``tp_ep``
cases) run once per module: world 4 is llama_debug at fsdp 2 x tp 2 (the
JAX trainer's ``auto_mesh(4)``), llama_moe_debug at fsdp 2 x ep 2 and the
4-layer llama_debug's pipeline at pp 2 x dp 2 (the JAX trainer's
``make_mesh(pp=2, dp=2)`` for ``--model pipeline``), world 2 is
llama_moe_debug at ep 2 (the JAX trainer's MoE meshes for 4 and 2
devices). Each rank starts from the parameters flax initialised, carried
by ``params_from_jax``, on a batch made with numpy; JAX runs in this process
on its virtual CPU devices at the same meshes. Bars, those of
``tests/test_torch_fsdp.py``: the loss to rtol 1e-5, every gradient leaf to
relative 1e-4, parameters after one AdamW step to the AdamW bound
``tests/test_torch_local_sgd.py`` derives, the eval loss to rtol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_fsdp import _adamw_close, _batch, _grads_of, _host, _jbatch, _port_tree, _rel
from test_torch_fsdp_worker import LOSS_CHUNK, run_world
from torchft_tpu.checkpointing.sharded import split_state_sharded as jax_split
from torchft_tpu.models.llama import Transformer as JTransformer
from torchft_tpu.models.llama import llama_debug as jax_llama_debug
from torchft_tpu.models.llama import llama_moe_debug as jax_llama_moe_debug
from torchft_tpu.parallel import make_mesh as jax_make_mesh
from torchft_tpu.parallel import train as jtrain
from torchft_tpu.parallel.pipeline import make_pipeline_loss as jax_pipeline_loss
from torchft_tpu_torch.models.llama import Transformer, llama_debug, params_from_jax

B, S = 8, 64
# world -> {case: the JAX mesh it is held to}
MESHES = {
    4: {"grad": dict(fsdp=2, tp=2), "moe": dict(fsdp=2, ep=2)},
    2: {"moe": dict(ep=2)},
}
DENSE = llama_debug(dtype=torch.float32)
MOE = llama_debug(num_experts=4, num_experts_per_tok=2, dtype=torch.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": {world: the JAX references}, world: {rank: the port's
    results}}."""
    saved = jtrain._LOSS_CHUNK
    jtrain._LOSS_CHUNK = LOSS_CHUNK
    try:
        return _runs(tmp_path_factory.mktemp("tp_ep"))
    finally:
        jtrain._LOSS_CHUNK = saved


def _runs(out):
    batch = _batch()
    f32 = dict(dtype=jnp.float32)
    cfg, moe_cfg = jax_llama_debug(**f32), jax_llama_moe_debug(**f32)
    mesh = jax_make_mesh(fsdp=2, tp=2)
    model = jtrain.build_model(cfg, mesh)
    state, shardings = jtrain.init_train_state(model, mesh, jax.random.PRNGKey(0), (B, S))
    params = _host(state.params)
    moe_params = _host(jtrain.init_train_state(
        jtrain.build_model(moe_cfg, mesh), mesh, jax.random.PRNGKey(1), (B, S)
    )[0].params)
    pipe_cfg = jax_llama_debug(num_layers=4, **f32)
    pipe_params = _host(jtrain.init_train_state(
        jtrain.build_model(pipe_cfg, mesh), mesh, jax.random.PRNGKey(2), (B, S)
    )[0].params)

    ref = {4: {}, 2: {}}
    loss, grads = jax.jit(jax.value_and_grad(
        jax_pipeline_loss(pipe_cfg, jax_make_mesh(pp=2, dp=2), n_micro=2)
    ))(pipe_params, _jbatch(batch))
    ref[4]["pipeline"] = (float(loss), _host(grads))
    for world, cases in MESHES.items():
        for case, axes in cases.items():
            c, p = (moe_cfg, moe_params) if case == "moe" else (cfg, params)
            ref[world][case] = _grads_of(c, jax_make_mesh(**axes), p, batch)
    ref[4]["eval"] = float(jtrain.make_eval_step(model, mesh, shardings)(
        state.params, _jbatch(batch)
    ))
    ref[4]["logits"] = np.asarray(JTransformer(cfg).apply(
        {"params": params}, jnp.asarray(batch["inputs"])
    ))
    micro_grad = jax.jit(jax.grad(
        lambda p, x, t, m: jtrain._loss_fn(model, p, x, t, m)
    ))
    for accum in (1, 2):
        step = jtrain.make_train_step(
            model, mesh, shardings, donate=False, accum_steps=accum
        )
        new, metrics = step(state, _jbatch(batch))
        micro = [
            micro_grad(params, *(
                jnp.asarray(batch[n][k::accum]) for n in ("inputs", "targets", "mask")
            ))
            for k in range(accum)
        ]
        g = jax.tree_util.tree_map(lambda *a: sum(a) / accum, *micro)
        ref[4][f"train{accum}"] = (
            float(metrics["loss"]), float(metrics["grad_norm"]),
            _host(new.params), _host(g),
        )

    inputs = {"tokens": batch["inputs"], "targets": batch["targets"], "mask": batch["mask"]}
    for prefix, p in (("p/", params), ("moe/", moe_params), ("pipe/", pipe_params)):
        inputs.update({prefix + k: v.numpy() for k, v in params_from_jax(p).items()})
    np.savez(out / "inputs.npz", **inputs)
    result = {"jax": ref}
    for world in (4, 2):
        run_world(world, out, cases="tp_ep")
        result[world] = {
            r: dict(np.load(out / f"world{world}_rank{r}.npz"))
            for r in range(world)
        }
    return result


@pytest.mark.timeout(300)
@pytest.mark.parametrize("world,case", [(4, "grad"), (4, "moe"), (2, "moe")],
                         ids=["fsdp2xtp2", "fsdp2xep2-moe", "ep2-moe"])
def test_grad_step_matches_jax_at_the_same_mesh(runs, world, case):
    """The loss and every gathered gradient leaf of each rank, at the JAX
    trainer's mesh for the group's size and model."""
    tcfg = MOE if case == "moe" else DENSE
    ref_loss, ref_grads = runs["jax"][world][case]
    want = {a: n for a, n in MESHES[world][case].items()}
    for r, res in runs[world].items():
        shape = eval(str(res[f"{case}/mesh"]))  # noqa: S307 - our own repr
        assert {a: n for a, n in shape.items() if n > 1} == want, shape
        np.testing.assert_allclose(float(res[f"{case}/loss"]), ref_loss, rtol=1e-5)
        got = _port_tree(res, f"{case}/grad/", tcfg)
        ref = jax.tree_util.tree_leaves_with_path(ref_grads)
        assert len(got) == len(ref)
        for path, leaf in ref:
            assert _rel(got[path], leaf) < 1e-4, (world, r, jax.tree_util.keystr(path))
    if case == "moe":
        routers = [k for k in runs[world][0] if k.startswith("moe/grad/") and "router" in k]
        assert routers and all(np.abs(runs[world][0][k]).sum() > 0 for k in routers)


@pytest.mark.timeout(300)
def test_pipeline_at_pp2_dp2_matches_jax(runs):
    """The 4-layer llama_debug at the JAX trainer's pipeline mesh for four
    ranks, pp 2 x dp 2: every rank's loss, and each dp rank's two stages'
    gradients merged (the embedding, norm and head summed over pp, equal on
    both stages) to every JAX gradient leaf."""
    ref_loss, ref_grads = runs["jax"][4]["pipeline"]
    tcfg = llama_debug(num_layers=4, dtype=torch.float32)
    ranks = runs[4]
    for r, res in ranks.items():
        shape = eval(str(res["pipeline/mesh"]))  # noqa: S307 - our own repr
        assert {a: n for a, n in shape.items() if n > 1} == {"dp": 2, "pp": 2}
        np.testing.assert_allclose(float(res["pipeline/loss"]), ref_loss, rtol=1e-5)
    ref = jax.tree_util.tree_leaves_with_path(ref_grads)
    for dp in (0, 1):  # rank = dp * 2 + pp
        merged = {}
        for r in (2 * dp, 2 * dp + 1):
            for k, v in ranks[r].items():
                if k.startswith("pipeline/grad/"):
                    if k in merged:
                        np.testing.assert_array_equal(v, merged[k], err_msg=k)
                    merged[k] = v
        got = _port_tree(merged, "pipeline/grad/", tcfg)
        assert len(got) == len(ref)
        for path, leaf in ref:
            assert _rel(got[path], leaf) < 1e-4, (dp, jax.tree_util.keystr(path))


@pytest.mark.timeout(300)
def test_born_sharded_params_at_fsdp2_tp2_equal_the_mesh_free_model(runs):
    """init_train_state over fsdp 2 x tp 2 gathers to torch.manual_seed(0)'s
    Transformer, bit for bit, on every rank; each rank holds a quarter of
    wq (half its heads, half its hidden columns) and the placements
    state_shardings reports."""
    torch.manual_seed(0)
    ref = Transformer(DENSE)
    for r, res in runs[4].items():
        assert bool(res["shardings"]) and bool(res["tp_split"]), r
        for name, p in ref.named_parameters():
            np.testing.assert_array_equal(res[f"init/{name}"], p.detach().numpy(), err_msg=name)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_at_fsdp2_tp2_matches_jax(runs, accum):
    ref_loss, ref_norm, ref_params, ref_g = runs["jax"][4][f"train{accum}"]
    ref_g = dict(jax.tree_util.tree_leaves_with_path(ref_g))
    for r, res in runs[4].items():
        np.testing.assert_allclose(float(res[f"train{accum}/loss"]), ref_loss, rtol=1e-5)
        np.testing.assert_allclose(float(res[f"train{accum}/grad_norm"]), ref_norm, rtol=1e-4)
        got = _port_tree(res, f"train{accum}/param/", DENSE)
        g_port = _port_tree(res, f"train{accum}/grad/", DENSE)
        masked, size = 0, 0
        for path, want in jax.tree_util.tree_leaves_with_path(ref_params):
            masked += _adamw_close(got[path], want, g_port[path], np.asarray(ref_g[path]))
            size += want.size
        assert masked <= size // 10_000, masked


@pytest.mark.timeout(300)
def test_counted_flops_at_fsdp2_tp2_within_10pct_of_the_analytic_share(runs):
    """TORCHFT_PERF's count of one grad step on a rank at fsdp 2 x tp 2 is
    within 10% of the analytic FLOPs of its rows (B over dp x fsdp) divided
    by tp: the projections, the attention and the vocab-parallel loss each
    split over the tp ranks."""
    from torchft_tpu_torch import perf

    n = sum(p.numel() for p in Transformer(DENSE).parameters())
    share = perf.flops_per_step(n, DENSE, B // 2, S) / 2
    for r, res in runs[4].items():
        assert abs(float(res["perf/flops"]) / share - 1) <= 0.10, (r, float(res["perf/flops"]) / share)


@pytest.mark.timeout(300)
def test_count_after_an_eval_step_restores_the_sharded_state(runs):
    """perf.record_step_cost after make_eval_step at fsdp 2 x tp 2 (FSDP2
    leaves the root unsharded after a forward without gradients): the
    ranks live, the count is recorded, and every parameter and AdamW leaf
    is what it was before the count, bit for bit."""
    for r, res in runs[4].items():
        assert bool(res["perf/after_eval"]), r


@pytest.mark.timeout(300)
def test_eval_step_at_fsdp2_tp2_matches_jax(runs):
    for r, res in runs[4].items():
        np.testing.assert_allclose(float(res["eval/loss"]), runs["jax"][4]["eval"], rtol=1e-5)


@pytest.mark.timeout(300)
def test_logits_at_fsdp2_tp2_match_jax(runs):
    """The model's forward at tp 2 (the vocab-parallel embedding, each
    rank's heads and feature columns, the head's blocks gathered) gives
    every rank the whole [B, S, V] logits, to tests/test_torch_llama.py's
    bar."""
    for r, res in runs[4].items():
        np.testing.assert_allclose(res["logits"], runs["jax"][4]["logits"], atol=1e-4)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("check", ["allreduce/fp32", "allreduce/int8", "heal/rebuilt"])
def test_two_d_placements_through_the_replica_average_and_the_heal(runs, check):
    """The replica-axis average (fp32 buckets and the quantized path's leaf
    lists) keeps each gradient's (fsdp, tp) placements and averages the
    full tensors; the sharded heal rebuilds a leaf over
    (fsdp, tp) as a fresh local shard with its placements."""
    for r, res in runs[4].items():
        assert bool(res[check]), (r, check)


@pytest.mark.timeout(300)
def test_sharded_heal_keys_over_fsdp_and_tp_match_jax(runs):
    """A [8, 16] leaf over fsdp (dim 0) and tp (dim 1): the four ranks'
    keys are the keys JAX's split_state_sharded writes for the same array
    over make_mesh(fsdp=2, tp=2)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    arr = jax.device_put(
        jnp.arange(128, dtype=jnp.float32).reshape(8, 16),
        NamedSharding(jax_make_mesh(fsdp=2, tp=2), P("fsdp", "tp")),
    )
    meta, _ = jax_split({"w": arr})
    port = set()
    for res in runs[4].values():
        port |= set(eval(str(res["heal/keys"])))  # noqa: S307 - our own repr
    assert port == set(map(tuple, meta["w"].keys))
    assert len(port) == 4


@pytest.mark.timeout(300)
def test_chip_smoke_tp_ep_check_holds_on_cpu():
    """chip_smoke.py phase 21's check, rehearsed on the CPU at llama_debug
    size: two gloo ranks at tp 2 and at ep 2 against the mesh-free model's
    two steps, fp32 within the CPU bars and bf16 within the derived bar,
    the swapped-wo fault past both, the router gradient nonzero."""
    import chip_smoke

    result = chip_smoke.tp_ep_check("cpu", "debug")
    assert len(result["cases"]) == len(chip_smoke.TP_EP_CASES)
    for name, case in result["cases"].items():
        assert case["loss"] <= case["bar"]["loss"] and case["grad"] <= case["bar"]["grad"], name
        if name.startswith("dense"):
            assert case["fault_grad"] > 10 * case["bar"]["grad"], name
