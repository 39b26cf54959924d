"""The port's sequence and pipeline parallelism across the ranks of a replica
group against the JAX package at the same ``make_mesh``, on the CPU at
llama_debug size in fp32.

Two gloo worlds of ``tests/test_torch_fsdp_worker.py`` (its ``sp_pp``
cases) run once per module. World 2 is llama_debug at ``make_mesh(sp=2)``
with the default attention (k and v gathered over the sp ranks), ring and
Ulysses, and the 4-layer llama_debug at ``make_mesh(pp=2)`` in 2
microbatches (the JAX trainer's pipeline mesh for two devices); world 8 is
llama_debug at ``auto_mesh(8)``, fsdp 2 x tp 2 x sp 2 (the JAX trainer's
dense mesh for eight devices), with the default attention, ring and
Ulysses, and llama_moe_debug at fsdp 2 x ep 2 x tp 2 (the JAX trainer's
MoE mesh for eight devices: the experts over ep, each expert's FFN over
tp and fsdp, the attention over tp and replicated over ep). The
pipeline at pp 2 x dp 2 runs in ``tests/test_torch_tp_ep.py``'s world of
four. Each rank starts from the parameters flax initialised, carried by
``params_from_jax``, on a batch made with numpy; JAX runs in this process
on its virtual CPU devices at the same meshes. Bars, those of
``tests/test_torch_fsdp.py``: the loss to rtol 1e-5, every gradient leaf
to relative 1e-4; the parameters after one AdamW step to
``chip_smoke.adamw_excess``'s bound on every element (1e-5 plus what the
two sides' gradient difference can move AdamW's first step)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_fsdp import _batch, _grads_of, _host, _jbatch, _port_tree, _rel
from test_torch_fsdp_worker import LOSS_CHUNK, run_world
from torchft_tpu.checkpointing.sharded import split_state_sharded as jax_split
from torchft_tpu.models.llama import llama_debug as jax_llama_debug
from torchft_tpu.models.llama import llama_moe_debug as jax_llama_moe_debug
from torchft_tpu.parallel import auto_mesh as jax_auto_mesh
from torchft_tpu.parallel import make_mesh as jax_make_mesh
from torchft_tpu.parallel import train as jtrain
from torchft_tpu.parallel.pipeline import init_pipeline_state
from torchft_tpu.parallel.pipeline import make_pipeline_loss as jax_pipeline_loss
from torchft_tpu.parallel.pipeline import make_pipeline_train_step
from torchft_tpu_torch.models.llama import llama_debug, params_from_jax

B, S = 8, 64
DENSE = llama_debug(dtype=torch.float32)
PIPE = llama_debug(num_layers=4, dtype=torch.float32)
MOE = llama_debug(num_experts=4, num_experts_per_tok=2, dtype=torch.float32)
# (world, case) -> the JAX mesh it is held to.
MESHES = {
    (2, "sp/dense"): dict(sp=2),
    (2, "sp/ring"): dict(sp=2),
    (2, "sp/ulysses"): dict(sp=2),
    (2, "pp"): dict(pp=2),
    (8, "sp/dense"): dict(fsdp=2, tp=2, sp=2),
    (8, "sp/ring"): dict(fsdp=2, tp=2, sp=2),
    (8, "sp/ulysses"): dict(fsdp=2, tp=2, sp=2),
    (8, "moe"): dict(fsdp=2, ep=2, tp=2),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": the JAX references, 2 and 8: {rank: the port's results}}."""
    saved = jtrain._LOSS_CHUNK
    jtrain._LOSS_CHUNK = LOSS_CHUNK
    try:
        return _runs(tmp_path_factory.mktemp("sp_pp"))
    finally:
        jtrain._LOSS_CHUNK = saved


def _runs(out):
    batch = _batch()
    f32 = dict(dtype=jnp.float32)
    cfg, pipe_cfg = jax_llama_debug(**f32), jax_llama_debug(num_layers=4, **f32)
    mesh = jax_make_mesh(sp=2)
    assert dict(jax_auto_mesh(8).shape) == {**dict(mesh.shape), **MESHES[(8, "sp/dense")]}
    model = jtrain.build_model(cfg, mesh)
    state, shardings = jtrain.init_train_state(model, mesh, jax.random.PRNGKey(0), (B, S))
    params = _host(state.params)
    ref = {}
    moe_cfg, moe_mesh = jax_llama_moe_debug(**f32), jax_make_mesh(**MESHES[(8, "moe")])
    moe_model = jtrain.build_model(moe_cfg, moe_mesh)
    moe_state, moe_sh = jtrain.init_train_state(
        moe_model, moe_mesh, jax.random.PRNGKey(1), (B, S)
    )
    moe_params = _host(moe_state.params)
    ref[(8, "moe")] = _grads_of(moe_cfg, moe_mesh, moe_params, batch)
    new, metrics = jtrain.make_train_step(moe_model, moe_mesh, moe_sh, donate=False)(
        moe_state, _jbatch(batch)
    )
    ref["moe_train"] = (
        float(metrics["loss"]), float(metrics["grad_norm"]), _host(new.params),
        ref[(8, "moe")][1],
    )
    for (world, case), axes in MESHES.items():
        if case in ("pp", "moe"):
            continue
        attn = case.split("/")[1]
        c = cfg if attn == "dense" else dataclasses.replace(cfg, attn_impl=attn)
        ref[(world, case)] = _grads_of(c, jax_make_mesh(**axes), params, batch)
    new, metrics = jtrain.make_train_step(model, mesh, shardings, donate=False)(
        state, _jbatch(batch)
    )
    ref["sp_train"] = (
        float(metrics["loss"]), float(metrics["grad_norm"]), _host(new.params),
        ref[(2, "sp/dense")][1],
    )

    pmesh = jax_make_mesh(pp=2)
    pstate, psh = init_pipeline_state(pipe_cfg, pmesh, jax.random.PRNGKey(2), (B, S))
    pipe_params = _host(pstate.params)
    loss, grads = jax.jit(jax.value_and_grad(
        jax_pipeline_loss(pipe_cfg, pmesh, n_micro=2)
    ))(pipe_params, _jbatch(batch))
    ref[(2, "pp")] = (float(loss), _host(grads))
    pnew, _ = make_pipeline_train_step(pipe_cfg, pmesh, psh, n_micro=2)(pstate, _jbatch(batch))
    ref["pp_train"] = _host(pnew.params)

    inputs = {"tokens": batch["inputs"], "targets": batch["targets"], "mask": batch["mask"]}
    for prefix, p in (("p/", params), ("pipe/", pipe_params), ("moe/", moe_params)):
        inputs.update({prefix + k: v.numpy() for k, v in params_from_jax(p).items()})
    np.savez(out / "inputs.npz", **inputs)
    result = {"jax": ref}
    for world in (2, 8):
        run_world(world, out, cases="sp_pp")
        result[world] = {
            r: dict(np.load(out / f"world{world}_rank{r}.npz"))
            for r in range(world)
        }
    return result


def _stages(res_by_rank, prefix):
    """The pp ranks' results under ``prefix`` merged into one: each holds
    its stage's layers and every rank the replicated leaves, which must
    agree."""
    merged = {}
    for res in res_by_rank:
        for k, v in res.items():
            if k.startswith(prefix):
                if k in merged:
                    np.testing.assert_array_equal(v, merged[k], err_msg=k)
                merged[k] = v
    return merged


@pytest.mark.timeout(400)
@pytest.mark.parametrize(
    "world,case", list(MESHES),
    ids=["sp2-default", "sp2-ring", "sp2-ulysses", "pp2", "fsdp2xtp2xsp2-default",
         "fsdp2xtp2xsp2-ring", "fsdp2xtp2xsp2-ulysses", "fsdp2xep2xtp2-moe"],
)
def test_grad_step_across_ranks_matches_jax(runs, world, case):
    """The loss and every gathered gradient leaf at the JAX trainer's mesh
    for the case, on every rank (over pp: the stages' leaves merged, the
    replicated ones equal on both stages)."""
    tcfg = {"pp": PIPE, "moe": MOE}.get(case, DENSE)
    ref_loss, ref_grads = runs["jax"][(world, case)]
    ranks = runs[world]
    for r, res in ranks.items():
        shape = eval(str(res[f"{case}/mesh"]))  # noqa: S307 - our own repr
        assert {a: n for a, n in shape.items() if n > 1} == MESHES[(world, case)], shape
        np.testing.assert_allclose(float(res[f"{case}/loss"]), ref_loss, rtol=1e-5)
    views = [_stages(ranks.values(), f"{case}/grad/")] if case == "pp" else ranks.values()
    ref = jax.tree_util.tree_leaves_with_path(ref_grads)
    for res in views:
        got = _port_tree(res, f"{case}/grad/", tcfg)
        assert len(got) == len(ref)
        for path, leaf in ref:
            assert _rel(got[path], leaf) < 1e-4, (world, case, jax.tree_util.keystr(path))


def _assert_adamw(got, g_port, ref_params, ref_g):
    """Every element of every leaf after one AdamW step within
    ``chip_smoke.adamw_excess``'s bound: 1e-5 plus lr times the most two
    gradients' difference can move the first step."""
    import chip_smoke

    ref_g = dict(jax.tree_util.tree_leaves_with_path(ref_g))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    for path, want in jax.tree_util.tree_leaves_with_path(ref_params):
        excess = chip_smoke.adamw_excess(
            t(got[path]), t(want), t(g_port[path]), t(ref_g[path])
        )
        assert excess == 0, (jax.tree_util.keystr(path), excess)


@pytest.mark.timeout(400)
def test_train_step_at_sp2_matches_jax(runs):
    """make_train_step at sp 2 (the default attention): the loss, the
    global gradient norm (each element counted once over the sp replicas)
    and the parameters after one AdamW step, on both ranks."""
    ref_loss, ref_norm, ref_params, ref_g = runs["jax"]["sp_train"]
    for r, res in runs[2].items():
        np.testing.assert_allclose(float(res["sp_train/loss"]), ref_loss, rtol=1e-5)
        np.testing.assert_allclose(float(res["sp_train/grad_norm"]), ref_norm, rtol=1e-4)
        _assert_adamw(
            _port_tree(res, "sp_train/param/", DENSE),
            _port_tree(res, "sp_train/grad/", DENSE), ref_params, ref_g,
        )


@pytest.mark.timeout(400)
def test_train_step_at_fsdp2_ep2_tp2_moe_matches_jax(runs):
    """make_train_step on llama_moe_debug at fsdp 2 x ep 2 x tp 2, on all
    eight ranks: the loss to rtol 1e-5; the global gradient norm to rtol
    1e-5 of the norm of JAX's gradients, and to rtol 1e-6 of the norm of
    the rank's own gathered gradients (each element counted once: the
    attention's gradient is held by both ep ranks, the norms' and the
    router's by every ep and tp rank); the parameters after one AdamW step
    to ``chip_smoke.adamw_excess`` == 0."""
    ref_loss, _, ref_params, ref_g = runs["jax"]["moe_train"]
    ref_norm = float(np.sqrt(sum(
        np.square(np.asarray(g, np.float64)).sum() for g in jax.tree_util.tree_leaves(ref_g)
    )))
    assert len(runs[8]) == 8
    for r, res in runs[8].items():
        np.testing.assert_allclose(float(res["moe_train/loss"]), ref_loss, rtol=1e-5)
        norm = float(res["moe_train/grad_norm"])
        np.testing.assert_allclose(norm, ref_norm, rtol=1e-5)
        np.testing.assert_allclose(norm, float(res["moe_train/grad_norm_gathered"]), rtol=1e-6)
        _assert_adamw(
            _port_tree(res, "moe_train/param/", MOE),
            _port_tree(res, "moe_train/grad/", MOE), ref_params, ref_g,
        )


@pytest.mark.timeout(400)
def test_router_input_is_the_same_bits_on_every_rank_at_fsdp2_ep2_tp2(runs):
    """The router's top-k routes a token alike on every rank only if its
    input is the same bits on every rank of the ep and tp groups: the
    sha of each MoE layer's input, equal within each fsdp coordinate's
    four ranks, which hold the same rows; and the ranks of the two fsdp
    coordinates, which hold other rows, differ."""
    mesh = eval(str(runs[8][0]["moe/mesh"]))  # noqa: S307 - our own repr
    by_rows = {}
    for r, res in runs[8].items():
        shas = eval(str(res["moe/router_sha"]))  # noqa: S307 - our own repr
        assert len(shas) == MOE.num_layers, shas
        fsdp = int(np.unravel_index(r, list(mesh.values()))[2])
        by_rows.setdefault(fsdp, set()).add(tuple(shas))
    assert sorted(by_rows) == [0, 1]
    assert all(len(s) == 1 for s in by_rows.values()), by_rows
    assert by_rows[0] != by_rows[1]


@pytest.mark.timeout(400)
def test_adamw_step_at_pp2_matches_jax(runs):
    """One AdamW step on the pipeline's summed gradients at pp 2: each
    stage's layers and the replicated embedding, norm and head (equal on
    both stages) against JAX's pipeline train step."""
    ranks = runs[2].values()
    _assert_adamw(
        _port_tree(_stages(ranks, "pp_train/param/"), "pp_train/param/", PIPE),
        _port_tree(_stages(ranks, "pp/grad/"), "pp/grad/", PIPE),
        runs["jax"]["pp_train"], runs["jax"][(2, "pp")][1],
    )


@pytest.mark.timeout(400)
@pytest.mark.parametrize("case", ["sp2", "fsdp2xtp2xsp2", "pp2", "fsdp2xep2xtp2-moe"])
def test_sharded_heal_keys_over_sp_and_pp_match_jax(runs, case):
    """The pg-sharded heal's keys against JAX's ``split_state_sharded`` at
    the same mesh. sp 2: a leaf replicated over sp, one whole-leaf key. fsdp
    2 x tp 2 x sp 2: a [8, 16] leaf over fsdp (dim 0) and tp (dim 1), the
    eight ranks' keys the four JAX writes. pp 2: each stage's leaves are
    whole layers, and the layers a stage holds are the rows of the stacked
    layer dim JAX's pipeline specs give its pp coordinate. fsdp 2 x ep 2 x
    tp 2: an expert-like [4, 8, 16] leaf at ``P("ep", "fsdp", "tp")``,
    eight keys, and an attention-like [8, 16] leaf at ``P("tp", "fsdp")``,
    replicated over ep, the eight ranks' keys the four JAX writes."""
    arr = jnp.arange(128, dtype=jnp.float32).reshape(8, 16)
    if case == "fsdp2xep2xtp2-moe":
        mesh = jax_make_mesh(**MESHES[(8, "moe")])
        meta, _ = jax_split({
            "experts": jax.device_put(
                jnp.arange(512, dtype=jnp.float32).reshape(4, 8, 16),
                NamedSharding(mesh, P("ep", "fsdp", "tp")),
            ),
            "attn": jax.device_put(arr, NamedSharding(mesh, P("tp", "fsdp"))),
        })
        port = {"experts": set(), "attn": set()}
        for res in runs[8].values():
            for leaf, keys in eval(str(res["heal/moe_keys"])).items():  # noqa: S307
                port[leaf] |= set(keys)
        for leaf, n in (("experts", 8), ("attn", 4)):
            assert port[leaf] == set(map(tuple, meta[leaf].keys)) and len(port[leaf]) == n, leaf
        return
    if case == "sp2":
        meta, _ = jax_split({"w": jax.device_put(arr, NamedSharding(jax_make_mesh(sp=2), P()))})
        for res in runs[2].values():
            assert eval(str(res["heal/sp_keys"])) == list(map(tuple, meta["w"].keys))  # noqa: S307
        return
    if case == "fsdp2xtp2xsp2":
        meta, _ = jax_split({"w": jax.device_put(
            arr, NamedSharding(jax_auto_mesh(8), P("fsdp", "tp"))
        )})
        port = set()
        for res in runs[8].values():
            port |= set(eval(str(res["heal/keys"])))  # noqa: S307 - our own repr
        assert port == set(map(tuple, meta["w"].keys)) and len(port) == 4
        return
    stack = jnp.zeros((PIPE.num_layers, 16))
    meta, _ = jax_split({"w": jax.device_put(stack, NamedSharding(jax_make_mesh(pp=2), P("pp")))})
    want = {k[0] for k in map(tuple, meta["w"].keys)}
    got = set()
    for res in runs[2].values():
        assert bool(res["heal/pp_whole"])
        layers = [int(i) for i in res["heal/pp_layers"]]
        assert layers == list(range(layers[0], layers[-1] + 1)), layers
        got.add(("s", layers[0], layers[-1] + 1, None))
    assert got == want


@pytest.mark.timeout(300)
def test_chip_smoke_sp_pp_check_holds_on_cpu():
    """chip_smoke.py phase 21's sequence- and pipeline-parallel cases,
    rehearsed on the CPU at llama_debug size: two gloo ranks at sp 2 (the
    default attention, ring and Ulysses) and at pp 2 against one rank's two
    steps, fp32 within the CPU bars (the pipeline bit for bit) and bf16
    within the bars set from readings, each planted fault past them."""
    import chip_smoke

    result = chip_smoke.tp_ep_check("cpu", "debug", cases=chip_smoke.SP_PP_CASES)
    assert len(result["cases"]) == len(chip_smoke.SP_PP_CASES)
    for name, case in result["cases"].items():
        assert case["loss"] <= case["bar"]["loss"] and case["grad"] <= case["bar"]["grad"], name
        if case["fault_grad"] is not None:
            assert case["fault_grad"] > case["bar"]["grad"], name
        if name.startswith("pipeline float32"):
            assert case["loss"] == 0 and case["grad"] == 0, name
