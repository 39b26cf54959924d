"""The port's sharding rules and meshes against the JAX package's: every
parameter's spec (the ``tp`` and ``ep`` entries included) for the dense and
the MoE llama_debug, mapped through the layout (``nn.Linear`` weights are
``[out, in]``, each layer its own module); the multislice device layout; the
batch block (rows over (dp, fsdp), sequence over sp) each rank holds; the
AdamW state's specs; the group mesh's factoring and its refusal; the
process-axis coordinates."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.models.llama import Transformer as JTransformer
from torchft_tpu.models.llama import llama_debug as jax_llama_debug
from torchft_tpu.models.llama import llama_moe_debug as jax_llama_moe_debug
from torchft_tpu.parallel import auto_mesh as jax_auto_mesh
from torchft_tpu.parallel import make_mesh as jax_make_mesh
from torchft_tpu.parallel import make_multislice_mesh as jax_multislice
from torchft_tpu.parallel.sharding import batch_sharding as jax_batch_sharding
from torchft_tpu.parallel.sharding import param_specs as jax_param_specs
from torchft_tpu.parallel.sharding import tree_specs_like as jax_tree_specs_like
from torchft_tpu_torch import device_mesh as tdm
from torchft_tpu_torch.models.llama import (
    _block_params,
    _DENSE,
    _OUT,
    _QKV,
    Transformer,
    llama_debug,
    llama_moe_debug,
)
from torchft_tpu_torch.parallel import (
    batch_sharding,
    make_mesh,
    make_multislice_mesh,
    param_specs,
)
from torchft_tpu_torch.parallel.mesh import group_mesh
from torchft_tpu_torch.parallel.sharding import (
    param_placements,
    tp_plan,
    tree_specs_like,
)

CPU = torch.device("cpu")


def _jax_spec_in_port_layout(spec, kind):
    """A flax leaf's spec (its layer dim dropped) laid out over the port's
    dims: a dense kernel reversed; q/k/v ``[H, heads, Dh]`` as ``[heads*Dh,
    H]`` (the merged dim takes the heads' axis, Dh being whole); the output
    kernel ``[heads, Dh, H]`` as ``[H, heads*Dh]``."""
    spec = tuple(spec)
    if kind == _DENSE:
        return spec[::-1]
    if kind == _QKV:
        assert spec[2] is None
        return (spec[1], spec[0])
    if kind == _OUT:
        assert spec[1] is None
        return (spec[2], spec[0])
    return spec


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_param_specs_match_jax(moe):
    jcfg = (jax_llama_moe_debug if moe else jax_llama_debug)()
    tcfg = (llama_moe_debug if moe else llama_debug)()
    shapes = jax.eval_shape(
        lambda: JTransformer(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)
        )["params"]
    )
    jspecs = jax_param_specs(shapes)
    with torch.device("meta"):
        model = Transformer(tcfg)
    got = param_specs(model)
    pad = lambda spec, n: (None,) * (n - len(spec)) + tuple(spec)  # noqa: E731
    want = {
        "embed.weight": tuple(jspecs["embed"]["embedding"]),
        "final_norm.scale": pad(jspecs["final_norm"]["scale"], 1),
        "lm_head.weight": tuple(jspecs["lm_head"]["kernel"])[::-1],
    }
    for name, path, kind in _block_params(moe):
        spec = jspecs["layers"]
        for key in path:
            spec = spec[key]
        leaf = shapes["layers"]
        for key in path:
            leaf = leaf[key]
        # The layer-stack dim leads (never sharded); each layer is a module.
        spec = pad(spec, leaf.ndim)
        assert spec[0] is None, (name, spec)
        for i in range(tcfg.num_layers):
            want[f"layers.{i}.{name}"] = _jax_spec_in_port_layout(spec[1:], kind)
    assert set(got) == set(want)
    for name, spec in got.items():
        assert spec == want[name], (name, spec, want[name])
    if moe:
        assert got["layers.0.mlp.experts_gate"] == ("ep", "fsdp", "tp")
        assert got["layers.0.mlp.router.weight"] == (None, "fsdp")
    else:
        assert got["layers.0.attn.wq.weight"] == ("tp", "fsdp")
        assert got["layers.0.attn.wo.weight"] == ("fsdp", "tp")


def test_opt_state_specs_follow_their_parameter():
    """AdamW's moments take their parameter's spec and its step count is
    replicated, as JAX's tree_specs_like gives optax's state."""
    specs = {"layers.0.mlp.down.weight": ("fsdp", "tp"), "embed.weight": ("tp", "fsdp")}
    tree = {"exp_avg": {n: 0 for n in specs}, "exp_avg_sq": {n: 0 for n in specs}, "step": 0}
    got = tree_specs_like(tree, specs)
    assert got == {"exp_avg": specs, "exp_avg_sq": specs, "step": ()}
    jgot = jax_tree_specs_like(
        {"mu": {"embed": {"embedding": 0}}, "count": 0},
        {("embed", "embedding"): ("tp", "fsdp")},
    )
    assert tuple(jgot["mu"]["embed"]["embedding"]) == got["exp_avg"]["embed.weight"]
    assert tuple(jgot["count"]) == got["step"]


def test_multislice_mesh_layout_matches_jax():
    """make_multislice_mesh(2, fsdp=2, tp=2) over 8 devices: the device at
    every coordinate, by index, as JAX lays out its 8 virtual devices."""
    jmesh = jax_multislice(2, fsdp=2, tp=2, devices=jax.devices()[:8])
    tmesh = make_multislice_mesh(2, fsdp=2, tp=2, devices=[torch.device("cpu", i) for i in range(8)])
    assert tmesh.shape == dict(jmesh.shape)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(np.vectorize(lambda d: d.index)(tmesh.devices), ids)
    with pytest.raises(ValueError, match="need 16 devices"):
        make_multislice_mesh(2, fsdp=4, tp=2, devices=[CPU] * 8)


@pytest.mark.parametrize("dp,fsdp", [(1, 2), (2, 2), (2, 1), (1, 4)])
def test_batch_rows_match_jax(dp, fsdp):
    """Rank r of (dp, fsdp), row-major, holds the rows JAX's batch
    sharding gives the device at that coordinate."""
    jmesh = jax_make_mesh(dp=dp, fsdp=fsdp)
    index = jax_batch_sharding(jmesh).devices_indices_map((8, 16))
    tmesh = make_mesh(dp=dp, fsdp=fsdp, devices=[CPU] * (dp * fsdp))
    for i in range(dp):
        for j in range(fsdp):
            want = index[jmesh.devices[i, 0, j, 0, 0, 0]]
            got = batch_sharding(tmesh, i * fsdp + j, (8, 16))
            assert [s.indices(n)[:2] for s, n in zip(got, (8, 16))] == [
                s.indices(n)[:2] for s, n in zip(want, (8, 16))
            ], (i, j)
    with pytest.raises(ValueError, match="not divisible"):
        batch_sharding(tmesh, 0, (7, 16))


@pytest.mark.parametrize("world", [1, 2, 3])
def test_group_mesh_factors_as_jax_auto_mesh(world):
    mesh = group_mesh(world, world - 1, CPU)
    assert mesh.shape["fsdp"] == world and mesh.process_rank == world - 1
    assert mesh.process_coordinate() == {
        "dp": 0, "pp": 0, "fsdp": world - 1, "ep": 0, "sp": 0, "tp": 0,
    }


@pytest.mark.parametrize("world", [4, 8])
def test_group_sizes_that_need_tp_or_sp_raise(world):
    """No dense group size raises now: 4 ranks take the JAX trainer's
    auto_mesh(4), fsdp 2 x tp 2 (rank 3 sits at fsdp 1, tp 1), and 8 its
    auto_mesh(8), fsdp 2 x tp 2 x sp 2 (rank 7 at fsdp 1, sp 1, tp 1; rank
    5 at fsdp 1, sp 0, tp 1), every axis a process axis, a rank's
    coordinate row-major over them."""
    mesh = group_mesh(world, world - 1, CPU)
    want = {a: n for a, n in jax_auto_mesh(world).shape.items()}
    assert mesh.shape == want and want["fsdp"] == want["tp"] == 2
    assert want["sp"] == (2 if world == 8 else 1)
    last = {"dp": 0, "pp": 0, "fsdp": 1, "ep": 0, "sp": want["sp"] - 1, "tp": 1}
    assert mesh.process_coordinate() == last
    if world == 8:
        mesh.process_rank = 5
        assert mesh.process_coordinate() == {**last, "sp": 0}


@pytest.mark.parametrize("world,want", [
    (2, {"ep": 2}), (4, {"fsdp": 2, "ep": 2}), (8, None), (6, None),
    (3, {"fsdp": 3}),
])
def test_group_mesh_of_the_moe_model_is_the_jax_trainers(world, want):
    """``--model moe``: an even world gives the experts ep 2, fsdp 2 when
    n/2 is even, tp the rest (train_hsdp.py's MoE mesh); an odd one takes
    auto_mesh. ``want`` None: the mesh needs both ep and tp (8 ranks: fsdp
    2 x ep 2 x tp 2; 6: ep 2 x tp 3), held to JAX's ``make_mesh`` of the
    JAX trainer's rule; llama_moe_debug splits over the first
    (``check_model_mesh`` passes), and its 4 q and 2 kv heads do not
    split over tp 3 (``check_model_mesh`` raises, naming them and the
    axis)."""
    from torchft_tpu_torch.models.llama import llama_moe_debug
    from torchft_tpu_torch.parallel.train import check_model_mesh

    if want is None:
        mesh = group_mesh(world, world - 1, CPU, "moe")
        rest = world // 2
        fsdp = 2 if rest % 2 == 0 else 1
        assert mesh.shape == dict(jax_make_mesh(fsdp=fsdp, ep=2, tp=rest // fsdp).shape)
        assert mesh.shape["ep"] == 2 and mesh.shape["tp"] > 1
        if world == 8:
            check_model_mesh(llama_moe_debug(), mesh)
        else:
            with pytest.raises(ValueError, match="4 q and 2 kv heads do not split over tp=3"):
                check_model_mesh(llama_moe_debug(), mesh)
        return
    mesh = group_mesh(world, world - 1, CPU, "moe")
    assert {a: n for a, n in mesh.shape.items() if n > 1} == want


@pytest.mark.parametrize("world,want", [(1, {}), (2, {"pp": 2}), (4, {"dp": 2, "pp": 2})])
def test_group_mesh_of_the_pipeline_model(world, want):
    """``--model pipeline`` puts its GPipe stages on other ranks on an even
    world, as the JAX trainer does (make_mesh(pp=2, dp=n/2)): 2 ranks are
    pp 2, 4 are pp 2 x dp 2 (rank 3 at dp 1, pp 1); one rank holds the
    whole pipeline."""
    mesh = group_mesh(world, world - 1, CPU, "pipeline")
    assert {a: n for a, n in mesh.shape.items() if n > 1} == want
    if world > 1:
        jmesh = jax_make_mesh(**want)
        assert mesh.shape == dict(jmesh.shape)
        assert mesh.process_coordinate()["pp"] == 1
        assert mesh.process_coordinate()["dp"] == world // 2 - 1


class _DeviceMesh:
    """The names and sizes of a torch DeviceMesh, which is all
    ``param_placements`` reads."""

    def __init__(self, **shape):
        self.mesh_dim_names = tuple(shape)
        self.mesh = np.zeros(tuple(shape.values()))


@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_tp_and_ep_above_one_raise(axis):
    """tp and ep above 1 no longer raise: they build their placements. At
    tp 2 the plan splits q, k, v, gate, up, the head and the embedding on
    their output (vocab) rows and wo, down on their input columns, and the
    norms and the router not at all; at ep 2 it splits the experts on their
    expert dim. FSDP2's fsdp dim comes first in each placement."""
    from torch.distributed.tensor import Shard

    tcfg = llama_moe_debug() if axis == "ep" else llama_debug()
    with torch.device("meta"):
        model = Transformer(tcfg)
    mesh = make_mesh(fsdp=2, **{axis: 2}, devices=[CPU] * 4)
    plan = tp_plan(model, mesh)
    placements = param_placements(model, _DeviceMesh(fsdp=2, **{axis: 2}))
    if axis == "tp":
        want = {"attn.wq": 0, "attn.wk": 0, "attn.wv": 0, "attn.wo": 1,
                "mlp.gate": 0, "mlp.up": 0, "mlp.down": 1}
        want = {f"layers.{i}.{m}.weight": d for i in range(tcfg.num_layers) for m, d in want.items()}
        want.update({"embed.weight": 0, "lm_head.weight": 0})
    else:
        want = {f"layers.{i}.mlp.experts_{m}": 0
                for i in range(tcfg.num_layers) for m in ("gate", "up", "down")}
    assert plan == {name: ((axis, d),) for name, d in want.items()}
    for name, p in model.named_parameters():
        fsdp = Shard(1 if name in want and want[name] == 0 and p.dim() == 2 else 0)
        if name in want:
            assert placements[name][1:] == (Shard(want[name]),), name
        else:
            assert len(placements[name]) == 1, name
        if p.dim() == 2 and name in want:
            assert placements[name][0] == fsdp, name
    with pytest.raises(ValueError, match="does not split"):
        tp_plan(model, make_mesh(**{axis: 3}, devices=[CPU] * 3))


@pytest.mark.parametrize("fsdp,ep,tp", [(2, 1, 2), (1, 2, 1), (2, 2, 1), (2, 2, 2)])
def test_batch_rows_over_ep_and_tp_match_jax(fsdp, ep, tp):
    """Ranks that differ only in ep or tp hold the rows JAX's batch
    sharding gives the devices at their (dp, fsdp) coordinate."""
    jmesh = jax_make_mesh(fsdp=fsdp, ep=ep, tp=tp)
    index = jax_batch_sharding(jmesh).devices_indices_map((8, 16))
    tmesh = make_mesh(fsdp=fsdp, ep=ep, tp=tp, devices=[CPU] * (fsdp * ep * tp))
    for rank, coord in enumerate(np.ndindex(fsdp, ep, tp)):
        want = index[jmesh.devices[0, 0, coord[0], coord[1], 0, coord[2]]]
        got = batch_sharding(tmesh, rank, (8, 16))
        assert [s.indices(n)[:2] for s, n in zip(got, (8, 16))] == [
            s.indices(n)[:2] for s, n in zip(want, (8, 16))
        ], coord


@pytest.mark.parametrize("axes", [
    dict(sp=2), dict(fsdp=2, tp=2, sp=2), dict(pp=2, dp=2), dict(dp=2, sp=4),
], ids=["sp2", "fsdp2xtp2xsp2", "pp2xdp2", "dp2xsp4"])
def test_batch_blocks_over_sp_and_pp_match_jax(axes):
    """Every rank's block, rows over (dp, fsdp) and sequence over sp, is
    the one JAX's batch sharding gives the device at its coordinate
    (row-major over every axis); the ranks that differ only in pp take the
    same block."""
    jmesh = jax_make_mesh(**axes)
    index = jax_batch_sharding(jmesh).devices_indices_map((8, 16))
    n = int(np.prod(list(axes.values())))
    tmesh = make_mesh(**axes, devices=[CPU] * n)
    for rank, coord in enumerate(np.ndindex(*jmesh.devices.shape)):
        want = index[jmesh.devices[coord]]
        got = batch_sharding(tmesh, rank, (8, 16))
        assert [s.indices(m)[:2] for s, m in zip(got, (8, 16))] == [
            s.indices(m)[:2] for s, m in zip(want, (8, 16))
        ], coord
    if tmesh.shape["sp"] > 1:
        with pytest.raises(ValueError, match="sequence 15 not divisible"):
            batch_sharding(tmesh, 0, (8, 15))


class _FakeManager:
    def num_participants(self):
        return 2

    def participating_rank(self):
        return 1


def test_process_axes_take_the_rank_as_coordinate():
    """Each rank of a group names its own device at its coordinate, which
    comes from its rank, row-major over every axis (sp a process axis too:
    rank 3 of fsdp 2 x sp 2 sits at fsdp 1, sp 1); another device is not
    this process's and raises."""
    mesh = make_mesh(fsdp=2, sp=2, devices=[torch.device("cpu", i % 2) for i in range(4)])
    mesh.process_rank = 3
    mm = tdm.ManagedMesh(_FakeManager(), mesh)
    assert mm.device_coordinate(torch.device("cpu", 1)) == {
        "dp": 0, "pp": 0, "fsdp": 1, "ep": 0, "sp": 1, "tp": 0,
    }
    view = mm[("replica", "fsdp")]
    assert view.rank(torch.device("cpu", 1)) == 1 * 2 + 1
    assert view.partition_spec() == ("fsdp",)
    with pytest.raises(ValueError, match="not this process's device"):
        mm.device_coordinate(torch.device("cpu", 0))
    # tp and ep are process axes too: rank 3 of fsdp 2 x tp 2 sits at
    # fsdp 1, tp 1; rank 1 of ep 2 at ep 1.
    for shape, rank, want in ((dict(fsdp=2, tp=2), 3, {"fsdp": 1, "tp": 1}),
                              (dict(ep=2), 1, {"ep": 1})):
        mesh = make_mesh(**shape, devices=[CPU] * 4 if "tp" in shape else [CPU] * 2)
        mesh.process_rank = rank
        coord = tdm.ManagedMesh(_FakeManager(), mesh).device_coordinate()
        assert coord == {**dict.fromkeys(mesh.axis_names, 0), **want}


@pytest.mark.parametrize(
    "name,local_rank,want",
    [("cuda", None, 0), ("cuda", "2", 2), ("cuda:1", "2", 1), ("cuda", "5", None)],
    ids=["no-launcher", "local-rank", "explicit-index", "local-rank-past-cards"],
)
def test_trainer_device_follows_local_rank(monkeypatch, name, local_rank, want):
    """Under torchrun each rank of a group takes the card ``LOCAL_RANK``
    names (``cuda`` without an index); an explicit index wins; a
    ``LOCAL_RANK`` past the visible cards exits instead of sharing one."""
    from torchft_tpu_torch._train_common import trainer_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    if want is None:
        with pytest.raises(SystemExit, match="LOCAL_RANK=5"):
            trainer_device(name, "train_hsdp")
    else:
        assert trainer_device(name, "train_hsdp") == torch.device("cuda", want)
