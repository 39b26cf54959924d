"""The port's sharding rules and meshes against the JAX package's: every
parameter's spec (the ``tp`` and ``ep`` entries included) for the dense and
the MoE llama_debug, mapped through the layout (``nn.Linear`` weights are
``[out, in]``, each layer its own module); the multislice device layout; the
batch rows each rank of (dp, fsdp) holds; the AdamW state's specs; the
group mesh's factoring and its refusals; the process-axis coordinates."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.models.llama import Transformer as JTransformer
from torchft_tpu.models.llama import llama_debug as jax_llama_debug
from torchft_tpu.models.llama import llama_moe_debug as jax_llama_moe_debug
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
    TP_EP_ITEM,
    check_process_mesh,
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
            want = index[jmesh.devices[i, 0, j, 0, 0, 0]][0]
            got = batch_sharding(tmesh, i * fsdp + j, 8)
            assert (got.start, got.stop) == (want.start, want.stop), (i, j)
    with pytest.raises(ValueError, match="not divisible"):
        batch_sharding(tmesh, 0, 7)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_group_mesh_factors_as_jax_auto_mesh(world):
    mesh = group_mesh(world, world - 1, CPU)
    assert mesh.shape["fsdp"] == world and mesh.process_rank == world - 1
    assert mesh.process_coordinate() == {"dp": 0, "fsdp": world - 1}


@pytest.mark.parametrize("world", [4, 8])
def test_group_sizes_that_need_tp_or_sp_raise(world):
    with pytest.raises(NotImplementedError, match=TP_EP_ITEM):
        group_mesh(world, 0, CPU)


@pytest.mark.parametrize("axis", ["tp", "ep"])
def test_tp_and_ep_above_one_raise(axis):
    with pytest.raises(NotImplementedError, match=TP_EP_ITEM):
        check_process_mesh(make_mesh(**{axis: 2}, devices=[CPU] * 2))


class _FakeManager:
    def num_participants(self):
        return 2

    def participating_rank(self):
        return 1


def test_process_axes_take_the_rank_as_coordinate():
    """Each rank of a group names its own device at every process-axis
    coordinate: the coordinate comes from its rank, and the in-process
    axes from where the device sits."""
    mesh = make_mesh(fsdp=2, sp=2, devices=[torch.device("cpu", i % 2) for i in range(4)])
    mesh.process_rank = 1
    mm = tdm.ManagedMesh(_FakeManager(), mesh)
    assert mm.device_coordinate(torch.device("cpu", 1)) == {
        "dp": 0, "pp": 0, "fsdp": 1, "ep": 0, "sp": 1, "tp": 0,
    }
    view = mm[("replica", "fsdp")]
    assert view.rank(torch.device("cpu", 0)) == 1 * 2 + 1
    assert view.partition_spec() == ("fsdp",)


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
