"""The port's ring attention (torchft_tpu_torch.parallel) and offset-block
flash attention against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both. The JAX block
kernels run in Pallas interpret mode; on the CPU the port's block wrappers
take their kernels' plain PyTorch versions (the CUDA kernels are held
against those on the card: tests/test_torch_flash_block_gpu.py and
chip_smoke.py). The port's ring runs its sp ranks on a mesh that repeats
the CPU device; the JAX ring runs on the virtual CPU devices of
tests/conftest.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.models.llama import Transformer as JTransformer
from torchft_tpu.models.llama import llama_debug as jax_llama_debug
from torchft_tpu.ops import flash_attention as J
from torchft_tpu.parallel import auto_mesh as jax_auto_mesh
from torchft_tpu.parallel import make_mesh as jax_make_mesh
from torchft_tpu.parallel import make_ring_attention as jax_ring
from torchft_tpu.parallel import train as jtrain
from torchft_tpu_torch import device_mesh as tdm
from torchft_tpu_torch.models.llama import (
    Transformer,
    llama_debug,
    params_from_jax,
    params_to_jax,
)
from torchft_tpu_torch.ops import flash_attention as T
from torchft_tpu_torch.parallel import (
    auto_mesh,
    build_model,
    make_mesh,
    make_ring_attention,
)
from torchft_tpu_torch.parallel import train as ttrain
from torchft_tpu_torch.parallel.ring_attention import _flash_fold_supported

import chip_smoke

CPU = torch.device("cpu")


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / (np.abs(ref).max() + 1e-9))


# ---------------------------------------------------------------------------
# The block kernels' plain versions against the Pallas block kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offsets", [(0, 0), (256, 0), (0, 256), (256, 128)])
def test_block_matches_jax_values_and_both_cotangents(offsets):
    """flash_attention_block's (out, lse) and its vjp with cotangents on
    both outputs, fp32, Sq=Skv=256, Hq 2, Hkv 1, D 32."""
    q_off, k_off = offsets
    B, S, Hq, Hkv, D = 1, 256, 2, 1, 32
    q, k, v, dout = _arrays(
        (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D)
    )
    (dlse,) = _arrays((B, Hq, S), seed=1)

    (jout, jlse), vjp = jax.vjp(
        lambda a, b, c: J.flash_attention_block(
            a, b, c, q_off, k_off, interpret=True
        ),
        *map(jnp.asarray, (q, k, v)),
    )
    jgrads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = T.flash_attention_block(tq, tk, tv, q_off, k_off)
    torch.autograd.backward(
        [out, lse], [torch.from_numpy(dout), torch.from_numpy(dlse)]
    )
    assert out.shape == (B, S, Hq, D) and lse.shape == (B, Hq, S)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), atol=2e-5)
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        if not np.abs(np.asarray(ref)).max():  # a block wholly in the future
            assert not got.abs().max(), name
            continue
        assert _rel(got.numpy(), ref) < 1e-4, (name, _rel(got.numpy(), ref))


def test_block_in_the_future_gives_zero_out_and_lse_floor():
    q, k, v = (torch.from_numpy(a) for a in _arrays((1, 64, 2, 16), (1, 64, 1, 16), (1, 64, 1, 16)))
    out, lse = T.flash_block_fwd(q, k, v, 0, 64)
    assert not out.abs().max() and (lse <= -1e29).all() and torch.isfinite(lse).all()


def test_block_at_zero_offsets_equals_causal_plain_versions():
    """At offsets (0, 0) with dlse 0 the block plain versions are the
    whole-sequence causal ones, bit for bit."""
    q, k, v, dout = (
        torch.from_numpy(a)
        for a in _arrays((2, 128, 4, 32), (2, 128, 2, 32), (2, 128, 2, 32), (2, 128, 4, 32))
    )
    out, lse = T.flash_block_fwd_reference(q, k, v, 0, 0)
    out_c, lse_c = T.flash_attention_fwd_reference(q, k, v)
    assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
    delta = T._delta(dout, out)
    zero = torch.zeros_like(lse)
    dq = T.flash_block_bwd_dq(q, k, v, dout, lse, delta, zero, 0, 0)
    dk, dv = T.flash_block_bwd_dkv(q, k, v, dout, lse, delta, zero, 0, 0)
    for a, b in zip((dq, dk, dv), T.flash_attention_bwd_reference(q, k, v, dout, lse, delta)):
        assert torch.equal(a, b)


def test_block_term_sums_bound_the_outputs():
    """With offsets and dlse the term sums still bound every element."""
    q, k, v, dout = (
        torch.from_numpy(a)
        for a in _arrays((1, 128, 4, 32), (1, 192, 2, 32), (1, 192, 2, 32), (1, 128, 4, 32))
    )
    dlse = torch.from_numpy(_arrays((1, 4, 128), seed=3)[0])
    out, lse = T.flash_block_fwd(q, k, v, 256, 128)
    delta = T._delta(dout, out)
    terms = T.flash_attention_term_sums(q, k, v, dout, lse, delta, True, 256, 128, dlse)
    got = {
        "out": out,
        "dq": T.flash_block_bwd_dq(q, k, v, dout, lse, delta, dlse, 256, 128),
    }
    got["dk"], got["dv"] = T.flash_block_bwd_dkv(q, k, v, dout, lse, delta, dlse, 256, 128)
    for name, x in got.items():
        assert x.shape == terms[name].shape, name
        assert (terms[name] >= x.abs() - 1e-6).all(), name


def test_block_wrapper_refuses_non_cuda_device():
    q, k, v = (torch.empty(1, 64, 2, 16, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="CUDA"):
        T.flash_block_fwd(q, k, v, 0, 0)


def test_block_unsupported_shapes_raise():
    q, k, v = (torch.from_numpy(a) for a in _arrays((1, 100, 2, 16), (1, 100, 1, 16), (1, 100, 1, 16)))
    with pytest.raises(ValueError, match="dense fold"):
        T.flash_attention_block(q, k, v, 0, 0)


# ---------------------------------------------------------------------------
# The ring against the JAX ring on the virtual mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "sp, S, fold",
    [(2, 512, "flash"), (4, 512, "flash"), (2, 32, "dense"), (4, 64, "dense")],
)
def test_ring_matches_jax_ring(sp, S, fold):
    """Values (atol 2e-5) and gradients of sum(out^2) (relative 1e-4) of
    the port's make_ring_attention on a repeated CPU device against the
    JAX ring at the same sp."""
    B, Hq, Hkv, D = 1, 2, 1, 32
    q, k, v = _arrays((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), seed=2)
    use_flash = fold == "flash"
    jring = jax_ring(jax_make_mesh(sp=sp), use_flash=use_flash)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout = jax.jit(jring)(jq, jk, jv)
    jgrads = jax.jit(
        jax.grad(lambda a, b, c: jnp.sum(jring(a, b, c) ** 2), (0, 1, 2))
    )(jq, jk, jv)

    ring = make_ring_attention(make_mesh(sp=sp, devices=[CPU] * sp), use_flash=use_flash)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    for name in T.LAUNCHES:
        T.LAUNCHES[name] = 0
    out = ring(tq, tk, tv)
    (out**2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5)
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        assert _rel(got.numpy(), ref) < 1e-4, (name, _rel(got.numpy(), ref))
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert not any(T.LAUNCHES.values())


def test_ring_flash_fold_calls_the_block_once_per_hop(monkeypatch):
    """sp ranks x sp hops block calls, each at the JAX fold's offsets:
    q at idx * Sq, k at ((idx - i) mod sp) * Skv."""
    from torchft_tpu_torch.parallel import ring_attention as R

    calls = []
    real = R.flash_attention_block
    monkeypatch.setattr(
        R, "flash_attention_block",
        lambda q, k, v, qo, ko: calls.append((qo, ko)) or real(q, k, v, qo, ko),
    )
    q, k, v = (torch.from_numpy(a) for a in _arrays((1, 1024, 2, 16), (1, 1024, 1, 16), (1, 1024, 1, 16)))
    make_ring_attention(make_mesh(sp=4, devices=[CPU] * 4))(q, k, v)
    assert calls == [
        (idx * 256, ((idx - i) % 4) * 256) for idx in range(4) for i in range(4)
    ]


def test_flash_fold_autoselect_matches_jax():
    from torchft_tpu.parallel.ring_attention import _flash_fold_supported as jsel

    for sq in (32, 128, 256, 300, 512, 1024, 4096):
        assert _flash_fold_supported(sq, sq) == jsel(sq, sq), sq


def test_ring_refuses_sharded_batch_or_heads():
    """A mesh one process holds whole with fsdp=2, or with tp=2 beside
    sp=2, runs the ring over the rows and heads it is given (this rank's
    rows, this rank's tp heads), as the sp=2 mesh alone does."""
    q, k, v = (torch.from_numpy(a) for a in _arrays((2, 64, 2, 8), (2, 64, 1, 8), (2, 64, 1, 8)))
    alone = make_ring_attention(make_mesh(sp=2, devices=[CPU] * 2))
    for axes in (dict(fsdp=2), dict(tp=2)):
        sharded = make_ring_attention(make_mesh(sp=2, **axes, devices=[CPU] * 4))
        assert torch.equal(sharded(q, k, v), alone(q, k, v)), axes


@pytest.mark.parametrize("n", range(1, 9))
def test_auto_mesh_shapes_equal_jax(n):
    assert auto_mesh(n, devices=[CPU] * n).shape == dict(jax_auto_mesh(n).shape)


def test_make_mesh_shapes_equal_jax():
    for kw in ({"dp": 2, "sp": 2}, {"pp": 2, "tp": 2}, {"ep": 2, "fsdp": 2, "sp": 2}):
        assert make_mesh(devices=[CPU] * 8, **kw).shape == dict(jax_make_mesh(**kw).shape)
    with pytest.raises(ValueError, match="need 4 devices"):
        make_mesh(sp=4, devices=[CPU] * 2)


# ---------------------------------------------------------------------------
# llama_debug with ring attention against the JAX model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_llama_debug(dtype=jnp.float32)
    tokens = np.zeros((2, 128), np.int32)
    params = jax.jit(JTransformer(cfg).init)(
        jax.random.PRNGKey(0), jnp.asarray(tokens)
    )["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_llama_ring_sp2_logits_and_every_grad_leaf_match_jax(jax_params, monkeypatch):
    monkeypatch.setattr(jtrain, "_LOSS_CHUNK", 32)
    monkeypatch.setattr(ttrain, "_LOSS_CHUNK", 32)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (2, 128)).astype(np.int32)
    t, m = np.roll(x, -1, axis=1), np.ones_like(x)
    m[:, -3:] = 0
    jmodel = jtrain.build_model(
        jax_llama_debug(dtype=jnp.float32, attn_impl="ring"), jax_make_mesh(sp=2)
    )
    model = build_model(
        llama_debug(dtype=torch.float32, attn_impl="ring"),
        make_mesh(sp=2, devices=[CPU] * 2),
    )
    model.load_state_dict(params_from_jax(jax_params))

    ref_logits = jax.jit(jmodel.apply)({"params": jax_params}, jnp.asarray(x))
    with torch.no_grad():
        logits = model(torch.from_numpy(x).long())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jtrain._loss_fn(jmodel, p, *map(jnp.asarray, (x, t, m)))
    ))(jax_params)
    loss, grads = ttrain.grad_step(
        model,
        {
            "inputs": torch.from_numpy(x).long(),
            "targets": torch.from_numpy(t).long(),
            "mask": torch.from_numpy(m),
        },
    )
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(grads, model.cfg)))
    ref = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(got) == len(ref)
    for path, leaf in ref:
        assert _rel(got[path], leaf) < 1e-4, jax.tree_util.keystr(path)


def test_ring_and_ulysses_models_need_a_mesh():
    with pytest.raises(ValueError, match="mesh"):
        build_model(llama_debug(attn_impl="ring"))
    with pytest.raises(ValueError, match="attn_fn"):
        Transformer(llama_debug(attn_impl="ring"))
    with pytest.raises(ValueError, match="ulysses attention requires a mesh"):
        build_model(llama_debug(attn_impl="ulysses"))
    with pytest.raises(ValueError, match="attn_fn"):
        Transformer(llama_debug(attn_impl="ulysses"))


def test_ring_model_at_sp1_equals_dense_model():
    """One device: the ring is one dense fold per layer (shards under 256
    tokens), the same function as dense attention."""
    cfg = llama_debug(dtype=torch.float32)
    torch.manual_seed(0)
    dense = Transformer(cfg)
    ring = build_model(
        dataclasses.replace(cfg, attn_impl="ring"), auto_mesh(1, devices=[CPU])
    )
    ring.load_state_dict(dense.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 64)))
    with torch.no_grad():
        torch.testing.assert_close(ring(x), dense(x), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# ManagedMesh over the port's mesh
# ---------------------------------------------------------------------------


class _FakeManager:
    def __init__(self, participants, rank):
        self._n, self._rank = participants, rank

    def num_participants(self):
        return self._n

    def participating_rank(self):
        return self._rank


def test_managed_mesh_sizes_ranks_and_views():
    mesh = make_mesh(fsdp=2, sp=2, devices=[torch.device("cpu", i) for i in range(4)])
    mm = tdm.ManagedMesh(_FakeManager(3, 1), mesh)
    assert mm.size() == 12 and mm.size("replica") == 3 and mm.ndim == 7
    assert mm.shape()["fsdp"] == 2 and mm.axis_names[0] == "replica"
    view = mm[("replica", "fsdp")]
    assert view.size() == 6 and view.shape() == {"replica": 3, "fsdp": 2}
    # cpu:3 sits at fsdp 1, sp 1.
    assert mm.device_coordinate(torch.device("cpu", 3))["fsdp"] == 1
    assert view.rank(torch.device("cpu", 3)) == 1 * 2 + 1
    world = mm.flatten(name="world")
    assert mm["world"] is world and world.size() == 12
    assert mm.flatten(name="world") is world
    with pytest.raises(ValueError, match="already registered"):
        mm.flatten(("fsdp",), name="world")
    # The view's inner axes, the replica axis left out, as JAX's
    # PartitionSpec holds them.
    assert view.partition_spec() == ("fsdp",)
    assert mm[("replica", "fsdp", "sp")].partition_spec() == ("fsdp", "sp")
    with pytest.raises(ValueError, match="no managed axis"):
        mm["fsdp"].allreduce_grads({})
    assert tdm.ManagedMesh(_FakeManager(0, None), mesh)[("replica",)].rank() is None


def test_managed_mesh_repeated_device_has_no_single_coordinate():
    mm = tdm.ft_init_device_mesh(_FakeManager(1, 0), sp=2, devices=[CPU, CPU])
    assert mm.mesh.shape["sp"] == 2
    with pytest.raises(ValueError, match="appears 2 times"):
        mm.device_coordinate()


# ---------------------------------------------------------------------------
# chip_smoke.py's ring limit, rehearsed on the CPU with the plain versions
# ---------------------------------------------------------------------------


def test_chip_smoke_ring_check_holds_in_bf16_on_cpu():
    """The sp=4 bf16 ring (the block plain versions, which round P where
    the kernels do not) against the full-sequence plain versions, within
    chip_smoke.py's derived ring limit."""
    rec = chip_smoke.check_sequence_parallel(
        make_ring_attention, B=1, S=1024, Hq=4, Hkv=2, D=32, sp=4, device=CPU, seed=0
    )
    assert all(r["share"] <= 1.0 for r in rec["outputs"].values()), rec
