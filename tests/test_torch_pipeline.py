"""The port's GPipe pipeline (torchft_tpu_torch.parallel.pipeline) against
the JAX package's, on the CPU in fp32.

The port runs its pp stages one after another on a mesh that repeats the CPU
device, over the port's own Transformer (its layers split into contiguous
stages); the JAX pipeline runs on pp virtual CPU devices of
tests/conftest.py with the layer stack sharded over ``pp``. Parameters are
initialised by flax and carried across with ``params_from_jax``; the batch
is made with numpy from a seed. Losses and every gradient leaf are held to
1e-5 of their largest value.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.models.llama import Transformer as JTransformer
from torchft_tpu.models.llama import llama_debug as jax_llama_debug
from torchft_tpu.parallel import make_mesh as jax_make_mesh
from torchft_tpu.parallel.pipeline import _check_cfg as jax_check_cfg
from torchft_tpu.parallel.pipeline import gpipe_loop as jax_gpipe_loop
from torchft_tpu.parallel.pipeline import make_pipeline_loss as jax_pipeline_loss
from torchft_tpu.parallel.ring_attention import shard_map
from jax.sharding import PartitionSpec as P
from torchft_tpu_torch.models.llama import (
    Transformer,
    llama_debug,
    params_from_jax,
    params_to_jax,
)
from torchft_tpu_torch.parallel import (
    gpipe_loop,
    grad_step,
    make_mesh,
    make_pipeline_loss,
    pipeline_grad_step,
)
from torchft_tpu_torch.parallel.pipeline import _check_cfg

CPU = torch.device("cpu")
TOL = 1e-5


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / (np.abs(ref).max() + 1e-12))


def _small(**kw):
    """tests/test_pipeline.py's model: fp32, 2 heads of 8, hidden 16."""
    base = dict(remat=False, attn_impl="dense", vocab_size=64, hidden_size=16,
                intermediate_size=32, num_heads=2, num_kv_heads=2, head_dim=8,
                max_seq_len=32)
    base.update(kw)
    return (
        jax_llama_debug(dtype=jnp.float32, param_dtype=jnp.float32, **base),
        llama_debug(dtype=torch.float32, **base),
    )


PP_MICRO = [(1, 2), (2, 2), (4, 4), (8, 1)]


@pytest.mark.parametrize("pp, n_micro", PP_MICRO)
def test_gpipe_loop_matches_jax(pp, n_micro):
    """Linear-tanh stages: the port's tick loop against the JAX tick loop
    in shard_map (the last stage's buffer), values and the gradients of
    <out, c> with respect to every stage weight and the inputs."""
    mb, d = 2, 8
    rng = np.random.default_rng(pp)
    w = (rng.standard_normal((pp, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    c = rng.standard_normal((n_micro, mb, d)).astype(np.float32)

    def device_fn(w_local, x_all):
        out = jax_gpipe_loop(lambda h: jnp.tanh(h @ w_local[0]), x_all, axis="pp")
        last = (jax.lax.axis_index("pp") == pp - 1).astype(out.dtype)
        return jax.lax.psum(out * last, "pp")

    piped = shard_map(device_fn, mesh=jax_make_mesh(pp=pp),
                      in_specs=(P("pp"), P()), out_specs=P())
    jout = piped(jnp.asarray(w), jnp.asarray(x))
    jgw, jgx = jax.grad(lambda a, b: jnp.sum(piped(a, b) * c), (0, 1))(
        jnp.asarray(w), jnp.asarray(x)
    )

    tw, tx = (torch.from_numpy(a).requires_grad_() for a in (w, x))
    out = gpipe_loop(
        [lambda h, s=s: torch.tanh(h @ tw[s]) for s in range(pp)], tx, [CPU] * pp
    )
    (out * torch.from_numpy(c)).sum().backward()
    assert _rel(out.detach().numpy(), jout) < TOL
    assert _rel(tw.grad.numpy(), jgw) < TOL
    assert _rel(tx.grad.numpy(), jgx) < TOL


def _batch(vocab, B, S, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (B, S)).astype(np.int32)
    t = rng.integers(0, vocab, (B, S)).astype(np.int32)
    m = np.ones((B, S), np.int32)
    m[:, -2:] = 0
    return x, t, m


@pytest.mark.parametrize("pp, n_micro", PP_MICRO)
def test_pipeline_loss_and_every_grad_leaf_match_jax(pp, n_micro):
    jcfg, tcfg = _small(num_layers=8 if pp == 8 else 4)
    B, S = 4, 16
    x, t, m = _batch(64, B, S, seed=pp)
    params = JTransformer(jcfg).init(
        jax.random.PRNGKey(pp), jnp.asarray(x)
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    jloss_fn = jax_pipeline_loss(jcfg, jax_make_mesh(pp=pp), n_micro)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss_fn))(
        params, {"inputs": x, "targets": t, "mask": m}
    )

    model = Transformer(tcfg)
    model.load_state_dict(params_from_jax(params))
    batch = {"inputs": torch.from_numpy(x).long(),
             "targets": torch.from_numpy(t).long(), "mask": torch.from_numpy(m)}
    mesh = make_mesh(pp=pp, devices=[CPU] * pp)
    loss, grads = pipeline_grad_step(model, batch, mesh, n_micro)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(grads, tcfg)))
    ref = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(got) == len(ref)
    for path, leaf in ref:
        assert _rel(got[path], leaf) < TOL, (jax.tree_util.keystr(path), _rel(got[path], leaf))
    # The gradients keep the dense model's names: grad_step's dict, the
    # same function on full logits (the batch's 16 tokens are one chunk).
    loss_d, grads_d = grad_step(model, batch)
    assert list(grads_d) == list(grads)
    np.testing.assert_allclose(float(loss_d), float(loss), rtol=TOL)


@pytest.mark.parametrize(
    "overrides, pp",
    [
        ({"num_layers": 3}, 2),
        ({"tie_embeddings": True}, 1),
        ({"num_experts": 4}, 1),
        ({"attn_impl": "ring"}, 1),
        ({"attn_impl": "ulysses"}, 1),
    ],
)
def test_check_cfg_refuses_what_jax_refuses(overrides, pp):
    jcfg, tcfg = _small(num_layers=4)
    jcfg = dataclasses.replace(jcfg, **overrides)
    tcfg = dataclasses.replace(tcfg, **overrides)
    with pytest.raises(ValueError) as jerr:
        jax_check_cfg(jcfg, pp)
    with pytest.raises(ValueError) as terr:
        _check_cfg(tcfg, pp)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError):
        make_pipeline_loss(tcfg, make_mesh(pp=pp, devices=[CPU] * pp), 1)


def test_pipeline_refuses_dp_and_an_uneven_batch():
    """dp is a process axis: a mesh with dp=2 pipelines the rows this rank
    holds, as the pp=2 mesh alone does. A batch that does not split into
    the microbatches still raises."""
    _, tcfg = _small(num_layers=4)
    model = Transformer(tcfg)
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, tcfg.vocab_size, (4, 8), generator=gen)
    batch = {"inputs": x, "targets": x.roll(-1, 1), "mask": torch.ones_like(x)}
    with torch.no_grad():
        sharded = make_pipeline_loss(tcfg, make_mesh(pp=2, dp=2, devices=[CPU] * 4), 2)
        alone = make_pipeline_loss(tcfg, make_mesh(pp=2, devices=[CPU] * 2), 2)
        assert torch.equal(sharded(model, batch), alone(model, batch))
    loss_fn = make_pipeline_loss(tcfg, make_mesh(pp=2, devices=[CPU] * 2), 3)
    x = torch.zeros(4, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible by n_micro 3"):
        loss_fn(Transformer(tcfg), {"inputs": x, "targets": x, "mask": x})


def test_chip_smoke_pipeline_check_holds_on_cpu():
    """chip_smoke.py's pp=2 against pp=1 check, rehearsed on the CPU."""
    import chip_smoke

    rec = chip_smoke.pipeline_check(device="cpu")
    assert rec["worst_grad_rel"] <= chip_smoke.PIPELINE_TOL
