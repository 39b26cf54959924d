"""The port's Llama model, chunked loss and AdamW against the JAX package's,
on the CPU at llama_debug size in fp32: parameters are initialised by flax
and carried across with ``params_from_jax``, so both compute one function."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torchft_tpu.models.llama import Transformer as JTransformer
from torchft_tpu.models.llama import llama_debug as jax_llama_debug
from torchft_tpu.parallel import train as jtrain
from torchft_tpu_torch.models.llama import (
    Transformer,
    llama_debug,
    params_from_jax,
    params_to_jax,
)
from torchft_tpu_torch.parallel import train as ttrain


def _configs(attn="dense", **kw):
    jcfg = jax_llama_debug(dtype=jnp.float32, attn_impl=attn, **kw)
    tcfg = llama_debug(dtype=torch.float32, attn_impl=attn, **kw)
    return jcfg, tcfg


def _tokens(B=2, S=128, seed=3, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _configs()
    params = JTransformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(_tokens())
    )["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(tcfg, jax_params):
    model = Transformer(tcfg)
    model.load_state_dict(params_from_jax(jax_params))
    return model


def test_params_round_trip(jax_params):
    _, tcfg = _configs()
    back = params_to_jax(params_from_jax(jax_params), tcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path])


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_logits_match_jax(jax_params, attn):
    kw = {"flash_min_seq": 0} if attn == "flash" else {}
    jcfg, tcfg = _configs(attn, **kw)
    x = _tokens()
    ref = JTransformer(jcfg).apply({"params": jax_params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port_model(tcfg, jax_params)(torch.from_numpy(x).long())
    assert got.dtype == torch.float32 and got.shape == (2, 128, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def _batch(S, seed=5):
    x = _tokens(S=S, seed=seed)
    mask = np.ones_like(x)
    mask[:, -3:] = 0
    return x, np.roll(x, -1, axis=1), mask


@pytest.mark.parametrize("seq,chunk", [(128, 32), (100, 32)])
def test_chunked_loss_matches_jax(jax_params, monkeypatch, seq, chunk):
    """4 chunks of 32 tokens, and an odd length on the full-logits path."""
    monkeypatch.setattr(jtrain, "_LOSS_CHUNK", chunk)
    monkeypatch.setattr(ttrain, "_LOSS_CHUNK", chunk)
    jcfg, tcfg = _configs()
    x, t, m = _batch(seq)
    ref = jtrain._loss_fn(
        JTransformer(jcfg), jax_params, jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(m),
    )
    with torch.no_grad():
        got = ttrain._loss_fn(
            _port_model(tcfg, jax_params), torch.from_numpy(x).long(),
            torch.from_numpy(t).long(), torch.from_numpy(m),
        )
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def _jax_grads(jcfg, params, x, t, m):
    return jax.value_and_grad(
        lambda p: jtrain._loss_fn(
            JTransformer(jcfg), p, jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(m),
        )
    )(params)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_every_gradient_leaf_matches_jax(jax_params, monkeypatch, attn):
    monkeypatch.setattr(jtrain, "_LOSS_CHUNK", 32)
    monkeypatch.setattr(ttrain, "_LOSS_CHUNK", 32)
    kw = {"flash_min_seq": 0} if attn == "flash" else {}
    jcfg, tcfg = _configs(attn, **kw)
    x, t, m = _batch(128)
    ref_loss, ref_grads = _jax_grads(jcfg, jax_params, x, t, m)
    model = _port_model(tcfg, jax_params)
    loss, grads = ttrain.grad_step(
        model,
        {
            "inputs": torch.from_numpy(x).long(),
            "targets": torch.from_numpy(t).long(),
            "mask": torch.from_numpy(m),
        },
    )
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(grads, tcfg)))
    ref = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(got) == len(ref)
    for path, leaf in ref:
        leaf = np.asarray(leaf)
        rel = np.abs(got[path] - leaf).max() / (np.abs(leaf).max() + 1e-12)
        assert rel < 1e-4, (jax.tree_util.keystr(path), rel)


def test_adamw_step_matches_optax(jax_params):
    """One update from zero optimizer state on the same gradients."""
    jcfg, tcfg = _configs()
    x, t, m = _batch(128)
    _, grads = _jax_grads(jcfg, jax_params, x, t, m)
    tx = jtrain.default_optimizer()
    updates, _ = tx.update(grads, tx.init(jax_params), jax_params)
    ref = optax.apply_updates(jax_params, updates)

    model = _port_model(tcfg, jax_params)
    opt = ttrain.default_optimizer(model.parameters())
    tgrads = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in model.named_parameters():
        p.grad = tgrads[name].clone()
    opt.step()
    got = dict(
        jax.tree_util.tree_leaves_with_path(
            params_to_jax(dict(model.named_parameters()), tcfg)
        )
    )
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        np.testing.assert_allclose(
            got[path], np.asarray(leaf), atol=1e-6,
            err_msg=jax.tree_util.keystr(path),
        )


def test_flash_routing_follows_min_seq(monkeypatch):
    """attn_impl='flash' routes to the flash path only from flash_min_seq
    on, and only for lengths supports() accepts — as the JAX model does."""
    from torchft_tpu_torch.models import llama as tl

    calls = []
    real = tl.flash_attention
    monkeypatch.setattr(
        tl, "flash_attention",
        lambda *a, **k: calls.append(a[0].shape[1]) or real(*a, **k),
    )
    _, tcfg = _configs("flash", flash_min_seq=64)
    model = Transformer(dataclasses.replace(tcfg, num_layers=1))
    with torch.no_grad():
        for S in (32, 64, 100):
            model(torch.zeros(1, S, dtype=torch.long))
    assert calls == [64]


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Transformer(llama_debug(num_experts=4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Transformer(llama_debug(attn_impl="ring"))
