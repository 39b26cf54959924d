"""The port's mixture-of-experts MLP (``MoEMLP``, ``llama_moe_debug`` and the
router's aux loss) against the JAX package's, on the CPU in fp32.

Parameters are initialised by flax and carried across (the router kernel
transposed, the stacked experts as they are), inputs are made with numpy
from a seed, and both packages compute one function: outputs, the sown
aux term and every gradient are held to 1e-5 of their largest value.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.models.llama import MoEMLP as JMoEMLP
from torchft_tpu.models.llama import Transformer as JTransformer
from torchft_tpu.models.llama import llama_debug as jax_llama_debug
from torchft_tpu.models.llama import llama_moe_debug as jax_llama_moe_debug
from torchft_tpu.parallel import train as jtrain
from torchft_tpu_torch.models import llama_moe_debug
from torchft_tpu_torch.models.llama import (
    MLP,
    MoEMLP,
    Transformer,
    llama_debug,
    params_from_jax,
    params_to_jax,
    top_k_lower_index,
)
from torchft_tpu_torch.parallel import train as ttrain

TOL = 1e-5


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / (np.abs(ref).max() + 1e-12))


def _configs(**kw):
    return (
        jax_llama_debug(dtype=jnp.float32, **kw),
        llama_debug(dtype=torch.float32, **kw),
    )


def _flax_moe(jcfg, x, seed=1):
    params = JMoEMLP(jcfg).init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return jax.tree_util.tree_map(np.array, params)  # writable copies


def _port_moe(tcfg, params) -> MoEMLP:
    moe = MoEMLP(tcfg)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    moe.load_state_dict({
        "router.weight": t(params["router"]["kernel"].T),
        "experts_gate": t(params["experts_gate"]),
        "experts_up": t(params["experts_up"]),
        "experts_down": t(params["experts_down"]),
    })
    return moe


def _flax_apply(jcfg, params, x):
    out, inter = JMoEMLP(jcfg).apply(
        {"params": params}, x, mutable=["intermediates"]
    )
    return out, inter["intermediates"]["router_aux"][0]


def _check_moe(jcfg, tcfg, params, x, seed=7):
    """Output, aux and the gradients of <out, w> + aux (every parameter and
    the input) of the two packages on the same params and input."""
    w = np.random.default_rng(seed).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        out, aux = _flax_apply(jcfg, p, xx)
        return jnp.sum(out * w) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True
    )(params, jnp.asarray(x))

    moe = _port_moe(tcfg, params)
    tx = torch.from_numpy(x).requires_grad_()
    out = moe(tx)
    ((out * torch.from_numpy(w)).sum() + moe.aux).backward()
    assert _rel(out.detach().numpy(), jout) < TOL
    np.testing.assert_allclose(float(moe.aux.detach()), float(jaux), rtol=TOL)
    assert _rel(tx.grad.numpy(), jgx) < TOL
    got = {
        "router": moe.router.weight.grad.numpy().T,
        "experts_gate": moe.experts_gate.grad.numpy(),
        "experts_up": moe.experts_up.grad.numpy(),
        "experts_down": moe.experts_down.grad.numpy(),
    }
    for name, g in got.items():
        ref = jgp[name]["kernel"] if name == "router" else jgp[name]
        assert _rel(g, ref) < TOL, (name, _rel(g, ref))
    return out.detach().numpy(), moe


def _x(B=2, S=16, H=64, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, H)).astype(np.float32)


@pytest.mark.parametrize("experts,k", [(4, 2), (4, 1), (8, 2)])
def test_moe_mlp_output_aux_and_grads_match_flax(experts, k):
    jcfg, tcfg = _configs(num_experts=experts, num_experts_per_tok=k)
    x = _x()
    _check_moe(jcfg, tcfg, _flax_moe(jcfg, x), x)


def test_capacity_drop_matches_flax():
    """Capacity 1 token per expert (tests/test_models.py's case): at most
    E*C = 2 tokens get a nonzero output, the same tokens as in flax."""
    jcfg, tcfg = _configs(
        num_experts=2, num_experts_per_tok=1, expert_capacity_factor=2.0 / 16
    )
    x = _x(B=1)
    out, _ = _check_moe(jcfg, tcfg, _flax_moe(jcfg, x, seed=3), x)
    assert int(np.any(out != 0.0, axis=-1).sum()) <= 2


def test_one_expert_equals_the_dense_mlp():
    """E=1, k=1 with room for every token: routing is the identity with
    gate 1, so the MoE MLP computes the dense MLP on the expert's weights."""
    _, tcfg = _configs(
        num_experts=1, num_experts_per_tok=1, expert_capacity_factor=2.0
    )
    torch.manual_seed(0)
    moe = MoEMLP(tcfg)
    dense = MLP(dataclasses.replace(tcfg, num_experts=0))
    with torch.no_grad():
        dense.gate.weight.copy_(moe.experts_gate[0].T)
        dense.up.weight.copy_(moe.experts_up[0].T)
        dense.down.weight.copy_(moe.experts_down[0].T)
        x = torch.from_numpy(_x())
        torch.testing.assert_close(moe(x), dense(x), rtol=TOL, atol=TOL)
        # Uniform routing over one expert: f = p = 1, so aux = E * 1 = 1.
        assert float(moe.aux) == 1.0


def test_aux_value_matches_flax_and_is_one_at_uniform_routing():
    jcfg, tcfg = _configs(num_experts=4, num_experts_per_tok=2)
    x = _x(seed=4)
    params = _flax_moe(jcfg, x, seed=5)
    _, jaux = _flax_apply(jcfg, params, jnp.asarray(x))
    moe = _port_moe(tcfg, params)
    with torch.no_grad():
        moe(torch.from_numpy(x))
    np.testing.assert_allclose(float(moe.aux), float(jaux), rtol=TOL)
    # A zero router: every prob 1/E, every top-1 choice expert 0 (the lower
    # index wins the tie), so f = (1, 0, 0, 0) and aux = E * 1/E = 1.
    params["router"]["kernel"] = np.zeros_like(params["router"]["kernel"])
    _, jaux = _flax_apply(jcfg, params, jnp.asarray(x))
    moe = _port_moe(tcfg, params)
    with torch.no_grad():
        moe(torch.from_numpy(x))
    assert float(moe.aux) == float(jaux) == 1.0


def test_tied_router_probabilities_pick_the_experts_jax_picks():
    """Experts 0 and 3, and 1 and 2, get the same router column, so every
    token's probabilities tie in pairs; a zero router ties all four.
    jax.lax.top_k takes the lower index on a tie, and so must the port:
    the experts' weights differ, so the outputs show which were picked."""
    jcfg, tcfg = _configs(num_experts=4, num_experts_per_tok=2)
    x = _x(seed=6)
    params = _flax_moe(jcfg, x, seed=8)
    r = params["router"]["kernel"]
    r[:, 3] = r[:, 0]
    r[:, 2] = r[:, 1]
    _check_moe(jcfg, tcfg, params, x)
    params["router"]["kernel"] = np.zeros_like(r)
    _check_moe(jcfg, tcfg, params, x)

    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = top_k_lower_index(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# llama_moe_debug end to end: the train loss with its aux term
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_params():
    cfg = jax_llama_moe_debug(dtype=jnp.float32)
    params = JTransformer(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32)
    )["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_moe_params_round_trip(moe_params):
    tcfg = llama_moe_debug(dtype=torch.float32)
    sd = params_from_jax(moe_params)
    assert sd["layers.0.mlp.router.weight"].shape == (4, 64)
    assert sd["layers.1.mlp.experts_down"].shape == (4, 128, 64)
    Transformer(tcfg).load_state_dict(sd)  # every name and shape fits
    back = params_to_jax(sd, tcfg)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    ref = jax.tree_util.tree_leaves_with_path(moe_params)
    assert len(flat) == len(ref)
    for path, leaf in ref:
        np.testing.assert_array_equal(leaf, flat[path])


def test_expert_init_follows_lecun_normal():
    """The bits cannot match flax's; the distribution does: a normal
    truncated at two deviations, variance 1 / (in * E)."""
    torch.manual_seed(0)
    cfg = llama_debug(num_experts=8, num_experts_per_tok=2,
                      hidden_size=256, intermediate_size=512)
    moe = MoEMLP(cfg)
    for w, fan_in in ((moe.experts_gate.detach(), 256 * 8),
                      (moe.experts_down.detach(), 512 * 8)):
        std = (1.0 / fan_in) ** 0.5
        assert abs(float(w.std()) / std - 1.0) < 0.02
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978


@pytest.mark.parametrize("seq", [64, 100])
def test_moe_loss_and_every_grad_leaf_match_jax(moe_params, monkeypatch, seq):
    """``_loss_fn`` of llama_moe_debug, aux term included, on the chunked
    path (S=64 in 2 chunks of 32) and the full-logits path (S=100)."""
    monkeypatch.setattr(jtrain, "_LOSS_CHUNK", 32)
    monkeypatch.setattr(ttrain, "_LOSS_CHUNK", 32)
    jcfg = jax_llama_moe_debug(dtype=jnp.float32)
    tcfg = llama_moe_debug(dtype=torch.float32)
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (2, seq)).astype(np.int32)
    t, m = np.roll(x, -1, axis=1), np.ones_like(x)
    m[:, -3:] = 0
    jmodel = JTransformer(jcfg)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jtrain._loss_fn(jmodel, p, *map(jnp.asarray, (x, t, m)))
    )(moe_params)
    _, ref_aux = jtrain._apply_with_aux(jmodel, moe_params, jnp.asarray(x))

    model = Transformer(tcfg)
    model.load_state_dict(params_from_jax(moe_params))
    loss, grads = ttrain.grad_step(model, {
        "inputs": torch.from_numpy(x).long(),
        "targets": torch.from_numpy(t).long(),
        "mask": torch.from_numpy(m),
    })
    np.testing.assert_allclose(float(model.router_aux().detach()), float(ref_aux), rtol=TOL)
    assert float(ref_aux) > 1.0  # the aux term is in play, not its minimum
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(grads, tcfg)))
    ref = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(got) == len(ref)
    for path, leaf in ref:
        assert _rel(got[path], leaf) < TOL, (jax.tree_util.keystr(path), _rel(got[path], leaf))
    assert float(grads["layers.0.mlp.router.weight"].abs().sum()) > 0


def test_dense_loss_adds_no_aux_and_remat_keeps_the_moe_gradients():
    """A dense model has no aux term; a MoE model's gradients (aux term
    included) are the same with every block recomputed in the backward."""
    torch.manual_seed(0)
    assert Transformer(llama_debug(dtype=torch.float32)).router_aux() is None
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 32)))
    batch = {"inputs": x, "targets": torch.roll(x, -1, 1),
             "mask": torch.ones_like(x)}
    grads = {}
    for remat in (False, True):
        torch.manual_seed(0)
        model = Transformer(llama_moe_debug(dtype=torch.float32, remat=remat))
        _, g = ttrain.grad_step(model, batch)
        grads[remat] = {k: v.clone() for k, v in g.items()}
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=0, atol=0)


def test_router_names_are_the_routers_parameters():
    """``router_names`` lists each MoE layer's router weight, by the name
    ``grad_step`` keys its gradient under; a dense model has none."""
    torch.manual_seed(0)
    model = Transformer(llama_moe_debug(dtype=torch.float32))
    names = model.router_names()
    assert names == [f"layers.{i}.mlp.router.weight" for i in range(len(model.layers))]
    params = dict(model.named_parameters())
    assert all(params[n].shape == (model.cfg.num_experts, model.cfg.hidden_size) for n in names)
    assert Transformer(llama_debug(dtype=torch.float32)).router_names() == []
