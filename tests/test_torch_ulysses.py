"""The port's Ulysses attention (torchft_tpu_torch.parallel.ulysses) against
the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both. The port runs its
sp ranks on a mesh that repeats the CPU device; the JAX version runs on the
virtual CPU devices of tests/conftest.py. Where the gate picks flash, the JAX
kernels run in Pallas interpret mode and the port's wrappers take their
kernels' plain PyTorch versions. fp32 throughout; values and gradients are
held to 1e-5 of their largest value, those of the flash route to the JAX
tests' own limits for the flash kernel's reassociation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchft_tpu.models.llama as jllama
import torchft_tpu.ops.flash_attention as jflash
from torchft_tpu.models.llama import llama_debug as jax_llama_debug
from torchft_tpu.parallel import make_mesh as jax_make_mesh
from torchft_tpu.parallel import train as jtrain
from torchft_tpu.parallel.ulysses import _kv_expand_factor as jax_expand
from torchft_tpu.parallel.ulysses import make_ulysses_attention as jax_ulysses
from torchft_tpu_torch.models.llama import llama_debug, params_from_jax, params_to_jax
from torchft_tpu_torch.ops import flash_attention as T
from torchft_tpu_torch.parallel import build_model, make_mesh, make_ulysses_attention
from torchft_tpu_torch.parallel import train as ttrain
from torchft_tpu_torch.parallel import ulysses as U

CPU = torch.device("cpu")
TOL = 1e-5


def _rel(got, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / (np.abs(ref).max() + 1e-12))


def test_kv_expand_factor_matches_jax():
    for hq in range(1, 17):
        for hkv in (h for h in range(1, hq + 1) if hq % h == 0):
            for sp in (1, 2, 3, 4, 8):
                assert U._kv_expand_factor(hq, hkv, sp) == jax_expand(hq, hkv, sp), (
                    hq, hkv, sp,
                )


@pytest.mark.parametrize(
    "sp, B, S, hq, hkv, D, use_flash",
    [
        (2, 2, 32, 4, 2, 16, None),  # tests/test_parallel.py's sp=2 case
        (4, 1, 64, 8, 2, 8, None),  # its GQA expand: 2 kv heads -> 4
        (4, 1, 32, 4, 1, 8, None),  # one kv head -> 4 (full MHA expand)
        (2, 1, 512, 2, 1, 16, True),  # the flash route over the re-shard
    ],
)
def test_ulysses_matches_jax_ulysses(sp, B, S, hq, hkv, D, use_flash):
    """Output and the gradients of <out, w> of the port's Ulysses on a
    repeated CPU device against the JAX version on sp virtual devices."""
    rng = np.random.default_rng(sp * 100 + S)
    q, k, v, w = (
        rng.standard_normal(s).astype(np.float32)
        for s in ((B, S, hq, D), (B, S, hkv, D), (B, S, hkv, D), (B, S, hq, D))
    )
    july = jax_ulysses(jax_make_mesh(sp=sp), use_flash=use_flash)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout = jax.jit(july)(jq, jk, jv)
    jgrads = jax.jit(
        jax.grad(lambda a, b, c: jnp.sum(july(a, b, c) * w), (0, 1, 2))
    )(jq, jk, jv)

    uly = make_ulysses_attention(make_mesh(sp=sp, devices=[CPU] * sp), use_flash=use_flash)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    for name in T.LAUNCHES:
        T.LAUNCHES[name] = 0
    out = uly(tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.shape == (B, S, hq, D)
    if use_flash:
        # The Pallas kernel folds 512 keys in blocks where the plain
        # version sums them at once: the JAX tests' own limits for that
        # reassociation, flash against dense (tests/test_ops.py, atol 2e-5)
        # and Ulysses gradients (tests/test_parallel.py, atol 1e-4).
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5)
        for got, ref in zip((tq.grad, tk.grad, tv.grad), jgrads):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    else:
        assert _rel(out.detach().numpy(), jout) < TOL
        for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
            assert _rel(got.numpy(), ref) < TOL, (name, _rel(got.numpy(), ref))
    # CPU tensors take the plain versions: no kernel launch is counted.
    assert not any(T.LAUNCHES.values())


@pytest.mark.parametrize("sp", [1, 2])
def test_gate_chooses_flash_or_dense_as_jax(monkeypatch, sp):
    """The Ulysses gate is its own, not the model's flash_min_seq: flash
    when asked, or by default when causal with a whole sequence of at least
    1024, and only for lengths ``supports`` takes. Both packages' attention
    calls are replaced by spies; JAX is only traced."""
    picked = {}

    def spy(pkg, kind, zeros):
        return lambda q, *a, **kw: picked[pkg].append(kind) or zeros(q)

    monkeypatch.setattr(jflash, "flash_attention", spy("jax", "flash", jnp.zeros_like))
    monkeypatch.setattr(jllama, "dense_attention", spy("jax", "dense", jnp.zeros_like))
    monkeypatch.setattr(U, "flash_attention", spy("torch", "flash", torch.zeros_like))
    monkeypatch.setattr(U, "dense_attention", spy("torch", "dense", torch.zeros_like))
    for S in (256, 512, 1000, 1024, 1040, 2048):
        for causal in (True, False):
            for use_flash in (None, True, False):
                picked.update(jax=[], torch=[])
                x = np.zeros((1, S, 2, 8), np.float32)
                jfn = jax_ulysses(jax_make_mesh(sp=sp), causal=causal, use_flash=use_flash)
                jax.eval_shape(jfn, *(jnp.asarray(x),) * 3)
                if causal:
                    tfn = make_ulysses_attention(
                        make_mesh(sp=sp, devices=[CPU] * sp), use_flash=use_flash
                    )
                    tfn(*(torch.from_numpy(x),) * 3)
                else:  # the port's attention is causal; its body is not
                    U.ulysses_attention_shard(
                        *(torch.from_numpy(x),) * 3, causal=False,
                        use_flash=use_flash,
                    )
                case = (S, causal, use_flash)
                # JAX traces its SPMD body once; the port runs it per rank.
                assert len(picked["jax"]) == 1, (case, picked)
                assert picked["torch"] == picked["jax"] * (sp if causal else 1), (
                    case, picked,
                )
                want = (use_flash if use_flash is not None else causal and S >= 1024)
                want = want and T.supports(S)
                assert picked["torch"][0] == ("flash" if want else "dense"), case


def test_ulysses_refuses_sharded_batch_or_heads_and_odd_heads():
    """A mesh one process holds whole with fsdp=2, or with tp=2 beside
    sp=2, runs Ulysses over the rows and heads it is given (this rank's
    rows, this rank's tp heads), as the sp=2 mesh alone does. Heads that do
    not divide over sp still raise."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 32, 4, 8, generator=gen)
    kv = torch.randn(2, 32, 2, 8, generator=gen)
    alone = make_ulysses_attention(make_mesh(sp=2, devices=[CPU] * 2))
    for axes in (dict(fsdp=2), dict(tp=2)):
        sharded = make_ulysses_attention(make_mesh(sp=2, **axes, devices=[CPU] * 4))
        assert torch.equal(sharded(q, kv, kv), alone(q, kv, kv)), axes
    uly = make_ulysses_attention(make_mesh(sp=4, devices=[CPU] * 4))
    x = torch.zeros(1, 32, 6, 8)
    with pytest.raises(ValueError, match="heads"):
        uly(x, x[:, :, :2], x[:, :, :2])


def test_llama_ulysses_sp2_logits_and_every_grad_leaf_match_jax(monkeypatch):
    """llama_debug with attn_impl='ulysses' at sp=2 (dense attention over
    the whole 128-token sequence on each rank's 2 q heads and 1 kv head):
    logits, the chunked loss and every gradient leaf against JAX."""
    monkeypatch.setattr(jtrain, "_LOSS_CHUNK", 32)
    monkeypatch.setattr(ttrain, "_LOSS_CHUNK", 32)
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (2, 128)).astype(np.int32)
    t, m = np.roll(x, -1, axis=1), np.ones_like(x)
    m[:, -3:] = 0
    jmodel = jtrain.build_model(
        jax_llama_debug(dtype=jnp.float32, attn_impl="ulysses"), jax_make_mesh(sp=2)
    )
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model = build_model(
        llama_debug(dtype=torch.float32, attn_impl="ulysses"),
        make_mesh(sp=2, devices=[CPU] * 2),
    )
    model.load_state_dict(params_from_jax(params))

    ref_logits = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        logits = model(torch.from_numpy(x).long())
    assert _rel(logits.numpy(), ref_logits) < TOL

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jtrain._loss_fn(jmodel, p, *map(jnp.asarray, (x, t, m)))
    ))(params)
    loss, grads = ttrain.grad_step(model, {
        "inputs": torch.from_numpy(x).long(),
        "targets": torch.from_numpy(t).long(),
        "mask": torch.from_numpy(m),
    })
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=TOL)
    got = dict(jax.tree_util.tree_leaves_with_path(params_to_jax(grads, model.cfg)))
    ref = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(got) == len(ref)
    for path, leaf in ref:
        assert _rel(got[path], leaf) < TOL, (jax.tree_util.keystr(path), _rel(got[path], leaf))


def test_chip_smoke_ulysses_check_holds_in_bf16_on_cpu():
    """chip_smoke.py's Ulysses check (sp=4, the flash gate's whole-sequence
    route; on the CPU the plain versions) within its ring limit, at a
    smaller shape: 4 q heads and 2 kv heads, expanded to one a rank."""
    import chip_smoke

    rec = chip_smoke.check_sequence_parallel(
        make_ulysses_attention, B=1, S=1024, Hq=4, Hkv=2, D=32, sp=4, device=CPU, seed=0)
    assert all(r["share"] <= 1.0 for r in rec["outputs"].values()), rec
