"""The port's flash attention (torchft_tpu_torch.ops.flash_attention) against
the JAX package's Pallas kernels, run in interpret mode on the CPU.

Inputs are made with numpy from a seed and handed to both. On the CPU the
port's wrappers take their kernels' plain PyTorch versions (the tensors lie
on the CPU); the CUDA kernels themselves are held against those plain
versions on the card (test_torch_flash_attention_gpu.py, and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.models.llama import dense_attention as jax_dense
from torchft_tpu.ops import flash_attention as J
from torchft_tpu_torch.ops import flash_attention as T

import chip_smoke


def _qkv(B=2, S=256, Hq=4, Hkv=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))
    )


def _torch(arrays, dtype=torch.float32, grad=False):
    return [
        torch.from_numpy(a).to(dtype).requires_grad_(grad) for a in arrays
    ]


def test_forward_matches_jax_fp32():
    q, k, v = _qkv()
    out = T.flash_attention(*_torch((q, k, v))).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(
        out, np.asarray(J.flash_attention(jq, jk, jv)), atol=2e-5
    )
    np.testing.assert_allclose(
        out, np.asarray(jax_dense(jq, jk, jv)), atol=2e-5
    )


def test_forward_matches_jax_bf16():
    q, k, v = _qkv()
    out = T.flash_attention(*_torch((q, k, v), torch.bfloat16))
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    for ref in (J.flash_attention(jq, jk, jv), jax_dense(jq, jk, jv)):
        np.testing.assert_allclose(
            out, np.asarray(ref, np.float32), atol=3e-2
        )


def test_lse_matches_jax_forward_impl():
    q, k, v = _qkv()
    _, lse = T.flash_attention_fwd_reference(*_torch((q, k, v)))
    t = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)  # noqa: E731
    _, jlse = J._forward_impl(t(q), t(k), t(v), True, 256, 256, True)
    assert lse.shape == (2, 4, 256)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(jlse)[:, :, 0], atol=1e-5
    )


def test_gradients_match_jax():
    q, k, v = _qkv(B=1)
    tq, tk, tv = _torch((q, k, v), grad=True)
    (T.FlashAttentionFunction.apply(tq, tk, tv, True) ** 2).sum().backward()
    grads = jax.grad(
        lambda a, b, c: jnp.sum(J.flash_attention(a, b, c) ** 2), (0, 1, 2)
    )(*map(jnp.asarray, (q, k, v)))
    for ref, got in zip(grads, (tq.grad, tk.grad, tv.grad)):
        ref = np.asarray(ref)
        rel = np.abs(got.numpy() - ref).max() / (np.abs(ref).max() + 1e-9)
        assert rel < 1e-4, rel


def test_bwd_reference_is_split_of_wrappers():
    """The dq and dk/dv wrappers' plain versions are the two halves of
    flash_attention_bwd_reference, on the same lse and delta."""
    q, k, v = _torch(_qkv(S=128))
    dout = torch.from_numpy(
        np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    )
    out, lse = T.flash_fwd(q, k, v)
    delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = T.flash_attention_bwd_reference(q, k, v, dout, lse, delta)
    torch.testing.assert_close(T.flash_bwd_dq(q, k, v, dout, lse, delta), dq)
    dk2, dv2 = T.flash_bwd_dkv(q, k, v, dout, lse, delta)
    torch.testing.assert_close(dk2, dk)
    torch.testing.assert_close(dv2, dv)
    assert dk.shape == k.shape and dq.shape == q.shape


def test_causality():
    """Perturbing future tokens must not change earlier outputs."""
    q, k, v = _qkv(B=1)
    k2, v2 = k.copy(), v.copy()
    k2[:, 200:] = 99.0
    v2[:, 200:] = -99.0
    out = T.flash_attention(*_torch((q, k, v))).numpy()
    out2 = T.flash_attention(*_torch((q, k2, v2))).numpy()
    np.testing.assert_array_equal(out[:, :200], out2[:, :200])
    assert not np.allclose(out[:, 200:], out2[:, 200:])


@pytest.mark.parametrize("seq", [16, 48, 64, 100, 128, 256, 384, 512, 1000, 1024, 2048])
@pytest.mark.parametrize("blocks", [(512, 512), (128, 256), (64, 64), (24, 32)])
def test_supports_agrees_with_jax(seq, blocks):
    assert T.supports(seq, *blocks) == J.supports(seq, *blocks)


def test_unsupported_seq_len_raises():
    assert not T.supports(100)
    with pytest.raises(ValueError):
        T.flash_attention(*_torch(_qkv(S=100)))


def test_wrapper_refuses_non_cuda_device():
    """Off the CPU a wrapper launches its kernel or raises: tensors on any
    other device never reach the plain version."""
    q, k, v = (torch.empty(1, 64, 2, 16, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="CUDA"):
        T.flash_fwd(q, k, v)


def _assert_within(name, a, b, terms, dtype):
    """chip_smoke.py's element-wise limit for this output."""
    r = chip_smoke.compare(a, b, terms, chip_smoke.TOL[str(dtype)[6:]])
    assert r["share"] <= 1.0, f"{name}: {r['share']:.3g}x of its limit"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_plain_within_element_limit_of_jax_kernels(dtype):
    """The Pallas kernels (interpret mode) round P where the CUDA kernels
    do (the online softmax's unnormalised P), so they must sit inside the
    element-wise limit the CUDA kernels are held to against the plain
    versions. The backward is compared on the same lse and delta in fp32
    only: in bf16 the Pallas kernels also round dP."""
    B, S, Hq, Hkv, D = 2, 256, 4, 2, 64
    q, k, v = _qkv(B, S, Hq, Hkv, D)
    dout = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    sw = lambda a: jnp.swapaxes(jnp.asarray(a, jdt), 1, 2)  # noqa: E731
    un = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(jnp.swapaxes(a, 1, 2), np.float32)
    )
    tq, tk, tv, tdo = _torch((q, k, v, dout), dtype)
    out, lse = T.flash_attention_fwd_reference(tq, tk, tv)
    delta = (tdo.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    terms = T.flash_attention_term_sums(tq, tk, tv, tdo, lse, delta)
    jout, jlse = J._forward_impl(sw(q), sw(k), sw(v), True, 64, 64, True)
    _assert_within("out", un(jout), out, terms["out"], dtype)
    _assert_within(
        "lse", torch.from_numpy(np.array(jlse[:, :, 0])), lse, 1.0,
        torch.float32,
    )
    # A sum of |terms| bounds the sum (up to the output's rounding).
    assert (terms["out"] >= out.float().abs() * (1 - 2**-7) - 1e-6).all()
    if dtype != torch.float32:
        return
    rows = lambda x: jnp.broadcast_to(  # noqa: E731
        jnp.asarray(x.numpy())[:, :, None, :], (B, Hq, 8, S)
    )
    got = J._backward_impl(
        sw(q), sw(k), sw(v), sw(dout), rows(lse), rows(delta),
        True, 64, 64, True,
    )
    ref = T.flash_attention_bwd_reference(tq, tk, tv, tdo, lse, delta)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _assert_within(name, un(a), b, terms[name], dtype)
        assert (terms[name] >= b.abs() - 1e-6).all(), name
