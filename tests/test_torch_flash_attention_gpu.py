"""The port's three CUDA flash-attention kernels against their plain
PyTorch versions, on the card. Imports no JAX, so it runs where JAX is not
installed; tests/conftest.py imports JAX, so skip it there:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_attention_gpu.py

Without a CUDA device the test skips.
"""

import pytest
import torch

from torchft_tpu_torch.ops import flash_attention as T

import chip_smoke


def _assert_within(name, a, b, terms, dtype):
    """chip_smoke.py's element-wise limit for this output."""
    r = chip_smoke.compare(a, b, terms, chip_smoke.TOL[str(dtype)[6:]])
    assert r["share"] <= 1.0, f"{name}: {r['share']:.3g}x of its limit"


@pytest.mark.gpu
def test_kernels_match_plain_on_card():
    """The three CUDA kernels against their plain versions at the
    llama_small attention shape cut to B=2, in bf16 and fp32, element by
    element at chip_smoke.py's limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(0)
        mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)  # noqa: E731
        q, k, v, dout = mk(2, 1024, 12, 64), mk(2, 1024, 4, 64), mk(2, 1024, 4, 64), mk(2, 1024, 12, 64)
        out, lse = T.flash_fwd(q, k, v)
        out_r, lse_r = T.flash_attention_fwd_reference(q, k, v)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        terms = T.flash_attention_term_sums(q, k, v, dout, lse, delta)
        terms["lse"] = 1.0
        got = (
            out, lse, T.flash_bwd_dq(q, k, v, dout, lse, delta),
            *T.flash_bwd_dkv(q, k, v, dout, lse, delta),
        )
        ref = (out_r, lse_r, *T.flash_attention_bwd_reference(q, k, v, dout, lse, delta))
        for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, ref):
            _assert_within(
                f"{dtype} {name}", a, b, terms[name],
                torch.float32 if name == "lse" else dtype,
            )


@pytest.mark.gpu
@pytest.mark.parametrize("causal", (True, False), ids=("causal", "full"))
@pytest.mark.parametrize("q_per_kv", (1, 3, 4))
@pytest.mark.parametrize("S", (1, 63, 65, 200, 1000))
@pytest.mark.parametrize("D", (16, 32, 64, 128))
def test_bf16_tile_edges_on_card(D, S, q_per_kv, causal):
    """The bf16 kernels (all three on the tensor cores) at every
    head_dim, lengths off the 64-row tile, GQA ratios 1, 3 and 4, causal and
    not: every element of out, lse, dq, dk and dv within chip_smoke.py's
    limit (``TOL`` through ``flash_attention_term_sums``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    if S == 1:
        _check_one_key(2, 2 * q_per_kv, 2, D, causal, seed=D + q_per_kv)
        return
    chip_smoke.check_case(
        2, S, 2 * q_per_kv, 2, D, torch.bfloat16, causal, timed=False,
        seed=S * 10 + D + q_per_kv,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("D", (64, 128))
def test_bf16_dq_is_deterministic_on_card(D):
    """dq sums each q row over its kv tiles in a fixed order, with no
    atomics, so two calls on the same bf16 inputs give the same bits: the
    whole-sequence kernel (causal) and the block kernel at offsets
    (1024, 512) with an lse cotangent, at llama_small's heads cut to B=2.
    The drills' bitwise parameter checks rest on this."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    g = torch.Generator(device="cuda").manual_seed(D)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    B, S, Hq, Hkv = 2, 1024, 12, 4
    q, k, v, dout = mk(B, S, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D), mk(B, S, Hq, D)
    dlse = torch.randn(B, Hq, S, generator=g, device="cuda")
    out, lse = T.flash_fwd(q, k, v)
    delta = T._delta(dout, out)
    out_b, lse_b = T.flash_block_fwd(q, k, v, 1024, 512)
    delta_b = T._delta(dout, out_b)
    for name, call in (
        ("flash_bwd_dq", lambda: T.flash_bwd_dq(q, k, v, dout, lse, delta)),
        ("flash_block_bwd_dq", lambda: T.flash_block_bwd_dq(
            q, k, v, dout, lse_b, delta_b, dlse, 1024, 512)),
    ):
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.isfinite(first.float()).all(), name
        assert torch.equal(first.view(torch.int16), second.view(torch.int16)), (
            f"{name} at D={D}: two calls on the same inputs differ in "
            f"{int((first.view(torch.int16) != second.view(torch.int16)).sum())} elements"
        )


def _check_one_key(B, Hq, Hkv, D, causal, seed):
    """S = 1: every row sees one key, so P = 1, out = V, and the exact dq
    and dk are 0. out, lse and dv are held to ``TOL`` as at every length.
    dq and dk are held to their exact 0 instead: there dS = dP - delta is
    the difference of two fp32 sums of the same D exact bf16 products
    (dO.V and dO.O with O = V) taken in different orders, each off by at
    most (D - 1) 2^-24 A, A = sum_d |dO_d V_d|; both the kernel's and the
    plain version's dq = dS K scale and dk = sum over the group of
    dS Q scale stay within 2 (D - 1) 2^-24 (1 + 2^-8)^3 of A |K| scale and
    of sum A |Q| scale (dS and the output rounded to bf16, 2^-8 each; the
    group's fp32 sum, less).
    ``TOL``'s floor, 1e-5 * rms(plain), is 0 where every plain element is
    0, so it cannot hold this case."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)  # noqa: E731
    q, k, v, dout = mk(B, 1, Hq, D), mk(B, 1, Hkv, D), mk(B, 1, Hkv, D), mk(B, 1, Hq, D)
    out, lse = T.flash_fwd(q, k, v, causal)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = T.flash_bwd_dq(q, k, v, dout, lse, delta, causal)
    dk, dv = T.flash_bwd_dkv(q, k, v, dout, lse, delta, causal)
    out_r, lse_r = T.flash_attention_fwd_reference(q, k, v, causal)
    dq_r, dk_r, dv_r = T.flash_attention_bwd_reference(q, k, v, dout, lse, delta, causal)
    terms = T.flash_attention_term_sums(q, k, v, dout, lse, delta, causal)
    for name, a, b, t, dtype in (
        ("out", out, out_r, terms["out"], torch.bfloat16),
        ("lse", lse, lse_r, 1.0, torch.float32),
        ("dv", dv, dv_r, terms["dv"], torch.bfloat16),
    ):
        _assert_within(name, a, b, t, dtype)
    group = Hq // Hkv
    scale = D ** -0.5
    v_rep = v.float().repeat_interleave(group, dim=2)  # [B, 1, Hq, D]
    a = (dout.float().abs() * v_rep.abs()).sum(-1, keepdim=True)  # [B, 1, Hq, 1]
    eps = 2 * (D - 1) * 2.0**-24 * (1 + 2.0**-8) ** 3
    k_rep = k.float().abs().repeat_interleave(group, dim=2)
    limit_dq = eps * a * k_rep * scale
    limit_dk = (eps * a * q.float().abs() * scale).view(B, 1, Hkv, group, D).sum(3)
    for name, x, limit in (
        ("dq", dq, limit_dq), ("dq plain", dq_r, limit_dq),
        ("dk", dk, limit_dk), ("dk plain", dk_r, limit_dk),
    ):
        over = (x.float().abs() - limit).max()
        assert torch.isfinite(x.float()).all() and over <= 0, (
            f"{name} at S=1 exceeds its exact-zero limit by {float(over)}"
        )
