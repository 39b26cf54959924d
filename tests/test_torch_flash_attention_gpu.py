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
