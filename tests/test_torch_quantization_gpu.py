"""The port's CUDA quantize and dequantize kernels against their plain
PyTorch versions and the host quantizer, bit for bit, on the card. Imports
no JAX, so it runs where JAX is not installed; tests/conftest.py imports
JAX, so skip it there:

    python -m pytest --noconftest -m gpu tests/test_torch_quantization_gpu.py

Without a CUDA device the tests skip.
"""

import pytest
import torch

import chip_smoke


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_kernels_match_plain_and_host_on_card(bits, monkeypatch):
    """chip_smoke.py's cases at smaller sizes, the transfer chunk cut so
    that the chunked route runs: 0 differing payload bytes, scale bits and
    dequantized bits against the plain versions and the host quantizer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    from torchft_tpu_torch.ops import quantization as Q

    monkeypatch.setattr(Q, "_TRANSFER_CHUNK", 64 * Q.BLOCK)
    for i, n in enumerate((1, 511, 512, 513, 4103, 3 * 64 * Q.BLOCK + 777)):
        chip_smoke.quantize_case(f"n={n}", chip_smoke.seeded_values(n, i), bits)
    chip_smoke.quantize_case("special values", chip_smoke.special_values(bits), bits)


@pytest.mark.gpu
def test_kernels_count_their_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    from torchft_tpu_torch.ops import quantization as Q

    before = dict(Q.LAUNCHES)
    q, s, n = Q.fused_quantize(torch.ones(1000, device="cuda"), 8)
    Q.fused_dequantize(q, s, n, 8)
    assert Q.LAUNCHES["quantize"] == before["quantize"] + 1
    assert Q.LAUNCHES["dequantize"] == before["dequantize"] + 1
