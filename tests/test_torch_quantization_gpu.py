"""The port's CUDA quantize, dequantize and fused int8 reduce kernels against
their plain PyTorch versions and the host quantizer, bit for bit, on the
card. Imports no JAX, so it runs where JAX is not installed;
tests/conftest.py imports JAX, so skip it there:

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


@pytest.mark.gpu
@pytest.mark.parametrize("avg", [False, True])
@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 5, 6, 7, 8, 9, 12])
def test_reduce_kernel_matches_plain_and_host_on_card(ranks, avg):
    """chip_smoke.py's reduce cases, on row counts that are not multiples
    of 32 too, at every R the kernel is compiled for (1 to 8) and at run
    time (9, 12), averaging by a multiply for R a power of two and by a
    divide otherwise: seeded rows, special rows, tie-heavy rows (exact
    half-integer quotients) and quotient-boundary rows (quotients within a
    few ulps of the half-integers and around the kernel's guard band,
    scales subnormal, near 2^-128 and near 2^121). 0 differing payload
    bytes and scale bits against the plain version and the host's
    reduce."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    for rows in (1, 5, 33, 1000):
        chip_smoke.reduce_case(
            "seeded", *chip_smoke.reduce_inputs(ranks, rows, seed=rows), avg
        )
    chip_smoke.reduce_case(
        "special rows", *chip_smoke.reduce_special_inputs(ranks), avg
    )
    for seed in (11, 12):
        chip_smoke.reduce_case(
            "tie-heavy", *chip_smoke.reduce_tie_inputs(ranks, 1000, seed), avg
        )
        chip_smoke.reduce_case(
            "quotient boundary", *chip_smoke.reduce_boundary_inputs(ranks, seed),
            avg,
        )


@pytest.mark.gpu
def test_reduce_kernel_counts_its_launches_and_takes_views():
    """One launch per call; a payload that starts off a 16-byte boundary
    takes the kernel's scalar accesses and the same bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    from torchft_tpu_torch.ops import quantization as Q

    q_host, s_host = chip_smoke.reduce_inputs(3, 7, seed=5)
    q = torch.from_numpy(q_host).cuda()
    s = torch.from_numpy(s_host).cuda()
    before = Q.LAUNCHES["reduce"]
    q_out, s_out = Q.fused_reduce_int8(q, s)
    assert Q.LAUNCHES["reduce"] == before + 1
    shifted = torch.empty(q.numel() + 1, dtype=torch.int8, device="cuda")
    view = shifted[1:].view(q.shape)
    view.copy_(q)
    q_view, s_view = Q.fused_reduce_int8(view, s)
    torch.cuda.synchronize()
    assert torch.equal(q_view, q_out) and torch.equal(s_view, s_out)
