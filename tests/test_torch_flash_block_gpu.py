"""The port's three CUDA offset-block flash kernels (ring attention's fold)
against their plain PyTorch versions, on the card. Imports no JAX, so it
runs where JAX is not installed; tests/conftest.py imports JAX, so skip it
there:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_block_gpu.py

Without a CUDA device the tests skip.
"""

import pytest
import torch

import chip_smoke


@pytest.mark.gpu
@pytest.mark.parametrize(
    "dtype, offsets",
    [
        (torch.bfloat16, (0, 0)),
        (torch.bfloat16, (1024, 0)),
        (torch.bfloat16, (1024, 512)),
        (torch.bfloat16, (0, 1024)),
        (torch.float32, (1024, 512)),
    ],
    ids=str,
)
def test_block_kernels_match_plain_on_card(dtype, offsets):
    """Out (on rows that see a key), lse, dq, dk and dv element by element
    at chip_smoke.py's limit, at llama_small's heads cut to B=2; at (0,1024)
    every key is masked: out 0, lse <= -1e29, zero gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.check_block_case(
        2, 1024, 1024, 12, 4, 64, dtype, *offsets, timed=False, seed=0
    )


@pytest.mark.gpu
def test_block_kernels_ragged_shapes_on_card():
    """Sq != Skv, lengths and offsets that are not multiples of the tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.check_block_case(
        1, 200, 328, 4, 2, 32, torch.float32, 300, 100, timed=False, seed=1
    )
    chip_smoke.check_block_case(
        2, 96, 160, 8, 2, 128, torch.bfloat16, 64, 0, timed=False, seed=2
    )


@pytest.mark.gpu
def test_ring_sp4_on_repeated_card():
    """make_ring_attention at sp=4 on a mesh that repeats the card: 16
    launches of each block kernel, out and gradients within the ring
    limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = chip_smoke.check_ring(1, 2048, 12, 4, 64, 4, "cuda", seed=3)
    for name in chip_smoke.BLOCK_KERNELS:
        assert rec["launches"][name] == 16, rec["launches"]
    assert all(r["share"] <= 1.0 for r in rec["outputs"].values()), rec


@pytest.mark.gpu
@pytest.mark.parametrize("offsets", chip_smoke.BLOCK_OFFSETS, ids=str)
@pytest.mark.parametrize("D", (16, 32, 64, 128))
def test_bf16_block_head_dims_on_card(D, offsets):
    """The bf16 block kernels at every head_dim, at chip_smoke.py's offsets
    on Sq = Skv = 1024, each element within its limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    q_per_kv = {16: 1, 32: 4, 64: 3, 128: 4}[D]
    chip_smoke.check_block_case(
        1, 1024, 1024, 2 * q_per_kv, 2, D, torch.bfloat16, *offsets,
        timed=False, seed=D,
    )


@pytest.mark.gpu
@pytest.mark.parametrize(
    "Sq, Skv, q_off, k_off",
    [(63, 65, 0, 0), (200, 328, 300, 100), (1000, 200, 0, 64),
     (65, 1000, 960, 0)],
    ids=str,
)
@pytest.mark.parametrize("q_per_kv", (1, 3, 4))
@pytest.mark.parametrize("D", (16, 32, 64, 128))
def test_bf16_block_ragged_on_card(D, q_per_kv, Sq, Skv, q_off, k_off):
    """Sq != Skv, lengths off the tile and offsets off the tile, in bf16 at
    every head_dim and GQA ratio (rows that see no key: out 0, lse -1e30)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.check_block_case(
        2, Sq, Skv, 2 * q_per_kv, 2, D, torch.bfloat16, q_off, k_off,
        timed=False, seed=Sq + Skv + D + q_per_kv,
    )
