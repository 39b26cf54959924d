"""The fused int8 reduce kernel's divide-free arithmetic, modelled in numpy
float32 step for step, against the host's reduce, bit for bit.

The kernel (``torchft_tpu_torch/ops/csrc/quantization.cu``,
``reduce_rows_int8_kernel``) decodes int8 with a magic float instead of a
conversion, multiplies by 1/R for a power-of-two R, multiplies by the row
scale's reciprocal instead of dividing and takes the correctly rounded
divide only within a guard band of the half-integers (or for a whole row
whose reciprocal is not finite), and rounds and casts with a magic add.
This model does the same steps in the same order, each a float32 numpy
operation rounded once as the card's ``__fadd_rn`` / ``__fmul_rn`` /
``__frcp_rn`` / ``__fdiv_rn`` are, with the constants read from the CUDA
source, so it cannot drift from the kernel. The host's reduce is each
rank's ``dequantize_blockwise`` summed in rank order, divided by
np.float32(R) if averaging, and ``quantize_blockwise`` (both packages'
host quantizers). The kernel itself is held to the same bytes on the card
(chip_smoke.py phase 5, tests/test_torch_quantization_gpu.py).
"""

import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from torchft_tpu import collectives as jcoll
from torchft_tpu_torch import collectives as tcoll
from torchft_tpu_torch.ops import quantization as Q

import chip_smoke

SOURCE = (
    Path(__file__).resolve().parent.parent
    / "torchft_tpu_torch" / "ops" / "csrc" / "quantization.cu"
)
F32 = np.float32


def _constant(name: str) -> str:
    m = re.search(rf"constexpr \w+ {name} = ([0-9A-Fa-fx.p+-]+?)[uf]?;",
                  SOURCE.read_text())
    assert m, f"{name} not found in {SOURCE.name}"
    return m.group(1)


DECODE_BITS = int(_constant("kDecodeBits"), 16)
DECODE_FLIP = int(_constant("kDecodeFlip"), 16)
DECODE_BIAS = F32(_constant("kDecodeBias"))
RINT_MAGIC = F32(_constant("kRintMagic"))
GUARD = F32(float.fromhex(_constant("kQuotientGuard")))
NEAR_HALF = F32(0.5) - GUARD


def decode(q: np.ndarray) -> np.ndarray:
    """int8 -> float32 as the kernel: (b ^ 0x80) under 2^23's bits, minus
    2^23 + 128."""
    b = q.view(np.uint8).astype(np.uint32) ^ (DECODE_FLIP & 0xFF)
    return (b | DECODE_BITS).view(F32) - DECODE_BIAS


def model_requantize(x: np.ndarray):
    """x fp32 [rows, 512] -> (int8 [rows * 512], fp32 scales [rows], the
    share of values that took the correctly rounded divide), as the
    kernel's ``requantize_row``: lane l of a row's warp holds values 16 l
    to 16 l + 15."""
    with np.errstate(all="ignore"):
        scale = np.abs(x).max(axis=1) / F32(127)  # NaN if the row holds one
        scale = np.where(scale == 0, F32(1), scale).astype(F32)
        inv = F32(1) / scale
        fast = (inv > 0) & (inv <= np.finfo(F32).max)
        t = x * inv[:, None]
        m = t + RINT_MAGIC
        far = np.abs(t - (m - RINT_MAGIC)).reshape(-1, 32, 16).max(axis=2)
        # A lane (16 consecutive values) with any value within the guard
        # band, and a whole row whose reciprocal is not finite, divide.
        near = np.repeat(far >= NEAR_HALF, 16, axis=1)
        exact = x / scale[:, None]
        exact = np.where(np.isnan(exact), F32(0), np.clip(exact, F32(-127), F32(127)))
        slow = near | ~fast[:, None]
        m = np.where(slow, exact.astype(F32) + RINT_MAGIC, m).astype(F32)
    q = (m.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    return q.reshape(-1), scale, float(slow.mean())


def model_reduce(q: np.ndarray, s: np.ndarray, avg: bool):
    """q int8 [R, rows, 512], s fp32 [R, rows] -> model_requantize of the
    kernel's rank sum: rank 0's products as they are, each later product
    and sum rounded once, then x 1/R (R a power of two) or / R."""
    ranks = q.shape[0]
    with np.errstate(all="ignore"):
        acc = decode(q[0]) * s[0][:, None]
        for r in range(1, ranks):
            acc = acc + decode(q[r]) * s[r][:, None]
        if avg:
            if ranks & (ranks - 1) == 0:
                acc = acc * F32(1.0 / ranks)
            else:
                acc = acc / F32(ranks)
    return model_requantize(acc.astype(F32))


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a).reshape(-1)
    return a.view(np.uint32) if a.dtype == F32 else a


def _assert_same(got, want, what: str) -> None:
    """Bit for bit; any NaN equals any NaN."""
    (gq, gs), (wq, ws) = got, want
    assert np.count_nonzero(_bits(gq) != _bits(wq)) == 0, f"{what}: payload"
    differ = (_bits(gs) != _bits(ws)) & ~(np.isnan(gs) & np.isnan(ws))
    assert np.count_nonzero(differ) == 0, f"{what}: scales"


def _host_quantize(x: np.ndarray):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = tcoll.quantize_blockwise(x.reshape(-1))
        _assert_same(jcoll.quantize_blockwise(x.reshape(-1)), want, "host quantizers")
    return want


def test_constants_are_what_the_arithmetic_needs():
    """The decode bias is 2^23 + 128 under the bits of 2^23; the magic add
    is 1.5 * 2^23; the guard exceeds the largest gap between the
    reciprocal quotient and the divided one, 3u * 127 (1 + 2^-21) plus its
    u^2 terms, u = 2^-24, and is far below 0.5."""
    assert DECODE_BITS == np.array(2.0**23, F32).view(np.uint32)
    assert DECODE_FLIP == 0x80808080 and DECODE_BIAS == 2**23 + 128
    assert RINT_MAGIC == 1.5 * 2**23
    u = 2.0**-24
    gap = 127 * (1 + 2.0**-21) * ((1 + u) ** 3 - 1) + 2.0**-149
    assert gap < float(GUARD) < 2.0**-8
    assert float(NEAR_HALF) == 0.5 - float(GUARD)  # exact in fp32


def test_decode_is_every_int8():
    q = np.arange(-128, 128, dtype=np.int8)
    np.testing.assert_array_equal(decode(q), q.astype(F32))


def test_magic_rint_and_byte_are_rint_and_the_int8_cast():
    """For float32 t on every half-integer and integer of (-127.5, 127.5),
    one ulp either side, and a sweep between, t + 1.5 * 2^23 rounds to
    rint(t) (half to even), and its low byte is the two's-complement int8."""
    k = np.arange(-128, 128, dtype=np.float64)
    pts = np.concatenate([k + 0.5, k, np.linspace(-127.5, 127.5, 200001)]).astype(F32)
    t = np.concatenate([pts, np.nextafter(pts, F32(np.inf)),
                        np.nextafter(pts, F32(-np.inf))])
    t = t[np.abs(t) < 127.5]
    m = t + RINT_MAGIC
    np.testing.assert_array_equal(m - RINT_MAGIC, np.rint(t))
    byte = (m.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    np.testing.assert_array_equal(byte, np.rint(t).astype(np.int8))


def _boundary_rows(scale_exps, seed: int) -> np.ndarray:
    """Rows whose quotients sit on every k + 0.5, k = -128..127, and one
    ulp either side: per row an absmax in column 0 with a random mantissa
    at 127 * 2^e, its scale fl(absmax / 127), and x = fl((k + 0.5) *
    scale) and its two float neighbours in the other columns."""
    rng = np.random.default_rng(seed)
    halves = np.arange(-128, 128, dtype=np.float64) + 0.5
    rows = []
    for e in scale_exps:
        with np.errstate(over="ignore"):  # past the largest float: dropped
            absmax = F32(min(127 * rng.uniform(1.0, 2.0) * 2.0**e, np.finfo(F32).max))
            scale = absmax / F32(127)
            scale = F32(1) if scale == 0 else scale
            x = (halves * np.float64(scale)).astype(F32)
        x = np.concatenate([x, np.nextafter(x, F32(np.inf)), np.nextafter(x, F32(-np.inf))])
        x = x[np.abs(x) <= absmax]
        for start in range(0, x.size, 511):
            row = np.zeros(512, F32)
            row[0] = absmax if start % 2 == 0 else -absmax
            chunk = x[start:start + 511]
            row[1:1 + chunk.size] = chunk
            rows.append(row)
    return np.stack(rows)


# Subnormal scales, scales near 2^-128 (where 1/scale overflows), normal
# ones, and scales near 2^121 (absmax near the largest float).
SCALE_EXPS = (
    -149, -147, -140, -133, -130, -129, -128.5, -128, -127.5, -127, -126,
    -125, -100, -40, -3, 0, 7, 40, 100, 119, 120, 120.5, 121,
)


def test_requantize_is_the_host_quantizer_at_every_half_integer():
    x = _boundary_rows(SCALE_EXPS, seed=0)
    q, s, exact_share = model_requantize(x)
    _assert_same((q, s), _host_quantize(x), "boundary rows")
    # The rows put a third of their values on the half-integers themselves,
    # where the reciprocal cannot decide: their lanes take the divide.
    assert exact_share > 0.5


def test_requantize_of_nan_inf_and_zero_rows():
    x = np.random.default_rng(1).standard_normal((6, 512)).astype(F32)
    x[0, 5] = np.nan
    x[1, 9] = np.inf
    x[2, 3] = -np.inf
    x[3] = 0.0
    x[4, ::2] = -0.0
    x[4, 1::2] = 0.0
    x[5] = 1e-45
    q, s, _ = model_requantize(x)
    _assert_same((q, s), _host_quantize(x), "special rows")


CASES = {
    "seeded": lambda r, seed: chip_smoke.reduce_inputs(r, 37, seed),
    "special rows": lambda r, seed: chip_smoke.reduce_special_inputs(r),
    "tie-heavy": lambda r, seed: chip_smoke.reduce_tie_inputs(r, 200, seed),
    "quotient boundary": lambda r, seed: chip_smoke.reduce_boundary_inputs(r, seed),
}


@pytest.mark.parametrize("avg", [False, True])
@pytest.mark.parametrize("ranks", [2, 3, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_model_reduce_is_the_host_reduce(case, ranks, avg):
    """chip_smoke.py's phase-5 inputs: the model, the plain version and the
    host's reduce write the same bytes."""
    q, s = CASES[case](ranks, 30 + ranks)
    want = chip_smoke.reduce_host(q, s, avg)
    got = model_reduce(q, s, avg)
    _assert_same(got[:2], want, f"model, {case}")
    qo, so = Q.fused_reduce_int8(torch.from_numpy(q), torch.from_numpy(s), avg)
    _assert_same((qo.numpy().reshape(-1), so.numpy()), want, f"plain, {case}")
    if case == "tie-heavy" and ranks in (2, 4):
        # Exact ties, half of the quotients at R = 2 and a quarter at R = 4,
        # send almost every lane to the divide.
        assert got[2] > 0.9


def test_tie_heavy_r2_average_takes_the_divide_and_seeded_rarely_does():
    """The timed tie-heavy input (R = 2, averaging, equal scales): half the
    quotients are exact ties, so nearly every lane divides; on seeded
    inputs a lane divides where one of its 16 values lies within the guard
    band, about 16 * 2G = 2^-10 of the lanes."""
    q, s = chip_smoke.reduce_tie_inputs(2, 64, seed=3)
    ties = model_reduce(q, s, True)
    assert ties[2] > 0.99
    q, s = chip_smoke.reduce_inputs(2, 64, seed=3)
    assert model_reduce(q, s, True)[2] < 0.01


def _drawn_case(rng: np.random.Generator):
    """One draw: 1 to 5 ranks, averaging or not, 1 to 5 rows whose scale
    exponents lie in [-149, 125] (an end point, an integer or any float),
    a scale ratio between ranks from {0 (equal scales: ties), 2^-20,
    2^-13, 2^-11}, and a pattern of 1 to 64 levels tiled over the row and
    permuted per rank."""
    ranks = int(rng.integers(1, 6))
    avg = bool(rng.integers(2))
    rows = int(rng.integers(1, 6))
    exps = rng.uniform(-149.0, 125.0, rows)
    kind = rng.integers(3, size=rows)
    exps = np.where(kind == 0, rng.choice([-149.0, 125.0], rows),
                    np.where(kind == 1, np.round(exps), exps))
    ratio = float(rng.choice([0.0, 2.0**-20, 2.0**-13, 2.0**-11]))
    levels = rng.integers(-128, 128, int(rng.integers(1, 65))).astype(np.int8)
    pattern = np.resize(levels, 512)
    q = np.stack([
        np.stack([rng.permutation(pattern) for _ in range(rows)])
        for _ in range(ranks)
    ])
    base = rng.uniform(1.0, 2.0, rows) * 2.0**exps
    d = rng.uniform(-ratio, ratio, (ranks, rows)) if ratio else np.zeros((ranks, rows))
    s = (base[None] * (1.0 + d)).astype(F32)
    return q, s, avg


@pytest.mark.parametrize("seed", range(10))
def test_model_reduce_is_the_host_reduce_on_drawn_scales_and_levels(seed):
    """Fifteen seeded draws of random scale exponents (subnormal to near
    the largest float), scale ratios between ranks and level patterns."""
    rng = np.random.default_rng(1000 + seed)
    for _ in range(15):
        q, s, avg = _drawn_case(rng)
        _assert_same(model_reduce(q, s, avg)[:2], chip_smoke.reduce_host(q, s, avg),
                     "drawn")
