"""The port's fused int8 reduce (``torchft_tpu_torch/ops/quantization.py``
``fused_reduce_int8``) against the host's reduce, bit for bit, and against
the JAX package's Pallas ``fused_reduce_int8`` in interpret mode. Inputs are
host-quantized payloads of values made with numpy from a seed. On the CPU
the wrapper runs the kernel's plain version; the kernel itself is held to
the same bits on the card (tests/test_torch_quantization_gpu.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu import collectives as jcoll
from torchft_tpu.ops import quantization as JQ
from torchft_tpu_torch import collectives as tcoll
from torchft_tpu_torch.ops import quantization as Q

import chip_smoke

RANKS = [2, 3, 4]
ROWS = [1, 5, 37]  # 5 and 37 are not multiples of the TPU tile of 32


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a).reshape(-1)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bitwise(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.size == want.size, (
        what, got.dtype, got.shape, want.dtype, want.shape,
    )
    diff = int(np.count_nonzero(_bits(got) != _bits(want)))
    assert diff == 0, f"{what}: {diff} of {got.size} differ in their bits"


def _port(q: np.ndarray, s: np.ndarray, avg: bool):
    qo, so = Q.fused_reduce_int8(torch.from_numpy(q), torch.from_numpy(s), avg)
    assert qo.shape == (s.shape[1], Q.BLOCK) and so.shape == (s.shape[1],)
    return qo.numpy().reshape(-1), so.numpy()


def _host_acc(q: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The host's fp32 sum in rank order, [rows, 512]."""
    acc = np.zeros(q.shape[1:], np.float32)
    for r in range(q.shape[0]):
        acc += q[r].astype(np.float32) * s[r][:, None]
    return acc


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("avg", [False, True])
@pytest.mark.parametrize("ranks", RANKS)
def test_plain_reduce_equals_host(ranks, avg, rows):
    """Sum in rank order, / np.float32(R) if avg, then quantize_blockwise:
    the plain version writes the host's payload and scale bits, and
    chip_smoke.reduce_host (the card's yardstick) is that host reduce, as
    both packages' host quantizers write it."""
    q, s = chip_smoke.reduce_inputs(ranks, rows, seed=ranks * 10 + rows)
    acc = _host_acc(q, s)
    if avg:
        acc = acc / np.float32(ranks)
    qh, sh = jcoll.quantize_blockwise(acc.reshape(-1))
    qc, sc = chip_smoke.reduce_host(q, s, avg)
    _assert_bitwise(qc, qh, "reduce_host payload")
    _assert_bitwise(sc, sh, "reduce_host scales")
    qo, so = _port(q, s, avg)
    _assert_bitwise(qo, qh, "payload")
    _assert_bitwise(so, sh, "scales")


@pytest.mark.parametrize("avg", [False, True])
@pytest.mark.parametrize("ranks", RANKS)
def test_plain_reduce_equals_host_on_special_rows(ranks, avg):
    """A NaN scale in one rank gives scale NaN and q 0; a row zero in every
    rank scale 1.0 and q 0; subnormal scales a subnormal scale; a row at
    +-127 in every rank +-127 again; all as the host writes them."""
    q, s = chip_smoke.reduce_special_inputs(ranks)
    qh, sh = chip_smoke.reduce_host(q, s, avg)
    qo, so = _port(q, s, avg)
    _assert_bitwise(qo, qh, "payload")
    _assert_bitwise(so, sh, "scales")
    qo = qo.reshape(-1, Q.BLOCK)
    nan, zero, sub, edge, _seeded = range(5)
    assert np.isnan(so[nan]) and not qo[nan].any()
    assert so[zero] == 1.0 and not qo[zero].any()
    assert 0 < so[sub] < np.finfo(np.float32).tiny and qo[sub].any()
    np.testing.assert_array_equal(np.abs(qo[edge]), 127)
    np.testing.assert_array_equal(np.sign(qo[edge]), np.sign(q[0, edge]))


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a * b + c in fp32 with one rounding (a fused multiply-add). a is an
    int8 level and b an fp32 scale, so a * b is exact in fp64; c + a * b is
    then rounded to fp64 and to fp32, and where the fp64 sum sits exactly
    halfway between two fp32 values its rounding error decides the side."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = c + p
    bv = s - c
    err = (c - (s - bv)) + (p - bv)  # two-sum: s + err == c + p exactly
    r = s.astype(np.float32)
    toward = np.where(err > 0, np.float32(np.inf), np.float32(-np.inf))
    nb = np.nextafter(r, toward.astype(np.float32))
    mid = (r.astype(np.float64) + nb.astype(np.float64)) / 2
    return np.where((err != 0) & (s == mid), nb, r).astype(np.float32)


def _xla_reduce(q: np.ndarray, s: np.ndarray, avg: bool):
    """What the Pallas reduce computes under XLA on the CPU: the rank sum
    with each later product fused into the add (fma(q0, s0, q1*s1), then
    fma(q_r, s_r, acc)), the divide by R as a multiply by fp32(1 / R), and
    the scale as absmax times fp32(1 / 127). Returns (acc, scales)."""
    ranks = q.shape[0]
    lvl = q.astype(np.float32)
    sc = [np.repeat(s[r][:, None], Q.BLOCK, axis=1) for r in range(ranks)]
    acc = _fma(lvl[0], sc[0], lvl[1] * sc[1])
    for r in range(2, ranks):
        acc = _fma(lvl[r], sc[r], acc)
    if avg:
        acc = acc * np.float32(1.0 / ranks)
    absmax = np.abs(acc).max(axis=1)
    return acc, np.where(absmax == 0, np.float32(1.0), absmax * np.float32(1.0 / 127))


def _pallas(q: np.ndarray, s: np.ndarray, avg: bool):
    """The JAX package's Pallas reduce in interpret mode, its rows padded to
    the TPU tile and sliced back to the caller's."""
    rows = s.shape[1]
    qo, so = JQ.fused_reduce_int8(jnp.asarray(q), jnp.asarray(s), avg=avg)
    assert qo.shape[0] % 32 == 0 and qo.shape[0] >= rows
    return np.asarray(qo)[:rows].reshape(-1), np.asarray(so)[:rows]


@pytest.mark.parametrize("avg", [False, True])
@pytest.mark.parametrize("ranks", RANKS)
def test_plain_reduce_against_pallas_kernel(ranks, avg):
    """The payload bit for bit. The scales: the port's are the host's
    (absmax of the rank-order sum / 127, correctly rounded); the Pallas
    kernel's are those of XLA's arithmetic (_xla_reduce), which contracts
    the multiply-adds, multiplies by 1/R and by 1/127, and so differ in the
    last bit on some rows. ROADMAP.md §3 lists the difference."""
    rows = 37
    q, s = chip_smoke.reduce_inputs(ranks, rows, seed=200 + ranks)
    qo, so = _port(q, s, avg)
    qp, sp = _pallas(q, s, avg)
    _assert_bitwise(qo, qp, "payload vs Pallas")
    acc = _host_acc(q, s)
    if avg:
        acc = acc / np.float32(ranks)
    _assert_bitwise(so, np.abs(acc).max(axis=1) / np.float32(127), "port scale")
    _assert_bitwise(sp, _xla_reduce(q, s, avg)[1], "Pallas scale")


def test_pallas_reduce_rounds_the_sum_differently_from_the_wire():
    """Pins the difference: XLA's fused multiply-adds give another fp32 sum
    than the host's separately rounded products and sums on thousands of
    values, so scales differ in their last bit on many rows; and with R=3
    and averaging, where XLA multiplies by fp32(1/3), two payload bytes
    differ by one level, where the port writes the host's bytes. The
    Pallas output is _xla_reduce's, payload and scales, bit for bit."""
    ranks, rows = 3, 100
    rng = np.random.default_rng(7)
    qs, ss = zip(*(
        tcoll.quantize_blockwise(rng.standard_normal(rows * Q.BLOCK).astype(np.float32))
        for _ in range(ranks)
    ))
    q, s = np.stack([x.reshape(rows, Q.BLOCK) for x in qs]), np.stack(ss)
    differing = {}
    for avg in (False, True):
        acc_xla, s_xla = _xla_reduce(q, s, avg)
        acc = _host_acc(q, s)
        if avg:
            acc = acc / np.float32(ranks)
        assert np.count_nonzero(acc != acc_xla) > 1000
        qp, sp = _pallas(q, s, avg)
        q_xla = np.clip(np.rint(acc_xla / s_xla[:, None]), -127, 127).astype(np.int8)
        _assert_bitwise(qp, q_xla, "Pallas payload")
        _assert_bitwise(sp, s_xla, "Pallas scale")
        qh, sh = chip_smoke.reduce_host(q, s, avg)
        qo, so = _port(q, s, avg)
        _assert_bitwise(qo, qh, "port payload")
        _assert_bitwise(so, sh, "port scales")
        assert np.count_nonzero(sp != sh) > 20
        differing[avg] = np.abs(qp.astype(np.int32) - qh.astype(np.int32))
    assert not differing[False].any()
    assert np.count_nonzero(differing[True]) == 2 and differing[True].max() == 1


@pytest.mark.parametrize(
    "q, s, match",
    [
        (torch.zeros(2, 3, 512, dtype=torch.int8), torch.ones(2, 3, device="meta"), "CUDA"),
        (torch.zeros(2, 3, 512, dtype=torch.int8, device="meta"), torch.ones(2, 3), "CUDA"),
        (torch.zeros(2, 3, 512), torch.ones(2, 3), "int8"),
        (torch.zeros(2, 3, 512, dtype=torch.int8), torch.ones(2, 3, dtype=torch.float64), "float32"),
        (torch.zeros(2, 3, 256, dtype=torch.int8), torch.ones(2, 3), r"\[R, rows, 512\]"),
        (torch.zeros(2, 3, 512, dtype=torch.int8), torch.ones(2, 4), r"\[R, rows, 512\]"),
        (torch.zeros(0, 3, 512, dtype=torch.int8), torch.ones(0, 3), "no ranks"),
    ],
    ids=["cpu-q-meta-scales", "meta-q-cpu-scales", "float-q", "float64-scales",
         "short-rows", "scales-shape", "no-ranks"],
)
def test_reduce_wrapper_raises(q, s, match):
    """Tensors off one CUDA device (a mix with the CPU; ``meta`` stands in
    for a device the CPU run has not got), wrong dtypes and shapes: the
    wrapper raises and never takes the plain version for them."""
    before = Q.LAUNCHES["reduce"]
    with pytest.raises(ValueError, match=match):
        Q.fused_reduce_int8(q, s)
    assert Q.LAUNCHES["reduce"] == before


def test_reduce_of_no_rows_and_no_launch_on_the_cpu():
    before = Q.LAUNCHES["reduce"]
    qo, so = Q.fused_reduce_int8(
        torch.zeros(2, 0, 512, dtype=torch.int8), torch.zeros(2, 0)
    )
    assert qo.shape == (0, 512) and so.shape == (0,)
    q, s = chip_smoke.reduce_inputs(2, 3, seed=1)
    Q.fused_reduce_int8(torch.from_numpy(q), torch.from_numpy(s))
    assert Q.LAUNCHES["reduce"] == before
