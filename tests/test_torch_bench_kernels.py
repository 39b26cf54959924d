"""The port's kernel harness (``python -m torchft_tpu_torch.ops.bench_kernels``)
on the CPU at small sizes: it runs every section through the plain versions
only when asked (``--device cpu``), says so, keeps every key of the JAX
package's harness, and fails when a limit is missed. On the card it runs the
kernels at the JAX harness's sizes (chip_smoke.py phase 5)."""

import ast
import json
from pathlib import Path

import pytest
import torch

from torchft_tpu_torch.ops import bench_kernels as BK
from torchft_tpu_torch.ops import flash_attention as F
from torchft_tpu_torch.ops import quantization as Q

JAX_HARNESS = Path(__file__).resolve().parent.parent / "torchft_tpu/ops/bench_kernels.py"


def _jax_harness_keys() -> dict:
    """{section: [keys]} of the JAX harness's result, read from its source:
    the top-level keys of ``result`` ("" for the first dict) and the keys of
    each ``result["section"] = {...}`` dict."""
    keys = {}
    for node in ast.walk(ast.parse(JAX_HARNESS.read_text())):
        target, value = None, None
        if isinstance(node, ast.AnnAssign) and isinstance(node.value, ast.Dict):
            target, value = "", node.value
        elif (
            isinstance(node, ast.Assign)
            and isinstance(node.targets[0], ast.Subscript)
            and isinstance(node.targets[0].value, ast.Name)
            and node.targets[0].value.id == "result"
        ):
            target = node.targets[0].slice.value
            value = node.value
        if target is not None:
            keys[target] = (
                [k.value for k in value.keys] if isinstance(value, ast.Dict) else []
            )
    return keys


@pytest.fixture
def small(monkeypatch):
    for name, value in (
        ("QUANT_N", 4 * Q.BLOCK + 333),
        ("REDUCE_N", 5 * Q.BLOCK),
        ("FLASH_SHAPE", (1, 64, 2, 16)),
        ("LONG_S", 128),
        ("REPS", 2),
    ):
        monkeypatch.setattr(BK, name, value)


def _run(capsys, argv):
    rc = BK.main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_harness_on_the_cpu_keeps_the_jax_keys(small, capsys):
    rc, result = _run(capsys, ["--device", "cpu"])
    assert rc == 0 and result["ok"] is True
    assert result["compiled"] is False and result["backend"] == "cpu"
    jax_keys = _jax_harness_keys()
    # The first dict's keys, six sections and "ok".
    assert len(jax_keys) == 8 and "fused_reduce" in jax_keys
    for section, keys in jax_keys.items():
        assert section == "" or section in result, section
        record = result if section == "" else result[section]
        missing = [k for k in keys if k not in record]
        assert not missing, (section, missing)
    # The port's own keys, at its exact limits.
    assert result["quantize"]["scale_mismatch_bits"] == 0
    assert result["quantize"]["quantize_level_diff_count"] == 0
    assert result["fused_reduce"]["reduce_payload_mismatch_bytes"] == 0
    assert result["fused_reduce"]["reduce_scale_mismatch_bits"] == 0
    assert result["flash_attention"]["grad_rel_err_vs_dense"] < 0.05
    # Every kernel is listed, and none launched: the CPU ran the plain versions.
    assert result["launches"] == dict.fromkeys([*F.LAUNCHES, *Q.LAUNCHES], 0)
    assert len(result["launches"]) == 9


def test_harness_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BK.main([])


def test_harness_fails_when_the_reduce_misses_a_byte(small, capsys, monkeypatch):
    """One payload byte off the host's: ok is false and the exit code 1."""
    real = Q.fused_reduce_int8

    def off_by_one(q, s, avg=False):
        qo, so = real(q, s, avg)
        qo = qo.clone()
        qo.view(-1)[3] = qo.view(-1)[3] // 2 + 1
        return qo, so

    monkeypatch.setattr(Q, "fused_reduce_int8", off_by_one)
    rc, result = _run(capsys, ["--device", "cpu"])
    assert rc == 1 and result["ok"] is False
    assert result["fused_reduce"]["reduce_payload_mismatch_bytes"] == 1
