"""The port bench's optional probes (quorum latency, heal bandwidth): the
twin of tests/test_bench_probes.py. Each runs in a fresh process, as the
bench's supervisor runs it, with the bench knobs that turn the probes off
removed from the environment; the quorum probe's keys are the JAX probe's.
The heal probe keeps the JAX file's ``slow`` mark (a 0.25 GB transfer
between two processes)."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_probe(expr: str, timeout: int) -> dict:
    env = dict(os.environ)
    for knob in ("BENCH_TINY", "BENCH_QUORUM", "BENCH_HEAL"):
        env.pop(knob, None)
    code = (
        f"import sys; sys.path.insert(0, {REPO!r}); "
        "import json; from torchft_tpu_torch import bench; "
        f"print(json.dumps({expr}))"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.timeout(240)
def test_bench_quorum_probe():
    out = _run_probe("bench._bench_quorum()", timeout=180)
    assert "error" not in out, out
    assert set(out) == {"what", "rounds", "p50_ms", "p95_ms", "max_ms"}
    assert out["rounds"] == 20
    assert 0 < out["p50_ms"] <= out["p95_ms"] <= out["max_ms"] < 20_000


@pytest.mark.slow
def test_bench_heal_probe():
    out = _run_probe('bench._bench_heal("cpu")', timeout=400)
    assert "error" not in out, out
    assert out["checksum_ok"] is True
    assert out["gb_per_s"] > 0
