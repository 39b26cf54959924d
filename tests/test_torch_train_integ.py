"""The port's fault-tolerant trainer end to end on the CPU (the twin of
tests/test_hsdp_integ.py): two replica-group OS processes of
``python -m torchft_tpu_torch.train_hsdp --model debug``, outer gradient
averaging through the Manager's socket process group; group 1 is SIGKILLed
mid-run, restarts, heals params + AdamW state from the survivor over HTTP,
and both finish with bitwise-identical parameters."""

import math
import subprocess
import sys

import pytest

from torchft_tpu_torch.drill import kill_heal_drill


# Covers a first-use build of the C++ binaries (~1 min) before the drill.
@pytest.mark.timeout(300)
def test_two_groups_kill_heal_bitwise_equal(tmp_path):
    steps = 8
    results = kill_heal_drill(
        ["--model", "debug", "--steps", str(steps), "--device", "cpu"],
        str(tmp_path / "results"),
        str(tmp_path / "logs"),
        kill_after_step=3,
        timeout_s=200.0,
        env={"OMP_NUM_THREADS": "1"},
    )
    healed = (tmp_path / "logs" / "group1.log").read_text()
    assert "SIGKILLed after step 3" in healed
    assert "healing from replica_rank=0" in healed.split("SIGKILLed")[1]
    for r in results.values():
        assert r["final_step"] == steps
        assert r["losses"] and all(math.isfinite(x) for x in r["losses"])
        assert r["device"] == "cpu"
    # The north-star contract: bitwise-identical params after kill + heal.
    assert results[0]["param_sha256"] == results[1]["param_sha256"], results


# Two drills; covers a first-use build of the C++ binaries (~1 min).
@pytest.mark.timeout(300)
def test_two_groups_kill_heal_quantized_device_path(tmp_path):
    """``--quantize`` through the device-quantized allreduce (CPU tensors
    forced down it, so the kernels' plain versions): the same kill and
    heal ends in bitwise-identical parameters, and in the very bits the
    host quantizer's path reaches (the two write the same wire)."""
    steps = 8
    sha = {}
    for path, env in (("device", {"TORCHFT_FORCE_DEVICE_QUANT": "1"}),
                      ("host", {})):
        results = kill_heal_drill(
            ["--model", "debug", "--steps", str(steps), "--device", "cpu",
             "--quantize"],
            str(tmp_path / path / "results"),
            str(tmp_path / path / "logs"),
            kill_after_step=3,
            timeout_s=200.0,
            env={"OMP_NUM_THREADS": "1", **env},
        )
        healed = (tmp_path / path / "logs" / "group1.log").read_text()
        assert "healing from replica_rank=0" in healed.split("SIGKILLed")[1]
        for r in results.values():
            assert r["final_step"] == steps
            assert (r["quantize"], r["bits"]) == (True, 8)
            assert r["losses"] and all(math.isfinite(x) for x in r["losses"])
        assert results[0]["param_sha256"] == results[1]["param_sha256"], path
        sha[path] = results[0]["param_sha256"]
    assert sha["device"] == sha["host"], sha


# Covers a first-use build of the C++ binaries (~1 min) before the drill.
@pytest.mark.timeout(300)
def test_two_groups_kill_heal_ring_attention(tmp_path):
    """``--attn ring`` (ring attention over the group's one-device mesh,
    the dense fold at these short sequences): the same kill and heal ends
    in bitwise-identical parameters."""
    steps = 8
    results = kill_heal_drill(
        ["--model", "debug", "--attn", "ring", "--steps", str(steps),
         "--device", "cpu"],
        str(tmp_path / "results"),
        str(tmp_path / "logs"),
        kill_after_step=3,
        timeout_s=200.0,
        env={"OMP_NUM_THREADS": "1"},
    )
    healed = (tmp_path / "logs" / "group1.log").read_text()
    assert "healing from replica_rank=0" in healed.split("SIGKILLed")[1]
    assert "managed mesh" in healed
    for r in results.values():
        assert r["final_step"] == steps
        assert r["losses"] and all(math.isfinite(x) for x in r["losses"])
        # CPU tensors take the plain versions: no kernel launch is counted.
        assert not any(r["kernel_launches"].values())
    assert results[0]["param_sha256"] == results[1]["param_sha256"], results


@pytest.mark.parametrize(
    "flags, item",
    [
        (["--model", "pipeline"], "pipeline"),
        (["--ckpt-transport", "pg-sharded"], "pg_transport"),
        (["--durable-dir", "x"], "durable"),
        (["--model", "moe"], "MoE"),
        (["--attn", "ulysses"], "parallel/ulysses"),
    ],
)
def test_unported_flags_exit_naming_roadmap(flags, item):
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.train_hsdp", "--device",
         "cpu", *flags],
        capture_output=True, text=True, timeout=60,
    )
    assert proc.returncode == 2
    assert "ROADMAP.md" in proc.stderr and item in proc.stderr, proc.stderr
