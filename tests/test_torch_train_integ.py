"""The port's fault-tolerant trainer end to end on the CPU (the twin of
tests/test_hsdp_integ.py): two replica-group OS processes of
``python -m torchft_tpu_torch.train_hsdp --model debug``, outer gradient
averaging through the Manager's socket process group; group 1 is SIGKILLed
mid-run, restarts, heals params + AdamW state from the survivor over HTTP,
and both finish with bitwise-identical parameters. Also the MoE drill, one
group of each family the port once refused (MoE, GPipe, Ulysses), and the
flags still unported."""

import json
import math
import os
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


# Covers a first-use build of the C++ binaries (~1 min) before the drill.
@pytest.mark.timeout(300)
def test_two_groups_kill_heal_moe(tmp_path):
    """``--model moe`` (llama_moe_debug: 4 experts, top-2, the router's aux
    loss): the same kill and heal ends in bitwise-identical parameters."""
    steps = 8
    results = kill_heal_drill(
        ["--model", "moe", "--steps", str(steps), "--device", "cpu"],
        str(tmp_path / "results"),
        str(tmp_path / "logs"),
        kill_after_step=3,
        timeout_s=200.0,
        env={"OMP_NUM_THREADS": "1"},
    )
    healed = (tmp_path / "logs" / "group1.log").read_text()
    assert "healing from replica_rank=0" in healed.split("SIGKILLed")[1]
    for r in results.values():
        assert r["final_step"] == steps
        assert r["losses"] and all(math.isfinite(x) for x in r["losses"])
        assert r["router_grad_l1"] > 0
    assert results[0]["param_sha256"] == results[1]["param_sha256"], results


def _one_group(tmp_path, flags, steps=2):
    """One replica group of the trainer on the CPU against a lighthouse of
    its own; returns its result JSON."""
    from torchft_tpu_torch.coordination import LighthouseServer

    lighthouse = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
        quorum_tick_ms=50,
    )
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "torchft_tpu_torch.train_hsdp", "--device",
             "cpu", "--steps", str(steps), "--min-replicas", "1",
             "--result-dir", str(tmp_path), *flags],
            capture_output=True, text=True, timeout=200,
            env={**os.environ, "TORCHFT_LIGHTHOUSE": lighthouse.address(),
                 "REPLICA_GROUP_ID": "0", "OMP_NUM_THREADS": "1"},
        )
    finally:
        lighthouse.shutdown()
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(tmp_path / "group0.json") as f:
        return json.load(f)


@pytest.mark.timeout(300)
@pytest.mark.parametrize(
    "flags", [["--model", "moe"], ["--model", "pipeline"], ["--attn", "ulysses"]]
)
def test_hsdp_family_runs_on_cpu(tmp_path, flags):
    """The three families the JAX trainer builds on one chip: MoE, GPipe
    (pp=1, 2 microbatches) and Ulysses attention (sp=1) each run two steps
    on the CPU; a MoE step moves its router."""
    r = _one_group(tmp_path, flags)
    assert r["final_step"] == 2 and r["committed_steps"] == 2
    assert r["losses"] and all(math.isfinite(x) for x in r["losses"])
    if flags[1] == "moe":
        assert r["router_grad_l1"] > 0
    else:
        assert r["router_grad_l1"] is None


@pytest.mark.parametrize(
    "flags, item",
    [
        (["--ckpt-transport", "pg-sharded"], "pg_transport"),
        (["--durable-dir", "x"], "durable"),
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
