"""The port's fault-tolerant trainer end to end on the CPU (the twin of
tests/test_hsdp_integ.py): two replica-group OS processes of
``python -m torchft_tpu_torch.train_hsdp --model debug``, outer gradient
averaging through the Manager's socket process group; group 1 is SIGKILLed
mid-run, restarts, heals params + AdamW state from the survivor over HTTP,
and both finish with bitwise-identical parameters. Also the MoE drill, the
same drill healing over ``--ckpt-transport pg-sharded``, one group of each
family the port once refused (MoE, GPipe, Ulysses), and a ``--durable-dir``
resume that ends in an uninterrupted run's bits."""

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


def run_one_group(trainer, out_dir, flags):
    """One replica group of ``python -m <trainer> --device cpu`` against a
    lighthouse of its own; returns (its result JSON, its stdout)."""
    from torchft_tpu_torch.coordination import LighthouseServer

    lighthouse = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
        quorum_tick_ms=50,
    )
    try:
        proc = subprocess.run(
            [sys.executable, "-m", trainer, "--device", "cpu",
             "--min-replicas", "1", "--result-dir", str(out_dir), *flags],
            capture_output=True, text=True, timeout=200,
            env={**os.environ, "TORCHFT_LIGHTHOUSE": lighthouse.address(),
                 "REPLICA_GROUP_ID": "0", "OMP_NUM_THREADS": "1"},
        )
    finally:
        lighthouse.shutdown()
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(os.path.join(out_dir, "group0.json")) as f:
        return json.load(f), proc.stdout


def durable_resume(trainer, tmp_path, step_flag, flags):
    """Runs one group to step 4 with a durable snapshot there, relaunches
    it to step 6 from the snapshot, and runs it to step 6 uninterrupted.
    Returns (the resumed run's result, the uninterrupted run's result,
    the resumed run's stdout)."""
    durable = ["--durable-dir", str(tmp_path / "durable"), "--durable-every", "4"]
    first, _ = run_one_group(trainer, tmp_path / "a", [step_flag, "4", *durable, *flags])
    assert [s["step"] for s in first["durable_saves"]] == [4]
    resumed, out = run_one_group(
        trainer, tmp_path / "b", [step_flag, "6", *durable, *flags]
    )
    whole, _ = run_one_group(trainer, tmp_path / "c", [step_flag, "6", *flags])
    assert "[group 0] resumed from durable step 4" in out
    return resumed, whole, out


def _one_group(tmp_path, flags, steps=2):
    return run_one_group(
        "torchft_tpu_torch.train_hsdp", tmp_path, ["--steps", str(steps), *flags]
    )[0]


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


# Covers a first-use build of the C++ binaries (~1 min) before the drill.
@pytest.mark.timeout(300)
def test_two_groups_kill_heal_pg_sharded(tmp_path):
    """``--ckpt-transport pg-sharded`` on the int4 wire (the JAX package's
    pg-sharded HSDP drill): the healed group receives params and AdamW
    state as tensors, leaf by leaf, and both groups end bitwise equal. The
    receiver's journal holds one sharded ``heal_xfer`` whose bytes are the
    state's: params, exp_avg and exp_avg_sq in fp32 and a float32 step per
    parameter tensor."""
    from torchft_tpu_torch.models import Transformer, llama_debug

    steps = 8
    journal = tmp_path / "journal"
    results = kill_heal_drill(
        ["--model", "debug", "--steps", str(steps), "--device", "cpu",
         "--ckpt-transport", "pg-sharded", "--quantize", "--quantize-bits", "4"],
        str(tmp_path / "results"),
        str(tmp_path / "logs"),
        kill_after_step=3,
        timeout_s=200.0,
        env={"OMP_NUM_THREADS": "1", "TORCHFT_JOURNAL_DIR": str(journal)},
    )
    healed = (tmp_path / "logs" / "group1.log").read_text()
    assert "healing from replica_rank=0" in healed.split("SIGKILLed")[1]
    for r in results.values():
        assert r["final_step"] == steps and r["ckpt_transport"] == "pg-sharded"
        assert (r["quantize"], r["bits"]) == (True, 4)
        assert r["losses"] and all(math.isfinite(x) for x in r["losses"])
    assert results[0]["param_sha256"] == results[1]["param_sha256"], results
    params = list(Transformer(llama_debug()).parameters())
    state_bytes = 3 * 4 * sum(p.numel() for p in params) + 4 * len(params)
    recv = [
        e["attrs"] for f in journal.glob("journal_replica1_*.jsonl")
        for e in map(json.loads, f.read_text().splitlines())
        if e["event"] == "heal_xfer" and e["attrs"]["dir"] == "recv"
    ]
    assert recv and all(a["sharded"] and a["transport"] == "pg" for a in recv)
    assert {a["nbytes"] for a in recv} == {state_bytes}


@pytest.mark.timeout(300)
def test_hsdp_durable_resume_equals_uninterrupted_run(tmp_path):
    """``--durable-dir``: a run stopped at step 4 and relaunched to step 6
    resumes from its snapshot and ends in the bits of an uninterrupted
    6-step run (the batch of step k is seeded by k)."""
    resumed, whole, _ = durable_resume(
        "torchft_tpu_torch.train_hsdp", tmp_path, "--steps", []
    )
    assert resumed["final_step"] == whole["final_step"] == 6
    assert resumed["committed_steps"] == 2
    assert resumed["param_sha256"] == whole["param_sha256"]
