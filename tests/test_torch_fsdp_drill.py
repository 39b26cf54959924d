"""The port's ``train_hsdp`` with replica groups of two ranks on the CPU:
two groups of two gloo processes each against one lighthouse; every rank
of group 1 is SIGKILLed after step 3 and relaunched, each rank heals its
shards from the same rank of group 0, by HTTP (fp32 gradients) and by
pg-sharded (the int8 device-quantize path, plain versions on the CPU),
and both groups end with equal gathered parameters and AdamW state, bit
for bit. The fp32 drill ends within the fsdp-1 bars of a drill of
one-rank groups: its losses and parameters' L1 within relative 1e-4 (the
gradient-leaf bar; only the gradients' reduction order differs). The MoE
and GPipe families run in such groups too, and a full-job preemption
resumes every rank from its own snapshot. Also the trainer's refusal of a
group size whose factoring needs tp."""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torchft_tpu_torch.drill import kill_heal_drill, preempt_all_drill
from torchft_tpu_torch.parallel.sharding import TP_EP_ITEM

ARGS = ["--model", "debug", "--steps", "8", "--device", "cpu"]


def _drill(tmp_path, name, args, ranks, env=None):
    results = kill_heal_drill(
        args, str(tmp_path / name / "results"), str(tmp_path / name / "logs"),
        kill_after_step=3, timeout_s=200.0, ranks_per_group=ranks,
        env={"OMP_NUM_THREADS": "1", **(env or {})},
    )
    for g, r in results.items():
        assert r["final_step"] == 8, (g, r["final_step"])
        assert r["losses"] and all(math.isfinite(x) for x in r["losses"])
    json.dumps(results)  # every rank's result, no cycle
    return results


def _assert_healed_and_equal(tmp_path, name, results, ranks):
    logs = tmp_path / name / "logs"
    for r in range(ranks):
        log = logs / ("group1.log" if r == 0 else f"group1_rank{r}.log")
        assert "healing from replica_rank=0" in log.read_text(), log
    shas = {
        (g, rk["rank"]): (rk["param_sha256"], rk["opt_sha256"])
        for g, res in results.items() for rk in res["ranks"]
    }
    assert len(shas) == 2 * ranks
    assert len(set(shas.values())) == 1, shas
    for res in results.values():
        assert [rk["world_size"] for rk in res["ranks"]] == [ranks] * ranks


@pytest.mark.timeout(300)
def test_groups_of_two_ranks_kill_heal_http_within_fsdp1_bars(tmp_path):
    two = _drill(tmp_path, "fsdp2", ARGS, 2)
    _assert_healed_and_equal(tmp_path, "fsdp2", two, 2)
    one = _drill(tmp_path, "fsdp1", ARGS, 1)
    assert one[0]["param_sha256"] == one[1]["param_sha256"]
    np.testing.assert_allclose(two[0]["losses"], one[0]["losses"], rtol=1e-4)
    np.testing.assert_allclose(two[0]["param_l1"], one[0]["param_l1"], rtol=1e-4)


@pytest.mark.timeout(300)
def test_groups_of_two_ranks_kill_heal_pg_sharded_int8(tmp_path):
    results = _drill(
        tmp_path, "pg",
        [*ARGS, "--ckpt-transport", "pg-sharded", "--quantize"], 2,
        env={"TORCHFT_FORCE_DEVICE_QUANT": "1"},
    )
    _assert_healed_and_equal(tmp_path, "pg", results, 2)
    for res in results.values():
        assert res["ckpt_transport"] == "pg-sharded" and res["quantize"]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("model", ["moe", "pipeline"])
def test_moe_and_pipeline_in_groups_of_two_ranks(tmp_path, model):
    """The MoE model (its aux term over the group's whole batch) and the
    GPipe pipeline (each rank pipelining its rows) in groups of two ranks
    on the int4 device-quantize path: the kill, the heal and equal
    gathered state."""
    results = _drill(
        tmp_path, model,
        ["--model", model, "--batch", "8", "--seq", "64", "--steps", "8",
         "--quantize", "--quantize-bits", "4", "--device", "cpu"], 2,
        env={"TORCHFT_FORCE_DEVICE_QUANT": "1"},
    )
    _assert_healed_and_equal(tmp_path, model, results, 2)
    if model == "moe":
        assert all(r["router_grad_l1"] > 0 for r in results.values())


@pytest.mark.timeout(300)
def test_groups_of_two_ranks_resume_from_per_rank_snapshots(tmp_path):
    """A full-job preemption with groups of two ranks: every rank drains
    with a snapshot of its own shards under group<g>/rank<r>, the job
    relaunches against a fresh lighthouse and each rank resumes from its
    own; both groups end equal."""
    durable = tmp_path / "durable"
    out = preempt_all_drill(
        "torchft_tpu_torch.train_hsdp",
        [*ARGS, "--durable-dir", str(durable), "--durable-every", "3"],
        str(tmp_path / "results"), str(tmp_path / "logs"),
        term_after_step=3, timeout_s=200.0, ranks_per_group=2,
        env={"OMP_NUM_THREADS": "1"},
    )
    for g in (0, 1):
        for r in (0, 1):
            assert list((durable / f"group{g}" / f"rank{r}").glob("*.ckpt")), (g, r)
        ranks = out["resume"][g]["ranks"]
        assert [rk["final_step"] for rk in ranks] == [8, 8]
        assert len({rk["param_sha256"] for rk in ranks}) == 1
    assert out["resume"][0]["opt_sha256"] == out["resume"][1]["opt_sha256"]


@pytest.mark.timeout(120)
def test_trainer_refuses_a_group_whose_factoring_needs_tp(tmp_path):
    """4 ranks factor as fsdp 2 x tp 2: the trainer raises naming the
    ROADMAP item before any rendezvous or quorum."""
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.train_hsdp", "--device", "cpu"],
        env={"RANK": "0", "WORLD_SIZE": "4",
             "PYTHONPATH": str(Path(__file__).resolve().parents[1])},
        capture_output=True, text=True, timeout=100,
    )
    assert proc.returncode != 0
    assert TP_EP_ITEM in proc.stderr, proc.stderr[-2000:]
