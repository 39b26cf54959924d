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
resumes every rank from its own snapshot. Groups of four ranks run the JAX
trainer's auto_mesh(4), fsdp 2 x tp 2, through the same kill and heal, the
MoE model in groups of two runs at ep 2, and the pipeline in groups of two
at pp 2 (its stages on the two ranks) ends equal to one-rank groups bit for
bit. Also the trainer's refusal of an MoE group whose mesh does not split
the model (6 ranks: ep 2 x tp 3), and the JAX trainer's of the same mesh."""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from torchft_tpu_torch.drill import kill_heal_drill, preempt_all_drill

ARGS = ["--model", "debug", "--steps", "8", "--device", "cpu"]
PIPELINE_ARGS = ["--model", "pipeline", "--steps", "8", "--device", "cpu"]


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


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The drill of one-rank groups, the reference of the drills of larger
    groups (run once for the module)."""
    one = _drill(tmp_path_factory.mktemp("fsdp1"), "fsdp1", ARGS, 1)
    assert one[0]["param_sha256"] == one[1]["param_sha256"]
    return one


@pytest.fixture(scope="module")
def one_rank_pipeline(tmp_path_factory):
    """The pipeline's drill of one-rank groups (one stage a rank), the
    reference of the pipeline's drills of larger groups."""
    one = _drill(tmp_path_factory.mktemp("pp1"), "pp1", PIPELINE_ARGS, 1)
    assert one[0]["param_sha256"] == one[1]["param_sha256"]
    return one


@pytest.mark.timeout(300)
def test_groups_of_two_ranks_kill_heal_http_within_fsdp1_bars(tmp_path, one_rank):
    two = _drill(tmp_path, "fsdp2", ARGS, 2)
    _assert_healed_and_equal(tmp_path, "fsdp2", two, 2)
    one = one_rank
    np.testing.assert_allclose(two[0]["losses"], one[0]["losses"], rtol=1e-4)
    np.testing.assert_allclose(two[0]["param_l1"], one[0]["param_l1"], rtol=1e-4)


@pytest.mark.timeout(300)
def test_groups_of_four_ranks_at_fsdp2_tp2_kill_heal_within_one_rank_bars(tmp_path, one_rank):
    """Two groups of four ranks at fsdp 2 x tp 2 (llama_debug, HTTP heal):
    every rank of group 1 killed after step 3 and healed rank by rank from
    the same rank of group 0; every rank of both groups ends with equal
    gathered parameters and AdamW state, and the losses and parameters' L1
    within relative 1e-4 of one-rank groups."""
    four = _drill(tmp_path, "tp", ARGS, 4)
    _assert_healed_and_equal(tmp_path, "tp", four, 4)
    for res in four.values():
        assert res["mesh"] == {"dp": 1, "pp": 1, "fsdp": 2, "ep": 1, "sp": 1, "tp": 2}
    one = one_rank
    np.testing.assert_allclose(four[0]["losses"], one[0]["losses"], rtol=1e-4)
    np.testing.assert_allclose(four[0]["param_l1"], one[0]["param_l1"], rtol=1e-4)


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
    """The MoE model at ep 2 (the JAX trainer's MoE mesh for two devices:
    each rank runs two of the four experts on the whole batch) and the
    GPipe pipeline at pp 2 (the JAX trainer's pipeline mesh for two
    devices: each rank holds and runs one stage) in groups of two ranks on
    the int4 device-quantize path: the kill, the heal and equal gathered
    state."""
    results = _drill(
        tmp_path, model,
        ["--model", model, "--batch", "8", "--seq", "64", "--steps", "8",
         "--quantize", "--quantize-bits", "4", "--device", "cpu"], 2,
        env={"TORCHFT_FORCE_DEVICE_QUANT": "1"},
    )
    _assert_healed_and_equal(tmp_path, model, results, 2)
    want = {"ep": 2} if model == "moe" else {"pp": 2}
    for res in results.values():
        assert {a: n for a, n in res["mesh"].items() if n > 1} == want
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


@pytest.mark.timeout(300)
def test_pipeline_in_groups_of_two_ranks_kill_heal_equal_one_rank_bit_for_bit(
    tmp_path, one_rank_pipeline
):
    """Two groups of two ranks at pp 2 (``--model pipeline``, fp32
    gradients, the pg-sharded heal: each rank's stage and the replicated
    leaves, leaf by leaf): group 1 killed after step 3 and each rank healed
    from the same rank (the same stage) of group 0; every rank of both
    groups ends with equal gathered parameters and AdamW state, and equal
    bit for bit to one-rank groups: each stage runs the one rank's
    arithmetic, and the sums over pp add zeros."""
    two = _drill(tmp_path, "pp2", [*PIPELINE_ARGS, "--ckpt-transport", "pg-sharded"], 2)
    _assert_healed_and_equal(tmp_path, "pp2", two, 2)
    for res in two.values():
        assert {a: n for a, n in res["mesh"].items() if n > 1} == {"pp": 2}
        assert res["ckpt_transport"] == "pg-sharded"
    one = one_rank_pipeline
    assert two[0]["param_sha256"] == one[0]["param_sha256"]
    assert two[0]["opt_sha256"] == one[0]["opt_sha256"]
    assert two[0]["losses"] == one[0]["losses"]


@pytest.mark.timeout(120)
def test_trainer_refuses_a_group_whose_factoring_needs_tp(tmp_path):
    """``--model moe`` at 6 ranks factors as the JAX trainer's ep 2 x tp 3,
    which llama_moe_debug does not split (4 q and 2 kv heads, vocab 256,
    over tp 3): the trainer raises a ``ValueError`` naming the heads and
    the axis before any rendezvous or quorum. (8 MoE ranks are fsdp 2 x ep
    2 x tp 2, ``tests/test_torch_moe_ep_tp_drill.py``.)"""
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.train_hsdp", "--device", "cpu",
         "--model", "moe"],
        env={"RANK": "0", "WORLD_SIZE": "6",
             "PYTHONPATH": str(Path(__file__).resolve().parents[1])},
        capture_output=True, text=True, timeout=100,
    )
    assert proc.returncode != 0
    assert "ValueError: 4 q and 2 kv heads do not split over tp=3" in proc.stderr, (
        proc.stderr[-2000:]
    )
    assert "GROUP_INIT_METHOD" not in proc.stderr, proc.stderr[-2000:]


@pytest.mark.timeout(120)
def test_jax_trainer_refuses_the_same_moe_mesh():
    """The JAX twin of the refusal above: its ``init_train_state`` refuses
    llama_moe_debug at ``make_mesh(ep=2, tp=3)`` (the embedding's vocab of
    256 does not split over tp 3)."""
    import jax
    import jax.numpy as jnp

    from torchft_tpu.models.llama import llama_moe_debug
    from torchft_tpu.parallel import make_mesh
    from torchft_tpu.parallel import train as jtrain

    cfg = llama_moe_debug(dtype=jnp.float32)
    mesh = make_mesh(ep=2, tp=3)
    with pytest.raises(ValueError, match="divisible by 3"):
        jtrain.init_train_state(
            jtrain.build_model(cfg, mesh), mesh, jax.random.PRNGKey(0), (8, 64)
        )
