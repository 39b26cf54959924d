"""The port's Streaming DiLoCo trainer end to end on the CPU (the CPU twin
of ``chip_smoke.py``'s DiLoCo drill): two replica-group OS processes of
``python -m torchft_tpu_torch.train_diloco --device cpu`` on the int4 +
error-feedback wire; group 1 is SIGKILLed after outer step 2, restarts,
heals the global state (fragment backups + outer optimizer) from the
survivor, and both groups finish the outer-step target with the same
``global_sha``. Also a ``--durable-dir`` resume that ends in an
uninterrupted run's global state, and the trainer's refusal without a
card."""

import math
import subprocess
import sys

import pytest

from test_torch_train_integ import durable_resume
from torchft_tpu_torch.drill import kill_heal_drill

OUTER_STEPS = 6
DRILL_ARGS = [
    "--outer-steps", str(OUTER_STEPS), "--sync-every", "4", "--n-fragments",
    "2", "--fragment-sync-delay", "0", "--quantize", "--quantize-bits", "4",
    "--error-feedback", "--batch-size", "4", "--seq-len", "64",
    "--device", "cpu",
]


# Covers a first-use build of the C++ binaries (~1 min) before the drill.
@pytest.mark.timeout(300)
def test_diloco_two_groups_kill_heal_global_state_equal(tmp_path):
    results = kill_heal_drill(
        DRILL_ARGS,
        str(tmp_path / "results"),
        str(tmp_path / "logs"),
        kill_after_step=2,
        timeout_s=200.0,
        env={"OMP_NUM_THREADS": "1"},
        trainer="torchft_tpu_torch.train_diloco",
        mark="outer_step={n} loss",
    )
    healed = (tmp_path / "logs" / "group1.log").read_text()
    assert "SIGKILLed after step 2" in healed
    assert "healing from replica_rank=0" in healed.split("SIGKILLed")[1]
    for r in results.values():
        assert r["final_outer_step"] == OUTER_STEPS
        assert not r["drained"]
        assert r["device"] == "cpu"
        assert r["losses"] and all(math.isfinite(x) for x in r["losses"])
        # CPU tensors take the plain versions: no kernel launch is counted.
        assert not any(r["kernel_launches"].values())
    assert results[0]["global_sha"] == results[1]["global_sha"], results


def test_groups_draw_different_batches_on_the_cpu():
    """The group's data seed and the inner step are mixed into 32 bits
    before they seed the generator: the CPU generator keeps only a seed's
    low 32 bits, so a seed with the group in the high bits handed every
    group the same batches on the CPU. A relaunched group replays its own
    stream."""
    import torch

    from torchft_tpu_torch._train_common import group_data_seed
    from torchft_tpu_torch.train_diloco import inner_tokens

    cpu = torch.device("cpu")
    draw = lambda g, inner: inner_tokens(  # noqa: E731
        (group_data_seed(g), inner), 4, 64, 256, cpu
    )
    assert not torch.equal(draw("0", 0), draw("1", 0))
    assert not torch.equal(draw("0", 0), draw("0", 1))
    assert torch.equal(draw("1", 3), draw("1", 3))


def _run(*flags):
    return subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.train_diloco", *flags],
        capture_output=True, text=True, timeout=60,
    )


@pytest.mark.timeout(300)
def test_durable_resume_equals_uninterrupted_run(tmp_path):
    """A run stopped at outer step 4 and relaunched to 6 restores the
    global state, the inner params and AdamW state, and its place in the
    inner stream, and ends in the global state of an uninterrupted run."""
    resumed, whole, _ = durable_resume(
        "torchft_tpu_torch.train_diloco", tmp_path, "--outer-steps",
        ["--sync-every", "4", "--n-fragments", "2", "--fragment-sync-delay",
         "0", "--batch-size", "4", "--seq-len", "64"],
    )
    assert resumed["final_outer_step"] == whole["final_outer_step"] == 6
    assert resumed["inner_steps"] == 4  # two syncs of 2 inner steps each
    assert resumed["global_sha"] == whole["global_sha"]


def test_no_card_exits_naming_the_cpu_flag():
    """The trainer runs on cuda by default and never falls back: without a
    card it exits naming --device cpu."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs on it")
    proc = _run("--steps", "1")
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr, proc.stderr
