"""The port's model-heal drill on the CPU (``python -m
torchft_tpu_torch.drills model-heal --model moe|pipeline|ulysses --device
cpu``): ``train_hsdp`` at the JAX drill's arguments (int4 outer wire,
pg-sharded heal), one rank a group; group 1 is SIGKILLed, heals and both
finish bitwise equal."""

import pytest

from test_torch_drills import one_thread, run_drill  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.timeout(180)
@pytest.mark.parametrize("model", ["moe", "pipeline", "ulysses"])
def test_model_heal_family_heals_bitwise(model, tmp_path):
    report = run_drill(["model-heal", "--model", model, "--steps", "20"], tmp_path)
    assert report["drill"] == f"model-heal:{model}"
    assert report["restarts"] == {0: 0, 1: 1}
    assert report["final_steps"] == [20, 20]
