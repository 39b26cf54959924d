"""The port's soak and elastic-down drills on the CPU
(``python -m torchft_tpu_torch.drills soak|elastic-down --device cpu``):
repeated SIGKILLs of one of two groups on the int4+EF wire, each relaunch
healing from the survivor; and a 3->2 permanent departure."""

import pytest

from test_torch_drills import one_thread, run_drill  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.timeout(240)
def test_soak_heals_every_kill_bitwise(tmp_path):
    report = run_drill(["soak", "--steps", "60", "--kills", "2"], tmp_path)
    assert report["kills"] == 2
    assert report["restarts"] == {0: 0, 1: 2}
    assert report["final_steps"] == [60, 60]


@pytest.mark.timeout(240)
def test_elastic_down_survivors_finish_bitwise(tmp_path):
    report = run_drill(["elastic-down", "--steps", "40"], tmp_path)
    assert report["final_steps"] == [40, 40]
