"""The port's elastic-up drill on the CPU (``python -m
torchft_tpu_torch.drills elastic-up --device cpu``): two groups train
unpaced, a third joins mid-run, heals the live state forward and all
three finish bitwise equal."""

import pytest

from test_torch_drills import one_thread, run_drill  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.timeout(240)
def test_a_third_group_joins_mid_run_and_finishes_bitwise(tmp_path):
    report = run_drill(["elastic-up", "--steps", "1000"], tmp_path)
    assert 0 < report["joiner_heal_step"] < 1000
    assert report["final_steps"] == [1000, 1000, 1000]
