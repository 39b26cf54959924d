"""The port's heal-storm drill on the CPU (``python -m
torchft_tpu_torch.drills heal-storm --device cpu``): after a steady-state
SIGKILL, the victim's next incarnations are killed again as they log
"reconfiguring pg" and "healing from"; the survivor never restarts, and
the last incarnation heals and finishes bitwise equal."""

import pytest

from test_torch_drills import one_thread, run_drill  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.timeout(240)
def test_heal_storm_kills_land_in_the_join_and_the_heal(tmp_path):
    report = run_drill(["heal-storm", "--steps", "40"], tmp_path)
    assert report["kills"] == 3
    assert report["restarts"] == {0: 0, 1: 3}
    assert report["final_steps"] == [40, 40]
