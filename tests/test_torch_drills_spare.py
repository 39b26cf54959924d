"""The port's hot-spare drill on the CPU (``python -m
torchft_tpu_torch.drills spare-failover --device cpu``): three groups at a
fixed world size of 2 (``WorldSizeMode.FIXED_WITH_SPARES``); an active
group is SIGKILLed, the spare is promoted with no heal, the relaunched
victim heals in as the new spare, and all three finish bitwise equal."""

import pytest

from test_torch_drills import one_thread, run_drill  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.timeout(240)
def test_the_spare_is_promoted_without_a_heal(tmp_path):
    report = run_drill(["spare-failover", "--steps", "1000"], tmp_path)
    assert report["spare_group"] != report["victim_group"]
    assert report["restarts"][report["victim_group"]] == 1
    assert report["final_steps"] == [1000, 1000, 1000]
