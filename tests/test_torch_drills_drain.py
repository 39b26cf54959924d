"""The port's drain drill on the CPU (``python -m torchft_tpu_torch.drills
drain --device cpu``): group 2 of three leaves mid-run by SIGTERM (a
graceful drain: exit 0, "draining at step", "left the quorum") and, in a
second run, by SIGKILL; both survivors finish bitwise equal, and neither
departure stalls them past ``drills.STALL_LIMIT_S``."""

import pytest

from test_torch_drills import one_thread, run_drill  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.timeout(300)
def test_drain_and_sigkill_legs_cost_the_survivors_about_a_step(tmp_path):
    report = run_drill(["drain", "--steps", "40"], tmp_path)
    drain, kill = report["graceful_drain"], report["sigkill_control"]
    assert drain["survivor_final_steps"] == [40, 40]
    assert kill["survivor_final_steps"] == [40, 40]
    assert not kill["victim_exit_clean"]  # a SIGKILLed trainer cannot exit 0
