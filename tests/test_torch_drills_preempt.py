"""The port's full-job preemption drill on the CPU over ``train_ddp``'s cnn
(``python -m torchft_tpu_torch.drills preempt-all --device cpu``), through
``drill.preempt_all_drill``: every group drains, by SIGTERM or by one
operator ``drain_all`` at the lighthouse (``via="operator"``), and the
relaunch against a fresh lighthouse resumes from the drain-time snapshots.
(The DiLoCo family: ``tests/test_torch_orchestration.py``.)"""

import pytest

from test_torch_drills import one_thread, run_drill  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.timeout(240)
@pytest.mark.parametrize("via", ["operator", "sigterm"])
def test_preempt_all_ddp_resumes_from_the_drain_snapshots(via, tmp_path):
    report = run_drill(["preempt-all", "--steps", "30", "--via", via], tmp_path)
    assert report["drill"] == "preempt-all:ddp"
    assert report["via"] == via
    # The drain lands after group 1's step 12 and before the end.
    assert all(12 <= s < 30 for s in report["drained_steps"]), report
    assert report["final_steps"] == [30, 30]


@pytest.mark.timeout(120)
def test_operator_drain_must_reach_every_member(monkeypatch):
    """``drain_all`` that reaches fewer managers than groups fails the
    drill where it is sent, as the JAX drill asserts."""
    from torchft_tpu_torch import coordination, drill

    class Client:
        def __init__(self, addr):
            pass

        def drain_all(self):
            return {"n_members": 2, "n_sent": 1}

        def close(self):
            pass

    monkeypatch.setattr(coordination, "LighthouseClient", Client)
    with pytest.raises(AssertionError, match="did not reach every member"):
        drill._drain_all("127.0.0.1:1", 2)
