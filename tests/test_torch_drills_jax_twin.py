"""``tools/drills.py spare-failover`` (the JAX trainers) and the port's
twin at the same ``--steps``, side by side on the CPU: the two reports'
verdicts and final steps agree. (Which group the lighthouse ranks as the
spare depends on registration order, so the groups are not compared.)"""

import json
import os
import subprocess
import sys

import pytest

from test_torch_drills import REPO, assert_jax_keys, one_thread, run_drill  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# Long enough for the JAX victim's relaunch (imports and a compile) to
# rejoin before its peers finish: at 1500 steps its run lasts ~50 s beside
# the port's.
STEPS = 1500
VERDICTS = ("clean_finish", "spare_promoted_no_heal", "bitwise_equal_all3",
            "final_steps")


@pytest.mark.timeout(420)
def test_spare_failover_agrees_with_the_jax_drill(tmp_path):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
           "TMPDIR": str(tmp_path)}
    jax = subprocess.Popen(
        [sys.executable, "tools/drills.py", "spare-failover", "--steps", str(STEPS)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        port = run_drill(["spare-failover", "--steps", str(STEPS)], tmp_path)
        out, err = jax.communicate(timeout=360)
    finally:
        if jax.poll() is None:
            jax.terminate()
            jax.wait(30)
    assert jax.returncode == 0, err[-3000:]
    reference = json.loads(out.strip().splitlines()[-1])
    assert_jax_keys("spare-failover", reference)
    for key in VERDICTS:
        assert port[key] == reference[key], (key, port[key], reference[key])
    assert reference["spare_group"] is not None and port["spare_group"] is not None
    assert port["final_steps"] == [STEPS] * 3
