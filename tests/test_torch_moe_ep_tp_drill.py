"""The port's ``train_hsdp --model moe`` in replica groups of eight ranks on
the CPU, at the JAX trainer's MoE mesh for eight devices: fsdp 2 x ep 2 x
tp 2 (the experts over ep, each expert's FFN over tp and fsdp, the
attention over tp and replicated over ep). Two groups of eight gloo
processes against one lighthouse, HTTP heal; every rank of group 1 is
SIGKILLed after step 3, relaunched and healed rank by rank from the same
rank of group 0, and every rank of both groups ends with equal gathered
parameters and AdamW state. The losses and parameters' L1 stay within
relative 1e-4 of two groups of one rank (the bar of the four-rank drill in
``tests/test_torch_fsdp_drill.py``: the split computes the same sums in
another order)."""

import numpy as np
import pytest

from test_torch_fsdp_drill import _assert_healed_and_equal, _drill

MOE_ARGS = ["--model", "moe", "--batch", "8", "--seq", "64", "--steps", "8",
            "--device", "cpu"]


@pytest.mark.timeout(420)
def test_moe_groups_of_eight_ranks_at_fsdp2_ep2_tp2_kill_heal_within_one_rank_bars(tmp_path):
    one = _drill(tmp_path, "moe1", MOE_ARGS, 1)
    assert one[0]["param_sha256"] == one[1]["param_sha256"]
    eight = _drill(tmp_path, "moe8", MOE_ARGS, 8)
    _assert_healed_and_equal(tmp_path, "moe8", eight, 8)
    for res in eight.values():
        assert {a: n for a, n in res["mesh"].items() if n > 1} == {"fsdp": 2, "ep": 2, "tp": 2}
        assert res["router_grad_l1"] > 0
    np.testing.assert_allclose(eight[0]["losses"], one[0]["losses"], rtol=1e-4)
    np.testing.assert_allclose(eight[0]["param_l1"], one[0]["param_l1"], rtol=1e-4)


@pytest.mark.timeout(300)
def test_chip_smoke_moe_ep_tp_check_holds_on_cpu():
    """chip_smoke.py phase 21's world of eight ranks, rehearsed on the CPU:
    llama_moe_debug at fsdp 2 x ep 2 x tp 2 against one rank's two steps,
    fp32 within ``TP_FP32`` and bf16 within ``TP_BF16`` (the sums over
    ranks in fp32 route every token as one rank does), AdamW excess 0, and
    the planted fault (the first expert from the tp rank) past both
    bars."""
    import chip_smoke

    result = chip_smoke.tp_ep_check("cpu", "debug", cases=(),
                                    moe_cases=chip_smoke.MOE_EP_TP_CASES)
    assert len(result["cases"]) == len(chip_smoke.MOE_EP_TP_CASES)
    assert list(result["world_wall_s"]) == [8]
    for name, case in result["cases"].items():
        assert case["world"] == 8, name
        assert case["loss"] <= case["bar"]["loss"] and case["grad"] <= case["bar"]["grad"], name
        assert case["adamw_excess"] == 0, name
        if "float32" in name:
            assert case["fault_loss"] > case["bar"]["loss"], name
            assert case["fault_grad"] > case["bar"]["grad"], name
