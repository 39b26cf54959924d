"""The port's ``train_ddp`` (``torchft_tpu_torch/train_ddp.py``) against the
repo root's ``train_ddp.py``, and end to end on the CPU.

- One training step of ``cnn`` and ``resnet-tiny`` (fp32) on an explicit
  numpy batch: the port's ``loss_and_grads`` and Adam against the JAX
  trainer's loss (``train_ddp.py:173-197``) and ``optax.adam``, from the
  same flax weights. The CNN pins the NHWC flatten order before
  ``Dense_0``.
- ``PureDistributedDataParallel`` against the JAX class in a mixed quorum.
- The twin of ``tests/test_ddp_integ.py``: two replica-group OS processes
  of ``python -m torchft_tpu_torch.train_ddp --model resnet-tiny --device
  cpu`` on the int4 + error-feedback wire; group 1 is SIGKILLed after step
  3, restarts, heals params, Adam state and BatchNorm statistics, and both
  finish with bitwise-equal params and equal statistics at the healed step.
- A ``--durable-dir`` resume (resnet-tiny: params, Adam state and
  BatchNorm statistics) that ends in an uninterrupted run's bits, and the
  trainer's refusal without a card.
"""

import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import train_ddp as jax_train_ddp
from test_torch_mixed_quorum import run_leaf_pair
from test_torch_train_integ import durable_resume
from torchft_tpu.models import resnet as jresnet
from torchft_tpu_torch import train_ddp
from torchft_tpu_torch.drill import kill_heal_drill
from torchft_tpu_torch.models import resnet as tresnet

LR = 1e-3
# One step's loss and gradients sum in different orders in the two
# packages (fp32): measured on the CPU, the loss differs by 5e-6 and the
# gradients by 1.5e-4 of each leaf's largest value (resnet-tiny's stage-4
# BatchNorms see 4 values each). Adam's first step moves a parameter by
# lr * g / (|g| + eps): where |g| is above GRAD_NOISE of its leaf's largest
# gradient the two packages' steps agree within PARAM_ATOL; below it the
# gradient is rounding noise of either sign (measured up to 9.9e-5 of the
# largest), and the step may be +-lr on either side, so within 2 * lr.
LOSS_ATOL = 1e-4
GRAD_RTOL = 1e-3
GRAD_NOISE = 3e-4
PARAM_ATOL = 1e-6


def _jax_step(model, variables, x, y):
    """``train_ddp.py``'s loss_and_grads and one ``optax.adam`` step."""
    params = {"params": variables["params"]}
    batch_stats = variables.get("batch_stats")

    def loss_fn(p):
        if batch_stats is None:
            logits = model.apply(p, x)
            return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean(), None
        logits, upd = model.apply(
            {**p, "batch_stats": batch_stats}, x, mutable=["batch_stats"]
        )
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return loss, upd["batch_stats"]

    @jax.jit
    def step(params):
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        tx = optax.adam(LR)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, new_stats, grads, optax.apply_updates(params, updates)

    loss, new_stats, grads, new = step(params)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return float(loss), host(new_stats), host(grads), host(new)


@pytest.mark.parametrize("name", ["cnn", "resnet-tiny"])
def test_one_train_step_matches_jax_trainer(name):
    rng = np.random.default_rng(5)
    if name == "cnn":
        jmodel, model = jax_train_ddp.Net(), train_ddp.Net()
    else:
        jmodel = jresnet.resnet_tiny(dtype=jnp.float32)
        model = tresnet.resnet_tiny(dtype=torch.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4)
    j_loss, j_stats, j_grads, j_new = _jax_step(jmodel, variables, x, y)

    model.load_state_dict(tresnet.params_from_jax(variables), strict=False)
    loss, batch, grads = train_ddp.loss_and_grads(
        model, torch.from_numpy(x), torch.from_numpy(y)
    )
    train_ddp.adam(model.parameters(), LR).step()
    assert abs(float(loss) - j_loss) <= LOSS_ATOL
    j_grads = tresnet.params_from_jax(j_grads)
    j_new = tresnet.params_from_jax(j_new)
    assert set(grads) == set(j_grads)
    for n, p in model.named_parameters():
        g = j_grads[n].numpy()
        scale = np.abs(g).max()
        np.testing.assert_allclose(grads[n].numpy(), g, atol=GRAD_RTOL * scale, err_msg=n)
        diff = np.abs(p.detach().numpy() - j_new[n].numpy())
        signal = np.abs(g) > GRAD_NOISE * scale
        assert diff[signal].max(initial=0) <= PARAM_ATOL, n
        assert diff.max() <= 2 * LR * (1 + 1e-4), n
    if name == "cnn":
        assert batch is None and j_stats is None
        return
    model.update_batch_stats(batch)
    for layer, kv in tresnet.batch_stats_from_jax(j_stats).items():
        for k, want in kv.items():
            got = model.batch_stats()[layer][k]
            np.testing.assert_allclose(
                got.numpy(), want.numpy(), atol=1e-5 * want.abs().max(),
                err_msg=f"{layer}.{k}",
            )


def test_pure_ddp_matches_jax_class_in_a_mixed_quorum():
    """One JAX and one port ``PureDistributedDataParallel``, a dict whose
    keys are not sorted: each leaf averaged with its twin, exact in fp32."""
    run_leaf_pair("pure", quantize=False)


DRILL_STEPS = 8
DRILL_ARGS = [
    "--model", "resnet-tiny", "--batch-size", "4", "--image-size", "32",
    "--steps", str(DRILL_STEPS), "--quantize", "--quantize-bits", "4",
    "--error-feedback", "--device", "cpu",
]


# Covers a first-use build of the C++ binaries (~1 min) before the drill.
@pytest.mark.timeout(300)
def test_resnet_two_groups_kill_heal_params_and_statistics(tmp_path):
    results = kill_heal_drill(
        DRILL_ARGS,
        str(tmp_path / "results"),
        str(tmp_path / "logs"),
        kill_after_step=3,
        timeout_s=200.0,
        env={"OMP_NUM_THREADS": "1"},
        trainer="torchft_tpu_torch.train_ddp",
        mark="[group 1] step={n} loss=",
    )
    healed = (tmp_path / "logs" / "group1.log").read_text()
    assert "SIGKILLed after step 3" in healed
    assert "healing from replica_rank=0" in healed.split("SIGKILLed")[1]
    for r in results.values():
        assert r["final_step"] == DRILL_STEPS
        assert not r["drained"]
        assert r["device"] == "cpu"
        assert (r["quantize"], r["bits"]) == (True, 4)
        assert r["losses"] and all(math.isfinite(x) for x in r["losses"])
        # CPU tensors take the plain versions: no kernel launch is counted.
        assert not any(r["kernel_launches"].values())
    assert results[0]["param_sha256"] == results[1]["param_sha256"], results
    # The relaunched group's first committed step started from the
    # survivor's statistics; after it each group's own data moves them.
    stats = [results[g]["batch_stats_sha"] for g in (0, 1)]
    first = min(stats[1], key=int)
    assert 0 < int(first) < DRILL_STEPS - 1, stats
    assert stats[1][first] == stats[0][first]
    assert stats[1][str(int(first) + 1)] != stats[0][str(int(first) + 1)]


def _run(*flags):
    return subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.train_ddp", *flags],
        capture_output=True, text=True, timeout=60,
    )


@pytest.mark.timeout(300)
def test_durable_resume_equals_uninterrupted_run(tmp_path):
    """A run stopped at step 4 and relaunched to step 6 resumes from its
    snapshot (the BatchNorm statistics included) and ends in the params
    and statistics of an uninterrupted 6-step run."""
    resumed, whole, _ = durable_resume(
        "torchft_tpu_torch.train_ddp", tmp_path, "--steps",
        ["--model", "resnet-tiny", "--batch-size", "4"],
    )
    assert resumed["final_step"] == whole["final_step"] == 6
    assert resumed["param_sha256"] == whole["param_sha256"]
    assert resumed["batch_stats_sha"]["5"] == whole["batch_stats_sha"]["5"]


def test_no_card_exits_naming_the_cpu_flag():
    """The trainer runs on cuda by default and never falls back: without a
    card it exits naming --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs on it")
    proc = _run("--model", "resnet50", "--image-size", "224", "--num-classes", "1000")
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr, proc.stderr
