"""The port's DurableCheckpointer (its own one-file-per-step format in the
heal wire's stream encoding) beside the JAX package's orbax one: the twins
of tests/test_durable_checkpoint.py, the leaf order of the fingerprint and
``rehang_like`` against JAX's, a JAX snapshot's values restored bit for bit
from a port snapshot of the same state, the owned copy ``save`` takes, and a
torn save."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.checkpointing import durable as jdurable
from torchft_tpu_torch.checkpointing import DurableCheckpointer
from torchft_tpu_torch.checkpointing import durable as tdurable


def test_save_restore_roundtrip(tmp_path):
    ckpt = DurableCheckpointer(str(tmp_path), every=10, keep=2)
    state = {"w": torch.arange(8, dtype=torch.float32), "step": 40}
    assert not ckpt.maybe_save(41, state)  # off-cadence
    assert ckpt.maybe_save(40, state)
    ckpt.wait()
    assert ckpt.latest_step() == 40
    restored = ckpt.restore()
    np.testing.assert_array_equal(restored["w"], np.arange(8, dtype=np.float32))
    assert int(restored["step"]) == 40
    ckpt.close()


def test_maybe_save_state_factory_called_only_on_cadence(tmp_path):
    """A callable state is built only when a save happens: off-cadence
    steps must not pay the device->host copy."""
    ckpt = DurableCheckpointer(str(tmp_path), every=10, keep=2)
    calls = []

    def factory():
        calls.append(True)
        return {"w": torch.zeros(4)}

    assert not ckpt.maybe_save(7, factory)
    assert calls == []
    assert ckpt.maybe_save(20, factory)
    assert calls == [True]
    ckpt.wait()
    assert ckpt.latest_step() == 20
    ckpt.close()


def test_retention_keeps_latest_and_prunes_sidecars(tmp_path):
    ckpt = DurableCheckpointer(str(tmp_path), every=1, keep=2)
    for step in (1, 2, 3):
        ckpt.save(step, {"v": torch.full((4,), float(step))})
    ckpt.wait()
    assert ckpt.latest_step() == 3 and ckpt.all_steps() == [2, 3]
    np.testing.assert_array_equal(ckpt.restore(step=3)["v"], 3.0)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(step=1)  # oldest pruned
    assert sorted(p.name for p in (tmp_path / "fingerprints").iterdir()) == [
        "2.json", "3.json",
    ]
    assert [s["step"] for s in ckpt.saves] == [1, 2, 3]
    ckpt.close()


def test_structure_fingerprint_mismatch_fails_loudly(tmp_path):
    """Restoring into a DIFFERENT structure is refused at the door; a
    matching one restores onto the live leaves' dtype and device."""
    ckpt = DurableCheckpointer(str(tmp_path), every=1)
    state = {"a": torch.arange(8, dtype=torch.float32), "b": torch.zeros(4)}
    ckpt.save(1, state)
    ckpt.wait()
    restored = ckpt.restore(abstract_state=state)
    assert torch.is_tensor(restored["a"]) and restored["a"].device == state["a"].device
    assert torch.equal(restored["a"], state["a"])
    wrong_shape = {"a": torch.zeros(4), "b": torch.zeros(8)}
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(abstract_state=wrong_shape)
    wrong_tree = {**state, "c": torch.zeros(2)}
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(abstract_state=wrong_tree)
    wrong_dtype = {**state, "a": torch.zeros(8, dtype=torch.float64)}
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(abstract_state=wrong_dtype)
    ckpt.close()


def test_structure_fingerprint_missing_sidecar_tolerated(tmp_path):
    """A snapshot whose sidecar was lost still restores: the check is
    advisory when absent, loud when present."""
    ckpt = DurableCheckpointer(str(tmp_path), every=1)
    state = {"w": torch.ones(4)}
    ckpt.save(1, state)
    ckpt.wait()
    fp = ckpt._fingerprint_path(1)
    assert fp.exists()
    fp.unlink()
    restored = ckpt.restore(abstract_state=state)
    assert torch.equal(restored["w"], torch.ones(4))
    ckpt.close()


def _unsorted_tree():
    """Keys inserted out of sorted order, nested, with a list, a tuple, a
    None node and Python scalars."""
    rng = np.random.default_rng(0)
    return {
        "z": rng.standard_normal(3).astype(np.float32),
        "m": {"step": 4, "b": rng.standard_normal((2, 2))},
        "a": [np.arange(5, dtype=np.int32), (np.float32(2.5),), None],
        "k": 1.5,
    }


def test_fingerprint_and_rehang_leaf_order_equal_jax():
    """Both flatten a dict with its keys sorted, as jax.tree_util does, so
    the fingerprint and the re-hang of a saved tree onto a live one are
    JAX's, leaf for leaf."""
    tree = _unsorted_tree()
    assert tdurable.structure_fingerprint(tree) == jdurable.structure_fingerprint(tree)
    cur = {"b": np.zeros(2, np.float32), "a": np.zeros(3), "c": 5}
    saved = {"c": 7, "a": np.arange(3.0), "b": np.array([1, 2], np.int64)}
    got = DurableCheckpointer.rehang_like(cur, saved)
    want = jdurable.DurableCheckpointer.rehang_like(cur, saved)
    assert list(got) == list(want) == ["a", "b", "c"]
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_port_snapshot_restores_a_jax_snapshots_values(tmp_path):
    """The same numpy state saved by both packages restores to the same
    values, bit for bit (bf16 through the JAX side's ml_dtypes and the
    port's raw-bits path)."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b16 = torch.from_numpy(rng.standard_normal(6).astype(np.float32)).bfloat16()
    jstate = {"w": jnp.asarray(w), "h": jnp.asarray(b16.float().numpy(), jnp.bfloat16),
              "n": {"s": jnp.asarray(np.int32(3))}}
    tstate = {"w": torch.from_numpy(w), "h": b16,
              "n": {"s": torch.tensor(3, dtype=torch.int32)}}
    jc = jdurable.DurableCheckpointer(str(tmp_path / "jax"), every=1)
    jc.save(5, jstate)
    jc.wait()
    want = jc.restore()
    jc.close()
    tc = DurableCheckpointer(str(tmp_path / "port"), every=1)
    tc.save(5, tstate)
    tc.wait()
    got = tc.restore()
    tc.close()
    assert np.asarray(got["w"]).tobytes() == np.asarray(want["w"]).tobytes()
    assert got["h"].view(torch.int16).numpy().tobytes() == np.asarray(want["h"]).tobytes()
    assert int(got["n"]["s"]) == int(want["n"]["s"]) == 3


def test_save_owns_its_copy_of_a_cpu_tensor(tmp_path):
    """save returns with its own copy: an in-place update of the live CPU
    tensor right after (what optimizer.step() does) does not reach the
    snapshot."""
    ckpt = DurableCheckpointer(str(tmp_path), every=1)
    live = {"w": torch.arange(1 << 16, dtype=torch.float32),
            "host": np.arange(4.0)}
    ckpt.save(1, live)
    live["w"].add_(1.0)
    live["host"] += 1.0
    ckpt.wait()
    got = ckpt.restore()
    np.testing.assert_array_equal(got["w"], np.arange(1 << 16, dtype=np.float32))
    np.testing.assert_array_equal(got["host"], np.arange(4.0))
    ckpt.close()


def test_torn_save_is_not_a_step(tmp_path):
    """A .tmp file that a killed save left behind is ignored by
    latest_step and restore."""
    ckpt = DurableCheckpointer(str(tmp_path), every=1)
    ckpt.save(4, {"w": torch.ones(3)})
    ckpt.wait()
    (tmp_path / "8.ckpt.tmp").write_bytes(b"\x00" * 11)  # torn mid-write
    assert ckpt.latest_step() == 4
    assert torch.equal(torch.as_tensor(ckpt.restore()["w"]), torch.ones(3))
    ckpt.close()


def test_failed_write_raises_at_wait(tmp_path):
    """A snapshot that cannot be written raises at wait(), not silently."""
    ckpt = DurableCheckpointer(str(tmp_path), every=1)
    ckpt.save(1, {"f": lambda: None})  # not picklable
    with pytest.raises(RuntimeError, match="durable snapshot write failed"):
        ckpt.wait()
    ckpt.close()


# Covers a first-use build of the C++ binaries (~1 min) before the drill.
@pytest.mark.timeout(300)
def test_preempt_all_drill_resumes_from_the_drain_snapshots(tmp_path):
    """The full-job preemption drill on the CPU (``train_hsdp``,
    llama_debug): both groups are SIGTERMed after group 1's step 3, drain
    with a snapshot, and a relaunch against a fresh lighthouse resumes each
    from its drain-time snapshot and ends with both groups in the same
    bits."""
    from torchft_tpu_torch.drill import preempt_all_drill

    out = preempt_all_drill(
        "torchft_tpu_torch.train_hsdp",
        ["--model", "debug", "--steps", "8", "--device", "cpu",
         "--durable-every", "4", "--durable-dir", str(tmp_path / "durable")],
        str(tmp_path / "results"),
        str(tmp_path / "logs"),
        term_after_step=3,
        timeout_s=240.0,
        env={"OMP_NUM_THREADS": "1"},
    )
    assert out["final_steps"] == [8, 8]
    assert out["resumed_from_steps"] == out["drained_steps"]
    assert all(3 < s < 8 for s in out["drained_steps"]), out["drained_steps"]
    for g in (0, 1):
        assert out["drain"][g]["drained"] and not out["resume"][g]["drained"]
        saved = [s["step"] for s in out["drain"][g]["durable_saves"]]
        assert out["drained_steps"][g] == saved[-1], saved
    shas = {out["resume"][g]["param_sha256"] for g in (0, 1)}
    assert len(shas) == 1
