"""The port's LocalSGD / DiLoCo (``torchft_tpu_torch/local_sgd.py``) against
the JAX package's.

- Twins of tests/test_local_sgd.py's unit tests, against a fake manager:
  validation, the schedule, alpha, the round-robin, the state_dict round
  trip, partition_fragments, streaming buckets, error feedback and its
  reset on heal. Params are CPU tensors.
- The outer SGD against ``optax.sgd`` and the alpha merge against the
  numpy expression, bit for bit.
- ``partition_fragments`` on the port's ``state_dict`` against the JAX
  package's on the flax tree it was carried from.
- The slice as a whole: JAX DiLoCo and port DiLoCo, each a 1-replica
  quorum with a real lighthouse and Manager, on ``llama_debug`` carried
  across with ``params_from_jax``, fed the same numpy token batches through
  each side's trainer inner step; their fragment backups must agree.
"""

from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Any, Dict, List

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchft_tpu import local_sgd as jlocal
from torchft_tpu.models import Transformer as JTransformer
from torchft_tpu.models import llama_debug as jllama_debug
from torchft_tpu_torch.collectives import dequantize_blockwise, quantize_blockwise
from torchft_tpu_torch.local_sgd import (
    SGD,
    DiLoCo,
    LocalSGD,
    _Fragment,
    alpha_merge,
    apply_updates,
    partition_fragments,
)
from torchft_tpu_torch.models import Transformer, llama_debug
from torchft_tpu_torch.models.llama import params_from_jax
from torchft_tpu_torch.work import DummyWork


class FakeManager:
    """Just enough Manager surface for the schedule tests."""

    def __init__(self) -> None:
        self.allreduce_calls: List[List[np.ndarray]] = []
        self.quorums = 0
        self.commits = 0
        self.commit_answer = True
        self.num = 2
        self._step = 0
        self.registered = {}

    def register_state_dict_fn(self, key, state_fn, load_fn):
        self.registered[key] = (state_fn, load_fn)

    @contextmanager
    def fenced_state_dict(self):
        yield

    def start_quorum(self, **kw):
        self.quorums += 1

    def allreduce(self, tensors, should_quantize=False, quantize_bits=8,
                  on_local_quantized=None):
        if not isinstance(tensors, (list, tuple)):
            tensors = [tensors]
        arrays = [np.array(t, dtype=np.float32) for t in tensors]
        if should_quantize and on_local_quantized is not None:
            # The real collective's contract: quantize the flat payload and
            # hand (flat, q, s) to the hook.
            flat = np.concatenate([a.reshape(-1) for a in arrays])
            q, s = quantize_blockwise(flat, quantize_bits)
            on_local_quantized(flat, q, s)
        # Averaging with a peer holding zeros: result = x / num.
        out = [a / self.num for a in arrays]
        self.allreduce_calls.append(arrays)
        return DummyWork(out)

    def should_commit(self, **kw):
        self.commits += 1
        if self.commit_answer:
            self._step += 1
        return self.commit_answer

    def current_step(self):
        return self._step


def make_params() -> Dict[str, torch.Tensor]:
    return {"w": torch.full((4, 4), 2.0), "b": torch.full((4,), 4.0)}


class Box:
    def __init__(self, params: Dict[str, torch.Tensor]) -> None:
        self.params = params

    def get(self):
        return self.params

    def set(self, p):
        self.params = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}

    def frag(self, keys):
        def setter(p):
            for k in keys:
                self.params[k] = torch.tensor(np.asarray(p[k]))

        return (keys, lambda: {k: self.params[k] for k in keys}, setter)


def _np(t) -> np.ndarray:
    return np.asarray(t)


# ---------------------------------------------------------------------------
# Twins of tests/test_local_sgd.py's unit tests
# ---------------------------------------------------------------------------


def test_local_sgd_schedule_and_average():
    m = FakeManager()
    box = Box(make_params())
    ls = LocalSGD(m, box.get, box.set, sync_every=3)
    assert ls.step() is None
    assert ls.step() is None
    assert m.quorums == 0
    assert ls.step() is True  # third step syncs
    assert m.quorums == 1
    np.testing.assert_array_equal(_np(box.params["w"]), np.full((4, 4), 1.0))
    np.testing.assert_array_equal(_np(box.params["b"]), np.full((4,), 2.0))
    state_fn, load_fn = m.registered["LocalSGD"]
    state = state_fn()
    assert all(isinstance(v, np.ndarray) for v in state.values())
    box.params["w"] += 1.0  # the heal payload is a copy, not a view
    np.testing.assert_array_equal(state["w"], np.full((4, 4), 1.0))


def test_local_sgd_failed_commit_keeps_params():
    m = FakeManager()
    m.commit_answer = False
    box = Box(make_params())
    ls = LocalSGD(m, box.get, box.set, sync_every=1)
    assert ls.step() is False
    np.testing.assert_array_equal(_np(box.params["w"]), np.full((4, 4), 2.0))


def test_local_sgd_quantized_sync():
    """LocalSGD hands its tensors to the manager as they are, with the
    int8 flag; sub-8-bit is refused with a pointer at DiLoCo."""
    m = FakeManager()
    box = Box(make_params())
    seen = {}
    orig = m.allreduce

    def spy(tensors, should_quantize=False, quantize_bits=8, **kw):
        seen["q"], seen["bits"] = should_quantize, quantize_bits
        seen["types"] = {type(t) for t in tensors}
        return orig(tensors, should_quantize, quantize_bits, **kw)

    m.allreduce = spy
    ls = LocalSGD(m, box.get, box.set, sync_every=1, should_quantize=True)
    assert ls.step() is True
    assert seen == {"q": True, "bits": 8, "types": {torch.Tensor}}
    with pytest.raises(ValueError, match="DiLoCo"):
        LocalSGD(m, box.get, box.set, sync_every=1, should_quantize=True,
                 quantize_bits=4)


def test_diloco_validation_messages_equal_jax():
    """Each refusal raises the JAX package's ValueError, message and all."""
    cases = [
        dict(n=2, sync_every=3),
        dict(n=1, sync_every=4, fragment_sync_delay=4),
        dict(n=2, sync_every=4, fragment_sync_delay=2),
        dict(n=1, sync_every=4, fragment_update_alpha=1.5),
    ]
    for case in cases:
        n = case.pop("n")
        messages = []
        for mod, params in ((jlocal, {"w": np.zeros(4)}), (None, make_params())):
            m = FakeManager()
            box = Box(params)
            frag = (["w"], box.get, box.set)
            with pytest.raises(ValueError) as err:
                (jlocal.DiLoCo if mod else DiLoCo)(m, [frag] * n, **case)
            messages.append(str(err.value))
        assert messages[0] == messages[1], case


def test_diloco_rejects_async_quorum_manager():
    m = FakeManager()
    m.use_async_quorum = True
    box = Box(make_params())
    with pytest.raises(ValueError, match="async"):
        DiLoCo(m, [(["w", "b"], box.get, box.set)], sync_every=2)


def test_diloco_alpha_is_local_weight():
    """alpha = weight of the LOCAL params: local' = (1-a)*global + a*local."""
    m = FakeManager()
    box = Box(make_params())
    diloco = DiLoCo(
        m, [(["w", "b"], box.get, box.set)], sync_every=1,
        outer_optimizer=SGD(1.0), fragment_update_alpha=0.5,
    )
    box.set({"w": np.zeros((4, 4)), "b": np.zeros(4)})
    assert diloco.step() is True
    # backup 2, pseudograd 2 -> averaged 1, sgd lr 1 -> global 1.0;
    # merged 0.5 * 1.0 + 0.5 * 0.0 = 0.5
    np.testing.assert_array_equal(_np(box.params["w"]), np.full((4, 4), 0.5))
    np.testing.assert_array_equal(
        diloco.fragments[0]._backup["w"], np.full((4, 4), 1.0)
    )


def test_diloco_single_fragment_outer_sgd():
    m = FakeManager()
    box = Box(make_params())
    diloco = DiLoCo(
        m, [(["w", "b"], box.get, box.set)], sync_every=2,
        outer_optimizer=SGD(1.0),
    )
    box.set({"w": np.zeros((4, 4)), "b": np.zeros(4)})
    assert diloco.step() is None
    assert diloco.step() is True
    # backup 2, pseudograd 2 -> averaged 1, sgd lr 1 -> 2 - 1 = 1
    np.testing.assert_array_equal(_np(box.params["w"]), np.full((4, 4), 1.0))
    assert m.quorums == 1


def test_diloco_failed_sync_restores_global():
    m = FakeManager()
    m.commit_answer = False
    box = Box(make_params())
    diloco = DiLoCo(m, [(["w", "b"], box.get, box.set)], sync_every=1)
    box.set({"w": np.zeros((4, 4)), "b": np.zeros(4)})
    assert diloco.step() is False
    np.testing.assert_array_equal(_np(box.params["w"]), np.full((4, 4), 2.0))


def test_diloco_backup_is_a_copy_of_the_live_tensors():
    """In-place inner updates must not move the global backup."""
    m = FakeManager()
    box = Box(make_params())
    diloco = DiLoCo(m, [(["w", "b"], box.get, box.set)], sync_every=2)
    box.params["w"].sub_(1.0)
    np.testing.assert_array_equal(
        diloco.fragments[0]._backup["w"], np.full((4, 4), 2.0)
    )


def test_streaming_fragments_round_robin():
    m = FakeManager()
    box = Box(make_params())
    diloco = DiLoCo(
        m, [box.frag(["w"]), box.frag(["b"])], sync_every=4,
        fragment_sync_delay=1,
    )
    for _ in range(8):
        diloco.step()
    # One round every sync_every // n_fragments = 2 inner steps: 4 rounds.
    assert m.quorums == 4
    assert m.commits == 4
    assert [a[0].size for a in m.allreduce_calls] == [16, 4, 16, 4]
    assert not diloco.sync_in_flight


def test_healed_replica_syncs_its_peers_fragment():
    """A relaunched replica heals to its peers' step inside the sync's
    quorum; it must then sync the fragment of that step (step % n), as its
    peers do, not the fragment of its pre-heal step 0."""
    m = FakeManager()
    box = Box(make_params())
    diloco = DiLoCo(m, [box.frag(["w"]), box.frag(["b"])], sync_every=2)

    def start_quorum_healing_to_step_3(**kw):
        m.quorums += 1
        m._step = 3

    m.start_quorum = start_quorum_healing_to_step_3
    assert diloco.step() is True
    assert [a[0].size for a in m.allreduce_calls] == [4]  # fragment 1, "b"


def test_sync_in_flight_covers_the_delay_window():
    m = FakeManager()
    box = Box(make_params())
    diloco = DiLoCo(m, [box.frag(["w"]), box.frag(["b"])], sync_every=4,
                    fragment_sync_delay=1)
    diloco.step()  # prepares (interval 2 - delay 1)
    assert diloco.sync_in_flight
    assert diloco.step() is True
    assert not diloco.sync_in_flight


def test_diloco_state_dict_roundtrip():
    """state_dict -> load_state_dict restores the global state bitwise into
    a FRESH instance and resets its local params to it."""
    m = FakeManager()
    box = Box(make_params())
    diloco = DiLoCo(m, [box.frag(["w"]), box.frag(["b"])], sync_every=2)
    for _ in range(4):  # both fragments sync: backups + opt states move
        box.set({k: np.asarray(v) - 0.5 for k, v in box.params.items()})
        diloco.step()
    state = diloco.state_dict()
    assert set(state) == {"fragment_0", "fragment_1"}
    assert set(state["fragment_0"]["opt_state"]) == {"trace"}

    m2 = FakeManager()
    box2 = Box(make_params())
    diloco2 = DiLoCo(m2, [box2.frag(["w"]), box2.frag(["b"])], sync_every=2)
    diloco2.load_state_dict(
        {f: {"backup": {k: torch.from_numpy(v) for k, v in s["backup"].items()},
             "opt_state": s["opt_state"]}
         for f, s in state.items()}
    )
    for f1, f2 in zip(diloco.fragments, diloco2.fragments):
        for k in f1._backup:
            np.testing.assert_array_equal(f1._backup[k], f2._backup[k])
            assert f2._backup[k].dtype == np.float32
            np.testing.assert_array_equal(
                f1._opt_state["trace"][k], f2._opt_state["trace"][k]
            )
    np.testing.assert_array_equal(
        _np(box2.params["w"]), diloco.fragments[0]._backup["w"]
    )


def test_diloco_streaming_buckets_split_and_preserve_numerics():
    """A fragment over the bucket cap sends one allreduce per bucket and
    gives the unbucketed result."""

    def run(bucket_cap_mb):
        m = FakeManager()
        params = {
            "a": torch.full((1000,), 2.0),  # 4000 B
            "b": torch.full((1000,), 4.0),
            "c": torch.full((500,), 6.0),
        }
        box = Box(params)
        diloco = DiLoCo(
            m, [(list(params), box.get, box.set)], sync_every=1,
            outer_optimizer=SGD(1.0), bucket_cap_mb=bucket_cap_mb,
        )
        box.set({k: np.zeros(v.shape, np.float32) for k, v in params.items()})
        assert diloco.step() is True
        return m, {k: _np(v).copy() for k, v in box.params.items()}

    m_small, out_small = run(bucket_cap_mb=4096 / (1024 * 1024))
    assert len(m_small.allreduce_calls) == 3
    m_big, out_big = run(bucket_cap_mb=32.0)
    assert len(m_big.allreduce_calls) == 1
    for k in out_small:
        np.testing.assert_array_equal(out_small[k], out_big[k])


def test_diloco_int4_error_feedback_unbiases_the_stream():
    """With int4 + error feedback the decoded stream's SUM tracks the true
    cumulative pseudograd within one quantization step; without it the
    per-sync bias accumulates."""
    g = np.full((64,), 0.3, np.float32)
    g[0] = 7.0  # pins the block scale to 1.0

    def run(error_feedback: bool, syncs: int = 8):
        mgr = FakeManager()
        local = {"w": torch.from_numpy(-g)}  # pseudograd = 0 - local = g
        frag = _Fragment(
            0, mgr, ["w"], lambda: local, lambda p: None, SGD(1.0), 0.0,
            should_quantize=True, quantize_bits=4, error_feedback=error_feedback,
        )
        frag._backup = {"w": np.zeros((64,), np.float32)}
        decoded_sum = np.zeros_like(g)
        for _ in range(syncs):
            mgr.allreduce_calls.clear()
            frag.prepare_sync()
            (payload,) = mgr.allreduce_calls[-1]
            q, s = quantize_blockwise(payload, bits=4)
            decoded_sum += dequantize_blockwise(q, s, payload.size, bits=4)
            frag._pending = []  # skip perform_sync: keep g constant
        return decoded_sum

    true_sum = g * 8
    assert np.abs(run(False) - true_sum).max() >= 2.0
    assert np.abs(run(True) - true_sum).max() <= 0.51


def test_error_feedback_residuals_reset_on_heal():
    """A healed replica's residuals tracked its PRE-heal stream; loading the
    global state clears them and resets the local params to it."""
    m = FakeManager()
    local = {"w": torch.full((64,), -0.3)}
    written = {}
    frag = _Fragment(
        0, m, ["w"], lambda: local, written.update, SGD(1.0), 0.0,
        should_quantize=True, quantize_bits=4, error_feedback=True,
    )
    frag._backup = {"w": np.zeros((64,), np.float32)}
    frag.prepare_sync()
    frag._pending = []
    assert frag._residuals, "EF sync must record a residual"
    state_fn, load_fn = m.registered["DiLoCoFragment_0"]
    load_fn(state_fn())  # heal: reload the global state
    assert not frag._residuals
    np.testing.assert_array_equal(written["w"], np.zeros(64, np.float32))


# ---------------------------------------------------------------------------
# The outer SGD and the alpha merge, bit for bit
# ---------------------------------------------------------------------------


def _seeded(seed: int, shape=(1000,)) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "a": rng.standard_normal(shape).astype(np.float32),
        "b": (rng.standard_normal(37) * 1e-3).astype(np.float32),
    }


@pytest.mark.parametrize(
    "kwargs",
    [dict(learning_rate=0.5), dict(learning_rate=0.7, momentum=0.9, nesterov=True),
     dict(learning_rate=0.7, momentum=0.9)],
    ids=["plain", "nesterov", "momentum"],
)
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_outer_sgd_bitwise_equal_to_optax(kwargs, kind):
    ref = optax.sgd(**kwargs)
    port = SGD(**kwargs)
    conv = (lambda d: d) if kind == "numpy" else (
        lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    )
    p_ref = _seeded(0)
    p_port = conv({k: v.copy() for k, v in p_ref.items()})
    s_ref, s_port = ref.init(p_ref), port.init(p_port)
    for step in range(5):
        g = _seeded(10 + step)
        u_ref, s_ref = ref.update(g, s_ref, p_ref)
        p_ref = jax.tree_util.tree_map(np.asarray, optax.apply_updates(p_ref, u_ref))
        u_port, s_port = port.update(conv(g), s_port, p_port)
        p_port = apply_updates(p_port, u_port)
        for k in p_ref:
            np.testing.assert_array_equal(np.asarray(u_port[k]), np.asarray(u_ref[k]))
            np.testing.assert_array_equal(np.asarray(p_port[k]), p_ref[k])
            if "momentum" in kwargs:
                np.testing.assert_array_equal(
                    np.asarray(s_port["trace"][k]), np.asarray(s_ref[0].trace[k])
                )


@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.9])
def test_alpha_merge_bitwise_equal_to_numpy(alpha):
    g, l_ = _seeded(1)["a"], _seeded(2)["a"]
    want = (1.0 - alpha) * g + alpha * l_  # the JAX package's expression
    np.testing.assert_array_equal(alpha_merge(g, l_, alpha), want)
    got = alpha_merge(torch.from_numpy(g), torch.from_numpy(l_), alpha)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# partition_fragments against the JAX package's
# ---------------------------------------------------------------------------


def test_partition_fragments_balanced():
    params = {k: torch.zeros(100) for k in "abcd"}
    groups = partition_fragments(params, 2)
    assert groups == jlocal.partition_fragments(
        {k: np.zeros(100, np.float32) for k in "abcd"}, 2
    )
    assert len(groups) == 2 and all(groups)


def test_partition_fragments_front_loaded_sizes():
    params = {"big": torch.zeros(1000), "s1": torch.zeros(1),
              "s2": torch.zeros(1), "s3": torch.zeros(1)}
    groups = partition_fragments(params, 4)
    assert len(groups) == 4 and all(groups), groups


@pytest.fixture(scope="module")
def jax_llama_params():
    """llama_debug's flax tree as the JAX trainer holds it: a tree map (as
    ``jit``'s outputs are) rebuilds the dict in sorted key order."""
    model = JTransformer(jllama_debug())
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _top(name: str) -> str:
    return name.split(".", 1)[0]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_partition_fragments_llama_equal_jax(jax_llama_params, n):
    """The port's groups hold exactly the tensors of JAX's groups: the
    names carried from each JAX group's top-level keys, and the same bytes."""
    state = params_from_jax(jax_llama_params)
    ref = jlocal.partition_fragments(jax_llama_params, n)
    port = partition_fragments(state, n)
    assert len(port) == len(ref) == n
    for names, keys in zip(port, ref):
        assert names == [k for top in keys for k in state if _top(k) == top]
        assert sum(state[k].numel() for k in names) == sum(
            a.size for k in keys
            for a in jax.tree_util.tree_leaves(jax_llama_params[k])
        )


def test_partition_fragments_errors_equal_jax(jax_llama_params):
    state = params_from_jax(jax_llama_params)
    for n in (0, 5):
        with pytest.raises(ValueError) as ref:
            jlocal.partition_fragments(jax_llama_params, n)
        with pytest.raises(ValueError) as port:
            partition_fragments(state, n)
        assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# The slice as a whole: JAX DiLoCo and port DiLoCo on llama_debug
# ---------------------------------------------------------------------------

SLICE_B, SLICE_S = 4, 32
SLICE_INNER = 8


def _batches() -> List[np.ndarray]:
    rng = np.random.default_rng(0)
    return [
        rng.integers(0, 256, (SLICE_B, SLICE_S)).astype(np.int32)
        for _ in range(SLICE_INNER)
    ]


def _one_replica_manager(package: str, lighthouse_addr: str):
    if package == "jax":
        from torchft_tpu.manager import Manager
        from torchft_tpu.process_group import ProcessGroupSocket
    else:
        from torchft_tpu_torch.manager import Manager
        from torchft_tpu_torch.process_group import ProcessGroupSocket
    return Manager(
        pg=ProcessGroupSocket(timeout=15.0),
        min_replica_size=1,
        use_async_quorum=False,
        timeout=15.0,
        quorum_timeout=30.0,
        replica_id=f"slice_{package}",
        lighthouse_addr=lighthouse_addr,
        group_rank=0,
        group_world_size=1,
    )


def _jax_slice(params0, batches, dtype, addr) -> Dict[str, Any]:
    """train_diloco.py's inner step and DiLoCo wiring, the JAX package."""
    model = JTransformer(jllama_debug(dtype=dtype))
    tx = optax.adamw(3e-4)

    @jax.jit
    def inner_step(params, opt_state, x, y):
        def loss_fn(p):
            logits = model.apply({"params": p}, x)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y
            ).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, grads

    state = {"params": jax.tree_util.tree_map(jnp.asarray, params0)}
    opt_state = tx.init(state["params"])

    def make_fragment(keys):
        def get():
            return {k: state["params"][k] for k in keys}

        def set_(frag):
            new = dict(state["params"])
            for k in keys:
                new[k] = jax.tree_util.tree_map(
                    lambda cur, v: jnp.asarray(np.asarray(v), cur.dtype),
                    state["params"][k], frag[k],
                )
            state["params"] = new

        return (keys, get, set_)

    manager = _one_replica_manager("jax", addr)
    try:
        diloco = jlocal.DiLoCo(
            manager,
            [make_fragment(g) for g in jlocal.partition_fragments(state["params"], 2)],
            sync_every=4,
            fragment_sync_delay=1,
        )
        commits, grads_seen = [], []
        for x in batches:
            xj = jnp.asarray(x)
            state["params"], opt_state, grads = inner_step(
                state["params"], opt_state, xj, jnp.roll(xj, -1, axis=1)
            )
            grads_seen.append(
                params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
            )
            c = diloco.step()
            if c is not None:
                commits.append(c)
        backup = {}
        for f in diloco.fragments:
            backup.update(f._backup)
        return {
            "backup": params_from_jax(backup),
            "commits": commits,
            "grads": grads_seen,
        }
    finally:
        manager.shutdown()


def _port_slice(params0, batches, dtype, addr) -> Dict[str, Any]:
    """The port trainer's inner step and DiLoCo wiring."""
    from torchft_tpu_torch.train_diloco import (
        inner_optimizer,
        inner_step,
        make_fragment,
    )

    model = Transformer(llama_debug(dtype=dtype))
    model.load_state_dict(params_from_jax(params0))
    optimizer = inner_optimizer(model.parameters(), 3e-4)
    params = dict(model.named_parameters())
    manager = _one_replica_manager("torch", addr)
    try:
        diloco = DiLoCo(
            manager,
            [make_fragment(params, g) for g in partition_fragments(params, 2)],
            sync_every=4,
            fragment_sync_delay=1,
        )
        commits, grads_seen = [], []
        for x in batches:
            xt = torch.from_numpy(x).long()
            inner_step(model, optimizer, xt, torch.roll(xt, -1, 1))
            grads_seen.append({n: p.grad.clone() for n, p in params.items()})
            c = diloco.step()
            if c is not None:
                commits.append(c)
        backup = {}
        for f in diloco.fragments:
            backup.update(f._backup)
        return {"backup": backup, "commits": commits, "grads": grads_seen}
    finally:
        manager.shutdown()


def _slice_errors(dtype_name: str) -> Dict[str, Any]:
    """Runs both slices on the same weights and batches; returns the
    element-wise |port - JAX| of the final fragment backups (by name) and
    the mask of the elements whose gradient, at some inner step, was below
    AdamW's eps on either side and differed between the sides (a sum that
    cancelled to its rounding noise; gradients that are exactly 0 on both
    sides, as for tokens absent from a batch, are not in it)."""
    from torchft_tpu_torch.coordination import LighthouseServer

    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    model = JTransformer(jllama_debug())
    params0 = jax.tree_util.tree_map(
        np.asarray,
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"],
    )
    batches = _batches()
    lighthouses = [
        LighthouseServer(bind="127.0.0.1:0", min_replicas=1,
                         join_timeout_ms=1000, quorum_tick_ms=20)
        for _ in range(2)
    ]
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            fj = pool.submit(_jax_slice, params0, batches, jdt, lighthouses[0].address())
            fp = pool.submit(_port_slice, params0, batches, tdt, lighthouses[1].address())
            ref, port = fj.result(timeout=240), fp.result(timeout=240)
    finally:
        for lh in lighthouses:
            lh.shutdown()
    # 8 inner steps, 2 fragments, sync_every 4: four committed rounds.
    assert ref["commits"] == port["commits"] == [True] * 4
    assert set(ref["backup"]) == set(port["backup"])
    start = params_from_jax(params0)
    err, eps_bound = {}, {}
    for name, want in ref["backup"].items():
        want = want.numpy()
        assert not np.array_equal(want, start[name].numpy()), name  # it moved
        err[name] = np.abs(port["backup"][name] - want)
        mask = np.zeros(want.shape, bool)
        for g_ref, g_port in zip(ref["grads"], port["grads"]):
            a, b = g_ref[name].numpy(), g_port[name].float().numpy()
            mask |= (np.minimum(np.abs(a), np.abs(b)) < ADAM_EPS) & (a != b)
        eps_bound[name] = mask
    return {"err": err, "eps_bound": eps_bound}


INNER_LR = 3e-4
ADAM_EPS = 1e-8
# The most the outer optimizer (SGD 0.7, nesterov momentum 0.9) multiplies a
# difference in one fragment's pseudograd by over its two syncs in 8 inner
# steps: 0.7 * (1 + 0.9) at the first, 0.7 * (0.9 + 0.81) at the second.
OUTER_GAIN = 0.7 * (1.9 + 1.71)


@pytest.mark.timeout(300)
def test_whole_slice_fp32_backups_agree_with_jax():
    """fp32: the two inner steps differ by rounding only (summation order in
    the matmuls and the softmax, AdamW's order of operations), and the
    backups agree within 1e-5. Where an element's gradient cancels to
    rounding noise (|g| < eps = 1e-8, set by each framework's summation
    order), AdamW's step lr * g / (|g| + eps) is set by that noise: such
    elements may differ by up to 2 * lr per inner step through the outer
    optimizer's gain. The test prints the measured errors (pytest -s)."""
    out = _slice_errors("float32")
    err = np.concatenate([e.ravel() for e in out["err"].values()])
    mask = np.concatenate([m.ravel() for m in out["eps_bound"].values()])
    print(
        f"fp32 whole slice: max |port - JAX| {err.max():.4g} over {err.size} "
        f"values; {int(mask.sum())} eps-bound, the rest within "
        f"{err[~mask].max():.4g} (rms {np.sqrt(np.mean(err[~mask] ** 2.0)):.4g})"
    )
    assert err[~mask].max() <= 1e-5
    assert err[mask].max(initial=0.0) <= 1e-5 + 2 * INNER_LR * OUTER_GAIN
    assert mask.sum() <= err.size // 10_000, mask.sum()  # a few cancelled sums


# bf16 compute (fp32 params): each side rounds activations and products to
# bf16 at its own places, so gradients differ in their ninth bit, and
# AdamW's g / sqrt(v) turns that into up to a whole step wherever a
# gradient is within that noise of 0. Measured on the CPU by this test
# (it prints them): max |port - JAX| 2.18e-3, rms 7.16e-5 over the 106,816
# backup values; the limits are twice those.
BF16_MAX_ERR = 4.4e-3
BF16_RMS_ERR = 1.5e-4


@pytest.mark.timeout(300)
def test_whole_slice_bf16_backups_agree_with_jax():
    out = _slice_errors("bfloat16")
    err = np.concatenate([e.ravel() for e in out["err"].values()])
    rms = float(np.sqrt(np.mean(err.astype(np.float64) ** 2)))
    print(f"bf16 whole slice: max |port - JAX| {err.max():.4g}, rms {rms:.4g}")
    assert err.max() <= BF16_MAX_ERR, err.max()
    assert rms <= BF16_RMS_ERR, rms
