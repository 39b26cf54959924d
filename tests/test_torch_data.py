"""The port's ``data.py`` (the twin of tests/test_elastic_data.py):
DistributedSampler.reshard and ElasticDataIterator keep every index exactly
once per epoch under any world-size walk, the stream is seeded and
deterministic, and a joiner heals its position from an incumbent. Then the
port's index streams equal the JAX package's for the same (n, rank, world,
seed, epoch) walks."""

import numpy as np
import pytest

from torchft_tpu import data as jdata
from torchft_tpu_torch.data import (
    DistributedSampler,
    ElasticDataIterator,
    StatefulDataIterator,
)


def _fleet(world, state, n, seed, batch):
    """One iterator per rank at ``world``, all loaded to the same global
    stream position — what every participant holds right after a resize
    at a lockstep quorum boundary."""
    its = []
    for r in range(world):
        s = DistributedSampler(n, r, world, shuffle=True, seed=seed)
        it = ElasticDataIterator(s, batch)
        it.load_state_dict(dict(state))
        its.append(it)
    return its


def _step(its, sink=None):
    """One lockstep fleet-batch; asserts the global cursor agrees
    fleet-wide afterwards (the elasticity contract)."""
    outs = [next(it) for it in its]
    states = {tuple(sorted(it.state_dict().items())) for it in its}
    assert len(states) == 1, "ranks disagree on the global position"
    if sink is not None:
        for o in outs:
            sink.extend(int(i) for i in o)
    return its[0].state_dict()


# ---------------------------------------------------------------------------
# Exactly-once per epoch across the 2 -> 8 -> 3 walk
# ---------------------------------------------------------------------------


def test_world_walk_2_8_3_exactly_once_per_epoch():
    n, batch, seed = 97, 2, 5  # prime length: every phase has a ragged tail
    seen = []
    state = {"epoch": 0, "gpos": 0}
    its = _fleet(2, state, n, seed, batch)
    for _ in range(4):  # world 2
        state = _step(its, seen)
    its = _fleet(8, state, n, seed, batch)  # grow mid-epoch
    for _ in range(3):
        state = _step(its, seen)
    its = _fleet(3, state, n, seed, batch)  # shrink mid-epoch
    while state["epoch"] == 0 and state["gpos"] < n:
        state = _step(its, seen)
    assert sorted(seen) == list(range(n))  # each index exactly once


def test_reshard_in_place_matches_fresh_fleet():
    """sampler.reshard() on a surviving iterator yields the same stream
    as a freshly constructed fleet at the same position (what a real
    trainer does in place vs what a healed joiner constructs)."""
    n, batch, seed = 64, 4, 9
    state = {"epoch": 0, "gpos": 0}
    its = _fleet(2, state, n, seed, batch)
    for _ in range(3):
        state = _step(its)
    survivor = its[0]
    survivor._sampler.reshard(1, 5)  # same object, new grid position
    fresh = _fleet(5, state, n, seed, batch)[1]
    np.testing.assert_array_equal(next(survivor), next(fresh))


@pytest.mark.parametrize("case", range(4))
def test_random_walk_exactly_once_property(case):
    """Property: ANY seeded world-size walk, resharding at arbitrary
    step boundaries across two epochs, yields every index exactly once
    per epoch — no duplication, no loss."""
    rng = np.random.default_rng(1000 + case)
    n = int(rng.integers(40, 140))
    batch = int(rng.integers(1, 5))
    seed = int(rng.integers(0, 1 << 16))
    state = {"epoch": 0, "gpos": 0}
    its = _fleet(int(rng.integers(1, 9)), state, n, seed, batch)
    seen = {0: [], 1: []}
    while True:
        sink = []
        state = _step(its, sink)
        # Rollover is lazy inside __next__, so post-draw state names the
        # epoch the just-yielded indices belong to.
        if state["epoch"] >= 2:
            break
        seen[state["epoch"]].extend(sink)
        if rng.random() < 0.3:  # resize at this step boundary
            its = _fleet(int(rng.integers(1, 9)), state, n, seed, batch)
    for epoch in range(2):
        assert sorted(seen[epoch]) == list(range(n)), (
            f"epoch {epoch}: walk lost/duplicated indices "
            f"(n={n} batch={batch} seed={seed})"
        )


# ---------------------------------------------------------------------------
# Seeded determinism
# ---------------------------------------------------------------------------


def test_reshard_walk_deterministic_replay():
    def run(seed):
        seq = []
        state = {"epoch": 0, "gpos": 0}
        its = _fleet(2, state, 101, seed, 3)
        for _ in range(5):
            seq.append([next(it).tolist() for it in its])
            state = its[0].state_dict()
        its = _fleet(5, state, 101, seed, 3)
        for _ in range(4):
            seq.append([next(it).tolist() for it in its])
        return seq

    assert run(9) == run(9)  # same seed: identical stream, rank by rank
    assert run(9) != run(10)  # different seed: different permutation


def test_global_order_is_world_independent():
    """The anchor property: the epoch permutation ignores the grid, so
    resharding re-partitions the SAME order (exactly-once is otherwise
    unprovable)."""
    a = DistributedSampler(50, 0, 2, shuffle=True, seed=3)
    b = DistributedSampler(50, 4, 7, shuffle=True, seed=3)
    np.testing.assert_array_equal(a.global_order(), b.global_order())
    a.set_epoch(2)
    assert not np.array_equal(
        a.global_order(), b.global_order()
    )  # but it IS epoch-dependent


# ---------------------------------------------------------------------------
# Joiner state handoff + tail/edge semantics
# ---------------------------------------------------------------------------


def test_joiner_heals_state_and_claims_tail_slice():
    """A mid-epoch joiner loads (epoch, gpos) from an incumbent's
    checkpoint and immediately claims its strided slice of the next
    fleet-batch — the same slice every incumbent computes for it."""
    n, batch, seed = 30, 2, 1
    state = {"epoch": 0, "gpos": 0}
    its = _fleet(2, state, n, seed, batch)
    for _ in range(3):
        state = _step(its)
    joiner = ElasticDataIterator(
        DistributedSampler(n, 2, 3, shuffle=True, seed=seed), batch
    )
    joiner.load_state_dict(its[0].state_dict())  # the healed handoff
    incumbents = _fleet(3, state, n, seed, batch)
    np.testing.assert_array_equal(next(joiner), next(incumbents[2]))


def test_tail_fleet_batch_is_short_not_padded():
    """The epoch tail yields fewer (possibly zero) indices per rank
    rather than duplicating — duplication would silently break
    exactly-once under resizing."""
    n, world, batch = 10, 4, 2  # stride 8: tail fleet-batch has 2 of 10
    its = _fleet(world, {"epoch": 0, "gpos": 0}, n, 0, batch)
    _step(its)
    tail = [next(it) for it in its]
    assert sum(len(t) for t in tail) == 2
    assert its[0].state_dict()["gpos"] == n
    assert its[0].batches_left() == 0


def test_elastic_iterator_rejects_bad_batch():
    s = DistributedSampler(10, 0, 2)
    with pytest.raises(ValueError):
        ElasticDataIterator(s, 0)


def test_reshard_rejects_bad_grid():
    s = DistributedSampler(10, 0, 2)
    with pytest.raises(ValueError):
        s.reshard(5, 3)  # rank beyond the new world
    with pytest.raises(ValueError):
        s.reshard(0, 0)  # empty world
    # a failed reshard must not corrupt the sampler
    assert (s.global_rank, s.global_world_size) == (0, 2)


# ---------------------------------------------------------------------------
# The same index streams as the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_sampler_indices_equal_jax(shuffle, drop_last):
    for n, world, seed in ((97, 4, 5), (10, 3, 0), (64, 8, 9), (5, 7, 2)):
        for rank in range(world):
            for epoch in range(3):
                ports = DistributedSampler(
                    n, rank, world, shuffle=shuffle, seed=seed,
                    drop_last=drop_last,
                )
                ref = jdata.DistributedSampler(
                    n, rank, world, shuffle=shuffle, seed=seed,
                    drop_last=drop_last,
                )
                ports.set_epoch(epoch)
                ref.set_epoch(epoch)
                np.testing.assert_array_equal(ports.indices(), ref.indices())
                np.testing.assert_array_equal(
                    ports.global_order(), ref.global_order()
                )
                assert len(ports) == len(ref)


def test_inner_grid_rank_equal_jax():
    """group_rank / num_replicas place a worker inside its replica group."""
    for g_rank in range(2):
        ports = DistributedSampler(50, 1, 3, group_rank=g_rank, num_replicas=2, seed=4)
        ref = jdata.DistributedSampler(50, 1, 3, group_rank=g_rank, num_replicas=2, seed=4)
        assert (ports.global_rank, ports.global_world_size) == (
            ref.global_rank, ref.global_world_size
        )
        np.testing.assert_array_equal(ports.indices(), ref.indices())


def test_stateful_iterator_stream_and_resume_equal_jax():
    ports = StatefulDataIterator(DistributedSampler(41, 1, 3, seed=7), 4)
    ref = jdata.StatefulDataIterator(jdata.DistributedSampler(41, 1, 3, seed=7), 4)
    for _ in range(9):  # crosses two epoch boundaries (3 batches an epoch)
        np.testing.assert_array_equal(next(ports), next(ref))
        assert ports.state_dict() == ref.state_dict()
    # A healed iterator resumes from the source's position.
    healed = StatefulDataIterator(DistributedSampler(41, 1, 3, seed=7), 4)
    healed.load_state_dict(ref.state_dict())
    for _ in range(4):
        np.testing.assert_array_equal(next(healed), next(ref))
    with pytest.raises(ValueError):
        StatefulDataIterator(DistributedSampler(41, 1, 3), 14)


def test_elastic_walk_equal_jax():
    """One seeded world-size walk with resizes, driven through both
    packages' iterators: the same slices at every step, the same state."""
    rng = np.random.default_rng(3)
    n, batch, seed = 83, 3, 11
    state = {"epoch": 0, "gpos": 0}
    world = 2
    for _ in range(25):
        ports = [
            ElasticDataIterator(DistributedSampler(n, r, world, seed=seed), batch)
            for r in range(world)
        ]
        refs = [
            jdata.ElasticDataIterator(
                jdata.DistributedSampler(n, r, world, seed=seed), batch
            )
            for r in range(world)
        ]
        for it in ports + refs:
            it.load_state_dict(dict(state))
        for p, r in zip(ports, refs):
            np.testing.assert_array_equal(next(p), next(r))
            assert p.batches_left() == r.batches_left()
        assert ports[0].state_dict() == refs[0].state_dict()
        state = ports[0].state_dict()
        world = int(rng.integers(1, 9))
