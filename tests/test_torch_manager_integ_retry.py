"""The allreduce retry of tests/test_manager_integ.py on the port's
``Manager`` (one of the four files of that twin; see
tests/test_torch_manager_integ.py), in a port world and a mixed one, held
to the JAX world's bits.

The worlds differ in how many steps the failure costs, which this file
pins: after the injected failure, a JAX replica's next ``allreduce`` sees
the error still latched (the JAX Manager checks ``errored()`` before it
waits for the quorum that reconfigures the group, ROADMAP.md §3) and skips
its collective, so it discards one more step than the port's Manager
does: one failed commit a replica in the port world, two in the JAX
world. In the mixed world the port replica then waits out the group's 5 s
timeout twice for the JAX replica that skipped, and both discard two
steps. The committed state is the same in all three."""

import pytest

from test_torch_manager_integ import (
    WORLDS,
    EventInjector,
    Runner,
    held_to_jax,
    make_lighthouse,
    run_replicas,
)

FAILED_COMMITS = {("torch", "torch"): [1, 1], ("torch", "jax"): [2, 2], ("jax", "jax"): [2, 2]}
_seen: dict = {}


def _retry(pkgs) -> list:
    """Two replicas, replica 1's allreduce failing at step 1, four steps;
    keeps each replica's failed commits under ``pkgs``."""
    injector = EventInjector().fail_allreduce_at(replica=1, step=1)
    lighthouse = make_lighthouse(2)
    try:
        runners = [Runner(r, lighthouse.address(), injector, pkg=pkgs[r], total_steps=4)
                   for r in range(2)]
        results = run_replicas(runners)
    finally:
        lighthouse.shutdown()
    assert injector.count == 1
    _seen[tuple(pkgs)] = [r.manager_ref[-1].goodput()["failed_commits"] for r in runners]
    return results


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_allreduce_failure_retries_step(world) -> None:
    """An injected allreduce failure on replica 1: both skip that commit
    and recover by reconfiguring, with no restart; the state is the JAX
    world's bits, and each world's failed commits are as pinned above."""
    held_to_jax((2, "allreduce_failure"), _retry, world)
    for pkgs, failed in _seen.items():
        assert failed == FAILED_COMMITS[pkgs], (pkgs, failed)
