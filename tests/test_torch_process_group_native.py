"""The port's ProcessGroupNative: the twins of tests/test_process_group_native.py
over the port's classes (the C++ pipelined engine behind the socket group's
surface, socket-vs-native fp32 bit equality, the int8 engine wire, abort and
reconfigure mid-collective, TORCHFT_PG, the wrapper zoo, the journal rows,
the flight recorder and the runner-driven kill/heal drill with the port's
demo trainer), and what only a port can show: a JAX and a port
ProcessGroupNative in one world, whose fp32 and int8 allreduces give the
JAX-only world's bits, whose bf16 allreduce rides both packages' Python
ring to the same bits, and whose journals hold the same pg_collective
rows."""

import json
import subprocess
import sys
import sysconfig
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

from torchft_tpu import process_group as jpg
from torchft_tpu import telemetry as jtelemetry
from torchft_tpu_torch import _native, _raw_dtypes
from torchft_tpu_torch import telemetry
from torchft_tpu_torch.drill import (
    FAULT_PLANES_ENV,
    fault_planes,
    kill_episode,
    runner_kill_heal_drill,
)
from torchft_tpu_torch.process_group import (
    ErrorSwallowingProcessGroupWrapper,
    FakeProcessGroupWrapper,
    ProcessGroupDummy,
    ProcessGroupNative,
    ProcessGroupSocket,
    ReduceOp,
    make_process_group,
)
from torchft_tpu_torch.store import TCPStoreServer
from torchft_tpu_torch.telemetry import byte_stats

from test_torch_orchestration import _journal_commits

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import goodput_report  # noqa: E402

pytestmark = pytest.mark.skipif(
    not _native.is_available(), reason="native collective engine unavailable"
)

# The package whose ProcessGroupNative (or socket group) a rank runs.
NATIVE = {"torch": ProcessGroupNative, "jax": jpg.ProcessGroupNative}
SOCKET = {"torch": ProcessGroupSocket, "jax": jpg.ProcessGroupSocket}


def _run_parallel(fns, timeout=60):
    with ThreadPoolExecutor(max_workers=len(fns)) as pool:
        futures = [pool.submit(fn) for fn in fns]
        return [f.result(timeout=timeout) for f in futures]


@pytest.fixture
def store():
    server = TCPStoreServer()
    yield server
    server.shutdown()


def _configure(store, groups, prefix):
    ws = len(groups)
    _run_parallel(
        [
            lambda r=r: groups[r].configure(f"{store.address()}/{prefix}", r, ws)
            for r in range(ws)
        ]
    )
    return groups


def _make_group(store, world_size, prefix="npg0", timeout=10.0, **kw):
    groups = [ProcessGroupNative(timeout=timeout, **kw) for _ in range(world_size)]
    return _configure(store, groups, prefix)


def _op(group, op):
    """``op`` as the enum of ``group``'s package."""
    return jpg.ReduceOp(op.value) if isinstance(group, jpg.ProcessGroup) else op


def _allreduce_all(groups, inputs, op, shutdown=True):
    """Every rank's allreduce of its own copy of ``inputs[rank]``; the
    groups are shut down after, unless ``shutdown`` is false."""

    def run(rank):
        arr = inputs[rank].copy()
        groups[rank].allreduce(arr, _op(groups[rank], op)).wait(timeout=30)
        return arr

    try:
        return _run_parallel([lambda r=r: run(r) for r in range(len(groups))])
    finally:
        if shutdown:
            for g in groups:
                g.shutdown()


# -- the engine library ------------------------------------------------------


def test_engine_library_links_the_shared_cxx_runtime():
    """The library is loaded into Python, which holds the shared C++
    runtime; a static copy inside it crashed its first iostream use."""
    from torchft_tpu_torch import coordination

    out = subprocess.run(
        ["readelf", "-d", str(coordination._BIN_DIR / "libtftcollectives.so")],
        capture_output=True, text=True, check=True,
    ).stdout
    assert "[libstdc++.so.6]" in out, out


def test_the_engine_is_built_with_pythons_cxx(monkeypatch):
    """A ``CXX`` in the environment (a toolchain that links libstdc++
    statically) does not reach the build: make gets Python's compiler, and
    ``BIN`` names the directory that the port loads from."""
    from torchft_tpu_torch import coordination

    calls = []

    def run(argv, **kw):
        calls.append(argv)
        return subprocess.CompletedProcess(argv, 0, "", "")

    monkeypatch.setenv("CXX", "/opt/static-toolchain/bin/g++")
    monkeypatch.setattr(coordination, "_BUILT_THIS_PROCESS", False)
    monkeypatch.setattr(coordination.subprocess, "run", run)
    coordination._ensure_built()
    (argv,) = calls
    assert f"CXX={sysconfig.get_config_var('CXX')}" in argv
    assert f"BIN={coordination._BIN_DIR}" in argv
    assert argv[-len(coordination._BUILD_TARGETS):] == [
        str(coordination._BIN_DIR / t) for t in coordination._BUILD_TARGETS
    ]


def _makefile_cxxflags():
    from torchft_tpu_torch import coordination

    for line in (coordination._CPP_DIR / "Makefile").read_text().splitlines():
        if line.startswith("CXXFLAGS ?="):
            return line.split("=", 1)[1].split()
    raise AssertionError("no CXXFLAGS in the Makefile")


def _plant_static_runtime_engine(bin_dir):
    """An engine library in ``bin_dir`` that links the C++ runtime
    statically: the shared build's objects linked with the Makefile's flags
    and ``-static-libstdc++``, as a compiler whose library directory holds
    only ``libstdc++.a`` would link them. Returns its path."""
    from torchft_tpu_torch import coordination

    bin_dir.mkdir()
    lib = bin_dir / coordination.ENGINE_LIBRARY
    objects = [str(coordination._BIN_DIR / f"{o}.o") for o in ("collectives", "net", "chaos")]
    subprocess.run(
        [sysconfig.get_config_var("CXX"), *_makefile_cxxflags(), "-static-libstdc++",
         "-shared", *objects, "-o", str(lib)],
        check=True, capture_output=True,
    )
    assert "libstdc++.so.6" not in _native.needed_libraries(lib)
    return lib


def _point_the_port_at(monkeypatch, bin_dir):
    """``coordination._BIN_DIR`` at ``bin_dir`` (whose control plane counts
    as built), and ``_native``'s cached library and error reset; all put
    back after the test, so other tests keep the shared library."""
    from torchft_tpu_torch import coordination

    monkeypatch.setattr(coordination, "_BIN_DIR", bin_dir)
    monkeypatch.setattr(coordination, "_BUILT_THIS_PROCESS", True)
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_lib_error", None)


@pytest.mark.timeout(180)
def test_load_rebuilds_an_engine_with_a_static_cxx_runtime(store, tmp_path, monkeypatch):
    """A stale library that links a static C++ runtime (make rebuilds
    nothing when only the compiler changed) is rebuilt with Python's
    compiler before it is loaded, and the engine then runs a two-rank
    allreduce and a flight-recorder snapshot. Only ``tmp_path`` is
    written: the shared build directory is left as it is."""
    bin_dir = tmp_path / "bin"
    lib = _plant_static_runtime_engine(bin_dir)
    _point_the_port_at(monkeypatch, bin_dir)
    _native._load()
    assert "libstdc++.so.6" in _native.needed_libraries(lib)
    assert (bin_dir / "collectives.o").exists()  # rebuilt, objects included
    groups = _make_group(store, 2, prefix="static-rt")
    out = _allreduce_all(
        groups, [np.full(1000, r + 1.0, np.float32) for r in range(2)],
        ReduceOp.SUM, shutdown=False,
    )
    try:
        for arr in out:
            np.testing.assert_array_equal(arr, np.full(1000, 3.0, np.float32))
        for g in groups:
            snap = g._engine.fr_snapshot(0)
            assert [r["op"] for r in snap["records"]] == ["allreduce"], snap
    finally:
        for g in groups:
            g.shutdown()


def test_load_raises_when_the_rebuild_keeps_the_static_runtime(tmp_path, monkeypatch):
    """Where the rebuild cannot fix the library (here a make that builds
    nothing), ``_load`` raises, naming the library, and caches the error:
    there is no quiet fallback to the Python ring."""
    from torchft_tpu_torch import coordination

    lib = _plant_static_runtime_engine(tmp_path / "bin")
    _point_the_port_at(monkeypatch, tmp_path / "bin")
    calls = []

    def make_nothing(argv, **kw):
        calls.append(argv)
        return subprocess.CompletedProcess(argv, 0, "", "")

    monkeypatch.setattr(coordination.subprocess, "run", make_nothing)
    with pytest.raises(RuntimeError, match=str(lib)):
        _native._load()
    (argv,) = calls
    assert "-B" in argv and argv[-1] == str(lib)
    assert not _native.is_available()
    with pytest.raises(RuntimeError, match="native collective engine unavailable"):
        ProcessGroupNative()


# -- core collectives --------------------------------------------------------


@pytest.mark.parametrize("world_size", [2, 3])
def test_allreduce_sum(store, world_size):
    groups = _make_group(store, world_size, prefix=f"nar{world_size}")
    inputs = [np.full((5, 3), float(r), np.float32) for r in range(world_size)]
    for r in _allreduce_all(groups, inputs, ReduceOp.SUM):
        np.testing.assert_allclose(r, sum(range(world_size)))


def test_allreduce_ops(store):
    groups = _make_group(store, 3, prefix="nops")

    def run(rank, op):
        arr = np.array([1.0, -2.0, 4.0], np.float32) * (rank + 1)
        return groups[rank].allreduce(arr, op).wait(timeout=30)[0]

    for op, expect in [
        (ReduceOp.AVG, np.array([2.0, -4.0, 8.0])),
        (ReduceOp.MAX, np.array([3.0, -2.0, 12.0])),
        (ReduceOp.MIN, np.array([1.0, -6.0, 4.0])),
    ]:
        for r in _run_parallel([lambda r=r, o=op: run(r, o) for r in range(3)]):
            np.testing.assert_allclose(r, expect, rtol=1e-6)
    for g in groups:
        g.shutdown()


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64"])
def test_allreduce_native_dtypes(store, dtype):
    groups = _make_group(store, 2, prefix=f"ndt_{dtype}")
    base = (np.arange(1000 + 7) % 97).astype(dtype)
    a, b = _allreduce_all(groups, [base * 1, base * 2], ReduceOp.SUM)
    np.testing.assert_array_equal(a, base * 3)
    np.testing.assert_array_equal(b, base * 3)


def _bf16(values):
    """The port's bfloat16 array of fp32 ``values`` (rounded to nearest
    even): the int16 carrier."""
    return _raw_dtypes.f32_to_bf16(np.asarray(values, np.float32)).view(_raw_dtypes.BF16)


def test_allreduce_fallback_dtype_rides_python_ring(store):
    """bf16 is outside the engine's set: the inherited socket ring carries
    it (the engine records no collective), reducing in fp32 per hop."""
    groups = _make_group(store, 2, prefix="nbf16")
    try:
        out = _allreduce_all(
            groups, [_bf16(np.full(16, float(r + 1))) for r in range(2)],
            ReduceOp.SUM, shutdown=False,
        )
        assert [g._engine.fr_seq() for g in groups] == [0, 0]
    finally:
        for g in groups:
            g.shutdown()
    for r in out:
        assert _raw_dtypes.wire_name(r.dtype) == "bfloat16"
        np.testing.assert_array_equal(_raw_dtypes.bf16_to_f32(r), 3.0)


def test_allgather_broadcast_barrier(store):
    groups = _make_group(store, 3, prefix="nagb")

    def run(rank):
        ragged = np.arange(4 + rank, dtype=np.float64) + rank
        gathered = groups[rank].allgather([ragged]).wait(timeout=30)
        token = np.full((2, 2), float(rank), np.float32)
        groups[rank].broadcast([token], root=1).wait(timeout=30)
        groups[rank].barrier().wait(timeout=30)
        return gathered, token

    for gathered, token in _run_parallel([lambda r=r: run(r) for r in range(3)]):
        for p in range(3):
            np.testing.assert_allclose(
                gathered[p][0], np.arange(4 + p, dtype=np.float64) + p
            )
        np.testing.assert_allclose(token, 1.0)  # root's payload
    for g in groups:
        g.shutdown()


def test_noncontiguous_input(store):
    groups = _make_group(store, 2, prefix="nnc")

    def run(rank):
        base = np.zeros((6, 8), np.float32)
        view = base[::2, ::2]  # non-contiguous view
        view[...] = rank + 1
        groups[rank].allreduce(view, ReduceOp.SUM).wait(timeout=30)
        return view.copy()

    for out in _run_parallel([lambda r=r: run(r) for r in range(2)]):
        np.testing.assert_allclose(out, 3.0)
    for g in groups:
        g.shutdown()


def test_world_size_one_noop():
    pg = ProcessGroupNative()
    pg.configure("unused:0/nsolo", 0, 1)
    out = pg.allreduce(np.full(4, 7.0, np.float32), ReduceOp.SUM).wait(timeout=5)
    np.testing.assert_allclose(out[0], 7.0)
    pg.shutdown()


# -- equivalence with the socket backend -------------------------------------


def test_socket_native_fp32_bitwise_equivalence(store):
    """Same inputs through both of the port's backends give BITWISE equal
    fp32 results: the C++ ring replicates the numpy ring's chunking and
    accumulation order."""
    ws = 3
    rng = np.random.default_rng(7)
    inputs = [rng.standard_normal(4096 + 13).astype(np.float32) for _ in range(ws)]
    native = _allreduce_all(_make_group(store, ws, prefix="eq_n"), inputs, ReduceOp.AVG)
    socket = _allreduce_all(
        _configure(store, [ProcessGroupSocket(timeout=10.0) for _ in range(ws)], "eq_s"),
        inputs, ReduceOp.AVG,
    )
    for s, n in zip(socket, native):
        np.testing.assert_array_equal(s, n)


# -- int8 wire codec ---------------------------------------------------------


def test_int8_wire_tolerance_and_byte_cut(store):
    """wire="int8": within quantization tolerance of the true mean, bitwise
    equal across ranks, and under half the fp32 path's wire bytes."""
    ws = 2
    n = 512 * 8 + 5
    rng = np.random.default_rng(3)
    inputs = [rng.standard_normal(n).astype(np.float32) for _ in range(ws)]

    def run_wire(prefix, wire):
        tx0 = byte_stats().get("pg_wire_tx", 0)
        out = _allreduce_all(
            _make_group(store, ws, prefix=prefix, wire=wire), inputs, ReduceOp.AVG
        )
        return out, byte_stats().get("pg_wire_tx", 0) - tx0

    q_out, q_tx = run_wire("w_q8", "int8")
    f_out, f_tx = run_wire("w_f32", "fp32")
    true_mean = (inputs[0] + inputs[1]) / ws
    np.testing.assert_allclose(q_out[0], true_mean, atol=0.1)
    np.testing.assert_array_equal(q_out[0], q_out[1])
    np.testing.assert_allclose(f_out[0], true_mean, rtol=1e-6)
    assert q_tx > 0 and f_tx > 0
    assert q_tx < f_tx / 2, f"int8 wire bytes {q_tx} not < half of {f_tx}"


# -- abort / reconfigure -----------------------------------------------------


def test_abort_unblocks_native_collective_and_reconfigures(store):
    """Rank 1 never joins; abort() must unblock rank 0's engine call
    promptly, latch errored(), and a reconfigure must recover fully."""
    groups = _make_group(store, 2, prefix="nab1", timeout=60.0)

    def stuck():
        work = groups[0].allreduce(np.ones(1 << 20, dtype=np.float32))
        with pytest.raises(Exception):
            work.wait(timeout=120)

    def aborter():
        time.sleep(0.5)
        groups[0].abort()

    t0 = time.monotonic()
    _run_parallel([stuck, aborter], timeout=120)
    assert time.monotonic() - t0 < 20, "abort did not unblock the collective"
    assert groups[0].errored() is not None

    def reconfigure(rank):
        groups[rank].configure(f"{store.address()}/nab2", rank, 2)
        arr = np.full(8, float(rank + 1), np.float32)
        groups[rank].allreduce(arr, ReduceOp.SUM).wait(timeout=30)
        return arr

    for out in _run_parallel([lambda r=r: reconfigure(r) for r in range(2)]):
        np.testing.assert_allclose(out, 3.0)
    assert groups[0].errored() is None
    for g in groups:
        g.shutdown()


def test_peer_failure_fails_native_collective_fast(store):
    """A peer that abandons a collective broadcasts its abort over the
    Python mesh; the survivor blocked in the C++ engine is poisoned through
    the cross-plane hook, not left to its timeout."""
    groups = _make_group(store, 2, prefix="nxp", timeout=60.0)
    t0 = time.monotonic()

    def survivor():
        work = groups[0].allreduce(np.ones(1 << 18, dtype=np.float32))
        with pytest.raises(Exception, match="abort|died"):
            work.wait(timeout=120)

    def failer():
        # Wrong arity fails locally before any engine traffic.
        work = groups[1].alltoall([np.ones(4, dtype=np.float32)])
        with pytest.raises(ValueError):
            work.wait(timeout=60)

    _run_parallel([survivor, failer], timeout=120)
    assert time.monotonic() - t0 < 20
    for g in groups:
        g.shutdown()


def test_abort_latches_error(store):
    groups = _make_group(store, 2, prefix="nlatch")
    groups[0].abort()
    assert groups[0].errored() is not None
    with pytest.raises(RuntimeError):
        groups[0].allreduce(np.ones(2, np.float32)).wait(timeout=5)
    for g in groups:
        g.shutdown()


# -- backend selection and wrappers ------------------------------------------


def test_make_process_group_env(monkeypatch):
    monkeypatch.delenv("TORCHFT_PG", raising=False)
    assert isinstance(make_process_group(), ProcessGroupSocket)
    assert not isinstance(make_process_group(), ProcessGroupNative)
    monkeypatch.setenv("TORCHFT_PG", "native")
    assert isinstance(make_process_group(), ProcessGroupNative)
    assert make_process_group().getBackendName() == "torchft-native"
    monkeypatch.setenv("TORCHFT_PG", "dummy")
    assert isinstance(make_process_group(), ProcessGroupDummy)
    monkeypatch.setenv("TORCHFT_PG", "nope")
    with pytest.raises(ValueError, match="nope"):
        make_process_group()


def test_wrapper_zoo_over_native(store):
    groups = _make_group(store, 2, prefix="nzoo")
    wrapped = [ErrorSwallowingProcessGroupWrapper(g) for g in groups]

    def run(rank):
        arr = np.full(4, float(rank + 1), np.float32)
        return wrapped[rank].allreduce(arr, ReduceOp.SUM).wait(timeout=30)[0]

    for out in _run_parallel([lambda r=r: run(r) for r in range(2)]):
        np.testing.assert_allclose(out, 3.0)
    # Post-error, collectives become no-ops until reconfigure.
    wrapped[0].report_error(RuntimeError("injected"))
    out = wrapped[0].allreduce(np.ones(2, np.float32)).wait(timeout=5)
    np.testing.assert_allclose(out[0], 1.0)
    fake = FakeProcessGroupWrapper(groups[0])
    fake.report_future_error(ValueError("boom"))
    with pytest.raises(ValueError, match="boom"):
        fake.allreduce(np.ones(1, np.float32)).wait(timeout=5)
    for g in groups:
        g.shutdown()


# -- the mixed world: a JAX and a port ProcessGroupNative --------------------

LAYOUTS = [("jax", "torch"), ("jax", "jax", "torch"), ("torch", "torch", "jax")]


def _mixed(store, packages, prefix, **kw):
    return _configure(
        store, [NATIVE[p](timeout=10.0, **kw) for p in packages], prefix
    )


@pytest.mark.parametrize("packages", LAYOUTS, ids="+".join)
def test_mixed_world_fp32_avg_equals_the_jax_world_bit_for_bit(store, packages):
    """fp32 AVG through the engine in a world of JAX and port ranks gives
    every rank the bits of a world of JAX ranks alone on the same inputs."""
    ws = len(packages)
    rng = np.random.default_rng(11)
    inputs = [rng.standard_normal(4096 + 13).astype(np.float32) for _ in range(ws)]
    mixed = _allreduce_all(_mixed(store, packages, "mx_f32"), inputs, ReduceOp.AVG)
    jax_only = _allreduce_all(
        _mixed(store, ("jax",) * ws, "mx_f32_j"), inputs, ReduceOp.AVG
    )
    for m in mixed:
        assert m.tobytes() == jax_only[0].tobytes()


def test_mixed_world_int8_wire_agrees_across_the_packages(store):
    """The engine's int8 wire: both packages decode the same bytes, which
    are the JAX-only world's, within the JAX test's tolerance of the mean."""
    n = 512 * 8 + 5
    rng = np.random.default_rng(3)
    inputs = [rng.standard_normal(n).astype(np.float32) for _ in range(2)]
    mixed = _allreduce_all(
        _mixed(store, ("jax", "torch"), "mx_q8", wire="int8"), inputs, ReduceOp.AVG
    )
    jax_only = _allreduce_all(
        _mixed(store, ("jax", "jax"), "mx_q8_j", wire="int8"), inputs, ReduceOp.AVG
    )
    assert mixed[0].tobytes() == mixed[1].tobytes() == jax_only[0].tobytes()
    np.testing.assert_allclose(mixed[0], (inputs[0] + inputs[1]) / 2, atol=0.1)


@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.AVG], ids=["sum", "avg"])
def test_mixed_world_bf16_rides_both_python_rings_to_the_same_bits(store, op):
    """A bf16 allreduce leaves the engine in both packages: the JAX rank
    reduces ml_dtypes bfloat16, the port rank its int16 carrier, each chunk
    under the header "bfloat16", and both end with the JAX-only world's
    bits (fp32 adds and divides, rounded to nearest even)."""
    rng = np.random.default_rng(5)
    values = [
        (rng.standard_normal(1000 + 3) * 4).astype(np.float32) for _ in range(2)
    ]
    jax_in = [v.astype(ml_dtypes.bfloat16) for v in values]
    groups = _mixed(store, ("jax", "torch"), "mx_bf16")
    try:
        mixed = _allreduce_all(
            groups, [jax_in[0], _bf16(values[1])], op, shutdown=False
        )
        # Neither engine ran a collective.
        assert [g._engine.fr_seq() for g in groups] == [0, 0]
    finally:
        for g in groups:
            g.shutdown()
    jax_only = _allreduce_all(_mixed(store, ("jax", "jax"), "mx_bf16_j"), jax_in, op)
    want = jax_only[0].view(np.int16).tobytes()
    assert str(mixed[0].dtype) == "bfloat16"
    assert _raw_dtypes.wire_name(mixed[1].dtype) == "bfloat16"
    assert mixed[0].view(np.int16).tobytes() == want
    assert mixed[1].view(np.int16).tobytes() == want


# -- OS-process kill + heal drill --------------------------------------------


@pytest.mark.timeout(240)
def test_native_kill_heal_drill(tmp_path):
    """The chaos drill with TORCHFT_PG=native over the port's demo trainer:
    three groups train over the engine, ``kill_one`` SIGKILLs one once
    group 1 has committed, the runner relaunches it, it heals, and all
    groups finish bitwise-equal. A quorum needs all three groups, so the
    survivors wait for the relaunch however long its start takes: the
    heal is forced at any step count."""
    import random

    from torchft_tpu_torch.coordination import LighthouseServer
    from torchft_tpu_torch.orchestration import ReplicaGroupRunner, render_topology
    from torchft_tpu_torch.orchestration.punisher import kill_one

    steps = 40
    lighthouse = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=3, join_timeout_ms=10000,
        quorum_tick_ms=50, heartbeat_timeout_ms=3000,
    )
    result_dir = str(tmp_path / "results")
    journal = tmp_path / "journal"
    runner = None
    try:
        specs = render_topology(
            [sys.executable, "-m", "torchft_tpu_torch.orchestration.demo_trainer",
             "--steps", str(steps), "--result-dir", result_dir,
             "--step-sleep", "0.03", "--min-replicas", "3", "--device", "cpu"],
            num_replica_groups=3,
            lighthouse_addr=lighthouse.address(),
            env={"TORCHFT_PG": "native", "OMP_NUM_THREADS": "1"},
            journal_dir=str(journal),
        )
        runner = ReplicaGroupRunner(specs, max_restarts=10, log_dir=str(tmp_path / "logs"))
        runner.start()
        deadline = time.monotonic() + 120
        while _journal_commits(journal, 1) < 5:
            assert time.monotonic() < deadline, "group 1 never committed"
            assert not sum(runner.restarts.values()), "a group died early"
            time.sleep(0.05)
        victim = kill_one(runner, rng=random.Random(0), spare_group_zero=True)
        assert victim is not None
        assert runner.run_until_done(timeout=180), (
            f"runner did not finish (restarts={runner.restarts})"
        )
        assert sum(runner.restarts.values()) == 1
    finally:
        if runner is not None:
            runner.stop()
        lighthouse.shutdown()
    results = {
        g: json.loads((tmp_path / "results" / f"group{g}.json").read_text())
        for g in range(3)
    }
    ws = [np.asarray(results[g]["w"], np.float32) for g in range(3)]
    for w in ws[1:]:
        assert w.tobytes() == ws[0].tobytes()
    assert [results[g]["final_step"] for g in range(3)] == [steps] * 3
    healed = [g for g in range(3) if results[g]["committed_this_life"] < steps]
    assert healed, f"no group shows heal evidence: {results}"
    backends = {
        json.loads(line)["attrs"]["backend"]
        for f in journal.glob("journal_replica*.jsonl")
        for line in f.read_text(errors="replace").splitlines()
        if '"pg_collective"' in line
    }
    assert backends == {"torchft-native"}
    # The kill is one recovery episode, the relaunched group its primary,
    # read the same by both packages' detectors.
    episode = kill_episode(str(journal), victim)
    events = telemetry.load_journal([str(journal)])
    assert telemetry.detect_episodes(events) == jtelemetry.detect_episodes(events)
    assert episode["root_cause"]["kind"] == "process_loss"


@pytest.mark.timeout(240)
def test_runner_drill_over_native_rehearses_the_card_phase(tmp_path, monkeypatch):
    """The CPU rehearsal of ``chip_smoke.py``'s orchestration phase with
    ``TORCHFT_PG=native``, four stripes a link and a seeded reset of
    stripe 1 in both groups' step 7: llama_debug under the runner, group 1
    killed through the lighthouse after step 3 and relaunched once, both
    groups ending at step 8 in the same bits, the gradient allreduce
    journaled by the engine's group, the kill one recovery episode with
    group 1 its primary, and ``drill.fault_planes``: the reset absorbed by
    a stripe handoff on both ends of a committed step, each group's goodput
    ledger tiling its wall (group 1 with down and heal seconds), and both
    groups' digests at the lighthouse."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the trainers inherit it
    out = runner_kill_heal_drill(
        ["--model", "debug", "--steps", "8", "--device", "cpu"],
        str(tmp_path / "results"), str(tmp_path / "logs"),
        env=FAULT_PLANES_ENV,
    )
    r0, r1 = out["results"][0], out["results"][1]
    assert out["restarts"] == {0: 0, 1: 1}
    assert [d["subject"] for d in out["proc_deaths"]] == ["replica1/rank0"]
    assert r0["final_step"] == r1["final_step"] == 8
    assert r0["param_sha256"] == r1["param_sha256"]
    events = telemetry.load_journal([out["journal_dir"]])
    rows = [e["attrs"] for e in events if e["event"] == "pg_collective"]
    assert {r["backend"] for r in rows} == {"torchft-native"}
    assert any(r["op"] == "allreduce" and r["ok"] for r in rows)
    # The engine's own records: its ring, not the Python fallback, carried
    # the gradient allreduce.
    assert any(
        e["event"] == "native_collective" and e["attrs"]["op"] == "allreduce"
        and e["attrs"]["status"] == "ok" for e in events
    )
    episode = kill_episode(out["journal_dir"], 1)
    assert episode["ttr_s"] > 0 and episode["max_step"] > 0
    planes = fault_planes(out)
    assert planes["failover_steps"] == [7]
    assert {f["stripe"] for rows in planes["failovers"].values() for f in rows} == {1}
    assert {row["incarnations"] for row in planes["goodput"].values()} == {1, 2}
    # Group 0 (one incarnation) through the JAX package's goodput tool.
    report = goodput_report.analyze(events)
    assert report["replicas"]["0"] == planes["goodput"]["0"]


@pytest.mark.timeout(240)
def test_every_rank_of_a_two_rank_group_runs_the_engine(tmp_path, monkeypatch):
    """``TORCHFT_PG=native`` reaches ``make_process_group`` in every rank of
    a group above one: two groups of two ``train_hsdp`` ranks, group 1
    killed and healed, each rank's replica-axis collectives journaled by
    the engine's group, and both groups ending in the same bits."""
    from torchft_tpu_torch.drill import kill_heal_drill

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    journal = tmp_path / "journal"
    results = kill_heal_drill(
        ["--model", "debug", "--steps", "8", "--device", "cpu"],
        str(tmp_path / "results"), str(tmp_path / "logs"), ranks_per_group=2,
        env={"TORCHFT_PG": "native", "TORCHFT_JOURNAL_DIR": str(journal)},
    )
    assert results[0]["final_step"] == results[1]["final_step"] == 8
    assert results[0]["param_sha256"] == results[1]["param_sha256"]
    backends = {}
    for f in journal.glob("journal_replica*_rank*.jsonl"):
        rank = f.name.split("_")[1] + "_" + f.name.split("_")[2]
        backends.setdefault(rank, set()).update(
            e["attrs"]["backend"] for e in telemetry.load_journal([str(f)])
            if e["event"] == "pg_collective"
        )
    assert sorted(backends) == [
        "replica0_rank0", "replica0_rank1", "replica1_rank0", "replica1_rank1"
    ]
    assert all(b == {"torchft-native"} for b in backends.values()), backends


# -- observability: journal agreement + snapshot safety ----------------------


def _journaled_run(package, backend, store, prefix, journal_path, monkeypatch):
    """An identical collective sequence on a 2-rank in-process group of one
    package's ``backend`` with its journal on; returns the pg_collective
    rows."""
    tel = telemetry if package == "torch" else jtelemetry
    cls = (NATIVE if backend == "native" else SOCKET)[package]
    monkeypatch.setenv("TORCHFT_JOURNAL_FILE", journal_path)
    tel.reset_event_log()
    groups = [cls(timeout=10.0) for _ in range(2)]
    try:
        _configure(store, groups, prefix)

        def run(rank):
            g = groups[rank]
            arr = np.arange(1024, dtype=np.float32) * (rank + 1)
            g.allreduce(arr, _op(g, ReduceOp.SUM)).wait(timeout=30)
            g.allgather([np.full(8, float(rank), np.float32)]).wait(timeout=30)
            g.broadcast([np.arange(16, dtype=np.float32)], root=0).wait(timeout=30)

        _run_parallel([lambda r=r: run(r) for r in range(2)])
    finally:
        for g in groups:
            g.shutdown()
        tel.reset_event_log()
    rows = [json.loads(line) for line in open(journal_path)]
    return [r for r in rows if r["event"] == "pg_collective"]


@pytest.mark.parametrize(
    "other", [("torch", "socket"), ("jax", "native")], ids=["port_socket", "jax_native"]
)
def test_native_journal_rows_agree(store, tmp_path, monkeypatch, other):
    """The port's native group journals the same (op, tag, nbytes, ok) rows
    as the port's socket group and as the JAX package's native group for
    the same collective sequence, so mixed fleets diff row for row."""
    per = {}
    for package, backend in (("torch", "native"), other):
        rows = _journaled_run(
            package, backend, store, f"jba_{package}_{backend}",
            str(tmp_path / f"{package}_{backend}.jsonl"), monkeypatch,
        )
        assert rows, f"{package} {backend}: no pg_collective events journaled"
        assert {r["attrs"]["backend"] for r in rows} == {f"torchft-{backend}"}
        per[(package, backend)] = sorted(
            (r["attrs"]["op"], r["attrs"]["tag"], r["attrs"]["nbytes"], r["attrs"]["ok"])
            for r in rows
        )
    assert per[("torch", "native")] == per[other]
    ops = [row[0] for row in per[("torch", "native")]]
    assert ops.count("allreduce") == ops.count("allgather") == ops.count("broadcast") == 2
    assert all(row[2] > 0 and row[3] for row in per[("torch", "native")])


def test_fr_snapshot_safe_during_inflight_allreduce(store):
    """fr_snapshot read continuously from another thread while allreduces
    are in flight never crashes, corrupts results or returns torn records."""
    groups = _make_group(store, 2, prefix="nfrsnap")
    stop = threading.Event()
    snaps, errs = [], []

    def sampler():
        engine = groups[0]._engine
        while not stop.is_set():
            try:
                snap = engine.fr_snapshot(0)
                for rec in snap["records"]:
                    assert rec["op"] in ("allreduce", "allgather", "broadcast", "barrier")
                    assert int(rec["bytes"]) >= 0
                snaps.append(len(snap["records"]))
            except Exception as e:  # noqa: BLE001 - collected for the assert
                errs.append(e)
                return

    t = threading.Thread(target=sampler)
    t.start()
    try:
        count = 256 * 1024
        for _ in range(8):

            def run(rank):
                arr = np.full(count, float(rank + 1), np.float32)
                out = groups[rank].allreduce(arr, ReduceOp.SUM).wait(timeout=30)[0]
                np.testing.assert_allclose(out[:8], 3.0)

            _run_parallel([lambda r=r: run(r) for r in range(2)])
        assert len(groups[0]._engine.fr_snapshot(0)["records"]) >= 8
    finally:
        stop.set()
        t.join(timeout=10)
        for g in groups:
            g.shutdown()
    assert not errs, f"snapshot raised concurrently: {errs[0]!r}"
    assert snaps and max(snaps) >= 1
