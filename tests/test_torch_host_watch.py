"""``chip_smoke.py``'s host watch, phase 20's ``hb_lapse`` reading and
phase 20a's Manager scenarios, rehearsed on the CPU.

The watch reads this machine's ``/proc`` (and says so where
``/proc/pressure`` is absent, without failing); a planted late wake-up, on
a fake clock, must be flagged and carry the host's state and the phases
running. Phase 20a runs at llama_debug's shapes on CPU tensors, its int4
allreduce down the device path's plain versions
(``TORCHFT_FORCE_DEVICE_QUANT``)."""

import time
from pathlib import Path

import pytest

import chip_smoke
from torchft_tpu_torch.coordination import LighthouseClient, LighthouseServer


def test_read_host_reads_this_machines_proc(capsys):
    host = chip_smoke.read_host()
    assert len(host["loadavg"]) == 4
    assert "MemAvailable" in host["meminfo"]
    has_psi = Path("/proc/pressure").is_dir()
    assert (host["pressure"] is not None) == has_psi
    if has_psi:
        assert set(host["pressure"]) <= set(chip_smoke.PRESSURE_KINDS)
        for kind in host["pressure"].values():
            assert "avg10" in kind["some"] and "total" in kind["some"]
    watch = chip_smoke.HostWatch(period=0.01)
    watch.tick()
    line = watch.summary()
    assert ("/proc/pressure present" in line) == has_psi
    assert ("/proc/pressure absent" in line) == (not has_psi)
    print(f"this machine: /proc/pressure {'present' if has_psi else 'absent'}")


def test_read_host_without_pressure_says_so(tmp_path):
    """A /proc with no pressure directory (as on a kernel without PSI)
    reads as ``pressure`` None, and the watch's line says absent."""
    proc = tmp_path / "proc"
    (proc / "self").mkdir(parents=True)
    (proc / "loadavg").write_text("1.00 0.50 0.25 2/100 42\n")
    (proc / "meminfo").write_text("MemTotal: 100 kB\nMemAvailable: 60 kB\nDirty: 3 kB\n")
    host = chip_smoke.read_host(proc)
    own = host.pop("self")
    assert host == {"loadavg": ["1.00", "0.50", "0.25", "2/100"], "pressure": None,
                    "meminfo": {"MemAvailable": 60, "Dirty": 3}}
    assert set(own) == {"cpu_s"} and own["cpu_s"] >= 0
    watch = chip_smoke.HostWatch(read=lambda: chip_smoke.read_host(proc))
    watch.readings.append((0.0, watch.reading()))
    assert "/proc/pressure absent" in watch.summary()


class FakeClock:
    """A monotonic clock that a sleep advances, late by ``extra`` seconds
    on the sleeps listed."""

    def __init__(self, extra: dict) -> None:
        self.now, self.sleeps, self.extra = 100.0, 0, extra

    def clock(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.now += s + self.extra.get(self.sleeps, 0.0)
        self.sleeps += 1

    def wall(self) -> float:
        return 1_000_000.0 + self.now


def test_a_planted_late_wake_up_is_flagged(monkeypatch):
    fake = FakeClock({3: 2.0, 7: 0.7})
    reads = []

    def read():
        reads.append(fake.now)
        return {"meminfo": {"MemAvailable": 1}}

    monkeypatch.setattr(chip_smoke, "RUNNING", {"lane_0": "path", "MainThread": "baby"})
    watch = chip_smoke.HostWatch(clock=fake.clock, sleep=fake.sleep, wall=fake.wall, read=read)
    lates = [watch.tick() for _ in range(10)]
    assert lates[3] == pytest.approx(2.0) and lates[7] == pytest.approx(0.7)
    assert sum(1 for x in lates if x > 1e-9) == 2
    assert watch.stalls() == 2
    assert watch.stalls(chip_smoke.EVIDENCE_BUDGET_S) == 1
    worst = watch.worst(5)
    assert worst[0]["late_s"] == pytest.approx(2.0)
    assert worst[1]["late_s"] == pytest.approx(0.7)
    assert worst[0]["phases"] == ["baby", "path"]
    # The stall forces a reading right after it, which the worst carries.
    assert worst[0]["host"] == {"meminfo": {"MemAvailable": 1}}
    stall_wall = worst[0]["at"]
    assert any(abs(ts - stall_wall) < 1e-6 for ts, _ in watch.readings)
    assert watch.phases_at(stall_wall) == ("baby", "path")
    line = watch.summary()
    assert "2 late by >= 0.5 s, 1 by >= 1.2 s" in line
    # A clean watch flags nothing.
    clean = chip_smoke.HostWatch(clock=FakeClock({}).clock, sleep=FakeClock({}).sleep,
                                 read=read)
    assert clean.stalls() == 0


def test_hb_lapses_print_beside_the_watch(capsys, monkeypatch):
    """Phase 20's reading: a replica that declared a 100 ms heartbeat and
    went quiet for 1.5 s has an ``hb_lapse`` record (gap over the 1.2 s
    budget) in the lighthouse's signal ring; ``hb_lapses`` returns it and
    prints it with the watch's state and phases at that moment."""
    watch = chip_smoke.HostWatch(period=0.01)
    monkeypatch.setattr(chip_smoke, "HOST_WATCH", watch)
    monkeypatch.setattr(chip_smoke, "RUNNING", {"MainThread": "baby"})
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, heartbeat_timeout_ms=30000)
    client = LighthouseClient(lh.address())
    try:
        for _ in range(5):
            client.heartbeat("lapser", hb_interval_ms=100)
            time.sleep(0.1)
        t_end = time.monotonic() + 1.6
        while time.monotonic() < t_end:
            watch.tick()
        lapses = chip_smoke.hb_lapses(lh, "test")
    finally:
        client.close()
        lh.shutdown()
    assert [s["replica_id"] for s in lapses] == ["lapser"]
    detail = lapses[0]["detail"]
    assert detail["budget_ms"] == 1200 and detail["gap_ms"] > 1200
    printed = capsys.readouterr().out
    assert "test lighthouse hb_lapse on lapser" in printed
    assert "phases ['baby']" in printed and "MemAvailable" in printed


@pytest.mark.timeout(240)
def test_manager_scenarios_rehearse_on_the_cpu(monkeypatch, tmp_path):
    """Phase 20a's five scenarios and both planted faults at llama_debug's
    shapes on the CPU (an int4 leaf of 200,001 values)."""
    monkeypatch.setenv("TORCHFT_FORCE_DEVICE_QUANT", "1")
    monkeypatch.setattr(chip_smoke, "OUT", tmp_path)
    out = chip_smoke.manager_scenarios_phase("cpu", "debug", q4_n=200_001)
    sc = out["scenarios"]
    assert list(sc) == ["crash", "three", "drain", "outage", "int4"]
    params = out["state_bytes"]
    assert sc["crash"]["heal_bytes"] == [[], [params]]
    assert sc["crash"]["planted_fault_caught"]
    assert sc["three"]["heal_bytes"][2] == [params] and sc["three"]["heal_bytes"][1] == [params]
    assert sc["outage"]["commits"] == [2, 2] and all(f > 0 for f in sc["outage"]["failed"])
    assert sc["drain"]["alone_commits"] >= 1
    assert sc["int4"]["int8_reference_differs_in"] > 0
    assert (tmp_path / "manager_scenarios.json").exists()
