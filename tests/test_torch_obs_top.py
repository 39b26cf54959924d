"""The port's fleet dashboard (``torchft_tpu_torch.obs_top``) held to the JAX
package's ``tools/obs_top.py``: each ``obs_top`` subject of
tests/test_observability.py, tests/test_goodput.py, tests/test_evidence.py
and tests/test_recovery.py through both tools: ``render`` with and without
color, ``check_frame`` on the frame and on its broken copies, and
``sort_worst_first``, compared as strings and lists; the cell helpers; and
``main --once --check`` over a live lighthouse fed by the port's client,
exit codes and ``CHECK FAIL`` lines on one fetched fleet."""

import os
import sys

import pytest

from torchft_tpu_torch import obs_top as ttop
from torchft_tpu_torch.coordination import LighthouseClient
from torchft_tpu_torch.telemetry import BADPUT_KINDS

from test_torch_fleet import _SEQ, _dg, lighthouse  # noqa: F401 - the fixture

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))

import obs_top as jtop  # noqa: E402
from test_goodput import _acct, _fleet_payload  # noqa: E402
from test_observability import (  # noqa: E402
    _composite_fleet,
    _fake_fleet,
    _synthetic_fleet,
)

pytestmark = pytest.mark.timeout(60)


def _world_churn():
    fleet = _fake_fleet()
    fleet["agg"].update(quorum_world=3, joins_total=6, leaves_total=5)
    return fleet


def _scoped(job):
    fleet = _fake_fleet()
    fleet["job"] = job
    return fleet


def _signal_fleet():
    return {
        "job": "default", "anomaly_seq": 0, "signal_seq": 2,
        "agg": {"n": 2, "n_digest": 2, "stragglers": 0, "quorum_world": 2,
                "joins_total": 0, "leaves_total": 0, "epoch": 1, "median_rate": 1.0,
                "median_step": 5, "anomalies_dropped": 0, "signals_dropped": 1},
        "replicas": {
            "r0": {"straggler": False, "flags": [], "digest": {"step": 5, "rate": 1.0, "gp": 1.0},
                   "last_hb_age_ms": 40, "signal": "proc_death", "signal_age_ms": 120},
            "r1": {"straggler": False, "flags": [], "digest": {"step": 5, "rate": 1.0, "gp": 1.0},
                   "last_hb_age_ms": 40},
        },
        "anomalies": [],
        "signals": [
            {"seq": 1, "source": "rpc_error", "replica_id": "r0", "site": "client:x",
             "ts_ms": 1},
            {"seq": 2, "source": "proc_death", "replica_id": "r0",
             "site": "lighthouse.leave", "ts_ms": 2},
        ],
    }


def _ttr_fleet():
    return {
        "replicas": {
            "r0": {"digest": {"step": 10, "rate": 1.0, "ph": {"h": [50.0, 70.0]}},
                   "flags": [], "last_hb_age_ms": 100},
            "r1": {"digest": {"step": 12, "rate": 1.1, "ph": {"h": [1.0, 4.2]}},
                   "flags": [], "last_hb_age_ms": 90},
        },
        "agg": {"n": 2, "n_digest": 2, "stragglers": 0, "median_step": 12},
    }


def _drop_lines(pred):
    return lambda frame: "\n".join(ln for ln in frame.splitlines() if not pred(ln))


def _replace(old, new):
    return lambda frame: frame.replace(old, new)


# name: (fleet, render/check keywords, broken copies of the frame). Each
# JAX test's fleet and the copies it breaks.
CASES = {
    "roundtrip": (_fake_fleet, {}, [_replace("STRAGGLER ", ""),
                                    _drop_lines(lambda ln: ln.startswith("b"))]),
    "world_churn": (_world_churn, {}, [_replace("world=3(+6/-5) ", "")]),
    "empty": (lambda: {"replicas": {}, "agg": {}, "anomalies": [], "anomaly_seq": 0}, {}, []),
    "top16_of_1024": (lambda: _synthetic_fleet(1024), {"top": 16},
                      [_replace("(+1008 more", "(+999 more"),
                       _drop_lines(lambda ln: ln.startswith("w0007"))]),
    "all_of_1024": (lambda: _synthetic_fleet(1024), {}, []),
    "rollups": (_composite_fleet, {}, [_drop_lines(lambda ln: "tenant-a" in ln),
                                       _drop_lines(lambda ln: ln.strip().startswith("d1"))]),
    "job_scoped": (lambda: _scoped("tenant-a"), {}, []),
    "job_default": (lambda: _scoped("default"), {}, []),
    "goodput": (_fleet_payload, {}, [_replace(" he ", " -- "),
                                     _replace("goodput=90.0%", "goodput=?"),
                                     _replace(" SLO_BURN", "")]),
    "signals": (_signal_fleet, {}, [_replace("proc_death", "-"),
                                    _replace("signals=2", "signals=0")]),
    "ttr_budget": (_ttr_fleet, {"top": 0, "ttr_budget_s": 60.0},
                   [_replace(" TTR_BUDGET", ""), _replace("70.0/60", "70.0")]),
    "ttr_budget_tight": (_ttr_fleet, {"ttr_budget_s": 3.0}, [_replace(" TTR_BUDGET", "")]),
}


@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_render_is_the_tools(name, color):
    make, kw, _ = CASES[name]
    frame = ttop.render(make(), color=color, **kw)
    assert frame == jtop.render(make(), color=color, **kw)
    assert (ttop.ANSI_RESET in frame) == color


@pytest.mark.parametrize("name", sorted(CASES))
def test_check_frame_is_the_tools(name):
    make, kw, breaks = CASES[name]
    fleet = make()
    frame = ttop.render(fleet, color=False, **kw)
    assert ttop.check_frame(fleet, frame, **kw) == jtop.check_frame(fleet, frame, **kw) == []
    for brk in breaks:
        broken = brk(frame)
        problems = ttop.check_frame(fleet, broken, **kw)
        assert problems and problems == jtop.check_frame(fleet, broken, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sort_worst_first_is_the_tools(name):
    make, _, _ = CASES[name]
    fleet = make()
    order = ttop.sort_worst_first(fleet.get("replicas") or {}, fleet.get("agg") or {})
    assert order == jtop.sort_worst_first(fleet.get("replicas") or {}, fleet.get("agg") or {})
    if name.endswith("of_1024"):
        assert order[:5] == ["w0007", "w0003", "w0011", "w0042", "w0099"]


DIGESTS = [
    {},
    {"acct": [1.0, 2.0]},
    {"acct": _acct(compute=8.0, down=2.0)},
    {"acct": _acct(compute=90.0, heal=10.0)},
    {"acct": _acct(compute=0.0)},
    {"acct": _acct(compute=5.0)},
    {"acct": [-1.0] * len(BADPUT_KINDS)},
    {"ph": {"q": [0.001, 0.0025], "h": [2.0, None], "c": [1], "a": "x"}},
    {"ph": {"h": [1.0, 4.25]}, "bw": {"0": 1.5, "2": 0.25, "x": "fast"}},
    {"bw": {}},
    {"bw": {"1": 3}},
]


@pytest.mark.parametrize("i", range(len(DIGESTS)))
def test_cell_helpers_are_the_tools(i):
    dg = DIGESTS[i]
    for fn in ("_acct_view", "_bw_summary", "_heal_s"):
        assert getattr(ttop, fn)(dg) == getattr(jtop, fn)(dg)
    for key in ("q", "h", "c", "a", "m"):
        assert ttop._phase_ms(dg, key) == jtop._phase_ms(dg, key)
    for v, fmt in ((None, "{:.2f}"), ("x", "{:.0f}"), (3, "{:.3f}"), ("2.5", "{:.1f}")):
        assert ttop._fmt(v, fmt) == jtop._fmt(v, fmt)


def test_glyphs_and_escapes_are_the_tools():
    assert ttop.BADPUT_GLYPHS == jtop.BADPUT_GLYPHS
    assert set(ttop.BADPUT_GLYPHS) == set(BADPUT_KINDS)
    for name in ("ANSI_HOME_CLEAR", "ANSI_BOLD", "ANSI_RED", "ANSI_YELLOW", "ANSI_RESET"):
        assert getattr(ttop, name) == getattr(jtop, name)


def _feed(addr):
    client = LighthouseClient(addr)
    for rid, dg in _SEQ:
        client.heartbeat(rid, digest=dg, hb_interval_ms=60000)
    client.heartbeat("ra", digest=_dg(11, 1.0), hb_interval_ms=60000,
                     signals=[{"source": "rpc_error", "replica_id": "rb", "site": "client:x"}])
    client.close()


def _main(module, argv, capsys):
    rc = module.main(argv)
    out = capsys.readouterr()
    return rc, out.out, [ln for ln in out.err.splitlines() if ln.startswith("CHECK FAIL:")]


@pytest.mark.parametrize("top", ["0", "1"])
def test_main_once_check_is_the_tools(lighthouse, monkeypatch, capsys, top):
    """``main --once --check`` over one fleet fetched from the live
    lighthouse: the same frame and exit 0; then with the frame's
    STRAGGLER tags dropped by ``render``, the same exit 1 and ``CHECK
    FAIL`` lines."""
    _feed(lighthouse.address())
    fleet = ttop.fetch_fleet(lighthouse.address())
    assert sorted(fleet["replicas"]) == ["ra", "rb"]
    argv = ["--lighthouse", lighthouse.address(), "--once", "--check", "--top", top]
    runs = []
    for module in (ttop, jtop):
        monkeypatch.setattr(module, "fetch_fleet", lambda *a, **k: fleet)
        good = _main(module, argv, capsys)
        render = module.render
        monkeypatch.setattr(module, "render",
                            lambda *a, **k: render(*a, **k).replace("STRAGGLER", "").replace(
                                "signals=", "sigs="))
        runs.append((good, _main(module, argv, capsys)))
    assert runs[0] == runs[1]
    (rc, frame, fails), (bad_rc, _, bad_fails) = runs[0]
    assert rc == 0 and not fails and frame.startswith("torchft fleet  replicas=2")
    assert bad_rc == 1 and any("signal count" in f for f in bad_fails)


def test_main_once_fetches_the_live_fleet_as_the_tool(lighthouse, capsys):
    """Unpatched: both tools fetch ``/fleet.json`` themselves and render the
    same rows (the heartbeat ages aside)."""
    _feed(lighthouse.address())
    frames = []
    for module in (ttop, jtop):
        rc, frame, fails = _main(module, ["--lighthouse", lighthouse.address(), "--once",
                                          "--check"], capsys)
        assert rc == 0 and not fails
        frames.append([ln.split()[:12] for ln in frame.splitlines()[1:4]])
    assert frames[0] == frames[1]


@pytest.mark.parametrize("argv", [[], ["--once"]])
def test_main_refuses_without_a_lighthouse_as_the_tool(monkeypatch, capsys, argv):
    monkeypatch.delenv("TORCHFT_LIGHTHOUSE", raising=False)
    errs = []
    for module in (ttop, jtop):
        with pytest.raises(SystemExit) as e:
            module.main(argv)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1]


def test_main_frames_until_max_frames_as_the_tool(lighthouse, monkeypatch, capsys):
    """The live loop without a terminal: ``--max-frames 2`` draws two frames
    without escapes and exits 0, as the JAX tool does."""
    _feed(lighthouse.address())
    fleet = ttop.fetch_fleet(lighthouse.address())
    outs = []
    for module in (ttop, jtop):
        monkeypatch.setattr(module, "fetch_fleet", lambda *a, **k: fleet)
        rc, out, _ = _main(module, ["--lighthouse", lighthouse.address(), "--max-frames", "2",
                                    "--interval", "0"], capsys)
        outs.append((rc, out))
    assert outs[0] == outs[1]
    assert outs[0][0] == 0 and outs[0][1].count("torchft fleet") == 2
    assert ttop.ANSI_HOME_CLEAR not in outs[0][1]
