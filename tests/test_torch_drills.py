"""``python -m torchft_tpu_torch.drills``, the twin of ``tools/drills.py``:
its reports, flags and verdicts held to the JAX tool's, without running a
drill. The drills themselves run on the CPU in ``test_torch_drills_*.py``
(one or two a file, so that each file stays under a minute under
``--dist loadfile``); the helpers they share are here."""

from __future__ import annotations

import argparse
import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from unittest.mock import patch

import pytest

from torchft_tpu_torch import drills

REPO = Path(__file__).resolve().parent.parent
JAX_TOOL = REPO / "tools" / "drills.py"

DRILL_NAMES = (
    "soak", "elastic-up", "elastic-down", "drain", "preempt-all",
    "heal-storm", "spare-failover", "model-heal",
)


def _returned_dicts(fn: ast.FunctionDef) -> list:
    """The dict literals ``fn`` returns (the first element where it returns
    a tuple), not those of functions nested in it."""
    out = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Return) and child.value is not None:
                value = child.value
                if isinstance(value, ast.Tuple):
                    value = value.elts[0]
                if isinstance(value, ast.Dict):
                    out.append(value)
            visit(child)

    visit(fn)
    return out


def report_keys(path: Path) -> dict:
    """{drill: the keys of the report its ``drill_*`` function returns};
    the drain drill's two legs under ``"drain.leg"`` (its nested ``leg``)."""
    tree = ast.parse(path.read_text())
    keys = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("drill_")):
            continue
        name = fn.name[len("drill_"):].replace("_", "-")
        (ret,) = _returned_dicts(fn)
        keys[name] = sorted(k.value for k in ret.keys)
        for inner in ast.walk(fn):
            if isinstance(inner, ast.FunctionDef) and inner.name == "leg":
                (leg,) = _returned_dicts(inner)
                keys[f"{name}.leg"] = sorted(k.value for k in leg.keys)
    return keys


JAX_KEYS = report_keys(JAX_TOOL)


def assert_jax_keys(drill: str, report: dict) -> None:
    """A live report of the port's drill has the JAX drill's keys."""
    assert sorted(report) == JAX_KEYS[drill], (drill, sorted(report))
    if drill == "drain":
        for leg in ("graceful_drain", "sigkill_control"):
            assert sorted(report[leg]) == JAX_KEYS["drain.leg"]


def run_drill(argv, tmp_path) -> dict:
    """Runs the port's drill ``argv`` on the CPU, its directory under
    ``tmp_path``; holds the report to the JAX keys and to
    ``check_report`` (``drills.run``), and to its planted fault."""
    args = drills.parse_args([*argv, "--device", "cpu"])
    args.workdir = str(tmp_path / "drill")
    try:
        report = drills.run(args)
    except drills.DrillFailed as e:
        pytest.fail(f"{argv}: {e.reasons}\n{json.dumps(e.report)}")
    assert_jax_keys(args.drill, report)
    with pytest.raises(AssertionError):
        drills.check_report(args.drill, drills.planted(args.drill, report))
    return report


@pytest.fixture
def one_thread(monkeypatch):
    """One intra-op thread a trainer: the drills start two or three."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_report_keys_equal_the_jax_drills():
    port = report_keys(REPO / "torchft_tpu_torch" / "drills.py")
    assert sorted(JAX_KEYS) == sorted([*DRILL_NAMES, "drain.leg"])
    assert port == JAX_KEYS


def _jax_parser() -> argparse.ArgumentParser:
    """The parser ``tools/drills.py``'s main builds, taken as it parses."""
    spec = importlib.util.spec_from_file_location("jax_tools_drills", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = {}

    class Built(Exception):
        pass

    def grab(self, *a, **k):
        got["parser"] = self
        raise Built

    with patch.object(argparse.ArgumentParser, "parse_args", grab), \
            patch("os.chdir"), patch("signal.signal"):
        with pytest.raises(Built):
            mod.main()
    return got["parser"]


def _flags(parser: argparse.ArgumentParser) -> dict:
    """{subcommand: {dest: (option strings, default, type, choices,
    required)}}, help left out."""
    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    out = {}
    for name, sp in sub.choices.items():
        out[name] = {
            a.dest: (tuple(a.option_strings), a.default, a.type,
                     tuple(a.choices) if a.choices else None, a.required)
            for a in sp._actions if not isinstance(a, argparse._HelpAction)
        }
    return out


def test_subcommands_flags_and_defaults_equal_the_jax_tools():
    jax, port = _flags(_jax_parser()), _flags(drills.build_parser())
    assert sorted(jax) == sorted(DRILL_NAMES)
    for name, flags in port.items():
        device = flags.pop("device")
        assert device == (("--device",), "cuda", str, None, False)
    assert port == jax


# Reports the CPU runs of this port gave (``test_torch_drills_*.py``), each
# passing ``check_report``.
PASSING = {
    "soak": {"drill": "soak", "kills": 1, "clean_finish": True,
             "restarts": {"0": 0, "1": 1}, "final_steps": [40, 40],
             "bitwise_equal": True, "wall_s": 10.0, "journal_dir": "/j"},
    "elastic-up": {"drill": "elastic-up", "clean_finish": True,
                   "final_steps": [1000, 1000, 1000], "bitwise_equal_all3": True,
                   "joiner_heal_step": 267, "joined_mid_run": True,
                   "unpaced": True, "wall_s": 18.0},
    "drain": {"drill": "drain", **{leg: {
        "survivor_final_steps": [40, 40], "bitwise_equal_survivors": True,
        "victim_exit_clean": leg == "graceful_drain",
        "victim_drain_logged": leg == "graceful_drain",
        "survivor_stall_s": 0.28, "survivor_step_s_median": 0.26,
        "wall_s": 15.5} for leg in ("graceful_drain", "sigkill_control")}},
    "preempt-all": {"drill": "preempt-all:ddp", "via": "operator",
                    "drained_steps": [15, 15], "resumed_from_steps": [15, 15],
                    "final_steps": [30, 30], "bitwise_equal": True, "wall_s": 18.4},
    "elastic-down": {"drill": "elastic-down", "final_steps": [40, 40],
                     "bitwise_equal_survivors": True, "wall_s": 17.0},
    "heal-storm": {"drill": "heal-storm", "kills": 3,
                   "storm_kill_phases": ["reconfiguring pg", "healing from"],
                   "clean_finish": True, "restarts": {"0": 0, "1": 3},
                   "survivor_restarts": 0, "final_steps": [40, 40],
                   "bitwise_equal": True, "wall_s": 18.7},
    "spare-failover": {"drill": "spare-failover", "spare_group": 2,
                       "victim_group": 0, "clean_finish": True,
                       "restarts": {"0": 1, "1": 0, "2": 0},
                       "spare_promoted_no_heal": True,
                       "final_steps": [1000, 1000, 1000],
                       "bitwise_equal_all3": True, "wall_s": 18.5},
    "model-heal": {"drill": "model-heal:moe", "clean_finish": True,
                   "restarts": {"0": 0, "1": 1}, "final_steps": [12, 12],
                   "bitwise_equal": True, "wall_s": 9.5},
}


@pytest.mark.parametrize("drill", DRILL_NAMES)
def test_check_report_passes_a_good_report_and_refuses_its_planted_fault(drill):
    report = PASSING[drill]
    assert_jax_keys(drill, report)
    drills.check_report(drill, report)
    bad = drills.planted(drill, report)
    assert bad != report
    with pytest.raises(AssertionError, match=drill.split("-")[0] if drill != "drain" else "drain leg"):
        drills.check_report(drill, bad)


@pytest.mark.parametrize("drill, field, value, says", [
    ("soak", "clean_finish", False, "clean finish"),
    ("elastic-up", "joiner_heal_step", 1000, "not mid-run"),
    ("elastic-up", "bitwise_equal_all3", False, "diverged"),
    ("preempt-all", "resumed_from_steps", None, "resumed from None"),
    ("preempt-all", "bitwise_equal", False, "diverged"),
    ("heal-storm", "survivor_restarts", 1, "survivor restarted"),
    ("spare-failover", "spare_group", None, "no single spare"),
    ("model-heal", "clean_finish", False, "clean finish"),
])
def test_check_report_refuses_each_verdict(drill, field, value, says):
    bad = {**PASSING[drill], field: value}
    with pytest.raises(AssertionError, match=says):
        drills.check_report(drill, bad)


@pytest.mark.parametrize("leg, field, value, says", [
    ("graceful_drain", "victim_exit_clean", False, "did not exit 0"),
    ("graceful_drain", "victim_drain_logged", False, "drain markers"),
    ("sigkill_control", "survivor_stall_s", 4.88, "sigkill leg: survivor stall"),
    ("sigkill_control", "survivor_stall_s", None, "sigkill leg: survivor stall"),
    ("sigkill_control", "bitwise_equal_survivors", False, "sigkill leg: the survivors"),
])
def test_check_report_holds_both_drain_legs(leg, field, value, says):
    bad = json.loads(json.dumps(PASSING["drain"]))
    bad[leg][field] = value
    with pytest.raises(AssertionError, match=says):
        drills.check_report("drain", bad)


def test_the_spare_check_reads_its_post_kill_log():
    """The promotion must re-rank the spare into a quorum of FIXED with no
    heal after the kill; a heal line or a full-size quorum only fails."""
    promoted = "reconfiguring pg: quorum 4, rank 1/2\n"
    assert drills.promoted_no_heal(promoted)
    assert not drills.promoted_no_heal(promoted + "healing from replica_rank=0 at step 9")
    assert not drills.promoted_no_heal("reconfiguring pg: quorum 4, rank 1/3\n")
    assert drills.latest_rank("reconfiguring pg: quorum 1, rank 2/3\n"
                              "reconfiguring pg: quorum 2, rank 1/2\n") == (1, 2)


def test_stall_after_reads_the_survivors_largest_gap():
    times = [(i, 100.0 + 0.25 * i) for i in range(10)]
    times += [(10, 104.0), (11, 104.25)]  # a 1.75 s gap after the signal
    stall, median = drills.stall_after(times, t_signal=102.4)
    assert stall == pytest.approx(1.75)
    assert median == pytest.approx(0.25)


def test_device_cuda_raises_without_a_card():
    """No fallback: without a card, ``--device cuda`` (the default) raises
    before any process starts, and the CLI exits non-zero with no
    report."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drills.run(drills.parse_args(["soak", "--steps", "4"]))
    proc = subprocess.run(
        [sys.executable, "-m", "torchft_tpu_torch.drills", "soak", "--steps", "4"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""


def test_a_failed_drill_prints_its_report_and_exits_1(monkeypatch, capsys):
    """A drill that ran but failed still prints its report (the JAX keys),
    then its reasons on stderr, and exits 1."""
    report = {**PASSING["elastic-down"], "bitwise_equal_survivors": False}
    monkeypatch.setitem(drills.DRILLS, "elastic-down",
                        lambda args: (dict(report), ["group 2 never reached step 15"]))
    monkeypatch.setattr(drills, "require_device", lambda device: None)
    with patch("signal.signal"):
        assert drills.main(["elastic-down", "--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert json.loads(out) == report
    assert "never reached step 15" in err and "survivors diverged" in err
