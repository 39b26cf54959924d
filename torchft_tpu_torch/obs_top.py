"""obs_top: live terminal dashboard for the lighthouse fleet-health plane.

Polls the lighthouse's ``/fleet.json`` endpoint and redraws a compact
``top``-style table — one row per replica with its last committed step,
step rate, rolling goodput, phase p95s, native per-peer bandwidth,
heartbeat age, and any straggler/anomaly flags the lighthouse's online
detector has raised. Plain ANSI escapes only (cursor-home + clear), no
curses, so it works over ssh, in tmux panes, and under ``script``. The
port's twin of the JAX package's ``tools/obs_top.py``: the same frame,
checks, command line and exit codes, over the port's ``knobs`` and
``telemetry.BADPUT_KINDS``; it imports no torch and touches no device.

Usage::

    python -m torchft_tpu_torch.obs_top --lighthouse 127.0.0.1:29510
    python -m torchft_tpu_torch.obs_top --lighthouse 127.0.0.1:29510 --once
    python -m torchft_tpu_torch.obs_top --lighthouse 127.0.0.1:29510 --once --check

``--once`` renders a single frame to stdout and exits (no escapes).
``--check`` validates the rendered frame against the fetched JSON (every
replica rendered, stragglers marked, aggregate line consistent) and exits
non-zero on a mismatch — the fleet drill uses it as a render smoke.
``--top N`` keeps the dashboard usable on O(1000)-replica fleets: rows
sort worst-first (anomaly flags, then step lag behind the fleet median,
then slowest rate) and only the N worst render, with a footer counting
the healthy rows left out. ``--top 0`` (default) renders every replica
sorted by id, exactly as before.

Env: ``TORCHFT_LIGHTHOUSE`` is the default for ``--lighthouse``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional

from torchft_tpu_torch import knobs
from torchft_tpu_torch.telemetry import BADPUT_KINDS

# Two-letter glyph per badput kind for the WORST column ("compute" never
# renders there — it is the goodput numerator, not badput).
BADPUT_GLYPHS = {
    "init_compile": "ic",
    "compute": "ok",
    "exposed_comm": "xc",
    "quorum_wait": "qw",
    "heal": "he",
    "discarded_step": "ds",
    "replay_catchup": "rc",
    "straggler_idle": "si",
    "drain": "dr",
    "down": "dn",
}

ANSI_HOME_CLEAR = "\x1b[H\x1b[J"
ANSI_BOLD = "\x1b[1m"
ANSI_RED = "\x1b[31m"
ANSI_YELLOW = "\x1b[33m"
ANSI_RESET = "\x1b[0m"


def fetch_fleet(lighthouse: str, timeout: float = 5.0,
                job: str = "") -> Dict[str, Any]:
    """GET http://<lighthouse>/fleet.json and decode it. ``job`` scopes
    the payload to one namespace (``?job=<id>``); empty fetches the
    default job's composite view, which carries the per-job rollup
    summaries under ``jobs`` plus federation ``districts``."""
    url = f"http://{lighthouse}/fleet.json"
    if job:
        url += f"?job={urllib.parse.quote(job)}"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _fmt(v: Any, fmt: str = "{:.2f}", dash: str = "-") -> str:
    if v is None:
        return dash
    try:
        return fmt.format(float(v))
    except (TypeError, ValueError):
        return dash


def _phase_ms(digest: Dict[str, Any], key: str) -> Optional[float]:
    """p95 of one digest phase, in milliseconds."""
    ph = digest.get("ph") or {}
    pair = ph.get(key)
    if not isinstance(pair, list) or len(pair) < 2 or pair[1] is None:
        return None
    return float(pair[1]) * 1e3


def _heal_s(digest: Dict[str, Any]) -> Optional[float]:
    """Heal (recv_checkpoint) p95 seconds from the digest's phase spans;
    None when the replica has no heal activity in its digest window."""
    ph = digest.get("ph") or {}
    pair = ph.get("h")
    if not isinstance(pair, list) or len(pair) < 2 or pair[1] is None:
        return None
    return float(pair[1])


def _acct_view(digest: Dict[str, Any]) -> tuple:
    """``(ledger goodput %, worst-badput-kind glyph)`` from the digest's
    cumulative ``acct`` vector (positional by BADPUT_KINDS). ``(None,
    "-")`` for pre-taxonomy digests or before any accounted second."""
    acct = digest.get("acct")
    if not isinstance(acct, list) or len(acct) < len(BADPUT_KINDS):
        return None, "-"
    vals = [max(float(v), 0.0) for v in acct[: len(BADPUT_KINDS)]]
    total = sum(vals)
    if total <= 0:
        return None, "-"
    by = dict(zip(BADPUT_KINDS, vals))
    gp = by["compute"] / total * 100.0
    worst = max((k for k in BADPUT_KINDS if k != "compute"),
                key=lambda k: by[k])
    if by[worst] <= 0:
        return gp, "-"
    return gp, BADPUT_GLYPHS.get(worst, "??")


def _bw_summary(digest: Dict[str, Any]) -> str:
    """Worst per-peer GiB/s (the lane that bounds the allreduce)."""
    bw = digest.get("bw") or {}
    vals = [float(v) for v in bw.values()
            if isinstance(v, (int, float))]
    if not vals:
        return "-"
    return f"{min(vals):.2f}"


def sort_worst_first(replicas: Dict[str, Any],
                     agg: Dict[str, Any]) -> List[str]:
    """Replica ids ordered worst-first: most anomaly flags (a straggler
    counts as one), then largest step lag behind the fleet median, then
    slowest rate; id breaks ties so the order is deterministic."""
    med_step = agg.get("median_step")

    def key(rid: str):
        r = replicas[rid] or {}
        flags = r.get("flags") or []
        severity = len(flags) + (1 if r.get("straggler") else 0)
        dg = r.get("digest") or {}
        step = dg.get("step")
        lag = 0.0
        if med_step is not None and step is not None:
            lag = float(med_step) - float(step)
        rate = dg.get("rate")
        rate = float(rate) if rate is not None else float("inf")
        return (-severity, -lag, rate, str(rid))

    return sorted(replicas, key=key)


def render(fleet: Dict[str, Any], color: bool = False, top: int = 0,
           ttr_budget_s: float = 60.0) -> str:
    """One full frame of the dashboard as a string (no clear escape).
    ``top > 0``: worst-first order, truncated to ``top`` rows.
    ``ttr_budget_s``: replicas mid-heal render their heal p95 against this
    budget ("4.2/60") and earn a ``TTR_BUDGET`` tag when over it."""
    replicas = fleet.get("replicas") or {}
    agg = fleet.get("agg") or {}
    anomalies = fleet.get("anomalies") or []
    if top > 0:
        order = sort_worst_first(replicas, agg)[:top]
    else:
        order = sorted(replicas)
    hidden = len(replicas) - len(order)

    def paint(s: str, code: str) -> str:
        return f"{code}{s}{ANSI_RESET}" if color else s

    # Non-default namespaces tag the header so two side-by-side panes
    # watching different jobs are distinguishable at a glance.
    job = fleet.get("job") or "default"
    job_tag = f"job={job}  " if job != "default" else ""
    lines: List[str] = []
    lines.append(paint(
        f"torchft fleet  {job_tag}replicas={int(agg.get('n', 0))} "
        # WORLD: current quorum size plus cumulative join/leave churn —
        # the elastic-membership counters the lighthouse folds across
        # quorum transitions (deliberate resizes and crash churn alike).
        f"world={int(agg.get('quorum_world', 0))}"
        f"(+{int(agg.get('joins_total', 0))}"
        f"/-{int(agg.get('leaves_total', 0))}) "
        # EPOCH: the serving lighthouse's fencing epoch — a jump flags a
        # standby takeover; distinct values across scrapes of different
        # addresses would flag split-brain.
        f"epoch={int(agg.get('epoch', 0))} "
        f"digests={int(agg.get('n_digest', 0))} "
        f"stragglers={int(agg.get('stragglers', 0))} "
        f"median_rate={_fmt(agg.get('median_rate'), '{:.3f}')}/s "
        f"median_step={_fmt(agg.get('median_step'), '{:.0f}')} "
        f"anomalies={int(fleet.get('anomaly_seq', 0))}"
        + (f" dropped={int(agg.get('anomalies_dropped', 0))}"
           if agg.get("anomalies_dropped") else "")
        # SIGNALS: failure-evidence count since boot — the unified bus the
        # lighthouse reacts on; sig_dropped > 0 means the evidence ring
        # churned past a scrape and detection attribution has a hole.
        + f" signals={int(fleet.get('signal_seq', 0))}"
        + (f" sig_dropped={int(agg.get('signals_dropped', 0))}"
           if agg.get("signals_dropped") else "")
        # GOODPUT: the job's compute share of every accounted
        # replica-second (cumulative badput ledger), plus a loud marker
        # while the lighthouse's SLO burn-rate evaluator is tripped.
        + (f" goodput={float(agg['goodput_frac']) * 100:.1f}%"
           if agg.get("goodput_frac") is not None else "")
        + (" SLO_BURN" if agg.get("slo_burning") else "")
        + (f" showing={len(order)}/{len(replicas)}" if hidden > 0 else ""),
        ANSI_BOLD))
    header = (f"{'REPLICA':<20} {'STEP':>7} {'RATE/s':>7} {'GOOD%':>6} "
              f"{'LEDG%':>6} {'WORST':>5} "
              f"{'Q95ms':>7} {'H95ms':>7} {'C95ms':>7} {'A95ms':>7} "
              f"{'M95ms':>7} {'BWmin':>6} {'HB_ms':>7} {'HEAL':>9} "
              f"{'SIGNAL':>14}  FLAGS")
    lines.append(paint(header, ANSI_BOLD))
    for rid in order:
        r = replicas[rid]
        dg = r.get("digest") or {}
        flags = sorted(r.get("flags") or [])
        straggler = bool(r.get("straggler"))
        tag = " ".join(flags)
        if straggler:
            tag = ("STRAGGLER " + tag).strip()
        heal_s = _heal_s(dg)
        over_budget = heal_s is not None and heal_s > ttr_budget_s
        if over_budget:
            tag = (tag + " TTR_BUDGET").strip()
        heal_cell = ("-" if heal_s is None
                     else f"{heal_s:.1f}/{ttr_budget_s:.0f}")
        # SIGNAL: the most recent failure-evidence source naming this
        # replica as its subject (proc_death, hb_lapse, ...) — what the
        # evidence plane last learned about it, straight from the ring.
        signal_cell = str(r.get("signal") or "-")[:14]
        gp = dg.get("gp")
        # LEDG%/WORST: cumulative ledger goodput + the badput kind this
        # replica has lost the most seconds to (two-letter glyph).
        ledger_gp, worst_glyph = _acct_view(dg)
        row = (
            f"{str(rid)[:20]:<20} "
            f"{_fmt(dg.get('step'), '{:.0f}'):>7} "
            f"{_fmt(dg.get('rate'), '{:.3f}'):>7} "
            f"{_fmt(None if gp is None else float(gp) * 100, '{:.1f}'):>6} "
            f"{_fmt(ledger_gp, '{:.1f}'):>6} "
            f"{worst_glyph:>5} "
            f"{_fmt(_phase_ms(dg, 'q'), '{:.1f}'):>7} "
            f"{_fmt(_phase_ms(dg, 'h'), '{:.1f}'):>7} "
            f"{_fmt(_phase_ms(dg, 'c'), '{:.1f}'):>7} "
            f"{_fmt(_phase_ms(dg, 'a'), '{:.1f}'):>7} "
            f"{_fmt(_phase_ms(dg, 'm'), '{:.1f}'):>7} "
            f"{_bw_summary(dg):>6} "
            f"{_fmt(r.get('last_hb_age_ms'), '{:.0f}'):>7} "
            f"{heal_cell:>9} "
            f"{signal_cell:>14}  "
            f"{tag}"
        )
        if straggler or over_budget:
            row = paint(row, ANSI_RED)
        elif flags:
            row = paint(row, ANSI_YELLOW)
        lines.append(row)
    if not replicas:
        lines.append("  (no replicas heartbeating yet)")
    if hidden > 0:
        lines.append(f"  (+{hidden} more replicas below the --top cut)")
    # Namespace rollup: the composite payload (no ?job= filter) carries a
    # per-job summary map — one line per island so a multi-tenant operator
    # sees every job's quorum world and anomaly count without N fetches.
    jobs = fleet.get("jobs") or {}
    if jobs:
        lines.append("")
        lines.append(paint("jobs:", ANSI_BOLD))
        lines.append(paint(
            f"  {'JOB':<16} {'N':>5} {'WORLD':>6} {'STRAG':>6} "
            f"{'RATE/s':>8} {'ANOM':>6}", ANSI_BOLD))
        for jname in sorted(jobs):
            ja = jobs[jname] or {}
            row = (
                f"  {str(jname)[:16]:<16} {int(ja.get('n', 0)):>5} "
                f"{int(ja.get('quorum_world', 0)):>6} "
                f"{int(ja.get('stragglers', 0)):>6} "
                f"{_fmt(ja.get('median_rate'), '{:.3f}'):>8} "
                f"{int(ja.get('anomaly_seq', 0)):>6}"
            )
            if ja.get("stragglers"):
                row = paint(row, ANSI_YELLOW)
            lines.append(row)
    # Federation view (root lighthouse only): one line per reporting
    # district — LOST means no rollup within the heartbeat timeout, a
    # failover count > 0 means a standby took over that district's epoch.
    districts = fleet.get("districts") or {}
    if districts:
        lines.append("")
        lines.append(paint("districts:", ANSI_BOLD))
        for dname in sorted(districts):
            d = districts[dname] or {}
            lost = bool(d.get("lost"))
            row = (
                f"  {str(dname)[:16]:<16} "
                f"{'LOST' if lost else 'up':<5} "
                f"epoch={int(d.get('epoch', 0))} "
                f"age_ms={int(d.get('age_ms', 0))} "
                f"failovers={int(d.get('failovers', 0))} "
                f"stale_dropped={int(d.get('stale_dropped', 0))} "
                f"jobs={len(d.get('jobs') or {})}"
            )
            if lost:
                row = paint(row, ANSI_RED)
            lines.append(row)
    if anomalies:
        lines.append("")
        lines.append(paint("recent anomalies:", ANSI_BOLD))
        for rec in anomalies[-8:]:
            lines.append(
                f"  #{rec.get('seq')} {rec.get('kind')} "
                f"replica={rec.get('replica_id')} "
                f"detail={json.dumps(rec.get('detail'))}"
            )
    # Failure-evidence tail: newest entries of the lighthouse signal ring,
    # with the observation site — where in the system the evidence came
    # from (runner.monitor vs lighthouse.leave vs a manager's hb loop).
    signals = fleet.get("signals") or []
    if signals:
        lines.append("")
        lines.append(paint("recent signals:", ANSI_BOLD))
        for rec in signals[-8:]:
            lines.append(
                f"  #{rec.get('seq')} {rec.get('source')} "
                f"subject={rec.get('replica_id')} "
                f"site={rec.get('site')}"
            )
    return "\n".join(lines) + "\n"


def check_frame(fleet: Dict[str, Any], frame: str,
                top: int = 0, ttr_budget_s: float = 60.0) -> List[str]:
    """Cross-checks a rendered frame against the JSON it came from.
    Returns a list of problems (empty = pass). With ``top > 0`` only the
    worst-first prefix must render (each with its tags), the truncation
    footer must count the rest, and the worst offenders — every flagged
    replica that fits in ``top`` rows — must not be cut. Replicas whose
    digest heal p95 exceeds ``ttr_budget_s`` must carry a TTR_BUDGET tag
    and render their heal cell."""
    problems: List[str] = []
    replicas = fleet.get("replicas") or {}
    agg = fleet.get("agg") or {}
    if top > 0:
        expected = sort_worst_first(replicas, agg)[:top]
        hidden = len(replicas) - len(expected)
        if hidden > 0 and f"(+{hidden} more replicas" not in frame:
            problems.append(
                f"{hidden} replicas were cut but no truncation footer")
    else:
        expected = list(replicas)
    frame_lines = frame.splitlines()
    for rid in expected:
        shown = str(rid)[:20]
        if not any(ln.startswith(shown) for ln in frame_lines):
            problems.append(f"replica {rid!r} missing from rendered frame")
            continue
        if replicas[rid].get("straggler"):
            row = next(ln for ln in frame_lines if ln.startswith(shown))
            if "STRAGGLER" not in row:
                problems.append(
                    f"replica {rid!r} is a straggler but its row has no "
                    f"STRAGGLER tag")
        for kind in replicas[rid].get("flags") or []:
            row = next(ln for ln in frame_lines if ln.startswith(shown))
            if kind not in row:
                problems.append(
                    f"replica {rid!r} flag {kind!r} not rendered")
        heal_s = _heal_s(replicas[rid].get("digest") or {})
        if heal_s is not None and heal_s > ttr_budget_s:
            row = next(ln for ln in frame_lines if ln.startswith(shown))
            if "TTR_BUDGET" not in row:
                problems.append(
                    f"replica {rid!r} heal p95 {heal_s:.1f}s exceeds the "
                    f"{ttr_budget_s:.0f}s TTR budget but has no "
                    f"TTR_BUDGET tag")
            if f"{heal_s:.1f}/" not in row:
                problems.append(
                    f"replica {rid!r} heal cell not rendered")
        sig = replicas[rid].get("signal")
        if sig:
            row = next(ln for ln in frame_lines if ln.startswith(shown))
            if str(sig)[:14] not in row:
                problems.append(
                    f"replica {rid!r} failure-evidence signal {sig!r} "
                    f"not rendered in its SIGNAL column")
        # Time-accounting columns: a digest that carries the cumulative
        # acct vector must render its ledger goodput cell and the
        # worst-badput-kind glyph; pre-taxonomy digests render dashes.
        ledger_gp, worst_glyph = _acct_view(replicas[rid].get("digest") or {})
        if ledger_gp is not None:
            row = next(ln for ln in frame_lines if ln.startswith(shown))
            if f"{ledger_gp:.1f}" not in row:
                problems.append(
                    f"replica {rid!r} ledger goodput cell not rendered")
            if worst_glyph != "-" and f" {worst_glyph} " not in row:
                problems.append(
                    f"replica {rid!r} worst-badput glyph {worst_glyph!r} "
                    f"not rendered")
    head = frame_lines[0] if frame_lines else ""
    if f"replicas={int(agg.get('n', 0))}" not in head:
        problems.append("aggregate replica count missing from header")
    if f"stragglers={int(agg.get('stragglers', 0))}" not in head:
        problems.append("aggregate straggler count missing from header")
    world = (
        f"world={int(agg.get('quorum_world', 0))}"
        f"(+{int(agg.get('joins_total', 0))}"
        f"/-{int(agg.get('leaves_total', 0))})"
    )
    if world not in head:
        problems.append("WORLD (quorum size + join/leave churn) missing "
                        "from header")
    if f"signals={int(fleet.get('signal_seq', 0))}" not in head:
        problems.append("failure-evidence signal count missing from header")
    if agg.get("goodput_frac") is not None:
        if f"goodput={float(agg['goodput_frac']) * 100:.1f}%" not in head:
            problems.append("job goodput fraction missing from header")
    if agg.get("slo_burning") and "SLO_BURN" not in head:
        problems.append("SLO burn state missing from header")
    for rec in (fleet.get("signals") or [])[-8:]:
        want = f"#{rec.get('seq')} {rec.get('source')}"
        if not any(want in ln for ln in frame_lines):
            problems.append(
                f"signal seq {rec.get('seq')} "
                f"({rec.get('source')!r}) missing from the recent-signals "
                f"tail")
    # Namespace rollup: every job island in the composite payload must
    # render its summary line (n + world), and every district its
    # up/LOST row — federation health must never be silently dropped.
    for jname, ja in (fleet.get("jobs") or {}).items():
        ja = ja or {}
        want = f"{str(jname)[:16]:<16} {int(ja.get('n', 0)):>5}"
        if not any(want in ln for ln in frame_lines):
            problems.append(f"job {jname!r} rollup row missing from frame")
    for dname, d in (fleet.get("districts") or {}).items():
        state = "LOST" if (d or {}).get("lost") else "up"
        if not any(str(dname)[:16] in ln and state in ln
                   for ln in frame_lines):
            problems.append(
                f"district {dname!r} ({state}) row missing from frame")
    return problems


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lighthouse",
                   default=knobs.get_str("TORCHFT_LIGHTHOUSE"),
                   help="lighthouse host:port (default: $TORCHFT_LIGHTHOUSE)")
    p.add_argument("--interval", type=float, default=1.0,
                   help="refresh interval seconds (default 1)")
    p.add_argument("--once", action="store_true",
                   help="render one frame to stdout and exit")
    p.add_argument("--check", action="store_true",
                   help="with --once: validate the frame against the JSON "
                        "and exit non-zero on mismatch")
    p.add_argument("--max-frames", type=int, default=0,
                   help="exit after N frames (0 = run until interrupted)")
    p.add_argument("--top", type=int, default=0,
                   help="show only the N worst replicas (flags, then step "
                        "lag, then rate); 0 = all, sorted by id")
    p.add_argument("--ttr-budget", type=float,
                   default=knobs.get_float("TORCHFT_TTR_BUDGET_S"),
                   help="flag replicas whose heal p95 exceeds this many "
                        "seconds (default: $TORCHFT_TTR_BUDGET_S)")
    p.add_argument("--job", default="",
                   help="scope the dashboard to one job namespace "
                        "(?job=<id>); empty shows the default job plus "
                        "the cross-job and district rollups")
    args = p.parse_args(argv)
    if not args.lighthouse:
        p.error("--lighthouse / $TORCHFT_LIGHTHOUSE is required")

    if args.once:
        fleet = fetch_fleet(args.lighthouse, job=args.job)
        frame = render(fleet, color=False, top=args.top,
                       ttr_budget_s=args.ttr_budget)
        sys.stdout.write(frame)
        if args.check:
            problems = check_frame(fleet, frame, top=args.top,
                                   ttr_budget_s=args.ttr_budget)
            for prob in problems:
                print(f"CHECK FAIL: {prob}", file=sys.stderr)
            return 1 if problems else 0
        return 0

    color = sys.stdout.isatty()
    frames = 0
    try:
        while True:
            try:
                fleet = fetch_fleet(args.lighthouse, job=args.job)
                frame = render(fleet, color=color, top=args.top,
                               ttr_budget_s=args.ttr_budget)
            except Exception as e:  # noqa: BLE001 - keep polling
                frame = f"fleet poll failed: {e}\n"
            sys.stdout.write((ANSI_HOME_CLEAR if color else "") + frame)
            sys.stdout.flush()
            frames += 1
            if args.max_frames and frames >= args.max_frames:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
