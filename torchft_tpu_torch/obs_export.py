"""Control-plane exporter: polls the lighthouse ``status`` RPC and turns it
into (a) journal events in the same JSONL stream the trainers write and
(b) a Prometheus-style text exposition served over a stdlib HTTP endpoint.
The port's twin of the JAX package's ``tools/obs_export.py``: the same
gauges, journal events, command line and exit codes.

The C++ lighthouse already serves its own ``/metrics``; this exporter adds
the pieces monitoring actually wants but a single C++ process can't give:
the status sampled into the *event journal* (so
``python -m torchft_tpu_torch.obs_report`` timelines include control-plane
state between steps), derived gauges (max heartbeat age, member-step
spread) computed Python-side, the fleet table's straggler, goodput and
anomaly gauges, and the native engine's per-peer counters read off the
trainers' journals.

It builds on the port's own ``coordination.LighthouseClient``,
``telemetry.EventLog``, ``telemetry.BADPUT_KINDS``, ``knobs`` and
``telemetry.load_journal``; it imports no torch and touches no device.

Usage::

    python -m torchft_tpu_torch.obs_export --lighthouse 127.0.0.1:29510 \
        --journal-file /tmp/journal/exporter.jsonl --port 9109

    python -m torchft_tpu_torch.obs_export --lighthouse 127.0.0.1:29510 --once

    python -m torchft_tpu_torch.obs_export --once --journal /tmp/journal

Env: ``TORCHFT_LIGHTHOUSE`` is the default for ``--lighthouse``.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from torchft_tpu_torch import knobs, telemetry
from torchft_tpu_torch.coordination import LighthouseClient
from torchft_tpu_torch.telemetry import BADPUT_KINDS, EventLog


def scrape(client: LighthouseClient, timeout: float = 5.0) -> Dict[str, Any]:
    """One status scrape, flattened into the fields the exporter serves."""
    s = client.status(timeout=timeout)
    hb = s.get("heartbeat_ages_ms", {}) or {}
    prev = s.get("prev_quorum") or {}
    members = prev.get("participants", []) or []
    steps = [int(m.get("step", 0)) for m in members]
    return {
        "quorum_id": int(s.get("quorum_id", 0)),
        "quorum_generation": int(s.get("quorum_generation", 0)),
        "joins_total": int(s.get("joins_total", 0)),
        "leaves_total": int(s.get("leaves_total", 0)),
        "participants_waiting": len(s.get("participants", []) or []),
        "quorum_members": len(members),
        "heartbeat_ages_ms": {k: int(v) for k, v in hb.items()},
        "heartbeat_age_max_ms": max(hb.values()) if hb else 0,
        "member_steps": {
            str(m.get("replica_id", "")): int(m.get("step", 0))
            for m in members
        },
        "step_spread": (max(steps) - min(steps)) if steps else 0,
        "left": list(s.get("left", []) or []),
        "reason": s.get("reason", ""),
    }


def render_prometheus(sample: Dict[str, Any]) -> str:
    """Prometheus text exposition for one scrape sample."""
    lines = []

    def gauge(name: str, value: Any, help_: str, labels: str = "") -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{labels} {value}")

    gauge("torchft_exporter_quorum_id", sample["quorum_id"],
          "Current quorum id.")
    gauge("torchft_exporter_quorum_generation", sample["quorum_generation"],
          "Quorum broadcasts since lighthouse boot.")
    gauge("torchft_exporter_joins_total", sample["joins_total"],
          "Members added across quorum transitions.")
    gauge("torchft_exporter_leaves_total", sample["leaves_total"],
          "Members gone across quorum transitions.")
    gauge("torchft_exporter_participants_waiting",
          sample["participants_waiting"],
          "Replicas waiting in the next quorum round.")
    gauge("torchft_exporter_quorum_members", sample["quorum_members"],
          "Members of the last delivered quorum.")
    gauge("torchft_exporter_heartbeat_age_max_ms",
          sample["heartbeat_age_max_ms"],
          "Max milliseconds since any replica's last heartbeat.")
    gauge("torchft_exporter_member_step_spread", sample["step_spread"],
          "Max minus min training step across quorum members.")
    lines.append("# HELP torchft_exporter_heartbeat_age_ms Milliseconds "
                 "since each replica's last heartbeat.")
    lines.append("# TYPE torchft_exporter_heartbeat_age_ms gauge")
    for rid, age in sorted(sample["heartbeat_ages_ms"].items()):
        esc = rid.replace("\\", "\\\\").replace('"', '\\"')
        lines.append(
            f'torchft_exporter_heartbeat_age_ms{{replica="{esc}"}} {age}'
        )
    lines.append("# HELP torchft_exporter_member_step Training step each "
                 "quorum member reported.")
    lines.append("# TYPE torchft_exporter_member_step gauge")
    for rid, step in sorted(sample["member_steps"].items()):
        esc = rid.replace("\\", "\\\\").replace('"', '\\"')
        lines.append(f'torchft_exporter_member_step{{replica="{esc}"}} {step}')
    return "\n".join(lines) + "\n"


def scrape_fleet(client: LighthouseClient,
                 timeout: float = 5.0) -> Optional[Dict[str, Any]]:
    """One ``fleet`` scrape (live health table). Returns ``None`` against an
    old lighthouse that predates the RPC instead of failing the whole poll."""
    try:
        return client.fleet(timeout=timeout)
    except Exception:  # noqa: BLE001 - fleet plane is additive
        return None


def render_fleet_prometheus(fleet: Dict[str, Any],
                            max_replicas: Optional[int] = None) -> str:
    """Prometheus gauges from the lighthouse's live fleet table: per-replica
    straggler/step-rate/goodput plus fleet-wide aggregates and the anomaly
    counter monitoring should alert on.

    Label-cardinality bound: above ``max_replicas`` fleet rows (default
    ``TORCHFT_EXPORT_MAX_REPLICAS``, shared with the lighthouse's own
    /metrics), per-replica series are emitted only for anomalous/straggler
    replicas — a 1024-replica fleet scrapes as aggregates plus the rows a
    pager rule would actually fire on, with a suppressed-count gauge naming
    what was collapsed.

    Every fleet series carries a ``job`` label (the payload's namespace);
    a composite payload additionally yields per-job rollup gauges — bounded
    by ``TORCHFT_EXPORT_MAX_JOBS`` the same way replicas are — plus one
    ``torchft_exporter_district_*`` series set per reporting district."""
    if max_replicas is None:
        max_replicas = knobs.get_int("TORCHFT_EXPORT_MAX_REPLICAS")
    lines = []

    def header(name: str, help_: str) -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} gauge")

    def esc(s: Any) -> str:
        return str(s).replace("\\", "\\\\").replace('"', '\\"')

    job = fleet.get("job") or "default"
    jl = f'job="{esc(job)}"'
    agg = fleet.get("agg") or {}
    all_replicas = fleet.get("replicas") or {}
    capped = len(all_replicas) > max_replicas
    if capped:
        replicas = {
            rid: r for rid, r in all_replicas.items()
            if r.get("straggler") or r.get("flags")
        }
    else:
        replicas = all_replicas
    header("torchft_exporter_fleet_replicas",
           "Replicas in the lighthouse fleet table.")
    lines.append(f"torchft_exporter_fleet_replicas{{{jl}}} "
                 f"{int(agg.get('n', 0))}")
    header("torchft_exporter_fleet_stragglers",
           "Replicas currently flagged as stragglers.")
    lines.append(f"torchft_exporter_fleet_stragglers{{{jl}}} "
                 f"{int(agg.get('stragglers', 0))}")
    header("torchft_exporter_fleet_anomalies_total",
           "Anomalies detected since lighthouse boot (rise edges).")
    lines.append(f"torchft_exporter_fleet_anomalies_total{{{jl}}} "
                 f"{int(fleet.get('anomaly_seq', 0))}")
    header("torchft_exporter_fleet_anomalies_dropped",
           "Anomaly records evicted from the lighthouse ring "
           "(feed incomplete when > 0).")
    lines.append(f"torchft_exporter_fleet_anomalies_dropped{{{jl}}} "
                 f"{int(agg.get('anomalies_dropped', 0))}")
    header("torchft_exporter_fleet_signals_total",
           "Failure-evidence signals ingested since lighthouse boot.")
    lines.append(f"torchft_exporter_fleet_signals_total{{{jl}}} "
                 f"{int(fleet.get('signal_seq', 0))}")
    header("torchft_exporter_fleet_signals_dropped",
           "Failure-evidence records evicted from the lighthouse signal "
           "ring (evidence feed incomplete when > 0).")
    lines.append(f"torchft_exporter_fleet_signals_dropped{{{jl}}} "
                 f"{int(agg.get('signals_dropped', 0))}")
    # Per-source signal counts: the source enum is closed (SIGNAL_SOURCES,
    # six values) so this series set is cardinality-bounded by construction
    # — unknown keys from a newer lighthouse still emit, but there can only
    # be as many as the lighthouse's own enum admits.
    sig_counts = fleet.get("signal_counts") or {}
    if sig_counts:
        header("torchft_exporter_fleet_signals_by_source",
               "Failure-evidence signals ingested per signal source.")
        for src in sorted(sig_counts):
            lines.append(
                f'torchft_exporter_fleet_signals_by_source{{{jl},'
                f'source="{esc(src)}"}} {int(sig_counts[src])}')
    header("torchft_exporter_replicas_suppressed",
           "Healthy replicas collapsed into aggregates by the "
           "TORCHFT_EXPORT_MAX_REPLICAS cardinality bound.")
    lines.append(f"torchft_exporter_replicas_suppressed{{{jl}}} "
                 f"{len(all_replicas) - len(replicas)}")
    if agg.get("median_rate") is not None:
        header("torchft_exporter_fleet_median_step_rate",
               "Median committed-steps-per-second across digest replicas.")
        lines.append(f"torchft_exporter_fleet_median_step_rate{{{jl}}} "
                     f"{float(agg['median_rate']):.6g}")
    if agg.get("median_goodput") is not None:
        header("torchft_exporter_fleet_median_goodput",
               "Median rolling goodput fraction across digest replicas.")
        lines.append(f"torchft_exporter_fleet_median_goodput{{{jl}}} "
                     f"{float(agg['median_goodput']):.6g}")
    # Time-accounting plane: job goodput fraction + per-kind badput sums.
    # The kind label iterates the CLOSED BADPUT_KINDS enum (never the
    # payload's keys), so the series set is cardinality-bounded by
    # construction even against a newer lighthouse.
    if agg.get("goodput_frac") is not None:
        header("torchft_exporter_fleet_goodput_fraction",
               "Compute share of all accounted replica-seconds in this "
               "job (from the cumulative badput ledger).")
        lines.append(f"torchft_exporter_fleet_goodput_fraction{{{jl}}} "
                     f"{float(agg['goodput_frac']):.6g}")
    badput = agg.get("badput_s") or {}
    if badput:
        header("torchft_exporter_fleet_badput_seconds",
               "Accounted replica-seconds per badput kind (closed "
               "BADPUT_KINDS enum).")
        for kind in BADPUT_KINDS:
            if kind in badput:
                lines.append(
                    f'torchft_exporter_fleet_badput_seconds{{{jl},'
                    f'kind="{esc(kind)}"}} {float(badput[kind]):.6g}')
    if agg.get("mtbf_s") is not None:
        header("torchft_exporter_fleet_mtbf_seconds",
               "Mean time between hard-evidence faults in this job.")
        lines.append(f"torchft_exporter_fleet_mtbf_seconds{{{jl}}} "
                     f"{float(agg['mtbf_s']):.6g}")
    if agg.get("ettr_s") is not None:
        header("torchft_exporter_fleet_ettr_seconds",
               "Mean evidence-to-training-resumption time in this job.")
        lines.append(f"torchft_exporter_fleet_ettr_seconds{{{jl}}} "
                     f"{float(agg['ettr_s']):.6g}")
    header("torchft_exporter_fleet_slo_burning",
           "1 while this job burns its goodput error budget faster than "
           "the configured threshold.")
    lines.append(f"torchft_exporter_fleet_slo_burning{{{jl}}} "
                 f"{1 if agg.get('slo_burning') else 0}")
    header("torchft_exporter_fleet_slo_burns_total",
           "SLO burn-rate rise edges since lighthouse boot.")
    lines.append(f"torchft_exporter_fleet_slo_burns_total{{{jl}}} "
                 f"{int(fleet.get('slo_seq', 0))}")

    header("torchft_exporter_replica_straggler",
           "1 when the lighthouse flags this replica as a straggler.")
    for rid in sorted(replicas):
        flag = 1 if replicas[rid].get("straggler") else 0
        lines.append(
            f'torchft_exporter_replica_straggler{{{jl},'
            f'replica="{esc(rid)}"}} {flag}')
    header("torchft_exporter_replica_anomaly",
           "1 per active anomaly flag (kind label) on this replica.")
    for rid in sorted(replicas):
        for kind in sorted(replicas[rid].get("flags") or []):
            lines.append(
                f'torchft_exporter_replica_anomaly{{{jl},'
                f'replica="{esc(rid)}",kind="{esc(kind)}"}} 1')
    header("torchft_exporter_replica_step_rate",
           "Committed steps per second from this replica's digest.")
    for rid in sorted(replicas):
        dg = replicas[rid].get("digest") or {}
        if "rate" in dg:
            lines.append(
                f'torchft_exporter_replica_step_rate{{{jl},'
                f'replica="{esc(rid)}"}} {float(dg["rate"]):.6g}')
    header("torchft_exporter_replica_goodput",
           "Rolling goodput fraction from this replica's digest.")
    for rid in sorted(replicas):
        dg = replicas[rid].get("digest") or {}
        if "gp" in dg:
            lines.append(
                f'torchft_exporter_replica_goodput{{{jl},'
                f'replica="{esc(rid)}"}} {float(dg["gp"]):.6g}')
    header("torchft_exporter_replica_commit_failures",
           "Consecutive commit failures from this replica's digest.")
    for rid in sorted(replicas):
        dg = replicas[rid].get("digest") or {}
        lines.append(
            f'torchft_exporter_replica_commit_failures{{{jl},'
            f'replica="{esc(rid)}"}} {int(dg.get("cf", 0))}')

    # Namespace rollups (composite payload only): one small series set per
    # job island. Bounded like replicas — above the cap only jobs a pager
    # rule would fire on (stragglers or anomalies) keep their series.
    all_jobs = fleet.get("jobs") or {}
    if all_jobs:
        max_jobs = knobs.get_int("TORCHFT_EXPORT_MAX_JOBS")
        if len(all_jobs) > max_jobs:
            jobs = {
                name: ja for name, ja in all_jobs.items()
                if (ja or {}).get("stragglers") or (ja or {}).get(
                    "anomaly_seq")
            }
        else:
            jobs = all_jobs
        header("torchft_exporter_jobs_suppressed",
               "Healthy job namespaces collapsed by the "
               "TORCHFT_EXPORT_MAX_JOBS cardinality bound.")
        lines.append("torchft_exporter_jobs_suppressed "
                     f"{len(all_jobs) - len(jobs)}")
        for name, key, help_ in (
            ("torchft_exporter_job_replicas", "n",
             "Replicas in this job namespace's fleet table."),
            ("torchft_exporter_job_quorum_world", "quorum_world",
             "This job's current quorum size."),
            ("torchft_exporter_job_stragglers", "stragglers",
             "Replicas this job currently flags as stragglers."),
            ("torchft_exporter_job_anomalies_total", "anomaly_seq",
             "Anomalies this job has raised since lighthouse boot."),
        ):
            header(name, help_)
            for jname in sorted(jobs):
                lines.append(
                    f'{name}{{job="{esc(jname)}"}} '
                    f"{int((jobs[jname] or {}).get(key, 0))}")

    # Federation (root lighthouse only): district liveness + fencing.
    districts = fleet.get("districts") or {}
    if districts:
        for name, key, help_ in (
            ("torchft_exporter_district_lost", "lost",
             "1 when no rollup arrived within the heartbeat timeout."),
            ("torchft_exporter_district_epoch", "epoch",
             "Max fencing epoch accepted from this district."),
            ("torchft_exporter_district_failovers", "failovers",
             "Epoch advances observed (district lighthouse failovers)."),
            ("torchft_exporter_district_stale_dropped", "stale_dropped",
             "Rollups fenced out as coming from a stale district primary."),
        ):
            header(name, help_)
            for dname in sorted(districts):
                lines.append(
                    f'{name}{{district="{esc(dname)}"}} '
                    f"{int((districts[dname] or {}).get(key, 0))}")
    return "\n".join(lines) + "\n"


def journal_anomalies(journal: Optional[EventLog],
                      fleet: Optional[Dict[str, Any]],
                      cursor: int) -> int:
    """Emit every anomaly newer than ``cursor`` as an ``anomaly`` journal
    event; returns the new cursor. The lighthouse assigns each anomaly a
    monotone ``seq``, so a restarting exporter only replays what the ring
    still holds."""
    if fleet is None:
        return cursor
    for rec in fleet.get("anomalies") or []:
        seq = int(rec.get("seq", 0))
        if seq <= cursor:
            continue
        cursor = seq
        if journal is not None:
            journal.emit(
                "anomaly",
                seq=seq,
                replica=str(rec.get("replica_id", "")),
                kind=str(rec.get("kind", "")),
                ts_ms=int(rec.get("ts_ms", 0)),
                detail=rec.get("detail"),
            )
    return cursor


def journal_overflow(journal: Optional[EventLog],
                     fleet: Optional[Dict[str, Any]],
                     last_dropped: int) -> int:
    """Journal a single ``anomaly_overflow`` event on the rise edge of the
    lighthouse's anomaly-ring drop counter; returns the new high-water mark.
    One event per observed rise (not per dropped record): the counter's
    delta rides the event, so the journal stays bounded even when the ring
    churns thousands of drops between scrapes."""
    if fleet is None:
        return last_dropped
    agg = fleet.get("agg") or {}
    dropped = int(agg.get("anomalies_dropped", 0))
    if dropped > last_dropped:
        if journal is not None:
            journal.emit(
                "anomaly_overflow",
                dropped_total=dropped,
                new_drops=dropped - last_dropped,
            )
        return dropped
    return last_dropped


def journal_signals(journal: Optional[EventLog],
                    fleet: Optional[Dict[str, Any]],
                    cursor: int) -> int:
    """Emit every failure-evidence signal newer than ``cursor`` as a
    ``failure_signal`` journal event; returns the new cursor. Signals carry
    a lighthouse-assigned monotone ``seq`` like anomalies, so a restarting
    exporter only replays what the ring still holds — and detection-latency
    reports get the lighthouse's observation site and timestamp for every
    signal even when the emitting trainer's own journal was lost with it."""
    if fleet is None:
        return cursor
    for rec in fleet.get("signals") or []:
        seq = int(rec.get("seq", 0))
        if seq <= cursor:
            continue
        cursor = seq
        if journal is not None:
            journal.emit(
                "failure_signal",
                seq=seq,
                source=str(rec.get("source", "")),
                subject=str(rec.get("replica_id", "")),
                site=str(rec.get("site", "")),
                ts_ms=int(rec.get("ts_ms", 0)),
                detail=rec.get("detail"),
            )
    return cursor


def journal_slo_burns(journal: Optional[EventLog],
                      fleet: Optional[Dict[str, Any]],
                      cursor: int) -> int:
    """Emit every SLO burn-rate rise edge newer than ``cursor`` as an
    ``slo_burn`` journal event; returns the new cursor. Burn records carry
    a lighthouse-assigned monotone ``seq`` like anomalies, so a restarting
    exporter only replays what the ring still holds."""
    if fleet is None:
        return cursor
    for rec in fleet.get("slo_burns") or []:
        seq = int(rec.get("seq", 0))
        if seq <= cursor:
            continue
        cursor = seq
        if journal is not None:
            journal.emit(
                "slo_burn",
                seq=seq,
                job=str(rec.get("job", "")),
                goodput=rec.get("goodput"),
                target=rec.get("target"),
                burn=rec.get("burn"),
                ts_ms=int(rec.get("ts_ms", 0)),
            )
    return cursor


def journal_signal_overflow(journal: Optional[EventLog],
                            fleet: Optional[Dict[str, Any]],
                            last_dropped: int) -> int:
    """Journal a single ``signal_overflow`` event on the rise edge of the
    lighthouse's signal-ring drop counter; returns the new high-water mark.
    Same shape as ``anomaly_overflow``: one event per observed rise, with
    the delta riding the event, so a churning ring can't flood the journal
    — but a detection report knows its evidence feed has a hole."""
    if fleet is None:
        return last_dropped
    agg = fleet.get("agg") or {}
    dropped = int(agg.get("signals_dropped", 0))
    if dropped > last_dropped:
        if journal is not None:
            journal.emit(
                "signal_overflow",
                dropped_total=dropped,
                new_drops=dropped - last_dropped,
            )
        return dropped
    return last_dropped


def latest_native_counters(
    events: list,
) -> Dict[str, Dict[str, Any]]:
    """Latest ``native_counters`` journal event per replica (the native PG
    drains one after every collective, so the last one carries the
    engine's cumulative per-peer counters for this incarnation)."""
    out: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("event") == "native_counters":
            out[telemetry._replica_key(ev)] = ev.get("attrs") or {}
    return out


def render_native_prometheus(
    counters: Dict[str, Dict[str, Any]],
) -> str:
    """Prometheus gauges from the native engine's always-on counters:
    per-peer goodput, MSG_DONTWAIT spin totals, and flight-recorder ring
    drops. Peer bandwidth divides bytes by busy time PER STREAM
    (``busy_ns / n_streams``): busy_ns sums over n_streams concurrent
    stripe jobs, so the raw quotient would understate wall bandwidth by
    roughly that factor."""
    if not counters:
        return ""
    lines = []

    def header(name: str, help_: str) -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} gauge")

    def esc(s: Any) -> str:
        return str(s).replace("\\", "\\\\").replace('"', '\\"')

    for name, key, help_ in (
        ("torchft_exporter_native_spin_total", "spin_total",
         "MSG_DONTWAIT EAGAIN->poll misses across all engine transfers."),
        ("torchft_exporter_native_fr_dropped", "dropped",
         "Flight records overwritten before any snapshot drained them."),
        ("torchft_exporter_native_fr_seq", "seq",
         "Collectives recorded by the engine flight recorder."),
        ("torchft_exporter_native_bytes_tx", "bytes_tx",
         "Bytes sent on the native data plane."),
        ("torchft_exporter_native_bytes_rx", "bytes_rx",
         "Bytes received on the native data plane."),
    ):
        header(name, help_)
        for rid in sorted(counters):
            lines.append(
                f'{name}{{replica="{esc(rid)}"}} '
                f"{int(counters[rid].get(key, 0))}"
            )

    header("torchft_exporter_native_peer_gib_s",
           "Per-peer stripe goodput, GiB per busy second "
           "(bytes / (busy_ns / n_streams)).")
    for rid in sorted(counters):
        c = counters[rid]
        streams = max(int(c.get("n_streams", 1)), 1)
        for p in c.get("peers") or []:
            for dirn, bkey, nskey in (
                ("tx", "tx_bytes", "tx_busy_ns"),
                ("rx", "rx_bytes", "rx_busy_ns"),
            ):
                busy = int(p.get(nskey, 0))
                gib_s = (
                    int(p.get(bkey, 0)) / (1 << 30) / (busy / streams / 1e9)
                    if busy > 0 else 0.0
                )
                lines.append(
                    f'torchft_exporter_native_peer_gib_s{{'
                    f'replica="{esc(rid)}",peer="{p.get("peer")}",'
                    f'dir="{dirn}"}} {gib_s:.4f}'
                )
    header("torchft_exporter_native_peer_spins",
           "Per-peer MSG_DONTWAIT spin count.")
    for rid in sorted(counters):
        for p in counters[rid].get("peers") or []:
            lines.append(
                f'torchft_exporter_native_peer_spins{{'
                f'replica="{esc(rid)}",peer="{p.get("peer")}"}} '
                f"{int(p.get('spins', 0))}"
            )
    return "\n".join(lines) + "\n"


class _Exporter:
    """Holds the latest sample; the HTTP handler and poll loop share it."""

    def __init__(self, journal_paths: Optional[list] = None) -> None:
        self._lock = threading.Lock()
        self._sample: Optional[Dict[str, Any]] = None
        self._fleet: Optional[Dict[str, Any]] = None
        self._error: str = "no scrape yet"
        self._journal_paths = list(journal_paths or [])

    def update(self, sample: Dict[str, Any],
               fleet: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            self._sample = sample
            self._fleet = fleet
            self._error = ""

    def fail(self, error: str) -> None:
        with self._lock:
            self._error = error

    def render(self) -> str:
        with self._lock:
            sample, fleet, error = self._sample, self._fleet, self._error
        body = render_prometheus(sample) if sample is not None else ""
        if fleet is not None:
            body += render_fleet_prometheus(fleet)
        if self._journal_paths:
            try:
                body += render_native_prometheus(
                    latest_native_counters(
                        telemetry.load_journal(self._journal_paths)
                    )
                )
            except Exception as e:  # noqa: BLE001 - journal is best-effort
                print(f"native gauge scan failed: {e}", file=sys.stderr)
        up = 1 if (sample is not None and not error) else 0
        body += ("# HELP torchft_exporter_up Last scrape succeeded.\n"
                 "# TYPE torchft_exporter_up gauge\n"
                 f"torchft_exporter_up {up}\n")
        return body


def _make_handler(exporter: _Exporter):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler API
            if self.path not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = exporter.render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args: Any) -> None:
            pass  # scrape chatter does not belong on stderr

    return Handler


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lighthouse",
                   default=knobs.get_str("TORCHFT_LIGHTHOUSE"),
                   help="lighthouse host:port (default: $TORCHFT_LIGHTHOUSE)")
    p.add_argument("--interval", type=float, default=5.0,
                   help="poll interval seconds (default 5)")
    p.add_argument("--journal-file", default="",
                   help="append lighthouse_status events to this JSONL file")
    p.add_argument("--journal", action="append", default=[],
                   metavar="PATH",
                   help="journal file/dir to scan for native engine "
                        "counters (per-peer GiB/s, spins, ring drops); "
                        "repeatable")
    p.add_argument("--port", type=int, default=0,
                   help="serve Prometheus text on this port (0 = off)")
    p.add_argument("--once", action="store_true",
                   help="scrape once, print the exposition to stdout, exit")
    p.add_argument("--max-scrapes", type=int, default=0,
                   help="exit after N successful scrapes (0 = run forever)")
    args = p.parse_args(argv)
    if not args.lighthouse and not args.journal:
        p.error("--lighthouse / $TORCHFT_LIGHTHOUSE or --journal is required")

    client = (
        LighthouseClient(args.lighthouse, connect_timeout=10.0)
        if args.lighthouse
        else None
    )
    journal = (
        EventLog(args.journal_file, replica_id="exporter")
        if args.journal_file
        else None
    )

    if args.once:
        if client is not None:
            sample = scrape(client)
            if journal is not None:
                journal.emit("lighthouse_status", **sample)
            sys.stdout.write(render_prometheus(sample))
            fleet = scrape_fleet(client)
            if fleet is not None:
                journal_anomalies(journal, fleet, 0)
                journal_overflow(journal, fleet, 0)
                journal_signals(journal, fleet, 0)
                journal_signal_overflow(journal, fleet, 0)
                journal_slo_burns(journal, fleet, 0)
                sys.stdout.write(render_fleet_prometheus(fleet))
        if args.journal:
            sys.stdout.write(
                render_native_prometheus(
                    latest_native_counters(
                        telemetry.load_journal(args.journal)
                    )
                )
            )
        return 0

    if client is None:
        p.error("serving mode needs --lighthouse / $TORCHFT_LIGHTHOUSE")
    exporter = _Exporter(journal_paths=args.journal)
    server = None
    if args.port:
        server = ThreadingHTTPServer(
            ("0.0.0.0", args.port), _make_handler(exporter)
        )
        threading.Thread(target=server.serve_forever, daemon=True).start()
        print(f"serving /metrics on :{server.server_address[1]}", flush=True)

    scrapes = 0
    anomaly_cursor = 0
    overflow_mark = 0
    signal_cursor = 0
    signal_overflow_mark = 0
    slo_cursor = 0
    try:
        while True:
            try:
                sample = scrape(client)
                fleet = scrape_fleet(client)
                exporter.update(sample, fleet)
                if journal is not None:
                    journal.emit("lighthouse_status", **sample)
                anomaly_cursor = journal_anomalies(
                    journal, fleet, anomaly_cursor
                )
                overflow_mark = journal_overflow(
                    journal, fleet, overflow_mark
                )
                signal_cursor = journal_signals(
                    journal, fleet, signal_cursor
                )
                signal_overflow_mark = journal_signal_overflow(
                    journal, fleet, signal_overflow_mark
                )
                slo_cursor = journal_slo_burns(
                    journal, fleet, slo_cursor
                )
                scrapes += 1
                if args.max_scrapes and scrapes >= args.max_scrapes:
                    return 0
            except Exception as e:  # noqa: BLE001 - keep polling through faults
                exporter.fail(str(e))
                print(f"scrape failed: {e}", file=sys.stderr, flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        if server is not None:
            server.shutdown()
        if journal is not None:
            journal.close()
        client.close()


if __name__ == "__main__":
    sys.exit(main())
