"""Central registry of ``TORCHFT_*`` environment knobs.

Every environment variable the framework reads is declared here ONCE,
with its type, default, and a one-line doc.  All reads in
``torchft_tpu_torch/`` and ``tools/`` go through the typed accessors below —
``tools/tft_lint.py`` (rule ``env-knob-registry``) rejects any direct
``os.environ`` / ``os.getenv`` read of a ``TORCHFT_*`` name outside
this module, and rejects accessor calls that name an unregistered
knob.  ``docs/KNOBS.md`` is generated verbatim from this registry
(``python tools/tft_lint.py --gen-knob-docs``), so a knob cannot be
read-but-undocumented or documented-but-dead.

Scope tells the linter (and the reader) where the knob is consumed:

- ``py``    read by Python code in ``torchft_tpu_torch/`` or ``tools/``
- ``cpp``   read by the C++ side (``getenv`` in ``_cpp/*.cc``)
- ``both``  read on both sides (the contract must match bit-for-bit)
- ``entry`` read by the repo-root entry script (``__graft_entry__.py``),
  outside the package; registered for documentation only

Accessor semantics (kept bit-compatible with the pre-registry call
sites):

- ``get_raw``   the raw string, or the registered default when unset
- ``get_str``   like ``get_raw`` but never ``None`` (falls back to "")
- ``get_int`` / ``get_float``  parse the raw value; unset -> default;
  a set-but-malformed value raises ``ValueError`` exactly as the old
  inline ``int(os.environ.get(...))`` did
- ``get_bool``  truthy iff the value is one of ``1/true/yes/on``
  (case-insensitive) — the journal flight-recorder gate's exact set
- ``require``   the raw string; raises ``KeyError(name)`` when unset,
  matching ``os.environ[name]``

Internal child-process plumbing variables (prefix ``_TORCHFT_``) are
deliberately NOT registered: the leading underscore marks them as
private wire between a launcher and the child it just spawned, not
user-facing configuration.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Union

__all__ = [
    "Knob",
    "KNOBS",
    "get_raw",
    "get_str",
    "get_int",
    "get_float",
    "get_bool",
    "require",
    "generate_doc",
]

_TRUTHY = ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    type: str  # "str" | "int" | "float" | "bool" | "spec"
    default: Optional[str]  # raw default string; None = unset
    doc: str  # ONE line; becomes the docs/KNOBS.md table row
    scope: str = "py"  # "py" | "cpp" | "both" | "entry"


def _k(
    name: str,
    type: str,
    default: Optional[str],
    doc: str,
    scope: str = "py",
) -> Knob:
    assert name.startswith("TORCHFT_"), name
    assert "\n" not in doc, name
    return Knob(name=name, type=type, default=default, doc=doc, scope=scope)


_ALL = [
    # -- chaos plane -------------------------------------------------------
    _k(
        "TORCHFT_CHAOS",
        "spec",
        None,
        "Seeded fault-injection spec, `seed:<u64>,spec:<kind>@<plane>[:k=v]...[;...]`; parsed identically by chaos.py and _cpp/chaos.cc.",
        scope="both",
    ),
    # -- journal / telemetry ----------------------------------------------
    _k(
        "TORCHFT_JOURNAL_FILE",
        "str",
        None,
        "Append JSONL event-journal records to this exact path (wins over TORCHFT_JOURNAL_DIR).",
    ),
    _k(
        "TORCHFT_JOURNAL_DIR",
        "str",
        None,
        "Directory for per-replica event journals (`events_<replica>.jsonl`); each process rotates its own file.",
    ),
    _k(
        "TORCHFT_JOURNAL_MAX_MB",
        "float",
        "0",
        "Rotate the journal after this many MiB (0 or unset = no cap); only safe with per-process journal paths.",
    ),
    _k(
        "TORCHFT_METRICS_FILE",
        "str",
        None,
        "Append JSONL per-step metrics records to this path; empty/unset disables the metrics logger.",
    ),
    _k(
        "TORCHFT_REPLICA_ID",
        "str",
        None,
        "Replica id stamped on journal events and step digests; falls back to REPLICA_GROUP_ID, then `pid<pid>`.",
    ),
    # -- perf attribution -------------------------------------------------
    _k(
        "TORCHFT_PERF",
        "bool",
        None,
        "Truthy: trainers record per-jitted-step FLOPs/bytes from XLA cost analysis at compile time (one `perf_model` journal event) and append MFU/roofline to step logs; unset costs nothing.",
    ),
    _k(
        "TORCHFT_PERF_LEDGER",
        "str",
        None,
        "Override the benchmark ledger path tools/perf_ledger.py appends to (default `<repo>/BENCH_LEDGER.jsonl`).",
    ),
    # -- flight recorder / tracing ----------------------------------------
    _k(
        "TORCHFT_TRACE_DIR",
        "str",
        None,
        "Enable torch.profiler step-window traces, written under this directory; unset disables tracing.",
    ),
    _k(
        "TORCHFT_TRACE_START",
        "int",
        "5",
        "First step (inclusive) of the profiler trace window.",
    ),
    _k(
        "TORCHFT_TRACE_COUNT",
        "int",
        "3",
        "Number of steps the profiler trace window spans.",
    ),
    _k(
        "TORCHFT_TRIGGER_FR_ON_ABORT",
        "bool",
        None,
        "Truthy (1/true/yes/on): dump the native flight-recorder ring to a JSON file when a collective aborts.",
    ),
    _k(
        "TORCHFT_FR_DIR",
        "str",
        "/tmp",
        "Directory for on-abort flight-recorder dumps (`fr_<replica>_<reason>_<ts>.json`).",
    ),
    # -- manager / coordination -------------------------------------------
    _k(
        "TORCHFT_LIGHTHOUSE",
        "str",
        None,
        "Lighthouse address list `host:port[,host:port...]` (first entry = primary, rest = warm standbys, failover in order); required by Manager when no address argument is given, optional default for obs tools.",
    ),
    _k(
        "TORCHFT_LH_LEASE_MS",
        "int",
        "3000",
        "Manager's lease on the active lighthouse: no heartbeat ack for this long fails over to the next address in the TORCHFT_LIGHTHOUSE list.",
        scope="cpp",
    ),
    _k(
        "TORCHFT_LH_STATE_DIR",
        "str",
        None,
        "Lighthouse durable-state directory (fsync'd epoch/quorum-id snapshot, survives crash/restart so quorum ids stay monotone); unset = volatile pre-HA behavior.",
        scope="cpp",
    ),
    _k(
        "TORCHFT_JOB",
        "str",
        "default",
        "Job namespace stamped on every heartbeat/quorum/leave frame; the lighthouse keeps fully isolated per-job membership, quorum numbering, fleet tables, and anomaly rings. `default` matches the pre-namespace wire behavior.",
        scope="both",
    ),
    _k(
        "TORCHFT_LH_DISTRICT",
        "str",
        None,
        "District name for a federated lighthouse; with TORCHFT_LH_ROOT set, the active instance piggybacks per-job fleet rollups upward on the heartbeat channel. The --district flag wins over the env.",
        scope="cpp",
    ),
    _k(
        "TORCHFT_LH_ROOT",
        "str",
        None,
        "Root lighthouse address `host:port` a district lighthouse reports its per-job rollup digests to; unset = federation off. The --root flag wins over the env.",
        scope="cpp",
    ),
    # -- failure-evidence plane -------------------------------------------
    _k(
        "TORCHFT_LH_EVIDENCE",
        "bool",
        "1",
        "Lighthouse evidence-driven REACTION (cadence-aware hb-lapse eviction + signal-triggered quorum re-evaluation). Signals are always collected/journaled/exported; `0` only stops acting on them.",
        scope="cpp",
    ),
    _k(
        "TORCHFT_LH_EVICT_MULT",
        "int",
        "12",
        "hb-lapse eviction budget multiplier: a replica whose open heartbeat gap exceeds max(TORCHFT_LH_EVICT_FLOOR_MS, mult x its declared cadence) is evicted from the quorum tables on evidence instead of waiting out heartbeat_timeout_ms. Replicas that never declared a cadence are never evicted early.",
        scope="cpp",
    ),
    _k(
        "TORCHFT_LH_EVICT_FLOOR_MS",
        "int",
        "1000",
        "Floor (ms) of the cadence-aware hb-lapse eviction budget, so very fast heartbeaters keep a sane grace window.",
        scope="cpp",
    ),
    _k(
        "TORCHFT_MGR_EVIDENCE_STREAK",
        "int",
        "3",
        "Manager hard-evidence lighthouse failover: this many CONSECUTIVE transport failures (connect refused/reset) on the active entry fails over immediately instead of waiting out the full TORCHFT_LH_LEASE_MS lease. `0` = lease lapse only. The --evidence-streak flag wins over the env.",
        scope="cpp",
    ),
    _k(
        "TORCHFT_EVIDENCE_WATCH",
        "bool",
        "1",
        "Trainer-side evidence watcher: while blocked on a managed collective, poll the local manager's evidence_status (~TORCHFT_EVIDENCE_POLL_S cadence) and abort the wedged process group on first hard peer-failure evidence (native_abort / proc_death / hb_lapse) instead of waiting out the collective timeout.",
    ),
    _k(
        "TORCHFT_EVIDENCE_POLL_S",
        "float",
        "0.1",
        "Poll cadence (seconds) of the trainer-side evidence watcher.",
    ),
    _k(
        "TORCHFT_TIMEOUT_SEC",
        "float",
        None,
        "Override Manager per-RPC timeout (seconds); default comes from the Manager(timeout=...) argument.",
    ),
    _k(
        "TORCHFT_QUORUM_TIMEOUT_SEC",
        "float",
        None,
        "Override Manager quorum timeout (seconds); default comes from the Manager(quorum_timeout=...) argument.",
    ),
    _k(
        "TORCHFT_CONNECT_TIMEOUT_SEC",
        "float",
        None,
        "Override Manager connect timeout (seconds); default comes from the Manager(connect_timeout=...) argument.",
    ),
    _k(
        "TORCHFT_QUORUM_RETRIES",
        "int",
        "0",
        "Extra quorum attempts after an ordinary quorum failure before giving up.",
    ),
    _k(
        "TORCHFT_DIGEST",
        "bool",
        "1",
        "Step-digest piggyback on heartbeats; any value but `0` keeps it on.",
    ),
    _k(
        "TORCHFT_DIGEST_INTERVAL_S",
        "float",
        "1.0",
        "Minimum seconds between refreshed step digests handed to the heartbeat loop.",
    ),
    _k(
        "TORCHFT_RPC_RETRIES",
        "int",
        "3",
        "Attempts per idempotent control-plane RPC before the error propagates.",
    ),
    _k(
        "TORCHFT_RPC_BACKOFF_BASE_S",
        "float",
        "0.05",
        "Base of the exponential RPC retry backoff (seconds).",
    ),
    _k(
        "TORCHFT_RPC_BACKOFF_MAX_S",
        "float",
        "1.0",
        "Cap on the exponential RPC retry backoff (seconds).",
    ),
    _k(
        "TORCHFT_HOST_ADDR",
        "str",
        None,
        "Address to advertise for this host's servers instead of the auto-detected outbound interface.",
    ),
    # -- process group / native data plane --------------------------------
    _k(
        "TORCHFT_PG",
        "str",
        "socket",
        "Data-plane backend for ProcessGroup selection: `socket` (pure Python) or `native` (C++ engine).",
    ),
    _k(
        "TORCHFT_PG_WIRE",
        "str",
        "fp32",
        "Wire format for allreduce payloads: `fp32` or `q8` (int8 quantized).",
    ),
    _k(
        "TORCHFT_NATIVE_STREAMS",
        "int",
        "4",
        "Socket streams per peer link in the native collective engine.",
    ),
    _k(
        "TORCHFT_LINKS",
        "spec",
        None,
        "Per-peer link policy, `<peer>=<class>[,k=v]...[;...]` with classes `local`/`dcn`/`wan` and keys `connect_ms`/`io_ms`/`streams`/`q8`; `*` sets the default. Must be symmetric across ranks. Parsed in Python; the native engine receives the resolved policies via `tft_coll_set_link`, the chaos plane via `tft_chaos_set_link`.",
        scope="py",
    ),
    _k(
        "TORCHFT_NATIVE_PIPELINE_BYTES",
        "int",
        str(1 << 20),
        "Pipeline chunk size (bytes) for the native engine's chunked ring collectives.",
    ),
    _k(
        "TORCHFT_NATIVE_FR_RING",
        "int",
        "256",
        "Flight-recorder ring capacity (entries) in the native engine.",
    ),
    # -- futures / watchdog ------------------------------------------------
    _k(
        "TORCHFT_WATCHDOG_TIMEOUT_SEC",
        "float",
        "30",
        "Default watchdog timeout (seconds) for future completion before the context aborts.",
    ),
    # -- runner / orchestration -------------------------------------------
    _k(
        "TORCHFT_RUNNER_PDEATHSIG",
        "bool",
        "1",
        "Deliver SIGKILL to replica children when the runner dies; any value but `0` keeps it on (Linux only).",
    ),
    _k(
        "TORCHFT_DRAIN_GRACE_S",
        "float",
        "120",
        "Preemption drain grace window (seconds) shared by every layer that budgets a SIGTERM->SIGKILL gap: orchestration/k8s.py renders it as `terminationGracePeriodSeconds`, the chaos `preempt` kind defaults its `grace=` param to it, and tools/elastic_drill.py waits this long for a drained exit before hard-killing.",
    ),
    # -- backend probe / collectives --------------------------------------
    _k(
        "TORCHFT_PROBE_TIMEOUT",
        "float",
        None,
        "Override the TPU backend-probe timeout (seconds).",
    ),
    _k(
        "TORCHFT_PROBE_NO_CACHE",
        "bool",
        None,
        "Truthy: ignore the cached backend-probe verdict and probe fresh.",
    ),
    _k(
        "TORCHFT_FORCE_DEVICE_QUANT",
        "bool",
        None,
        "Truthy: force the on-device (Pallas) quantization path even off-TPU (interpreter; test use only).",
    ),
    _k(
        "TORCHFT_LOSS_CHUNK",
        "int",
        "128",
        "Per-shard microbatch chunk size used when computing loss without materializing full logits.",
    ),
    _k(
        "TORCHFT_TTR_BUDGET_S",
        "float",
        "60",
        "Recovery time-to-restore budget (seconds): tools/obs_top.py flags any replica whose heal p95 exceeds it, and docs/FAULT_MODEL.md's TTR table is written against it.",
    ),
    _k(
        "TORCHFT_EXPORT_MAX_REPLICAS",
        "int",
        "64",
        "Per-replica series cardinality cap shared by the lighthouse /metrics endpoint and tools/obs_export.py: above this many fleet replicas, only aggregates plus anomalous/straggler replicas get per-replica series.",
        scope="both",
    ),
    _k(
        "TORCHFT_EXPORT_MAX_JOBS",
        "int",
        "64",
        "Per-job series cardinality cap in tools/obs_export.py: above this many job namespaces in the composite fleet payload, only jobs with stragglers or anomalies get per-job rollup series (plus a suppressed-count gauge).",
        scope="py",
    ),
    # -- SLO burn-rate evaluator (lighthouse goodput plane) ---------------
    _k(
        "TORCHFT_LH_SLO_GOODPUT",
        "float",
        "0.95",
        "Per-job goodput-fraction SLO target the lighthouse burn-rate evaluator compares against (compute share of all accounted replica-seconds). >= 1.0 disarms the evaluator (no error budget).",
        scope="cpp",
    ),
    _k(
        "TORCHFT_LH_SLO_BURN",
        "float",
        "2.0",
        "Burn-rate threshold that trips a rise-edge slo_burn event: burn = (1 - goodput) / (1 - TORCHFT_LH_SLO_GOODPUT), i.e. how many times faster than allotted the job spends its error budget.",
        scope="cpp",
    ),
    _k(
        "TORCHFT_LH_SLO_MIN_S",
        "float",
        "30.0",
        "Minimum accounted replica-seconds before the SLO evaluator arms, so startup/compile windows cannot page.",
        scope="cpp",
    ),
    # -- C++-only ----------------------------------------------------------
    _k(
        "TORCHFT_LH_DEBUG",
        "bool",
        None,
        "Set (any value): the C++ lighthouse logs per-RPC debug lines to stderr.",
        scope="cpp",
    ),
    _k(
        "TORCHFT_FLEET_SNAP_MS",
        "int",
        "100",
        "/fleet.json staleness bound for the lighthouse binary's cached snapshot (ms); 0 rebuilds the payload on every request. The --fleet-snap-ms flag wins over the env.",
        scope="cpp",
    ),
    # -- repo-root entry script (documented here, read outside the pkg) ---
    _k(
        "TORCHFT_XLA_CACHE_DIR",
        "str",
        None,
        "Override the XLA compilation-cache directory used by the TPU dry-run entry script.",
        scope="entry",
    ),
    _k(
        "TORCHFT_DRYRUN_XLA_FLAGS",
        "str",
        None,
        "Extra XLA_FLAGS appended for the TPU dry-run child process.",
        scope="entry",
    ),
    _k(
        "TORCHFT_DRYRUN_ALL_LEGS",
        "bool",
        None,
        "`1`: the TPU dry-run exercises every leg instead of stopping at the first failure.",
        scope="entry",
    ),
]

KNOBS: Dict[str, Knob] = {k.name: k for k in _ALL}
assert len(KNOBS) == len(_ALL), "duplicate knob registration"

_UNSET = object()


def _knob(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"unregistered env knob {name!r}: declare it in torchft_tpu_torch/knobs.py"
        ) from None


def get_raw(name: str, default: object = _UNSET) -> Optional[str]:
    """Raw env value; unset -> call-site default, else registered default."""
    knob = _knob(name)
    raw = os.environ.get(name)
    if raw is not None:
        return raw
    if default is not _UNSET:
        return default  # type: ignore[return-value]
    return knob.default


def get_str(name: str, default: Optional[str] = None) -> str:
    raw = get_raw(name, default if default is not None else _UNSET)
    return "" if raw is None else str(raw)


def get_int(name: str, default: Optional[Union[int, str]] = None) -> int:
    raw = get_raw(name, default if default is not None else _UNSET)
    if raw is None:
        raise ValueError(f"env knob {name} is unset and has no default")
    return int(raw)


def get_float(
    name: str, default: Optional[Union[float, str]] = None
) -> float:
    raw = get_raw(name, default if default is not None else _UNSET)
    if raw is None:
        raise ValueError(f"env knob {name} is unset and has no default")
    return float(raw)


def get_bool(name: str, default: Optional[str] = None) -> bool:
    raw = get_raw(name, default if default is not None else _UNSET)
    return str(raw).strip().lower() in _TRUTHY


def require(name: str) -> str:
    """Like ``os.environ[name]`` (raises ``KeyError(name)`` when unset)."""
    _knob(name)
    raw = os.environ.get(name)
    if raw is None:
        raise KeyError(name)
    return raw


_SCOPE_TITLE = {
    "py": "Python (`torchft_tpu_torch/`, `tools/`)",
    "cpp": "C++ (`torchft_tpu/_cpp/`)",
    "both": "Python + C++ (dual-language contract)",
    "entry": "Repo-root entry script",
}


def generate_doc() -> str:
    """The full ``docs/KNOBS.md`` body, generated from the registry."""
    lines = [
        "# Environment knobs",
        "",
        "<!-- GENERATED FILE — do not edit by hand. -->",
        "<!-- Source of truth: torchft_tpu_torch/knobs.py.  Regenerate with -->",
        "<!--   python tools/tft_lint.py --gen-knob-docs -->",
        "",
        "Every `TORCHFT_*` environment variable the framework reads, from",
        "the single registry in `torchft_tpu_torch/knobs.py`.  The contract",
        "linter (`tools/tft_lint.py`, rule `env-knob-registry`) keeps this",
        "file, the registry, and the actual reads in sync: a knob cannot",
        "be read but undocumented, or documented but dead.",
        "",
    ]
    order = ["both", "py", "cpp", "entry"]
    for scope in order:
        knobs = [k for k in _ALL if k.scope == scope]
        if not knobs:
            continue
        lines += [f"## {_SCOPE_TITLE[scope]}", ""]
        lines += ["| Name | Type | Default | Description |"]
        lines += ["| --- | --- | --- | --- |"]
        for k in knobs:
            default = "*(unset)*" if k.default is None else f"`{k.default}`"
            lines.append(
                f"| `{k.name}` | {k.type} | {default} | {k.doc} |"
            )
        lines.append("")
    return "\n".join(lines)
