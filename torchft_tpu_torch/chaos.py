"""Deterministic, seeded fault injection across the control and data planes.

The drills in ``tools/drills.py`` can only kill whole processes; the failure
modes that dominate DCN training — flaky links, slow peers, partial writes,
torn RPCs mid-heal — need *surgical* faults at the socket layer, and a drill
failure is only debuggable if it replays bit-for-bit. This module is the
single source of truth for what gets injected where:

- One env knob drives everything::

      TORCHFT_CHAOS="seed:<uint64>,spec:<rule>[;<rule>...]"
      rule = <kind>@<plane>[:<param>=<value>]...

  Kinds: ``connect_refuse``, ``reset``, ``stall``, ``partial_write``,
  ``rpc_delay``, ``rpc_drop``, ``abort_heal``, ``ckpt_truncate``,
  ``throttle``, ``preempt``.
  Planes: ``ctrl`` (framed-RPC client/server path), ``data`` (process-group
  send/recv, both socket and native backends), ``heal`` (checkpoint
  transport), or ``any``.
  Params (all optional): ``peer=<substr>``, ``match=<substr>`` (RPC type or
  collective tag), ``link=<class>`` (only peers whose registered link class
  — see :func:`set_link_class` — equals this, e.g. ``wan``),
  ``step=<a>-<b>`` (inclusive window; see :func:`set_step`),
  ``p=<float>`` (per-visit probability, default 1), ``after=<n>`` (skip the
  first n eligible visits), ``every=<n>`` (then fire each n-th, default 1),
  ``count=<n>`` (max fires, default unlimited), ``ms=<int>`` (stall/delay
  duration, default 100), ``frac=<float>`` (fraction written before the cut,
  default 0.5), ``rate=<bytes/s>`` + ``bucket=<bytes>`` (throttle token
  bucket: sustained rate and burst size, defaults 1 MiB/s and 64 KiB),
  ``grace=<ms>`` (preempt grace window before hard kill; 0 = defer to the
  ``TORCHFT_DRAIN_GRACE_S`` knob).

  ``preempt`` models a spot/preemptible eviction notice: the seeded
  decision picks *which* visits of a preemption site deliver a SIGTERM,
  and ``grace`` bounds the drain window the victim gets before SIGKILL —
  the same budget k8s grants via ``terminationGracePeriodSeconds``. The
  decision is pure hash like every other kind; the actual signal delivery
  is the caller's job (see ``tools/elastic_drill.py``), keeping the replay
  multiset exact.

  ``throttle`` is special: the seeded decision (after/every/p/count, per
  visit) picks *when a site's bandwidth cap switches on*; from that visit on
  the site is paced by a token bucket without further decisions, so one
  ``chaos_inject`` journal line marks the activation rather than one per
  sub-transfer. Pacing sleeps are wall-clock (like ``stall``); which visits
  activate is hash-only and replays exactly.

  Example — reset the 3rd+ quorum RPC and stall data sends to peer 1::

      TORCHFT_CHAOS="seed:7,spec:reset@ctrl:match=quorum:after=2:count=1;\\
      stall@data:peer=1:ms=250:every=4"

- **Determinism.** Each (rule, site) pair keeps a visit counter; whether a
  visit fires depends only on ``(seed, rule index, site key, visit number)``
  via an FNV-1a-64 site hash folded through splitmix64 — never on wall
  clock, thread interleaving, or a shared RNG stream. Two runs whose sites
  perform the same operation sequence inject the identical fault sequence.
  The C++ mirror (``_cpp/chaos.hpp``) implements the same hash bit-for-bit,
  so engine-side decisions replay too.

- **Zero overhead when off.** ``TORCHFT_CHAOS`` unset parses to a module
  global of ``None``; every hook is a single attribute load + ``is None``
  test.

- **Every injection is journaled** as a ``chaos_inject`` event (kind, plane,
  site, rule, visit, seq) so ``obs_trace.py`` timelines show exactly what
  was injected where, and ``tools/chaos_soak.py`` can compare the sequence
  across same-seed runs.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from torchft_tpu_torch import knobs

__all__ = [
    "ChaosError",
    "ChaosSpecError",
    "Injection",
    "Rule",
    "Chaos",
    "active",
    "init_from_env",
    "reset",
    "set_step",
    "current_step",
    "on_step_change",
    "scope",
    "maybe",
    "maybe_stall",
    "maybe_throttle",
    "check_connect",
    "set_link_class",
    "link_class",
    "backoff_jitter",
]

_M64 = (1 << 64) - 1

KINDS = (
    "connect_refuse",
    "reset",
    "stall",
    "partial_write",
    "rpc_delay",
    "rpc_drop",
    "abort_heal",
    "ckpt_truncate",
    "throttle",
    "preempt",
)

PLANES = ("ctrl", "data", "heal", "srv", "any")


class ChaosError(RuntimeError):
    """Raised *by* an injected fault (e.g. abort_heal). Carries the
    injection so handlers/journals can attribute the failure."""


class ChaosSpecError(ValueError):
    """Malformed TORCHFT_CHAOS value. Raised eagerly at init so a typo'd
    schedule fails the run instead of silently injecting nothing."""


# ----------------------------------------------------------------------
# Deterministic decision hash (mirrored bit-for-bit by _cpp/chaos.hpp)
# ----------------------------------------------------------------------


def fnv1a64(s: str) -> int:
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8", errors="replace"):
        h ^= b
        h = (h * 0x100000001B3) & _M64
    return h


def splitmix64(x: int) -> int:
    z = (x + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def decision_hash(seed: int, rule_idx: int, site_hash: int, visit: int) -> int:
    x = (
        seed
        ^ site_hash
        ^ ((rule_idx * 0x9E3779B97F4A7C15) & _M64)
        ^ ((visit * 0xBF58476D1CE4E5B9) & _M64)
    )
    return splitmix64(x & _M64)


def _hash_unit(h: int) -> float:
    """Top 53 bits of the hash as a float in [0, 1)."""
    return (h >> 11) / float(1 << 53)


# ----------------------------------------------------------------------
# Spec grammar
# ----------------------------------------------------------------------


@dataclass
class Rule:
    kind: str
    plane: str
    index: int = 0
    peer: Optional[str] = None
    match: Optional[str] = None
    link: Optional[str] = None
    step_lo: int = -1
    step_hi: int = 1 << 62
    p: float = 1.0
    after: int = 0
    every: int = 1
    count: Optional[int] = None
    ms: int = 100
    frac: float = 0.5
    rate: int = 1 << 20
    bucket: int = 1 << 16
    grace: int = 0

    def spec(self) -> str:
        """Round-trip the rule back to grammar form (for CHAOS_SOAK.json)."""
        parts = [f"{self.kind}@{self.plane}"]
        if self.peer is not None:
            parts.append(f"peer={self.peer}")
        if self.match is not None:
            parts.append(f"match={self.match}")
        if self.link is not None:
            parts.append(f"link={self.link}")
        if self.step_lo >= 0 or self.step_hi < (1 << 62):
            hi = self.step_hi if self.step_hi < (1 << 62) else ""
            parts.append(f"step={self.step_lo}-{hi}")
        if self.p < 1.0:
            parts.append(f"p={self.p}")
        if self.after:
            parts.append(f"after={self.after}")
        if self.every != 1:
            parts.append(f"every={self.every}")
        if self.count is not None:
            parts.append(f"count={self.count}")
        if self.kind in ("stall", "rpc_delay") or self.ms != 100:
            parts.append(f"ms={self.ms}")
        if self.kind in ("partial_write", "ckpt_truncate") or self.frac != 0.5:
            parts.append(f"frac={self.frac}")
        if self.kind == "throttle" or self.rate != (1 << 20):
            parts.append(f"rate={self.rate}")
        if self.kind == "throttle" or self.bucket != (1 << 16):
            parts.append(f"bucket={self.bucket}")
        if self.grace != 0:
            parts.append(f"grace={self.grace}")
        return ":".join(parts)


def parse_rule(text: str, index: int) -> Rule:
    head, *params = [p for p in text.strip().split(":") if p != ""]
    if "@" not in head:
        raise ChaosSpecError(f"rule '{text}': expected <kind>@<plane>")
    kind, _, plane = head.partition("@")
    if kind not in KINDS:
        raise ChaosSpecError(f"rule '{text}': unknown kind '{kind}' (have {KINDS})")
    if plane not in PLANES:
        raise ChaosSpecError(f"rule '{text}': unknown plane '{plane}' (have {PLANES})")
    r = Rule(kind=kind, plane=plane, index=index)
    for p in params:
        if "=" not in p:
            raise ChaosSpecError(f"rule '{text}': bad param '{p}' (expected k=v)")
        k, _, v = p.partition("=")
        try:
            if k == "peer":
                r.peer = v
            elif k == "match":
                r.match = v
            elif k == "link":
                r.link = v
            elif k == "step":
                lo, _, hi = v.partition("-")
                r.step_lo = int(lo) if lo else 0
                r.step_hi = int(hi) if hi else (1 << 62)
            elif k == "p":
                r.p = float(v)
                if not (0.0 <= r.p <= 1.0):
                    raise ValueError("p outside [0,1]")
            elif k == "after":
                r.after = int(v)
            elif k == "every":
                r.every = max(1, int(v))
            elif k == "count":
                r.count = int(v)
            elif k == "ms":
                r.ms = int(v)
            elif k == "frac":
                r.frac = float(v)
                if not (0.0 <= r.frac <= 1.0):
                    raise ValueError("frac outside [0,1]")
            elif k == "rate":
                r.rate = int(v)
                if r.rate <= 0:
                    raise ValueError("rate must be > 0")
            elif k == "bucket":
                r.bucket = int(v)
                if r.bucket <= 0:
                    raise ValueError("bucket must be > 0")
            elif k == "grace":
                r.grace = int(v)
                if r.grace < 0:
                    raise ValueError("grace must be >= 0")
            else:
                raise ValueError(f"unknown param '{k}'")
        except ChaosSpecError:
            raise
        except Exception as e:
            raise ChaosSpecError(f"rule '{text}': param '{p}': {e}") from e
    return r


def parse_spec(value: str) -> Tuple[int, List[Rule]]:
    """Parses a full ``TORCHFT_CHAOS`` value into (seed, rules)."""
    value = value.strip()
    if not value.startswith("seed:"):
        raise ChaosSpecError("TORCHFT_CHAOS must start with 'seed:<int>,spec:'")
    rest = value[len("seed:"):]
    seed_str, sep, spec = rest.partition(",")
    if not sep or not spec.startswith("spec:"):
        raise ChaosSpecError("TORCHFT_CHAOS must be 'seed:<int>,spec:<rules>'")
    try:
        seed = int(seed_str) & _M64
    except ValueError as e:
        raise ChaosSpecError(f"bad seed '{seed_str}'") from e
    spec = spec[len("spec:"):]
    rules = []
    for i, rtext in enumerate(t for t in spec.split(";") if t.strip()):
        rules.append(parse_rule(rtext, i))
    if not rules:
        raise ChaosSpecError("TORCHFT_CHAOS spec has no rules")
    return seed, rules


# ----------------------------------------------------------------------
# Runtime state
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class Injection:
    """What a hook should do; returned by :func:`maybe` when a rule fires."""

    kind: str
    plane: str
    site: str
    rule: int
    visit: int
    seq: int
    ms: int
    frac: float
    rate: int = 0
    bucket: int = 0
    grace: int = 0

    def __str__(self) -> str:
        return (
            f"chaos[{self.seq}] {self.kind}@{self.plane} site={self.site} "
            f"rule={self.rule} visit={self.visit}"
        )


class _TokenBucket:
    """Wall-clock token bucket pacing an activated throttle site. Lives in
    the hook layer, not the decision layer: *which* visit activates a
    throttle is hash-only, *how long* a paced write sleeps is not part of
    the replayed injection sequence (like a stall's sleep duration)."""

    # Cap per-call sleeps so one huge buffered write can't wedge a
    # deadline-driven transfer for longer than a stall rule could.
    MAX_SLEEP_S = 2.0

    def __init__(self, rate: int, bucket: int) -> None:
        self.rate = max(1, int(rate))  # bytes/second sustained
        self.cap = max(1, int(bucket))  # burst bytes
        self._tokens = float(self.cap)
        self._t_last = time.monotonic()
        self._lock = threading.Lock()

    def consume(self, nbytes: int) -> float:
        """Takes ``nbytes`` tokens; returns seconds the caller must sleep."""
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                float(self.cap), self._tokens + (now - self._t_last) * self.rate
            )
            self._t_last = now
            self._tokens -= float(nbytes)
            if self._tokens >= 0.0:
                return 0.0
            return min(-self._tokens / self.rate, self.MAX_SLEEP_S)


class Chaos:
    """Seeded schedule state: per-(rule, site) visit counters + fire log."""

    def __init__(self, seed: int, rules: List[Rule]) -> None:
        self.seed = seed & _M64
        self.rules = rules
        self._lock = threading.Lock()
        self._visits: Dict[Tuple[int, str], int] = {}
        self._fired: Dict[int, int] = {}
        self._seq = 0
        self._site_hash: Dict[str, int] = {}
        self._buckets: Dict[str, _TokenBucket] = {}  # site -> active throttle
        # Serializes throttle activation (check + pick + create) per process
        # so concurrent hooks at one site produce a deterministic number of
        # activation visits — the journal replays bit-for-bit.
        self._throttle_lock = threading.Lock()

    def spec(self) -> str:
        body = ";".join(r.spec() for r in self.rules)
        return f"seed:{self.seed},spec:{body}"

    def _rule_fires(self, r: Rule, site: str, visit: int) -> bool:
        if visit < r.after:
            return False
        k = visit - r.after
        if k % r.every != 0:
            return False
        if r.count is not None and self._fired.get(r.index, 0) >= r.count:
            return False
        if r.p < 1.0:
            sh = self._site_hash.get(site)
            if sh is None:
                sh = self._site_hash[site] = fnv1a64(site)
            h = decision_hash(self.seed, r.index, sh, visit)
            if _hash_unit(h) >= r.p:
                return False
        return True

    def pick(
        self,
        kind: str,
        plane: str,
        site: str,
        peer: Optional[str] = None,
        match: Optional[str] = None,
        step: Optional[int] = None,
    ) -> Optional[Injection]:
        """One eligible visit at ``site``: bumps the visit counter of every
        rule matching (kind, plane, peer, match, step) and returns an
        :class:`Injection` for the first rule that fires, else None."""
        if step is None:
            step = current_step()
        inj: Optional[Injection] = None
        # Lock-free pre-scan (rules are immutable once installed): a visit
        # no rule can match moves no counters, so skip the lock — armed
        # schedules scoped to one peer/RPC stay free for everything else.
        if not any(
            r.kind == kind
            and (r.plane == "any" or r.plane == plane)
            and (r.peer is None or (peer is not None and r.peer in peer))
            and (r.match is None or (match is not None and r.match in match))
            and (
                r.link is None
                or (peer is not None and _LINK_CLASSES.get(peer) == r.link)
            )
            and (
                r.step_lo < 0
                or (step is not None and r.step_lo <= step <= r.step_hi)
            )
            for r in self.rules
        ):
            return None
        with self._lock:
            for r in self.rules:
                if r.kind != kind:
                    continue
                if r.plane != "any" and r.plane != plane:
                    continue
                if r.peer is not None and (peer is None or r.peer not in peer):
                    continue
                if r.match is not None and (match is None or r.match not in match):
                    continue
                if r.link is not None and (
                    peer is None or _LINK_CLASSES.get(peer) != r.link
                ):
                    continue
                if r.step_lo >= 0:  # windowed rule: needs a known step
                    if step is None or not (r.step_lo <= step <= r.step_hi):
                        continue
                key = (r.index, site)
                visit = self._visits.get(key, 0)
                self._visits[key] = visit + 1
                if inj is None and self._rule_fires(r, site, visit):
                    self._fired[r.index] = self._fired.get(r.index, 0) + 1
                    self._seq += 1
                    inj = Injection(
                        kind=kind,
                        plane=plane,
                        site=site,
                        rule=r.index,
                        visit=visit,
                        seq=self._seq,
                        ms=r.ms,
                        frac=r.frac,
                        rate=r.rate if r.kind == "throttle" else 0,
                        bucket=r.bucket if r.kind == "throttle" else 0,
                        grace=r.grace if r.kind == "preempt" else 0,
                    )
        if inj is not None:
            self._journal(inj, peer=peer, match=match, step=step)
        return inj

    def _journal(
        self,
        inj: Injection,
        peer: Optional[str],
        match: Optional[str],
        step: Optional[int],
    ) -> None:
        try:
            from . import telemetry

            log = telemetry.get_event_log()
            if log is not None:
                log.emit(
                    "chaos_inject",
                    step=step,
                    kind=inj.kind,
                    plane=inj.plane,
                    site=inj.site,
                    rule=inj.rule,
                    visit=inj.visit,
                    seq=inj.seq,
                    ms=inj.ms,
                    frac=inj.frac,
                    rate=inj.rate,
                    bucket=inj.bucket,
                    grace=inj.grace,
                    peer=peer,
                    match=match,
                )
        except Exception:
            pass  # chaos must never break the path it injects into

    def throttle_delay(
        self,
        plane: str,
        site: str,
        nbytes: int,
        peer: Optional[str] = None,
        match: Optional[str] = None,
        step: Optional[int] = None,
    ) -> float:
        """Seconds this I/O must sleep under an active throttle (0 when the
        site has no active bucket and no throttle rule fires this visit)."""
        b = self._buckets.get(site)
        if b is None:
            with self._throttle_lock:
                b = self._buckets.get(site)
                if b is None:
                    inj = self.pick(
                        "throttle", plane, site, peer=peer, match=match,
                        step=step,
                    )
                    if inj is None:
                        return 0.0
                    b = self._buckets[site] = _TokenBucket(
                        inj.rate, inj.bucket
                    )
        return b.consume(nbytes)

    def injections_fired(self) -> int:
        with self._lock:
            return self._seq


# Module global consulted by every hook: None == chaos off (the fast path).
_STATE: Optional[Chaos] = None
_INIT_LOCK = threading.Lock()
_INITED = False

# Peer -> link class ("local"/"dcn"/"wan"), fed by the process group from
# TORCHFT_LINKS so `link=<class>` rules can scope faults to a whole class of
# links without enumerating peers. Plain dict: writes happen at configure
# time, reads are GIL-atomic lookups on the hook path.
_LINK_CLASSES: Dict[str, str] = {}

_GLOBAL_STEP: Optional[int] = None
_STEP_LISTENERS: List[Callable[[int], None]] = []

_TLS = threading.local()  # .ctx: (plane, peer, match) for _net-level hooks


def init_from_env(force: bool = False) -> Optional[Chaos]:
    """Parses ``TORCHFT_CHAOS`` once and installs the module state.
    Subsequent calls are no-ops unless ``force``."""
    global _STATE, _INITED
    with _INIT_LOCK:
        if _INITED and not force:
            return _STATE
        value = knobs.get_str("TORCHFT_CHAOS")
        if value:
            seed, rules = parse_spec(value)
            _STATE = Chaos(seed, rules)
        else:
            _STATE = None
        _INITED = True
        return _STATE


def active() -> Optional[Chaos]:
    """The installed schedule, initialising from env on first call.
    Hot paths read ``chaos._STATE`` directly after the first call."""
    if not _INITED:
        return init_from_env()
    return _STATE


def reset() -> None:
    """Forgets the installed schedule, step and link classes (tests)."""
    global _STATE, _INITED, _GLOBAL_STEP
    with _INIT_LOCK:
        _STATE = None
        _INITED = False
        _GLOBAL_STEP = None
        _STEP_LISTENERS.clear()
        _LINK_CLASSES.clear()


def install(seed: int, rules: List[Rule]) -> Chaos:
    """Installs a schedule programmatically (tests)."""
    global _STATE, _INITED
    with _INIT_LOCK:
        _STATE = Chaos(seed, rules)
        _INITED = True
        return _STATE


# ----------------------------------------------------------------------
# Step scoping
# ----------------------------------------------------------------------


def set_step(step: int) -> None:
    """Pins the current training step for ``step=a-b`` rule windows. Called
    by the Manager at quorum compute; listeners (the native engine mirror)
    are notified so C++-side rules stay in the same window."""
    global _GLOBAL_STEP
    _GLOBAL_STEP = int(step)
    for cb in list(_STEP_LISTENERS):
        try:
            cb(_GLOBAL_STEP)
        except Exception:
            pass


def current_step() -> Optional[int]:
    return _GLOBAL_STEP


def on_step_change(cb: Callable[[int], None]) -> None:
    """Registers a listener invoked from :func:`set_step` (e.g.
    ProcessGroupNative forwarding the step into the C++ chaos mirror)."""
    if cb not in _STEP_LISTENERS:
        _STEP_LISTENERS.append(cb)


# ----------------------------------------------------------------------
# Link classes (TORCHFT_LINKS -> `link=<class>` rule scoping)
# ----------------------------------------------------------------------


def set_link_class(peer: str, cls: str) -> None:
    """Tags ``peer`` (rank string or "host:port") with a link class so
    ``link=<class>`` rules apply to it. The process group calls this from
    its TORCHFT_LINKS policy at configure time; the native mirror is fed
    separately through ``tft_chaos_set_link``."""
    _LINK_CLASSES[str(peer)] = str(cls)


def link_class(peer: str) -> Optional[str]:
    return _LINK_CLASSES.get(str(peer))


# ----------------------------------------------------------------------
# TLS scope for _net.py-level hooks
# ----------------------------------------------------------------------


@contextlib.contextmanager
def scope(
    plane: str, peer: Optional[str] = None, match: Optional[str] = None
) -> Iterator[None]:
    """Attributes low-level ``_net`` I/O inside the block to (plane, peer,
    match) — lets ``_net.connect``/``send_frame`` consult chaos without
    changing their signatures. No-scope I/O is never injected."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (plane, peer, match)
    try:
        yield
    finally:
        _TLS.ctx = prev


def _scope_ctx() -> Optional[Tuple[str, Optional[str], Optional[str]]]:
    return getattr(_TLS, "ctx", None)


# ----------------------------------------------------------------------
# Hook helpers
# ----------------------------------------------------------------------


def maybe(
    kind: str,
    plane: str,
    site: str,
    peer: Optional[str] = None,
    match: Optional[str] = None,
    step: Optional[int] = None,
) -> Optional[Injection]:
    """The universal hook: None when chaos is off or no rule fires."""
    st = active()
    if st is None:
        return None
    return st.pick(kind, plane, site, peer=peer, match=match, step=step)


def maybe_stall(
    plane: str,
    site: str,
    peer: Optional[str] = None,
    match: Optional[str] = None,
) -> Optional[Injection]:
    """Stall hook: sleeps ``ms`` when a stall rule fires."""
    inj = maybe("stall", plane, site, peer=peer, match=match)
    if inj is not None:
        time.sleep(inj.ms / 1000.0)
    return inj


def maybe_throttle(
    plane: str,
    site: str,
    nbytes: int,
    peer: Optional[str] = None,
    match: Optional[str] = None,
) -> None:
    """Throttle hook: paces ``nbytes`` of I/O at ``site`` when a throttle
    rule has activated a token bucket there (sleeping as needed)."""
    st = active()
    if st is None:
        return
    delay = st.throttle_delay(plane, site, nbytes, peer=peer, match=match)
    if delay > 0.0:
        time.sleep(delay)


def check_connect(plane: str, peer: str) -> None:
    """Connect hook: raises ConnectionRefusedError when a connect_refuse
    rule fires for this peer."""
    inj = maybe("connect_refuse", plane, f"connect:{peer}", peer=peer)
    if inj is not None:
        raise ConnectionRefusedError(f"[chaos] connection refused: {inj}")


def backoff_jitter(key: str, attempt: int, cap_s: float) -> float:
    """Seeded full-jitter backoff delay in ``[0, cap_s)``.

    Deterministic in ``(chaos seed, key, attempt)`` via the same
    splitmix64/FNV-1a fold as the decision hash (seed 0 when no schedule is
    installed), so mass reconnects after a partition heal de-stampede
    without breaking same-seed chaos replay. Mirrored bit-for-bit by
    ``backoff_unit`` in ``_cpp/chaos.cc``."""
    st = active()
    seed = st.seed if st is not None else 0
    h = splitmix64(
        (seed ^ fnv1a64(key) ^ ((attempt * 0x9E3779B97F4A7C15) & _M64)) & _M64
    )
    return _hash_unit(h) * cap_s
