"""Flight-recorder tracing: zero-cost-when-off spans → Chrome trace JSON.

The port's own copy of ``distkeras_tpu/observability/trace.py`` (pure
Python, the same event shapes and file format). Every interesting section of the
PS exchange, WAL, elastic-membership, and serving stacks opens a *span*
here, and a run with tracing enabled writes one Chrome-trace-event JSON
file loadable in Perfetto (https://ui.perfetto.dev) where a single fused
EXCHANGE stitches across the worker thread, the PS handler, the WAL
flusher, the chain replica, and the C++ native server into one timeline.

Design constraints, in order:

1. **Zero cost when off.** Tracing is off by default and the hot paths
   (worker window loop, PS fold, serving decode step) call into this
   module unconditionally — so the off path must be one module-global
   read plus a no-op. ``span()`` returns a shared no-op context manager
   singleton, ``record``/``set_corr``/``instant`` return immediately:
   no allocation, no locks, no clock reads (the off-mode
   allocation-freeness is pinned by test).
2. **Cheap when on.** Events land in per-thread ring buffers (no lock on
   the record path; the only lock is one registration per thread) as
   plain tuples; ring overflow drops the OLDEST events (a flight
   recorder keeps the recent past). Timestamps are
   ``time.perf_counter_ns()`` — CLOCK_MONOTONIC on Linux, the SAME clock
   the native ``dkps.cpp`` span ring uses (``clock_gettime(
   CLOCK_MONOTONIC)``), so scraped C++ spans and Python spans share one
   timebase within a host without any offset arithmetic.
3. **Correlation.** A span records the *correlation id* in effect on its
   thread when it CLOSES (or an explicit ``corr=``). The worker loop
   sets ``w<id>:x<n>`` per window, the resilient client overrides with
   ``w<id>:s<seq>`` when it assigns the commit seqno (the id the wire
   actually carries), the socket client stamps the current corr into the
   request frame, and the PS handler adopts the frame's corr — so the
   worker-side exchange span and the PS-side fold/WAL-append spans share
   one id across threads, processes, and (via the seqno) the C++ wire.
4. **One clock with the device trace.** ``torch.profiler``'s Chrome
   traces stamp events on Unix time (``ts`` µs + ``baseTimeNanoseconds``).
   ``enable()`` reads ``time.time_ns()`` against ``perf_counter_ns()``
   back to back and keeps the difference,
   :func:`unix_minus_monotonic_ns`; a span's ``t0_ns`` plus it is Unix
   time, and :func:`clock_drift_ns` reads the difference again, so that
   drift between the two clocks shows. ``save()`` writes both into
   ``otherData``, so a timeline file lines up with a profiler trace.

Sampling: ``enable(sample=0.1)`` keeps a deterministic ~10% of spans
(counter-based, per thread — no RNG on the hot path). ``corr``
propagation is never sampled out, only span recording is.
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time
from typing import Any

__all__ = [
    "enable", "disable", "enabled", "span", "record", "instant",
    "counter", "set_corr", "current_corr", "add_events", "events",
    "save", "rotate_files", "dropped_spans", "live_dropped",
    "unix_minus_monotonic_ns", "clock_drift_ns",
]

#: category marking a ring entry as a sampled counter value rather than
#: a span — ``save()`` renders these as Chrome ``ph: "C"`` counter
#: tracks (Perfetto draws them as graphs alongside the spans)
COUNTER_CAT = "__counter__"

#: module-global tracer; ``None`` = disabled (the one read every
#: call-site pays when tracing is off)
_tracer = None

#: spans lost to ring overflow by recorders that have since been
#: disabled — ``dropped_spans()`` stays a process-lifetime counter so
#: the metrics surface never un-counts an overflow by turning tracing
#: off (the overflow being SILENT was the bug)
_dropped_retired = 0


class _NoopSpan:
    """Shared do-nothing context manager returned while tracing is off
    (and for sampled-out spans): entering/exiting allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    # a staticmethod: ``with`` holds the looked-up ``__exit__`` for the
    # whole block, and a plain method would be a bound-method object
    # allocated at every call site
    @staticmethod
    def __exit__(exc_type, exc, tb):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    """One live span: records ``(t_enter, t_exit)`` into the thread's
    ring on exit. Corr resolution: an explicit ``corr=`` wins; otherwise
    the thread's corr at CLOSE time — a span that wraps a wire call
    inherits the id the client assigned inside it (see module doc)."""

    __slots__ = ("_tr", "name", "cat", "corr", "args", "t0")

    def __init__(self, tr, name, cat, corr, args):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.corr = corr
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter_ns()
        tr = self._tr
        st = tr._state()
        corr = self.corr if self.corr is not None else st.corr
        tr._record(st, self.name, self.cat, corr, self.t0, t1 - self.t0,
                   self.args)
        return False


class _ThreadState:
    """Per-thread recorder state (ring + corr + sampling counter)."""

    __slots__ = ("ring", "idx", "corr", "n_seen", "tid", "tname")

    def __init__(self, cap: int):
        self.ring: list = [None] * cap
        self.idx = 0          # total events recorded (ring head = idx-1)
        self.corr: str | None = None
        self.n_seen = 0       # sampling counter (spans offered)
        self.tid = threading.get_native_id()
        self.tname = threading.current_thread().name


class Tracer:
    """The enabled-state recorder. Use the module functions; this class
    is public only so tests can poke at ring internals."""

    def __init__(self, ring_size: int = 65536, sample: float = 1.0):
        if ring_size < 16:
            raise ValueError(f"ring_size must be >= 16, got {ring_size}")
        if not 0.0 < sample <= 1.0:
            raise ValueError(f"sample must be in (0, 1], got {sample}")
        self.ring_size = int(ring_size)
        self.sample = float(sample)
        self._tls = threading.local()
        self._states: list[_ThreadState] = []
        self._reg_lock = threading.Lock()
        # foreign events merged in by scrapers (the native dkps ring, a
        # peer process's snapshot): already-shaped dicts, see add_events
        self._foreign: list[dict] = []
        self.unix_offset_ns = _unix_minus_monotonic()

    def _state(self) -> _ThreadState:
        st = getattr(self._tls, "st", None)
        if st is None:
            st = self._tls.st = _ThreadState(self.ring_size)
            with self._reg_lock:
                self._states.append(st)
        return st

    def _record(self, st: _ThreadState, name, cat, corr, t0, dur, args,
                sampled: bool = True):
        if sampled and self.sample < 1.0:
            st.n_seen += 1
            # deterministic counter sampling: record iff the scaled
            # counter crossed an integer — exactly ~sample of spans,
            # no RNG, no per-thread drift
            if int(st.n_seen * self.sample) == int(
                    (st.n_seen - 1) * self.sample):
                return
        st.ring[st.idx % self.ring_size] = (name, cat, corr, t0, dur, args)
        st.idx += 1

    def add_events(self, evs: list[dict]) -> None:
        with self._reg_lock:
            self._foreign.extend(evs)

    def events(self, min_end_ns: int | None = None) -> list[dict]:
        """Every recorded event as a list of dicts (oldest first per
        thread), merged across threads + foreign sources and sorted by
        start time. Keys: name, cat, corr, t0_ns, dur_ns, tid, tname,
        args. ``min_end_ns`` keeps only events that END after it — the
        incremental-consumer filter (RegimeTracker): entries land in
        the ring at span CLOSE, so an end-time cursor never permanently
        misses a long span whose START predates shorter spans already
        observed, and stale entries are skipped as raw tuples (no dict
        built, nothing sorted for them)."""
        out = []
        with self._reg_lock:
            states = list(self._states)
            foreign = list(self._foreign)
        for st in states:
            n = min(st.idx, self.ring_size)
            start = st.idx - n
            for k in range(start, st.idx):
                ev = st.ring[k % self.ring_size]
                if ev is None:
                    continue
                name, cat, corr, t0, dur, args = ev
                if min_end_ns is not None and t0 + dur <= min_end_ns:
                    continue
                out.append({
                    "name": name, "cat": cat, "corr": corr,
                    "t0_ns": t0, "dur_ns": dur,
                    "tid": st.tid, "tname": st.tname, "args": args,
                })
        if min_end_ns is not None:
            out.extend(e for e in foreign
                       if e["t0_ns"] + e["dur_ns"] > min_end_ns)
        else:
            out.extend(foreign)
        out.sort(key=lambda e: e["t0_ns"])
        return out

    def dropped(self) -> int:
        """Events lost to ring overflow (flight-recorder semantics:
        oldest dropped first), totalled across threads."""
        with self._reg_lock:
            states = list(self._states)
        return sum(max(0, st.idx - self.ring_size) for st in states)


def _unix_minus_monotonic() -> int:
    """``time.time_ns()`` less ``perf_counter_ns()``, the monotonic read
    taken as the mean of the two around the wall-clock one."""
    a = time.perf_counter_ns()
    u = time.time_ns()
    b = time.perf_counter_ns()
    return u - (a + b) // 2


def unix_minus_monotonic_ns() -> int | None:
    """What to add to a span's ``t0_ns`` for Unix time in ns, the clock
    of ``torch.profiler``'s traces: read at ``enable()``. None when
    off."""
    tr = _tracer
    return None if tr is None else tr.unix_offset_ns


def clock_drift_ns() -> int | None:
    """How far the Unix-minus-monotonic difference has moved since
    ``enable()``, read now (NTP slews the wall clock). None when off."""
    tr = _tracer
    if tr is None:
        return None
    return _unix_minus_monotonic() - tr.unix_offset_ns


def enabled() -> bool:
    return _tracer is not None


def enable(ring_size: int = 65536, sample: float = 1.0) -> Tracer:
    """Turn tracing on (idempotent: an already-enabled tracer is kept —
    nested enables from a caller inside a traced trainer must not
    discard the outer recorder's rings)."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer(ring_size=ring_size, sample=sample)
    return _tracer


def disable() -> None:
    """Turn tracing off and discard the recorder (hot paths return to
    the one-global-read no-op). The recorder's overflow count retires
    into the process-lifetime ``dropped_spans()`` counter first."""
    global _tracer, _dropped_retired
    if _tracer is not None:
        _dropped_retired += _tracer.dropped()
    _tracer = None


def dropped_spans() -> int:
    """Process-lifetime spans lost to ring overflow (drop-oldest),
    across every recorder this process has run — the
    ``trace_dropped_spans`` counter on the metrics surface. 0 while
    nothing ever overflowed; monotone otherwise."""
    tr = _tracer
    live = tr.dropped() if tr is not None else 0
    return _dropped_retired + live


def live_dropped() -> int:
    """Spans the CURRENT recorder lost to overflow (0 when off) — the
    analyzer's degraded-verdict input: a past run's retired overflow
    must not degrade this run's analysis."""
    tr = _tracer
    return tr.dropped() if tr is not None else 0


def span(name: str, cat: str = "", corr: str | None = None,
         args: dict | None = None):
    """Open a span: ``with trace.span("ps.fold"): ...``. Returns the
    shared no-op singleton when tracing is off — the off-mode call is
    allocation-free."""
    tr = _tracer
    if tr is None:
        return _NOOP_SPAN
    return _Span(tr, name, cat, corr, args)


def record(name: str, t0_ns: int, t1_ns: int, cat: str = "",
           corr: str | None = None, args: dict | None = None) -> None:
    """Record a completed span retroactively from two timestamps the
    caller already took (the worker phase histograms' path: they clock
    with ``perf_counter`` anyway, so tracing adds no extra clock reads).
    No-op when off."""
    tr = _tracer
    if tr is None:
        return
    st = tr._state()
    tr._record(st, name, cat, corr if corr is not None else st.corr,
               t0_ns, t1_ns - t0_ns, args)


def instant(name: str, cat: str = "", corr: str | None = None,
            args: dict | None = None) -> None:
    """Record a point event (zero-duration span). No-op when off."""
    tr = _tracer
    if tr is None:
        return
    st = tr._state()
    t = time.perf_counter_ns()
    tr._record(st, name, cat, corr if corr is not None else st.corr,
               t, 0, args)


def counter(name: str, value, t_ns: int | None = None) -> None:
    """Record one counter sample: ``save()`` emits
    these as Chrome ``ph: "C"`` counter-track records so sampled gauges
    — DynSGD τ p95, shm ring occupancy, serving rows in flight — render
    as graphs alongside the spans in Perfetto. Never sampled out
    (a decimated counter track lies about its own shape); no-op when
    tracing is off."""
    tr = _tracer
    if tr is None:
        return
    st = tr._state()
    t = time.perf_counter_ns() if t_ns is None else int(t_ns)
    tr._record(st, name, COUNTER_CAT, None, t, 0, float(value),
               sampled=False)


def set_corr(corr: str | None) -> None:
    """Set this thread's correlation id; spans without an explicit
    ``corr=`` record whatever is in effect when they close. No-op when
    off (corr is only consumed by recording)."""
    tr = _tracer
    if tr is None:
        return
    tr._state().corr = corr


def current_corr() -> str | None:
    """This thread's correlation id (None when off/unset) — the socket
    client reads it to stamp outgoing commit/exchange frames."""
    tr = _tracer
    if tr is None:
        return None
    return tr._state().corr


def add_events(evs: list[dict]) -> None:
    """Merge foreign pre-shaped events (the native dkps span ring, a
    peer process's ``events()`` snapshot). Each dict needs ``name``,
    ``t0_ns``, ``dur_ns``; ``cat``/``corr``/``tid``/``tname``/``args``
    are optional. No-op when off."""
    tr = _tracer
    if tr is None:
        return
    shaped = []
    for e in evs:
        shaped.append({
            "name": e["name"], "cat": e.get("cat", ""),
            "corr": e.get("corr"), "t0_ns": int(e["t0_ns"]),
            "dur_ns": int(e.get("dur_ns", 0)),
            "tid": e.get("tid", 0),
            "tname": e.get("tname", "foreign"), "args": e.get("args"),
        })
    tr.add_events(shaped)


def events(min_end_ns: int | None = None) -> list[dict]:
    """All recorded events (see :meth:`Tracer.events`); ``[]`` when
    off. ``min_end_ns`` is the incremental consumer's cursor filter."""
    tr = _tracer
    if tr is None:
        return []
    return tr.events(min_end_ns)


def open_maybe_gz(path: str):
    """Open a JSON document that may be gzipped — sniffed by magic
    bytes, not suffix, so rotated/renamed files read transparently.
    Shared by every observability reader (trace analysis, the
    timeseries store, the CLI)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path)


def load_json_maybe_gz(path: str) -> dict:
    with open_maybe_gz(path) as f:
        return json.load(f)


def rotate_files(path: str, max_bytes: int, keep: int = 3) -> None:
    """Size-capped rotation: when ``path`` already
    holds ``max_bytes`` or more, shift ``path`` → ``path.1`` →
    ``path.2`` … keeping at most ``keep`` rotated generations — a long
    watched run re-saving its timeline keeps bounded history instead of
    growing one file forever (or silently overwriting it)."""
    if keep < 1 or not os.path.exists(path) \
            or os.path.getsize(path) < max_bytes:
        return
    oldest = f"{path}.{keep}"
    if os.path.exists(oldest):
        os.remove(oldest)
    for k in range(keep - 1, 0, -1):
        src = f"{path}.{k}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{k + 1}")
    os.replace(path, f"{path}.1")


def save(path: str, max_bytes: int | None = None, keep: int = 3) -> str:
    """Write everything recorded so far as Chrome trace-event JSON
    (``{"traceEvents": [...]}``, complete-event ``ph: "X"`` records with
    µs timestamps, counter samples as ``ph: "C"`` tracks) — drag the
    file into https://ui.perfetto.dev or ``chrome://tracing``. A path
    ending in ``.gz`` is gzip-compressed (the long-run growth fix;
    ``dump``/``analyze`` read both formats transparently), and
    ``max_bytes`` rotates an existing file first (see
    :func:`rotate_files`). ``otherData`` carries the dropped-span count,
    this host's core count — the analyzer's host-honest denominator —
    and the clocks' difference at ``enable()``
    (``unix_minus_monotonic_ns``) with its drift since, read at the save
    (``clock_drift_ns``). Parent directories are created. Returns ``path``.
    Raises RuntimeError when tracing is off (nothing to save — a silent
    empty file would read as "traced, nothing happened")."""
    tr = _tracer
    if tr is None:
        raise RuntimeError("tracing is not enabled: nothing to save")
    evs = tr.events()
    pid = os.getpid()
    out: list[dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "distkeras_tpu_torch"},
    }]
    seen_tids: set = set()
    for e in evs:
        if e["tid"] not in seen_tids:
            seen_tids.add(e["tid"])
            out.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": e["tid"], "args": {"name": e["tname"]},
            })
        if e["cat"] == COUNTER_CAT:
            out.append({
                "name": e["name"], "ph": "C", "ts": e["t0_ns"] / 1e3,
                "pid": pid, "tid": e["tid"],
                "args": {"value": e["args"]},
            })
            continue
        args = dict(e["args"]) if e["args"] else {}
        if e["corr"] is not None:
            args["corr"] = e["corr"]
        out.append({
            "name": e["name"], "cat": e["cat"] or "dk", "ph": "X",
            "ts": e["t0_ns"] / 1e3, "dur": e["dur_ns"] / 1e3,
            "pid": pid, "tid": e["tid"], "args": args,
        })
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    if max_bytes is not None:
        rotate_files(path, int(max_bytes), keep=keep)
    doc = {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "dropped_events": tr.dropped(),
            "host_cores": os.cpu_count() or 1,
            "unix_minus_monotonic_ns": tr.unix_offset_ns,
            "clock_drift_ns": clock_drift_ns(),
        },
    }
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(doc, f)
    return path
