"""Flight-recorder tracing: zero-cost-when-off spans → Chrome trace JSON.

The port's own copy of ``distkeras_tpu/observability/trace.py`` (pure
Python). The parameter server and the worker threads open spans here; a
run with tracing on writes one Chrome trace-event JSON file loadable in
Perfetto (https://ui.perfetto.dev), where one exchange stitches across the
worker thread and the PS handler by its correlation id.

1. **Zero cost when off.** ``span()`` returns a shared no-op context
   manager, ``record``/``set_corr``/``instant`` return at once: one
   module-global read, no allocation, no lock, no clock read.
2. **Cheap when on.** Events land in per-thread ring buffers as plain
   tuples (no lock on the record path); overflow drops the oldest.
   Timestamps are ``time.perf_counter_ns()``.
3. **Correlation.** A span records the correlation id in effect on its
   thread when it closes (or an explicit ``corr=``). The worker loop sets
   ``w<id>:x<n>`` per window, the socket client stamps it into the request
   frame and the PS handler adopts it.

Sampling: ``enable(sample=0.1)`` keeps a deterministic ~10% of spans
(counter-based, per thread). Correlation is never sampled out.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

__all__ = ["enable", "disable", "enabled", "span", "record", "instant",
           "counter", "set_corr", "current_corr", "events", "save"]

#: category marking a ring entry as a sampled counter value rather than a
#: span; ``save()`` renders these as Chrome ``ph: "C"`` counter tracks
COUNTER_CAT = "__counter__"

#: the module-global tracer; ``None`` = disabled (the one read every
#: call site pays when tracing is off)
_tracer = None


class _NoopSpan:
    """Shared do-nothing context manager returned while tracing is off
    (and for sampled-out spans): entering and exiting allocate nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    """One live span: records ``(t_enter, t_exit)`` into the thread's ring
    on exit, with an explicit ``corr=`` or else the thread's corr at close
    time (a span around a wire call inherits the id assigned inside it)."""

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
    """Per-thread recorder state (ring, corr, sampling counter)."""

    __slots__ = ("ring", "idx", "corr", "n_seen", "tid", "tname")

    def __init__(self, cap: int):
        self.ring: list = [None] * cap
        self.idx = 0          # events recorded (ring head = idx - 1)
        self.corr: str | None = None
        self.n_seen = 0       # sampling counter (spans offered)
        self.tid = threading.get_native_id()
        self.tname = threading.current_thread().name


class Tracer:
    """The enabled-state recorder. Use the module functions."""

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
            # deterministic counter sampling: record iff the scaled counter
            # crossed an integer (no RNG, no per-thread drift)
            if int(st.n_seen * self.sample) == int(
                    (st.n_seen - 1) * self.sample):
                return
        st.ring[st.idx % self.ring_size] = (name, cat, corr, t0, dur, args)
        st.idx += 1

    def events(self) -> list[dict]:
        """Every recorded event (oldest first per thread), merged across
        threads and sorted by start: dicts with name, cat, corr, t0_ns,
        dur_ns, tid, tname, args."""
        with self._reg_lock:
            states = list(self._states)
        out = []
        for st in states:
            for k in range(st.idx - min(st.idx, self.ring_size), st.idx):
                ev = st.ring[k % self.ring_size]
                if ev is None:
                    continue
                name, cat, corr, t0, dur, args = ev
                out.append({"name": name, "cat": cat, "corr": corr,
                            "t0_ns": t0, "dur_ns": dur, "tid": st.tid,
                            "tname": st.tname, "args": args})
        out.sort(key=lambda e: e["t0_ns"])
        return out

    def dropped(self) -> int:
        """Events lost to ring overflow (oldest dropped first)."""
        with self._reg_lock:
            states = list(self._states)
        return sum(max(0, st.idx - self.ring_size) for st in states)


def enabled() -> bool:
    return _tracer is not None


def enable(ring_size: int = 65536, sample: float = 1.0) -> Tracer:
    """Turn tracing on (idempotent: an enabled tracer is kept)."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer(ring_size=ring_size, sample=sample)
    return _tracer


def disable() -> None:
    """Turn tracing off and discard the recorder."""
    global _tracer
    _tracer = None


def span(name: str, cat: str = "", corr: str | None = None,
         args: dict | None = None):
    """Open a span: ``with trace.span("ps.fold"): ...``. The shared no-op
    singleton when tracing is off."""
    tr = _tracer
    if tr is None:
        return _NOOP_SPAN
    return _Span(tr, name, cat, corr, args)


def record(name: str, t0_ns: int, t1_ns: int, cat: str = "",
           corr: str | None = None, args: dict | None = None) -> None:
    """Record a completed span from two timestamps the caller took (the
    worker's phase timings: tracing adds no clock read). No-op when off."""
    tr = _tracer
    if tr is None:
        return
    st = tr._state()
    tr._record(st, name, cat, corr if corr is not None else st.corr,
               t0_ns, t1_ns - t0_ns, args)


def instant(name: str, cat: str = "", corr: str | None = None,
            args: dict | None = None) -> None:
    """Record a point event (a zero-duration span). No-op when off."""
    tr = _tracer
    if tr is None:
        return
    st = tr._state()
    tr._record(st, name, cat, corr if corr is not None else st.corr,
               time.perf_counter_ns(), 0, args)


def counter(name: str, value, t_ns: int | None = None) -> None:
    """Record one counter sample, saved as a Chrome ``ph: "C"`` counter
    track. Never sampled out; no-op when off."""
    tr = _tracer
    if tr is None:
        return
    st = tr._state()
    t = time.perf_counter_ns() if t_ns is None else int(t_ns)
    tr._record(st, name, COUNTER_CAT, None, t, 0, float(value),
               sampled=False)


def set_corr(corr: str | None) -> None:
    """Set this thread's correlation id; spans without an explicit
    ``corr=`` record the one in effect when they close. No-op when off."""
    tr = _tracer
    if tr is None:
        return
    tr._state().corr = corr


def current_corr() -> str | None:
    """This thread's correlation id (None when off or unset): the socket
    client stamps it into outgoing commit and exchange frames."""
    tr = _tracer
    if tr is None:
        return None
    return tr._state().corr


def events() -> list[dict]:
    """All recorded events (:meth:`Tracer.events`); ``[]`` when off."""
    tr = _tracer
    if tr is None:
        return []
    return tr.events()


def save(path: str) -> str:
    """Write everything recorded so far as Chrome trace-event JSON
    (``{"traceEvents": [...]}``: ``ph: "X"`` spans with µs timestamps,
    counter samples as ``ph: "C"`` tracks, thread names as metadata), for
    https://ui.perfetto.dev or ``chrome://tracing``. ``otherData`` carries
    the dropped-event count. Parent directories are created. Raises when
    tracing is off (an empty file would read as "traced, nothing
    happened")."""
    tr = _tracer
    if tr is None:
        raise RuntimeError("tracing is not enabled: nothing to save")
    pid = os.getpid()
    out: list[dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "distkeras_tpu_torch"}}]
    seen_tids: set = set()
    for e in tr.events():
        if e["tid"] not in seen_tids:
            seen_tids.add(e["tid"])
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": e["tid"], "args": {"name": e["tname"]}})
        if e["cat"] == COUNTER_CAT:
            out.append({"name": e["name"], "ph": "C",
                        "ts": e["t0_ns"] / 1e3, "pid": pid, "tid": e["tid"],
                        "args": {"value": e["args"]}})
            continue
        args = dict(e["args"]) if e["args"] else {}
        if e["corr"] is not None:
            args["corr"] = e["corr"]
        out.append({"name": e["name"], "cat": e["cat"] or "dk", "ph": "X",
                    "ts": e["t0_ns"] / 1e3, "dur": e["dur_ns"] / 1e3,
                    "pid": pid, "tid": e["tid"], "args": args})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": out, "displayTimeUnit": "ms",
                   "otherData": {"dropped_events": tr.dropped()}}, f)
    return path
