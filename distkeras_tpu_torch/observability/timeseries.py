"""Embedded time-series telemetry: ring-buffered series + a background scraper.

The port's copy of ``distkeras_tpu/observability/timeseries.py``.
:mod:`~distkeras_tpu_torch.observability.metrics` is the *point-in-time*
metrics surface (``ps.stats()`` roll-ups, the typed registry, one health
snapshot). This module is the
*continuous* half: a lightweight in-process store of ``(t, value)``
series sampled on an interval by a background :class:`Scraper`, so "is
this run healthy right now" has data behind it — rounds/s over time,
per-worker progress skew, DynSGD τ percentiles, WAL fsync tails, shm
ring occupancy, serving latency percentiles, the training loss curve.
The watchdog (:mod:`distkeras_tpu_torch.observability.watch`) evaluates its
alert rules over exactly these series, and ``ElasticPolicy`` reads its
rounds/s + straggler observations from the same store — ONE definition
of progress, not three private ones.

Design constraints:

- **Bounded memory, whole-run coverage.** Every series is a fixed-
  capacity buffer; when it fills it *downsamples* (adjacent pairs merge:
  gauges average, counters keep the later cumulative value) and doubles
  its implicit resolution — RRD-style. A series therefore always spans
  the whole run at degrading resolution instead of forgetting the start
  (the loss-slope stall rule needs the early history; the skew rule only
  the recent past — both are served).
- **Cheap.** One sample is a float append under one store lock; the
  scraper thread touches the run only through the read-only stat
  surfaces that already exist (``ps.stats()`` without the settling
  barrier, worker ``_windows_done`` counters, bounded deques). A source
  that raises is disabled loudly (one warning), never killing the
  scrape loop.
- **Dumpable.** ``TimeSeriesStore.dump()`` writes one JSON document
  (series + metadata) — the CI chaos artifact, and the operator's
  offline view; :meth:`TimeSeriesStore.load` round-trips it.
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time
import warnings
from typing import Callable

import numpy as np

from distkeras_tpu_torch.observability import trace as _trace

__all__ = [
    "Series", "TimeSeriesStore", "Scraper",
    "ps_source", "progress_source", "history_source", "serving_source",
    "wire_metrics_source", "snapshot_deque",
]


class Series:
    """One named time series: a bounded list of ``(t, value)`` points.

    ``kind`` controls downsampling semantics when the buffer fills:
    ``"gauge"`` merges adjacent pairs by averaging under the earlier
    timestamp (the point labels the span it summarizes; a queue depth's
    coarse history is its mean), ``"counter"`` keeps the LATER sample of
    each pair (every surviving point stays a true cumulative
    observation — averaging would invent values the counter never
    held). ``resolution`` doubles per fill, so the series always covers
    its whole lifetime in at most ``capacity`` points.

    Concurrency: writers serialize on the store lock; READERS are
    lock-free. Points therefore live in ONE list of ``(t, v)`` tuples —
    appends are atomic under the GIL, downsampling builds a fresh list
    and REBINDS it in one assignment — so a racing reader snapshots
    ``self._pts`` once and sees either the old or the new list, never a
    torn mix of pre- and post-downsample timestamps/values.
    """

    __slots__ = ("name", "kind", "capacity", "resolution", "_pts")

    def __init__(self, name: str, kind: str = "gauge", capacity: int = 512):
        if kind not in ("gauge", "counter"):
            raise ValueError(f"kind must be 'gauge' or 'counter', got {kind!r}")
        if capacity < 8 or capacity % 2:
            raise ValueError(
                f"capacity must be an even number >= 8, got {capacity}"
            )
        self.name = name
        self.kind = kind
        self.capacity = int(capacity)
        self.resolution = 1      # raw samples merged into one point
        self._pts: list[tuple[float, float]] = []

    def __len__(self) -> int:
        return len(self._pts)

    def append(self, t: float, value: float) -> None:
        self._pts.append((float(t), float(value)))
        if len(self._pts) >= self.capacity:
            self._downsample()

    def _downsample(self) -> None:
        # A merged COUNTER pair keeps its later (t, value) sample: every
        # surviving point remains a true "cumulative count as of t"
        # observation, so any two points still give an exact rate. A
        # merged GAUGE pair keeps the earlier timestamp with the pair
        # mean (the point labels the span it summarizes — the head of
        # the series stays anchored at the run start).
        pts = self._pts
        n = len(pts) // 2 * 2
        if self.kind == "counter":
            merged = [pts[i + 1] for i in range(0, n, 2)]
        else:
            merged = [(pts[i][0], (pts[i][1] + pts[i + 1][1]) / 2.0)
                      for i in range(0, n, 2)]
        self._pts = merged + pts[n:]   # one rebind: readers never tear
        self.resolution *= 2

    def points(self) -> list[tuple[float, float]]:
        return list(self._pts)

    def last(self) -> tuple[float, float] | None:
        pts = self._pts
        if not pts:
            return None
        return pts[-1]

    def window(self, since_t: float) -> list[tuple[float, float]]:
        """Points with ``t >= since_t`` (trailing window reads)."""
        pts = self._pts                    # one snapshot (see class doc)
        lo = 0
        hi = len(pts)
        while lo < hi:                     # bisect on the sorted times
            mid = (lo + hi) // 2
            if pts[mid][0] < since_t:
                lo = mid + 1
            else:
                hi = mid
        return pts[lo:]

    def rate(self, window_s: float, now: float | None = None) -> float | None:
        """Per-second rate of change over the trailing window — THE
        rounds/s primitive (meaningful for counter series). None with
        fewer than two in-window points."""
        pts = self._pts
        if not pts:
            return None
        t_end = pts[-1][0] if now is None else float(now)
        w = self.window(t_end - float(window_s))
        if len(w) < 2:
            return None
        (t0, v0), (t1, v1) = w[0], w[-1]
        if t1 <= t0:
            return None
        return (v1 - v0) / (t1 - t0)

    def to_json(self) -> dict:
        pts = list(self._pts)
        return {
            "name": self.name, "kind": self.kind,
            "capacity": self.capacity, "resolution": self.resolution,
            "t": [p[0] for p in pts], "v": [p[1] for p in pts],
        }

    @classmethod
    def from_json(cls, d: dict) -> "Series":
        s = cls(d["name"], d.get("kind", "gauge"),
                d.get("capacity", 512))
        s.resolution = int(d.get("resolution", 1))
        s._pts = [(float(t), float(v)) for t, v in zip(d["t"], d["v"])]
        return s


class TimeSeriesStore:
    """Thread-safe named collection of :class:`Series`.

    ``sample`` lazily declares the series on first touch (kind is fixed
    at declaration — re-sampling with a different kind raises, same
    typed-surface discipline as the metrics registry). The clock is the
    caller's: every producer in this codebase samples ``time.monotonic()``
    so series timestamps, worker progress, and request latencies share
    one timebase.
    """

    def __init__(self, capacity: int = 512):
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._series: dict[str, Series] = {}

    def sample(self, name: str, t: float, value,
               kind: str = "gauge") -> None:
        v = float(value)
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = Series(name, kind, self.capacity)
            elif s.kind != kind:
                raise ValueError(
                    f"series {name!r} is a {s.kind}, cannot sample as {kind}"
                )
            s.append(t, v)

    def get(self, name: str) -> Series | None:
        with self._lock:
            return self._series.get(name)

    def names(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(n for n in self._series if n.startswith(prefix))

    def last(self, name: str) -> float | None:
        s = self.get(name)
        if s is None:
            return None
        p = s.last()
        return None if p is None else p[1]

    def rate(self, name: str, window_s: float,
             now: float | None = None) -> float | None:
        s = self.get(name)
        return None if s is None else s.rate(window_s, now)

    def delta(self, name: str, window_s: float,
              now: float | None = None) -> float | None:
        """Counter increase over the trailing window (spike rules)."""
        s = self.get(name)
        if s is None or not len(s):
            return None
        t_end = s._pts[-1][0] if now is None else float(now)
        pts = s.window(t_end - float(window_s))
        if len(pts) < 2:
            return None
        return pts[-1][1] - pts[0][1]

    def increase(self, name: str, window_s: float,
                 now: float | None = None) -> float | None:
        """Reset-aware counter increase over the trailing window: the
        sum of positive increments (Prometheus ``increase()``
        semantics). A counter that RESETS mid-window — a failed-over PS
        restarting its op counters — must not report a negative (or
        masked) spike."""
        s = self.get(name)
        if s is None or not len(s):
            return None
        t_end = s._pts[-1][0] if now is None else float(now)
        pts = s.window(t_end - float(window_s))
        if len(pts) < 2:
            return None
        return float(sum(
            max(0.0, pts[i + 1][1] - pts[i][1])
            for i in range(len(pts) - 1)
        ))

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)

    def to_json(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "series": {n: s.to_json()
                           for n, s in sorted(self._series.items())},
            }

    def dump(self, path: str, extra: dict | None = None) -> str:
        """Write the store (plus optional extra sections — the watchdog
        attaches its alert log here) as one JSON document. A ``.gz``
        path is gzip-compressed (long watched runs) — ``load``
        and the ``analyze`` CLI sniff the format, so both read back
        transparently."""
        doc = self.to_json()
        if extra:
            doc.update(extra)
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "wt") as f:
            json.dump(doc, f)
        return path

    @classmethod
    def load(cls, path: str) -> "TimeSeriesStore":
        doc = _trace.load_json_maybe_gz(path)
        store = cls(doc.get("capacity", 512))
        for n, s in doc.get("series", {}).items():
            store._series[n] = Series.from_json(s)
        return store


class Scraper:
    """Background sampler: every ``interval`` seconds it runs each
    registered source against the store, then fires ``on_tick`` (the
    watchdog evaluation rides here, so rules see freshly sampled data).

    A **source** is ``fn(store, now) -> None``. One that raises is
    disabled after a single warning naming it — telemetry must never
    take down the run it is observing. ``tick()`` runs one synchronous
    pass (tests drive scraping deterministically through it; the thread
    is just ``tick`` on a timer)."""

    def __init__(self, store: TimeSeriesStore, interval: float = 1.0):
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        self.store = store
        self.interval = float(interval)
        self._sources: list[tuple[str, Callable]] = []
        self._dead: set[str] = set()
        self._on_tick: list[Callable[[float], None]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0

    def add_source(self, name: str, fn: Callable) -> None:
        self._sources.append((str(name), fn))

    def on_tick(self, fn: Callable[[float], None]) -> None:
        self._on_tick.append(fn)

    def tick(self, now: float | None = None) -> None:
        t = time.monotonic() if now is None else float(now)
        for name, fn in self._sources:
            if name in self._dead:
                continue
            try:
                fn(self.store, t)
            except Exception as e:  # noqa: BLE001 — observer must survive
                self._dead.add(name)
                warnings.warn(
                    f"timeseries source {name!r} failed and was disabled "
                    f"({type(e).__name__}: {e})", stacklevel=2,
                )
        for fn in self._on_tick:
            try:
                fn(t)
            except Exception as e:  # noqa: BLE001
                warnings.warn(
                    f"timeseries on_tick hook failed "
                    f"({type(e).__name__}: {e})", stacklevel=2,
                )
        self.ticks += 1

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval):
                self.tick()

        self._thread = threading.Thread(
            target=loop, daemon=True, name="dk-watch-scraper"
        )
        self._thread.start()

    def stop(self, final_tick: bool = True) -> None:
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout=5)
        if final_tick:
            self.tick()  # end-of-run state always lands in the series


# -- sources -----------------------------------------------------------------

#: scalar ps.stats() keys worth a series, with their kind (rates and
#: derived means are skipped — the store derives rates itself)
_PS_SERIES: tuple[tuple[str, str], ...] = (
    ("pulls", "counter"), ("compressed_pulls", "counter"),
    ("commits", "counter"), ("dup_commits", "counter"),
    ("fenced_commits", "counter"), ("fused_exchanges", "counter"),
    ("batched_folds", "counter"), ("exchange_rtts", "counter"),
    ("bytes_in", "counter"), ("bytes_out", "counter"),
    ("num_updates", "counter"), ("wal_records", "counter"),
    ("wal_fsyncs", "counter"), ("evicted_workers", "counter"),
    ("heartbeats", "counter"), ("worker_retries", "counter"),
    ("joined_workers", "counter"), ("preempted_workers", "counter"),
    ("drain_timeouts", "counter"),
    ("active_workers", "gauge"), ("pool_size", "gauge"),
    ("center_lock_mean_hold_ns", "gauge"), ("wal_group_max", "gauge"),
    ("deploy_version", "gauge"), ("deploy_lag_folds", "gauge"),
)


def ps_source(ps) -> Callable:
    """Sample a parameter server (any transport that quacks ``stats()``:
    single PS, socket/native/shm server, ``ShardedPSGroup`` aggregate —
    or a zero-arg callable resolving the CURRENT server, so a failover's
    promoted primary is scraped, not the corpse) into ``ps.<key>``
    series — plus, where the server exposes them, the DynSGD τ p95
    (``ps.tau_p95``, from the fold path's recent-staleness ring), the
    WAL fsync tail (``ps.wal_fsync_p95_ms`` / ``ps.wal_fsync_max_ms``),
    and shm ring occupancy (``shm.ring_occupancy_frac``, the fullest
    ring's used fraction, plus ``shm.segments``). The stats read skips
    the settling barrier where supported (``settle=False``): a scrape
    must observe the run, not synchronize with it."""
    resolve = ps if callable(ps) else (lambda: ps)

    def sample(store: TimeSeriesStore, now: float) -> None:
        target = resolve()
        if target is None:
            return
        try:
            stats = target.stats(settle=False)
        except TypeError:           # native/group stats() take no kwarg
            stats = target.stats()
        for key, kind in _PS_SERIES:
            v = stats.get(key)
            if v is not None:
                store.sample(f"ps.{key}", now, v, kind)
        taus = getattr(target, "recent_staleness", None)
        if taus is not None:
            vals = taus()
            if vals:
                arr = np.asarray(vals, np.float64)
                p95 = float(np.percentile(arr, 95))
                store.sample("ps.tau_p95", now, p95)
                store.sample("ps.tau_max", now, float(arr.max()))
                # Perfetto counter track: the sampled τ tail
                # renders as a graph alongside the spans (no-op untraced)
                _trace.counter("ps.tau_p95", p95)
        wal = getattr(target, "_wal", None)
        recent = getattr(wal, "fsync_ms_recent", None)
        if recent:
            vals = snapshot_deque(recent)
            if vals:
                arr = np.asarray(vals, np.float64)
                store.sample("ps.wal_fsync_p95_ms", now,
                             float(np.percentile(arr, 95)))
                store.sample("ps.wal_fsync_max_ms", now, float(arr.max()))
        occ = getattr(target, "ring_occupancy", None)
        if occ is not None:
            segs = occ()
            if segs:
                frac = max(s["frac"] for s in segs)
                store.sample("shm.ring_occupancy_frac", now, frac)
                _trace.counter("shm.ring_occupancy_frac", frac)
            store.sample("shm.segments", now, len(segs))

    return sample


def progress_source(get_progress: Callable[[], dict]) -> Callable:
    """Sample per-worker cumulative window counts (``{wid: count}``)
    into ``worker.<wid>.windows`` counter series — the ONE progress
    record the skew rule and ``ElasticPolicy`` both read."""

    def sample(store: TimeSeriesStore, now: float) -> None:
        for wid, n in get_progress().items():
            store.sample(f"worker.{wid}.windows", now, n, "counter")

    return sample


def history_source(history: list, lock=None, tail: int = 16) -> Callable:
    """Sample the training history (per-window loss rows appended by the
    hogwild workers) into ``train.records`` (counter) and ``train.loss``
    (gauge: mean of the last ``tail`` losses — one worker's noisy window
    loss is not a signal; their recent mean is)."""

    def sample(store: TimeSeriesStore, now: float) -> None:
        if lock is not None:
            with lock:
                n = len(history)
                recent = [r.get("loss") for r in history[-tail:]]
        else:
            n = len(history)
            recent = [r.get("loss") for r in history[-tail:]]
        store.sample("train.records", now, n, "counter")
        losses = [x for x in recent if x is not None and np.isfinite(x)]
        if losses:
            store.sample("train.loss", now, float(np.mean(losses)))

    return sample


#: scalar GenerationEngine/GenerationServer stats keys worth a series
_SERVE_SERIES: tuple[tuple[str, str], ...] = (
    ("submitted", "counter"), ("admitted", "counter"),
    ("completed", "counter"), ("cancelled", "counter"),
    ("rejected", "counter"), ("failed", "counter"),
    ("steps", "counter"), ("prefills", "counter"),
    ("tokens_generated", "counter"), ("dead_connections", "counter"),
    ("queued", "gauge"), ("active", "gauge"),
    ("blocks_in_use", "gauge"), ("blocks_free", "gauge"),
    ("open_connections", "gauge"),
    # the serving front door — keys absent on engines
    # without it, so legacy series sets are unchanged
    ("prefix_hit_rate", "gauge"), ("prefix_cached_blocks", "gauge"),
    ("prefix_evictions", "counter"), ("cow_copies", "counter"),
    ("preemptions", "counter"),
)


def serving_source(engine) -> Callable:
    """Sample a ``GenerationEngine`` / ``GenerationServer`` into
    ``serve.<key>`` series plus per-SLO-class latency percentiles
    (``serve.lat.<class>.p50_ms`` / ``.p99_ms`` / ``.queue_ms`` /
    ``.prefill_ms`` / ``.decode_ms``) from the engine's retired-request
    ring — the series the per-class SLO rule evaluates."""

    def sample(store: TimeSeriesStore, now: float) -> None:
        stats = engine.stats()
        for key, kind in _SERVE_SERIES:
            v = stats.get(key)
            if v is not None:
                store.sample(f"serve.{key}", now, v, kind)
        if stats.get("active") is not None:
            # rows in flight as a Perfetto counter track:
            # batch occupancy over time next to the decode_step spans
            _trace.counter("serve.rows_in_flight", stats["active"])
        lat = stats.get("latency") or {}
        for cls, rec in lat.items():
            for key in ("p50_ms", "p99_ms", "queue_ms", "prefill_ms",
                        "decode_ms"):
                v = rec.get(key)
                if v is not None:
                    store.sample(f"serve.lat.{cls}.{key}", now, v)

    return sample


def wire_metrics_source(scrape: Callable[[], dict]) -> Callable:
    """Feed the store from a live server's ``metrics`` wire reply (the
    ``health --watch`` CLI path): ``scrape()`` returns the reply dict
    and every ``dk_ps_*`` / ``dk_serve_*`` sample lands under the SAME
    series names the in-process sources use, so the watchdog rules run
    unchanged against a remote server."""
    from distkeras_tpu_torch.observability.metrics import wire_series_samples

    def sample(store: TimeSeriesStore, now: float) -> None:
        reply = scrape()
        for name, kind, value in wire_series_samples(
                reply.get("metrics", {})):
            store.sample(name, now, value, kind)

    return sample


def snapshot_deque(d) -> list:
    """Copy a bounded deque another thread is appending to: ``list()``
    over a mutating deque can raise RuntimeError — retry, then settle
    for empty (a telemetry read must never fail the scrape)."""
    for _ in range(4):
        try:
            return list(d)
        except RuntimeError:
            continue
    return []
