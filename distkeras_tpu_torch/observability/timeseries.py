"""Embedded time-series telemetry: ring-buffered ``(t, value)`` series.

The port's copy of ``Series`` and ``TimeSeriesStore`` from
``distkeras_tpu/observability/timeseries.py``. The elastic coordinator
(``resilience/elastic.py``) samples every live worker's cumulative window
count into the ``worker.<wid>.windows`` counter series of a store, and
``ElasticPolicy`` reads its rounds/s off those series through
:mod:`~distkeras_tpu_torch.observability.watch`: one definition of
progress.

- **Bounded memory, whole-run coverage.** Every series is a fixed-capacity
  buffer; when it fills it *downsamples* (adjacent pairs merge: gauges
  average, counters keep the later cumulative value) and doubles its
  implicit resolution, so a series always spans the whole run at a
  degrading resolution.
- **Cheap.** One sample is a float append under one store lock; readers
  take no lock.
- **Dumpable.** ``TimeSeriesStore.dump()`` writes one JSON document
  (``.gz`` compressed) and :meth:`TimeSeriesStore.load` reads it back.

The background ``Scraper``, the ``*_source`` functions that feed it from
``ps.stats()``, the history and the serving engine, and
``wire_metrics_source`` belong to the watchtower (``ROADMAP.md`` A13) and
are not ported yet.
"""

from __future__ import annotations

import gzip
import json
import os
import threading

__all__ = ["Series", "TimeSeriesStore"]


def _load_json(path: str) -> dict:
    """A JSON document, gzip-compressed or not (sniffed by its magic)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    opener = gzip.open if magic == b"\x1f\x8b" else open
    with opener(path, "rt") as f:
        return json.load(f)


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
            raise ValueError(
                f"kind must be 'gauge' or 'counter', got {kind!r}")
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
        """Write the store (plus optional extra sections) as one JSON
        document. A ``.gz`` path is gzip-compressed; :meth:`load` sniffs
        the format, so both read back."""
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
        doc = _load_json(path)
        store = cls(doc.get("capacity", 512))
        for n, s in doc.get("series", {}).items():
            store._series[n] = Series.from_json(s)
        return store
