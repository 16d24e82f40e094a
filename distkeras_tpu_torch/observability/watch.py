"""The watchtower: declarative SLO/anomaly watchdog over the time series.

The failure shapes this codebase already *simulates* (stragglers under
``FaultPlan`` chaos, staleness blowups, fenced/dup commit storms after a
PS kill, WAL fsync tails, shm ring saturation, convergence stalls,
serving SLO misses) become typed, automatically-detected **alerts**:
each :class:`AlertRule` evaluates one condition over the
:class:`~distkeras_tpu_torch.observability.timeseries.TimeSeriesStore`, the
:class:`Watchdog` turns rule verdicts into fire/resolve *transitions*
(an alert log, an active set, optional hooks), and the
:class:`Watchtower` bundles store + scraper + watchdog into the one
object a trainer run or a live server attaches.

The unifying refactor: :func:`rates_from_counts` and
:func:`straggler_workers` are THE definitions of per-worker rounds/s
and straggler-ness — the skew rule evaluates them over the shared
``worker.<wid>.windows`` series, and ``ElasticPolicy``
(resilience/elastic.py) calls the same two functions instead of
computing privately, so the autoscaler and the alerting can never
disagree about who is slow.

Rules are deliberately *pure* over ``(store, now)`` (the only state a
rule keeps is its own persistence counter), so tests drive them
deterministically with hand-built series — chaos integration only has
to prove the SOURCES feed the store faithfully.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable

import numpy as np

from distkeras_tpu_torch.observability.timeseries import (
    Scraper,
    TimeSeriesStore,
    history_source,
    progress_source,
    ps_source,
    serving_source,
)

__all__ = [
    "Alert", "AlertRule", "TauP95Rule", "CommitSkewRule",
    "CommitReplaySpikeRule", "WalFsyncTailRule", "RingOccupancyRule",
    "DeployLagRule", "ServingSLORule", "PrefixHitRateRule",
    "LossStallRule",
    "BottleneckShiftRule", "SLOClass",
    "default_rules", "Watchdog", "Watchtower", "rates_from_counts",
    "worker_rates", "rounds_per_sec", "straggler_workers",
    "watch_endpoint",
]


# -- the ONE definition of rounds/s and straggler-ness ------------------------

def rates_from_counts(t0: float, counts0: dict, t1: float,
                      counts1: dict) -> dict:
    """Per-worker rounds/s between two cumulative window-count
    observations. Workers present only in the newer observation rate
    from zero (a joiner's first interval counts its whole progress)."""
    dt = float(t1) - float(t0)
    if dt <= 0:
        return {}
    return {
        wid: max(0.0, n - counts0.get(wid, 0)) / dt
        for wid, n in counts1.items()
    }


def worker_rates(store: TimeSeriesStore, window_s: float,
                 now: float | None = None,
                 prefix: str = "worker.") -> dict[int, float]:
    """Per-worker rounds/s read off the shared ``worker.<wid>.windows``
    counter series over the trailing window. Workers without two
    in-window points (just joined, just drained) are omitted."""
    rates: dict[int, float] = {}
    for name in store.names(prefix):
        if not name.endswith(".windows"):
            continue
        r = store.rate(name, window_s, now)
        if r is None:
            continue
        wid = name[len(prefix):-len(".windows")]
        try:
            rates[int(wid)] = r
        except ValueError:
            rates[wid] = r  # non-numeric worker labels pass through
    return rates


def rounds_per_sec(store: TimeSeriesStore, window_s: float,
                   now: float | None = None) -> float | None:
    """Pool rounds/s: the sum of per-worker rates (None before any
    worker has two in-window samples)."""
    rates = worker_rates(store, window_s, now)
    if not rates:
        return None
    return float(sum(rates.values()))


def straggler_workers(rates: dict, ratio: float) -> tuple[float, list]:
    """``(median_rate, [straggler ids])``: a straggler is a worker whose
    rate sits below ``ratio × median`` of the pool — DynSGD's τ tail,
    the workers whose commits the center is already down-weighting
    toward nothing. Needs a pool of >= 2 to define a median."""
    if len(rates) < 2:
        return 0.0, []
    med = float(np.median(list(rates.values())))
    if med <= 0:
        return med, []
    return med, sorted(w for w, r in rates.items() if r < ratio * med)


# -- alerts -------------------------------------------------------------------

class Alert(dict):
    """One typed alert transition (a dict, so it is JSON-clean by
    construction): ``rule``/``kind``/``severity``/``state`` ("firing" |
    "resolved")/``t``/``value``/``threshold``/``detail``."""

    @property
    def firing(self) -> bool:
        return self["state"] == "firing"


class AlertRule:
    """Base rule: subclasses implement :meth:`check` returning
    ``(firing, value, detail)`` — ``firing=None`` means "not enough
    data, leave the alert state unchanged". ``persistence`` demands N
    consecutive firing evaluations before the alert transitions (one
    noisy scrape must not page anyone)."""

    kind = "generic"
    severity = "warning"

    def __init__(self, name: str | None = None, persistence: int = 1):
        self.name = name or self.kind
        if persistence < 1:
            raise ValueError(
                f"persistence must be >= 1, got {persistence}"
            )
        self.persistence = int(persistence)
        self._streak = 0
        self.threshold: float | None = None

    def check(self, store: TimeSeriesStore, now: float):
        raise NotImplementedError

    def evaluate(self, store: TimeSeriesStore, now: float):
        """→ ``(firing, value, detail)`` with persistence applied."""
        firing, value, detail = self.check(store, now)
        if firing is None:
            return None, value, detail
        if firing:
            self._streak += 1
            return self._streak >= self.persistence, value, detail
        self._streak = 0
        return False, value, detail


class TauP95Rule(AlertRule):
    """DynSGD staleness tail: the p95 of recent per-commit τ (sampled
    from the fold path into ``ps.tau_p95``) crossed ``bound``. A τ
    blowup means someone's pulls are ancient — a straggler, a stalled
    pipeline, or a zombie — and the center is paying for it."""

    kind = "tau_p95"

    def __init__(self, bound: float = 16.0, **kw):
        super().__init__(**kw)
        self.threshold = float(bound)

    def check(self, store, now):
        v = store.last("ps.tau_p95")
        if v is None:
            return None, None, None
        return v > self.threshold, v, {"tau_p95": v}


class CommitSkewRule(AlertRule):
    """Per-worker commit-rate skew (the straggler alert): some worker's
    windows/s sits below ``ratio × median`` of the pool over the
    trailing window — evaluated with :func:`straggler_workers`, the
    same definition ``ElasticPolicy`` acts on."""

    kind = "commit_skew"

    def __init__(self, ratio: float = 0.25, window_s: float = 5.0,
                 min_rounds: int = 4, **kw):
        kw.setdefault("persistence", 2)
        super().__init__(**kw)
        self.threshold = float(ratio)
        self.window_s = float(window_s)
        self.min_rounds = int(min_rounds)

    def check(self, store, now):
        rates = worker_rates(store, self.window_s, now)
        # warm-up grace: a worker is judged only once (a) it has
        # completed at least one window — before that it is
        # INITIALIZING (first pull, jit warm-up), not straggling — and
        # (b) its series spans a FULL rate window, so the one-core
        # startup scramble (threads taking turns at the GIL while the
        # first windows compile and run) cannot read as skew; an
        # elastic joiner gets the same one-window grace. A worker that
        # progressed and then stalled stays in.
        for wid in list(rates):
            s = store.get(f"worker.{wid}.windows")
            pts = s.points() if s is not None else []
            if (not pts or pts[-1][1] <= 0
                    or now - pts[0][0] < self.window_s):
                rates.pop(wid)
        if len(rates) < 2:
            return None, None, None
        total = sum(rates.values())
        if total * self.window_s < self.min_rounds:
            return None, total, None   # too little progress to judge
        med, lagging = straggler_workers(rates, self.threshold)
        detail = {
            "median_rounds_per_sec": med,
            "stragglers": {str(w): rates[w] for w in lagging},
            "rates": {str(w): round(r, 3) for w, r in rates.items()},
        }
        worst = min(rates.values()) / med if med > 0 else None
        return bool(lagging), worst, detail


class CommitReplaySpikeRule(AlertRule):
    """Dup/fenced-commit spike: the sum of ``ps.dup_commits`` +
    ``ps.fenced_commits`` grew by more than ``max_in_window`` inside the
    trailing window. A handful of dups is the retry layer doing its job;
    a spike is a lost-ACK storm or a fenced old history replaying after
    a failover."""

    kind = "commit_replay_spike"

    def __init__(self, max_in_window: float = 3.0, window_s: float = 5.0,
                 **kw):
        super().__init__(**kw)
        self.threshold = float(max_in_window)
        self.window_s = float(window_s)

    def check(self, store, now):
        # reset-aware increase: a failed-over PS restarts its op
        # counters — the replay storm right after is exactly when this
        # rule must not be blinded by the reset
        dup = store.increase("ps.dup_commits", self.window_s, now)
        fenced = store.increase("ps.fenced_commits", self.window_s, now)
        if dup is None and fenced is None:
            return None, None, None
        v = (dup or 0.0) + (fenced or 0.0)
        return v > self.threshold, v, {
            "dup_commits": dup or 0.0, "fenced_commits": fenced or 0.0,
        }


class WalFsyncTailRule(AlertRule):
    """WAL fsync tail latency: the p95 of recent group-fsync durations
    (``ps.wal_fsync_p95_ms``) crossed ``p95_ms``. A slow log device
    stretches every deferred commit ACK — durable throughput dies here
    first."""

    kind = "wal_fsync_tail"

    def __init__(self, p95_ms: float = 50.0, **kw):
        super().__init__(**kw)
        self.threshold = float(p95_ms)

    def check(self, store, now):
        v = store.last("ps.wal_fsync_p95_ms")
        if v is None:
            return None, None, None
        return v > self.threshold, v, {"wal_fsync_p95_ms": v}


class DeployLagRule(AlertRule):
    """Serving-tier staleness: the deploy lag (``ps.deploy_lag_folds``
    — folds the training center is ahead of the newest snapshot the
    serving tier materialized) crossed ``bound``. A streamer that
    detached, a stalled publisher thread, or a snapshot cadence far
    coarser than the fold rate all land here: training keeps moving
    while served weights quietly age. Silent on training-only runs —
    until a deployer reports a version (``ps.deploy_version`` > 0)
    there is nothing to lag behind."""

    kind = "deploy_lag"

    def __init__(self, bound: float = 500.0, **kw):
        super().__init__(**kw)
        self.threshold = float(bound)

    def check(self, store, now):
        dv = store.last("ps.deploy_version")
        if dv is None or dv <= 0:
            return None, None, None
        v = store.last("ps.deploy_lag_folds")
        if v is None:
            return None, None, None
        return v > self.threshold, v, {
            "deploy_lag_folds": v, "deploy_version": dv,
        }


class RingOccupancyRule(AlertRule):
    """shm ring saturation: the fullest ring's used fraction
    (``shm.ring_occupancy_frac``) crossed ``frac`` — the writer is
    about to block on the reader; either the reader stalled or
    ``ring_bytes`` is undersized for the payload."""

    kind = "ring_occupancy"

    def __init__(self, frac: float = 0.9, **kw):
        super().__init__(**kw)
        self.threshold = float(frac)

    def check(self, store, now):
        v = store.last("shm.ring_occupancy_frac")
        if v is None:
            return None, None, None
        return v > self.threshold, v, {"ring_occupancy_frac": v}


class SLOClass:
    """One serving SLO class: latency bounds in ms (None = unbounded)."""

    __slots__ = ("p50_ms", "p99_ms")

    def __init__(self, p50_ms: float | None = None,
                 p99_ms: float | None = None):
        self.p50_ms = None if p50_ms is None else float(p50_ms)
        self.p99_ms = None if p99_ms is None else float(p99_ms)


class ServingSLORule(AlertRule):
    """Serving p50/p99 vs per-class SLO, with the queue/prefill/decode
    breakdown in the alert detail (the series carry the means the
    engine computed from its retired-request ring — the same numbers
    the request spans record, without needing tracing on). ``slo`` maps
    class name → :class:`SLOClass` (or ``(p50_ms, p99_ms)``)."""

    kind = "serving_slo"

    def __init__(self, slo: dict | None = None, **kw):
        super().__init__(**kw)
        slo = slo or {"default": SLOClass(p99_ms=1000.0)}
        self.slo: dict[str, SLOClass] = {
            str(c): (s if isinstance(s, SLOClass) else SLOClass(*s))
            for c, s in slo.items()
        }

    def check(self, store, now):
        misses = {}
        seen = False
        worst = None
        for cls, slo in self.slo.items():
            rec = {}
            for key in ("p50_ms", "p99_ms", "queue_ms", "prefill_ms",
                        "decode_ms"):
                v = store.last(f"serve.lat.{cls}.{key}")
                if v is not None:
                    rec[key] = v
            if not rec:
                continue
            seen = True
            for pct in ("p50_ms", "p99_ms"):
                bound = getattr(slo, pct)
                v = rec.get(pct)
                if bound is not None and v is not None and v > bound:
                    misses[cls] = {**rec, "missed": pct, "bound": bound}
                    ratio = v / bound
                    worst = ratio if worst is None else max(worst, ratio)
        if not seen:
            return None, None, None
        return bool(misses), worst, {"misses": misses} if misses else None


class PrefixHitRateRule(AlertRule):
    """The front door's reuse health: the engine's lifetime
    token-level prefix-cache hit rate sits below ``floor`` after at
    least ``min_admitted`` requests. A cold cache warming up is normal
    (the admission gate); a WARM replica stuck near zero means the
    router is spraying prefixes instead of colocating them (affinity
    off / misconfigured) or eviction is thrashing the tree — either
    way the fleet is paying full prefill for prompts it already
    computed. Engines without a prefix cache publish no
    ``serve.prefix_hit_rate`` series and are never judged."""

    kind = "prefix_hit_rate"

    def __init__(self, floor: float = 0.05, min_admitted: int = 50, **kw):
        super().__init__(**kw)
        self.threshold = float(floor)
        self.min_admitted = int(min_admitted)

    def check(self, store, now):
        rate = store.last("serve.prefix_hit_rate")
        if rate is None:
            return None, None, None     # cache off: nothing to judge
        admitted = store.last("serve.admitted")
        if admitted is None or admitted < self.min_admitted:
            return None, rate, None     # still warming: hold state
        detail = {"hit_rate": rate, "floor": self.threshold,
                  "admitted": admitted,
                  "cached_blocks": store.last("serve.prefix_cached_blocks"),
                  "evictions": store.last("serve.prefix_evictions")}
        return rate < self.threshold, rate, detail


class LossStallRule(AlertRule):
    """Convergence stall: the least-squares slope of ``train.loss``
    over the trailing window is not meaningfully negative even though
    training progressed (``train.records`` grew by at least
    ``min_new_records``). ``slope_eps`` is in loss-units/second —
    slope >= -eps fires. The progress gate keeps an idle/finished run
    from alerting."""

    kind = "loss_stall"

    def __init__(self, window_s: float = 20.0, min_points: int = 8,
                 min_new_records: int = 8, slope_eps: float = 1e-4, **kw):
        kw.setdefault("persistence", 2)
        super().__init__(**kw)
        self.window_s = float(window_s)
        self.min_points = int(min_points)
        self.min_new_records = int(min_new_records)
        self.threshold = float(slope_eps)

    def check(self, store, now):
        s = store.get("train.loss")
        if s is None:
            return None, None, None
        pts = s.window((now if now is not None
                        else (s.last() or (0,))[0]) - self.window_s)
        if len(pts) < self.min_points:
            return None, None, None
        # span gate (the skew rule's warm-up twin): a judgment about a
        # trailing window needs a window's worth of data — the first
        # seconds of a run (loss briefly rising out of init noise) must
        # not read as a stall, and a run shorter than the window is
        # never judged at all (stalls are a sustained phenomenon)
        if pts[-1][0] - pts[0][0] < 0.8 * self.window_s:
            return None, None, None
        grew = store.delta("train.records", self.window_s, now)
        if grew is None or grew < self.min_new_records:
            return None, None, None
        t = np.asarray([p[0] for p in pts])
        v = np.asarray([p[1] for p in pts])
        slope = float(np.polyfit(t - t[0], v, 1)[0])
        return slope >= -self.threshold, slope, {
            "slope_per_sec": slope, "window_points": len(pts),
        }


class BottleneckShiftRule(AlertRule):
    """The analyst's online twin: fires when the DOMINANT
    regime changes mid-run — the ``analyze.regime_code`` series (fed by
    :func:`distkeras_tpu_torch.observability.analyze.regime_source` on traced
    watched runs) stops agreeing with the regime that has held for most
    of the run so far. A run that starts compute-bound and turns
    fsync-bound mid-flight is a disk filling its cache, a log device
    degrading, a straggler arriving — exactly the transition an
    operator wants paged on, and one no level-threshold rule can see.
    Resolves when the newest samples return to the run's dominant
    regime."""

    kind = "bottleneck_shift"

    def __init__(self, min_points: int = 4, **kw):
        kw.setdefault("persistence", 2)
        super().__init__(**kw)
        self.min_points = int(min_points)

    def check(self, store, now):
        from distkeras_tpu_torch.observability.analyze import REGIMES

        s = store.get("analyze.regime_code")
        pts = s.points() if s is not None else []
        if len(pts) < self.min_points:
            return None, None, None
        codes = [int(v) for _, v in pts]
        cur = codes[-1]
        # the run's dominant regime: the mode of everything BEFORE the
        # newest sample (so a genuine shift doesn't out-vote itself
        # only after half the run)
        prior = codes[:-1]
        dominant = max(set(prior), key=prior.count)
        firing = cur != dominant

        def name(c):
            return REGIMES[c] if 0 <= c < len(REGIMES) else str(c)

        return firing, float(cur), {
            "from": name(dominant), "to": name(cur),
            "samples": len(codes),
        }


def default_rules(slo: dict | None = None,
                  tau_bound: float = 16.0) -> list[AlertRule]:
    """The standard rule set — what ``watch=True`` installs. Serving
    rules only judge classes with data, PS rules only servers with the
    matching series (the bottleneck-shift rule needs a traced watched
    run to feed its regime series), so one set covers training and
    serving runs."""
    return [
        TauP95Rule(bound=tau_bound),
        CommitSkewRule(),
        CommitReplaySpikeRule(),
        WalFsyncTailRule(),
        RingOccupancyRule(),
        DeployLagRule(),
        ServingSLORule(slo=slo),
        PrefixHitRateRule(),
        LossStallRule(),
        BottleneckShiftRule(),
    ]


# -- the watchdog -------------------------------------------------------------

class Watchdog:
    """Evaluates rules over a store and keeps the alert ledger: the
    ``active`` set (currently firing), the transition ``log`` (every
    fire AND resolve, timestamped), and per-kind counters. ``hooks``
    are called with each transition — the trainer's ``watch_hook=``
    lands here."""

    def __init__(self, store: TimeSeriesStore,
                 rules: Iterable[AlertRule] | None = None,
                 hooks: Iterable[Callable] | None = None):
        self.store = store
        self.rules = list(rules) if rules is not None else default_rules()
        names = [r.name for r in self.rules]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.hooks = list(hooks or [])
        self._lock = threading.Lock()
        self.active: dict[str, Alert] = {}
        self.log: list[Alert] = []
        self.evaluations = 0

    def evaluate(self, now: float | None = None) -> list[Alert]:
        """One evaluation pass; returns this pass's transitions."""
        t = time.monotonic() if now is None else float(now)
        transitions: list[Alert] = []
        for rule in self.rules:
            firing, value, detail = rule.evaluate(self.store, t)
            with self._lock:
                was = rule.name in self.active
                if firing is None or firing == was:
                    continue
                alert = Alert(
                    rule=rule.name, kind=rule.kind,
                    severity=rule.severity,
                    state="firing" if firing else "resolved",
                    t=t, value=value, threshold=rule.threshold,
                    detail=detail,
                )
                if firing:
                    self.active[rule.name] = alert
                else:
                    self.active.pop(rule.name, None)
                self.log.append(alert)
                transitions.append(alert)
        for alert in transitions:
            for hook in self.hooks:
                try:
                    hook(alert)
                except Exception:  # noqa: BLE001 — observer must survive
                    pass
        with self._lock:
            self.evaluations += 1
        return transitions

    def counts(self) -> dict[str, int]:
        """Lifetime FIRE transitions per alert kind."""
        with self._lock:
            out: dict[str, int] = {}
            for a in self.log:
                if a["state"] == "firing":
                    out[a["kind"]] = out.get(a["kind"], 0) + 1
            return out

    def alerts_json(self) -> dict:
        from distkeras_tpu_torch.observability.metrics import _json_clean

        with self._lock:
            doc = {
                "active": sorted(self.active),
                "log": [dict(a) for a in self.log],
            }
        doc["counts"] = self.counts()
        return _json_clean(doc)


# -- the bundle ---------------------------------------------------------------

class Watchtower:
    """Store + scraper + watchdog in one attachable object.

    ``add_ps`` / ``add_progress`` / ``add_history`` / ``add_serving``
    register the standard sources; the watchdog evaluates after every
    scrape tick (rules always see fresh samples). Attach it to a
    serving ``SocketParameterServer`` / ``GenerationServer`` via their
    ``watchtower`` attribute and the ``metrics`` wire action carries
    the alert ledger to remote scrapers."""

    def __init__(self, rules: Iterable[AlertRule] | None = None,
                 interval: float = 1.0, capacity: int = 512,
                 hook: Callable | None = None):
        self.store = TimeSeriesStore(capacity=capacity)
        self.watchdog = Watchdog(self.store, rules=rules,
                                 hooks=[hook] if hook is not None else [])
        self.scraper = Scraper(self.store, interval=interval)
        self.scraper.on_tick(self.watchdog.evaluate)

    # -- source registration -------------------------------------------------

    def add_source(self, name: str, fn: Callable) -> None:
        self.scraper.add_source(name, fn)

    def add_ps(self, ps) -> None:
        self.add_source("ps", ps_source(ps))

    def add_progress(self, get_progress: Callable[[], dict]) -> None:
        self.add_source("progress", progress_source(get_progress))

    def add_history(self, history: list, lock=None) -> None:
        self.add_source("history", history_source(history, lock))

    def add_serving(self, engine) -> None:
        self.add_source("serving", serving_source(engine))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self.scraper.start()

    def stop(self) -> None:
        self.scraper.stop(final_tick=True)

    def tick(self, now: float | None = None) -> None:
        self.scraper.tick(now)

    # -- results -------------------------------------------------------------

    @property
    def alerts(self) -> list[Alert]:
        return list(self.watchdog.log)

    def alerts_json(self) -> dict:
        return self.watchdog.alerts_json()

    def dump(self, path: str) -> str:
        """One JSON artifact: every series + the alert ledger."""
        return self.store.dump(path, extra={"alerts": self.alerts_json()})


# -- live-endpoint watch mode (the CLI's engine) ------------------------------

def watch_endpoint(scrape: Callable[[], dict],
                   rules: Iterable[AlertRule] | None = None,
                   interval: float = 2.0, count: int = 0,
                   emit: Callable[[dict], None] | None = None,
                   sleep: Callable[[float], None] = time.sleep) -> Watchdog:
    """Poll a live server's ``metrics`` action and run the SAME watchdog
    rules over the scraped series, emitting alert transitions (plus any
    server-side alert ledger riding the reply) through ``emit``. Runs
    ``count`` polls (0 = forever); returns the watchdog for inspection.
    ``scrape`` is any zero-arg callable returning the metrics reply —
    the CLI passes its wire scraper, tests pass a fake. The returned
    watchdog carries ``remote_active`` (the server-side ledger's active
    set from the LAST poll) next to its own ``active`` — the CLI's
    exit code must reflect a firing alert wherever it lives."""
    from distkeras_tpu_torch.observability.metrics import wire_series_samples

    store = TimeSeriesStore()
    dog = Watchdog(store, rules=rules)
    dog.remote_active = []
    n = 0
    seen_remote = 0
    while True:
        now = time.monotonic()
        reply = scrape()
        for name, kind, value in wire_series_samples(
                reply.get("metrics", {})):
            store.sample(name, now, value, kind)
        for alert in dog.evaluate(now):
            if emit is not None:
                emit(dict(alert))
        # relay the SERVER-side ledger too (a watchtower attached to the
        # server sees sources — τ ring, shm occupancy — a remote scrape
        # cannot reconstruct from counters alone)
        ledger = reply.get("alerts") or {}
        remote = ledger.get("log") or []
        for alert in remote[seen_remote:]:
            if emit is not None:
                emit({"remote": True, **alert})
        seen_remote = len(remote)
        dog.remote_active = list(ledger.get("active") or [])
        n += 1
        if count and n >= count:
            return dog
        sleep(max(0.05, interval))
