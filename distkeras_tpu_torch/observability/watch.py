"""The single definitions of per-worker rounds/s and of a straggler.

The port's copy of ``rates_from_counts``, ``worker_rates``,
``rounds_per_sec`` and ``straggler_workers`` from
``distkeras_tpu/observability/watch.py``. ``ElasticPolicy``
(``resilience/elastic.py``) calls these and no private copy of them, over
the same ``worker.<wid>.windows`` series the elastic coordinator samples;
the watchtower's commit-skew rule will read the same two definitions.
The watchtower itself (``AlertRule`` and its rules, ``Watchdog``,
``Watchtower``, ``watch_endpoint``) belongs to ``ROADMAP.md`` A13 and is
not ported yet.
"""

from __future__ import annotations

import numpy as np

from distkeras_tpu_torch.observability.timeseries import TimeSeriesStore

__all__ = ["rates_from_counts", "worker_rates", "rounds_per_sec",
           "straggler_workers"]


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
