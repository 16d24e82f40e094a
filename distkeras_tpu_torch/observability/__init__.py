"""Observability of the port: tracing and the unified metrics surface.

The port's copy of ``distkeras_tpu/observability/`` (pure Python and
numpy; the same metric names, wire replies, dump documents and reports):

- :mod:`distkeras_tpu_torch.observability.trace` — zero-cost-when-off
  spans (thread-local ring buffers, monotonic clocks) emitting Chrome
  trace-event JSON loadable in Perfetto, with a correlation id (worker id
  + seqno, or serving request id) stitching one exchange across the
  worker thread, the PS handler, the WAL flusher, chain replicas and the
  native C++ server's span ring.
- :mod:`distkeras_tpu_torch.observability.metrics` — a typed registry
  normalizing ``ps.stats()`` / serving / WAL counters into named metrics
  with Prometheus text and JSON snapshot exporters, served live by the
  ``metrics`` wire action of ``SocketParameterServer`` and
  ``GenerationServer``, plus the one-document
  :func:`~distkeras_tpu_torch.observability.metrics.health_snapshot`.
- :mod:`distkeras_tpu_torch.observability.timeseries` — the embedded
  time-series store (fixed-capacity downsampling ring series) and the
  background :class:`~distkeras_tpu_torch.observability.timeseries.Scraper`
  sampling the metrics surface into series over time.
- :mod:`distkeras_tpu_torch.observability.watch` — the watchtower:
  declarative typed alert rules (τ p95, commit-rate skew, dup/fenced
  spikes, WAL fsync tails, shm ring occupancy, deploy lag, per-class
  serving SLO, prefix hit rate, loss-slope stall, bottleneck shift)
  evaluated over those series, plus the ONE definition of rounds/s and
  of a straggler that ``ElasticPolicy`` reads too.
- :mod:`distkeras_tpu_torch.observability.analyze` — the analyst:
  post-hoc critical-path attribution over the recorded spans (per-worker
  waterfalls, pipelining overlap, center-lock/fsync/straggler wait
  attribution) ending in a typed regime verdict with knob-keyed
  recommendations; ``analyze=True`` on a trainer runs it post-run into
  ``trainer.analysis_``, and ``regime_source`` feeds the live regime
  series the watchtower's ``BottleneckShiftRule`` fires on.
- ``python -m distkeras_tpu_torch.observability`` — ``dump`` / ``tail``
  a live server's metrics, emit the ``health`` snapshot, ``health
  --watch`` a live server's alert transitions, or ``analyze`` a saved
  trace into the bottleneck report.

Trainer knobs: ``trace=True`` (enable), ``trace_dir=`` (write the
timeline file, path in ``trainer.trace_path_``) and ``trace_sample=``
(deterministic span sampling) on either backend; on the collective one
they record the engine's window (``engine.window``, ``engine.grads``,
``engine.forward``, ``engine.update``, ``engine.merge``) and the model's
parts (``lm.*``, ``flash.*``, ``fused_ce.*``). ``analyze=True`` and
``watch=True`` / ``watch_rules=`` / ``watch_dir=`` / ``scrape_interval=``
/ ``watch_hook=`` (the watchtower over a training run: alerts in
``trainer.watch_alerts_``, the dump path in ``trainer.watch_path_``)
need ``backend="ps"``. Spans are stamped on ``perf_counter_ns``;
``trace.unix_minus_monotonic_ns()`` (also in a saved file's
``otherData``) maps them onto the Unix time of ``torch.profiler``'s
traces, so a timeline lines up with a ``profile_dir`` trace.
"""

from distkeras_tpu_torch.observability import analyze, timeseries, trace, watch
from distkeras_tpu_torch.observability.metrics import (
    MetricsRegistry,
    health_snapshot,
    phase_metrics,
    ps_metrics,
    serving_metrics,
    trace_metrics,
)
from distkeras_tpu_torch.observability.timeseries import Scraper, TimeSeriesStore
from distkeras_tpu_torch.observability.watch import (
    Watchdog,
    Watchtower,
    default_rules,
)

__all__ = [
    "trace", "timeseries", "watch", "analyze", "MetricsRegistry", "ps_metrics",
    "serving_metrics", "phase_metrics", "trace_metrics",
    "health_snapshot", "TimeSeriesStore", "Scraper", "Watchdog",
    "Watchtower", "default_rules",
]
