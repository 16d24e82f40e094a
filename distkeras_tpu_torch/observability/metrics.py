"""Unified metrics surface: typed registry + Prometheus/JSON exporters.

Every subsystem in the rebuild already counts — ``ps.stats()`` /
``aggregate_ps_stats`` (PS contention, WAL, elastic membership),
``GenerationServer.stats()`` (serving), the worker phase histograms —
but each with its own ad-hoc dict shape. This module normalizes them
into ONE registry of *typed* metrics (counter / gauge / histogram) with
two exporters:

- :meth:`MetricsRegistry.to_prometheus` — the text exposition format
  (``# HELP`` / ``# TYPE`` + samples; version 0.0.4), served live from
  ``SocketParameterServer`` and ``GenerationServer`` via the ``metrics``
  wire action and scraped by ``python -m distkeras_tpu_torch.observability``;
- :meth:`MetricsRegistry.to_json` — a JSON-clean snapshot (the shape the
  health snapshot and CI artifacts embed).

The normalizers (:func:`ps_metrics`, :func:`serving_metrics`,
:func:`wal_metrics`, :func:`phase_metrics`) own the stat-key → metric
mapping, so a new counter lands on the wire by adding ONE schema row —
not another bespoke dump. :func:`health_snapshot` folds WAL health
(``resilience.wal.verify_tree``), metrics, and membership into one JSON
document — the single health artifact that replaces the separate
wal-verify / ps-stats / membership dumps.
"""

from __future__ import annotations

import time
from typing import Any, Iterable

__all__ = [
    "Metric", "MetricsRegistry", "ps_metrics", "serving_metrics",
    "wal_metrics", "phase_metrics", "trace_metrics", "health_snapshot",
    "wire_series_samples", "metrics_reply",
]

_KINDS = ("counter", "gauge", "histogram")


class Metric:
    """One named metric: a kind, help text, and labeled samples.

    ``samples`` is a list of ``(labels, value)`` where ``labels`` is a
    (possibly empty) tuple of ``(key, value)`` pairs — tuples, not
    dicts, so a (name, labels) series is hashable and re-observing it
    overwrites rather than duplicates. Histogram values are dicts
    ``{"buckets": [(le, cumulative_count), ...], "sum": s, "count": n}``
    with ``le`` ascending and an implicit ``+Inf`` == ``count``.
    """

    __slots__ = ("name", "kind", "help", "_samples")

    def __init__(self, name: str, kind: str, help_: str = ""):
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help_
        self._samples: dict[tuple, Any] = {}

    def observe(self, value, labels: dict | None = None) -> None:
        key = tuple(sorted((labels or {}).items()))
        self._samples[key] = value

    @property
    def samples(self) -> list[tuple[tuple, Any]]:
        return list(self._samples.items())


class MetricsRegistry:
    """Insertion-ordered collection of :class:`Metric` (one per name;
    re-declaring with a different kind is a programming error and raises
    — the registry is what keeps the surface *typed*)."""

    def __init__(self):
        self._metrics: dict[str, Metric] = {}

    def declare(self, name: str, kind: str, help_: str = "") -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Metric(name, kind, help_)
        elif m.kind != kind:
            raise ValueError(
                f"metric {name!r} already declared as {m.kind}, "
                f"cannot re-declare as {kind}"
            )
        return m

    def counter(self, name: str, value, labels: dict | None = None,
                help_: str = "") -> None:
        self.declare(name, "counter", help_).observe(value, labels)

    def gauge(self, name: str, value, labels: dict | None = None,
              help_: str = "") -> None:
        self.declare(name, "gauge", help_).observe(value, labels)

    def histogram(self, name: str, buckets: list[tuple[float, int]],
                  sum_: float, count: int, labels: dict | None = None,
                  help_: str = "") -> None:
        self.declare(name, "histogram", help_).observe(
            {"buckets": list(buckets), "sum": float(sum_),
             "count": int(count)}, labels,
        )

    def __iter__(self) -> Iterable[Metric]:
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    # -- exporters -----------------------------------------------------------

    def to_json(self) -> dict:
        """JSON-clean snapshot: ``{name: {"kind", "help", "samples":
        [{"labels": {...}, "value": ...}]}}``."""
        out = {}
        for m in self:
            out[m.name] = {
                "kind": m.kind, "help": m.help,
                "samples": [
                    {"labels": dict(lbl), "value": val}
                    for lbl, val in m.samples
                ],
            }
        return out

    def to_prometheus(self) -> str:
        """Text exposition (0.0.4): HELP/TYPE headers + one line per
        sample; counters get the ``_total`` suffix convention from their
        declared name (the schemas below already carry it); histograms
        expand to ``_bucket{le=...}`` / ``_sum`` / ``_count``."""
        lines = []
        for m in self:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for lbl, val in m.samples:
                if m.kind == "histogram":
                    for le, c in val["buckets"]:
                        lines.append(_sample_line(
                            m.name + "_bucket",
                            lbl + (("le", _fmt_le(le)),), c))
                    lines.append(_sample_line(
                        m.name + "_bucket", lbl + (("le", "+Inf"),),
                        val["count"]))
                    lines.append(_sample_line(m.name + "_sum", lbl,
                                              val["sum"]))
                    lines.append(_sample_line(m.name + "_count", lbl,
                                              val["count"]))
                else:
                    lines.append(_sample_line(m.name, lbl, val))
        return "\n".join(lines) + "\n"


def _fmt_le(le) -> str:
    return "+Inf" if le in (None, float("inf")) else repr(float(le))


def _sample_line(name: str, labels: tuple, value) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape(str(v))}"' for k, v in labels
        )
        name = f"{name}{{{body}}}"
    if isinstance(value, float):
        return f"{name} {value!r}"
    return f"{name} {value}"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


# -- normalizers: stats dicts → typed metrics --------------------------------

#: ``ps.stats()`` key → (metric name, kind, help). Rates and derived
#: means are EXCLUDED by design: Prometheus derives rates from counters
#: (``rate()``), and re-exporting ours would double-encode them; the
#: JSON snapshot keeps the raw stats dict next to the metrics anyway.
_PS_SCHEMA: tuple[tuple[str, str, str, str], ...] = (
    ("pulls", "dk_ps_pulls_total", "counter", "raw center pulls served"),
    ("compressed_pulls", "dk_ps_compressed_pulls_total", "counter",
     "int8 error-feedback pulls served"),
    ("commits", "dk_ps_commits_total", "counter", "commits folded"),
    ("dup_commits", "dk_ps_dup_commits_total", "counter",
     "replayed commits the seqno dedup refused to double-fold"),
    ("fused_exchanges", "dk_ps_fused_exchanges_total", "counter",
     "single-RTT fused commit+pull exchanges served"),
    ("batched_folds", "dk_ps_batched_folds_total", "counter",
     "folds applied inside a multi-fold center-lock section "
     "(batched local exchange)"),
    ("exchange_rtts", "dk_ps_exchange_rtts_total", "counter",
     "wire round trips spent on exchange traffic"),
    ("fenced_commits", "dk_ps_fenced_commits_total", "counter",
     "commits rejected by the fencing epoch"),
    ("bytes_in", "dk_ps_bytes_in_total", "counter",
     "payload bytes received (commit direction, wire size)"),
    ("bytes_out", "dk_ps_bytes_out_total", "counter",
     "payload bytes sent (pull direction, wire size)"),
    ("center_lock_acquires", "dk_ps_center_lock_acquires_total",
     "counter", "center-lock acquisitions"),
    ("center_lock_wait_ns", "dk_ps_center_lock_wait_ns_total", "counter",
     "total ns spent waiting on the center lock"),
    ("center_lock_hold_ns", "dk_ps_center_lock_hold_ns_total", "counter",
     "total ns the center lock was held"),
    ("num_updates", "dk_ps_num_updates", "gauge",
     "lifetime fold count (durable across failover)"),
    ("active_workers", "dk_ps_active_workers", "gauge",
     "workers holding a live lease"),
    ("evicted_workers", "dk_ps_evicted_workers_total", "counter",
     "lease-lapse evictions"),
    ("heartbeats", "dk_ps_heartbeats_total", "counter",
     "lease renewals received"),
    ("worker_retries", "dk_ps_worker_retries_total", "counter",
     "cumulative client retry count (as reported by heartbeats)"),
    ("wal_records", "dk_ps_wal_records_total", "counter",
     "WAL records appended"),
    ("wal_fsyncs", "dk_ps_wal_fsyncs_total", "counter",
     "real fsync syscalls issued by the WAL"),
    ("wal_group_max", "dk_ps_wal_group_max", "gauge",
     "largest commit window one fsync ever released"),
    ("pool_size", "dk_ps_pool_size", "gauge",
     "elastic worker pool gauge (configured + joins - drains)"),
    ("joined_workers", "dk_ps_joined_workers_total", "counter",
     "lifetime elastic live-joins"),
    ("preempted_workers", "dk_ps_preempted_workers_total", "counter",
     "lifetime preemption drains"),
    ("drain_timeouts", "dk_ps_drain_timeouts_total", "counter",
     "drains whose deadline lapsed into force-drain"),
    ("elapsed_s", "dk_ps_uptime_seconds", "gauge",
     "seconds since server construction"),
    ("deploy_version", "dk_ps_deploy_version", "gauge",
     "newest fold-count version the serving tier reported materialized"),
    ("deploy_lag_folds", "dk_ps_deploy_lag_folds", "gauge",
     "folds the center is ahead of the newest served snapshot "
     "(0 until a deployer reports a version)"),
)

_SERVING_SCHEMA: tuple[tuple[str, str, str, str], ...] = (
    ("submitted", "dk_serve_submitted_total", "counter",
     "requests accepted into the admission queue"),
    ("admitted", "dk_serve_admitted_total", "counter",
     "requests admitted into the running batch"),
    ("completed", "dk_serve_completed_total", "counter",
     "requests finished successfully"),
    ("cancelled", "dk_serve_cancelled_total", "counter",
     "requests cancelled (client death / explicit cancel)"),
    ("rejected", "dk_serve_rejected_total", "counter",
     "requests rejected by queue backpressure"),
    ("failed", "dk_serve_failed_total", "counter", "requests failed"),
    ("steps", "dk_serve_decode_steps_total", "counter",
     "batched decode iterations executed"),
    ("prefills", "dk_serve_prefills_total", "counter",
     "per-request prefills executed"),
    ("tokens_generated", "dk_serve_tokens_generated_total", "counter",
     "new tokens emitted by completed requests"),
    ("occupancy_sum", "dk_serve_occupancy_sum_total", "counter",
     "sum over steps of active batch rows (mean = /steps)"),
    ("spec_rounds", "dk_serve_spec_rounds_total", "counter",
     "speculative verify rounds"),
    ("spec_proposed", "dk_serve_spec_proposed_total", "counter",
     "draft tokens proposed"),
    ("spec_accepted", "dk_serve_spec_accepted_total", "counter",
     "draft tokens accepted"),
    ("connections", "dk_serve_connections_total", "counter",
     "client connections accepted"),
    ("open_connections", "dk_serve_open_connections", "gauge",
     "currently open client connections"),
    ("dead_connections", "dk_serve_dead_connections_total", "counter",
     "clients detected dead mid-generation"),
    ("queued", "dk_serve_queue_depth", "gauge",
     "requests waiting in the admission queue"),
    ("active", "dk_serve_active_requests", "gauge",
     "requests currently occupying batch rows"),
    ("blocks_in_use", "dk_serve_blocks_in_use", "gauge",
     "KV-cache blocks allocated to live requests"),
    ("blocks_free", "dk_serve_blocks_free", "gauge",
     "KV-cache blocks free in the pool"),
    ("blocks_high_water", "dk_serve_blocks_high_water", "gauge",
     "peak concurrent KV-cache block allocation"),
    # the serving front door: prefix-cache reuse, COW, and
    # SLO-admission preemption counters — absent keys simply don't emit,
    # so engines without the front door keep their exact legacy surface
    ("prefix_hit_tokens", "dk_serve_prefix_hit_tokens_total", "counter",
     "prompt tokens served from the radix prefix cache"),
    ("prefix_prompt_tokens", "dk_serve_prefix_prompt_tokens_total",
     "counter", "prompt tokens admitted (hit-rate denominator)"),
    ("prefix_hit_rate", "dk_serve_prefix_hit_rate", "gauge",
     "lifetime token-level prefix-cache hit rate"),
    ("prefix_cached_blocks", "dk_serve_prefix_cached_blocks", "gauge",
     "KV blocks currently owned by the radix prefix cache"),
    ("prefix_evictions", "dk_serve_prefix_evictions_total", "counter",
     "cached blocks evicted (LRU refcount-0 leaves)"),
    ("cow_copies", "dk_serve_prefix_cow_copies_total", "counter",
     "copy-on-write block copies (partial-block divergence)"),
    ("preemptions", "dk_serve_preemptions_total", "counter",
     "running rows preempted for higher-SLO admissions"),
)


def _apply_schema(reg: MetricsRegistry, schema, stats: dict,
                  labels: dict | None) -> None:
    for key, name, kind, help_ in schema:
        if key not in stats:
            continue
        val = stats[key]
        if kind == "counter":
            reg.counter(name, val, labels, help_)
        else:
            reg.gauge(name, val, labels, help_)


def ps_metrics(stats: dict, labels: dict | None = None,
               registry: MetricsRegistry | None = None) -> MetricsRegistry:
    """Normalize one ``ps.stats()`` dict — or an ``aggregate_ps_stats``
    roll-up, whose ``per_shard`` list fans out into ``shard``-labeled
    series next to the aggregate — into the registry."""
    reg = registry if registry is not None else MetricsRegistry()
    _apply_schema(reg, _PS_SCHEMA, stats, labels)
    for shard in stats.get("per_shard", ()):
        lbl = dict(labels or {})
        lbl["shard"] = str(shard.get("shard_id", "?"))
        _apply_schema(reg, _PS_SCHEMA, shard, lbl)
    phases = stats.get("exchange_phases")
    if phases:
        phase_metrics(phases, labels=labels, registry=reg)
    return reg


#: serving latency-summary keys (per SLO class, from the engine's
#: retired-request ring) → gauge names; the class rides as a label
_SERVE_LATENCY_KEYS: tuple[tuple[str, str, str], ...] = (
    ("p50_ms", "dk_serve_latency_p50_ms",
     "median end-to-end request latency (ms)"),
    ("p99_ms", "dk_serve_latency_p99_ms",
     "p99 end-to-end request latency (ms)"),
    ("queue_ms", "dk_serve_latency_queue_ms",
     "mean admission-queue wait (ms)"),
    ("prefill_ms", "dk_serve_latency_prefill_ms",
     "mean prefill time (ms)"),
    ("decode_ms", "dk_serve_latency_decode_ms",
     "mean decode time (ms)"),
)


def serving_metrics(stats: dict, labels: dict | None = None,
                    registry: MetricsRegistry | None = None,
                    ) -> MetricsRegistry:
    """Normalize a ``GenerationServer.stats()`` /
    ``GenerationEngine.stats()`` dict — including the per-SLO-class
    latency summary (``stats["latency"]``), which fans out into
    ``class``-labeled gauges."""
    reg = registry if registry is not None else MetricsRegistry()
    _apply_schema(reg, _SERVING_SCHEMA, stats, labels)
    for cls, rec in (stats.get("latency") or {}).items():
        lbl = dict(labels or {})
        lbl["class"] = str(cls)
        for key, name, help_ in _SERVE_LATENCY_KEYS:
            if key in rec:
                reg.gauge(name, rec[key], lbl, help_)
        if "count" in rec:
            # a gauge, not a counter: the count is of records currently
            # inside a bounded ring — eviction can shrink a class's
            # count, and Prometheus rate() over a "counter" would read
            # that dip as a reset spike
            reg.gauge("dk_serve_latency_observations",
                      rec["count"], lbl,
                      "retired requests behind the latency summary "
                      "(bounded-ring occupancy, not a lifetime total)")
    return reg


def trace_metrics(registry: MetricsRegistry | None = None,
                  labels: dict | None = None) -> MetricsRegistry:
    """The flight recorder's own health as metrics: whether tracing is
    on and — the previously-silent signal — how many spans the
    drop-oldest ring overflow discarded (``trace_dropped_spans``). Zero
    dropped means the timeline is complete; anything else says which
    runs need a bigger ``ring_size``."""
    from distkeras_tpu_torch.observability import trace

    reg = registry if registry is not None else MetricsRegistry()
    enabled = trace.enabled()
    reg.gauge("dk_trace_enabled", int(enabled), labels,
              "flight recorder on (1) / off (0)")
    reg.counter("dk_trace_dropped_spans_total",
                trace.dropped_spans(), labels,
                "spans lost to ring-buffer overflow (drop-oldest)")
    return reg


def metrics_reply(registry: MetricsRegistry, watchtower=None) -> dict:
    """Build THE ``metrics`` wire-action reply — the one shape every
    server (socket PS, shm PS, generation server) sends, so the wire
    surfaces cannot drift: the registry (with the flight recorder's
    overflow counter folded in) as JSON + Prometheus text, plus the
    alert ledger when a watchtower is attached."""
    trace_metrics(registry=registry)
    reply = {
        "ok": True, "metrics": registry.to_json(),
        "prom": registry.to_prometheus(),
    }
    if watchtower is not None:
        reply["alerts"] = watchtower.alerts_json()
    return reply


#: wire metric name → (series name, series kind): the inverse of the
#: schemas above, so a REMOTE scrape of the ``metrics`` action feeds
#: the same series names the in-process sources use and the watchdog
#: rules run unchanged (observability/watch.py ``watch_endpoint``).
_WIRE_TO_SERIES: dict[str, tuple[str, str]] = {
    name: (f"ps.{key}", "counter" if kind == "counter" else "gauge")
    for key, name, kind, _ in _PS_SCHEMA
}
_WIRE_TO_SERIES.update({
    name: (f"serve.{key}", "counter" if kind == "counter" else "gauge")
    for key, name, kind, _ in _SERVING_SCHEMA
})
_WIRE_LATENCY_TO_SERIES: dict[str, str] = {
    name: key for key, name, _ in _SERVE_LATENCY_KEYS
}


def wire_series_samples(metrics_json: dict):
    """Yield ``(series_name, kind, value)`` for every recognizable
    sample in a ``metrics`` wire reply's JSON snapshot. Shard-labeled
    PS samples land under ``ps.shard<id>.<key>``; class-labeled serving
    latency gauges under ``serve.lat.<class>.<key>`` — the exact names
    the in-process sources write."""
    for name, doc in (metrics_json or {}).items():
        for s in doc.get("samples", ()):
            value = s.get("value")
            if not isinstance(value, (int, float)):
                continue
            lbl = s.get("labels") or {}
            if name in _WIRE_LATENCY_TO_SERIES and "class" in lbl:
                yield (f"serve.lat.{lbl['class']}."
                       f"{_WIRE_LATENCY_TO_SERIES[name]}",
                       "gauge", value)
                continue
            mapped = _WIRE_TO_SERIES.get(name)
            if mapped is None:
                continue
            series, kind = mapped
            if "shard" in lbl:
                base = series[len("ps."):]
                yield f"ps.shard{lbl['shard']}.{base}", kind, value
            elif not lbl:
                yield series, kind, value


def phase_metrics(phases: dict, labels: dict | None = None,
                  registry: MetricsRegistry | None = None,
                  ) -> MetricsRegistry:
    """Normalize the worker exchange-phase histograms
    (``trainer.ps_stats_["exchange_phases"]`` — per-phase count/total/
    max + log2 ms buckets) into ONE Prometheus histogram labeled by
    phase."""
    reg = registry if registry is not None else MetricsRegistry()
    for phase, rec in phases.items():
        lbl = dict(labels or {})
        lbl["phase"] = phase
        edges = [e for e in rec.get("hist_ms_le", []) if e != "inf"]
        counts = rec.get("hist", [])
        cum, buckets = 0, []
        for le, c in zip(edges, counts):
            cum += c
            buckets.append((float(le), cum))
        reg.histogram(
            "dk_worker_exchange_phase_ms", buckets,
            rec.get("total_ms", 0.0), rec.get("count", 0), lbl,
            "per-window exchange phase latency (ms) by phase",
        )
        reg.gauge("dk_worker_exchange_phase_max_ms", rec.get("max_ms", 0.0),
                  lbl, "worst single phase sample (ms)")
    return reg


# -- the one health document -------------------------------------------------

_MEMBERSHIP_KEYS = (
    "pool_size", "active_workers", "joined_workers", "preempted_workers",
    "drain_timeouts", "evicted_workers", "num_updates",
)


def health_snapshot(wal_root: str | None = None,
                    ps_stats: dict | None = None,
                    serving_stats: dict | None = None,
                    watchtower=None, directory=None) -> dict:
    """ONE JSON health document: WAL health (``verify_tree`` — CRC-valid
    prefixes, torn tails, record totals), the normalized metrics
    snapshot, the membership gauges, the flight recorder's overflow
    counter, the live shm segment inventory, and — when a
    :class:`~distkeras_tpu_torch.observability.watch.Watchtower` (or a
    watchdog / pre-built alert ledger) is passed — the alert ledger.
    Replaces the separate ad-hoc dumps CI used to collect
    independently. Every section is optional; ``ok`` is the AND of the
    sections that can fail (an ACTIVE alert fails it — that is what an
    alert is for)."""
    out: dict = {"ok": True, "generated_unix_s": time.time()}
    if wal_root is not None:
        from distkeras_tpu_torch.resilience.wal import verify_tree

        wal = verify_tree(wal_root)
        out["wal"] = wal
        out["ok"] = out["ok"] and bool(wal.get("ok"))
    reg = MetricsRegistry()
    if ps_stats is not None:
        ps_metrics(ps_stats, registry=reg)
        out["membership"] = {
            k: ps_stats[k] for k in _MEMBERSHIP_KEYS if k in ps_stats
        }
        out["ps_stats"] = _json_clean(ps_stats)
    if serving_stats is not None:
        serving_metrics(serving_stats, registry=reg)
        out["serving_stats"] = _json_clean(serving_stats)
    # the flight recorder's overflow is otherwise silent:
    # a truncated timeline must be visible as a number, not a surprise
    from distkeras_tpu_torch.observability import trace

    out["trace"] = {"enabled": trace.enabled(),
                    "dropped_spans": trace.dropped_spans()}
    trace_metrics(registry=reg)
    # live /dev/shm segment inventory: the no-leak property
    # operator-visible — an empty list after a run IS the proof
    from distkeras_tpu_torch import shm as _shm

    out["shm"] = _shm.segment_inventory()
    if directory is not None:
        # membership-directory view: per-entry endpoint,
        # fence epoch, and lease age — an out-of-date registration or a
        # lapsing lease is operator-visible, not silent. Accepts the
        # membership dict itself or anything with .membership()
        # (DirectoryServer, DirectoryClient, HostedDirectory).
        view = (directory.membership()
                if hasattr(directory, "membership") else directory)
        out["directory"] = _json_clean(view)
    if watchtower is not None:
        alerts = (watchtower.alerts_json()
                  if hasattr(watchtower, "alerts_json") else watchtower)
        out["alerts"] = _json_clean(alerts)
        out["ok"] = out["ok"] and not alerts.get("active")
    if len(reg):
        out["metrics"] = reg.to_json()
    return out


def _json_clean(obj):
    """Best-effort JSON coercion for stats dicts (numpy scalars etc.)."""
    import numpy as np

    if isinstance(obj, dict):
        return {str(k): _json_clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_clean(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj
