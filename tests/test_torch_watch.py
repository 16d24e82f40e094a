"""The port's watchtower (``distkeras_tpu_torch/observability/watch.py``)
held to the JAX package's: every rule, alone and in ``default_rules()``,
evaluated over the same series at the same fixed ``now`` values gives the
same results and the same alert transitions (name, firing, value); the
``Watchtower`` driven by ``Scraper.tick(now=)`` keeps equal series and an
equal ledger; a failing source is disabled after one warning in both;
``watch_endpoint`` over the same ``metrics`` replies emits the same
transitions; and ``ElasticPolicy`` reads the one straggler definition the
commit-skew rule evaluates. No test sleeps: every clock is fixed."""

import warnings

import pytest

from distkeras_tpu.observability import metrics as jmetrics
from distkeras_tpu.observability import timeseries as jts
from distkeras_tpu.observability import watch as jwatch
from distkeras_tpu_torch.observability import metrics as tmetrics
from distkeras_tpu_torch.observability import timeseries as tts
from distkeras_tpu_torch.observability import watch as twatch

PKGS = ((jwatch, jts, jmetrics), (twatch, tts, tmetrics))
STEPS = 120


def samples(t: float):
    """The scripted run at second ``t``: ``[(series, value, kind)]``. Each
    rule's condition holds over a stretch of it and clears again."""
    out = []
    for wid in range(3):
        # worker 2 slows to 0.1 windows/s between t = 40 and 70
        n = 2.0 * min(t, 40) + (0.1 if wid == 2 else 2.0) * max(
            0.0, min(t, 70) - 40) + 2.0 * max(0.0, t - 70)
        out.append((f"worker.{wid}.windows", float(int(n)), "counter"))
    out += [
        ("ps.tau_p95", 30.0 if 20 <= t < 30 else 3.0, "gauge"),
        ("ps.dup_commits", 10.0 if t >= 50 else 0.0, "counter"),
        ("ps.fenced_commits", 5.0 if t >= 90 else 0.0, "counter"),
        ("ps.wal_fsync_p95_ms", 80.0 if 60 <= t < 66 else 10.0, "gauge"),
        ("ps.deploy_version", 100.0 + 10 * t, "gauge"),
        ("ps.deploy_lag_folds", 900.0 if 75 <= t < 85 else 50.0, "gauge"),
        ("shm.ring_occupancy_frac", 0.95 if 30 <= t < 35 else 0.3, "gauge"),
        ("serve.lat.interactive.p50_ms", 30.0, "gauge"),
        ("serve.lat.interactive.p99_ms",
         500.0 if 80 <= t < 90 else 100.0, "gauge"),
        ("serve.lat.interactive.queue_ms", 5.0, "gauge"),
        ("serve.lat.interactive.prefill_ms", 7.0, "gauge"),
        ("serve.lat.interactive.decode_ms", 18.0, "gauge"),
        ("serve.lat.default.p99_ms", 1500.0 if 10 <= t < 14 else 200.0,
         "gauge"),
        ("serve.prefix_hit_rate", 0.01 if 95 <= t < 105 else 0.4, "gauge"),
        ("serve.prefix_cached_blocks", 12.0, "gauge"),
        ("serve.prefix_evictions", float(int(t // 10)), "counter"),
        ("serve.admitted", 10.0 * t, "counter"),
        ("train.loss", 2.0 - 0.01 * t if t < 60 else 1.4, "gauge"),
        ("train.records", 4.0 * t, "counter"),
        ("analyze.regime_code", 2.0 if t >= 100 else 0.0, "counter"),
    ]
    return out


def _rules(w):
    return [
        w.TauP95Rule(bound=10.0),
        w.CommitSkewRule(ratio=0.3),
        w.CommitReplaySpikeRule(),
        w.WalFsyncTailRule(p95_ms=40.0, persistence=2),
        w.DeployLagRule(bound=500.0),
        w.RingOccupancyRule(frac=0.9),
        w.ServingSLORule(slo={"interactive": (50.0, 200.0),
                              "default": w.SLOClass(p99_ms=1000.0)}),
        w.PrefixHitRateRule(floor=0.05, min_admitted=50),
        w.LossStallRule(window_s=20.0),
        w.BottleneckShiftRule(min_points=4),
    ]


def _drive(w, ts, rules):
    store = ts.TimeSeriesStore(capacity=64)   # downsamples along the way
    dog = w.Watchdog(store, rules=rules)
    trans = []
    for k in range(STEPS):
        now = float(k)
        for name, v, kind in samples(now):
            store.sample(name, now, v, kind)
        trans.append([(a["rule"], a.firing, a["value"])
                      for a in dog.evaluate(now=now)])
    return store, dog, trans


@pytest.mark.parametrize("which", ["explicit", "default"])
def test_rules_give_equal_transitions(which):
    outs = []
    for w, ts, _ in PKGS:
        rules = (_rules(w) if which == "explicit" else w.default_rules(
            slo={"interactive": (50.0, 200.0)}, tau_bound=10.0))
        outs.append(_drive(w, ts, rules))
    (js, jd, jt), (ps, pd, pt) = outs
    assert pt == jt
    assert pd.alerts_json() == jd.alerts_json()
    assert ps.to_json() == js.to_json()
    fired = {a["rule"] for a in pd.log if a["state"] == "firing"}
    if which == "explicit":
        # every rule's condition held somewhere in the script
        assert fired == {r.name for r in pd.rules}, fired
    assert pd.counts() == jd.counts()


@pytest.mark.parametrize("idx", range(10))
def test_each_rule_evaluates_equal_every_tick(idx):
    results = []
    for w, ts, _ in PKGS:
        rule = _rules(w)[idx]
        store = ts.TimeSeriesStore()
        res = []
        for k in range(STEPS):
            now = float(k)
            for name, v, kind in samples(now):
                store.sample(name, now, v, kind)
            res.append(rule.evaluate(store, now))
        results.append((rule.name, rule.kind, rule.severity,
                        rule.threshold, res))
    assert results[1] == results[0]


def _tower(w, ts, hook_log, bad: bool):
    tower = w.Watchtower(rules=_rules(w), interval=1.0, capacity=128,
                         hook=hook_log.append)

    def scripted(store, now):
        for name, v, kind in samples(now):
            store.sample(name, now, v, kind)

    tower.add_source("script", scripted)
    if bad:
        def broken(store, now):
            raise RuntimeError("source down")
        tower.add_source("broken", broken)
    return tower


def test_watchtower_ticks_with_fixed_clocks(tmp_path):
    docs = []
    for w, ts, _ in PKGS:
        hooks: list = []
        tower = _tower(w, ts, hooks, bad=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for k in range(STEPS):
                tower.tick(now=float(k))
        # the broken source warned once and was disabled, never again
        msgs = [str(c.message) for c in caught
                if "timeseries source" in str(c.message)]
        assert len(msgs) == 1 and "'broken'" in msgs[0]
        assert tower.scraper._dead == {"broken"}
        path = tower.dump(str(tmp_path / f"{w.__name__}.json.gz"))
        docs.append((tower.alerts_json(), tower.store.to_json(),
                     [dict(a) for a in hooks], ts.TimeSeriesStore.load(
                         path).to_json()))
    assert docs[1] == docs[0]
    assert docs[1][2] == docs[1][0]["log"]   # the hook saw every transition


def test_scraper_stop_runs_a_final_tick():
    for _, ts, _ in PKGS:
        store = ts.TimeSeriesStore()
        sc = ts.Scraper(store, interval=30.0)
        sc.add_source("one", lambda s, now: s.sample("x", now, 1.0))
        sc.start()
        sc.stop()            # no wait for the interval: the final tick
        assert sc.ticks == 1 and store.last("x") == 1.0
        with pytest.raises(ValueError, match="interval"):
            ts.Scraper(store, interval=0)


def _ps_stats(k: int) -> dict:
    """A PS stats dict as the server reports it, its counters moving."""
    return {"pulls": 10 * k, "commits": 10 * k, "dup_commits": 3 * k,
            "fenced_commits": 0, "num_updates": 10 * k,
            "active_workers": 4, "pool_size": 4, "wal_fsyncs": k,
            "deploy_version": 10 * k, "deploy_lag_folds": 600 if k > 2
            else 0, "bytes_in": 1000 * k}


def test_watch_endpoint_relays_equal_transitions(monkeypatch):
    emitted = ([], [])
    for i, (w, ts, m) in enumerate(PKGS):
        k = [0]

        def scrape(m=m, w=w):
            k[0] += 1
            reply = m.metrics_reply(m.ps_metrics(_ps_stats(k[0])))
            reply["alerts"] = {"active": ["tau_p95"] if k[0] > 3 else [],
                               "log": [{"rule": "tau_p95", "t": 1.0}]
                               if k[0] > 3 else []}
            return reply

        clock = iter(float(x) for x in range(100))
        monkeypatch.setattr(w.time, "monotonic", lambda: next(clock))
        dog = w.watch_endpoint(
            scrape, rules=[w.DeployLagRule(bound=500.0),
                           w.CommitReplaySpikeRule(max_in_window=2.0)],
            count=6, emit=emitted[i].append, sleep=lambda s: None)
        monkeypatch.undo()
        assert dog.remote_active == ["tau_p95"]
    assert emitted[1] == emitted[0]
    assert any(e.get("remote") for e in emitted[1])
    assert any(e.get("rule") == "deploy_lag" for e in emitted[1])


def test_wire_metrics_source_feeds_the_in_process_series_names():
    stores = []
    for w, ts, m in PKGS:
        store = ts.TimeSeriesStore()
        reply = m.metrics_reply(m.ps_metrics(dict(
            _ps_stats(3), per_shard=[dict(_ps_stats(1), shard_id=0),
                                     dict(_ps_stats(2), shard_id=1)])))
        ts.wire_metrics_source(lambda r=reply: r)(store, 5.0)
        stores.append(store.to_json())
    assert stores[1] == stores[0]
    assert "ps.commits" in stores[1]["series"]
    assert "ps.shard1.commits" in stores[1]["series"]


def test_elastic_policy_reads_the_one_straggler_definition():
    from distkeras_tpu_torch.resilience import elastic

    assert elastic.straggler_workers is twatch.straggler_workers
    rates = {0: 2.0, 1: 2.1, 2: 0.3, 3: 1.9}
    assert twatch.straggler_workers(rates, 0.25) == \
        jwatch.straggler_workers(rates, 0.25)
    assert twatch.rates_from_counts(0.0, {0: 1}, 2.0, {0: 5, 1: 4}) == \
        jwatch.rates_from_counts(0.0, {0: 1}, 2.0, {0: 5, 1: 4})
