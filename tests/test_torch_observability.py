"""The port's metrics surface, time-series store, tracer additions, the
serving scheduler's spans and the ``python -m
distkeras_tpu_torch.observability`` CLI, held to the JAX package's.

- metrics: one stats dict (a port PS run's, and a synthetic one with every
  schema key) through ``ps_metrics``, ``serving_metrics``,
  ``phase_metrics`` and ``metrics_reply`` in both packages: equal JSON
  snapshots and byte-equal Prometheus text; the servers' ``metrics``
  action answers with that reply.
- timeseries: each package's ``dump()`` (plain and gzipped, downsampled)
  loads in the other's ``TimeSeriesStore.load`` with equal points.
- trace: overflow counters, foreign events, the end-time cursor, rotation.
- the CLI: ``dump``, ``tail``, ``health`` (also ``--watch --count``) and
  ``analyze`` of both packages against a port socket PS and a port
  ``GenerationServer`` on the CPU, with equal exit codes."""

import json
import os

import numpy as np
import pytest
import torch

from distkeras_tpu.observability import __main__ as jcli
from distkeras_tpu.observability import metrics as jm
from distkeras_tpu.observability import timeseries as jts
from distkeras_tpu.observability import trace as jtrace
from distkeras_tpu_torch import trainers
from distkeras_tpu_torch.data import Dataset
from distkeras_tpu_torch.models import mlp as torch_mlp
from distkeras_tpu_torch.observability import __main__ as tcli
from distkeras_tpu_torch.observability import metrics as tm
from distkeras_tpu_torch.observability import timeseries as tts
from distkeras_tpu_torch.observability import trace as ttrace
from distkeras_tpu_torch.observability import watch as twatch
from distkeras_tpu_torch.parallel import merge_rules as tr
from distkeras_tpu_torch import parameter_servers as tps


def _blobs(n=512, dim=16, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3.0, size=(classes, dim)).astype(np.float32)
    labels = rng.integers(0, classes, size=n).astype(np.int32)
    x = centers[labels] + rng.normal(0, 1.0, size=(n, dim)).astype(np.float32)
    return x, labels


@pytest.fixture(scope="module")
def ps_run(tmp_path_factory):
    """A small port PS run over the socket transport with a WAL: its
    ``ps_stats_`` (every counter moved, exchange phases included) and the
    WAL directory."""
    wal = str(tmp_path_factory.mktemp("wal"))
    t = trainers.DynSGD(
        torch_mlp(input_shape=(16,), hidden=(16,), num_classes=4,
                  dtype=torch.float32),
        loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
        learning_rate=0.1, num_workers=2, batch_size=32, num_epoch=1,
        communication_window=2, backend="ps", ps_transport="socket",
        ps_wal_dir=wal, device="cpu")
    t.train(Dataset.from_arrays(*_blobs()), shuffle=True)
    return t.ps_stats_, wal


def _synthetic_ps_stats() -> dict:
    st = {}
    for i, (key, _, kind, _) in enumerate(jm._PS_SCHEMA):
        st[key] = (i * 7 + 3) if kind == "counter" else (0.1 + 0.2) * i
    st["elapsed_s"] = 12.345678901234
    st["per_shard"] = [dict(st, shard_id=s, commits=s + 1) for s in range(2)]
    st["exchange_phases"] = {
        ph: {"count": 5, "total_ms": 12.5 + k, "max_ms": 4.25,
             "hist": [1, 2, 0, 2, 0], "hist_ms_le": [1, 2, 4, 8, "inf"]}
        for k, ph in enumerate(("compute", "fetch", "commit"))}
    return st


def _synthetic_serving_stats() -> dict:
    st = {key: i + 1 for i, (key, *_rest) in enumerate(jm._SERVING_SCHEMA)}
    st["prefix_hit_rate"] = 1 / 3
    st["latency"] = {
        "interactive": {"p50_ms": 12.5, "p99_ms": 80.0, "queue_ms": 1.0,
                        "prefill_ms": 3.0, "decode_ms": 8.5, "count": 9},
        "batch": {"p50_ms": 120.0, "count": 2}}
    return st


def _without_trace(reply: dict) -> tuple[dict, list]:
    """A ``metrics`` reply minus the flight recorder's two metrics (each
    package counts its own recorder's process-lifetime overflow)."""
    metrics = {k: v for k, v in reply["metrics"].items()
               if not k.startswith("dk_trace_")}
    prom = [ln for ln in reply["prom"].splitlines()
            if "dk_trace_" not in ln]
    return metrics, prom


@pytest.mark.parametrize("source", ["port_run", "synthetic"])
def test_ps_metrics_json_and_prometheus_equal(ps_run, source):
    stats = ps_run[0] if source == "port_run" else _synthetic_ps_stats()
    j, t = jm.ps_metrics(stats), tm.ps_metrics(stats)
    assert t.to_json() == j.to_json()
    assert t.to_prometheus() == j.to_prometheus()
    lbl = {"job": "x"}
    assert tm.ps_metrics(stats, labels=lbl).to_prometheus() == \
        jm.ps_metrics(stats, labels=lbl).to_prometheus()
    ph = stats["exchange_phases"]
    assert tm.phase_metrics(ph).to_prometheus() == \
        jm.phase_metrics(ph).to_prometheus()
    if source == "port_run":
        names = set(t.to_json())
        assert {"dk_ps_commits_total", "dk_ps_wal_fsyncs_total",
                "dk_worker_exchange_phase_ms"} <= names


def test_serving_metrics_and_reply_equal():
    stats = _synthetic_serving_stats()
    j, t = jm.serving_metrics(stats), tm.serving_metrics(stats)
    assert t.to_json() == j.to_json()
    assert t.to_prometheus() == j.to_prometheus()
    jr = jm.metrics_reply(jm.serving_metrics(stats))
    pr = tm.metrics_reply(tm.serving_metrics(stats))
    assert set(pr) == set(jr) == {"ok", "metrics", "prom"}
    assert _without_trace(pr) == _without_trace(jr)
    assert pr["metrics"]["dk_trace_dropped_spans_total"]["samples"][0][
        "value"] == ttrace.dropped_spans()


def _scrape_stats_of(server):
    """Wrap ``server.stats`` to keep what the next call returns."""
    seen = []
    orig = server.stats

    def stats(*a, **kw):
        seen.append(orig(*a, **kw))
        return seen[-1]

    server.stats = stats
    return seen


def test_socket_ps_metrics_action_with_alert_ledger():
    ps = tps.SocketParameterServer({"w": np.zeros(4, np.float32)},
                                   tr.ADAGMerge(), num_workers=1)
    ps.initialize()
    ps.start()
    try:
        c = tps.ParameterServerClient("127.0.0.1", ps.port, 0, timeout=60.0)
        c.commit(0, {"w": np.ones(4, np.float32)})
        c.close()
        tower = twatch.Watchtower(rules=[twatch.TauP95Rule(bound=1.0)])
        tower.add_source("tau", lambda s, now: s.sample("ps.tau_p95", now,
                                                        5.0))
        tower.tick(now=0.0)
        ps.watchtower = tower
        seen = _scrape_stats_of(ps)
        reply = tcli._scrape("127.0.0.1", ps.port)
        want = jm.metrics_reply(jm.ps_metrics(seen[-1]), tower)
        assert set(reply) == set(want) == {"ok", "metrics", "prom",
                                           "alerts"}
        assert _without_trace(reply) == _without_trace(want)
        assert reply["alerts"] == tower.alerts_json()
        assert reply["alerts"]["active"] == ["tau_p95"]
    finally:
        ps.stop()


def test_health_snapshot_matches(ps_run):
    stats, wal = ps_run
    tower = twatch.Watchtower(rules=[twatch.TauP95Rule(bound=100.0)])
    tower.tick(now=0.0)
    j = jm.health_snapshot(wal_root=wal, ps_stats=stats,
                           serving_stats=_synthetic_serving_stats(),
                           watchtower=tower.alerts_json())
    t = tm.health_snapshot(wal_root=wal, ps_stats=stats,
                           serving_stats=_synthetic_serving_stats(),
                           watchtower=tower)
    # each package scans its own shm segments and its own recorder
    for doc in (j, t):
        for k in ("generated_unix_s", "shm", "trace"):
            doc.pop(k)
        doc["metrics"] = {k: v for k, v in doc["metrics"].items()
                          if not k.startswith("dk_trace_")}
    assert t == j
    assert t["ok"] and t["wal"]["ok"]
    assert set(tm.health_snapshot()["shm"]) == {"count", "total_bytes",
                                                "segments"}


def _fill(ts):
    store = ts.TimeSeriesStore(capacity=16)
    for k in range(70):          # past capacity: downsampled twice
        store.sample("ps.commits", float(k), float(3 * k), "counter")
        store.sample("train.loss", float(k), 1.0 / (1 + k))
        if k % 3 == 0:
            store.sample("worker.0.windows", 0.5 * k, float(k), "counter")
    return store


@pytest.mark.parametrize("suffix", [".json", ".json.gz"])
def test_each_store_loads_the_others_dump(tmp_path, suffix):
    stores = {"jax": _fill(jts), "port": _fill(tts)}
    assert stores["port"].to_json() == stores["jax"].to_json()
    for writer, reader in (("jax", tts), ("port", jts)):
        path = stores[writer].dump(str(tmp_path / f"{writer}{suffix}"),
                                   extra={"alerts": {"counts": {}}})
        back = reader.TimeSeriesStore.load(path)
        assert back.to_json() == stores[writer].to_json()
        for name in stores[writer].names():
            assert back.get(name).points() == \
                stores[writer].get(name).points()


def test_trace_overflow_foreign_events_and_cursor(tmp_path):
    ttrace.enable(ring_size=16)
    try:
        base = ttrace.dropped_spans()
        for k in range(22):
            ttrace.record("worker.fetch", 100 * k, 100 * k + 50,
                          corr=f"w0:x{k}")
        assert ttrace.live_dropped() == 6
        assert ttrace.dropped_spans() == base + 6
        ttrace.add_events([{"name": "ps.fold", "t0_ns": 2105, "dur_ns": 10,
                            "cat": "dkps", "corr": "w0:s1", "tid": 7,
                            "tname": "dkps:7"}])
        ev = ttrace.events()
        assert [e["t0_ns"] for e in ev] == \
            [100 * k for k in range(6, 22)] + [2105]
        assert ev[-1]["cat"] == "dkps" and ev[-1]["tname"] == "dkps:7"
        # the end-time cursor keeps what ends after it, foreign events too
        assert [e["t0_ns"] for e in ttrace.events(min_end_ns=2049)] == \
            [2000, 2100, 2105]
        path = str(tmp_path / "t.json")
        for _ in range(3):
            ttrace.save(path, max_bytes=1, keep=2)
        assert os.path.exists(path + ".1") and os.path.exists(path + ".2")
        assert not os.path.exists(path + ".3")
        doc = ttrace.load_json_maybe_gz(path)
        assert doc["otherData"]["dropped_events"] == 6
        assert doc["otherData"]["host_cores"] == (os.cpu_count() or 1)
    finally:
        ttrace.disable()
    # the overflow retires into the process-lifetime counter
    assert ttrace.live_dropped() == 0
    assert ttrace.dropped_spans() == base + 6
    ttrace.add_events([{"name": "x", "t0_ns": 0}])   # off: a no-op
    assert ttrace.events() == []


def _engine_run(eng_cls, model, prompts, trace_mod, **kw):
    trace_mod.enable()
    try:
        eng = eng_cls(model, max_batch=2, block_size=8, **kw)
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run_until_idle()
        assert all(r.state == "done" for r in reqs)
        return trace_mod.events()
    finally:
        trace_mod.disable()


def test_serving_scheduler_spans_match_the_jax_engine():
    """The port's scheduler records the JAX scheduler's serve.* spans at
    the same points: per request one enqueue, one queued, one prefill and
    one request span under its id, decode steps with their rows; the
    analyzer's serving report counts every request."""
    import jax.numpy as jnp

    from distkeras_tpu.models import transformer_lm as jlm
    from distkeras_tpu.serving import GenerationEngine as JEngine
    from distkeras_tpu_torch.convert import params_from_jax
    from distkeras_tpu_torch.models.lm import TransformerLM
    from distkeras_tpu_torch.observability import analyze as tan
    from distkeras_tpu_torch.serving import GenerationEngine as TEngine

    cfg = dict(vocab=64, maxlen=64, dim=32, heads=4, depth=1,
               pos_embedding="rope", kv_heads=2)
    spec = jlm(dtype=jnp.float32, **cfg)
    params, _ = spec.init_np(0)
    model = TransformerLM(dtype=torch.float32, device="cpu", **cfg)
    params_from_jax(params, model)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, size=n).astype(np.int32)
               for n in (5, 9, 7)]
    tev = _engine_run(TEngine, model.eval(), prompts, ttrace, device="cpu")
    jev = _engine_run(lambda m, **kw: JEngine(spec, params, **kw), None,
                      prompts, jtrace)

    def shape(evs):
        per = {}
        for e in evs:
            if e["name"].startswith("serve.") and e["corr"] is not None:
                per.setdefault(e["corr"], []).append(e["name"])
        return sorted(sorted(v) for v in per.values())

    assert shape(tev) == shape(jev)
    assert shape(tev) == [["serve.enqueue", "serve.prefill", "serve.queued",
                           "serve.request"]] * 3
    steps = [e for e in tev if e["name"] == "serve.decode_step"]
    assert steps and all(e["args"]["rows"] >= 1 for e in steps)
    rep = tan.analyze_events(tev, host_cores=8)
    assert rep["serving"]["requests"] == 3
    assert rep["verdict"]["regime"] in tan.REGIMES


# -- the CLI --------------------------------------------------------------


@pytest.fixture(scope="module")
def servers():
    from distkeras_tpu_torch.models.lm import TransformerLM
    from distkeras_tpu_torch.serving import (
        GenerationClient,
        GenerationEngine,
        GenerationServer,
    )

    ps = tps.SocketParameterServer({"w": np.zeros(4, np.float32)},
                                   tr.ADAGMerge(), num_workers=1)
    ps.initialize()
    ps.start()
    torch.manual_seed(0)
    model = TransformerLM(vocab=64, maxlen=64, dim=32, heads=4, depth=1,
                          dtype=torch.float32, device="cpu").eval()
    srv = GenerationServer(GenerationEngine(model, max_batch=2,
                                            block_size=8, device="cpu"))
    srv.start()
    try:
        c = tps.ParameterServerClient("127.0.0.1", ps.port, 0, timeout=60.0)
        c.commit(0, {"w": np.ones(4, np.float32)})
        c.pull()
        c.close()
        g = GenerationClient("127.0.0.1", srv.port)
        g.generate(np.arange(5, dtype=np.int32), max_new_tokens=3)
        g.close()
        yield ps, srv
    finally:
        srv.stop()
        ps.stop()


def _run(cli, argv, capsys):
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


def _drop_moving(doc: dict) -> dict:
    """A scrape minus what moves between two scrapes (the uptime, the
    connection counters the scrapes themselves bump) and each package's
    own recorder metrics."""
    return {k: v for k, v in doc.items()
            if k not in ("dk_ps_uptime_seconds", "dk_trace_enabled",
                         "dk_trace_dropped_spans_total",
                         "dk_serve_connections_total",
                         "dk_serve_open_connections")}


def test_cli_dump_and_tail(servers, capsys):
    ps, srv = servers
    for port, prefix in ((ps.port, "dk_ps_"), (srv.port, "dk_serve_")):
        outs = {}
        for name, cli in (("jax", jcli), ("port", tcli)):
            rc, out = _run(cli, ["dump", "--port", str(port)], capsys)
            assert rc == 0
            outs[name] = _drop_moving(json.loads(out))
            rc, prom = _run(cli, ["dump", "--port", str(port), "--prom"],
                            capsys)
            assert rc == 0 and f"# TYPE {prefix}" in prom
            rc, out = _run(cli, ["tail", "--port", str(port), "--count",
                                 "2", "--interval", "0.05"], capsys)
            lines = out.strip().splitlines()
            assert rc == 0 and len(lines) == 2
            assert all(prefix[:-1] in json.dumps(json.loads(ln)["metrics"])
                       for ln in lines)
        assert outs["port"] == outs["jax"]
        assert any(k.startswith(prefix) for k in outs["port"])


def test_cli_health_and_watch_exit_codes(servers, capsys, ps_run):
    ps, srv = servers
    wal = ps_run[1]
    for cli in (jcli, tcli):
        rc, out = _run(cli, ["health", "--host", "127.0.0.1", "--port",
                             str(ps.port)], capsys)
        doc = json.loads(out)
        assert rc == 0 and doc["ok"] and "ps_stats" in doc
        rc, out = _run(cli, ["health", "--host", "127.0.0.1", "--port",
                             str(srv.port)], capsys)
        doc = json.loads(out)
        assert rc == 0 and "serving_stats" in doc and "ps_stats" not in doc
        rc, out = _run(cli, ["health", "--wal-dir", wal], capsys)
        assert rc == 0 and json.loads(out)["wal"]["ok"]
        rc, out = _run(cli, ["health", "--watch", "--host", "127.0.0.1",
                             "--port", str(ps.port),
                             "--count", "2", "--interval", "0.05"], capsys)
        assert rc == 0 and out == ""
    # a server-side alert: the watch relays it and exits 1
    tower = twatch.Watchtower(rules=[twatch.TauP95Rule(bound=1.0)])
    tower.add_source("tau", lambda s, now: s.sample("ps.tau_p95", now, 9.0))
    tower.tick(now=0.0)
    ps.watchtower = tower
    try:
        for cli in (jcli, tcli):
            rc, out = _run(cli, ["health", "--watch", "--host", "127.0.0.1",
                             "--port", str(ps.port),
                                 "--count", "1"], capsys)
            alert = json.loads(out.strip().splitlines()[0])
            assert rc == 1 and alert["remote"] and alert["rule"] == "tau_p95"
    finally:
        ps.watchtower = None
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit):
            cli.main(["health"])          # neither --wal-dir nor --host


def test_cli_analyze_json_and_degraded_exit(tmp_path, capsys):
    ttrace.enable(ring_size=64)
    try:
        t = 0
        for n in range(1, 4):
            xc, sc = f"w0:x{n}", f"w0:s{n}"
            ttrace.record("worker.compute", t, t + 5_000_000, corr=xc)
            ttrace.record("worker.fetch", t + 1_000_000, t + 5_000_000,
                          corr=xc)
            ttrace.record("worker.commit", t + 5_500_000, t + 8_000_000,
                          corr=sc)
            ttrace.record("ps.fold", t + 6_000_000, t + 7_000_000, corr=sc)
            t += 10_000_000
        ok_path = ttrace.save(str(tmp_path / "ok.json.gz"))
    finally:
        ttrace.disable()
    store = tts.TimeSeriesStore()
    store.sample("ps.tau_p95", 0.0, 4.0)
    series = store.dump(str(tmp_path / "s.json"))
    reports = []
    for cli in (jcli, tcli):
        rc, out = _run(cli, ["analyze", ok_path, "--series", series,
                             "--json"], capsys)
        assert rc == 0
        reports.append(json.loads(out))
        rc, text = _run(cli, ["analyze", ok_path], capsys)
        assert rc == 0 and text.startswith("regime: ")
    assert reports[1] == reports[0]
    assert reports[1]["training"]["windows"] == 3
    assert reports[1]["counters"]["ps.tau_p95"]["last"] == 4.0
    ttrace.enable(ring_size=16)         # overflows: a degraded verdict
    try:
        for k in range(20):
            ttrace.record("worker.fetch", k, k + 1, corr="w0:x1")
        bad = ttrace.save(str(tmp_path / "bad.json"))
    finally:
        ttrace.disable()
    for cli in (jcli, tcli):
        rc, _ = _run(cli, ["analyze", bad], capsys)
        assert rc == 2
        with pytest.raises(SystemExit):
            cli.main(["analyze", str(tmp_path / "missing.json")])


def _watched_trainer(**kw):
    return trainers.DynSGD(
        torch_mlp(input_shape=(16,), hidden=(16,), num_classes=4,
                  dtype=torch.float32),
        loss="sparse_softmax_cross_entropy", worker_optimizer="sgd",
        learning_rate=0.1, num_workers=3, batch_size=32, num_epoch=1,
        communication_window=2, backend="ps", device="cpu", watch=True,
        scrape_interval=0.05, **kw)


def test_elastic_watched_run_feeds_the_coordinators_progress():
    """An elastic run's coordinator samples each worker's windows into the
    watchtower's store (the one progress record the policy and the
    commit-skew rule read), and the run's ledger lands."""
    t = _watched_trainer(elastic=True, analyze=True)
    t.train(Dataset.from_arrays(*_blobs(n=768)), shuffle=True)
    names = set(t.watchtower_.store.names())
    assert {f"worker.{w}.windows" for w in range(3)} <= names
    assert {"ps.commits", "train.loss"} <= names
    assert isinstance(t.watch_alerts_["log"], list)
    assert t.analysis_["skipped_windows"] == 0
    assert sum(w["windows"] for w in t.analysis_["training"][
        "workers"].values()) == t.ps_stats_["commits"]
    assert not t.watchtower_.scraper._dead


def test_a_failed_watched_run_stops_its_scraper():
    """A run that dies mid-flight leaves no scraper polling a stopped
    server: the trainer stops the watchtower it left behind."""
    import threading

    from distkeras_tpu_torch.resilience import FaultPlan

    t = _watched_trainer(fault_plan=FaultPlan(kill_at={1: 1}))
    with pytest.raises(Exception):
        t.train(Dataset.from_arrays(*_blobs(n=768)), shuffle=True)
    assert t._watchtower_active_ is None
    assert not [th for th in threading.enumerate()
                if th.name == "dk-watch-scraper" and th.is_alive()]


# -- spans inside the collective engine, the LM and the fused CE -------------

def _lm_engine():
    """A tiny fused-CE LM under ADAG (W=2, window 2, 2 rows a worker) on
    the CPU, its engine, its state and one epoch of two windows staged."""
    from distkeras_tpu_torch.models.lm import transformer_lm_spec
    from distkeras_tpu_torch.parallel.local_sgd import LocalSGDEngine

    spec = transformer_lm_spec(vocab=64, maxlen=16, dim=32, heads=2,
                               depth=2, dtype=torch.float32,
                               attn_impl="flash", pos_embedding="rope",
                               fused_ce=True, ce_chunk=8)
    t = trainers.ADAG(spec, loss="sparse_softmax_cross_entropy",
                      worker_optimizer="adam", learning_rate=1e-3,
                      num_workers=2, batch_size=2, communication_window=2,
                      device="cpu")
    eng = LocalSGDEngine(spec=t.spec, loss_step=t._loss_step(),
                         optimizer=t.allocate_optimizer(),
                         rule=t.allocate_merge_rule(), device="cpu",
                         num_workers=2, window=2, batch_size=2)
    params, nt = spec.init(0)
    gen = torch.Generator().manual_seed(0)
    tok = torch.randint(0, 64, (2, 8, 17), generator=gen)
    staged = (tok[..., :16].contiguous(), tok[..., 1:].contiguous())
    return eng, eng.init_state(params, nt), staged


def _inside(inner, outer):
    return (outer["t0_ns"] <= inner["t0_ns"] and inner["t0_ns"]
            + inner["dur_ns"] <= outer["t0_ns"] + outer["dur_ns"])


def test_engine_spans_nest_as_a_window_runs():
    """Each window records one ``engine.window`` (corr its step, args its
    rows and tokens) holding ``window`` × ``engine.grads`` (each holding
    one ``engine.forward``) and ``engine.update``, then one
    ``engine.merge``; the model's parts and the fused CE's forward lie
    inside the forward, its backward inside ``engine.grads``."""
    eng, state, staged = _lm_engine()
    ttrace.enable()
    try:
        eng.run_epoch_resident(state, staged, None)
        evs = ttrace.events()
    finally:
        ttrace.disable()
    named = lambda n: [e for e in evs if e["name"] == n]
    windows = named("engine.window")
    assert [w["corr"] for w in windows] == ["x0", "x1"]
    assert all(w["args"] == {"rows": 8, "tokens": 128} for w in windows)
    for w in windows:
        inside = lambda n: [e for e in named(n) if _inside(e, w)]
        grads, fwd = inside("engine.grads"), inside("engine.forward")
        assert len(grads) == len(fwd) == len(inside("engine.update")) == 2
        assert len(inside("engine.merge")) == 1
        assert all(_inside(f, g) for f, g in zip(fwd, grads))
        assert all(e["corr"] == w["corr"] for e in evs if _inside(e, w))
        for f, g in zip(fwd, grads):
            parts = [e for e in evs if _inside(e, f)]
            assert [e["name"] for e in parts].count("lm.attn") == 2
            assert {"lm.embed", "lm.mlp", "lm.head", "flash.forward",
                    "fused_ce.forward"} <= {e["name"] for e in parts}
            back = [e for e in evs if _inside(e, g) and not _inside(e, f)
                    and not e["name"].startswith("engine.")]
            assert {e["name"] for e in back} == {"fused_ce.backward",
                                                 "flash.backward"}
        merge = inside("engine.merge")[0]
        assert grads[-1]["t0_ns"] < merge["t0_ns"]


def test_engine_spans_leave_the_arithmetic_alone():
    """The center and the losses are bit-equal with tracing on and off;
    off, nothing is recorded."""
    out = {}
    for on in (False, True):
        eng, state, staged = _lm_engine()
        if on:
            ttrace.enable()
        try:
            state, losses = eng.run_epoch_resident(state, staged, None)
            out[on] = (state.center, losses, ttrace.events())
        finally:
            ttrace.disable()
    assert out[False][2] == [] and out[True][2]
    torch.testing.assert_close(out[True][1], out[False][1], rtol=0, atol=0)
    for k, v in out[False][0].items():
        torch.testing.assert_close(out[True][0][k], v, rtol=0, atol=0)


def test_span_call_sites_allocate_nothing_when_off():
    """With tracing off, no block allocated at a span's call site in the
    engine, the LM, the fused CE or flash, nor in the tracer, is alive
    when a span is opened (what a call site builds for it), inside the
    deepest open spans (the forward's flash, the fused CE's forward and
    backward, the update, the merge), nor left over after a window
    (``tracemalloc``)."""
    import inspect
    import re
    import tracemalloc

    from distkeras_tpu_torch.models import lm
    from distkeras_tpu_torch.ops import flash_attention, fused_ce
    from distkeras_tpu_torch.parallel import local_sgd

    sites = [tracemalloc.Filter(True, ttrace.__file__)]
    for mod in (local_sgd, lm, fused_ce, flash_attention):
        lines = inspect.getsource(mod).splitlines()
        hits = [i + 1 for i, ln in enumerate(lines)
                if re.search(r"_trace\.|self\._window_span\(", ln)]
        assert hits, mod.__name__
        sites += [tracemalloc.Filter(True, mod.__file__, lineno=n)
                  for n in hits]
    eng, state, staged = _lm_engine()
    eng.run_epoch_resident(state, staged, None)      # warm every path
    assert not ttrace.enabled()
    snaps = []
    take = lambda: snaps.append(tracemalloc.take_snapshot())

    def around(fn):
        def wrapped(*a, **k):
            take()
            return fn(*a, **k)
        return wrapped

    import unittest.mock as mock

    span = ttrace.span

    def opening(name, cat="", corr=None, args=None):
        # span's own signature: a *args wrapper would pack a tuple at
        # the call site
        take()
        return span(name, cat, corr, args)

    patches = [mock.patch.object(flash_attention, "_fa_forward",
                                 around(flash_attention._fa_forward)),
               mock.patch.object(fused_ce, "_mm_f32",
                                 around(fused_ce._mm_f32)),
               mock.patch.object(local_sgd, "tree_map",
                                 around(local_sgd.tree_map)),
               mock.patch.object(ttrace, "span", opening)]
    merge = eng.rule.merge
    eng.rule.merge = around(merge)
    tracemalloc.start()
    try:
        with patches[0], patches[1], patches[2], patches[3]:
            before = tracemalloc.take_snapshot()
            eng._window_fn(state, tuple(c[:, :4].reshape(
                2, 2, 2, 16) for c in staged))
            after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
        eng.rule.merge = merge
    assert len(snaps) > 40
    for snap in snaps:
        held = snap.filter_traces(sites).statistics("lineno")
        assert held == [], held
    grew = [d for d in after.filter_traces(sites).compare_to(
        before.filter_traces(sites), "lineno") if d.size_diff > 0]
    assert grew == [], grew
