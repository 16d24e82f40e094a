"""The port's analyzer (``distkeras_tpu_torch/observability/analyze.py``)
held to the JAX package's on the same inputs: hand-built span streams of
every loop shape and regime give equal reports (floats within 1e-12
relative, everything else equal) and byte-equal ``format_report`` text;
the live regime tracker feeds equal series; each package loads the
other's saved trace; and a trace the port saved from a tiny config-5 run
(``analyze=True``, ``device="cpu"``) gives the same report from both
analyzers, with every window each worker ran assembled."""

import math

import numpy as np
import pytest
import torch

from distkeras_tpu.observability import analyze as jan
from distkeras_tpu.observability import timeseries as jts
from distkeras_tpu.observability import trace as jtrace
from distkeras_tpu.observability import watch as jwatch
from distkeras_tpu_torch.observability import analyze as tan
from distkeras_tpu_torch.observability import timeseries as tts
from distkeras_tpu_torch.observability import trace as ttrace
from distkeras_tpu_torch.observability import watch as twatch

MS = 1_000_000  # ns per ms
REL = 1e-12


def assert_same(a, b, path="report"):
    """Deep equality with floats within ``REL`` relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), \
            (path, sorted(set(a) ^ set(b)))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(a, bool):
        assert isinstance(b, (int, float)), (path, a, b)
        assert math.isclose(a, b, rel_tol=REL, abs_tol=0.0) or a == b, \
            (path, a, b)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def ev(name, t0_ms, dur_ms, corr=None, tid=1, cat="", args=None):
    return {"name": name, "cat": cat, "corr": corr,
            "t0_ns": int(t0_ms * MS), "dur_ns": int(dur_ms * MS),
            "tid": tid, "tname": f"t{tid}", "args": args}


def serial_window(base_ms, wid=0, n=1, compute_ms=5.0, wire_ms=1.5,
                  decode_ms=1.0, lock_ms=1.5, fold_ms=2.0, append_ms=1.0,
                  wait_ms=3.0):
    """One serial-loop window: compute/fetch, compress, and a commit with
    its corr-stitched server-side decomposition. ``(events, end_ms)``."""
    xc, sc = f"w{wid}:x{n}", f"w{wid}:s{n}"
    t = base_ms
    evs = [ev("worker.compute", t - 0.5, compute_ms + 0.5, xc, 10 + wid),
           ev("worker.fetch", t, compute_ms, xc, 10 + wid),
           ev("worker.compress", t + compute_ms, 1.0, xc, 10 + wid)]
    c0 = t + compute_ms + 1.0
    commit = decode_ms + lock_ms + fold_ms + append_ms + wait_ms + wire_ms
    evs.append(ev("worker.commit", c0, commit, sc, 10 + wid))
    s = c0 + wire_ms / 2
    evs.append(ev("ps.decode", s, decode_ms, sc, 99))
    s += decode_ms + lock_ms
    evs.append(ev("ps.fold", s, fold_ms, sc, 99))
    s += fold_ms
    evs.append(ev("ps.wal_append", s, append_ms, sc, 99))
    s += append_ms
    evs.append(ev("ps.wal_wait", s, wait_ms, sc, 99))
    return evs, c0 + commit


def _windows(n_workers, n_windows, gap_ms=0.5, slow=None, **kw):
    evs = []
    for wid in range(n_workers):
        t = 0.3 * wid
        for n in range(1, n_windows + 1):
            gap = 200.0 if wid == slow else gap_ms
            e, t = serial_window(t + gap, wid=wid, n=n, **kw)
            evs += e
    return evs


def _pipelined(n_windows=6, residue_ms=8.0):
    """Window N's commit runs inside window N+1's dispatch → fetch-return
    span; the fetch after it waits ``residue_ms`` (device-critical) or
    returns at once (exchange-critical)."""
    evs, t = [], 0.0
    for n in range(1, n_windows + 1):
        evs.append(ev("worker.compute", t, 10.0 + residue_ms, f"w0:x{n}",
                      10))
        if n > 1:
            evs.append(ev("worker.commit", t + 1.0, 6.0, f"w0:s{n - 1}", 10))
            evs.append(ev("ps.fold", t + 2.0, 1.0, f"w0:s{n - 1}", 99))
        evs.append(ev("worker.fetch", t + 8.0, 2.0 + residue_ms, f"w0:x{n}",
                      10))
        evs.append(ev("worker.compress", t + 10.0 + residue_ms, 0.5,
                      f"w0:x{n}", 10))
        t += 11.0 + residue_ms
    evs.append(ev("worker.commit", t, 6.0, f"w0:s{n_windows}", 10))
    return evs


def _elastic(n_windows=5):
    """The EASGD loop: the fresh-center pull precedes the window's fetch
    and lies inside its dispatch → fetch-return span."""
    evs, t = [], 0.0
    for n in range(1, n_windows + 1):
        xc = f"w1:x{n}"
        evs += [ev("worker.compute", t, 12.0, xc, 11),
                ev("worker.pull", t + 1.0, 2.0, xc, 11),
                ev("worker.fetch", t + 4.0, 8.0, xc, 11),
                ev("worker.compress", t + 12.0, 0.5, xc, 11),
                ev("worker.commit", t + 12.5, 3.0, xc, 11),
                ev("ps.fold", t + 13.0, 1.0, xc, 99)]
        t += 17.0
    return evs


def _serving():
    return [
        ev("serve.request", 0, 100, "r1", 5, args={"state": "done"}),
        ev("serve.queued", 0, 70, "r1", 5),
        ev("serve.prefill", 70, 10, "r1", 5, args={"rows": 1, "lpad": 16}),
        ev("serve.request", 5, 95, "r2", 5, args={"state": "done"}),
        ev("serve.queued", 5, 60, "r2", 5),
        ev("serve.prefill", 65, 5, "r2", 5),
        ev("serve.decode_step", 80, 5, None, 5,
           args={"rows": 4, "batch": 4}),
        ev("serve.decode_step", 85, 15, None, 5, args={"rows": 8}),
        ev("serve.request", 10, 30, "r3", 5, args={"state": "cancelled"}),
    ]


def _counters():
    return [ev("ps.tau_p95", 1.0 + i, 0, None, 3, cat="__counter__",
               args=float(3 + i)) for i in range(5)]


_SERIES = {"series": {"ps.tau_p95": {"v": [2.0, 20.0, 18.0]},
                      "shm.ring_occupancy_frac": {"v": [0.2, 0.95]},
                      "analyze.regime_code": {"v": [0, 0, 1]},
                      "train.loss": {"v": [1.0]}},
           "alerts": {"counts": {"tau_p95": 2}}}

_CASES = {
    "serial": (lambda: _windows(2, 4), 0, None),
    "pipelined_hidden": (lambda: _pipelined(residue_ms=8.0), 0, None),
    "pipelined_exposed": (lambda: _pipelined(residue_ms=0.0), 0, None),
    "elastic": (_elastic, 0, None),
    "straggler": (lambda: _windows(4, 4, slow=2), 0, None),
    "fsync_bound": (lambda: _windows(2, 4, compute_ms=1.0, wait_ms=25.0,
                                     append_ms=5.0, lock_ms=0.2,
                                     fold_ms=0.5, wire_ms=0.5,
                                     decode_ms=0.2), 0, None),
    "lock_bound": (lambda: _windows(3, 4, compute_ms=1.0, lock_ms=30.0,
                                    fold_ms=10.0, wire_ms=0.5, wait_ms=0.2,
                                    append_ms=0.2, decode_ms=0.3), 0, None),
    "serving_only": (_serving, 0, None),
    "dropped_spans": (lambda: _windows(1, 3) + [
        ev("worker.commit", 500.0, 4.0, "w3:s9", 13)], 7, None),
    "mixed_with_counters": (lambda: _windows(2, 3) + _serving()
                            + _counters(), 0, _SERIES),
    "empty": (lambda: [], 0, None),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_reports_equal_on_hand_built_streams(case):
    build, dropped, series = _CASES[case]
    for cores in (8, 1):
        j = jan.analyze_events(build(), dropped=dropped, host_cores=cores,
                               series=series)
        t = tan.analyze_events(build(), dropped=dropped, host_cores=cores,
                               series=series)
        assert_same(j, t)
        assert tan.format_report(t) == jan.format_report(j)
    if case == "straggler":
        assert t["training"]["dominant_wait_worker"] == 2
        assert t["training"]["stragglers"] == [2]
    if case == "serving_only":
        assert t["verdict"]["regime"] == "queue-bound"
    if case == "dropped_spans":
        assert t["degraded"] and t["skipped_windows"] >= 1


def test_interval_algebra_and_classifier_match():
    rng = np.random.default_rng(0)
    for _ in range(40):
        xs = [tuple(sorted(map(int, rng.integers(0, 100, 2))))
              for _ in range(rng.integers(0, 8))]
        ys = [tuple(sorted(map(int, rng.integers(0, 100, 2))))
              for _ in range(rng.integers(0, 8))]
        assert tan.merge_intervals(xs) == jan.merge_intervals(xs)
        assert tan.union_length(xs) == jan.union_length(xs)
        assert tan.intersect_intervals(xs, ys) == \
            jan.intersect_intervals(xs, ys)
        totals = {k: float(rng.uniform(0, 100)) for k in (
            "compute", "compress", "wire", "decode", "lock_wait", "fold",
            "wal", "serve_queue", "serve_prefill", "serve_decode")}
        kw = dict(host_cores=int(rng.integers(1, 9)),
                  n_workers=int(rng.integers(0, 12)),
                  wall_ms=float(rng.uniform(1, 400)),
                  busy_ms=float(rng.uniform(0, 4000)),
                  serving_only=bool(rng.integers(0, 2)))
        assert_same(jan.classify(totals, **kw), tan.classify(totals, **kw))
    assert tan.REGIMES == jan.REGIMES
    assert [tan.regime_code(r) for r in tan.REGIMES] == \
        [jan.regime_code(r) for r in jan.REGIMES]


def test_regime_tracker_and_shift_rule_match():
    """The live shadow: the same event slices through each package's
    tracker land equal series, and the bottleneck-shift rule fires the
    same transitions over them."""
    stores = (jts.TimeSeriesStore(), tts.TimeSeriesStore())
    trackers = (jan.RegimeTracker(), tan.RegimeTracker())
    rules = (jwatch.BottleneckShiftRule(), twatch.BottleneckShiftRule())
    # compute-bound, then fsync-bound windows
    phases = [_windows(2, 3, compute_ms=20.0),
              [dict(e, t0_ns=e["t0_ns"] + 10_000 * MS) for e in _windows(
                  2, 3, compute_ms=0.5, wait_ms=40.0, append_ms=10.0)]]
    outs = ([], [])
    now = 0.0
    for slab in phases:
        for k in range(4):
            now += 1.0
            for i in (0, 1):
                trackers[i].observe(slab, stores[i], now)
                outs[i].append(rules[i].evaluate(stores[i], now))
    assert_same(stores[0].to_json(), stores[1].to_json())
    assert_same(outs[0], outs[1])


def _record_all(mod, evs):
    for e in evs:
        if e["cat"] == "__counter__":
            mod.counter(e["name"], e["args"])
        else:
            mod.record(e["name"], e["t0_ns"], e["t0_ns"] + e["dur_ns"],
                       corr=e["corr"], args=e["args"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_loads_the_others_trace(tmp_path, writer):
    mod = ttrace if writer == "port" else jtrace
    evs = _windows(2, 3) + _serving()
    mod.enable(ring_size=4096)
    try:
        _record_all(mod, evs)
        mod.counter("ps.tau_p95", 4.0)
        path = mod.save(str(tmp_path / "t.json.gz"))
    finally:
        mod.disable()
    jev, jmeta = jan.load_trace(path)
    tev, tmeta = tan.load_trace(path)
    assert_same(jev, tev)
    assert jmeta == tmeta
    assert_same(jan.analyze_trace(path), tan.analyze_trace(path))


def _tiny_config5_run(tmp_path, pipelined: bool):
    """Config 5's model (the IMDB LSTM classifier) at a tiny width under
    DynSGD with fused Adam on the in-process PS, traced and analyzed."""
    from distkeras_tpu_torch.datasets import imdb
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DynSGD

    W, B, win, T = 3, 8, 2, 24
    train, _ = imdb(n_train=W * B * win * 3, n_test=8, vocab=300, maxlen=T)
    spec = lstm_classifier(vocab=300, maxlen=T, embed_dim=16, hidden_dim=16,
                           dtype=torch.float32)
    t = DynSGD(spec, loss="sparse_softmax_cross_entropy",
               worker_optimizer="fused_adam", learning_rate=0.01,
               features_col=["features", "mask"], num_workers=W,
               batch_size=B, communication_window=win, num_epoch=1,
               backend="ps", ps_pipeline_depth=1 if pipelined else 0,
               device="cpu", analyze=True, trace_dir=str(tmp_path))
    t.train(train, shuffle=True)
    return t


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
def test_port_saved_trace_gives_the_same_report(tmp_path, pipelined):
    t = _tiny_config5_run(tmp_path, pipelined)
    a = t.analysis_
    assert a is not None and a["verdict"]["regime"] in tan.REGIMES
    assert a["verdict"]["regime"] != "idle"
    assert a["dropped_spans"] == 0 and a["skipped_windows"] == 0
    ran = {}
    for r in t.history.records:
        if "loss" in r:
            ran[str(r["worker"])] = ran.get(str(r["worker"]), 0) + 1
    assert {w: v["windows"] for w, v in a["training"]["workers"].items()} \
        == ran
    frac = a["training"]["overlap"]["fraction"]
    assert frac is not None and 0.0 <= frac <= 1.0
    if pipelined:
        assert frac > 0.5   # every commit but the last hides under compute
    else:
        assert frac == 0.0
    j = jan.analyze_trace(t.trace_path_)
    p = tan.analyze_trace(t.trace_path_)
    assert_same(j, p)
    assert p["verdict"]["regime"] == a["verdict"]["regime"]
    assert p["training"]["windows"] == a["training"]["windows"]
