"""The port's spans beside the device trace: one clock, each device
operation's phase and part (``portbench.spans``), idle gaps named by
span, and no span recorded by the untraced run."""

from __future__ import annotations

import json
import os

import pytest
import torch

from portbench import run, spanpass, spans
from portbench.tests.conftest import tiny

US = 1000                   # ns a µs
OFFSET = 10 ** 12           # the synthetic spans' Unix-minus-monotonic
BASE = OFFSET               # the synthetic trace's base: µs = t0_ns / 1000
ENGINE, AUTOGRAD = 100, 200


def test_a_span_holds_its_profiler_event_on_one_clock(tmp_path):
    """A port span around a ``record_function`` block under the CPU's
    profiler contains that block's event once the span is mapped through
    the tracer's offset, within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from distkeras_tpu_torch.observability import trace as ptrace

    assert ptrace.unix_minus_monotonic_ns() is None       # off
    ptrace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with ptrace.span("outer"):
                with record_function("inner"):
                    torch.ones(64).sum()
        offset = ptrace.unix_minus_monotonic_ns()
        assert abs(ptrace.clock_drift_ns()) < 10 ** 6
        outer = next(e for e in ptrace.events() if e["name"] == "outer")
    finally:
        ptrace.disable()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    inner = next(e for e in doc["traceEvents"] if e.get("name") == "inner"
                 and e.get("ph") == "X")
    base = int(doc["baseTimeNanoseconds"])
    a = spans.to_trace_us(outer["t0_ns"], offset, base)
    b = spans.to_trace_us(outer["t0_ns"] + outer["dur_ns"], offset, base)
    start, end = float(inner["ts"]), float(inner["ts"]) + float(inner["dur"])
    assert a - 1000 <= start and end <= b + 1000, (a, b, start, end)
    assert inner["tid"] == outer["tid"]


def _span(name, a_us, b_us, tid=ENGINE, args=None):
    return {"name": name, "cat": "", "corr": None, "t0_ns": a_us * US,
            "dur_ns": (b_us - a_us) * US, "tid": tid, "tname": str(tid),
            "args": args}


def _synthetic():
    """One window: forward (attention, the fused CE), a backward launched
    from autograd's thread, the update, the merge, a launch in the window
    under no phase and one after it."""
    sp = [_span("engine.window", 0, 10000, args={"rows": 4, "tokens": 64}),
          _span("engine.grads", 100, 6000),
          _span("engine.forward", 200, 2000),
          _span("lm.attn", 300, 1000),
          _span("fused_ce.forward", 1100, 1900),
          _span("fused_ce.backward", 2500, 3000, tid=AUTOGRAD),
          _span("engine.update", 6100, 7000),
          _span("engine.merge", 7100, 9000)]
    calls = [(1, 500, ENGINE), (2, 1500, ENGINE), (3, 2600, AUTOGRAD),
             (4, 4000, AUTOGRAD), (5, 6500, ENGINE), (6, 8000, ENGINE),
             (7, 9500, ENGINE), (8, 11000, ENGINE)]
    ops = [(1, 600, 100, "void at::native::elementwise_kernel<128, 2>(int)"),
           (2, 1600, 200, "nvjet_tst_256x128_64x4"),
           (3, 2700, 300, "nvjet_tst_128x128"),
           (4, 4100, 400, "void fa_bwd_dkv_wgmma_kernel<128>(int)"),
           (5, 6600, 50, "adam_kernel"),
           (6, 8100, 60, "void at::native::vectorized_elementwise_kernel"
                         "<4>(int)"),
           (7, 9600, 10, "Memcpy HtoD (Pageable -> Device)"),
           (8, 11100, 5, "Memset (Device)")]
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": ts, "dur": 5, "tid": tid, "args": {"correlation": c}}
          for c, ts, tid in calls]
    ev += [{"ph": "X", "cat": "gpu_memcpy" if n.startswith("Memcpy") else
            "gpu_memset" if n.startswith("Memset") else "kernel",
            "name": n, "ts": ts, "dur": d, "tid": 7,
            "args": {"correlation": c}} for c, ts, d, n in ops]
    ev.append({"ph": "f", "cat": "ac2g", "name": "ac2g", "ts": 600,
               "id": 1})
    return {"traceEvents": ev, "baseTimeNanoseconds": BASE}, sp


def test_each_operation_gets_its_phase_and_part():
    doc, sp = _synthetic()
    s = spans.split(doc, sp, OFFSET, host_s=0.0107)
    assert s.windows == 1 and s.tokens == 64 and s.threads_match
    assert s.phase_ms("engine.forward") == pytest.approx(0.3)
    # both launches of autograd's thread: inside engine.grads, outside
    # engine.forward, with or without a span on their own thread
    assert s.phase_ms("engine.grads") == pytest.approx(0.7)
    assert s.phase_ms("engine.update") == pytest.approx(0.05)
    assert s.phase_ms("engine.merge") == pytest.approx(0.06)
    assert s.part_ms("fused_ce.") == pytest.approx(0.5)
    assert s.us == pytest.approx({
        ("engine.forward", "lm.attn"): 100,
        ("engine.forward", "fused_ce.forward"): 200,
        ("engine.grads", "fused_ce.backward"): 300,
        ("engine.grads", "no span, another thread"): 400,
        ("engine.update", "engine.update"): 50,
        ("engine.merge", "engine.merge"): 60,
        ("engine.window", "engine.window"): 10,
        (spans.OUTSIDE, "no span, engine thread"): 5})
    assert sum(s.launches.values()) == 8
    assert s.busy_us == pytest.approx(1125)
    lines = spans.table(s)
    assert any(line.startswith("engine.grads") and "fa_bwd_dkv" in line
               for line in lines)


def test_idle_gaps_are_named_by_the_engine_threads_span():
    doc, sp = _synthetic()
    s = spans.split(doc, sp, OFFSET, host_s=0.0107)
    names = [n for n, _ in s.gaps]
    assert "host before vectorized_elementwise_kernel in engine.update" \
        in names
    assert "host before Memcpy HtoD in engine.merge" in names
    assert "host before the window's end outside the program" in names
    assert all(n.endswith(spans.OUTSIDE) or " in engine." in n
               or " in lm." in n or " in fused_ce." in n for n in names)
    assert [g for _, g in s.gaps] == sorted((g for _, g in s.gaps),
                                            reverse=True)


def test_a_device_only_trace_names_threads_by_pthread_id():
    """Runtime calls named as a device-only trace names them (the
    magnitude of the pthread id's low 32 bits, read signed) are placed
    on the threads the spans name, given each thread's pthread id."""
    doc, sp = _synthetic()
    idents = {ENGINE: 0x7F67C1DB1300, AUTOGRAD: 0x7F647F7FF6C0}
    assert spans.trace_tids(idents)[1042607360] == ENGINE
    assert spans.trace_tids(idents)[2139092672] == AUTOGRAD
    for e in doc["traceEvents"]:
        if e.get("cat") == "cuda_runtime":
            e["tid"] = {ENGINE: 1042607360, AUTOGRAD: 2139092672}[e["tid"]]
    assert not spans.split(doc, sp, OFFSET, 0.0107).threads_match
    s = spans.split(doc, sp, OFFSET, 0.0107, idents)
    assert s.threads_match
    assert s.us[("engine.grads", "fused_ce.backward")] == pytest.approx(300)
    assert s.part_ms("fused_ce.") == pytest.approx(0.5)


def test_attribution_by_time_where_threads_do_not_match():
    """Runtime calls whose thread ids are none of the spans' are placed by
    time on the engine's thread alone."""
    doc, sp = _synthetic()
    for e in doc["traceEvents"]:
        if e.get("cat") == "cuda_runtime":
            e["tid"] += 1
    s = spans.split(doc, sp, OFFSET, host_s=0.0107)
    assert not s.threads_match
    assert s.phase_ms("engine.grads") == pytest.approx(0.7)
    assert s.us[("engine.grads", "engine.grads")] == pytest.approx(700)


def test_no_window_span_no_split():
    doc, sp = _synthetic()
    assert spans.split(doc, sp[1:], OFFSET, 0.0107) is None


def test_clock_check_reads_the_slack_on_each_side():
    sp = [_span("portbench.clock", 100, 200)]
    doc = {"baseTimeNanoseconds": BASE, "traceEvents": [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 120, "dur": 50, "tid": ENGINE, "args": {"correlation": 9}}]}
    c = spans.clock_check(doc, sp, OFFSET)
    assert c == {"slack_before_us": 20.0, "slack_after_us": 30.0,
                 "span_us": 100.0, "same_thread": True}


def test_innermost_of_nested_intervals():
    at = spans.Innermost([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"),
                          (6, 8, "d"), (12, 13, "e")]).at
    assert [at(t) for t in (-1, 1, 2, 3.5, 4, 5, 7, 9, 11, 12.5, 20)] == \
        [None, "a", "b", "c", "b", "a", "d", "a", None, "e", None]


def test_the_untraced_run_records_no_span(monkeypatch):
    """The untraced run never turns the port's tracer on; a traced run
    without a card leaves the span metrics out and the tracer off."""
    from distkeras_tpu_torch.observability import trace as ptrace

    calls = []
    real = ptrace.enable
    monkeypatch.setattr(ptrace, "enable",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    b = tiny("lm9_adag_L2048")
    res, code = run.run(b, 2 ** 31 + 11, 0.05, False, device="cpu")
    assert code == 0 and calls == []
    assert not ptrace.enabled() and ptrace.events() == []
    res, code = run.run(b, 2 ** 31 + 11, 0.05, True, device="cpu")
    assert code == 0 and calls == [] and not ptrace.enabled()
    assert not {"forward_ms.tokens", "backward_ms.tokens", "update_ms.tokens",
                "merge_ms.tokens", "fused_ce_ms.tokens"} & set(res["metrics"])


def test_the_pass_takes_the_runs_seed(monkeypatch):
    monkeypatch.setattr("sys.argv", ["run", "--workload", "x", "--seed",
                                     str(2 ** 31 + 7), "--trace", "1"])
    assert spanpass._seed() == 2 ** 31 + 7
    monkeypatch.setattr("sys.argv", ["pytest", "-q", os.devnull])
    assert spanpass._seed() == 0
