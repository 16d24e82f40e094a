"""The traced run's pass with the port's own spans on: what the readers of
``forward_ms``, ``backward_ms``, ``update_ms``, ``merge_ms`` and
``fused_ce_ms`` read.

The harness's traced window runs with the port's tracer off and keeps only
the device's events without their correlation ids. So, once that window
has closed and its state is freed, the first of these readers builds the
cell's timed path anew from the run's seed, warms it with two epochs, and
runs the cell's ``trace_epochs`` epochs once more under the same profiler
(device activity only) with the port's tracer on; ``portbench.spans``
splits that pass's device time by the spans, with the threads' pthread
ids from ``threading`` to name the trace's threads. Before the epochs,
one port span around a stream synchronise checks the two clocks against
each other. The pass prints its table, its idle gaps named by span, the clock
check and its own window (host time, idle, ``mfu.tokens``) to stderr.

On a port whose tracer has no Unix-minus-monotonic offset (it records no
engine span either), or without a CUDA card, there is no pass and the
readers find nothing to read. The untraced run never comes here.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import torch

from portbench import core, spans

CLOCK_SPAN = "portbench.clock"
#: epochs before the pass's own: with one, a traced L2048 epoch still met
#: 100 ms of cudaMalloc now and then
WARM_EPOCHS = 2


def _port_tracer():
    """The port's tracer, where it maps its spans onto Unix time."""
    try:
        mod = importlib.import_module(
            "distkeras_tpu_torch.observability.trace")
    except ImportError:
        return None
    return mod if hasattr(mod, "unix_minus_monotonic_ns") else None


def _seed() -> int:
    """The run's ``--seed`` (the pass makes the run's own weights and
    rows), 0 where the process was not started by ``portbench.run``."""
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_known_args(sys.argv[1:])[0].seed


def _profiled(run):
    """``run()`` under ``torch.profiler`` with device activity only, as
    ``portbench.trace.traced`` records it: ``(Chrome document, host s)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="portbench-spans-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return doc, host_s


def measure(ctx, err=sys.stderr):
    """The pass: ``spans.Split`` of its epochs, or None."""
    tracer = _port_tracer()
    if (ctx.trace is None or tracer is None or tracer.enabled()
            or not torch.cuda.is_available()):
        return None
    bench = ctx.bench
    drv = core.load_driver(bench.cell["driver"]).Driver(bench, _seed(),
                                                         "cuda")
    try:
        epochs = int(bench.cell["trace_epochs"])
        for _ in range(WARM_EPOCHS):
            drv.epoch()
        torch.cuda.synchronize()
        drift = []

        def work():
            # the first runtime call under the profiler pays its set-up:
            # the span holds the second
            torch.cuda.current_stream().synchronize()
            with tracer.span(CLOCK_SPAN):
                torch.cuda.current_stream().synchronize()
            for _ in range(epochs):
                drv.epoch()
            torch.cuda.synchronize()
            drift.append(tracer.clock_drift_ns())

        tracer.enable()
        try:
            doc, host_s = _profiled(work)
            offset = tracer.unix_minus_monotonic_ns()
            evs = tracer.events()
            dropped = tracer.live_dropped()
        finally:
            tracer.disable()
    finally:
        drv.release()
        del drv
    # every thread that recorded a span is known to threading (the tracer
    # asks for its name), autograd's too
    idents = {t.native_id: t.ident for t in threading.enumerate()
              if t.native_id is not None and t.ident is not None}
    out = spans.split(doc, evs, offset, host_s, idents)
    if out is None:
        return None
    _report(ctx, out, doc, evs, offset, drift[0], dropped, host_s, idents,
            err)
    return out


def _report(ctx, out, doc, evs, offset, drift, dropped, host_s, idents,
            err):
    for line in spans.table(out):
        print(f"spans: {line}", file=err)
    for name, s in out.gaps:
        print(f"spans: idle {s * 1e3:.3f} ms {name}", file=err)
    check = spans.clock_check(doc, evs, offset, CLOCK_SPAN,
                              idents=idents)
    print(f"spans: clock check {json.dumps(check)}; offset "
          f"{offset} ns, drift from enable() to the pass's end "
          f"{drift} ns", file=err)
    busy = out.busy_us / 1e6
    tokens = out.tokens
    mfu = core.load_reader("mfu.tokens").read(dataclasses.replace(
        ctx, window_s=host_s, done=dict(ctx.done, tokens=tokens)))
    print(f"spans: pass window {host_s:.6f} s ({host_s / out.windows:.6f} "
          f"s a window), busy {busy:.6f} s, idle "
          f"{100 * (1 - busy / host_s):.4f}%, mfu.tokens {mfu:.4f}%; "
          f"spans {len(evs)} ({len(evs) / out.windows:.1f} a window), "
          f"dropped {dropped}; runtime threads are the spans' threads: "
          f"{out.threads_match}", file=err)


def split(ctx):
    """The pass's split, measured once a run (kept on ``ctx``)."""
    memo = vars(ctx)
    if "span_split" not in memo:
        memo["span_split"] = measure(ctx)
    return memo["span_split"]
