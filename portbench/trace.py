"""The traced window: ``torch.profiler`` over it, recording the device's
activity alone (kernels, copies, memsets and the CUDA runtime calls that
issued them; no host operator events, whose recording would slow the
host-paced parts of the step and inflate the idle share it measures).

The window is the host's span around the traced epochs, ended by a
synchronise. Busy time is the union of the device operations' intervals;
an idle gap is a stretch of the window with none of them, named by the
CUDA runtime call the host was in during it (a copy, a synchronise, …),
or, where it was in none, as host time before the device operation that
ends the gap.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters (``fa_bwd_dkv_wgmma_kernel``, ``nvjet_tst_…``)."""
    base = re.sub(r"^void\s+", "", name)
    base = re.split(r"[<(]", base, maxsplit=1)[0]
    return base.rsplit("::", 1)[-1] or name[:80]


def _spans(events: list, cats) -> list:
    return sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
         e.get("name", ""))
        for e in events if e.get("cat") in cats and e.get("ph") == "X")


class Trace:
    """The device's events of one traced window (µs on the trace's
    clock), the window being ``host_s`` seconds from the first runtime
    call or device operation."""

    def __init__(self, events: list, host_s: float):
        self.host_s = host_s
        self.device = _spans(events, DEVICE_CATS)
        self.kernels = _spans(events, ("kernel",))
        self.runtime = _spans(events, ("cuda_runtime", "cuda_driver"))
        starts = [s[0] for s in self.device + self.runtime]
        self.t0 = min(starts) if starts else 0.0
        self.t1 = self.t0 + host_s * 1e6

    @property
    def window_s(self) -> float:
        return self.host_s

    def busy_intervals(self) -> list:
        """The device operations' intervals inside the window, merged."""
        out = []
        for a, b, _ in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels_in_window(self) -> list:
        return [k for k in self.kernels if self.t0 <= k[0] < self.t1]

    def device_ops(self, top: int = 10) -> list:
        """``[[name, seconds]]`` of the device operations that took most
        time in the window, summed by name."""
        by = {}
        for a, b, name in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n[:200], s] for n, s in sorted(by.items(),
                                                key=lambda x: -x[1])][:top]

    def _host_during(self, a: float, b: float, after: str) -> str:
        best, share = None, 0.0
        for s, e, name in self.runtime:
            if e <= a:
                continue
            if s >= b:
                break
            over = min(b, e) - max(a, s)
            if over > share:
                best, share = name, over
        if best is not None and share >= 0.5 * (b - a):
            return f"host in {best}"
        return f"host before {after}"

    def idle_gaps(self, top: int = 10) -> list:
        """``[[what the host was doing, seconds]]`` of the longest
        stretches of the window with nothing on the device."""
        busy = self.busy_intervals()
        if not busy:
            return []
        nxt = {max(a, self.t0): short_name(n) for a, _, n in self.device}
        gaps, prev = [], self.t0
        for a, b in busy:
            if a > prev:
                gaps.append((a - prev, prev, a, nxt.get(a, "?")))
            prev = b
        if self.t1 > prev:
            gaps.append((self.t1 - prev, prev, self.t1, "the window's end"))
        gaps.sort(reverse=True)
        return [[self._host_during(a, b, after), g / 1e6]
                for g, a, b, after in gaps[:top]]


def traced(run) -> Trace:
    """``run()`` under the profiler, ended by a synchronise; the chrome
    trace is read back and deleted."""
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        if on_card:
            torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return Trace(events, host_s)
