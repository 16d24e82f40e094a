"""Device time by the port's own spans: each device operation of a
``torch.profiler`` trace given the phase and the part of the program that
launched it. Imports nothing of the port: it reads the port's span events
as dicts (``name``, ``t0_ns``, ``dur_ns``, ``tid``, ``args``, as
``observability.trace.events()`` gives them) beside the trace's own
Chrome document.

- The spans are stamped on ``perf_counter_ns``, the trace on Unix time
  (``ts`` µs past ``baseTimeNanoseconds``); a span's place on the trace's
  clock is its stamp plus the port's Unix-minus-monotonic offset, less
  the trace's base.
- A device operation (kernel, copy, memset) is matched to the runtime
  call that launched it through the trace's ``correlation`` id.
- Its **phase** is the innermost ``engine.*`` span open on the engine's
  thread (the one that records ``engine.window``) at the runtime call's
  time. Autograd launches the backward from a thread of its own, while
  the engine's thread waits inside ``engine.grads``: those launches fall
  inside ``engine.grads`` and outside ``engine.forward``, the backward.
- Its **part** is the innermost span open on the launching thread. A
  trace of device activity alone names a runtime call's thread by the
  magnitude of the low 32 bits of its pthread id, read as a signed
  integer (``torch`` 2.11); with host activity on, by the OS thread id
  the spans carry. :func:`trace_tids` maps either onto the spans' ids;
  where no runtime call's thread is among them, the part is read on the
  engine's thread by time alone.
- Operations under no ``engine.*`` span are outside the program.
"""

from __future__ import annotations

import bisect
import dataclasses

from portbench.trace import DEVICE_CATS, Trace, short_name

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "engine.window"
OUTSIDE = "outside the program"
#: the metrics' phases: the innermost engine span a phase is read from
PHASES = {"forward": "engine.forward", "backward": "engine.grads",
          "update": "engine.update", "merge": "engine.merge"}
FUSED_CE = "fused_ce."


def to_trace_us(t_ns: int, offset_ns: int, base_ns: int) -> float:
    """A span stamp (``perf_counter_ns``) on the trace's clock, µs past
    the trace's ``baseTimeNanoseconds``; integers until the last step, so
    that nanoseconds survive."""
    return (int(t_ns) + int(offset_ns) - int(base_ns)) / 1e3


class Innermost:
    """The innermost of nested intervals ``(start, end, name)`` open at a
    time, from one sweep that records which interval is innermost from
    each boundary on (an interval that outlives its parent is cut at the
    parent's end)."""

    def __init__(self, intervals):
        self.times, self.names = [], []
        stack = []                      # (end, name), innermost last

        def close_until(t):
            while stack and stack[-1][0] <= t:
                end, _ = stack.pop()
                self.times.append(end)
                self.names.append(stack[-1][1] if stack else None)

        for s, e, name in sorted(intervals, key=lambda x: (x[0], -x[1])):
            if e <= s:
                continue
            close_until(s)
            if stack:
                e = min(e, stack[-1][0])
            stack.append((e, name))
            self.times.append(s)
            self.names.append(name)
        close_until(float("inf"))

    def at(self, t: float):
        i = bisect.bisect_right(self.times, t) - 1
        return self.names[i] if i >= 0 else None


@dataclasses.dataclass
class Split:
    """A traced stretch's device time by phase and part (µs totals)."""

    windows: int                # engine.window spans
    tokens: int                 # their args' tokens, summed
    busy_us: float
    us: dict                    # (phase, part) -> device µs
    launches: dict              # (phase, part) -> device operations
    kernels: dict               # (phase, part) -> {short name: µs}
    gaps: list                  # [[name, seconds]], longest first
    threads_match: bool         # runtime tids are the spans' tids

    def phase_ms(self, phase: str) -> float:
        """Device ms a window whose innermost engine span is ``phase``."""
        return sum(v for (ph, _), v in self.us.items()
                   if ph == phase) / 1e3 / self.windows

    def part_ms(self, prefix: str) -> float:
        """Device ms a window launched under a part named ``prefix…``, in
        any phase."""
        return sum(v for (_, pt), v in self.us.items()
                   if pt.startswith(prefix)) / 1e3 / self.windows


def trace_tids(idents: dict) -> dict:
    """``{trace tid: span tid}`` from ``{OS thread id: pthread id}``
    (``threading``'s ``native_id`` and ``ident`` of each thread): the OS
    id itself, the pthread id's low 32 bits, and their magnitude read as
    a signed integer."""
    out = {}
    for native, ident in idents.items():
        low = int(ident) & 0xFFFFFFFF
        signed = low - (1 << 32) if low >= 1 << 31 else low
        for k in (native, low, abs(signed)):
            out.setdefault(k, native)
    return out


def _engine_tid(spans: list):
    tids = [s["tid"] for s in spans if s["name"] == WINDOW]
    return max(set(tids), key=tids.count) if tids else None


def split(doc: dict, spans: list, offset_ns: int, host_s: float,
          idents: dict | None = None, top: int = 10) -> Split | None:
    """The split of ``doc`` (a Chrome trace of ``torch.profiler``) by the
    port's ``spans`` recorded over the same stretch, ``host_s`` seconds
    long from its first runtime call or device operation, with the
    recording threads' ``{OS thread id: pthread id}`` (``idents``); None
    without an ``engine.window`` span or a device operation."""
    events = doc.get("traceEvents", [])
    base = int(doc.get("baseTimeNanoseconds", 0))
    engine = _engine_tid(spans)
    if engine is None:
        return None
    by_tid = {}
    for s in spans:
        if s.get("cat") == "__counter__" or s["dur_ns"] <= 0:
            continue
        a = to_trace_us(s["t0_ns"], offset_ns, base)
        b = to_trace_us(s["t0_ns"] + s["dur_ns"], offset_ns, base)
        by_tid.setdefault(s["tid"], []).append((a, b, s["name"]))
    phase_at = Innermost([x for x in by_tid[engine]
                          if x[2].startswith("engine.")])
    part_at = {tid: Innermost(v) for tid, v in by_tid.items()}
    alias = trace_tids(idents or {})
    runtime, ops = {}, []
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") != "X" or corr is None:
            continue
        if e.get("cat") in RUNTIME_CATS:
            tid = e.get("tid")
            runtime[corr] = (float(e["ts"]), alias.get(tid, tid))
        elif e.get("cat") in DEVICE_CATS:
            ops.append((float(e.get("dur", 0)), e.get("name", ""), corr))
    if not ops:
        return None
    threads_match = any(tid in part_at for _, tid in runtime.values())
    us, launches, kernels = {}, {}, {}
    for dur, name, corr in ops:
        call = runtime.get(corr)
        phase = part = None
        if call is not None:
            t, tid = call
            phase = phase_at.at(t)
            where = part_at.get(tid if threads_match else engine)
            part = where.at(t) if where is not None else None
            if part is None:
                part = ("no span, engine thread" if tid == engine
                        else "no span, another thread")
        key = (phase or OUTSIDE, part or OUTSIDE)
        us[key] = us.get(key, 0.0) + dur
        launches[key] = launches.get(key, 0) + 1
        kn = kernels.setdefault(key, {})
        kn[short_name(name)] = kn.get(short_name(name), 0.0) + dur
    tr = Trace(events, host_s)
    windows = [s for s in spans if s["name"] == WINDOW]
    return Split(
        windows=len(windows),
        tokens=sum(int((s.get("args") or {}).get("tokens", 0))
                   for s in windows),
        busy_us=tr.busy_s() * 1e6, us=us, launches=launches,
        kernels=kernels,
        gaps=idle_gaps(tr, Innermost(by_tid[engine]).at, top),
        threads_match=threads_match)


def idle_gaps(tr: Trace, span_at, top: int = 10) -> list:
    """``portbench.trace.Trace.idle_gaps`` with each gap's name followed
    by the program span open on the engine's thread at the gap's start
    (``host before elementwise_kernel in engine.merge``), or by
    ``outside the program``."""
    busy = tr.busy_intervals()
    if not busy:
        return []
    nxt = {max(a, tr.t0): short_name(n) for a, _, n in tr.device}
    gaps, prev = [], tr.t0
    for a, b in busy:
        if a > prev:
            gaps.append((a - prev, prev, a, nxt.get(a, "?")))
        prev = b
    if tr.t1 > prev:
        gaps.append((tr.t1 - prev, prev, tr.t1, "the window's end"))
    gaps.sort(reverse=True)
    out = []
    for g, a, b, after in gaps[:top]:
        span = span_at(a)
        where = f"in {span}" if span else OUTSIDE
        host = tr._host_during(a, b, after).rstrip()
        out.append([f"{host} {where}", g / 1e6])
    return out


def clock_check(doc: dict, spans: list, offset_ns: int,
                name: str = "portbench.clock",
                call: str = "cudaStreamSynchronize",
                idents: dict | None = None) -> dict | None:
    """Where the runtime call ``call`` lies inside the span ``name`` once
    mapped: ``slack_before_us`` (call start less span start) and
    ``slack_after_us`` (span end less call end), both ≥ 0 when the two
    clocks agree, and whether the call's thread is the span's."""
    span = next((s for s in spans if s["name"] == name), None)
    if span is None:
        return None
    base = int(doc.get("baseTimeNanoseconds", 0))
    a = to_trace_us(span["t0_ns"], offset_ns, base)
    b = to_trace_us(span["t0_ns"] + span["dur_ns"], offset_ns, base)
    calls = [e for e in doc.get("traceEvents", [])
             if e.get("cat") in RUNTIME_CATS and e.get("name") == call
             and e.get("ph") == "X"]
    if not calls:
        return None
    mid = (a + b) / 2
    c = min(calls, key=lambda e: abs(float(e["ts"])
                                     + float(e.get("dur", 0)) / 2 - mid))
    c0, c1 = float(c["ts"]), float(c["ts"]) + float(c.get("dur", 0))
    return {"slack_before_us": c0 - a, "slack_after_us": b - c1,
            "span_us": b - a, "same_thread": trace_tids(idents or {}).get(
                c.get("tid"), c.get("tid")) == span["tid"]}


def table(s: Split) -> list[str]:
    """Lines of device ms and launches a window by phase and part, with
    each row's elementwise ms and its largest kernels by short name."""
    w = s.windows
    lines = [f"{'phase':<16} {'part':<24} {'ms/win':>8} {'launch/win':>10} "
             f"{'eltwise ms':>10}  largest kernels (ms/win)"]
    for key in sorted(s.us, key=lambda k: -s.us[k]):
        kn = s.kernels[key]
        elt = sum(v for n, v in kn.items() if "elementwise" in n)
        big = ", ".join(f"{n[:40]} {v / 1e3 / w:.2f}" for n, v in sorted(
            kn.items(), key=lambda x: -x[1])[:3])
        lines.append(f"{key[0]:<16} {key[1]:<24} {s.us[key] / 1e3 / w:8.2f} "
                     f"{s.launches[key] / w:10.1f} {elt / 1e3 / w:10.2f}  "
                     f"{big}")
    four = sum(s.phase_ms(p) for p in PHASES.values())
    out = sum(v for (ph, _), v in s.us.items() if ph == OUTSIDE) / 1e3 / w
    busy = s.busy_us / 1e3 / w
    lines.append(f"busy {busy:.2f} ms/win over {w} windows; forward + "
                 f"backward + update + merge {four:.2f} "
                 f"({100 * four / busy:.2f}% of busy); {OUTSIDE} "
                 f"{out:.3f} ({100 * out / busy:.3f}%)")
    return lines
