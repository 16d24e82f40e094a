"""The analyst: critical-path attribution and bottleneck diagnosis.

The port's copy of ``distkeras_tpu/observability/analyze.py``: the same
report from the same events. The flight recorder answers "what happened"
and the watchtower "is it healthy right now"; this module answers **why
is this run slow, and which knob fixes it**. It is strictly post-hoc: it
consumes the span streams the recorder already captured (in-memory
``trace.events()`` or a saved Chrome-trace file) plus, optionally, the
watchtower's time-series dump — the training/serving hot paths pay
nothing for it, and a no-trace run pays nothing at all.

The machinery, bottom up:

- **Interval algebra.** Spans are ``[t0, t0+dur)`` intervals;
  :func:`union_length` / :func:`intersect_intervals` are the primitives
  everything else uses. Regime fractions are computed over per-bucket
  interval UNIONS across all threads, not sums: four workers waiting on
  the same group fsync cost the run one fsync of wall time, not four —
  summed attribution (who waited how much) is reported separately, per
  worker.
- **Window assembly.** Each worker's ``worker.fetch`` spans anchor its
  windows (one fetch per window in every loop shape — serial,
  pipelined, elastic); the compress/commit/pull/compute spans between
  two fetch anchors belong to the earlier window. The window's commit
  is then decomposed against the PS-side spans that share its
  correlation id (or nest inside it on the same thread — the in-process
  transport): ``ps.decode`` → center-lock wait (the decode→fold gap) →
  ``ps.fold`` → ``ps.wal_append`` → ``ps.wal_wait``/``wal.fsync``, and
  whatever remains is wire time. A window missing its anchor or commit
  is SKIPPED and counted — dropped spans never become invented time.
- **Overlap.** ``worker.compute`` spans run dispatch → fetch-return, so
  ``|exchange ∩ compute| / |exchange|`` is the fraction of exchange
  hidden under the window's outstanding device work — ~0.0 for the
  serial loop, ~1.0 for ``ps_pipeline_depth=1`` (the pipelined loop's claim,
  measured per run). The fraction is an upper bound: a device that
  finishes mid-exchange is indistinguishable from one that ran through
  it without device-side events, so per-window CRITICAL attribution
  additionally checks the fetch residue — a pipelined window whose
  fetch still waited was compute-critical (its hidden exchange charged
  to compute), one whose fetch returned immediately was
  exchange-critical.
- **Verdict.** :func:`classify` turns the bucket fractions into one of
  :data:`REGIMES` (``host-core-bound`` refines ``compute-bound`` when
  the worker pool oversubscribes the host's cores and their busy
  intervals saturate them) and keys up to three recommendations to
  existing knobs. ``trace_dropped_spans > 0`` marks the whole verdict
  ``degraded``.

Surfaces: ``python -m distkeras_tpu_torch.observability analyze <trace.json>
[--series <dump.json>] [--json]`` (both files may be gzipped), the
trainer knob ``analyze=True`` (→ ``trainer.analysis_``), and
:func:`regime_source` feeding ``analyze.regime_code`` into the
watchtower store so ``watch.BottleneckShiftRule`` can fire when the
dominant regime changes mid-run.
"""

from __future__ import annotations

import bisect
import os
from typing import Any, Callable

from distkeras_tpu_torch.observability.trace import load_json_maybe_gz

__all__ = [
    "REGIMES", "load_trace", "analyze_events", "analyze_trace",
    "bucket_totals", "classify", "format_report", "union_length",
    "merge_intervals", "intersect_intervals", "regime_source",
    "RegimeTracker", "regime_code",
]

#: the typed regime vocabulary (index == the ``analyze.regime_code``
#: series value the watchtower's shift rule reads). ``queue-bound`` is
#: the serving tier's admission-wait regime; ``idle`` means the trace
#: carried no attributable work.
REGIMES = (
    "compute-bound",        # 0: device/window compute dominates
    "wire-bound",           # 1: exchange transport (incl. decode) dominates
    "fsync-bound",          # 2: durable logging (append/flush/fsync/wait)
    "fold-lock-bound",      # 3: center-lock queueing + fold dominates
    "host-core-bound",      # 4: compute-bound AND the host's cores are
    #                            oversubscribed by the worker pool
    "queue-bound",          # 5: serving admission queue dominates
    "idle",                 # 6: nothing attributable recorded
)

#: bucket → regime mapping for the training-side classifier
_TRAIN_BUCKET_REGIME = {
    "compute": "compute-bound",
    "wire": "wire-bound",
    "decode": "wire-bound",
    "wal": "fsync-bound",
    "lock_wait": "fold-lock-bound",
    "fold": "fold-lock-bound",
}

#: span names claimed by a window's commit decomposition (matched by
#: corr, or by same-thread nesting for the in-process transport)
_SERVER_SPAN_NAMES = frozenset((
    "ps.decode", "ps.fold", "ps.wal_append", "ps.wal_wait", "wal.fsync",
))

_EPS_NS = 50_000          # 50 µs: "the fetch returned immediately"


def regime_code(name: str) -> int:
    """Regime name → its :data:`REGIMES` index (the series encoding)."""
    return REGIMES.index(name)


# -- interval algebra ---------------------------------------------------------

def merge_intervals(ivs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Sorted, non-overlapping union of ``[a, b)`` intervals."""
    out: list[tuple[int, int]] = []
    for a, b in sorted(iv for iv in ivs if iv[1] > iv[0]):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def union_length(ivs: list[tuple[int, int]]) -> int:
    """Total covered length of a set of intervals (overlaps once)."""
    return sum(b - a for a, b in merge_intervals(ivs))


def intersect_intervals(xs: list[tuple[int, int]],
                        ys: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Intersection of two interval unions (both merged first)."""
    xs, ys = merge_intervals(xs), merge_intervals(ys)
    out = []
    i = j = 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _iv(e: dict) -> tuple[int, int]:
    return (e["t0_ns"], e["t0_ns"] + e["dur_ns"])


# -- trace loading ------------------------------------------------------------


def load_trace(path: str) -> tuple[list[dict], dict]:
    """Read a Chrome trace-event file (``trace.save()``'s output, plain
    or gzipped) back into tracer-shaped event dicts. Returns
    ``(events, meta)`` where ``meta`` carries ``otherData`` —
    ``dropped_events`` and ``host_cores`` when the writer stamped them.
    Counter records (``ph: "C"``) come back with the tracer's
    ``__counter__`` category and their value as ``args``."""
    doc = load_json_maybe_gz(path)
    tnames: dict[int, str] = {}
    events: list[dict] = []
    for rec in doc.get("traceEvents", []):
        ph = rec.get("ph")
        if ph == "M":
            if rec.get("name") == "thread_name":
                tnames[rec.get("tid", 0)] = rec.get("args", {}).get(
                    "name", "")
            continue
        if ph == "C":
            events.append({
                "name": rec["name"], "cat": "__counter__", "corr": None,
                "t0_ns": int(rec["ts"] * 1e3), "dur_ns": 0,
                "tid": rec.get("tid", 0), "tname": "",
                "args": rec.get("args", {}).get("value"),
            })
            continue
        if ph != "X":
            continue
        args = dict(rec.get("args") or {})
        corr = args.pop("corr", None)
        events.append({
            "name": rec["name"], "cat": rec.get("cat", ""), "corr": corr,
            "t0_ns": int(rec["ts"] * 1e3),
            "dur_ns": int(rec.get("dur", 0) * 1e3),
            "tid": rec.get("tid", 0), "tname": "", "args": args or None,
        })
    for e in events:
        e["tname"] = tnames.get(e["tid"], e["tname"])
    events.sort(key=lambda e: e["t0_ns"])
    return events, dict(doc.get("otherData") or {})


# -- window assembly ----------------------------------------------------------

def _worker_of(corr) -> str | None:
    """``w3:s17`` / ``w3:x5`` / ``w3`` → ``"3"``; None otherwise."""
    if not isinstance(corr, str) or not corr.startswith("w"):
        return None
    head = corr.split(":", 1)[0][1:]
    return head if head.isdigit() else None


def _assemble_windows(events: list[dict]) -> tuple[dict, int]:
    """→ ``({wid: [window dicts]}, skipped)``. A window anchors on one
    ``worker.fetch``; sibling worker spans between two anchors attach to
    the earlier one (``worker.compute`` attaches by its END, which
    coincides with its window's fetch-return). Server-side spans are
    claimed by corr match or same-thread nesting inside the commit.
    Windows without a commit (dropped spans, the not-yet-flushed tail of
    a pipelined run) are skipped, never guessed at."""
    per_worker: dict[str, list[dict]] = {}
    server_by_corr: dict[str, list[dict]] = {}
    for e in events:
        name = e["name"]
        if name.startswith("worker."):
            wid = _worker_of(e["corr"])
            if wid is not None:
                per_worker.setdefault(wid, []).append(e)
        elif name in _SERVER_SPAN_NAMES and e["corr"] is not None:
            server_by_corr.setdefault(e["corr"], []).append(e)

    out: dict[str, list[dict]] = {}
    skipped = 0
    for wid, evs in per_worker.items():
        fetches = sorted((e for e in evs if e["name"] == "worker.fetch"),
                         key=lambda e: e["t0_ns"])
        if not fetches:
            skipped += sum(1 for e in evs if e["name"] == "worker.commit")
            continue
        bounds = [f["t0_ns"] for f in fetches]
        wins: list[dict] = [
            {"fetch": f, "compress": None, "commit": None, "pull": None,
             "compute": None} for f in fetches
        ]
        for e in sorted(evs, key=lambda ev: ev["t0_ns"]):
            name = e["name"]
            if name == "worker.fetch":
                continue
            # compute spans START before their window's anchor (the
            # dispatch precedes the fetch) — place them by their end,
            # which IS the fetch-return of their window
            t = (e["t0_ns"] + e["dur_ns"] if name == "worker.compute"
                 else e["t0_ns"])
            if t < bounds[0]:
                skipped += 1 if name == "worker.commit" else 0
                continue
            key = name.split(".", 1)[1]
            # the window whose anchor interval contains t
            w = wins[bisect.bisect_right(bounds, t) - 1]
            if key in w and w[key] is None:
                w[key] = e
        kept = []
        for w in wins:
            if w["commit"] is None:
                skipped += 1
                continue
            kept.append(_decompose_window(w, server_by_corr))
        if kept:
            _mark_hidden(kept)
            out[wid] = kept
    return out, skipped


def _mark_hidden(wins: list[dict]) -> None:
    """Post-pass over one worker's decomposed windows: a commit is
    HIDDEN when it lies inside the worker's compute union — in the
    pipelined loop window N's commit runs under window N+1's
    dispatch→fetch-return span, so containment is checked against the
    union, not the commit's own window. ``residue_fetch_ns`` is the
    duration of the first fetch that starts after the commit ends (the
    pipelined loop's post-exchange device wait): a positive residue
    means the device outlasted the hidden exchange — the compute was
    the window's critical path."""
    wins.sort(key=lambda w: w["t0_ns"])
    comp = merge_intervals([w["compute_iv"] for w in wins
                            if w["compute_iv"] is not None])
    fetches = sorted(w["fetch_iv"] for w in wins)
    starts = [f[0] for f in fetches]
    for w in wins:
        c0, c1 = w["commit_iv"]
        w["hidden_exchange"] = any(a <= c0 and c1 <= b for a, b in comp)
        k = bisect.bisect_left(starts, c1)
        w["residue_fetch_ns"] = (fetches[k][1] - fetches[k][0]
                                 if k < len(fetches) else 0)
        # the elastic (EASGD) loop pulls BEFORE its window's fetch, so
        # the pull attaches to the previous window AND runs inside the
        # next one's dispatch→fetch-return span — hidden under compute,
        # charged nothing (same rule as hidden commits; an unfused
        # serial pull sits outside every compute span and stays charged)
        if w["pull_iv"] is not None:
            p0, p1 = w["pull_iv"]
            w["pull_hidden"] = any(a <= p0 and p1 <= b for a, b in comp)


def _decompose_window(w: dict, server_by_corr: dict) -> dict:
    """One window's waterfall: worker phases + the commit's server-side
    decomposition (decode → lock wait → fold → wal append/wait → wire
    residue), all in ns."""
    fetch, commit = w["fetch"], w["commit"]
    c0, c1 = _iv(commit)
    # corr matching covers every transport: the socket/shm handler
    # adopts the frame's corr, the in-process server section runs on
    # the worker's own thread under its corr, and the batched-fold
    # drain stamps each fold with the COMMIT's corr. The group
    # flusher's fsync carries no corr — its cost reaches the window
    # through ps.wal_wait, never double-counted here.
    claimed: list[dict] = list(server_by_corr.get(commit["corr"], []))
    named = {n: [e for e in claimed if e["name"] == n]
             for n in _SERVER_SPAN_NAMES}
    decode = sum(e["dur_ns"] for e in named["ps.decode"])
    fold = sum(e["dur_ns"] for e in named["ps.fold"])
    wal = (sum(e["dur_ns"] for e in named["ps.wal_append"])
           + sum(e["dur_ns"] for e in named["ps.wal_wait"])
           + sum(e["dur_ns"] for e in named["wal.fsync"]))
    # center-lock wait: decode-end → fold-start where both sides were
    # recorded (socket/shm); commit-start → fold-start for the
    # in-process transport (no decode span; the client call does
    # nothing else before contending)
    lock_wait = 0
    lock_iv = None
    if named["ps.fold"]:
        fold0 = min(e["t0_ns"] for e in named["ps.fold"])
        if named["ps.decode"]:
            dec1 = max(_iv(e)[1] for e in named["ps.decode"])
            lock_wait = max(0, fold0 - dec1)
            if lock_wait:
                lock_iv = (dec1, fold0)
        elif fold0 >= c0:
            lock_wait = max(0, fold0 - c0)
            if lock_wait:
                lock_iv = (c0, fold0)
    server = decode + fold + wal + lock_wait
    commit_dur = commit["dur_ns"]
    wire = max(0, commit_dur - server)
    pull = w["pull"]["dur_ns"] if w["pull"] else 0
    compute = w["compute"]
    start = compute["t0_ns"] if compute is not None else fetch["t0_ns"]
    end = max(_iv(commit)[1], _iv(fetch)[1],
              _iv(w["pull"])[1] if w["pull"] else 0)
    return {
        "corr": commit["corr"], "t0_ns": start, "t1_ns": end,
        "tid": commit["tid"],
        "fetch_ns": fetch["dur_ns"],
        "compress_ns": w["compress"]["dur_ns"] if w["compress"] else 0,
        "commit_ns": commit_dur, "pull_ns": pull,
        "compute_ns": compute["dur_ns"] if compute is not None else None,
        "compute_iv": _iv(compute) if compute is not None else None,
        "fetch_iv": _iv(fetch), "commit_iv": (c0, c1),
        "pull_iv": _iv(w["pull"]) if w["pull"] else None,
        "decode_ns": decode, "lock_wait_ns": lock_wait,
        "lock_iv": lock_iv,
        "fold_ns": fold, "wal_ns": wal, "wire_ns": wire,
        # filled by _mark_hidden (needs the whole worker's windows)
        "hidden_exchange": False, "pull_hidden": False,
        "residue_fetch_ns": 0,
    }


def _exchange_free(win: dict) -> bool:
    """A window's exchange cost the critical path nothing: it ran
    hidden under outstanding compute AND the device still had work left
    when it finished (the following fetch genuinely waited)."""
    return win["hidden_exchange"] and win["residue_fetch_ns"] > _EPS_NS


def _critical_buckets(win: dict, prev: dict | None) -> dict[str, int]:
    """One window's CRITICAL-path attribution (ns per bucket; the values
    sum to roughly what the window cost the worker's timeline).

    Serial window: the dispatch→fetch-return stretch is compute (it
    holds the jit dispatch, any compile, and the blocking wait; the
    exchange lies entirely outside it) and each exchange phase is
    exposed. Pipelined window: its commit runs under the NEXT window's
    compute span — if the fetch after it still waited, the device was
    the constraint and the hidden exchange is charged nothing; if the
    fetch returned immediately, the exchange was the constraint and its
    decomposition is charged. Symmetrically, a window whose compute
    span envelops the PREVIOUS window's non-free commit only counts its
    observable fetch residue as compute — the enveloped stretch was
    already charged to that exchange."""
    if _exchange_free(win):
        exch = {"wire": 0, "decode": 0, "lock_wait": 0, "fold": 0,
                "wal": 0}
    else:
        exch = {"wire": win["wire_ns"], "decode": win["decode_ns"],
                "lock_wait": win["lock_wait_ns"], "fold": win["fold_ns"],
                "wal": win["wal_ns"]}
    if prev is not None and prev["hidden_exchange"] \
            and not _exchange_free(prev):
        compute = win["fetch_ns"]
    else:
        compute = (win["compute_ns"] if win["compute_ns"] is not None
                   else win["fetch_ns"])
    return {
        "compute": compute,
        "compress": win["compress_ns"],
        "pull": 0 if win["pull_hidden"] else win["pull_ns"],
        **exch,
    }


# -- bucket totals (union-based, the classifier's input) ----------------------

def bucket_totals(events: list[dict]) -> dict[str, float]:
    """Per-bucket wall coverage in ms — interval UNIONS across all
    threads, so N workers waiting on one fsync count it once. This is
    the classifier's input; the per-worker sums (who waited how much)
    live in the full report. Works on any event slice, which is what
    :class:`RegimeTracker` feeds it."""
    ivs: dict[str, list] = {
        "compute": [], "compress": [], "wire": [], "decode": [],
        "lock_wait": [], "fold": [], "wal": [],
        "serve_queue": [], "serve_prefill": [], "serve_decode": [],
    }
    exchange: list[tuple[int, int]] = []
    compute: list[tuple[int, int]] = []
    fetch: list[tuple[int, int]] = []
    wal_wait: list[tuple[int, int]] = []
    for e in events:
        name, iv = e["name"], _iv(e)
        if e["cat"] == "__counter__" or e["dur_ns"] <= 0:
            continue
        if name == "worker.compute":
            compute.append(iv)
        elif name == "worker.fetch":
            fetch.append(iv)
        elif name == "worker.compress":
            ivs["compress"].append(iv)
        elif name in ("worker.commit", "worker.pull"):
            exchange.append(iv)
        elif name == "ps.decode":
            ivs["decode"].append(iv)
        elif name == "ps.fold":
            ivs["fold"].append(iv)
        elif name in ("ps.wal_append", "wal.fsync"):
            ivs["wal"].append(iv)
        elif name == "ps.wal_wait":
            # deferred-ACK waits count per WINDOW (who waited how long —
            # the sums) but not in the wall-union bucket: N workers
            # convoyed behind one flusher would otherwise read as N
            # bands of "disk time" when the disk did one fsync — the
            # union's wal bucket is what the log device actually DID
            # (appends + fsyncs)
            wal_wait.append(iv)
        elif name == "serve.queued":
            ivs["serve_queue"].append(iv)
        elif name == "serve.prefill":
            ivs["serve_prefill"].append(iv)
        elif name == "serve.decode_step":
            ivs["serve_decode"].append(iv)
    # compute evidence: real dispatch→fetch-return spans where present,
    # else the blocking fetch (older traces / foreign scrape)
    ivs["compute"] = compute if compute else fetch
    # wire = exchange wall not covered by any server-side section and
    # not hidden under outstanding compute (wal waits ARE covered —
    # they must not resurface as wire)
    server = (ivs["decode"] + ivs["fold"] + ivs["wal"] + wal_wait
              + (compute if compute else []))
    exch_u = merge_intervals(exchange)
    covered = intersect_intervals(exch_u, server)
    ivs["wire"] = _subtract(exch_u, covered)
    # lock wait needs pairing, which a flat slice cannot do — it is
    # folded into the per-window report; here the fold bucket carries
    # the locked section itself
    out = {k: union_length(v) / 1e6 for k, v in ivs.items()}
    out["lock_wait"] = 0.0
    return out


def _subtract(xs: list[tuple[int, int]],
              ys: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Interval union difference ``xs \\ ys`` (both merged)."""
    out = []
    ys = merge_intervals(ys)
    for a, b in merge_intervals(xs):
        cur = a
        for c, d in ys:
            if d <= cur or c >= b:
                continue
            if c > cur:
                out.append((cur, c))
            cur = max(cur, d)
            if cur >= b:
                break
        if cur < b:
            out.append((cur, b))
    return out


# -- the classifier -----------------------------------------------------------

def classify(totals_ms: dict[str, float], *, host_cores: int | None = None,
             n_workers: int = 0, wall_ms: float = 0.0,
             busy_ms: float = 0.0,
             serving_only: bool = False) -> tuple[str, dict]:
    """→ ``(regime, fractions)``. Training buckets win when present;
    a serving-only trace classifies over queue/prefill/decode.
    ``host-core-bound`` refines ``compute-bound`` when the pool
    oversubscribes the host and the threads' busy unions saturate it."""
    train_keys = ("compute", "compress", "wire", "decode", "lock_wait",
                  "fold", "wal")
    serve_keys = ("serve_queue", "serve_prefill", "serve_decode")
    keys = serve_keys if serving_only else train_keys
    total = sum(totals_ms.get(k, 0.0) for k in keys)
    if total <= 0.0:
        return "idle", {}
    fr = {k: totals_ms.get(k, 0.0) / total for k in keys}
    if serving_only:
        top = max(serve_keys, key=lambda k: fr[k])
        regime = {"serve_queue": "queue-bound",
                  "serve_prefill": "compute-bound",
                  "serve_decode": "compute-bound"}[top]
        return regime, fr
    grouped = {
        "compute-bound": fr["compute"] + fr["compress"],
        "wire-bound": fr["wire"] + fr["decode"],
        "fsync-bound": fr["wal"],
        "fold-lock-bound": fr["lock_wait"] + fr["fold"],
    }
    regime = max(grouped, key=lambda k: grouped[k])
    # duty-cycle override: when the log device was doing durable work
    # (appends + fsyncs, overlaps counted once) for more than half the
    # run's wall, the run is fsync-bound even if compute spans cover a
    # comparable stretch — compute parallelizes across workers and
    # devices, the log is the serial resource, and the group-commit
    # knob is what moves it
    if (wall_ms > 0 and totals_ms.get("wal", 0.0) / wall_ms > 0.5
            and grouped["fsync-bound"]
            >= max(grouped["wire-bound"], grouped["fold-lock-bound"])):
        regime = "fsync-bound"
    if (regime == "compute-bound" and host_cores
            and n_workers > host_cores and wall_ms > 0
            and busy_ms / (wall_ms * host_cores) > 0.85):
        regime = "host-core-bound"
    fr["_grouped"] = grouped
    return regime, fr


def _recommend(report: dict) -> list[str]:
    """Up to three knob-keyed recommendations, most load-bearing first."""
    recs: list[str] = []
    verdict = report["verdict"]
    regime = verdict["regime"]
    tr = report.get("training") or {}
    counters = report.get("counters") or {}
    if report.get("degraded"):
        recs.append(
            "trace dropped spans (ring overflow) — attribution is a "
            "lower bound; raise trace ring_size or trace_sample down "
            "before trusting marginal calls"
        )
    straggler = tr.get("dominant_wait_worker")
    if straggler is not None:
        recs.append(
            f"worker {straggler} dominates wait time "
            f"({tr['workers'][str(straggler)]['stall_ms']:.0f} ms "
            f"stalled) — a straggler host: drain it (elastic=True with "
            f"autoscale_target; DynSGD is already down-weighting its "
            f"commits)"
        )
    if regime == "fsync-bound":
        recs.append(
            "durable logging dominates — raise ps_wal_group_window "
            "(one fsync per group amortizes the tail) and/or move "
            "ps_wal_dir to a faster filesystem"
        )
    if regime == "wire-bound":
        overlap = tr.get("overlap", {}).get("fraction")
        if overlap is not None and overlap > 0.5:
            recs.append(
                "exchange outlasts compute even at pipeline depth 1 — "
                "the wire itself dominates: try ps_transport='shm' "
                "(colocated) or compression='int8' to shrink the bytes"
            )
        else:
            recs.append(
                "exchange RTT is exposed — enable ps_pipeline_depth=1 "
                "(overlap it with the next window's compute), keep "
                "ps_fused_exchange=True, or move colocated workers to "
                "ps_transport='shm'"
            )
    if regime == "fold-lock-bound":
        recs.append(
            "center-lock queueing/fold dominates — raise ps_num_shards "
            "(leaf-sharded centers fold in parallel); batched folds "
            "already amortize the lock for colocated workers"
        )
    if regime == "host-core-bound":
        recs.append(
            "the worker pool oversubscribes this host's cores — fewer "
            "colocated workers (or more cores) before any transport "
            "knob will show"
        )
    ring = counters.get("shm.ring_occupancy_frac", {}).get("max")
    if ring is not None and ring > 0.9:
        recs.append(
            "shm ring occupancy peaked above 0.9 — the writer is about "
            "to block on the reader: raise the shm ring capacity "
            "(ring_bytes)"
        )
    tau = counters.get("ps.tau_p95", {}).get("last")
    if tau is not None and tau > 16:
        recs.append(
            f"DynSGD τ p95 ended at {tau:.0f} — staleness is pricing "
            f"commits toward nothing; look at the straggler table "
            f"before adding workers"
        )
    sv = report.get("serving") or {}
    if sv and sv.get("dominant") == "queue":
        recs.append(
            "serving requests wait in admission — raise max_batch / "
            "block budget, or add replicas; occupancy says whether the "
            "batch is already full"
        )
    if not recs:
        if regime == "idle":
            recs.append(
                "nothing attributable was recorded — enable tracing "
                "around the workload (trainer trace=True / analyze=True,"
                " bench --trace-dir) before diagnosing"
            )
        else:
            recs.append(
                "no single bottleneck — the run is balanced; scale the "
                "knob matching the regime fractions if throughput must "
                "rise"
            )
    return recs[:3]


# -- the full analysis --------------------------------------------------------

def analyze_events(events: list[dict], *, dropped: int = 0,
                   host_cores: int | None = None,
                   store=None, series: dict | None = None) -> dict:
    """Analyze a full event stream → the report dict (see module doc).
    ``store`` is an optional live ``TimeSeriesStore``; ``series`` an
    already-loaded dump document — either contributes the counters
    section (τ tail, ring occupancy, alert names)."""
    if host_cores is None:
        host_cores = os.cpu_count() or 1
    spans = [e for e in events
             if e.get("cat") != "__counter__" and e.get("dur_ns", 0) >= 0]
    counters = _counter_summary(events, store=store, series=series)
    wall_ns = 0
    if spans:
        t0 = min(e["t0_ns"] for e in spans)
        t1 = max(e["t0_ns"] + e["dur_ns"] for e in spans)
        wall_ns = max(0, t1 - t0)
    busy_ns = _busy_ns(spans)
    totals = bucket_totals(spans)
    windows, skipped = _assemble_windows(spans)
    training = _training_report(windows, totals) if windows else None
    serving = _serving_report(spans)
    serving_only = training is None and serving is not None
    n_workers = len(windows)
    # fold the lock-wait UNION into the classifier's totals (the flat
    # slice cannot pair decode→fold gaps; the windows can) — and carve
    # it out of the wire residue, which covered the same wall stretch.
    # Union, not the per-worker sum: convoyed waits would otherwise
    # zero out genuinely wire-dominated runs.
    if training is not None:
        lw = training["union_ms"]["lock_wait"]
        totals["lock_wait"] = lw
        totals["wire"] = max(0.0, totals["wire"] - lw)
    regime, fractions = classify(
        totals, host_cores=host_cores, n_workers=n_workers,
        wall_ms=wall_ns / 1e6, busy_ms=busy_ns / 1e6,
        serving_only=serving_only,
    )
    report = {
        "ok": True,
        "degraded": dropped > 0,
        "dropped_spans": int(dropped),
        "skipped_windows": int(skipped),
        "host_cores": int(host_cores),
        "wall_s": wall_ns / 1e9,
        "host_busy_fraction": (busy_ns / (wall_ns * host_cores)
                               if wall_ns else 0.0),
        "training": training,
        "serving": serving,
        "counters": counters,
        "verdict": {
            "regime": regime,
            "regime_code": regime_code(regime),
            "degraded": dropped > 0,
            "fractions": {k: round(v, 4) for k, v in fractions.items()
                          if not k.startswith("_")},
        },
    }
    report["verdict"]["recommendations"] = _recommend(report)
    return report


def _busy_ns(spans: list[dict]) -> int:
    """Σ over threads of each thread's busy union — the host-saturation
    numerator (nested spans count once per thread)."""
    per_tid: dict[int, list] = {}
    for e in spans:
        if e["dur_ns"] > 0:
            per_tid.setdefault(e["tid"], []).append(_iv(e))
    return sum(union_length(v) for v in per_tid.values())


def _training_report(windows: dict[str, list[dict]],
                     totals: dict[str, float]) -> dict:
    workers: dict[str, dict] = {}
    crit_totals = {k: 0.0 for k in ("compute", "compress", "wire",
                                    "decode", "lock_wait", "fold", "wal",
                                    "pull")}
    for wid, wins in windows.items():
        sums = {k: 0.0 for k in crit_totals}
        stall = 0
        prev_end = None
        prev = None
        for w in sorted(wins, key=lambda x: x["t0_ns"]):
            for k, v in _critical_buckets(w, prev).items():
                sums[k] += v
            # stall: time between this worker's consecutive windows no
            # span accounts for — batch staging plus anything injected
            # at the boundary (a straggler's sleep lands exactly here)
            if prev_end is not None:
                stall += max(0, w["t0_ns"] - prev_end)
            # the previous loop's true end: commit/fetch end, plus the
            # pull only when it genuinely finished before the next
            # window began — the elastic loop's pull attaches to the
            # previous window yet runs inside the NEXT one's compute
            # span (pull_hidden), and letting it extend prev_end would
            # erase the boundary gap the straggler attribution reads
            prev_end = max(w["commit_iv"][1], w["fetch_iv"][1])
            if w["pull_iv"] is not None and not w["pull_hidden"]:
                prev_end = max(prev_end, w["pull_iv"][1])
            prev = w
        periods = sorted(w["t1_ns"] - w["t0_ns"] for w in wins)
        workers[wid] = {
            **{f"{k}_ms": round(v / 1e6, 3) for k, v in sums.items()},
            "windows": len(wins),
            "stall_ms": round(stall / 1e6, 3),
            "mean_window_ms": round(
                sum(periods) / len(periods) / 1e6, 3),
            "p50_window_ms": round(periods[len(periods) // 2] / 1e6, 3),
            # cadence = window + the stall before the next one: the
            # straggler test — a boundary sleep never shows inside the
            # window span itself
            "mean_cycle_ms": round(
                (sum(periods) + stall) / len(wins) / 1e6, 3),
        }
        for k, v in sums.items():
            crit_totals[k] += v
    overlap_exch, overlap_hidden = _overlap_from_windows(windows)
    med, stragglers, dominant = _stragglers(workers)
    # lock-wait UNION across all windows/threads: workers convoyed on
    # the center lock for the same wall stretch cost the run that
    # stretch once — the classifier's number (the per-worker SUMS above
    # answer who waited how much)
    lock_union = union_length([
        w["lock_iv"] for wins in windows.values() for w in wins
        if w["lock_iv"] is not None
    ])
    return {
        "windows": sum(len(v) for v in windows.values()),
        "workers": workers,
        "totals_ms": {k: round(v / 1e6, 3) for k, v in crit_totals.items()},
        "union_ms": {
            **{k: round(totals.get(k, 0.0), 3)
               for k in ("compute", "compress", "wire", "decode",
                         "fold", "wal")},
            "lock_wait": round(lock_union / 1e6, 3),
        },
        "overlap": {
            "exchange_ms": round(overlap_exch / 1e6, 3),
            "hidden_ms": round(overlap_hidden / 1e6, 3),
            "fraction": (round(overlap_hidden / overlap_exch, 4)
                         if overlap_exch else None),
        },
        "median_cycle_ms": med,
        "stragglers": stragglers,
        "dominant_wait_worker": dominant,
    }


def _overlap_from_windows(windows: dict) -> tuple[int, int]:
    """(total exchange ns, exchange ns hidden under outstanding
    compute) across all workers — the per-run overlap-efficiency
    numerator/denominator."""
    exch_total = hidden_total = 0
    for wins in windows.values():
        for w in wins:
            exch_total += w["commit_ns"] + w["pull_ns"]
            if w["hidden_exchange"]:
                hidden_total += w["commit_ns"]
            # a pull can hide independently of its commit (the elastic
            # loop's pull rides the next window's dispatch while its
            # commit stays exposed) — count each on its own flag, the
            # same rule _critical_buckets charges by
            if w["pull_hidden"]:
                hidden_total += w["pull_ns"]
    return exch_total, hidden_total


def _stragglers(workers: dict) -> tuple[float, list, Any]:
    """Median window cadence, stragglers (mean cycle > 2× the pool
    median), and the dominant wait source (the worker whose stall —
    time between its windows no span accounts for — exceeds 2× the
    median stall AND a tenth of its own timeline)."""
    if not workers:
        return 0.0, [], None
    # LOWER median: with an even pool the upper median is the slower
    # middle worker — at n=2 that is the straggler itself, which could
    # then never exceed 2× "the median" (its own value)
    periods = sorted(w["mean_cycle_ms"] for w in workers.values())
    med = periods[(len(periods) - 1) // 2]
    stragglers = sorted(
        (wid for wid, w in workers.items()
         if med > 0 and w["mean_cycle_ms"] > 2.0 * med),
        key=lambda x: (len(x), x),
    )
    dominant = None
    if len(workers) >= 2:
        stalls = sorted(w["stall_ms"] for w in workers.values())
        med_stall = stalls[(len(stalls) - 1) // 2]
        best = max(workers.items(), key=lambda kv: kv[1]["stall_ms"])
        wid, w = best
        span_ms = w["mean_window_ms"] * w["windows"] + w["stall_ms"]
        if (w["stall_ms"] > max(1.0, 2.0 * med_stall)
                and span_ms > 0 and w["stall_ms"] / span_ms > 0.1):
            dominant = int(wid) if wid.isdigit() else wid
    return med, [int(s) if s.isdigit() else s for s in stragglers], dominant


def _serving_report(spans: list[dict]) -> dict | None:
    reqs: dict[str, dict] = {}
    decode_steps = []
    for e in spans:
        name = e["name"]
        if name == "serve.decode_step":
            decode_steps.append(e)
            continue
        if not name.startswith("serve.") or e["corr"] is None:
            continue
        r = reqs.setdefault(e["corr"], {})
        if name == "serve.request":
            r["total_ns"] = e["dur_ns"]
            args = e.get("args") or {}
            r["state"] = args.get("state")
        elif name == "serve.queued":
            r["queue_ns"] = e["dur_ns"]
        elif name == "serve.prefill":
            r["prefill_ns"] = e["dur_ns"]
    done = {k: r for k, r in reqs.items() if "total_ns" in r}
    if not done and not decode_steps:
        return None
    tot = sum(r["total_ns"] for r in done.values())
    queue = sum(r.get("queue_ns", 0) for r in done.values())
    prefill = sum(r.get("prefill_ns", 0) for r in done.values())
    decode = max(0, tot - queue - prefill)
    buckets = {"queue": queue, "prefill": prefill, "decode": decode}
    dominant = (max(buckets, key=lambda k: buckets[k])
                if tot else "decode")
    # batch occupancy: duration-weighted mean rows in flight over the
    # decode-step spans (their rows arg; "batch" is the older name of
    # the same number)
    wsum = rsum = 0.0
    for e in decode_steps:
        args = e.get("args") or {}
        rows = args.get("rows", args.get("batch"))
        if rows is None or e["dur_ns"] <= 0:
            continue
        wsum += e["dur_ns"]
        rsum += float(rows) * e["dur_ns"]
    return {
        "requests": len(done),
        "totals_ms": {k: round(v / 1e6, 3) for k, v in buckets.items()},
        "dominant": dominant,
        "decode_steps": len(decode_steps),
        "mean_rows_in_flight": (round(rsum / wsum, 3) if wsum else None),
    }


def _counter_summary(events: list[dict], *, store=None,
                     series: dict | None = None) -> dict:
    """last/max per counter name — from the trace's own counter records,
    a live store, or a loaded dump (later sources win)."""
    out: dict[str, dict] = {}

    def _feed(name, values):
        vals = [float(v) for v in values if v is not None]
        if vals:
            out[name] = {"last": vals[-1], "max": max(vals)}

    by_name: dict[str, list] = {}
    for e in events:
        if e.get("cat") == "__counter__" and e.get("args") is not None:
            by_name.setdefault(e["name"], []).append(e["args"])
    for name, vals in by_name.items():
        _feed(name, vals)
    doc = series
    if store is not None:
        doc = store.to_json()
    if doc:
        for name, s in (doc.get("series") or {}).items():
            if name.startswith(("ps.tau", "shm.ring", "serve.active",
                                "analyze.")):
                _feed(name, s.get("v", []))
        alerts = (doc.get("alerts") or {}).get("counts")
        if alerts:
            out["alerts"] = alerts
    return out


def analyze_trace(path: str, series_path: str | None = None,
                  host_cores: int | None = None) -> dict:
    """Analyze a saved trace file (plain or gzipped) — the CLI's and
    CI's entry point. ``series_path`` points at a watchtower/timeseries
    dump; the trace's own ``otherData`` supplies the dropped-span count
    and, when stamped, the recording host's core count (a trace is
    analyzed on whatever machine is handy — the recording host's cores
    are the honest denominator)."""
    events, meta = load_trace(path)
    series = load_json_maybe_gz(series_path) if series_path else None
    if host_cores is None:
        host_cores = meta.get("host_cores")
    report = analyze_events(
        events, dropped=int(meta.get("dropped_events", 0) or 0),
        host_cores=host_cores, series=series,
    )
    report["trace_path"] = path
    return report


# -- human-readable rendering -------------------------------------------------

def format_report(report: dict) -> str:
    lines = []
    v = report["verdict"]
    flag = " [DEGRADED: dropped spans]" if report["degraded"] else ""
    lines.append(f"regime: {v['regime']}{flag}")
    lines.append(
        f"wall {report['wall_s']:.2f}s · host_cores "
        f"{report['host_cores']} · busy {report['host_busy_fraction']:.2f}"
    )
    tr = report.get("training")
    if tr:
        t = tr["totals_ms"]
        lines.append(
            f"training: {tr['windows']} windows · critical-path ms — "
            + " ".join(f"{k}={t[k]:.0f}" for k in (
                "compute", "compress", "wire", "decode", "lock_wait",
                "fold", "wal"))
        )
        ov = tr["overlap"]
        if ov["fraction"] is not None:
            lines.append(
                f"overlap: {ov['hidden_ms']:.0f}/{ov['exchange_ms']:.0f}"
                f" ms hidden ({ov['fraction']:.2f})"
            )
        for wid in sorted(tr["workers"], key=lambda x: (len(x), x)):
            w = tr["workers"][wid]
            lines.append(
                f"  w{wid}: {w['windows']} windows · "
                f"{w['mean_window_ms']:.1f} ms/window · "
                f"stall {w['stall_ms']:.0f} ms · "
                f"lock {w['lock_wait_ms']:.0f} ms · "
                f"wal {w['wal_ms']:.0f} ms"
            )
        if tr["stragglers"]:
            lines.append(f"stragglers: {tr['stragglers']}")
        if tr["dominant_wait_worker"] is not None:
            lines.append(
                f"dominant wait source: worker "
                f"{tr['dominant_wait_worker']}")
    sv = report.get("serving")
    if sv:
        t = sv["totals_ms"]
        occ = sv["mean_rows_in_flight"]
        lines.append(
            f"serving: {sv['requests']} requests · queue "
            f"{t['queue']:.0f} / prefill {t['prefill']:.0f} / decode "
            f"{t['decode']:.0f} ms · dominant {sv['dominant']}"
            + (f" · {occ:.1f} rows in flight" if occ is not None else "")
        )
    for i, rec in enumerate(v["recommendations"], 1):
        lines.append(f"  {i}. {rec}")
    return "\n".join(lines)


# -- the watchtower bridge ----------------------------------------------------

class RegimeTracker:
    """Incremental regime classification over the live recorder: each
    call classifies only the spans recorded since the previous one and
    samples the verdict into ``analyze.regime_code`` (plus per-bucket
    fraction gauges) — the series ``watch.BottleneckShiftRule`` fires
    on. Post-hoc analysis stays the source of truth; this is the cheap
    online shadow of it (one ring scan per scrape tick).

    The cursor is an END-time watermark: spans land in the ring when
    they CLOSE, so filtering by start time would permanently drop a
    long span (a whole pipelined compute window) whose dispatch
    predates shorter spans an earlier tick already consumed."""

    def __init__(self, min_span_ms: float = 1.0):
        self._cursor = 0
        self.min_span_ms = float(min_span_ms)

    def observe(self, events: list[dict], store, now: float) -> None:
        fresh = [e for e in events
                 if e["t0_ns"] + e["dur_ns"] > self._cursor
                 and e.get("cat") != "__counter__"]
        if not fresh:
            return
        totals = bucket_totals(fresh)
        train_ms = sum(totals.get(k, 0.0) for k in (
            "compute", "compress", "wire", "decode", "fold", "wal"))
        serve_ms = sum(totals.get(k, 0.0) for k in (
            "serve_queue", "serve_prefill", "serve_decode"))
        if max(train_ms, serve_ms) < self.min_span_ms:
            # too little evidence: no sample beats a noisy one — and
            # the cursor must NOT advance past unconsumed sub-threshold
            # spans, or sparse runs would shed their evidence tick by
            # tick and never sample at all. Spans with no attributable
            # mass whatsoever ARE consumed (nothing will ever accrue).
            if train_ms == 0.0 and serve_ms == 0.0:
                self._cursor = max(e["t0_ns"] + e["dur_ns"]
                                   for e in fresh)
            return
        self._cursor = max(e["t0_ns"] + e["dur_ns"] for e in fresh)
        regime, fractions = classify(totals,
                                     serving_only=serve_ms > train_ms)
        if regime == "idle":
            return
        # kind="counter" for the CODE series: it is categorical, and
        # the ring's gauge downsampling AVERAGES merged pairs — a run
        # alternating compute-bound(0)/fsync-bound(2) would downsample
        # to 1.0 = wire-bound, a regime never observed. Counter pairs
        # keep a true later sample, so every surviving point is a
        # genuinely classified code.
        store.sample("analyze.regime_code", now, regime_code(regime),
                     kind="counter")
        for k, v in fractions.items():
            if not k.startswith("_"):
                store.sample(f"analyze.frac.{k}", now, v)


def regime_source(tracker: RegimeTracker | None = None) -> Callable:
    """A :class:`~distkeras_tpu_torch.observability.timeseries.Scraper`
    source sampling the live recorder's recent spans into the regime
    series (no-op while tracing is off). The cursor rides into the
    recorder's ``events(min_end_ns=...)`` filter, so stale ring entries
    are skipped as raw tuples — no per-tick materialization of the
    whole ring."""
    from distkeras_tpu_torch.observability import trace as _trace

    tracker = tracker or RegimeTracker()

    def sample(store, now: float) -> None:
        if not _trace.enabled():
            return
        tracker.observe(_trace.events(min_end_ns=tracker._cursor),
                        store, now)

    return sample
