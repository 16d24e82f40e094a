"""CLI: scrape live metrics / emit the one-document health snapshot.

Usage::

    python -m distkeras_tpu_torch.observability dump --host H --port P [--prom]
    python -m distkeras_tpu_torch.observability tail --host H --port P \\
        [--interval 2] [--count 0]
    python -m distkeras_tpu_torch.observability health [--wal-dir DIR] \\
        [--host H --port P] [--watch [--interval 2] [--count 0]]
    python -m distkeras_tpu_torch.observability analyze <trace.json[.gz]> \\
        [--series <dump.json[.gz]>] [--json]

``dump``/``tail`` speak the ``metrics`` wire action both the
``SocketParameterServer`` and the ``GenerationServer`` serve (the framed
restricted-pickle protocol — ``networking.py``), printing the JSON
snapshot by default or the Prometheus text exposition with ``--prom``.
``health`` folds WAL health (``resilience.wal.verify_tree``), metrics,
membership, the trace-overflow counter, and the live shm segment
inventory into ONE JSON document (exit code 1 when unhealthy) — the
artifact CI uploads instead of three separate ad-hoc dumps.

``analyze`` runs the post-hoc critical-path analyzer
(observability/analyze.py) over a saved flight-recorder trace — plain
or gzipped — optionally joined with a watchtower time-series dump:
per-worker waterfalls, overlap efficiency, lock/fsync/straggler
attribution, and the typed regime verdict with knob-keyed
recommendations. ``--json`` prints the full report document (the CI
artifact); the default is the human-readable summary. Exit code 2 when
the verdict is degraded (the trace dropped spans), 0 otherwise.

``health --watch`` polls a live server's ``metrics`` action
on ``--interval`` and prints alert TRANSITIONS as JSON lines: the
scraped counters feed the same time-series store and watchdog rules the
in-process watchtower runs (observability/watch.py), and any alert
ledger the server itself carries (a trainer-attached watchtower) is
relayed with ``"remote": true``. ``--count N`` stops after N polls
(0 = forever); the exit code is 1 when any alert is still firing.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _scrape(host: str, port: int, timeout: float = 10.0) -> dict:
    from distkeras_tpu_torch import networking

    sock = networking.connect(host, port, timeout=timeout)
    sock.settimeout(timeout)
    try:
        networking.send_data(sock, {"action": "metrics"})
        reply = networking.recv_data(sock)
    finally:
        try:
            networking.send_data(sock, {"action": "bye"})
        except OSError:
            pass
        sock.close()
    if not isinstance(reply, dict) or not reply.get("ok"):
        raise ConnectionError(f"metrics scrape refused: {reply!r}")
    return reply


def _cmd_dump(args) -> int:
    reply = _scrape(args.host, args.port)
    if args.prom:
        sys.stdout.write(reply.get("prom", ""))
    else:
        print(json.dumps(reply.get("metrics", {}), indent=2,
                         sort_keys=True))
    return 0


def _cmd_tail(args) -> int:
    n = 0
    while True:
        reply = _scrape(args.host, args.port)
        if args.prom:
            sys.stdout.write(reply.get("prom", ""))
        else:
            print(json.dumps({"t_unix_s": time.time(),
                              "metrics": reply.get("metrics", {})}))
        sys.stdout.flush()
        n += 1
        if args.count and n >= args.count:
            return 0
        time.sleep(max(0.05, args.interval))


def _cmd_health(args) -> int:
    from distkeras_tpu_torch.observability.metrics import health_snapshot

    if args.watch:
        if args.host is None or args.port is None:
            raise SystemExit("health --watch needs --host/--port")
        from distkeras_tpu_torch.observability.watch import watch_endpoint

        def emit(alert: dict) -> None:
            print(json.dumps({"t_unix_s": time.time(), **alert}))
            sys.stdout.flush()

        dog = watch_endpoint(
            lambda: _scrape(args.host, args.port),
            interval=args.interval, count=args.count, emit=emit,
        )
        # a firing alert counts wherever it lives: locally derived from
        # the scraped counters, OR in the server-side ledger (rules the
        # remote scrape cannot reconstruct — τ ring, shm occupancy)
        return 1 if dog.active or dog.remote_active else 0

    stats = None
    if args.host is not None:
        from distkeras_tpu_torch import networking

        sock = networking.connect(args.host, args.port, timeout=10.0)
        sock.settimeout(10.0)
        try:
            networking.send_data(sock, {"action": "stats"})
            reply = networking.recv_data(sock)
        finally:
            try:
                networking.send_data(sock, {"action": "bye"})
            except OSError:
                pass
            sock.close()
        if not isinstance(reply, dict) or "stats" not in reply:
            raise ConnectionError(f"stats scrape refused: {reply!r}")
        stats = reply["stats"]
    # a serving server's stats dict carries "submitted"; a PS's carries
    # "pulls" — route to the matching normalizer
    serving = stats is not None and "submitted" in stats \
        and "pulls" not in stats
    report = health_snapshot(
        wal_root=args.wal_dir,
        ps_stats=None if serving else stats,
        serving_stats=stats if serving else None,
    )
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0 if report["ok"] else 1


def _cmd_analyze(args) -> int:
    from distkeras_tpu_torch.observability.analyze import (
        analyze_trace,
        format_report,
    )
    from distkeras_tpu_torch.observability.metrics import _json_clean

    try:
        report = analyze_trace(args.trace, series_path=args.series)
    except (OSError, ValueError, KeyError) as e:
        raise SystemExit(
            f"analyze: cannot read {args.trace!r}: "
            f"{type(e).__name__}: {e}"
        ) from e
    if args.json:
        print(json.dumps(_json_clean(report), indent=2, sort_keys=True))
    else:
        print(format_report(report))
    return 2 if report["degraded"] else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m distkeras_tpu_torch.observability",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def _net(p, required=True):
        p.add_argument("--host", default="127.0.0.1" if required else None)
        p.add_argument("--port", type=int, required=required)

    p = sub.add_parser("dump", help="scrape a live server's metrics once")
    _net(p)
    p.add_argument("--prom", action="store_true",
                   help="Prometheus text exposition instead of JSON")
    p.set_defaults(fn=_cmd_dump)

    p = sub.add_parser("tail", help="scrape on an interval")
    _net(p)
    p.add_argument("--prom", action="store_true")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--count", type=int, default=0,
                   help="stop after N scrapes (0 = forever)")
    p.set_defaults(fn=_cmd_tail)

    p = sub.add_parser(
        "health",
        help="one JSON health document: WAL + metrics + membership "
             "(+ --watch: live alert-transition tail)",
    )
    p.add_argument("--wal-dir", default=None,
                   help="WAL directory or sharded root to verify")
    _net(p, required=False)
    p.add_argument("--watch", action="store_true",
                   help="poll the server's metrics action and print "
                        "alert transitions (same watchdog rules as the "
                        "in-process watchtower)")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--count", type=int, default=0,
                   help="stop after N polls (0 = forever)")
    p.set_defaults(fn=_cmd_health)

    p = sub.add_parser(
        "analyze",
        help="post-hoc critical-path attribution + bottleneck verdict "
             "over a saved flight-recorder trace (.json or .json.gz)",
    )
    p.add_argument("trace", help="Chrome trace file from trace.save()")
    p.add_argument("--series", default=None,
                   help="watchtower/timeseries dump to join (counters, "
                        "alert history; .json or .json.gz)")
    p.add_argument("--json", action="store_true",
                   help="full report document instead of the summary")
    p.set_defaults(fn=_cmd_analyze)

    args = ap.parse_args(argv)
    if args.cmd == "health" and args.wal_dir is None \
            and args.host is None:
        ap.error("health needs --wal-dir and/or --host/--port")
    if args.cmd == "health" and args.host is not None \
            and args.port is None:
        ap.error("--host needs --port")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
