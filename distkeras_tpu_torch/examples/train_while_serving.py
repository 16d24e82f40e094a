"""Train while serving on the port: live weight streaming from the
parameter server into the serving tier, with canary rollout and SLO-gated
rollback (``distkeras_tpu_torch/deploy/``). The twin of
``examples/train_while_serving.py``; the replicas serve on the card unless
``--device cpu`` asks for the CPU.

Async ADAG workers fold into a ``ParameterServer`` while a
``WeightStreamer`` rides its chain-replication record stream and cuts
versioned snapshots at fold-count boundaries, bit-identical to the
training center. Two ``GenerationServer`` replicas register in a
membership directory; a ``RolloutController`` canaries each fresh
snapshot onto half the fleet, promotes when the watchdog stays green, and
rolls the canary back when this script injects a latency fault into the
serving-SLO series. Every served stream is checked bit-identical to a
``generate()`` oracle at the version the replica admitted it under.

Run:  python -m distkeras_tpu_torch.examples.train_while_serving --quick
      python -m distkeras_tpu_torch.examples.train_while_serving --rounds 3
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np
import torch

from distkeras_tpu_torch.utils import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--maxlen", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=2,
                    help="train→canary→promote rounds before the "
                         "injected-rollback finale")
    ap.add_argument("--folds-per-round", type=int, default=8)
    ap.add_argument("--snapshot-every", type=int, default=4,
                    help="streamer fold-count cut interval")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.quick:
        args.rounds = 1
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    from distkeras_tpu_torch.deploy import (
        RolloutController,
        RolloutPolicy,
        WeightStreamer,
        watchtower_health,
    )
    from distkeras_tpu_torch.directory import DirectoryServer
    from distkeras_tpu_torch.directory.router import RoutedGenerationClient
    from distkeras_tpu_torch.models import (
        generate,
        transformer_lm,
        transformer_lm_spec,
    )
    from distkeras_tpu_torch.observability.timeseries import TimeSeriesStore
    from distkeras_tpu_torch.observability.watch import (
        ServingSLORule,
        SLOClass,
        Watchdog,
    )
    from distkeras_tpu_torch.parallel.merge_rules import ADAGMerge
    from distkeras_tpu_torch.parameter_servers import ParameterServer
    from distkeras_tpu_torch.serving import (
        GenerationClient,
        GenerationEngine,
        GenerationServer,
    )

    device = resolve_device(args.device)
    print(f"device: {device}")
    cfg = dict(vocab=args.vocab, maxlen=args.maxlen, dim=args.dim,
               heads=args.heads, depth=args.depth, dtype=torch.float32)

    def module(tree):
        """A served module on the device carrying the weights ``tree``
        (the engine and ``generate`` take a module, not a param tree)."""
        m = transformer_lm(**cfg, device=device)
        with torch.no_grad():
            m.load_state_dict({k: torch.as_tensor(v)
                               for k, v in tree.items()})
        return m.eval()

    oracles: dict = {}

    def oracle(version, prompt, n):
        """The greedy ``generate()`` stream of ``prompt`` at the
        streamed snapshot ``version``."""
        if version not in oracles:
            oracles[version] = module(streamer.store.get(version).tree)
        return generate(oracles[version], prompt[None], n)[0, len(prompt):]

    # -- training side: a PS with the streamer attached as read replica --
    p0, _ = transformer_lm_spec(**cfg).init_np(0)
    ps = ParameterServer(p0, ADAGMerge(), 2)
    streamer = WeightStreamer(ADAGMerge(), 2,
                              snapshot_every=args.snapshot_every)
    streamer.attach_to(ps)

    def train(folds):
        """Two async workers committing deltas — live ADAG folding."""
        def worker(wid, n):
            rng = np.random.default_rng(wid)
            for _ in range(n):
                center = ps.pull(wid)
                delta = {k: (rng.standard_normal(a.shape) * 1e-3
                             ).astype(a.dtype) for k, a in center.items()}
                ps.commit(wid, delta)
        ts = [threading.Thread(target=worker, args=(w, folds // 2))
              for w in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    def drain(version, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if streamer.stats()["latest_version"] >= version:
                return
            time.sleep(0.05)
        raise RuntimeError(f"streamer lagging: {streamer.stats()}")

    dsrv = DirectoryServer(default_ttl=3.0)
    dsrv.initialize()
    dsrv.start()
    seeds = [(dsrv.host, dsrv.port)]
    servers: dict = {}
    router = None
    try:
        train(args.folds_per_round)
        drain(args.folds_per_round)
        v0 = streamer.store.versions()[0]
        print(f"[stream] training live; first snapshot v{v0} "
              f"(cuts every {args.snapshot_every} folds)")

        # -- serving side: two directory-registered streaming replicas ---
        for i in range(2):
            eng = GenerationEngine(module(streamer.store.get(v0).tree),
                                   max_batch=4, block_size=8,
                                   model_version=v0, device=device)
            srv = GenerationServer(eng, poll_interval=0.02)
            srv.snapshots = streamer.store    # the deploy_activate source
            srv.start()
            servers[f"rep-{i}"] = srv
            srv.register_with(seeds, key=f"rep-{i}", ttl=5.0)
        router = RoutedGenerationClient(directory=seeds,
                                        refresh_interval=0.2)
        print(f"[serve] 2 replicas at v{v0}, registered in the directory")

        # -- the deployer: watchdog health in, version activations out ---
        tstore = TimeSeriesStore()
        wd = Watchdog(tstore, rules=[
            ServingSLORule(slo={"default": SLOClass(p99_ms=500.0)}),
        ])
        clock = [0.0]

        def observe(p99_ms):
            clock[0] += 1.0
            tstore.sample("serve.lat.default.p99_ms", clock[0], p99_ms)
            wd.evaluate(now=clock[0])
            return clock[0]

        def activate(key, version):
            c = GenerationClient(servers[key].host, servers[key].port)
            try:
                return bool(c.deploy_activate(version,
                                              policy="refill")["ok"])
            finally:
                c.close()

        ctrl = RolloutController(
            router, activate, lambda: watchtower_health(wd),
            policy=RolloutPolicy(canary_fraction=0.5, bake_s=0.0,
                                 green_checks=1, red_checks=1,
                                 cooldown_s=0.0),
        )

        def check_streams():
            """Every replica, at whatever version it admits under, must
            serve the generate() oracle of that version's snapshot."""
            rng = np.random.default_rng(5)
            for key, srv in servers.items():
                c = GenerationClient(srv.host, srv.port)
                try:
                    # a staged swap applies between decode steps — wait
                    # for it to land so the admitted version is the one
                    # we read
                    deadline = time.monotonic() + 30
                    while True:
                        status = c.deploy_status()
                        if status["staged_version"] is None:
                            v = status["model_version"]
                            break
                        if time.monotonic() > deadline:
                            raise RuntimeError(f"{key} swap never landed")
                        time.sleep(0.05)
                    p = rng.integers(0, args.vocab, (8,)).astype(np.int32)
                    got = c.generate(p, max_new_tokens=8)
                finally:
                    c.close()
                if not np.array_equal(got, oracle(v, p, 8)):
                    raise SystemExit(f"{key} tore a stream at v{v}")

        # -- rounds: train on, canary the fresh snapshot, promote on green
        folds = args.folds_per_round
        for r in range(args.rounds):
            train(args.folds_per_round)
            folds += args.folds_per_round
            drain(folds)
            cand = streamer.store.versions()[-1]
            ctrl.begin(cand)
            observe(50.0)                       # healthy latency: green
            ctrl.step(clock[0])
            check_streams()                     # mixed-version fleet: exact
            observe(60.0)
            ctrl.step(clock[0])
            check_streams()
            print(f"[rollout] round {r}: v{cand} canaried on "
                  f"{len(ctrl.canary_keys)} replica(s), promoted "
                  f"fleet-wide (deploy lag "
                  f"{ps.stats()['deploy_lag_folds']} folds)")

        # -- finale: the next candidate meets an injected latency fault --
        good = ctrl.policy.version
        train(args.folds_per_round)
        folds += args.folds_per_round
        drain(folds)
        bad = streamer.store.versions()[-1]
        ctrl.begin(bad)
        observe(70.0)
        ctrl.step(clock[0])
        observe(5000.0)                         # p99 blows through the SLO
        acts = ctrl.step(clock[0])
        if [a["action"] for a in acts] != ["rollback"]:
            raise SystemExit(f"the faulted canary was not rolled back: "
                             f"{acts}")
        check_streams()
        print(f"[rollout] v{bad} canary hit the serving SLO "
              f"(p99 5000 ms > 500 ms bound) -> rolled back to v{good}")

        print("[journal] " + " -> ".join(
            f"{j['action']}(v{j.get('version')})" for j in ctrl.journal))

        # routed traffic over the settled fleet: the renewer re-advertises
        # each replica's model_version within TTL/3, then the router's
        # per-version split shows every request landing on the good version
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            router.refresh(force=True)
            if set(router.replica_versions().values()) == {good}:
                break
            time.sleep(0.2)
        rng = np.random.default_rng(23)
        for _ in range(4):
            p = rng.integers(0, args.vocab, (7,)).astype(np.int32)
            got = router.generate(p, max_new_tokens=6)
            if not np.array_equal(got, oracle(good, p, 6)):
                raise SystemExit(f"the router tore a stream at v{good}")
        rs = router.stats()
        print(f"[router] routed_by_version={rs['routed_by_version']} "
              f"replica_versions={rs['replica_versions']}")
        swaps = sum(s.engine.stats()["swaps"] for s in servers.values())
    finally:
        if router is not None:
            router.close()
        for srv in servers.values():
            srv.stop(drain=False)
        streamer.close()
        dsrv.stop()
    print("every served stream bit-identical to generate() at its "
          f"admitted version; no torn batches across {swaps} hot swaps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
