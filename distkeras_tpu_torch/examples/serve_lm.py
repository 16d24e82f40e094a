"""Serve a causal LM on the port: continuous-batching generation server
with a block-paged KV cache (``distkeras_tpu_torch/serving/``). The twin
of ``examples/serve_lm.py``, on the card unless ``--device cpu`` asks for
the CPU.

A ``GenerationEngine`` (iteration-level continuous batching over a shared
block-paged KV cache) behind a ``GenerationServer`` serves CONCURRENT
``GenerationClient``s, each request with its own sampling params; rows
retire the step they finish.

The model is the deterministic cyclic language of the LM example (next
token = (token+1) mod V) trained with ``SingleTrainer`` in f32, so the
script checks every served generation exactly: a greedy served stream is
bit-identical to single-request ``generate()``, and a request with
``eos_id`` stops at the oracle's first eos.

Run:  python -m distkeras_tpu_torch.examples.serve_lm --quick
      python -m distkeras_tpu_torch.examples.serve_lm --clients 16 --spec
      python -m distkeras_tpu_torch.examples.serve_lm --device cpu --quick
"""

from __future__ import annotations

import argparse
import sys
import threading

import numpy as np
import torch

from distkeras_tpu_torch.utils import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--maxlen", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--clients", type=int, default=8,
                    help="concurrent client threads")
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-batch", type=int, default=8,
                    help="engine batch slots (continuous-batch width)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV-cache block size (pool slots per block)")
    ap.add_argument("--spec", action="store_true",
                    help="speculative serving with the model as its own "
                         "draft (acceptance 1.0 — the upper bound; a real "
                         "deployment uses a small trained draft)")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.quick:
        args.clients, args.epochs = 4, 2
    return args


def train_cyclic_lm(args):
    """The cyclic language of the LM example, trained with SingleTrainer
    in f32: the served module on ``args.device`` carrying the center."""
    from distkeras_tpu_torch.models import (
        next_token_dataset,
        transformer_lm,
        transformer_lm_spec,
    )
    from distkeras_tpu_torch.trainers import SingleTrainer

    rng = np.random.default_rng(0)
    starts = rng.integers(0, args.vocab, (2048, 1))
    seqs = (starts + np.arange(args.maxlen + 1)) % args.vocab
    ds = next_token_dataset(seqs.astype(np.int32))
    cfg = dict(vocab=args.vocab, maxlen=args.maxlen, dim=args.dim,
               heads=args.heads, depth=args.depth, dtype=torch.float32)
    trainer = SingleTrainer(transformer_lm_spec(**cfg),
                            loss="sparse_softmax_cross_entropy",
                            worker_optimizer="adam", learning_rate=3e-3,
                            batch_size=64, num_epoch=args.epochs,
                            label_col="label", device=args.device)
    center = trainer.train(ds, shuffle=True)
    losses = trainer.get_history().losses()
    print(f"[train] loss {float(losses[0]):.3f} -> {float(losses[-1]):.4f}")
    model = transformer_lm(**cfg, device=args.device)
    with torch.no_grad():
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in center.items()})
    return model.eval()


def main(argv=None) -> int:
    args = parse_args(argv)
    from distkeras_tpu_torch.models import generate
    from distkeras_tpu_torch.serving import (
        GenerationClient,
        GenerationEngine,
        GenerationServer,
    )

    print(f"device: {resolve_device(args.device)}")
    model = train_cyclic_lm(args)

    # -- serve it ---------------------------------------------------------
    engine = GenerationEngine(
        model, max_batch=args.max_batch, block_size=args.block_size,
        draft=model if args.spec else None, device=args.device)
    server = GenerationServer(engine)
    failures = []
    lock = threading.Lock()

    def client(i):
        prompt = ((i + np.arange(8)) % args.vocab).astype(np.int32)
        want = (i + 8 + np.arange(args.max_new)) % args.vocab
        c = None
        try:
            c = GenerationClient("127.0.0.1", server.port)
            # the hard invariant: a greedy SERVED stream is bit-identical
            # to the single-request generate() oracle, whatever the model
            # learned (cyclic-task accuracy is reported, not asserted)
            got = c.generate(prompt, max_new_tokens=args.max_new)
            oracle = generate(model, prompt[None],
                              args.max_new)[0, len(prompt):]
            ok = np.array_equal(got, oracle)
            acc = float((got == want).mean())
            # eos early stop: pick the token the oracle emits 5th; the
            # served stream must stop at its FIRST occurrence
            eos = int(oracle[4])
            k = int(np.argmax(oracle == eos))
            stopped = c.generate(prompt, max_new_tokens=args.max_new,
                                 eos_id=eos)
            ok &= np.array_equal(stopped, oracle[:k + 1])
            with lock:
                if not ok:
                    failures.append(i)
                print(f"  client {i}: {'OK' if ok else 'MISMATCH'} "
                      f"(cyclic acc {acc:.2f}, eos stop after "
                      f"{len(stopped)}/{args.max_new})")
        except Exception:
            with lock:
                failures.append(i)
            raise
        finally:
            if c is not None:
                c.close()

    try:
        server.start()
        print(f"serving on 127.0.0.1:{server.port} "
              f"(max_batch={args.max_batch}, block_size={args.block_size}"
              + (", speculative" if args.spec else "") + ")")
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = server.stats()
    finally:
        server.stop()
    print(f"served {stats['completed']} requests, "
          f"mean batch occupancy {stats['mean_batch_occupancy']}, "
          f"block high-water {stats['blocks_high_water']}"
          + (f", spec acceptance {stats.get('spec_acceptance')}"
             if args.spec else ""))
    if failures:
        print(f"FAILED clients: {sorted(failures)}")
        return 1
    print("all served streams bit-identical to generate() "
          "(incl. eos early stop)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
