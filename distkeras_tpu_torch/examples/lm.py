"""Causal language modeling end to end on the port: the twin of
``examples/lm.py``. Train a decoder-only LM with a reference-API trainer,
then decode with the KV-cached decoder, on the card unless ``--device
cpu`` asks for the CPU.

The modern-decoder knobs are one flag each, as in the JAX example:

  --pos rope          rotary position embeddings (default sincos)
  --kv-heads 2        grouped-query attention (1 = multi-query)
  --window 64         sliding-window attention (a ring cache at decode)
  --attn flash        the flash-attention kernels ("auto", the default,
                      takes them on the card and their plain versions on
                      the CPU; "reference" is plain attention)
  --fused-ce          chunked fused linear+cross-entropy training loss

On the card the model computes in bf16 and attention runs through the
flash kernels (forward, dq, dk/dv); the int8 decode runs the int8 matmul
kernel. On the CPU everything is f32 over the kernels' plain versions.

After training, the script decodes greedily AND with beam search, then
re-serves the model in int8 (``quantize_lm``). The task is a deterministic
cyclic language (next token = (token+1) mod V), so the script checks its
own generations: each decode must continue the cycle to 0.9 accuracy.

Run:  python -m distkeras_tpu_torch.examples.lm --quick
      python -m distkeras_tpu_torch.examples.lm --pos rope --kv-heads 2 \\
          --window 64
      python -m distkeras_tpu_torch.examples.lm --device cpu --quick
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from distkeras_tpu_torch import trainers
from distkeras_tpu_torch.models import (
    beam_search,
    generate,
    next_token_dataset,
    quantize_lm,
    transformer_lm,
    transformer_lm_spec,
)
from distkeras_tpu_torch.utils import resolve_device

#: prompt tokens and new tokens of each decode
N_PROMPT, N_NEW = 8, 24
#: continuation accuracy each decode must reach
ACC_BAR = 0.9


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--trainer", default="ADAG",
                    choices=["ADAG", "DOWNPOUR", "AEASGD", "EAMSGD",
                             "DynSGD", "SingleTrainer"])
    ap.add_argument("--workers", type=int, default=2,
                    help="replicas (each consumes batch·window rows per "
                         "update — more workers need more --rows)")
    ap.add_argument("--attn", default="auto",
                    choices=["reference", "flash", "auto"])
    ap.add_argument("--pos", default="sincos", choices=["sincos", "rope"])
    ap.add_argument("--kv-heads", type=int, default=None)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--fused-ce", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="CI-sized run (fewer rows, shorter sequences)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.quick:
        args.rows, args.seq_len, args.epochs = 2048, 32, 8
    return args


def cyclic_rows(n: int, seq_len: int, vocab: int, seed: int = 0):
    """Row r is (start_r, start_r+1, ...) mod vocab, seq_len + 1 long."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, vocab, size=(n, 1))
    return (starts + np.arange(seq_len + 1)) % vocab


def model_config(args) -> dict:
    """The LM's options, shared by the training spec and the served
    module: bf16 on the card, f32 on the CPU."""
    on_card = resolve_device(args.device).type == "cuda"
    return dict(vocab=args.vocab, maxlen=2 * args.seq_len, dim=args.dim,
                heads=args.heads, depth=args.depth,
                dtype=torch.bfloat16 if on_card else torch.float32,
                attn_impl=args.attn, pos_embedding=args.pos,
                kv_heads=args.kv_heads, attn_window=args.window)


def served_model(args, center: dict):
    """The served module on ``args.device`` carrying the trained
    center."""
    model = transformer_lm(**model_config(args), device=args.device)
    with torch.no_grad():
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in center.items()})
    return model.eval()


def decode_checks(model, rows) -> dict:
    """Greedy, beam-4 and int8 greedy decodes of the first 4 rows' prompts,
    each scored against the true cycle on the generated tokens: ``{name:
    (accuracy, tokens)}``, in that order; stops at the first decode below
    ACC_BAR."""
    vocab = model.vocab
    prompts = rows[:4, :N_PROMPT].astype(np.int32)
    expect = (rows[:4, :1] + np.arange(N_PROMPT + N_NEW)) % vocab
    out = {}

    def score(toks):
        return float((toks[:, N_PROMPT:] == expect[:, N_PROMPT:]).mean())

    toks = generate(model, prompts, max_new_tokens=N_NEW)
    out["generate"] = (score(toks), toks)
    print(f"[generate] continuation accuracy: {out['generate'][0]:.3f}")
    for r in range(2):
        print(f"  prompt {toks[r, :N_PROMPT].tolist()} -> "
              f"{toks[r, N_PROMPT:N_PROMPT + 12].tolist()} ...")
    if out["generate"][0] < ACC_BAR:
        print("FAILED: generations diverge from the cyclic language")
        return out

    # beam search over the same caches: the best beam of a trained model
    # recovers the greedy continuation on a deterministic language
    btoks, bscores = beam_search(model, prompts, max_new_tokens=N_NEW,
                                 beams=4)
    out["beam"] = (score(btoks[:, 0]), btoks[:, 0])
    print(f"[beam-4] best-beam accuracy: {out['beam'][0]:.3f}  "
          f"(score {float(bscores[0, 0]):.2f})")
    if out["beam"][0] < ACC_BAR:
        print("FAILED: beam search diverges from the cyclic language")
        return out

    # int8 weight-only serving: quantize the trained model and decode again
    qtoks = generate(quantize_lm(model), prompts, max_new_tokens=N_NEW)
    out["int8"] = (score(qtoks), qtoks)
    print(f"[generate:int8] continuation accuracy: {out['int8'][0]:.3f}")
    if out["int8"][0] < ACC_BAR:
        print("FAILED: int8 generations diverge from the cyclic language")
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device}")

    rows = cyclic_rows(args.rows, args.seq_len, args.vocab)
    ds = next_token_dataset(rows.astype(np.int32))
    cfg = model_config(args)
    spec = transformer_lm_spec(**cfg, fused_ce=args.fused_ce)
    cls = getattr(trainers, args.trainer)
    kwargs = dict(
        loss="sparse_softmax_cross_entropy", worker_optimizer="adam",
        learning_rate=3e-3, batch_size=args.batch_size,
        num_epoch=args.epochs, label_col="label", device=args.device,
    )
    if args.trainer != "SingleTrainer":  # the oracle takes no distrib kwargs
        kwargs.update(num_workers=args.workers, communication_window=2,
                      log_metrics=True)
    trainer = cls(spec, **kwargs)
    center = trainer.train(ds, shuffle=True)
    losses = trainer.get_history().losses()
    print(f"[train] loss {float(losses[0]):.3f} -> {float(losses[-1]):.4f} "
          f"in {trainer.get_training_time():.1f}s")

    out = decode_checks(served_model(args, center), rows)
    if len(out) < 3 or out["int8"][0] < ACC_BAR:
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
