#!/usr/bin/env python3
"""A/B of the hand-written kernels of two checkouts of this repository on
one card: the flash-attention kernels K2 (forward), K3 (dq) and K4 (dk/dv),
the int8 matmul K1 and the LSTM forward scan K6.

    python3 flash_ab.py [--kernels flash,k1,k6] OTHER_ROOT [OTHER_ROOT ...]

runs, for each OTHER_ROOT in turn, its kernels, this checkout's, this
checkout's again and its own again, each in a process of its own (so each
builds and loads its own libraries), and prints one JSON line per case and
side, with device times under CUDA-graph replay (``chip_smoke.cuda_ms``):

- ``flash``: K2, K3 and K4 against their plain versions (O within 2e-2
  and lse within 1e-3; dq, dk and dv within 2^-6 of the plain output's
  largest magnitude; fully masked rows exactly 0, as ``chip_smoke.py``
  holds them) at edge-tile cases, the served prefill lengths and the two
  training shapes (config 9: B'=16, L=2048, H=8, D=128, causal; config 6:
  D=64, non-causal, ragged key mask); where a side's build helpers can say
  so, also registers, spills and the ``HGMMA``/``UTMALDG`` counts of the
  wgmma kernels;
- ``k1``: ``q_matmul`` at every Dense shape of the served config
  (``chip_smoke.DENSE``), decode (M=8), the served prefill lengths and
  M=1024, against its plain version (bf16: rtol 1e-2, atol 1e-3 of max
  |plain|), weights rotated so each launch reads them cold, then the sums
  of one decode step and of one 1024-token prefill (8 layers and the head),
  and the device time of a full forward of the served decoder in int8 over
  one prompt of 128, 336 and 1024 tokens;
- ``k6``: ``lstm_forward`` at the IMDB shape (G=8, B=64, T=200, H=128,
  bf16), with and without saved cell states, hs within 2^-6 of max
  |plain|; then 8 DynSGD windows of config 5 (host clock, after two
  warm-up windows), which hold 4 launches of K6 each.

Exits non-zero if any side fails a check. Needs one card; measures nothing
on the CPU.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

CASES = [
    # (B, L, H, Hkv, D, causal, window, key mask kind of chip_smoke._key_mask)
    (2, 77, 4, 2, 64, True, None, "holes"),
    (2, 130, 8, 8, 128, False, None, "holes"),
    (2, 333, 4, 1, 128, False, 5, "half"),
    (2, 333, 8, 2, 64, True, None, "half"),
    (1, 512, 4, 4, 128, False, None, "holes"),
    (2, 100, 4, 2, 64, False, 24, "half"),
    (2, 150, 4, 1, 128, True, 40, "half"),
    (1, 80, 16, 1, 128, True, None, None),
    (1, 128, 16, 1, 128, True, None, None),
    (1, 208, 16, 1, 128, True, None, None),
    (1, 336, 16, 1, 128, True, None, None),
    (16, 2048, 8, 8, 128, True, None, None),
    (16, 2048, 8, 8, 64, False, None, "ragged"),
]


def _smoke():
    """This checkout's chip_smoke.py (timing, masks), whatever the path."""
    spec = importlib.util.spec_from_file_location(
        "flash_ab_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build_report(_build):
    if not hasattr(_build, "sass_counts"):
        return {}
    out = {}
    for lib, fn in (("flash_attention", "fa_fwd_wgmma_kernel"),
                    ("flash_attention_bwd", "fa_bwd_dq_wgmma_kernel"),
                    ("flash_attention_bwd", "fa_bwd_dkv_wgmma_kernel")):
        report = _build.ptxas_report(_build.build_log(lib))
        sass = _build.sass_counts(lib)
        for d in (64, 128):
            tag = f"{fn}ILi{d}E"
            out[f"{fn}<{d}>"] = (
                [v for k, v in report.items() if tag in k],
                [v for k, v in sass.items() if tag in k])
    return out


def measure_k1(torch, cs, side: str, root: str) -> int:
    from distkeras_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda").manual_seed(1)
    failed, step, prefill = 0, 0.0, 0.0
    for k, n in cs.DENSE:
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        qt = quant.quantize(w, axis=1)
        qs = [quant.QTensor(qt.q.clone(), qt.scale.clone()) for _ in range(
            max(1, min(48, -(-200_000_000 // qt.q.numel()))))]
        for m in (8, *cs.SERVED_LENGTHS, 1024):
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            got = quant.q_matmul(x, qt).float()
            ref = quant._q_matmul_plain(x, qt.q, qt.scale,
                                        torch.bfloat16).float()
            ok = bool(torch.allclose(got, ref, rtol=1e-2,
                                     atol=1e-3 * ref.abs().max().item()))
            nq = cs.rotating(qs)
            us = 1e3 * cs.cuda_ms(torch, lambda: quant.q_matmul(x, nq()))
            failed += not ok
            if m == 8:
                step += us * cs.PER_STEP[(k, n)]
            if m == 1024:
                prefill += us * cs.PER_STEP[(k, n)]
            print(json.dumps(dict(side=side, root=root, kernel="K1", M=m,
                                  K=k, N=n, ok=ok, max_abs_err=(
                                      got - ref).abs().max().item(),
                                  us=us)), flush=True)
        del qs
    print(json.dumps(dict(side=side, root=root, kernel="K1",
                          decode_step_us=step, prefill_1024_us=prefill,
                          int8_prefill_ms=int8_prefill_ms(torch, cs))),
          flush=True)
    return failed


def int8_prefill_ms(torch, cs) -> dict:
    """Device time of one full forward (a prefill's compute) of the served
    400M decoder quantized to int8 (``quantize_lm``, random weights from
    seed 0) over one prompt of 128, 336 and 1024 tokens: the end-to-end
    number K1's prefill kernel should move (CUDA events, eager, median of
    5 after 2 warm-ups)."""
    from distkeras_tpu_torch.models import quantize_lm, transformer_lm

    model = transformer_lm(
        vocab=cs.VOCAB, maxlen=cs.MAXLEN, dim=cs.DIM, heads=cs.HEADS,
        depth=cs.DEPTH, kv_heads=cs.KV_HEADS, pos_embedding="rope",
        attn_impl="flash", dtype=torch.bfloat16, device="cuda", seed=0)
    qmodel = quantize_lm(model)
    del model
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    with torch.inference_mode():
        for length in (128, 336, 1024):
            seq = torch.randint(0, cs.VOCAB, (1, length), generator=gen,
                                device="cuda")
            times = []
            for i in range(7):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                qmodel(seq)
                b.record()
                torch.cuda.synchronize()
                if i >= 2:
                    times.append(a.elapsed_time(b))
            out[str(length)] = sorted(times)[len(times) // 2]
    del qmodel
    torch.cuda.empty_cache()
    return out


def measure_k6(torch, cs, side: str, root: str) -> int:
    from distkeras_tpu_torch.ops import recurrent as rec

    gen = torch.Generator(device="cuda").manual_seed(6)
    G, B, T, H = cs.IMDB_W, cs.IMDB_BATCH, cs.IMDB_T, cs.IMDB_H
    gx = (torch.randn((G, B, T, 4 * H), generator=gen, device="cuda")
          * 0.5).to(torch.bfloat16)
    wh = torch.randn((G, H, 4 * H), generator=gen, device="cuda") / H ** 0.5
    hs, _ = rec.lstm_forward(gx, wh, True)
    hp, _ = rec.lstm_forward(gx, wh, True, impl="plain")
    err = (hs.float() - hp.float()).abs().max().item()
    ok = err <= 2.0 ** -6 * hp.float().abs().max().item()
    row = dict(side=side, root=root, kernel="K6", G=G, B=B, T=T, H=H, ok=ok,
               max_abs_err=err)
    for save_c in (True, False):
        row[f"us_save_c_{save_c}"] = 1e3 * cs.cuda_ms(
            torch, lambda: rec.lstm_forward(gx, wh, save_c), iters=5)
    row["dynsgd_window_ms"] = dynsgd_window_ms(torch, cs)
    print(json.dumps(row), flush=True)
    return 0 if ok else 1


def dynsgd_window_ms(torch, cs, windows: int = 8) -> list[float]:
    """Host-clock times of DynSGD windows (4 steps of fused Adam and the
    merge) on the full-width IMDB LSTM (BASELINE config 5, W=8, B=64), one
    superbatch repeated, after two warm-up windows: the end-to-end metric
    K6 (4 launches a window) should move."""
    import time

    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.pallas_kernels import fused_adam
    from distkeras_tpu_torch.parallel import DynSGDMerge, LocalSGDEngine
    from distkeras_tpu_torch.trainers import _make_loss_step

    train, _ = cs.imdb_data()
    batch = next(train.superbatches(cs.IMDB_W, cs.IMDB_BATCH, cs.IMDB_WINDOW,
                                    ["features", "mask", "label"]))
    spec = lstm_classifier(vocab=cs.IMDB_VOCAB, maxlen=cs.IMDB_T,
                           embed_dim=cs.IMDB_E, hidden_dim=cs.IMDB_H)
    engine = LocalSGDEngine(
        spec, _make_loss_step(spec, get_loss("sparse_softmax_cross_entropy"),
                              2),
        fused_adam(cs.IMDB_LR), DynSGDMerge(), device="cuda",
        num_workers=cs.IMDB_W, window=cs.IMDB_WINDOW,
        batch_size=cs.IMDB_BATCH)
    state = engine.init_state(*spec.init(0))
    out = []
    for i in range(windows + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = engine.run_window(state, batch)
        loss.item()
        torch.cuda.synchronize()
        if i >= 2:
            out.append(1e3 * (time.perf_counter() - t0))
    return out


def measure(side: str, root: str, kernels=("flash",)) -> int:
    sys.path.insert(0, root)
    import torch

    from distkeras_tpu_torch.ops import _build
    from distkeras_tpu_torch.ops import flash_attention as fa

    if not fa.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"loaded {fa.__file__}, not {root}'s kernels")
    cs = _smoke()
    failed = 0
    if "k1" in kernels:
        failed += measure_k1(torch, cs, side, root)
    if "k6" in kernels:
        failed += measure_k6(torch, cs, side, root)
    if "flash" not in kernels:
        return 1 if failed else 0
    _build.build(("flash_attention", "flash_attention_bwd"))
    print(json.dumps(dict(side=side, root=root,
                          build=_build_report(_build))), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    for B, L, H, Hkv, D, causal, window, mk in CASES:
        q = torch.randn((B, L, H, D), generator=gen, device="cuda").to(bf)
        k = torch.randn((B, L, Hkv, D), generator=gen, device="cuda").to(bf)
        v = torch.randn((B, L, Hkv, D), generator=gen, device="cuda").to(bf)
        g = torch.randn((B, L, H, D), generator=gen, device="cuda").to(bf)
        km = cs._key_mask(torch, mk, B, L, gen)
        kw = dict(scale=D ** -0.5, causal=causal, window=window)
        o, lse = fa._fa_forward(q, k, v, km, **kw)
        ro, rlse = fa._fa_forward_plain(q, k, v, km, **kw)
        delta = fa._delta(o, g)
        args = (q, k, v, km, lse, delta, g)
        dq = fa._fa_bwd_dq(*args, **kw)
        dk, dv = fa._fa_bwd_dkv(*args, **kw)
        rq, rk, rv = fa._fa_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        row = dict(side=side, root=root, B=B, L=L, H=H, Hkv=Hkv, D=D,
                   causal=causal,
                   window=window, key_mask=mk, o_err=cs._err(o, ro),
                   lse_err=cs._err(lse, rlse), dq_err=cs._err(dq, rq),
                   dk_err=cs._err(dk, rk), dv_err=cs._err(dv, rv))
        ok = (row["o_err"] <= 2e-2 and row["lse_err"] <= 1e-3
              and bool(torch.isfinite(o.float()).all())
              and row["dq_err"] <= 2.0 ** -6 * rq.float().abs().max().item()
              and row["dk_err"] <= 2.0 ** -6 * rk.float().abs().max().item()
              and row["dv_err"] <= 2.0 ** -6 * rv.float().abs().max().item())
        if mk == "half":
            ok = ok and all(t[1].abs().max().item() == 0.0
                            for t in (o, dq, dk, dv))
        del ro, rlse, rq, rk, rv
        iters = 10 if L >= 2048 else 20
        row.update(ok=ok, k2_ms=cs.cuda_ms(
            torch, lambda: fa._fa_forward(q, k, v, km, **kw), iters=iters),
            k3_ms=cs.cuda_ms(torch, lambda: fa._fa_bwd_dq(*args, **kw),
                             iters=iters),
            k4_ms=cs.cuda_ms(torch, lambda: fa._fa_bwd_dkv(*args, **kw),
                             iters=iters))
        failed += not ok
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 1 if failed else 0


def main(argv) -> int:
    kernels = ["flash", "k1", "k6"]
    if len(argv) > 2 and argv[1] == "--kernels":
        kernels = argv[2].split(",")
        argv = argv[:1] + argv[3:]
    if len(argv) == 3 and argv[1] in ("this", "other"):
        return measure(argv[1], argv[2], kernels)
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    rc = 0
    sides = []
    for other in map(os.path.abspath, argv[1:]):
        sides += [("other", other), ("this", HERE), ("this", HERE),
                  ("other", other)]
    for side, root in sides:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--kernels", ",".join(kernels), side, root],
                           capture_output=True, text=True, timeout=600)
        print(r.stdout, end="", flush=True)
        if r.returncode:
            print(f"{side} ({root}) failed, rc {r.returncode}:\n"
                  f"{r.stderr[-4000:]}", flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
