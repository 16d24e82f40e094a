#!/usr/bin/env python3
"""Chip smoke for the PyTorch + CUDA port (``distkeras_tpu_torch``).

Run on a machine with one NVIDIA H100 (Hopper, sm_90a), the CUDA toolkit and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. the card's name and power limit (``nvidia-smi``);
2. build all five kernel sources from ``distkeras_tpu_torch/csrc`` (one
   ``nvcc`` per source, started together) and, beside them, the native
   parameter server's C++ core (``native/dkps.cpp``, ``g++``), then show
   that the kernels
   redesigned on wgmma (K2's, K3's and K4's bf16 paths, K7's dwh product
   and every instantiation of K1's prefill kernel) issue ``HGMMA`` and
   ``UTMALDG`` (TMA) instructions and spill nothing, and that K6's cluster
   scan, K7's two scans and K1's split decode kernel spill nothing
   (``check_sass``);
3. K1 ``q_matmul`` against its plain version at every Dense shape of the
   served 400M config: decode (M=8, twice for equal bits: the K split sums
   in rank order), the served prefill lengths (``SERVED_LENGTHS``) and
   M=1024, with kernel, plain and library (``torch.matmul`` over a
   pre-dequantized bf16 weight) times and the card's bound, each row with
   the launch plan (``quant.plan_q_matmul``); then ragged edges for every
   kernel path;
4. K2 flash-attention forward against its plain version at prefill shapes
   (B=4 and the served B=1 lengths; H=16, Hkv=1, D=128, bf16, causal) and
   at small cases for its edge tiles (ragged L, windows, masked keys
   inside whole tiles, GQA 2 and MQA, fully masked rows, f32), with
   kernel, plain and library (``scaled_dot_product_attention``) times and
   the bound;
5. K5 fused Adam against its plain version over the 8-worker stack of the
   IMDB LSTM's leaves (21.5 M f32 elements), bf16 gradients and misaligned
   leaves, with kernel, plain and library (``torch.optim.Adam(fused=True)``
   over the same tensors) times and the bound;
6. K6 and K7, the LSTM scan forward and backward, against their plain
   versions at the training shapes (G=8 workers, B=64, T=200, H=128, bf16;
   and G=1, the parameter-server path's launch, each worker alone)
   and small ragged f32 / bf16 cases at the edges of K6's cluster scan
   and K7's prefetch (see ``check_lstm``), K6 also without saved cell
   states (the eval path's launch), K7 twice for equal bits, with kernel,
   plain and library (cuDNN's ``nn.LSTM`` at the same T, G·B and H,
   forward and backward; its forget-bias convention differs, so it is
   timed, not compared) times and the bounds, K6's launch (cluster size,
   rows, blocks) and K7's two launches (the reverse scan, the dwh
   product) timed apart;
7. K2, K3 and K4, the flash-attention forward and backward (dq, dk/dv),
   against their plain versions at the LM's and the classifier's training
   shapes and at small GQA / window / ragged / masked-key / f32 /
   fully-masked cases (see ``check_flash_bwd``), with kernel, plain and
   library (SDPA's forward and backward) times and the bounds; then the
   flash Function under ``torch.func.vmap(grad)`` at W=2, through the
   kernels and the plain versions (one launch of K2, K3 and K4 for the
   step); then the fused cross-entropy in bf16 under ``vmap(grad)`` at the
   LM's head width: f32 logits and no per-worker loop
   (``check_fused_ce``);
8. one DynSGD window at full width through the kernels and the same window
   through their plain versions on the card: the centers must agree within
   the stated bf16 tolerance (see ``compare_window``);
9. serve the 400M MQA decoder (vocab 16384, dim 2048, 16 heads, 1 KV head,
   depth 8, RoPE, flash prefill, bf16; random weights from seed 0) through
   ``GenerationServer`` to 4 concurrent ``GenerationClient``s (prompts of
   128/77/208/333 tokens, 32 greedy new tokens each), then quantize it
   (``quantize_lm``) and serve again; K1 and K2's launch counters, reset
   just before, must show both launched, K1 at decode and at prefill;
   every served stream is held to a full forward, tie-aware (see
   ``tie_aware_check``);
10. train: ``DynSGD(lstm_classifier(), worker_optimizer="fused_adam",
    features_col=["features", "mask"], num_workers=8, batch_size=64,
    communication_window=4)`` — BASELINE config 5 at its published width
    (vocab 20000, maxlen 200, embed 128, hidden 128, bf16 compute, f32
    params, lr 1e-3), random init from seed 0 — for two epochs of 6 windows
    on the synthetic IMDB stand-in; K5, K6 and K7's launch counters, reset
    just before, must show all three launched; the loss must fall, and the
    trained center's eval logits must match the plain-torch reference scan;
    then LeNet under ADAG (BASELINE config 2) on synthetic MNIST, 8
    workers, to test accuracy > 0.95;
11. one ADAG window of the config-9 LM at full width and depth 2 through
    K2–K5 and through their plain versions: centers within the stated bf16
    bound (see ``compare_lm_window``);
12. train config 9 (``bench.py:518-586``): ``transformer_lm_spec(vocab
    16384, maxlen 2048, dim 1024, heads 8, depth 8, RoPE, bf16 compute,
    f32 params, attn_impl="flash", fused_ce=True, ce_chunk=512)`` under
    ``ADAG(worker_optimizer="fused_adam", learning_rate=1e-4,
    num_workers=2, batch_size=8, communication_window=2)`` for two epochs
    of 3 windows on a learnable synthetic stream (``lm_tokens``), random
    init from seed 0; K2, K3, K4 and K5's launch counters, reset just
    before, must all show launches, no ``vmap`` may fall back to a loop
    over workers, and the last window's loss must be below the first's;
    then config 6's encoder classifier (``transformer_classifier(vocab
    8192, maxlen 2048, dim 512, heads 8, depth 8, attn_impl="flash")``)
    under ``DOWNPOUR(worker_optimizer="sgd",
    learning_rate=1e-3, num_workers=2, batch_size=8)`` for 3 windows on
    ragged rows; K2, K3 and K4 must have launched and the loss be finite;
13. the parameter-server backend (``backend="ps"``), every launch counter
    set to 0 just before each phase and read just after: config 3
    (CIFAR-10 VGG-small under DOWNPOUR, bf16 compute, f32 params, fused
    Adam at PS3_LR) through a ``SocketParameterServer`` the phase starts,
    4 worker threads of batch 512, window 1, 2 epochs of 32 windows a
    worker — 256 commits and 256 folds, some commit priced τ ≥ 1, K5
    launched 256 times, the loss falling and held-out accuracy above
    PS3_ACC_BAR;
    config 5 (the IMDB LSTM above) under DynSGD through the in-process PS,
    8 workers of batch 64, window 4, 2 epochs of 3 windows — K5, K6 and
    K7 launched once a step a worker (192 each), 48 commits, the loss
    falling; one worker through the in-process PS through the kernels and
    through their plain versions, centers within ``compare_window``'s bf16
    bound; then the MNIST example's twin
    (``distkeras_tpu_torch.examples.mnist``) in this process, ADAG and
    DOWNPOUR through the PS with int8 commits, each to test accuracy >
    0.8; then config 5 through the native PS at ``ps_pipeline_depth=1``
    (K5, K6 and K7 once a step a worker, 48 commits and folds, the loss
    falling, some commit priced τ ≥ 1, its τ beside the in-process serial
    run's); one DOWNPOUR worker on config 5 over the native PS serially
    and pipelined, centers within ``compare_ps_window``'s bound and
    displacement check (the largest difference printed); and config 3
    again through the native PS serially, and at depth 1 through the
    native and the shm PS at PS3_PIPE_LR for PS3_PIPE_EPOCHS (each run:
    one commit and one fold a window a worker, K5 once a step, every
    worker's loss falling, held-out accuracy above PS3_ACC_BAR; its
    window's phases, τ and the center lock's hold printed); each phase
    prints its wall time;
14. the parameter server's resilience layer on config 5 (8 workers, batch
    64, window 4, fused Adam, 2 epochs of 3 windows), each phase one JSON
    line, its launches counted alone and gated (K5, K6 and K7 once a step
    actually taken; lifetime folds equal the commits the clients saw
    acknowledged; the loss falling): ``ps_config5_chaos_socket`` (socket
    PS with a WAL snapshotting every PS5_SNAPSHOT_EVERY commits,
    ``RetryPolicy(seed=0)``, heartbeats with a lease below the restart
    delay, ``FaultPlan(seed=0, drop_recv=PS5_DROP, kill_at={3: 2})`` and a
    restart budget of one: some replay refused, one restart, some
    eviction, every worker's loss falling, the log recovered to the final
    center bit for bit, ``python -m distkeras_tpu_torch.resilience.wal
    verify`` clean), ``ps_config5_failover`` (a hot standby and a WAL, the
    primary killed after half the commits: one failover at fence epoch 1,
    the final center the standby's, the failover time printed beside the
    timeout) and ``ps_config5_native_wal`` (the native PS's C++ WAL with
    heartbeats and retries, crash()ed after the last exchange: the port's
    ``recover_ps_state`` gives the center last served bit for bit, with
    ``num_updates``, ``last_seq`` and ``fence_epoch``); the WAL phases
    print the durability cost (window time, ``ps.wal_wait`` total, fsyncs,
    bytes, the temporary directory's filesystem) beside the in-process
    window;
15. print the ``kernels`` JSON line (K1 as one decode step and, as
    ``q_matmul_prefill``, one 1024-token prefill; every row with its
    launches on the PS phases, K6 and K7 with their G=1 times), read
    config 3's gates (``ps3_failures``), then the
    result line ``{"ok": true, "device": {...}}`` last.

The library calls are yardsticks only; the port never calls them.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np

PEAK_BYTES = 3.35e12        # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12          # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12            # H100 SXM f32 FLOP/s outside the tensor cores

DEVICE = "cuda"
VOCAB, MAXLEN, DIM, HEADS, KV_HEADS, DEPTH = 16384, 1024, 2048, 16, 1, 8
PROMPTS = (128, 77, 208, 333)
SERVED_LENGTHS = (80, 128, 208, 336)   # the prompts padded to BLOCK
NEW_TOKENS = 32
BLOCK = 16
# Dense shapes (K, N) of the config: qkv, attn_out, mlp_up, mlp_down, head
DENSE = ((2048, 2304), (2048, 2048), (2048, 8192), (8192, 2048),
         (2048, 16384))
PER_STEP = {(2048, 2304): DEPTH, (2048, 2048): DEPTH, (2048, 8192): DEPTH,
            (8192, 2048): DEPTH, (2048, 16384): 1}
# BASELINE config 5 at its published width: IMDB LSTM under DynSGD
IMDB_VOCAB, IMDB_T, IMDB_E, IMDB_H = 20000, 200, 128, 128
IMDB_W, IMDB_BATCH, IMDB_WINDOW, IMDB_LR = 8, 64, 4, 1e-3
IMDB_WINDOWS = 6          # windows per epoch of the training phase
# config 9 (bench.py:518-586): the causal LM training composition, under
# ADAG with W=2 stacked workers of batch 8 (B'=16 folded into the kernels)
LM_VOCAB, LM_L, LM_DIM, LM_HEADS, LM_DEPTH = 16384, 2048, 1024, 8, 8
LM_W, LM_BATCH, LM_WINDOW, LM_WINDOWS = 2, 8, 2, 3
LM_LR, LM_CHUNK = 1e-4, 512
LM_CMP_DEPTH = 2          # kernels-vs-plain window: plain attention holds
#                           [B', H, L, L] f32 scores per layer
# config 6 (bench.py:370-386): the encoder classifier under DOWNPOUR
CLS_VOCAB, CLS_L, CLS_DIM, CLS_HEADS, CLS_DEPTH = 8192, 2048, 512, 8, 8
CLS_W, CLS_BATCH, CLS_WINDOW, CLS_WINDOWS, CLS_LR = 2, 8, 5, 3, 1e-3
LOSS = "sparse_softmax_cross_entropy"
# the parameter-server path (backend="ps"): config 3 (bench.py:316-324,
# CIFAR-10 VGG-small under DOWNPOUR) through a socket PS this script
# starts, 4 worker threads of batch 512 over 65536 rows, 2 epochs.
# Window 1, DOWNPOUR's push every step: at window 4 four workers' summed
# multi-step Adam windows learn slowly and erratically, in the JAX package
# too. Adam at 2.5e-4, half bench.py's 5e-4: at 5e-4 one serial run in
# five or six misses the accuracy bar (PERF.md, Findings)
PS3_W, PS3_BATCH, PS3_WINDOW, PS3_LR, PS3_EPOCHS = 4, 512, 1, 2.5e-4, 2
PS3_WINDOWS = 32          # windows a worker an epoch
PS3_TEST = 2048
PS3_ACC_BAR = 0.3         # held-out accuracy gate (PERF.md, Findings)
# DOWNPOUR with four Adam workers learns config 3 while lr·τ stays near
# 1e-3 (PERF.md, Findings): τ is ~3 serially and ~7 pipelined, so the
# pipelined runs take half the rate for twice the epochs
PS3_PIPE_LR, PS3_PIPE_EPOCHS = 1.25e-4, 4
# config 5 through the in-process PS: 8 worker threads of batch 64,
# window 4, 3 windows a worker an epoch, 2 epochs
PS5_W, PS5_WINDOWS, PS5_EPOCHS = 8, 3, 2
PS_PARITY_WINDOWS = 2     # the one-worker kernels-vs-plain PS run
PS_DISP_FRAC = 0.25       # its per-leaf displacement agreement
PS_PIPE_WINDOWS = 3       # the one-worker serial-vs-pipelined native run
# the resilience phases: config 5 as PS5_* runs it, through the socket PS
# under chaos (drops, a worker killed and restarted), through a standby
# failover, and through the native PS's C++ write-ahead log. The chaos
# phase's lease lapses during the killed worker's restart delay while its
# peers still heartbeat (windows of ~0.4 s: the eviction is seen), and
# stays above a live worker's heartbeat gap (a window and its exchange)
PS5_DROP = 0.15           # the chaos phase's drop_recv
PS5_KILL = {3: 2}         # worker 3 dies at its window 2
PS5_HEARTBEAT, PS5_LEASE, PS5_RESTART_DELAY = 0.05, 1.0, 2.0
PS5_ATTEMPTS = 12         # tries a call: a try fails with p ~ 0.28
PS5_MAX_DELAY = 0.2       # backoff cap: a replay reaches the server well
#                           inside the lease its fold renewed
PS5_SNAPSHOT_EVERY = 16   # snapshots (and log truncation) in the run
PS5_FAILOVER_TIMEOUT = 2.0
MNIST_RUNS = (["--trainer", "adag"],
              # DOWNPOUR sums 4 workers' Adam windows: window 1 (the
              # paper's push-every-step) is where it learns reliably
              ["--trainer", "downpour", "--backend", "ps", "--compression",
               "int8", "--workers", "4", "--window", "1"])


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, peak_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, ops_ms=t_ops)


def _events(torch, run, n: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        run()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def eager_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Time per call issued from Python one after another (CUDA events):
    the device time, or the host's time per call where the host is the
    slower of the two."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _events(torch, fn, iters) / iters


def cuda_ms(torch, fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed ``replays`` times (CUDA events), so the Python wrappers' host
    time between launches is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events(torch, graph.replay, replays) / (iters * replays)
    del graph
    return ms


def rotating(items):
    """A callable stepping through ``items`` — weights rotated so each
    timed launch reads them cold from HBM, as a decode step does."""
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % len(items)
        return items[state["i"]]

    return nxt


def check_q_matmul(torch, quant):
    """Phase 3: K1 against its plain version at every Dense shape of the
    served config: decode (M=8, the served batch), the served prefill
    lengths (SERVED_LENGTHS, one batched prefill per padded length) and
    M=1024, with kernel, plain and library times and the card's bound; the
    split decode kernel twice for equal bits; then ragged edges."""
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rows, max_err = [], 0.0
    for (k, n) in DENSE:
        w = torch.randn((n, k), generator=gen, device=DEVICE) * 0.02
        qt = quant.quantize(w, axis=1)
        nrot = max(1, min(48, math.ceil(200e6 / qt.q.numel())))
        qs = [quant.QTensor(qt.q.clone(), qt.scale.clone())
              for _ in range(nrot)]
        deq = [quant.dequantize(q_, axis=1, dtype=torch.bfloat16)
               for q_ in qs]
        cases = [(m, torch.bfloat16) for m in (8, *SERVED_LENGTHS, 1024)]
        if (k, n) == DENSE[0]:   # ragged decode rows, and the f32 kernel
            cases += [(13, torch.bfloat16), (8, torch.float32),
                      (1024, torch.float32)]
        for m, dt in cases:
            x = torch.randn((m, k), generator=gen, device=DEVICE).to(dt)
            got = quant.q_matmul(x, qt).float()
            again = quant.q_matmul(x, qt).float()
            ref = quant._q_matmul_plain(x, qt.q, qt.scale, dt).float()
            torch.cuda.synchronize()
            rtol = 1e-2 if dt == torch.bfloat16 else 1e-5
            atol = 1e-3 * ref.abs().max().item() if dt == torch.bfloat16 \
                else 1e-5 * ref.abs().max().item()
            err = (got - ref).abs().max().item()
            ok = torch.allclose(got, ref, rtol=rtol, atol=atol)
            if not (ok and torch.isfinite(got).all()):
                raise AssertionError(
                    f"q_matmul M={m} K={k} N={n} {dt}: max |kernel - plain| "
                    f"= {err} beyond rtol={rtol}, atol={atol}")
            if not torch.equal(got, again):   # the K split sums in rank order
                raise AssertionError(f"q_matmul M={m} K={k} N={n} {dt}: two "
                                     f"launches differ")
            max_err = max(max_err, err)
            plan = quant.plan_q_matmul(m, n, k, dt)
            nq, nd = rotating(qs), rotating(deq)
            kernel_ms = cuda_ms(torch, lambda: quant.q_matmul(x, nq()))
            call_ms = eager_ms(torch, lambda: quant.q_matmul(x, nq()))
            plain_ms = cuda_ms(torch, lambda: quant._q_matmul_plain(
                x, *nq(), dt), iters=10)
            library_ms = (cuda_ms(torch, lambda: torch.matmul(x, nd().t()))
                          if dt == torch.bfloat16 else None)
            esz = 2 if dt == torch.bfloat16 else 4
            nbytes = m * k * esz + k * n + n * 4 + m * n * esz
            row = dict(M=m, K=k, N=n, dtype=str(dt).split(".")[-1],
                       plan=dict(kernel=plan.kernel, tokens=plan.tokens,
                                 channels=plan.channels, splits=plan.splits,
                                 blocks=plan.blocks),
                       max_abs_err=err, equal_bits=True, kernel_ms=kernel_ms,
                       eager_ms=call_ms, plain_ms=plain_ms,
                       library_ms=library_ms,
                       **bound(nbytes, 2.0 * m * n * k,
                               PEAK_BF16 if esz == 2 else PEAK_F32))
            rows.append(row)
            log("q_matmul " + json.dumps(row))
        del qs, deq
    # ragged edges: M, K, N that no tile divides. K that rules out 16-byte
    # rows takes the element-masked kernels (f32 tile, bf16 decode, bf16
    # mma.sync prefill); K a multiple of 16 but not of a chunk, N not of a
    # channel tile and M not of a token tile take the split decode and the
    # wgmma prefill kernels, whose TMA boxes and cp.async pieces zero-fill
    for m, k, n in ((40, 200, 300), (50, 77, 130), (3, 77, 130),
                    (12, 200, 300), (40, 208, 300), (3, 208, 130),
                    (12, 1040, 300), (300, 1040, 1000), (17, 64, 64),
                    (257, 2048, 130)):
        qt = quant.quantize(torch.randn((n, k), generator=gen,
                                        device=DEVICE), axis=1)
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((m, k), generator=gen, device=DEVICE).to(dt)
            got = quant.q_matmul(x, qt).float()
            ref = quant._q_matmul_plain(x, qt.q, qt.scale, dt).float()
            rtol = 1e-2 if dt == torch.bfloat16 else 1e-5
            atol = (1e-3 if dt == torch.bfloat16 else 1e-5) \
                * ref.abs().max().item()
            if not torch.allclose(got, ref, rtol=rtol, atol=atol):
                raise AssertionError(
                    f"q_matmul edge M={m} K={k} N={n} {dt}: max |kernel - "
                    f"plain| = {(got - ref).abs().max().item()}")
        log(f"q_matmul edge M={m} K={k} N={n}: ok "
            f"({quant.plan_q_matmul(m, n, k).kernel} in bf16)")
    return rows, max_err


def check_flash(torch, fa):
    """Phase 4: K2 against its plain version, with times and bounds."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    rows, max_err = [], 0.0
    bf = torch.bfloat16
    cases = [
        # (B, L, H, Hkv, D, dtype, causal, window, key mask; see _key_mask)
        (4, 128, 16, 1, 128, bf, True, None, None),
        (4, 208, 16, 1, 128, bf, True, None, None),
        (1, 80, 16, 1, 128, bf, True, None, None),
        (1, 128, 16, 1, 128, bf, True, None, None),
        (1, 208, 16, 1, 128, bf, True, None, None),
        (1, 336, 16, 1, 128, bf, True, None, None),
        (2, 100, 4, 2, 64, bf, False, 24, "half"),
        (2, 150, 4, 1, 128, bf, True, 40, "half"),
        # the wgmma kernel's edge tiles: L not a multiple of its 128-row
        # tiles, masked keys inside otherwise interior tiles, a window
        # narrower than a warp's 16 rows, GQA 2 and MQA, fully masked rows
        (2, 77, 4, 2, 64, bf, True, None, "holes"),
        (2, 130, 8, 8, 128, bf, False, None, "holes"),
        (2, 333, 4, 1, 128, bf, False, 5, "half"),
        (2, 333, 8, 2, 64, bf, True, None, "half"),
        (1, 512, 4, 4, 128, bf, False, None, "holes"),
        (2, 100, 4, 2, 64, torch.float32, True, 24, "half"),
    ]
    for B, L, H, Hkv, D, dt, causal, window, mkind in cases:
        q = torch.randn((B, L, H, D), generator=gen, device=DEVICE).to(dt)
        k = torch.randn((B, L, Hkv, D), generator=gen, device=DEVICE).to(dt)
        v = torch.randn((B, L, Hkv, D), generator=gen, device=DEVICE).to(dt)
        km = _key_mask(torch, mkind, B, L, gen)
        masked = km is not None
        kw = dict(scale=D ** -0.5, causal=causal, window=window)
        o, lse = fa._fa_forward(q, k, v, km, **kw)
        ro, rlse = fa._fa_forward_plain(q, k, v, km, **kw)
        torch.cuda.synchronize()
        o_atol = 2e-2 if dt == torch.bfloat16 else 1e-4
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        if not (err <= o_atol and lse_err <= 1e-3
                and torch.isfinite(o.float()).all()):
            raise AssertionError(
                f"flash B={B} L={L} H={H}/{Hkv} D={D} {dt} causal={causal} "
                f"window={window} mask={mkind}: |O - plain| = {err} "
                f"(atol {o_atol}), |lse - plain| = {lse_err} (atol 1e-3)")
        if mkind == "half" and o[1].abs().max().item() != 0.0:
            raise AssertionError("flash: fully masked rows must give 0")
        max_err = max(max_err, err)
        kernel_ms = cuda_ms(torch, lambda: fa._fa_forward(q, k, v, km, **kw))
        call_ms = eager_ms(torch, lambda: fa._fa_forward(q, k, v, km, **kw))
        plain_ms = cuda_ms(torch, lambda: fa._fa_forward_plain(
            q, k, v, km, **kw), iters=10)
        library_ms = None
        if window is None and not masked:
            qt = q.transpose(1, 2).contiguous()
            kt = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2) \
                .contiguous()
            vt = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2) \
                .contiguous()
            library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal))
        pairs = _pairs(torch, fa, B, L, causal, window, km)
        esz = 2 if dt == torch.bfloat16 else 4
        nbytes = (2 * B * L * H * D + 2 * B * L * Hkv * D) * esz \
            + B * H * L * 4
        row = dict(B=B, L=L, H=H, Hkv=Hkv, D=D, dtype=str(dt).split(".")[-1],
                   causal=causal, window=window, key_mask=mkind,
                   max_abs_err=err, lse_err=lse_err, kernel_ms=kernel_ms,
                   eager_ms=call_ms, plain_ms=plain_ms,
                   library_ms=library_ms,
                   **bound(nbytes, 4.0 * pairs * H * D,
                           PEAK_BF16 if esz == 2 else PEAK_F32))
        rows.append(row)
        log("flash_attention " + json.dumps(row))
    return rows, max_err


def _pairs(torch, fa, B, L, causal, window, km):
    """(batch, query, key) pairs this band and key mask leave to compute."""
    qp = torch.arange(L, device=DEVICE)[:, None]
    kp = torch.arange(L, device=DEVICE)[None, :]
    band = fa.band_predicate(qp, kp, causal, fa._canonical_window(window, L))
    valid = torch.ones((B, L, L), dtype=torch.bool, device=DEVICE)
    if band is not None:
        valid &= band[None]
    if km is not None:
        valid &= km.bool()[:, None, :]
    return int(valid.sum().item())


def _key_mask(torch, kind, B, L, gen):
    """None; "half": row 0 attends a prefix, row 1 nothing (every query
    of row 1 fully masked); "ragged": each row a prefix of its own
    length, L/4 .. L; "holes": every key but one in 37 (offset by the
    row), so masked keys fall inside tiles that are otherwise whole."""
    if kind is None:
        return None
    km = torch.zeros((B, L), device=DEVICE)
    if kind == "half":
        km[0, : L - L // 3] = 1.0
        return km
    if kind == "holes":
        pos = torch.arange(L, device=DEVICE)[None]
        rows = torch.arange(B, device=DEVICE)[:, None]
        return ((pos + 5 * rows) % 37 != 3).float()
    lengths = torch.randint(L // 4, L + 1, (B,), generator=gen,
                            device=DEVICE)
    return (torch.arange(L, device=DEVICE)[None] < lengths[:, None]).float()


def check_flash_bwd(torch, fa):
    """K2's forward, K3 (dq) and K4 (dk/dv) against their plain versions
    at the LM's training shape (B'=16 = 2 workers x 8, L=2048, H=8, D=128,
    bf16, causal), the classifier's (D=64, non-causal, ragged key mask)
    and small cases (GQA 2 and 1, window with and without causal, a window
    narrower than a warp's rows, ragged L, masked keys inside whole tiles,
    f32, the bf16 FMA path at D=32, fully masked rows). The forward is
    held to the tolerances of ``check_flash``; the backward kernels and
    their plain version read the same q, k, v, dO and the kernel forward's
    O and lse. Tolerance: the kernels round p and ds to bf16 as operands
    of their second products (as FA2) where the plain version keeps f32,
    so bf16 outputs agree to 2^-6 of the plain output's largest magnitude
    (two bf16 ulps); f32 to 1e-4 of it (summation order over up to L terms
    through exp). Fully masked rows must give exact zeros. Kernel, plain
    and library (``scaled_dot_product_attention``'s forward, and its
    backward, which computes dq, dk and dv in one call, at the same shapes
    without the key mask) are timed at the two training shapes."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE).manual_seed(3)
    bf, f32 = torch.bfloat16, torch.float32
    Bp = LM_W * LM_BATCH
    cases = [
        # (B, L, H, Hkv, D, dtype, causal, window, key mask, timed)
        (Bp, LM_L, LM_HEADS, LM_HEADS, LM_DIM // LM_HEADS, bf, True, None,
         None, True),
        (Bp, CLS_L, CLS_HEADS, CLS_HEADS, CLS_DIM // CLS_HEADS, bf, False,
         None, "ragged", True),
        (2, 100, 4, 2, 64, bf, False, 24, "half", False),
        (2, 150, 4, 1, 128, bf, True, 40, "half", False),
        (2, 77, 4, 4, 128, bf, True, None, None, False),
        (2, 130, 8, 2, 64, bf, False, None, "half", False),
        (2, 77, 4, 2, 32, bf, True, None, "half", False),
        (2, 333, 4, 1, 128, bf, False, 5, "half", False),
        (2, 333, 8, 2, 64, bf, True, None, "holes", False),
        (1, 512, 4, 4, 128, bf, False, None, "holes", False),
        (2, 100, 4, 2, 64, f32, True, 24, "half", False),
        (2, 77, 4, 1, 128, f32, False, None, None, False),
    ]
    fwd_rows, dq_rows, dkv_rows = [], [], []
    dq_err = dkv_err = 0.0
    for B, L, H, Hkv, D, dt, causal, window, mkind, timed in cases:
        q = torch.randn((B, L, H, D), generator=gen, device=DEVICE).to(dt)
        k = torch.randn((B, L, Hkv, D), generator=gen, device=DEVICE).to(dt)
        v = torch.randn((B, L, Hkv, D), generator=gen, device=DEVICE).to(dt)
        g = torch.randn((B, L, H, D), generator=gen, device=DEVICE).to(dt)
        km = _key_mask(torch, mkind, B, L, gen)
        kw = dict(scale=D ** -0.5, causal=causal, window=window)
        out, lse = fa._fa_forward(q, k, v, km, **kw)
        ro, rlse = fa._fa_forward_plain(q, k, v, km, **kw)
        torch.cuda.synchronize()
        label = (f"B={B} L={L} H={H}/{Hkv} D={D} {str(dt).split('.')[-1]} "
                 f"causal={causal} window={window} mask={mkind}")
        o_atol = 2e-2 if dt == bf else 1e-4
        errs = {"o": _err(out, ro), "lse": _err(lse, rlse)}
        if not (errs["o"] <= o_atol and errs["lse"] <= 1e-3
                and torch.isfinite(out.float()).all()):
            raise AssertionError(
                f"flash forward {label}: |O - plain| = {errs['o']} (atol "
                f"{o_atol}), |lse - plain| = {errs['lse']} (atol 1e-3)")
        if mkind == "half" and out[1].abs().max().item() != 0.0:
            raise AssertionError(f"flash forward {label}: fully masked rows "
                                 f"must give 0")
        del ro, rlse
        delta = fa._delta(out, g)
        args = (q, k, v, km, lse, delta, g)
        dq = fa._fa_bwd_dq(*args, **kw)
        dk, dv = fa._fa_bwd_dkv(*args, **kw)
        rq, rk, rv = fa._fa_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        rel = 2.0 ** -6 if dt == bf else 1e-4
        for name, got, ref in (("dq", dq, rq), ("dk", dk, rk),
                               ("dv", dv, rv)):
            errs[name] = _err(got, ref)
            scale = ref.float().abs().max().item()
            if not (errs[name] <= rel * scale
                    and torch.isfinite(got.float()).all()):
                raise AssertionError(
                    f"flash backward {label} {name}: max |kernel - plain| = "
                    f"{errs[name]} beyond {rel} x {scale}")
        if mkind == "half" and not all(
                t[1].abs().max().item() == 0.0 for t in (dq, dk, dv)):
            raise AssertionError(f"flash backward {label}: fully masked "
                                 f"rows must give zero gradients")
        log(f"flash backward {label}: ok " + json.dumps(errs))
        dq_err = max(dq_err, errs["dq"])
        dkv_err = max(dkv_err, errs["dk"], errs["dv"])
        del rq, rk, rv
        if not timed:
            continue
        pairs = _pairs(torch, fa, B, L, causal, window, km)
        esz = 2 if dt == bf else 4
        qb, kvb = B * L * H * D * esz, B * L * Hkv * D * esz
        rowb = 2 * B * H * L * 4 + (0 if km is None else B * L * 4)
        shape = dict(B=B, L=L, H=H, Hkv=Hkv, D=D,
                     dtype=str(dt).split(".")[-1], causal=causal,
                     window=window, key_mask=mkind)
        # library: SDPA (flash backend) forward and its backward alone
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        gt = g.transpose(1, 2).contiguous()
        with torch.enable_grad():
            lo = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
            lib_bwd = eager_ms(torch, lambda: torch.autograd.grad(
                lo, (qt, kt, vt), gt, retain_graph=True), iters=10)
        lib_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt.detach(), kt.detach(), vt.detach(), is_causal=causal))
        del lo, qt, kt, vt, gt
        fwd_rows.append(dict(
            **shape, max_abs_err=errs["o"], lse_err=errs["lse"],
            kernel_ms=cuda_ms(torch, lambda: fa._fa_forward(
                q, k, v, km, **kw), iters=5),
            eager_ms=eager_ms(torch, lambda: fa._fa_forward(
                q, k, v, km, **kw), iters=5),
            plain_ms=cuda_ms(torch, lambda: fa._fa_forward_plain(
                q, k, v, km, **kw), iters=1, replays=2),
            library_ms=lib_fwd,
            **bound(2 * qb + 2 * kvb + B * H * L * 4, 4.0 * pairs * H * D,
                    PEAK_BF16 if esz == 2 else PEAK_F32)))
        log("flash_attention training shape " + json.dumps(fwd_rows[-1]))
        dq_rows.append(dict(
            **shape, max_abs_err=errs["dq"],
            kernel_ms=cuda_ms(torch, lambda: fa._fa_bwd_dq(*args, **kw),
                              iters=5),
            eager_ms=eager_ms(torch, lambda: fa._fa_bwd_dq(*args, **kw),
                              iters=5),
            plain_ms=cuda_ms(torch, lambda: fa._fa_bwd_plain(
                *args, **kw, parts=("dq",)), iters=1, replays=2),
            library_ms=lib_bwd,
            **bound(3 * qb + 2 * kvb + rowb, 6.0 * pairs * H * D,
                    PEAK_BF16 if esz == 2 else PEAK_F32)))
        log("flash_attention_bwd_dq " + json.dumps(dq_rows[-1]))
        dkv_rows.append(dict(
            **shape, max_abs_err=max(errs["dk"], errs["dv"]),
            kernel_ms=cuda_ms(torch, lambda: fa._fa_bwd_dkv(*args, **kw),
                              iters=5),
            eager_ms=eager_ms(torch, lambda: fa._fa_bwd_dkv(*args, **kw),
                              iters=5),
            plain_ms=cuda_ms(torch, lambda: fa._fa_bwd_plain(
                *args, **kw, parts=("dkv",)), iters=1, replays=2),
            library_ms=lib_bwd,
            **bound(2 * qb + 4 * kvb + rowb, 8.0 * pairs * H * D,
                    PEAK_BF16 if esz == 2 else PEAK_F32)))
        log("flash_attention_bwd_dkv " + json.dumps(dkv_rows[-1]))
    torch.cuda.empty_cache()
    return fwd_rows, dq_rows, dkv_rows, dq_err, dkv_err


# the kernels redesigned on wgmma: kernels-line entry → (library, function)
WGMMA_KERNELS = {
    "flash_attention": ("flash_attention", "fa_fwd_wgmma_kernel"),
    "flash_attention_bwd_dq": ("flash_attention_bwd",
                               "fa_bwd_dq_wgmma_kernel"),
    "flash_attention_bwd_dkv": ("flash_attention_bwd",
                                "fa_bwd_dkv_wgmma_kernel"),
}


# the same check for the other wgmma kernels, each of its instantiations
WGMMA_KERNELS_ONE = {
    "lstm_backward": ("lstm", "lstm_dwh_wgmma_kernel"),
    "q_matmul_prefill": ("quant", "qmm_prefill_wgmma_kernel"),
}

# kernels on the main paths held to no spills (registers reported), every
# instantiation: K6's cluster scan, K7's two scans (lstm.cu is one
# translation unit, and register allocation there is fragile), K1's split
# decode kernel
NO_SPILL_KERNELS = {
    "lstm_forward": ("lstm", "lstm_fwd_cluster_kernel"),
    "lstm_backward_scan": ("lstm", "lstm_bwd_kernel"),
    "lstm_backward_direct_scan": ("lstm", "lstm_bwd_direct_kernel"),
    "q_matmul": ("quant", "qmm_decode_split_kernel"),
}


def _template_tag(name, fn):
    """``<256,2>`` for a mangled ``fn<256, 2>``; "" if not a template."""
    rest = name[name.index(fn) + len(fn):]
    if not rest.startswith("I"):
        return ""
    inner, args = rest[1:], []
    while inner and not inner.startswith("E"):
        if inner.startswith("13__nv_bfloat16"):
            args.append("bf16")
            inner = inner[len("13__nv_bfloat16"):]
        elif inner.startswith("f"):
            args.append("f32")
            inner = inner[1:]
        elif inner[:2] in ("Li", "Lb"):
            end = inner.index("E")
            val = inner[2:end]
            args.append(val if inner[1] == "i" else ("true" if val == "1"
                                                     else "false"))
            inner = inner[end + 1:]
        else:
            break
    return "<" + ",".join(args) + ">"


def _kernel_rows(lib, fn, report, sass, need_wgmma):
    """Every instantiation of ``fn`` in ``lib``'s build: registers, spills
    and (for a wgmma kernel) its HGMMA / UTMALDG counts, held to no spills
    and, for a wgmma kernel, HGMMA > 0 and UTMALDG > 0."""
    names = [k for k in report if fn in k and
             (k[k.index(fn) + len(fn):][:1] in ("I", "E", "v"))]
    if not names:
        raise AssertionError(f"{fn} not found in the build of {lib}: "
                             f"{list(report)}")
    rows = {}
    for name in names:
        ops = sass.get(name, {})
        row = dict(report[name])
        if need_wgmma:
            row.update(hgmma=ops.get("HGMMA", 0), utmaldg=ops.get("UTMALDG", 0))
        bad = (row.get("spill_stores", 0) or row.get("spill_loads", 0)
               or (need_wgmma and not (row["hgmma"] > 0
                                       and row["utmaldg"] > 0)))
        if bad:
            raise AssertionError(f"{fn} ({name}): {row}")
        rows[_template_tag(name, fn)] = row
    return rows[""] if list(rows) == [""] else rows


def _sass_row(lib, fn, tag, report, sass):
    regs = [v for k, v in report.items() if tag in k]
    ops = [v for k, v in sass.items() if tag in k]
    if len(regs) != 1 or len(ops) != 1:
        raise AssertionError(f"{tag} not found once in the build of {lib}: "
                             f"{list(report)}")
    row = dict(**regs[0], hgmma=ops[0]["HGMMA"], utmaldg=ops[0]["UTMALDG"])
    if not (row["hgmma"] > 0 and row["utmaldg"] > 0
            and row.get("spill_stores", 0) == 0
            and row.get("spill_loads", 0) == 0):
        raise AssertionError(f"{fn} ({tag}): {row}")
    return row


def check_sass(_build):
    """Each kernel redesigned on wgmma (the flash kernels at both head
    dims, the LSTM's dwh product, K1's prefill kernel at every token tile
    and warpgroup count) issues ``HGMMA`` and ``UTMALDG`` (TMA)
    instructions in its SASS (``cuobjdump -sass`` of the built library),
    spills nothing (``ptxas -v``), and ``setmaxnreg`` was not ignored;
    the scans and K1's decode kernel (``NO_SPILL_KERNELS``) spill nothing.
    Registers are the launch count; the flash kernels' consumer
    warpgroups raise theirs with ``setmaxnreg``."""
    out = {}
    kernels = [(entry, lib, fn, {f"D={d}": f"{fn}ILi{d}E" for d in (64, 128)})
               for entry, (lib, fn) in WGMMA_KERNELS.items()]
    for entry, lib, fn, tags in kernels:
        text = _build.build_log(lib)
        if "setmaxnreg ignored" in text:
            raise AssertionError(f"{lib}: ptxas ignored setmaxnreg:\n{text}")
        report = _build.ptxas_report(text)
        sass = _build.sass_counts(lib)
        for key, tag in tags.items():
            out.setdefault(entry, {})[key] = _sass_row(lib, fn, tag, report,
                                                       sass)
        log(f"sass {entry} ({fn}): {json.dumps(out[entry])}")
    for table, need_wgmma in ((WGMMA_KERNELS_ONE, True),
                              (NO_SPILL_KERNELS, False)):
        for entry, (lib, fn) in table.items():
            text = _build.build_log(lib)
            if "setmaxnreg ignored" in text:
                raise AssertionError(f"{lib}: ptxas ignored setmaxnreg")
            rows = _kernel_rows(lib, fn, _build.ptxas_report(text),
                                _build.sass_counts(lib) if need_wgmma else {},
                                need_wgmma)
            out[entry] = rows
            log(f"sass {entry} ({fn}): {json.dumps(rows)}")
    return out


def check_fused_ce(torch):
    """The fused cross-entropy (``ops/fused_ce.py``) on the card in bf16 at
    the LM's head (D=1024, V=16384, chunk 512), 2 workers of 1024 rows.
    Each worker's loss equals the plain f32-logit reference (the same bf16
    operands multiplied in f32) to 1e-5 relative, as the JAX op keeps its
    logits f32 (summation order only; bf16 logits would move it ~1e-4).
    ``vmap(grad)`` over the workers raises no vmap-fallback warning (a
    per-worker loop) and matches a loop over workers: the loss to 1e-5
    relative, dh and dkernel to 2^-7 of their largest magnitude (one bf16
    ulp there: batched and single products may sum in another order, and
    a last-bit f32 difference can flip a bf16 rounding)."""
    import warnings

    from distkeras_tpu_torch.ops.fused_ce import chunked_softmax_cross_entropy

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    W, N, D, V = 2, 1024, LM_DIM, LM_VOCAB
    bf = torch.bfloat16
    hs = torch.randn((W, N, D), generator=gen, device=DEVICE).to(bf)
    ks = (torch.randn((W, D, V), generator=gen, device=DEVICE)
          * D ** -0.5).to(bf)
    ys = torch.randint(0, V, (W, N), generator=gen, device=DEVICE)

    def loss(h, k, y):
        return chunked_softmax_cross_entropy(h, y, k, chunk=LM_CHUNK)

    grad = torch.func.grad_and_value(loss, argnums=(0, 1))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (dh, dk), vals = torch.func.vmap(grad)(hs, ks, ys)
        torch.cuda.synchronize()
    fallback = [str(w.message) for w in caught if "batching rule"
                in str(w.message)]
    if fallback:
        raise AssertionError(f"fused CE under vmap(grad) fell back to a "
                             f"per-worker loop: {fallback[:2]}")
    errs = dict(loss=0.0, dh=0.0, dk=0.0)
    for w in range(W):
        ref = torch.nn.functional.cross_entropy(
            hs[w].float() @ ks[w].float(), ys[w])
        (rh, rk), rv = grad(hs[w], ks[w], ys[w])
        for name, got, want, tol in (
                ("loss", vals[w], ref, 1e-5 * ref.abs().item()),
                ("loss", vals[w], rv, 1e-5 * rv.abs().item()),
                ("dh", dh[w], rh, 2.0 ** -7 * rh.float().abs().max().item()),
                ("dk", dk[w], rk, 2.0 ** -7 * rk.float().abs().max().item())):
            e = _err(got, want)
            errs[name] = max(errs[name], e)
            if not e <= tol:
                raise AssertionError(f"fused CE worker {w} {name}: |got - "
                                     f"want| = {e} beyond {tol}")
    log("fused_ce bf16 vmap(grad) W=2: ok " + json.dumps(errs))


def check_flash_vmap(torch, fa):
    """The flash Function under ``torch.func.vmap(grad)`` at W=2: the
    gradients through K2–K4 equal those through the plain versions
    (tolerance as in ``check_flash_bwd``), and each kernel launched once
    for the step, not once per worker."""
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    W, B, L, H, Hkv, D = 2, 2, 130, 4, 2, 64
    bf = torch.bfloat16
    qs = torch.randn((W, B, L, H, D), generator=gen, device=DEVICE).to(bf)
    ks = torch.randn((W, B, L, Hkv, D), generator=gen, device=DEVICE).to(bf)
    vs = torch.randn((W, B, L, Hkv, D), generator=gen, device=DEVICE).to(bf)
    masks = torch.ones((W, B, L), device=DEVICE)
    masks[:, 1, 100:] = 0.0
    probe = torch.randn((B, L, H, D), generator=gen, device=DEVICE)

    def counts():
        return (fa._fa_forward.launches, fa._fa_bwd_dq.launches,
                fa._fa_bwd_dkv.launches)

    grads, launched = {}, {}
    for impl in ("kernel", "plain"):
        def loss(q, k, v, m, impl=impl):
            o = fa.flash_attention(q, k, v, causal=True, key_mask=m,
                                   impl=impl)
            return torch.sum(o.float() * probe)

        before = counts()
        grads[impl] = torch.func.vmap(torch.func.grad(
            loss, argnums=(0, 1, 2)))(qs, ks, vs, masks)
        torch.cuda.synchronize()
        launched[impl] = [a - b for a, b in zip(counts(), before)]
    if launched != {"kernel": [1, 1, 1], "plain": [0, 0, 0]}:
        raise AssertionError(f"flash vmap(grad): launches {launched}, "
                             f"expected one of K2, K3, K4 for the step")
    errs = {}
    for name, got, ref in zip(("dq", "dk", "dv"), grads["kernel"],
                              grads["plain"]):
        errs[name] = _err(got, ref)
        scale = ref.float().abs().max().item()
        if not errs[name] <= 2.0 ** -6 * scale:
            raise AssertionError(f"flash vmap(grad) {name}: max |kernel - "
                                 f"plain| = {errs[name]} beyond 2^-6 x "
                                 f"{scale}")
    log("flash vmap(grad) W=2: ok " + json.dumps(dict(
        errs, launches=launched["kernel"])))


def lm_spec(torch, depth, attn_impl):
    from distkeras_tpu_torch.models import transformer_lm_spec

    return transformer_lm_spec(
        vocab=LM_VOCAB, maxlen=LM_L, dim=LM_DIM, heads=LM_HEADS, depth=depth,
        dtype=torch.bfloat16, attn_impl=attn_impl, pos_embedding="rope",
        fused_ce=True, ce_chunk=LM_CHUNK)


def lm_tokens(n, seed=0):
    """A learnable stream: each row counts up by one mod V from a random
    start (uniform tokens, as bench.py's, cannot show a falling loss)."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, LM_VOCAB, (n, 1))
    return ((start + np.arange(LM_L + 1)[None]) % LM_VOCAB).astype(np.int32)


def compare_lm_window(torch):
    """One ADAG window of the config-9 LM at full width and depth
    LM_CMP_DEPTH through K2–K5 and, from the same init on the same
    superbatch, through their plain versions on the card. Bound as in
    ``compare_window``: Adam moves an element by at most ~1.01 lr a step
    whatever its gradient's size, a noise-level gradient may take either
    sign, and ADAG's center is the mean of the W workers, so centers agree
    to 2.02 lr · window; the mean loss to 1e-2."""
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.ops.pallas_kernels import fused_adam
    from distkeras_tpu_torch.parallel import ADAGMerge, LocalSGDEngine
    from distkeras_tpu_torch.trainers import _make_loss_step

    toks = lm_tokens(LM_W * LM_WINDOW * LM_BATCH, seed=1).reshape(
        LM_W, LM_WINDOW, LM_BATCH, LM_L + 1)
    batch = (toks[..., :-1], toks[..., 1:])
    out = {}
    for impl, attn in (("kernel", "flash"), ("plain", "plain")):
        spec = lm_spec(torch, LM_CMP_DEPTH, attn)
        engine = LocalSGDEngine(
            spec, _make_loss_step(spec, get_loss(LOSS), 1, LOSS),
            fused_adam(LM_LR, impl=impl), ADAGMerge(), device=DEVICE,
            num_workers=LM_W, window=LM_WINDOW, batch_size=LM_BATCH)
        params, nt = spec.init(0)
        state, loss = engine.run_window(engine.init_state(params, nt), batch)
        out[impl] = (engine.center_params(state), loss.item())
        del engine, state
        torch.cuda.empty_cache()
    (ck, lk), (cp, lp) = out["kernel"], out["plain"]
    diff = max(_err(ck[k], cp[k]) for k in ck)
    mean = max((ck[k] - cp[k]).abs().mean().item() for k in ck)
    limit = 2.02 * LM_LR * LM_WINDOW
    if not (diff <= limit and abs(lk - lp) <= 1e-2
            and all(torch.isfinite(v).all() for v in ck.values())):
        raise AssertionError(
            f"ADAG LM window kernel vs plain: max |center diff| {diff} "
            f"(limit {limit}), loss {lk} vs {lp}")
    log("LM window kernels vs plain: " + json.dumps(dict(
        depth=LM_CMP_DEPTH, max_center_diff=diff, max_mean_center_diff=mean,
        limit=limit, loss_kernel=lk, loss_plain=lp)))


def train_lm(torch):
    """The slice's main path: config 9 at full width and depth under
    ADAG with fused Adam, the flash kernels and the fused cross-entropy,
    two epochs of LM_WINDOWS windows, random init from seed 0. Returns
    the phase's record; the caller reads the launch counters around it."""
    import warnings

    from distkeras_tpu_torch.data import next_token_dataset
    from distkeras_tpu_torch.trainers import ADAG

    spec = lm_spec(torch, LM_DEPTH, "flash")
    t = ADAG(spec, loss=LOSS, worker_optimizer="fused_adam",
             learning_rate=LM_LR, num_workers=LM_W, batch_size=LM_BATCH,
             communication_window=LM_WINDOW, num_epoch=2, log_metrics=True,
             device=DEVICE)
    ds = next_token_dataset(lm_tokens(
        LM_W * LM_WINDOW * LM_BATCH * LM_WINDOWS))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t.train(ds)
    wall = time.perf_counter() - t0
    fallback = [str(w.message) for w in caught
                if "batching rule" in str(w.message)]
    if fallback:
        raise AssertionError(f"ADAG LM: vmap fell back to a per-worker "
                             f"loop: {fallback[:2]}")
    losses = t.history.losses()
    if len(losses) != 2 * LM_WINDOWS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"ADAG LM: bad loss history {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ADAG LM: the loss did not fall: {losses}")
    tokens = LM_W * LM_WINDOW * LM_BATCH * LM_L
    rec = dict(
        wall_s=wall, windows=len(losses), tokens_per_window=tokens,
        losses=losses, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        params=sum(v.numel() for v in t.trained_params_.values()),
        epochs=[dict(epoch=m["epoch"],
                     tokens_per_s=m["samples_per_sec"] * LM_L,
                     window_ms=1e3 * m["wall_time"] / LM_WINDOWS)
                for m in t.metrics_ if "samples_per_sec" in m])
    log("train ADAG lm config 9: " + json.dumps(rec))
    return rec


def classifier_data(n, seed=0):
    """Rows of ragged length (L/4 .. L, zero-padded, so the key mask is
    real) labelled by whether most of their tokens lie in the lower half
    of the vocabulary."""
    from distkeras_tpu_torch.data import Dataset

    rng = np.random.default_rng(seed)
    lengths = rng.integers(CLS_L // 4, CLS_L + 1, n)
    mask = (np.arange(CLS_L)[None] < lengths[:, None]).astype(np.float32)
    toks = rng.integers(1, CLS_VOCAB, (n, CLS_L)) * mask.astype(np.int64)
    low = np.sum((toks < CLS_VOCAB // 2) * mask, axis=1)
    label = (2 * low > lengths).astype(np.int32)
    return Dataset({"features": toks.astype(np.int32), "mask": mask,
                    "label": label})


def train_classifier(torch):
    """Config 6's encoder classifier at full width (vocab 8192, L 2048,
    dim 512, 8 heads, depth 8, bf16 compute, f32 params) through the flash
    kernels (non-causal, key mask, D=64) under DOWNPOUR with SGD, for
    CLS_WINDOWS windows on ragged rows."""
    from distkeras_tpu_torch.models import transformer_classifier
    from distkeras_tpu_torch.trainers import DOWNPOUR

    spec = transformer_classifier(
        vocab=CLS_VOCAB, maxlen=CLS_L, dim=CLS_DIM, heads=CLS_HEADS,
        depth=CLS_DEPTH, dtype=torch.bfloat16, attn_impl="flash")
    t = DOWNPOUR(spec, loss=LOSS, worker_optimizer="sgd",
                 learning_rate=CLS_LR, features_col=["features", "mask"],
                 num_workers=CLS_W, batch_size=CLS_BATCH,
                 communication_window=CLS_WINDOW, num_epoch=1,
                 log_metrics=True, device=DEVICE)
    t0 = time.perf_counter()
    t.train(classifier_data(CLS_W * CLS_WINDOW * CLS_BATCH * CLS_WINDOWS))
    wall = time.perf_counter() - t0
    losses = t.history.losses()
    if len(losses) != CLS_WINDOWS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"DOWNPOUR classifier: bad losses {losses}")
    m = t.metrics_[-1]
    log("train DOWNPOUR classifier config 6: " + json.dumps(dict(
        wall_s=wall, windows=len(losses), loss_first=losses[0],
        loss_last=losses[-1], samples_per_sec=m["samples_per_sec"],
        window_ms=1e3 * m["wall_time"] / CLS_WINDOWS)))


def serve(torch, model, label):
    """Phases 5/6: the served path — server, 4 concurrent clients."""
    from distkeras_tpu_torch.serving import (
        GenerationClient,
        GenerationEngine,
        GenerationServer,
    )

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, (lp,)).astype(np.int32)
               for lp in PROMPTS]
    engine = GenerationEngine(model, max_batch=8, block_size=BLOCK,
                              device=DEVICE)
    server = GenerationServer(engine, poll_interval=0.01)
    server.start()
    results, errors = {}, []

    def client(i):
        try:
            c = GenerationClient("127.0.0.1", server.port)
            try:
                results[i] = c.generate(prompts[i],
                                        max_new_tokens=NEW_TOKENS)
            finally:
                c.close()
        except Exception as e:  # re-raised below, after the server stops
            errors.append((i, repr(e)))

    try:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        stats = server.stats()
    finally:
        server.stop()
    if errors or len(results) != len(prompts):
        raise AssertionError(f"{label}: clients failed: {errors}")
    for i, toks in results.items():
        if toks.shape != (NEW_TOKENS,) or toks.min() < 0 \
                or toks.max() >= VOCAB:
            raise AssertionError(f"{label}: bad stream {i}: {toks}")
    if stats["completed"] != len(prompts) or stats["blocks_in_use"] != 0:
        raise AssertionError(f"{label}: engine stats {stats}")
    n_tok = NEW_TOKENS * len(prompts)
    log(f"serve {label}: " + json.dumps(dict(
        wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
        steps=stats["steps"], prefills=stats["prefills"],
        mean_batch_occupancy=stats["mean_batch_occupancy"],
        latency=stats["latency"])))
    return prompts, results, wall


def tie_aware_check(torch, model, prompts, results, label):
    """Every emitted token is the argmax of its context up to one bf16 ulp,
    judged by one full forward over prompt + generated tokens.

    A random-init bf16 model ties logits, and the served path (paged decode:
    bf16 attention scores, the decode matmul kernel) and the full forward
    (flash attention in f32, the prefill matmul kernel) round differently,
    so the streams are legitimate greedy decodes that need not match
    bitwise. The logits both paths compare are themselves bf16 (the head's
    output), each rounded by up to half an ulp: a gap of one ulp between the
    unrounded logits reads as up to two ulps between the rounded ones, so
    that is the bound. An emission bug gaps by whole units."""
    worst, off_argmax = 0.0, 0
    for i, p in enumerate(prompts):
        toks = results[i]
        seq = torch.from_numpy(np.concatenate([p, toks[:-1]]).astype(
            np.int64)).to(DEVICE)[None]
        lg = model(seq)[0, len(p) - 1:].float()
        emitted = torch.from_numpy(toks.astype(np.int64)).to(DEVICE)
        mx = lg.max(dim=-1).values
        got = lg.gather(1, emitted[:, None])[:, 0]
        # bf16 ulp at the row max: 2^(exponent - 7)
        ulp = torch.exp2(torch.floor(torch.log2(
            mx.abs().clamp(min=2.0 ** -120))) - 7)
        gap = (mx - got) / ulp
        if not torch.isfinite(lg).all() or bool((gap > 2.0).any()):
            raise AssertionError(
                f"{label}: stream {i} emits a token beyond one bf16 ulp of "
                f"the full-forward argmax: max gap {gap.max().item()} ulp")
        worst = max(worst, gap.max().item())
        off_argmax += int((gap > 0).sum().item())
    log(f"tie-aware check {label}: ok (worst gap {worst:.3f} ulp of the "
        f"rounded logits, {off_argmax} of {NEW_TOKENS * len(prompts)} "
        f"tokens not the exact argmax)")


def _err(got, ref):
    return (got.float() - ref.float()).abs().max().item()


def imdb_leaf_shapes():
    """The stacked [W, …] leaves of the IMDB LSTM at its published width:
    the tree fused Adam sees once per optimizer step."""
    return [(IMDB_W,) + s for s in (
        (IMDB_VOCAB, IMDB_E), (4 * IMDB_H, IMDB_E), (4 * IMDB_H,),
        (IMDB_H, 4 * IMDB_H), (2, IMDB_H), (2,))]


def check_adam(torch, pk):
    """K5 against its plain version at the slice's shapes (f32, one step
    of the 8-worker stack), plus bf16 gradients and misaligned leaves.
    Kernel and plain do the same f32 operations in the same order with
    IEEE sqrt and division: they must agree exactly (tolerance 0)."""
    gen = torch.Generator(device=DEVICE).manual_seed(5)

    def tree(shapes, scale, dtype=torch.float32):
        return [(torch.randn(s, generator=gen, device=DEVICE) * scale)
                .to(dtype) for s in shapes]

    shapes = imdb_leaf_shapes()
    gs, ms = tree(shapes, 1e-2), tree(shapes, 1e-3)
    vs = [v.abs() for v in tree(shapes, 1e-4)]
    cases = [("imdb f32", gs, ms, vs)]
    small = [(3, 1001), (7,), (2, 513)]
    cases.append(("bf16 grads", tree(small, 1e-2, torch.bfloat16),
                  tree(small, 1e-3), [v.abs() for v in tree(small, 1e-4)]))
    odd = [g.reshape(-1)[1:] for g in tree(small, 1e-2)]   # 4-byte aligned
    cases.append(("misaligned", odd, [torch.zeros_like(g) for g in odd],
                  [torch.zeros_like(g) for g in odd]))
    max_err = 0.0
    for label, g_, m_, v_ in cases:
        got = pk.fused_adam_step(g_, m_, v_, 3, IMDB_LR)
        ref = pk.fused_adam_step(g_, m_, v_, 3, IMDB_LR, impl="plain")
        torch.cuda.synchronize()
        err = max(_err(a, b) for outs in zip(got, ref) for a, b in zip(*outs))
        if err != 0.0 or not all(torch.isfinite(u).all() for u in got[2]):
            raise AssertionError(f"fused_adam {label}: max |kernel - plain| "
                                 f"= {err}, expected 0")
        max_err = max(max_err, err)
        log(f"fused_adam {label}: ok")
    k = pk._coefficients(3, IMDB_LR, 0.9, 0.999, 1e-8)
    outs = ([torch.empty_like(m) for m in ms], [torch.empty_like(v)
                                               for v in vs],
            [torch.empty_like(g) for g in gs])
    table = pk._adam_table(gs, ms, vs, *outs)
    kernel_ms = cuda_ms(torch, lambda: pk._adam_launch(table, k))
    call_ms = eager_ms(torch, lambda: pk.fused_adam_step(gs, ms, vs, 3,
                                                         IMDB_LR))
    plain_ms = cuda_ms(torch, lambda: pk.fused_adam_step(
        gs, ms, vs, 3, IMDB_LR, impl="plain"), iters=5)
    params = [torch.zeros_like(g, requires_grad=True) for g in gs]
    for p, g in zip(params, gs):
        p.grad = g.clone()
    lib_opt = torch.optim.Adam(params, lr=IMDB_LR, fused=True)
    library_ms = eager_ms(torch, lib_opt.step)
    n = sum(g.numel() for g in gs)
    row = dict(elements=n, leaves=len(gs), max_abs_err=max_err,
               kernel_ms=kernel_ms, eager_ms=call_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               **bound(24.0 * n, 12.0 * n, PEAK_F32))
    log("fused_adam " + json.dumps(row))
    del lib_opt, params
    return [row], max_err


def check_lstm(torch, rec):
    """K6 and K7 against their plain versions at the slice's shape (bf16,
    G=8 workers, B=64, T=200, H=128), at the parameter-server path's (G=1:
    each worker thread launches alone; its row names the launch plan) and
    at small cases: B=20, B=17 and
    B=33 are not multiples of the 16-row tile, T=1 and T=2 the edges of
    the scans' prefetch rings (K6's cluster scan at H 32, 64 and 128, and
    K7's backward), T=70 a ragged last chunk of the tensor-core dwh
    product (H=64, bf16), H=144 (bf16) and H=256 (f32) the scans whose
    staged step inputs do not fit in shared memory (and the forward's
    per-block scan). Every case also runs the forward without saving the
    cell states (the eval path's launch): the same hs bits, no cs. The
    ``lstm_forward`` rows name the launch (cluster size, rows, blocks).
    Tolerance: bf16 kernel and plain round the same f32 values to bf16
    each step, and a one-ulp flip of h feeds the next steps, so outputs
    agree to 2^-6 of the plain output's largest magnitude (two bf16 ulps);
    f32 to 1e-5 of it (summation order only). K7 is deterministic: a
    second launch gives the same bits. At the two training shapes K7's two
    launches, the reverse scan and the dwh product, are also timed apart
    (``scan_ms``, ``dwh_ms``)."""
    import torch.nn as nn

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(IMDB_W, IMDB_BATCH, IMDB_T, IMDB_H, bf),
             # the parameter-server path: each worker launches alone (G=1)
             (1, IMDB_BATCH, IMDB_T, IMDB_H, bf),
             (2, 20, 7, 32, f32), (2, 20, 7, 32, bf), (2, 17, 70, 64, bf),
             (2, 17, 2, 64, bf), (3, 17, 1, 64, bf), (2, 17, 2, 32, f32),
             # the cluster scan's edges at the IMDB width: one step, two
             # steps, and a third 16-row group holding one row
             (1, 17, 1, 128, bf), (2, 33, 2, 128, bf),
             # the scans whose staged inputs do not fit in shared memory
             # (step inputs read in the step), the tensor-core and the FMA
             # paths, and the FMA dwh for bf16 at H not a multiple of 64;
             # neither takes the forward's cluster scan
             (1, 17, 3, 144, bf), (1, 17, 3, 256, f32)]
    fwd_rows, bwd_rows, max_err = [], [], 0.0
    for G, B, T, H, dt in cases:
        gx = (torch.randn((G, B, T, 4 * H), generator=gen, device=DEVICE)
              * 0.5).to(dt)
        wh = torch.randn((G, H, 4 * H), generator=gen, device=DEVICE) \
            / H ** 0.5
        dhs = torch.randn((G, B, T, H), generator=gen, device=DEVICE).to(dt)
        launch = rec.forward_launch(gx)
        hs, cs = rec.lstm_forward(gx, wh, True)
        hp, cp = rec.lstm_forward(gx, wh, True, impl="plain")
        # the eval path's launch: no cell states saved, the same hs
        hn, cn = rec.lstm_forward(gx, wh, False)
        dgx, dwh = rec.lstm_backward(gx, wh, hs, cs, dhs)
        dgx2, dwh2 = rec.lstm_backward(gx, wh, hs, cs, dhs)
        dgp, dwp = rec.lstm_backward(gx, wh, hp, cp, dhs, impl="plain")
        torch.cuda.synchronize()
        label = f"G={G} B={B} T={T} H={H} {str(dt).split('.')[-1]}"
        if not (torch.equal(dgx, dgx2) and torch.equal(dwh, dwh2)):
            raise AssertionError(f"lstm {label}: two backward launches "
                                 f"differ (K7 must be deterministic)")
        if cn.numel() != 0 or not torch.equal(hn, hs):
            raise AssertionError(f"lstm {label}: the forward without cell "
                                 f"states gives other hs")
        rel = 2.0 ** -6 if dt == bf else 1e-5
        errs = {}
        for name, got, ref in (("hs", hs, hp), ("hs_no_cells", hn, hp),
                               ("cs", cs, cp),
                               ("dgx", dgx, dgp), ("dwh", dwh, dwp)):
            errs[name] = _err(got, ref)
            scale = ref.float().abs().max().item()
            if not (errs[name] <= rel * scale
                    and torch.isfinite(got.float()).all()):
                raise AssertionError(
                    f"lstm {label} {name}: max |kernel - plain| = "
                    f"{errs[name]} beyond {rel} x {scale}")
        max_err = max(max_err, errs["hs"], errs["dgx"])
        log(f"lstm {label}: ok " + json.dumps(dict(errs, forward=launch)))
        if (B, T, H) != (IMDB_BATCH, IMDB_T, IMDB_H) or G not in (IMDB_W, 1):
            continue
        path = "collective" if G == IMDB_W else "ps"
        esz = 2 if dt == torch.bfloat16 else 4
        seq, gates, wbytes = G * B * T * H, G * B * T * 4 * H, G * H * 4 * H
        mac = 2.0 * G * B * T * H * 4 * H
        lstm_lib = nn.LSTM(H, H, batch_first=True, device=DEVICE, dtype=dt)
        lstm_lib.flatten_parameters()
        x = torch.randn((G * B, T, H), generator=gen, device=DEVICE).to(dt)
        with torch.no_grad():
            lib_fwd = eager_ms(torch, lambda: lstm_lib(x), iters=10)
        xr = x.clone().requires_grad_()
        out = lstm_lib(xr)[0]
        dout = torch.randn_like(out)
        lib_bwd = eager_ms(torch, lambda: torch.autograd.grad(
            out, [xr, *lstm_lib.parameters()], dout, retain_graph=True),
            iters=10)
        fwd_rows.append(dict(
            path=path, G=G, B=B, T=T, H=H, dtype=str(dt).split(".")[-1],
            launch=launch,
            max_abs_err=max(errs["hs"], errs["hs_no_cells"], errs["cs"]),
            kernel_ms=cuda_ms(torch, lambda: rec.lstm_forward(gx, wh, True),
                              iters=5),
            kernel_no_cells_ms=cuda_ms(torch, lambda: rec.lstm_forward(
                gx, wh, False), iters=5),
            eager_ms=eager_ms(torch, lambda: rec.lstm_forward(gx, wh, True),
                              iters=5),
            plain_ms=cuda_ms(torch, lambda: rec.lstm_forward(
                gx, wh, True, impl="plain"), iters=1, replays=2),
            library_ms=lib_fwd,
            **bound(gates * esz + wbytes * 4 + 2 * seq * esz, mac,
                    PEAK_BF16)))
        log("lstm_forward " + json.dumps(fwd_rows[-1]))
        dgx_, dwh_ = torch.empty_like(dgx), torch.empty_like(dwh)
        bwd_rows.append(dict(
            path=path, G=G, B=B, T=T, H=H, dtype=str(dt).split(".")[-1],
            max_abs_err=max(errs["dgx"], errs["dwh"]),
            kernel_ms=cuda_ms(torch, lambda: rec.lstm_backward(
                gx, wh, hs, cs, dhs), iters=5),
            scan_ms=cuda_ms(torch, lambda: rec._lstm_bwd_into(
                dgx_, dwh_, gx, wh, hs, cs, dhs, parts=1), iters=5),
            dwh_ms=cuda_ms(torch, lambda: rec._lstm_bwd_into(
                dgx_, dwh_, gx, wh, hs, cs, dhs, parts=2), iters=5),
            eager_ms=eager_ms(torch, lambda: rec.lstm_backward(
                gx, wh, hs, cs, dhs), iters=5),
            plain_ms=cuda_ms(torch, lambda: rec.lstm_backward(
                gx, wh, hs, cs, dhs, impl="plain"), iters=1, replays=2),
            library_ms=lib_bwd,
            **bound(2 * gates * esz + 3 * seq * esz + wbytes * 4
                    + wbytes * 4, 3.0 * mac, PEAK_BF16)))
        log("lstm_backward " + json.dumps(bwd_rows[-1]))
        del lstm_lib, x, xr, out, dout, dgx_, dwh_
    return fwd_rows, bwd_rows, max_err


def imdb_data():
    from distkeras_tpu_torch.datasets import imdb

    n = IMDB_W * IMDB_WINDOW * IMDB_BATCH * IMDB_WINDOWS
    return imdb(n_train=n, n_test=64, vocab=IMDB_VOCAB, maxlen=IMDB_T)


def compare_window(torch, train):
    """One DynSGD window at full width through the kernels and, from the
    same init on the same superbatch, through their plain versions on the
    card. bf16 forward and backward round at different places in the two,
    so gradients differ by bf16 noise. Adam's first steps move an element
    by at most ~lr (1.01 lr over four steps at b1=0.9, b2=0.999) whatever
    its gradient's size, and a noise-level gradient may take either sign:
    a worker's element can part by 2 lr per step, and the DynSGD fold sums
    the W workers' displacements with weights 1/(i+1). So centers agree
    to 2.02 lr · window · sum 1/(i+1); the mean loss to 1e-2."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.ops.pallas_kernels import fused_adam
    from distkeras_tpu_torch.ops.losses import get_loss
    from distkeras_tpu_torch.parallel import DynSGDMerge, LocalSGDEngine
    from distkeras_tpu_torch.trainers import _make_loss_step

    batch = next(train.superbatches(IMDB_W, IMDB_BATCH, IMDB_WINDOW,
                                    ["features", "mask", "label"]))
    loss_fn = get_loss("sparse_softmax_cross_entropy")
    out = {}
    for impl in ("kernel", "plain"):
        spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T,
                               embed_dim=IMDB_E, hidden_dim=IMDB_H,
                               scan_impl=impl)
        engine = LocalSGDEngine(
            spec, _make_loss_step(spec, loss_fn, 2),
            fused_adam(IMDB_LR, impl=impl), DynSGDMerge(), device=DEVICE,
            num_workers=IMDB_W, window=IMDB_WINDOW, batch_size=IMDB_BATCH)
        params, nt = spec.init(0)
        state, loss = engine.run_window(engine.init_state(params, nt), batch)
        out[impl] = (state.center, loss.item())
    (ck, lk), (cp, lp) = out["kernel"], out["plain"]
    diff = max(_err(ck[k], cp[k]) for k in ck)
    mean = max((ck[k] - cp[k]).abs().mean().item() for k in ck)
    limit = 2.02 * IMDB_LR * IMDB_WINDOW * sum(
        1.0 / (i + 1) for i in range(IMDB_W))
    if not (diff <= limit and abs(lk - lp) <= 1e-2
            and all(torch.isfinite(v).all() for v in ck.values())):
        raise AssertionError(
            f"DynSGD window kernel vs plain: max |center diff| {diff} "
            f"(limit {limit}), loss {lk} vs {lp}")
    log("window kernels vs plain: " + json.dumps(dict(
        max_center_diff=diff, max_mean_center_diff=mean, limit=limit,
        loss_kernel=lk, loss_plain=lp)))
    return diff


def train_dynsgd(torch, train, test):
    """The slice's main path: DynSGD on the full-width IMDB LSTM with
    fused Adam (BASELINE config 5), two epochs of IMDB_WINDOWS windows on
    the synthetic IMDB stand-in, random init from seed 0. Returns the
    phase's record; the caller reads the launch counters around it."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DynSGD

    spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T, embed_dim=IMDB_E,
                           hidden_dim=IMDB_H)
    t = DynSGD(spec, loss="sparse_softmax_cross_entropy",
               worker_optimizer="fused_adam", learning_rate=IMDB_LR,
               features_col=["features", "mask"], num_workers=IMDB_W,
               batch_size=IMDB_BATCH, communication_window=IMDB_WINDOW,
               num_epoch=2, log_metrics=True, device=DEVICE)
    t0 = time.perf_counter()
    center = t.train(train)
    wall = time.perf_counter() - t0
    losses = t.history.losses()
    if len(losses) != 2 * IMDB_WINDOWS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"DynSGD: bad loss history {losses}")
    if not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"DynSGD: the loss did not fall: {losses}")
    # the trained center through the eval path (no autograd: the forward
    # kernel without saved cell states) against the plain-torch reference
    toks = torch.from_numpy(test["features"][:64]).to(DEVICE)
    mask = torch.from_numpy(test["mask"][:64]).to(DEVICE)
    params = {k: v.to(DEVICE) for k, v in center.items()}
    ref_spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T,
                               embed_dim=IMDB_E, hidden_dim=IMDB_H,
                               scan_impl="reference")
    with torch.no_grad():
        got, _ = spec.apply(params, {}, (toks, mask), False)
        ref, _ = ref_spec.apply(params, {}, (toks, mask), False)
    eval_err = _err(got, ref)
    if got.shape != (64, 2) or not torch.isfinite(got).all() \
            or eval_err > 0.05 * max(1.0, ref.abs().max().item()):
        raise AssertionError(f"DynSGD eval: logits off the reference by "
                             f"{eval_err}")
    acc = float((got.argmax(-1).cpu().numpy() == test["label"][:64]).mean())
    epochs = [m for m in t.metrics_ if "samples_per_sec" in m]
    rec = dict(wall_s=wall, windows=len(losses),
               rows_per_window=IMDB_W * IMDB_WINDOW * IMDB_BATCH,
               loss_first=losses[0], loss_last=losses[-1],
               eval_logit_err_vs_reference=eval_err, eval_accuracy_64=acc,
               epochs=[dict(epoch=m["epoch"],
                            samples_per_sec=m["samples_per_sec"],
                            window_ms=1e3 * m["wall_time"] / IMDB_WINDOWS)
                       for m in epochs])
    log("train DynSGD imdb_lstm: " + json.dumps(rec))
    return rec


def train_adag_lenet(torch):
    """The flagship beside the main path: LeNet under ADAG (BASELINE
    config 2) on the synthetic MNIST stand-in, 8 stacked workers, held to
    the JAX package's own accuracy gate for it (test accuracy > 0.95, the
    verify recipe's)."""
    from distkeras_tpu_torch.datasets import mnist
    from distkeras_tpu_torch.models import lenet
    from distkeras_tpu_torch.ops.metrics import accuracy
    from distkeras_tpu_torch.trainers import ADAG

    train, test = mnist(n_train=32768, n_test=1024)
    spec = lenet()
    t = ADAG(spec, loss="sparse_softmax_cross_entropy",
             worker_optimizer="adam", learning_rate=1e-3, num_workers=8,
             batch_size=128, communication_window=4, num_epoch=2,
             device=DEVICE)
    t0 = time.perf_counter()
    center = t.train(train, shuffle=True)
    wall = time.perf_counter() - t0
    params = {k: v.to(DEVICE) for k, v in center.items()}
    with torch.no_grad():
        out, _ = spec.apply(params, {}, torch.from_numpy(
            test["features"]).to(DEVICE), False)
    acc = accuracy(torch.from_numpy(test["label"]).to(DEVICE), out).item()
    losses = t.history.losses()
    log("train ADAG lenet: " + json.dumps(dict(
        wall_s=wall, windows=len(losses), loss_first=losses[0],
        loss_last=losses[-1], test_accuracy=acc)))
    if not acc > 0.95:
        raise AssertionError(f"ADAG lenet: test accuracy {acc} <= 0.95")


def _ps_launch_counters():
    """Every kernel wrapper's launch counter, by its kernels-line name."""
    from distkeras_tpu_torch.ops import flash_attention as fa
    from distkeras_tpu_torch.ops import pallas_kernels as pk
    from distkeras_tpu_torch.ops import quant
    from distkeras_tpu_torch.ops import recurrent as rec

    return {"q_matmul": (quant.q_matmul, "launches"),
            "q_matmul_prefill": (quant.q_matmul, "prefill_launches"),
            "flash_attention": (fa._fa_forward, "launches"),
            "flash_attention_bwd_dq": (fa._fa_bwd_dq, "launches"),
            "flash_attention_bwd_dkv": (fa._fa_bwd_dkv, "launches"),
            "fused_adam": (pk.fused_adam_step, "launches"),
            "lstm_forward": (rec.lstm_forward, "launches"),
            "lstm_backward": (rec.lstm_backward, "launches")}


def counted(run):
    """Run ``run()`` with every launch counter set to 0 just before and
    read just after: ``(run's result, {kernel: launches})``."""
    counters = _ps_launch_counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    out = run()
    return out, {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def _phase_summary(phases):
    return {k: dict(count=v["count"], mean_ms=v["mean_ms"],
                    max_ms=v["max_ms"], total_ms=v["total_ms"])
            for k, v in phases.items()}


def _worker_loss_fell(history, workers, epochs):
    """Each epoch's mean window loss over every worker: the last epoch's
    must be below the first's."""
    by_epoch = [[r["loss"] for r in history if r.get("epoch") == e
                 and "loss" in r] for e in range(epochs)]
    means = [float(np.mean(v)) for v in by_epoch]
    ok = (all(len(v) > 0 for v in by_epoch) and means[-1] < means[0]
          and all(np.isfinite(means)))
    return ok, means


@contextlib.contextmanager
def _servers_built(module, name: str):
    """Record every parameter server the class ``module.name`` builds
    inside the block (the trainer starts its own; this reads its
    ``stats()`` and τ after the run)."""
    cls = getattr(module, name)
    made = []

    class Recording(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    setattr(module, name, Recording)
    try:
        yield made
    finally:
        setattr(module, name, cls)


class _NativeTaus:
    """τ of every native exchange, from the versions the C++ server
    returns: a pull and an exchange answer with the center version they
    recorded (an exchange's is its post-fold version), so an exchange
    folded at ``v`` was priced ``τ = v − 1 − pv``, ``pv`` the version of
    the worker's latest record before it, or of the one before that for
    an exchange with the lag flag (``native_ps._XCHG_LAG``). Stands in
    for ``native_ps.load_dkps`` over the block."""

    def __init__(self, native_ps):
        self._mod = native_ps
        self._load = native_ps.load_dkps
        self._lib = None
        self._records: dict = {}
        self.taus: list[int] = []

    def __enter__(self):
        self._lib = self._load()
        self._mod.load_dkps = lambda: self
        return self

    def __exit__(self, *exc):
        self._mod.load_dkps = self._load

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def dkps_client_pull(self, handle, out):
        v = self._lib.dkps_client_pull(handle, out)
        if v >= 0:
            self._records.setdefault(handle, []).append(v)
        return v

    def dkps_client_exchange(self, handle, flags, *args):
        v = self._lib.dkps_client_exchange(handle, flags, *args)
        rec = self._records.setdefault(handle, [])
        if v >= 0 and rec:
            lag = flags & self._mod._XCHG_LAG and len(rec) >= 2
            self.taus.append(int(v - 1 - rec[-2 if lag else -1]))
            rec.append(v)
        return v


def _staleness(taus) -> dict:
    return dict(max=max(taus, default=0),
                mean=float(np.mean(taus)) if taus else 0.0,
                count=len(taus),
                histogram={str(k): taus.count(k) for k in sorted(set(taus))})


def _each_worker_loss_fell(history, workers, epochs):
    """Per worker: its last epoch's mean window loss below its first's."""
    out = []
    for w in range(workers):
        means = [np.mean([r["loss"] for r in history
                          if r.get("worker") == w and r.get("epoch") == e])
                 for e in (0, epochs - 1)]
        out.append(bool(np.all(np.isfinite(means)) and means[1] < means[0]))
    return out


def run_ps_vgg(torch, window: int, lr: float, batch: int, windows: int,
               device: str, transport: str = "socket", depth: int = 0,
               epochs: int = PS3_EPOCHS) -> dict:
    """Config 3 (bench.py:316-324: CIFAR-10 VGG-small under DOWNPOUR,
    the stale-gradient PS) through ``transport`` at ``ps_pipeline_depth``
    ``depth``. On the socket transport a ``SocketParameterServer`` started
    here, the trainer's PS3_W worker threads pointed at it
    (``ps_host``/``ps_port``); on ``"native"`` and ``"shm"`` the trainer's
    own server, recorded as it is built (``_servers_built``). Either way
    the server's ``stats()`` and τ are read after the run (τ from
    ``recent_staleness()``, or on native from the versions the server
    returns: ``_NativeTaus``). ``vgg_small()`` in bf16 with f32 params on
    the synthetic CIFAR-10 stand-in, fused Adam at ``lr``, ``epochs``
    epochs of ``windows`` windows of ``window`` steps of ``batch`` rows a
    worker; then held-out accuracy (``ModelPredictor`` +
    ``AccuracyEvaluator``) on PS3_TEST rows. Returns the run's record.
    (``ps_sweep.py`` runs this path at other windows and rates, in either
    package.)"""
    from distkeras_tpu_torch.datasets import cifar10
    from distkeras_tpu_torch.evaluators import AccuracyEvaluator
    from distkeras_tpu_torch.models import vgg_small
    from distkeras_tpu_torch.parallel.merge_rules import DownpourMerge
    from distkeras_tpu_torch.parameter_servers import SocketParameterServer
    from distkeras_tpu_torch.predictors import ModelPredictor
    from distkeras_tpu_torch.trainers import DOWNPOUR

    rows = PS3_W * batch * window * windows
    train, test = cifar10(n_train=rows, n_test=PS3_TEST)
    spec = vgg_small()
    kw = dict(loss=LOSS, worker_optimizer="fused_adam", learning_rate=lr,
              num_workers=PS3_W, batch_size=batch,
              communication_window=window, num_epoch=epochs,
              backend="ps", ps_transport=transport,
              ps_pipeline_depth=depth, device=device)
    if transport == "socket":
        init, _ = spec.init_np(0)
        server = SocketParameterServer(init, DownpourMerge(), PS3_W)
        server.initialize()
        server.start()
        try:
            t = DOWNPOUR(spec, ps_host="127.0.0.1", ps_port=server.port,
                         **kw)
            t0 = time.perf_counter()
            center = t.train(train, shuffle=True)
            wall = time.perf_counter() - t0
            stats = server.stats()
            taus = server.recent_staleness()
        finally:
            server.stop()
    else:
        t = DOWNPOUR(spec, **kw)
        t0 = time.perf_counter()
        center, servers, taus = _train_recording(t, train, True, transport)
        wall = time.perf_counter() - t0
        stats = t.ps_stats_
    t1 = time.perf_counter()
    acc = AccuracyEvaluator().evaluate(ModelPredictor(
        spec, center, device=device).predict(test))
    eval_s = time.perf_counter() - t1
    commits = PS3_W * windows * epochs
    fell, means = _worker_loss_fell(t.history, PS3_W, epochs)
    return dict(transport=transport, pipeline_depth=depth, window=window,
                lr=lr, batch=batch, epochs=epochs,
                windows_a_worker_an_epoch=windows, wall_s=wall,
                eval_s=eval_s, expected_commits=commits,
                commits=stats["commits"], num_updates=stats["num_updates"],
                bytes_in=stats["bytes_in"], bytes_out=stats["bytes_out"],
                center_lock_mean_hold_ns=stats["center_lock_mean_hold_ns"],
                staleness=_staleness(taus),
                loss_fell=fell, epoch_mean_loss=means,
                worker_loss_fell=_each_worker_loss_fell(t.history, PS3_W,
                                                        epochs),
                test_accuracy=acc,
                window_wall_ms=1e3 * wall / (commits / PS3_W),
                exchange_phases=_phase_summary(t.exchange_phases_))


def _train_recording(t, ds, shuffle: bool, transport: str):
    """``t.train(ds)`` on the trainer's own ``transport`` server, recorded
    as it is built: ``(center, [server], τ of every commit)``."""
    import distkeras_tpu_torch.workers as workers

    if transport == "native":
        from distkeras_tpu_torch import native_ps as module

        name = "NativeSocketParameterServer"
    elif transport == "shm":
        from distkeras_tpu_torch import shm as module

        name = "ShmParameterServer"
    else:
        module, name = workers, "ParameterServer"
    with contextlib.ExitStack() as stack:
        servers = stack.enter_context(_servers_built(module, name))
        tap = (stack.enter_context(_NativeTaus(module))
               if transport == "native" else None)
        center = t.train(ds, shuffle=shuffle)
    if len(servers) != 1:
        raise AssertionError(f"{transport}: {len(servers)} servers built")
    taus = tap.taus if tap is not None else servers[0].recent_staleness()
    return center, servers, taus


def train_ps_vgg(torch):
    """Config 3 at PS3_WINDOW, PS3_LR, PS3_BATCH and PS3_WINDOWS through a
    socket PS (``run_ps_vgg``). Returns the run's record; its gates are
    read by ``ps3_failures`` after the ``kernels`` line."""
    rec = run_ps_vgg(torch, PS3_WINDOW, PS3_LR, PS3_BATCH, PS3_WINDOWS,
                     DEVICE)
    log("train DOWNPOUR vgg_small via the socket PS: " + json.dumps(rec))
    return rec


def ps3_failures(name: str, rec: dict, launches: dict,
                 each_worker: bool) -> list:
    """Config 3's gates on one run, as messages (empty when it passed):
    one commit and one fold a window a worker; K5 once a step; some commit
    priced τ ≥ 1 (the run was asynchronous); the loss falls (with
    ``each_worker``, every worker's own too); held-out accuracy above
    PS3_ACC_BAR."""
    out = []
    commits = rec["expected_commits"]
    k5 = PS3_W * rec["windows_a_worker_an_epoch"] * rec["window"] \
        * rec["epochs"]
    if rec["commits"] != commits or rec["num_updates"] != commits:
        out.append(f"{name}: {rec['commits']} commits and "
                   f"{rec['num_updates']} folds, expected {commits}")
    if launches["fused_adam"] != k5:
        out.append(f"{name}: K5 launched {launches['fused_adam']} times, "
                   f"expected {k5}")
    if not rec["staleness"]["max"] >= 1:
        out.append(f"{name}: no commit was stale ({rec['staleness']}): "
                   f"the run was not asynchronous")
    if not (rec["loss_fell"]
            and (all(rec["worker_loss_fell"]) or not each_worker)):
        out.append(f"{name}: the loss did not fall: "
                   f"{rec['epoch_mean_loss']}, by worker "
                   f"{rec['worker_loss_fell']}")
    if not rec["test_accuracy"] > PS3_ACC_BAR:
        out.append(f"{name}: held-out accuracy {rec['test_accuracy']} <= "
                   f"{PS3_ACC_BAR}")
    return out


def run_ps_lstm(torch, train, transport: str, depth: int) -> dict:
    """Config 5 (the IMDB LSTM at full width, bf16 compute, f32 params)
    under DynSGD through the trainer's own ``transport`` server at
    ``ps_pipeline_depth`` ``depth``: PS5_W worker threads of batch
    IMDB_BATCH, window IMDB_WINDOW, fused Adam, PS5_EPOCHS epochs of
    PS5_WINDOWS windows a worker, unshuffled. Gates: one commit and one
    fold a window a worker; the loss falls. Returns the run's record (τ
    of every commit included); the caller reads K5, K6 and K7."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DynSGD

    rows = PS5_W * IMDB_BATCH * IMDB_WINDOW * PS5_WINDOWS
    ds = train.gather(np.arange(rows))
    spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T, embed_dim=IMDB_E,
                           hidden_dim=IMDB_H)
    t = DynSGD(spec, loss=LOSS, worker_optimizer="fused_adam",
               learning_rate=IMDB_LR, features_col=["features", "mask"],
               num_workers=PS5_W, batch_size=IMDB_BATCH,
               communication_window=IMDB_WINDOW, num_epoch=PS5_EPOCHS,
               backend="ps", ps_transport=transport,
               ps_pipeline_depth=depth, device=DEVICE)
    t0 = time.perf_counter()
    _, _, taus = _train_recording(t, ds, False, transport)
    wall = time.perf_counter() - t0
    stats = t.ps_stats_
    commits = PS5_W * PS5_WINDOWS * PS5_EPOCHS
    fell, means = _worker_loss_fell(t.history, PS5_W, PS5_EPOCHS)
    rec = dict(transport=transport, pipeline_depth=depth, wall_s=wall,
               commits=stats["commits"], num_updates=stats["num_updates"],
               batched_folds=stats["batched_folds"],
               center_lock_mean_hold_ns=stats["center_lock_mean_hold_ns"],
               staleness=_staleness(taus), epoch_mean_loss=means,
               window_wall_ms=1e3 * wall / (commits / PS5_W),
               exchange_phases=_phase_summary(stats["exchange_phases"]))
    label = f"{transport} PS at depth {depth}"
    log(f"train DynSGD imdb_lstm via the {label}: " + json.dumps(rec))
    if stats["commits"] != commits or stats["num_updates"] != commits:
        raise AssertionError(f"{label}: {stats['commits']} commits and "
                             f"{stats['num_updates']} folds, expected "
                             f"{commits}")
    if not fell:
        raise AssertionError(f"{label}: the loss did not fall: {means}")
    return rec


def train_ps_lstm(torch, train):
    """Config 5 through the in-process PS, serially (``run_ps_lstm``)."""
    return run_ps_lstm(torch, train, "inprocess", 0)


def train_ps_lstm_native_pipelined(torch, train, serial):
    """Config 5 through the native PS at depth 1 (``run_ps_lstm``). Gate:
    some commit was priced τ ≥ 1. Prints its τ beside ``serial``'s (the
    in-process run's); timing moves τ from run to run, so the strict
    check that ``lag`` prices from the previous pull is the CPU test's."""
    rec = run_ps_lstm(torch, train, "native", 1)
    log("config 5 staleness, native pipelined vs in-process serial: "
        + json.dumps(dict(native_pipelined=rec["staleness"],
                          inprocess_serial=serial["staleness"])))
    if not rec["staleness"]["max"] >= 1:
        raise AssertionError(f"native pipelined PS: no commit was priced "
                             f"τ >= 1 ({rec['staleness']})")
    return rec


def train_ps_vgg_transports(torch):
    """Config 3 at PS3_WINDOW, PS3_BATCH and PS3_WINDOWS through the native
    transport serially (PS3_LR, PS3_EPOCHS, as ``train_ps_vgg`` runs it)
    and pipelined, and through shm pipelined (both at PS3_PIPE_LR for
    PS3_PIPE_EPOCHS: the same rate times steps, and about the same rate
    times τ, since pipelining doubles τ), each counted alone
    (``counted``). Returns ``{run: (record, launches)}``;
    ``ps3_failures`` reads each run's gates (every worker's loss falls
    among them) after the ``kernels`` line."""
    out = {}
    for transport, depth in (("native", 0), ("native", 1), ("shm", 1)):
        name = f"config3_{transport}" + ("_pipelined" if depth else "")
        lr, epochs = ((PS3_PIPE_LR, PS3_PIPE_EPOCHS) if depth
                      else (PS3_LR, PS3_EPOCHS))
        out[name] = counted(lambda: run_ps_vgg(
            torch, PS3_WINDOW, lr, PS3_BATCH, PS3_WINDOWS, DEVICE,
            transport=transport, depth=depth, epochs=epochs))
        log(f"train DOWNPOUR vgg_small via the {transport} PS at depth "
            f"{depth}: " + json.dumps(out[name][0]))
        log(f"launches on the {name} path: {json.dumps(out[name][1])}")
    return out


def compare_ps_pipeline(torch, train):
    """One DOWNPOUR worker on config 5 through the kernels over the
    native transport, serially and then at depth 1, from the same init on
    the same PS_PIPE_WINDOWS windows, unshuffled. The JAX package pins the
    two to the same bits (one worker's deferred re-base telescopes:
    ``C_N = C_{N-1} + sent_N`` at fold scale 1); on the card the two runs
    may part where a kernel's sums are not run-to-run deterministic (the
    embedding's backward adds its rows with atomics). The centers are held
    to ``compare_ps_window``'s bound and displacement check; the largest
    difference is printed."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DOWNPOUR

    rows = IMDB_BATCH * IMDB_WINDOW * PS_PIPE_WINDOWS
    ds = train.gather(np.arange(rows))
    out = {}
    for depth in (0, 1):
        spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T,
                               embed_dim=IMDB_E, hidden_dim=IMDB_H)
        t = DOWNPOUR(spec, loss=LOSS, worker_optimizer="fused_adam",
                     learning_rate=IMDB_LR,
                     features_col=["features", "mask"], num_workers=1,
                     batch_size=IMDB_BATCH, communication_window=IMDB_WINDOW,
                     num_epoch=1, backend="ps", ps_transport="native",
                     ps_pipeline_depth=depth, device=DEVICE)
        out[depth] = (t.train(ds), t.history.losses())
        init = spec.init_np(t.seed)[0]
    (c0, l0), (c1, l1) = out[0], out[1]
    diff = max(_err(c1[k], c0[k]) for k in c0)
    bits_equal = all(torch.equal(c1[k], c0[k]) for k in c0)
    limit = 2.02 * IMDB_LR * IMDB_WINDOW * PS_PIPE_WINDOWS
    disp, moved = {}, {}
    for k in c0:
        i0 = torch.as_tensor(init[k], dtype=torch.float32)
        d0, d1 = c0[k].float() - i0, c1[k].float() - i0
        moved[k] = d0.norm().item()
        disp[k] = (d1 - d0).norm().item() / max(moved[k], 1e-30)
    rec = dict(max_center_diff=diff, bits_equal=bits_equal, limit=limit,
               max_displacement_rel_diff=max(disp.values()),
               displacement_limit=PS_DISP_FRAC, losses_serial=l0,
               losses_pipelined=l1)
    log("one-worker native PS serial vs pipelined: " + json.dumps(rec))
    if not (diff <= limit and len(l1) == len(l0) == PS_PIPE_WINDOWS
            and all(v <= PS_DISP_FRAC for v in disp.values())
            and all(v > 0 for v in moved.values())
            and all(torch.isfinite(v).all() for v in c1.values())):
        raise AssertionError(f"one-worker native PS serial vs pipelined: "
                             f"max |center diff| {diff} (limit {limit}), "
                             f"displacement parts by {disp}, serial "
                             f"displacement {moved}, losses {l0} vs {l1}")
    return rec


def compare_ps_window(torch, train):
    """One worker through the in-process PS (DynSGD, the IMDB LSTM at full
    width, PS_PARITY_WINDOWS windows, unshuffled) through the kernels and,
    from the same init on the same rows, through every kernel's plain
    version. The bound is ``compare_window``'s for the Adam steps taken:
    2.02 lr a step (W=1, τ=0: the center is the worker's own sum). That
    bound is about twice the furthest Adam can move an element, so it
    cannot catch a kernel that yields no gradient or a wrong one: each
    leaf's displacement from the init must also match the plain run's,
    ``|Δkernel − Δplain| <= PS_DISP_FRAC |Δplain|`` (L2 norms; a plain bf16
    run against a plain f32 one parts by 4.1% at most on the CPU), and
    the plain run must have moved every leaf."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.ops.pallas_kernels import fused_adam
    from distkeras_tpu_torch.trainers import DynSGD

    rows = IMDB_BATCH * IMDB_WINDOW * PS_PARITY_WINDOWS
    ds = train.gather(np.arange(rows))
    out = {}
    for impl in ("kernel", "plain"):
        spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T,
                               embed_dim=IMDB_E, hidden_dim=IMDB_H,
                               scan_impl=impl)
        t = DynSGD(spec, loss=LOSS, worker_optimizer=fused_adam(
                       IMDB_LR, impl=impl), learning_rate=IMDB_LR,
                   features_col=["features", "mask"], num_workers=1,
                   batch_size=IMDB_BATCH, communication_window=IMDB_WINDOW,
                   num_epoch=1, backend="ps", device=DEVICE)
        out[impl] = (t.train(ds), t.history.losses())
        init = spec.init_np(t.seed)[0]   # the run's init, both impls alike
    (ck, lk), (cp, lp) = out["kernel"], out["plain"]
    diff = max(_err(ck[k], cp[k]) for k in ck)
    limit = 2.02 * IMDB_LR * IMDB_WINDOW * PS_PARITY_WINDOWS
    loss_diff = max(abs(a - b) for a, b in zip(lk, lp))
    disp, moved = {}, {}
    for k in ck:
        i0 = torch.as_tensor(init[k], dtype=torch.float32)
        dp, dk = cp[k].float() - i0, ck[k].float() - i0
        moved[k] = dp.norm().item()
        disp[k] = (dk - dp).norm().item() / max(moved[k], 1e-30)
    rec = dict(max_center_diff=diff, limit=limit,
               max_displacement_rel_diff=max(disp.values()),
               displacement_rel_diff=disp, displacement_limit=PS_DISP_FRAC,
               losses_kernel=lk, losses_plain=lp)
    log("one-worker PS window kernels vs plain: " + json.dumps(rec))
    if not (diff <= limit and len(lk) == PS_PARITY_WINDOWS
            and loss_diff <= 1e-2
            and all(v <= PS_DISP_FRAC for v in disp.values())
            and all(v > 0 for v in moved.values())
            and all(torch.isfinite(v).all() for v in ck.values())):
        raise AssertionError(f"one-worker PS kernels vs plain: max |center "
                             f"diff| {diff} (limit {limit}), displacement "
                             f"parts by {disp} (limit {PS_DISP_FRAC}), plain "
                             f"displacement {moved}, losses {lk} vs {lp}")
    return rec


def _config5(transport: str, **kw):
    """Config 5 as ``run_ps_lstm`` runs it (PS5_W workers of batch
    IMDB_BATCH, window IMDB_WINDOW, fused Adam, PS5_EPOCHS epochs of
    PS5_WINDOWS windows) on ``transport`` with the resilience ``kw``:
    ``(trainer, its rows)``."""
    from distkeras_tpu_torch.models import lstm_classifier
    from distkeras_tpu_torch.trainers import DynSGD

    spec = lstm_classifier(vocab=IMDB_VOCAB, maxlen=IMDB_T, embed_dim=IMDB_E,
                           hidden_dim=IMDB_H)
    t = DynSGD(spec, loss=LOSS, worker_optimizer="fused_adam",
               learning_rate=IMDB_LR, features_col=["features", "mask"],
               num_workers=PS5_W, batch_size=IMDB_BATCH,
               communication_window=IMDB_WINDOW, num_epoch=PS5_EPOCHS,
               backend="ps", ps_transport=transport, device=DEVICE, **kw)
    return t, PS5_W * IMDB_BATCH * IMDB_WINDOW * PS5_WINDOWS


def _fs_type(path: str) -> str:
    return subprocess.run(["stat", "-f", "-c", "%T", path],
                          capture_output=True, text=True, timeout=30,
                          check=True).stdout.strip()


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path))


@contextlib.contextmanager
def _traced():
    """Span recording over the block (the trainer leaves a tracer it did
    not enable on); yields a list that receives the events."""
    from distkeras_tpu_torch.observability import trace as _trace

    _trace.enable()
    out: list = []
    try:
        yield out
        out.extend(_trace.events())
    finally:
        _trace.disable()


def _windows_run(history) -> int:
    return sum(1 for r in history if "loss" in r)


def _phase_gates(name, t, launches, extra) -> list:
    """The gates every resilience phase shares, as messages: the
    exactly-once oracle (lifetime folds equal the commits the clients saw
    acknowledged; ``extra`` says whether ``commits`` counts the run too),
    the loss falling, and K5, K6 and K7 launched once a step actually
    taken."""
    out = []
    s, r = t.ps_stats_, t.resilience_stats_
    windows = _windows_run(t.history.records)
    if not s["num_updates"] == r["logical_commits"] == windows:
        out.append(f"{name}: {s['num_updates']} folds, "
                   f"{r['logical_commits']} logical commits, {windows} "
                   f"windows exchanged: not exactly once")
    if extra and s["commits"] != r["logical_commits"]:
        out.append(f"{name}: {s['commits']} commits counted against "
                   f"{r['logical_commits']} logical")
    fell, means = _worker_loss_fell(t.history.records, PS5_W, PS5_EPOCHS)
    if not fell:
        out.append(f"{name}: the loss did not fall: {means}")
    steps = windows * IMDB_WINDOW
    for k in ("fused_adam", "lstm_forward", "lstm_backward"):
        if launches[k] != steps:
            out.append(f"{name}: {k} launched {launches[k]} times, expected "
                       f"{steps} (once a step actually taken)")
    return out


def train_ps_lstm_chaos(torch, train, serial):
    """Config 5 through the socket PS under chaos: a write-ahead log
    (``ps_wal_dir`` in a fresh temporary directory, a snapshot every
    PS5_SNAPSHOT_EVERY commits, so the log rotates and truncates),
    ``RetryPolicy(seed=0)``, heartbeats with a lease shorter than the
    restart delay, and ``FaultPlan(seed=0, drop_recv=PS5_DROP,
    kill_at=PS5_KILL)`` installed with ``with plan:``, a restart budget of
    one. Gates: exactly once (``commits == logical_commits``), some replay
    refused (``dup_commits >= 1``), one restart, some eviction, every
    worker's loss falling, ``recover_ps_state`` of the log equal to the
    final center bit for bit (``num_updates`` too), the ``wal`` CLI's
    verify clean, and K5/K6/K7 once a step actually taken. Prints the
    durability cost beside ``serial``'s (the in-process run's) window."""
    from distkeras_tpu_torch import workers
    from distkeras_tpu_torch.parallel.merge_rules import DynSGDMerge
    from distkeras_tpu_torch.resilience import (
        FaultPlan,
        RetryPolicy,
        recover_ps_state,
    )

    wal_dir = tempfile.mkdtemp(prefix="dk-wal-chaos-")
    try:
        plan = FaultPlan(seed=0, drop_recv=PS5_DROP, kill_at=dict(PS5_KILL))
        t, rows = _config5(
            "socket", ps_wal_dir=wal_dir,
            ps_snapshot_every=PS5_SNAPSHOT_EVERY,
            retry_policy=RetryPolicy(seed=0, max_attempts=PS5_ATTEMPTS,
                                     max_delay=PS5_MAX_DELAY),
            heartbeat_interval=PS5_HEARTBEAT, lease_timeout=PS5_LEASE,
            worker_restart_budget=1, worker_restart_delay=PS5_RESTART_DELAY,
            fault_plan=plan)

        def run():
            with _traced() as events, \
                    _servers_built(workers, "SocketParameterServer") as made, \
                    warnings.catch_warnings(), plan:
                warnings.simplefilter("ignore")   # the restart warning
                t0 = time.perf_counter()
                center = t.train(train.gather(np.arange(rows)))
                wall = time.perf_counter() - t0
            return center, wall, events, made

        (center, wall, events, made), launches = counted(run)
        s, r = t.ps_stats_, t.resilience_stats_
        state = recover_ps_state(wal_dir, DynSGDMerge(), PS5_W, None)
        recovered_equal = state is not None and all(
            np.array_equal(state["center"][k], center[k].numpy())
            for k in center)
        cli = subprocess.run(
            [sys.executable, "-m", "distkeras_tpu_torch.resilience.wal",
             "verify", wal_dir], capture_output=True, text=True, timeout=120)
        verify = json.loads(cli.stdout) if cli.stdout else {}
        phases = _phase_summary(s["exchange_phases"])
        rec = dict(
            phase="ps_config5_chaos_socket", wall_s=wall,
            window_ms=sum(v["mean_ms"] for v in phases.values()),
            inprocess_window_ms=serial["window_wall_ms"],
            inprocess_window_ms_from_phases=sum(
                v["mean_ms"] for v in serial["exchange_phases"].values()),
            wal_wait_total_ms=sum(e["dur_ns"] for e in events
                                  if e["name"] == "ps.wal_wait") / 1e6,
            wal_fsyncs=s["wal_fsyncs"], wal_records=s["wal_records"],
            wal_group_max=s["wal_group_max"],
            wal_bytes_written=made[0]._wal.bytes_written,
            wal_fs=_fs_type(wal_dir),
            commits=s["commits"], num_updates=s["num_updates"],
            logical_commits=r["logical_commits"],
            dup_commits=s["dup_commits"], retries=r["retries"],
            reconnects=r["reconnects"], restarts=r["restarts"],
            evicted_workers=s["evicted_workers"],
            heartbeats=s["heartbeats"], worker_retries=s["worker_retries"],
            faults=plan.stats(), recovered_num_updates=(
                None if state is None else state["num_updates"]),
            recovered_equal=recovered_equal, verify_rc=cli.returncode,
            verify_ok=verify.get("ok"),
            verify_torn_tail_bytes=verify.get("torn_tail_bytes"),
            verify_record_totals=verify.get("record_totals"),
            snapshots=[x["version"] for x in verify.get("snapshots", [])],
            worker_loss_fell=_each_worker_loss_fell(
                t.history.records, PS5_W, PS5_EPOCHS),
            launches=launches, exchange_phases=phases)
        log(json.dumps(rec))
        fails = _phase_gates("chaos", t, launches, extra=True)
        if s["dup_commits"] < 1:
            fails.append(f"chaos: no replay was refused (dup_commits "
                         f"{s['dup_commits']}, faults {plan.stats()})")
        if r["restarts"] != 1 or plan.stats()["kills"] != 1:
            fails.append(f"chaos: {r['restarts']} restarts after "
                         f"{plan.stats()['kills']} kills, expected 1")
        if s["evicted_workers"] < 1:
            fails.append("chaos: no worker was evicted")
        if not all(rec["worker_loss_fell"]):
            fails.append(f"chaos: a worker's loss did not fall: "
                         f"{rec['worker_loss_fell']}")
        if not (recovered_equal
                and rec["recovered_num_updates"] == s["num_updates"]):
            fails.append(f"chaos: the log recovers to "
                         f"{rec['recovered_num_updates']} updates, equal "
                         f"centers {recovered_equal}")
        if not (cli.returncode == 0 and verify.get("ok")
                and verify.get("torn_tail_bytes") == 0
                and len(rec["snapshots"]) == 1):
            fails.append(f"chaos: wal verify rc {cli.returncode}: "
                         f"{cli.stdout[-2000:]} {cli.stderr[-2000:]}")
        if fails:
            raise AssertionError("; ".join(fails))
        return rec
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)


@contextlib.contextmanager
def _timed_servers():
    """The socket servers (primary, standby) the trainer builds inside the
    block, each stamping when it crashed (``t_crash``) and when it first
    folded a commit (``t_first_fold``; a standby folds only once
    promoted): yields the list they land in."""
    from distkeras_tpu_torch import workers

    made: list = []
    names = ("SocketParameterServer", "StandbySocketParameterServer")
    saved = {n: getattr(workers, n) for n in names}

    def timed(cls):
        class Timed(cls):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                self.t_crash = self.t_first_fold = None
                made.append(self)

            def _crash(self):
                self.t_crash = time.perf_counter()
                super()._crash()

            def _fold_one_locked(self, work):
                super()._fold_one_locked(work)
                if self.t_first_fold is None and work.version:
                    self.t_first_fold = time.perf_counter()

        return Timed

    for n, cls in saved.items():
        setattr(workers, n, timed(cls))
    try:
        yield made
    finally:
        for n, cls in saved.items():
            setattr(workers, n, cls)


def train_ps_lstm_failover(torch, train):
    """Config 5 through the socket PS with a hot standby and a write-ahead
    log, the primary crash-stopped once half the run's commits folded
    (``FaultPlan(kill_ps_after_commits=...)``). Gates: one failover, via
    the standby, promoted at fence epoch 1; exactly once (lifetime folds
    equal the logical commits); the loss falls; the final center is the
    promoted standby's, and its own log replays to it bit for bit; K5/K6/K7
    once a step actually taken. Prints the failover time (the kill to the
    standby's first fold) and the failover timeout."""
    from distkeras_tpu_torch.parallel.merge_rules import DynSGDMerge
    from distkeras_tpu_torch.resilience import FaultPlan, recover_ps_state

    wal_dir = tempfile.mkdtemp(prefix="dk-wal-failover-")
    try:
        kill_after = PS5_W * PS5_WINDOWS * PS5_EPOCHS // 2
        plan = FaultPlan(kill_ps_after_commits=kill_after)
        t, rows = _config5("socket", ps_standby=True, ps_wal_dir=wal_dir,
                           ps_failover_timeout=PS5_FAILOVER_TIMEOUT,
                           fault_plan=plan)

        def run():
            with _timed_servers() as made, warnings.catch_warnings(), plan:
                warnings.simplefilter("ignore")   # the failover warning
                t0 = time.perf_counter()
                center = t.train(train.gather(np.arange(rows)))
                wall = time.perf_counter() - t0
            return center, wall, made

        (center, wall, made), launches = counted(run)
        s, r = t.ps_stats_, t.resilience_stats_
        fo = r["ps_failover"]
        primary = next(m for m in made if not hasattr(m, "is_standby"))
        standby = next(m for m in made if hasattr(m, "is_standby"))
        from_standby = all(np.array_equal(center[k].numpy(), v)
                           for k, v in standby.get_model().items())
        state = recover_ps_state(os.path.join(wal_dir, "standby"),
                                 DynSGDMerge(), PS5_W, None)
        replay_equal = state is not None and all(
            np.array_equal(state["center"][k], center[k].numpy())
            for k in center)
        rec = dict(
            phase="ps_config5_failover", wall_s=wall,
            kill_after_commits=kill_after, failovers=fo["failovers"],
            failover_log=fo["failover_log"],
            failover_s=(None if None in (primary.t_crash,
                                         standby.t_first_fold)
                        else standby.t_first_fold - primary.t_crash),
            failover_timeout_s=PS5_FAILOVER_TIMEOUT,
            promoted=standby.promoted_, fence_epoch=standby.fence_epoch,
            num_updates=s["num_updates"],
            logical_commits=r["logical_commits"], retries=r["retries"],
            reconnects=r["reconnects"], standby_num_updates=(
                standby.num_updates), center_from_standby=from_standby,
            standby_log_replays_equal=replay_equal,
            epoch_mean_loss=_worker_loss_fell(t.history.records, PS5_W,
                                              PS5_EPOCHS)[1],
            launches=launches)
        log(json.dumps(rec))
        fails = _phase_gates("failover", t, launches, extra=False)
        if not (fo["failovers"] == 1 and plan.stats()["ps_kills"] == 1
                and fo["failover_log"][0]["via"] == "standby"):
            fails.append(f"failover: {fo['failovers']} failovers after "
                         f"{plan.stats()['ps_kills']} kills: "
                         f"{fo['failover_log']}")
        if not (standby.promoted_ and standby.fence_epoch == 1
                and fo["failover_log"][0]["epoch"] == 1):
            fails.append(f"failover: the standby promoted "
                         f"{standby.promoted_} at fence epoch "
                         f"{standby.fence_epoch}, expected 1")
        if not (from_standby and standby.num_updates == s["num_updates"]
                and replay_equal):
            fails.append(f"failover: the final center is the standby's "
                         f"{from_standby}, its log replays to it "
                         f"{replay_equal}")
        if fails:
            raise AssertionError("; ".join(fails))
        return rec
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)


@contextlib.contextmanager
def _crash_at_first_close():
    """The native server the trainer builds inside the block, with its C++
    span ring armed, crash()ed at the first client close (every worker
    done, none deregistered yet). Just before the crash, the live state is
    read into the yielded dict: ``center``, ``num_updates``,
    ``fence_epoch``, ``last_seq`` (each worker's last sent seqno, from its
    client) and the ring's ``spans``."""
    from distkeras_tpu_torch import native_ps
    from distkeras_tpu_torch.resilience import retry

    cap: dict = {}
    servers: list = []
    clients: list = []
    srv_cls, cli_cls = native_ps.NativeSocketParameterServer, \
        retry.ResilientPSClient

    class Armed(srv_cls):
        def initialize(self):
            super().initialize()
            self.set_trace(True)
            servers.append(self)

    class CrashAtClose(cli_cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            clients.append(self)

        def close(self):
            if not cap:
                ps = servers[0]
                cap.update(
                    center=ps.spec.flatten(ps.get_model()),
                    num_updates=ps.num_updates, fence_epoch=ps.fence_epoch,
                    last_seq={c.worker_id: c._seq_epoch + c._wire_seq
                              for c in clients if c.seq},
                    spans=ps.scrape_trace_events())
                ps.crash()
            super().close()

    native_ps.NativeSocketParameterServer = Armed
    retry.ResilientPSClient = CrashAtClose
    try:
        yield cap
    finally:
        native_ps.NativeSocketParameterServer = srv_cls
        retry.ResilientPSClient = cli_cls


def train_ps_lstm_native_wal(torch, train, serial):
    """Config 5 through the native PS, serially, with the C++ write-ahead
    log (``ps_wal_dir``), heartbeats and ``RetryPolicy(seed=0)``; the
    server crash()ed after the last exchange. Gate: the port's
    ``recover_ps_state`` rebuilds from the C++ log the center last served,
    bit for bit, with ``num_updates``, ``last_seq`` and ``fence_epoch``
    equal; K5/K6/K7 once a step. Prints the durability cost beside
    ``serial``'s window."""
    from distkeras_tpu_torch.parallel.merge_rules import DynSGDMerge
    from distkeras_tpu_torch.resilience import RetryPolicy, recover_ps_state

    wal_dir = tempfile.mkdtemp(prefix="dk-wal-native-")
    try:
        # a lease long past the run: no eviction retires a dedup entry
        # before the crash, so every worker's last seqno is in the log
        t, rows = _config5(
            "native", ps_wal_dir=wal_dir,
            retry_policy=RetryPolicy(seed=0, max_attempts=PS5_ATTEMPTS),
            heartbeat_interval=PS5_HEARTBEAT, lease_timeout=300.0)

        def run():
            with _crash_at_first_close() as cap:
                t0 = time.perf_counter()
                t.train(train.gather(np.arange(rows)))
                wall = time.perf_counter() - t0
            return cap, wall

        (cap, wall), launches = counted(run)
        s, r = t.ps_stats_, t.resilience_stats_
        spec = t.spec
        template, _ = spec.init_np(t.seed)
        state = recover_ps_state(wal_dir, DynSGDMerge(), PS5_W, None,
                                 template=template)
        from distkeras_tpu_torch.native_ps import FlatSpec

        flat = None if state is None else FlatSpec(template).flatten(
            state["center"])
        equal = flat is not None and np.array_equal(flat, cap["center"])
        phases = _phase_summary(s["exchange_phases"])
        rec = dict(
            phase="ps_config5_native_wal", wall_s=wall,
            window_wall_ms=1e3 * wall / (PS5_WINDOWS * PS5_EPOCHS),
            window_ms=sum(v["mean_ms"] for v in phases.values()),
            inprocess_window_ms=serial["window_wall_ms"],
            inprocess_window_ms_from_phases=sum(
                v["mean_ms"] for v in serial["exchange_phases"].values()),
            wal_wait_total_ms=sum(e["dur_ns"] for e in cap["spans"]
                                  if e["name"] == "ps.wal_wait") / 1e6,
            wal_fsync_total_ms=sum(e["dur_ns"] for e in cap["spans"]
                                   if e["name"] == "wal.fsync") / 1e6,
            wal_fsyncs=s["wal_fsyncs"], wal_records=s["wal_records"],
            wal_group_max=s["wal_group_max"],
            wal_bytes_written=_dir_bytes(wal_dir), wal_fs=_fs_type(wal_dir),
            num_updates=cap["num_updates"],
            recovered_num_updates=(None if state is None
                                   else state["num_updates"]),
            center_bits_equal=equal,
            last_seq_equal=(state is not None
                            and state["last_seq"] == cap["last_seq"]),
            fence_epoch=cap["fence_epoch"], recovered_fence_epoch=(
                None if state is None else state["fence_epoch"]),
            heartbeats=s["heartbeats"], logical_commits=r["logical_commits"],
            launches=launches, exchange_phases=phases)
        log(json.dumps(rec))
        fails = _phase_gates("native_wal", t, launches, extra=True)
        if not (equal and rec["last_seq_equal"]
                and rec["recovered_num_updates"] == cap["num_updates"]
                and rec["recovered_fence_epoch"] == cap["fence_epoch"]
                and len(cap["last_seq"]) == PS5_W):
            fails.append(f"native_wal: the C++ log recovers to "
                         f"{rec['recovered_num_updates']} updates (live "
                         f"{cap['num_updates']}), center bits equal {equal}, "
                         f"last_seq equal {rec['last_seq_equal']}, fence "
                         f"{rec['recovered_fence_epoch']} (live "
                         f"{cap['fence_epoch']})")
        if fails:
            raise AssertionError("; ".join(fails))
        return rec
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)


def run_mnist_twin():
    """The MNIST example's twin (``distkeras_tpu_torch.examples.mnist``)
    in this process, once a MNIST_RUNS entry, held to the JAX example's
    gate (test accuracy > 0.8)."""
    from distkeras_tpu_torch.examples import mnist as twin

    recs = []
    for args in MNIST_RUNS:
        t0 = time.perf_counter()
        acc = twin.main(args + ["--device", DEVICE])
        recs.append(dict(args=args, test_accuracy=acc,
                         wall_s=time.perf_counter() - t0))
        log("mnist twin: " + json.dumps(recs[-1]))
        if not acc > 0.8:
            raise AssertionError(f"mnist twin {args}: test accuracy {acc} "
                                 f"<= 0.8")
    return recs


def _build_all(_build) -> dict:
    """Every kernel source with ``nvcc`` (``_build.build``) and, at the
    same time, the native parameter server's C++ core with ``g++``
    (``native.build``): seconds per library, the core's as ``dkps``."""
    from distkeras_tpu_torch import native

    out, errors = {}, []

    def gxx():
        try:
            out["dkps"] = native.build()
        except BaseException as e:   # re-raised below, after nvcc
            errors.append(e)

    th = threading.Thread(target=gxx)
    th.start()
    try:
        secs = _build.build()
    finally:
        th.join()
    if errors:
        raise errors[0]
    return {**secs, **out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from distkeras_tpu_torch.models import quantize_lm, transformer_lm
    from distkeras_tpu_torch.ops import _build
    from distkeras_tpu_torch.ops import flash_attention as fa
    from distkeras_tpu_torch.ops import pallas_kernels as pk
    from distkeras_tpu_torch.ops import quant
    from distkeras_tpu_torch.ops import recurrent as rec

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 is f32
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    secs = _build_all(_build)
    log(f"build: {json.dumps(secs)} total {time.perf_counter() - t0:.2f}s")
    sass = check_sass(_build)

    with torch.inference_mode():
        qrows, q_err = check_q_matmul(torch, quant)
        frows, f_err = check_flash(torch, fa)
        arows, a_err = check_adam(torch, pk)
    fwd_rows, bwd_rows, l_err = check_lstm(torch, rec)
    with torch.no_grad():
        (fa_train_rows, dq_rows, dkv_rows, dq_err,
         dkv_err) = check_flash_bwd(torch, fa)
    check_flash_vmap(torch, fa)
    check_fused_ce(torch)
    log(f"kernel checks done at {time.perf_counter() - t0:.1f}s")
    train, test = imdb_data()
    compare_window(torch, train)

    model = transformer_lm(
        vocab=VOCAB, maxlen=MAXLEN, dim=DIM, heads=HEADS, depth=DEPTH,
        kv_heads=KV_HEADS, pos_embedding="rope", attn_impl="flash",
        dtype=torch.bfloat16, device=DEVICE, seed=0)
    qmodel = quantize_lm(model)
    torch.cuda.synchronize()

    with torch.inference_mode():
        quant.q_matmul.launches = 0
        quant.q_matmul.prefill_launches = 0
        fa._fa_forward.launches = 0
        prompts, res16, _ = serve(torch, model, "bf16")
        _, res8, _ = serve(torch, qmodel, "int8")
        launches = {"q_matmul": quant.q_matmul.launches,
                    "q_matmul_prefill": quant.q_matmul.prefill_launches,
                    "flash_attention": fa._fa_forward.launches}
        log(f"launches on the served path: {json.dumps(launches)}")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel never launched on the served "
                                 f"path: {launches}")

        tie_aware_check(torch, model, prompts, res16, "bf16")
        tie_aware_check(torch, qmodel, prompts, res8, "int8")
    del model, qmodel
    torch.cuda.empty_cache()

    pk.fused_adam_step.launches = 0
    rec.lstm_forward.launches = 0
    rec.lstm_backward.launches = 0
    train_dynsgd(torch, train, test)
    trained = {"fused_adam": pk.fused_adam_step.launches,
               "lstm_forward": rec.lstm_forward.launches,
               "lstm_backward": rec.lstm_backward.launches}
    log(f"launches on the training path: {json.dumps(trained)}")
    if min(trained.values()) < 1:
        raise AssertionError(f"a kernel never launched on the training "
                             f"path: {trained}")
    launches.update(trained)
    train_adag_lenet(torch)
    torch.cuda.empty_cache()
    log(f"slice 1-2 paths done at {time.perf_counter() - t0:.1f}s")

    compare_lm_window(torch)
    counters = {"flash_attention": fa._fa_forward,
                "flash_attention_bwd_dq": fa._fa_bwd_dq,
                "flash_attention_bwd_dkv": fa._fa_bwd_dkv,
                "fused_adam": pk.fused_adam_step}
    for fn in counters.values():
        fn.launches = 0
    train_lm(torch)
    lm_launches = {k: fn.launches for k, fn in counters.items()}
    log(f"launches on the LM training path: {json.dumps(lm_launches)}")
    if min(lm_launches.values()) < 1:
        raise AssertionError(f"a kernel never launched on the LM training "
                             f"path: {lm_launches}")
    launches.update({k: lm_launches[k] for k in (
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv")})
    torch.cuda.empty_cache()

    for fn in counters.values():
        fn.launches = 0
    train_classifier(torch)
    cls_launches = {k: counters[k].launches for k in (
        "flash_attention", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")}
    log(f"launches on the classifier training path: "
        f"{json.dumps(cls_launches)}")
    if min(cls_launches.values()) < 1:
        raise AssertionError(f"a kernel never launched on the classifier "
                             f"training path: {cls_launches}")
    log(f"training paths done at {time.perf_counter() - t0:.1f}s")

    # the parameter-server path (backend="ps"): each phase's launches are
    # counted from 0 just before it and read just after
    t_ps = time.perf_counter()
    vgg_rec, ps3 = counted(lambda: train_ps_vgg(torch))
    log(f"launches on the socket PS path: {json.dumps(ps3)}")
    log(json.dumps({"phase": "ps_config3_socket",
                    "wall_s": time.perf_counter() - t_ps}))
    torch.cuda.empty_cache()
    t_ps = time.perf_counter()
    lstm_rec, ps5 = counted(lambda: train_ps_lstm(torch, train))
    ps5_steps = PS5_W * PS5_WINDOWS * IMDB_WINDOW * PS5_EPOCHS
    log(f"launches on the in-process PS path: {json.dumps(ps5)}")
    for name in ("fused_adam", "lstm_forward", "lstm_backward"):
        if ps5[name] != ps5_steps:
            raise AssertionError(f"in-process PS: {name} launched "
                                 f"{ps5[name]} times, expected {ps5_steps} "
                                 f"(one a step a worker)")
    log(json.dumps({"phase": "ps_config5_inprocess",
                    "wall_s": time.perf_counter() - t_ps}))
    t_ps = time.perf_counter()
    compare_ps_window(torch, train)
    log(json.dumps({"phase": "ps_one_worker_parity",
                    "wall_s": time.perf_counter() - t_ps}))
    t_ps = time.perf_counter()
    run_mnist_twin()
    log(json.dumps({"phase": "mnist_twin",
                    "wall_s": time.perf_counter() - t_ps}))
    torch.cuda.empty_cache()

    # the pipelined exchange and the native and shm transports; config 3's
    # runs are gated after the kernels line (ps3_failures), so a run that
    # does not learn still leaves every kernel's numbers printed
    t_ps = time.perf_counter()
    _, ps5p = counted(lambda: train_ps_lstm_native_pipelined(
        torch, train, lstm_rec))
    log(f"launches on the native pipelined PS path: {json.dumps(ps5p)}")
    for name in ("fused_adam", "lstm_forward", "lstm_backward"):
        if ps5p[name] != ps5_steps:
            raise AssertionError(f"native pipelined PS: {name} launched "
                                 f"{ps5p[name]} times, expected "
                                 f"{ps5_steps} (one a step a worker)")
    log(json.dumps({"phase": "ps_config5_native_pipelined",
                    "wall_s": time.perf_counter() - t_ps}))
    t_ps = time.perf_counter()
    compare_ps_pipeline(torch, train)
    log(json.dumps({"phase": "ps_pipeline_parity",
                    "wall_s": time.perf_counter() - t_ps}))
    torch.cuda.empty_cache()
    t_ps = time.perf_counter()
    vgg_runs = train_ps_vgg_transports(torch)
    log(json.dumps({"phase": "ps_config3_transports",
                    "wall_s": time.perf_counter() - t_ps}))
    torch.cuda.empty_cache()

    # the resilience layer on config 5: chaos over the socket PS with a
    # WAL, a standby failover, the native PS's C++ WAL (each counts its
    # own launches and gates them)
    resilience = {}
    for name, fn in (
            ("config5_chaos_socket",
             lambda: train_ps_lstm_chaos(torch, train, lstm_rec)),
            ("config5_failover",
             lambda: train_ps_lstm_failover(torch, train)),
            ("config5_native_wal",
             lambda: train_ps_lstm_native_wal(torch, train, lstm_rec))):
        resilience[name] = fn()
        log(f"launches on the {name} path: "
            f"{json.dumps(resilience[name]['launches'])}")
        torch.cuda.empty_cache()
    log(f"parameter-server paths done at {time.perf_counter() - t0:.1f}s")

    def total(rows, pick, key):
        vals = [r[key] * w for r, w in pick(rows)]
        return None if any(v is None for v in vals) else sum(vals)

    def decode_step(rows):    # one decode step's q_matmul calls at M=8
        return [(r, PER_STEP[(r["K"], r["N"])]) for r in rows
                if r["M"] == 8 and r["dtype"] == "bfloat16"]

    def prefill_1024(rows):   # one 1024-token prefill's calls (8 layers, head)
        return [(r, PER_STEP[(r["K"], r["N"])]) for r in rows
                if r["M"] == 1024 and r["dtype"] == "bfloat16"]

    def served_prefill(rows):  # one layer's prefill attention, 4 prompts
        return [(r, 1) for r in rows if (r["B"], r["H"], r["Hkv"]) ==
                (1, HEADS, KV_HEADS) and r["L"] in SERVED_LENGTHS]

    def one_launch(rows):      # one launch at the collective path's shapes
        return [(r, 1) for r in rows if r.get("path") != "ps"]

    def lm_shape(rows):        # one launch at config 9's training shape
        return [(r, 1) for r in rows
                if (r["L"], r["D"]) == (LM_L, LM_DIM // LM_HEADS)]

    sass_for = dict(sass, lstm_backward=dict(
        dwh=sass["lstm_backward"], scan=sass["lstm_backward_scan"],
        direct_scan=sass["lstm_backward_direct_scan"]))
    kernels = []
    for name, src, replaces, rows, pick, err in (
            ("q_matmul", "distkeras_tpu_torch/csrc/quant.cu",
             "distkeras_tpu/ops/quant.py:93", qrows, decode_step, q_err),
            ("q_matmul_prefill", "distkeras_tpu_torch/csrc/quant.cu",
             "distkeras_tpu/ops/quant.py:93", qrows, prefill_1024, q_err),
            ("flash_attention", "distkeras_tpu_torch/csrc/flash_attention.cu",
             "distkeras_tpu/ops/flash_attention.py:146", frows,
             served_prefill, f_err),
            ("fused_adam", "distkeras_tpu_torch/csrc/adam.cu",
             "distkeras_tpu/ops/pallas_kernels.py:36", arows, one_launch,
             a_err),
            ("lstm_forward", "distkeras_tpu_torch/csrc/lstm.cu",
             "distkeras_tpu/ops/recurrent.py:75", fwd_rows, one_launch,
             max(r["max_abs_err"] for r in fwd_rows)),
            ("lstm_backward", "distkeras_tpu_torch/csrc/lstm.cu",
             "distkeras_tpu/ops/recurrent.py:109", bwd_rows, one_launch,
             max(r["max_abs_err"] for r in bwd_rows)),
            ("flash_attention_bwd_dq",
             "distkeras_tpu_torch/csrc/flash_attention_bwd.cu",
             "distkeras_tpu/ops/flash_attention.py:336", dq_rows, lm_shape,
             dq_err),
            ("flash_attention_bwd_dkv",
             "distkeras_tpu_torch/csrc/flash_attention_bwd.cu",
             "distkeras_tpu/ops/flash_attention.py:426", dkv_rows, lm_shape,
             dkv_err)):
        by_bytes = sum(r["bound_ms"] * w for r, w in pick(rows)
                       if r["bound_by"] == "bytes")
        bound_ms = total(rows, pick, "bound_ms")
        ps_rows = [r for r in rows if r.get("path") == "ps"]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=err,
            ms=total(rows, pick, "kernel_ms"),
            plain_ms=total(rows, pick, "plain_ms"),
            bound_ms=bound_ms,
            bound_by="bytes" if by_bytes >= 0.5 * bound_ms else "operations",
            library_ms=total(rows, pick, "library_ms"),
            checked=True,
            **({k: total(rows, pick, k) for k in ("scan_ms", "dwh_ms")}
               if "scan_ms" in rows[0] else {}),
            ps_launches={"config3_socket": ps3[name],
                         "config5_inprocess": ps5[name],
                         **{k: v[1][name] for k, v in vgg_runs.items()},
                         "config5_native_pipelined": ps5p[name],
                         **{k: v["launches"][name]
                            for k, v in resilience.items()}},
            **({"ps_shape": ps_rows[0]} if ps_rows else {}),
            shapes=[r for r, _ in pick(rows)] if name == "q_matmul_prefill"
            else rows,
            **({"sass": sass_for[name]} if name in sass_for else {})))
    print(json.dumps({"kernels": kernels}), flush=True)
    failures = ps3_failures("config3_socket", vgg_rec, ps3, False)
    for name, (rec3, launches3) in vgg_runs.items():
        failures += ps3_failures(name, rec3, launches3, True)
    if failures:
        raise AssertionError("config 3's gates failed: "
                             + "; ".join(failures))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
