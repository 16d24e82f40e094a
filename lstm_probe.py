#!/usr/bin/env python3
"""Where one step of the LSTM forward scan (K6) goes, on one card.

    python3 lstm_probe.py [--shape G B T H]

builds ``distkeras_tpu_torch/csrc/lstm.cu`` three more times beside the
shipped build (``-DDK_LSTM_PROBE``: entry points that run the forward scan
on a chosen path, and ``clock64()`` marks between the parts of a step;
``... -DDK_LSTM_PROBE_NO_GX``: the same without the per-block scan's
in-step gx loads; ``... -DDK_LSTM_PROBE_NOMARK``: the entry points without
the marks) and, at the IMDB shape (G=8 workers, B=64, T=200, H=128, bf16)
unless told otherwise, runs the forward paths: the per-block scan (``lstm_fwd_kernel``), the
cluster scan (``lstm_fwd_cluster_kernel``) on 16 batch rows a cluster, and
the cluster scan on the rows the plan picks (8 at the IMDB shape):

- their times without marks (CUDA events over 10 launches) and per step;
- each part's cycles per step and warp from the marks, and its share.
  Per-block scan: products (the mma chain with its wh fragment loads), gate
  (gx loads, gate math, h/c/hs/cs stores), barrier (``__syncthreads``);
  the NO_GX build's gate part, subtracted, gives the in-step gx loads.
  Cluster scan: prefetch (issuing the cp.async of gx for a later step),
  products, gate, publish (the DSMEM h stores, the wait for the next gx,
  the cluster barrier's arrive), store (hs, cs), wait (the barrier's wait);
- ``hs`` of each path against the plain version (2^-6 of max |plain|).

Prints one JSON line per build and path; ends non-zero on any failure.
Needs one card. The marks cost a few cycles each: the shares, not the
marked times, are the result.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

from distkeras_tpu_torch.ops import _build

PARTS = {0: ("products", "gate", "barrier"),
         1: ("prefetch", "products", "gate", "publish", "store", "wait")}
SLOTS = {0: (1, 2, 5), 1: (0, 1, 2, 3, 4, 5)}


def build(tag: str, defines) -> ctypes.CDLL:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"liblstm-probe-{tag}.so")
    cmd = [_build._tool("nvcc"), *_build.NVCC_FLAGS, *defines, "-o", out,
           _build.source_path("lstm")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc {tag} failed:\n{r.stderr}")
    lib = ctypes.CDLL(out)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.dk_lstm_probe_fwd.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, vp]
    lib.dk_lstm_probe_fwd.restype = i
    lib.dk_lstm_probe_read.argtypes = [vp]
    lib.dk_lstm_probe_read.restype = i
    return lib


def main(argv) -> int:
    import torch

    from distkeras_tpu_torch.ops import recurrent as rec

    if not torch.cuda.is_available():
        print("lstm_probe: no CUDA device", file=sys.stderr)
        return 1
    G, B, T, H = (8, 64, 200, 128)
    if "--shape" in argv:
        i = argv.index("--shape")
        G, B, T, H = map(int, argv[i + 1:i + 5])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as pool:
        libs = dict(zip(("marks", "no_gx", "nomark"), pool.map(
            lambda a: build(*a),
            (("marks", ["-DDK_LSTM_PROBE"]),
             ("no_gx", ["-DDK_LSTM_PROBE", "-DDK_LSTM_PROBE_NO_GX"]),
             ("nomark", ["-DDK_LSTM_PROBE", "-DDK_LSTM_PROBE_NOMARK"])))))
    gen = torch.Generator(device="cuda").manual_seed(6)
    gx = (torch.randn((G, B, T, 4 * H), generator=gen, device="cuda")
          * 0.5).to(torch.bfloat16)
    wh = torch.randn((G, H, 4 * H), generator=gen, device="cuda") / H ** 0.5
    hp, _ = rec.lstm_forward(gx, wh, True, impl="plain")
    hs, cs = torch.empty_like(hp), torch.empty_like(hp)
    stream = torch.cuda.current_stream().cuda_stream
    counts = (ctypes.c_ulonglong * 8)()
    failed = 0

    def run(lib, path):
        err = lib.dk_lstm_probe_fwd(gx.data_ptr(), wh.data_ptr(), hs.data_ptr(),
                                    cs.data_ptr(), G, B, T, H, 1, path, stream)
        _build.check(err, f"lstm probe path {path}")

    for path in (0, 2, 1):
        row = dict(G=G, B=B, T=T, H=H, path={
            0: "per-block", 1: "cluster", 2: "cluster, 16 rows"}[path])
        lib = libs["nomark"]
        run(lib, path)
        torch.cuda.synchronize()
        err = (hs.float() - hp.float()).abs().max().item()
        ok = err <= 2.0 ** -6 * hp.float().abs().max().item()
        failed += not ok
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(10):
            run(lib, path)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / 10
        row.update(ok=ok, max_abs_err=err, kernel_ms=ms,
                   step_us=1e3 * ms / T)
        for tag in ("marks", "no_gx") if path == 0 else ("marks",):
            lib = libs[tag]
            lib.dk_lstm_probe_read(counts)   # zero
            run(lib, path)
            torch.cuda.synchronize()
            _build.check(lib.dk_lstm_probe_read(counts), "probe read")
            warps = counts[7]
            cyc = {name: counts[slot] / (warps * T)
                   for name, slot in zip(PARTS[min(path, 1)],
                                         SLOTS[min(path, 1)])}
            total = sum(cyc.values())
            row[tag] = dict(warps=warps, cycles_per_step=cyc,
                            cycles_total=total, setup_cycles=counts[6] / warps,
                            share={k: v / total for k, v in cyc.items()})
        if path == 0:
            row["gx_load_cycles"] = (row["marks"]["cycles_per_step"]["gate"]
                                     - row["no_gx"]["cycles_per_step"]["gate"])
        print(json.dumps(row), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
