#!/usr/bin/env python3
"""Every launch plan K1 (``q_matmul``'s int8 kernels) could take, timed on
one card: the evidence behind ``ops/quant.py::plan_q_matmul``.

    python3 qmm_plans.py [M ...]

For every Dense shape of the served config (``chip_smoke.DENSE``) and each
M (default: 8, the served prefill lengths and 1024), times every plan of
the kernel's path: decode (M <= 16) at each K split of 1..8 blocks;
prefill at each token tile (64, 128, 192, 256), channel tile (128 or 64)
and K split of 1..3 blocks. Each plan is launched through the library's
``dk_q_matmul`` with its fields, checked against the plain version (bf16:
rtol 1e-2, atol 1e-3 of max |plain|), and timed under CUDA-graph replay
with the weights rotated so each launch reads them cold
(``chip_smoke.cuda_ms``). Prints one JSON line per shape: cuBLAS's time
over the bf16 weight, each plan's time, and the plan ``plan_q_matmul``
picks. Needs one card; exits non-zero on a wrong result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from distkeras_tpu_torch.ops import _build, quant

    if not torch.cuda.is_available():
        print("qmm_plans: no CUDA device", file=sys.stderr)
        return 1
    ms = [int(a) for a in argv[1:]] or [8, *cs.SERVED_LENGTHS, 1024]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = _build.load("quant", quant._bind)
    gen = torch.Generator(device="cuda").manual_seed(1)
    failed = 0
    for k, n in cs.DENSE:
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        qt = quant.quantize(w, axis=1)
        qs = [quant.QTensor(qt.q.clone(), qt.scale.clone()) for _ in range(
            max(1, min(48, math.ceil(200e6 / qt.q.numel()))))]
        deq = [quant.dequantize(q_, axis=1, dtype=torch.bfloat16)
               for q_ in qs]
        for m in ms:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            ref = quant._q_matmul_plain(x, qt.q, qt.scale,
                                        torch.bfloat16).float()
            out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            if m <= quant.DECODE_M:
                plans = [("decode", 0, 0, s) for s in range(1, 9)
                         if s <= -(-k // quant.DECODE_CHUNK)]
            else:
                plans = [("prefill", tn, wg, s) for tn in quant.TOKEN_TILES
                         for wg in (2, 1) for s in range(1, 4)]
            nq, nd = cs.rotating(qs), cs.rotating(deq)
            row = dict(M=m, K=k, N=n, cublas_us=1e3 * cs.cuda_ms(
                torch, lambda: torch.matmul(x, nd().t())))
            chosen = quant.plan_q_matmul(m, n, k)
            row["chosen"] = (f"decode:0:0:{chosen.splits}"
                             if chosen.kernel == "decode" else
                             f"prefill:{chosen.tokens}:{chosen.wg}:"
                             f"{chosen.splits}")
            times = {}
            for kernel, tn, wg, s in plans:
                def run(q_=None):
                    q_ = q_ or qt
                    err = lib.dk_q_matmul(
                        x.data_ptr(), q_.q.data_ptr(), q_.scale.data_ptr(),
                        out.data_ptr(), m, n, k, 1, quant._PATHS[kernel], tn,
                        wg, s, torch.cuda.current_stream().cuda_stream)
                    _build.check(err, "q_matmul plan")
                run()
                torch.cuda.synchronize()
                ok = torch.allclose(out.float(), ref, rtol=1e-2,
                                    atol=1e-3 * ref.abs().max().item())
                failed += not ok
                times[f"{kernel}:{tn}:{wg}:{s}"] = (
                    1e3 * cs.cuda_ms(torch, lambda: run(nq())) if ok
                    else None)
            row["plans_us"] = times
            row["best"] = min((v, p) for p, v in times.items()
                              if v is not None)[1]
            print(json.dumps(row), flush=True)
        del qs, deq
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
