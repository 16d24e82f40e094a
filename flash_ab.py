#!/usr/bin/env python3
"""A/B of the flash-attention kernels K2 (forward), K3 (dq) and K4 (dk/dv)
of two checkouts of this repository on one card.

    python3 flash_ab.py OTHER_ROOT [OTHER_ROOT ...]

runs, for each OTHER_ROOT in turn, its kernels, this checkout's, this
checkout's again and its own again, each in a process of its own (so each
builds and loads its own libraries), and prints one JSON line per case and
side: K2, K3 and K4 against their plain versions (O within 2e-2 and lse
within 1e-3; dq, dk and dv within 2^-6 of the plain output's largest
magnitude; fully masked rows exactly 0, as ``chip_smoke.py`` holds them)
and their device
times under CUDA-graph replay (``chip_smoke.cuda_ms``), at edge-tile
cases, the served prefill lengths and the two training shapes (config 9:
B'=16, L=2048, H=8, D=128, causal; config 6: D=64, non-causal, ragged key
mask). Where a side's build helpers can say so, it also prints registers,
spills and the ``HGMMA``/``UTMALDG`` counts of the wgmma kernels. Exits
non-zero if any side fails a check. Needs one card; measures nothing on
the CPU.
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


def measure(side: str, root: str) -> int:
    sys.path.insert(0, root)
    import torch

    from distkeras_tpu_torch.ops import _build
    from distkeras_tpu_torch.ops import flash_attention as fa

    if not fa.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"loaded {fa.__file__}, not {root}'s kernels")
    cs = _smoke()
    _build.build(("flash_attention", "flash_attention_bwd"))
    print(json.dumps(dict(side=side, root=root,
                          build=_build_report(_build))), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf = torch.bfloat16
    failed = 0
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
    if len(argv) == 3 and argv[1] in ("this", "other"):
        return measure(argv[1], argv[2])
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
        r = subprocess.run([sys.executable, os.path.abspath(__file__), side,
                            root], capture_output=True, text=True,
                           timeout=600)
        print(r.stdout, end="", flush=True)
        if r.returncode:
            print(f"{side} ({root}) failed, rc {r.returncode}:\n"
                  f"{r.stderr[-4000:]}", flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv))
