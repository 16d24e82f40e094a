"""The readings a cell's limits are set from, at the cell's own size, on
the card, in one process:

- the port on every seed of ``--seeds`` (the lower readings);
- the control, the reference in fp8, on the first ``--control`` of them
  (an upper reading);
- each fault the cell's path can have (``faults.for_cell``) planted in
  the port, on the first ``--fault-seeds`` of them (the other upper
  readings).

Every reading is compared with the f32 reference of its seed by
``core.compare``. One JSON line a reading on stdout, and in ``--out``::

    python3 -m portbench.calibrate --workload lm9_adag_L2048 \\
        --seeds 11,12,13 --control 3 --fault-seeds 3 --out chiprun_out/cal.jsonl

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import core, faults, run


def _layout(drv) -> dict:
    return dict(lead=drv.lead, window=drv.window, batch=drv.batch,
                shapes=drv.shapes)


def _program(bench, seed, device, fault=None):
    with faults.planted(bench, fault):
        drv = core.load_driver(bench.cell["driver"]).Driver(bench, seed,
                                                            device)
        readings = drv.first_steps()
        layout = _layout(drv)
        drv.release()
    return readings, layout


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    run.fix_environment()
    bench = core.resolve(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    fault_names = faults.for_cell(bench)
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, prog, ref, t0):
        numbers = core.compare(prog, ref)
        line = json.dumps({"workload": bench.name, "kind": kind,
                           "seed": seed, "seconds": time.perf_counter() - t0,
                           **{k: v for k, (v, _) in numbers.items()},
                           "leaves": {k: w for k, (_, w) in numbers.items()},
                           "loss_prog": prog["loss"],
                           "loss_ref": ref["loss"]})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        prog, layout = _program(bench, seed, args.device)
        ref = run.reference_readings(bench, layout, seed, args.device)
        emit("program", seed, prog, ref, t0)
        if i < args.control:
            t0 = time.perf_counter()
            ctrl = run.reference_readings(bench, layout, seed, args.device,
                                          precision="fp8")
            emit("control_fp8", seed, ctrl, ref, t0)
        if i < args.fault_seeds:
            for name in fault_names:
                t0 = time.perf_counter()
                bad, _ = _program(bench, seed, args.device, name)
                emit("fault_" + name, seed, bad, ref, t0)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
