"""Run one cell once and print its result as the last line of stdout.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's driver (the port's trainer and engine, weights
and traffic from the seed on the card), runs the first
``core.CHECKED_WINDOWS`` windows of the timed path, which warm up every
shape, and then one epoch as the window runs them, so that the caching
allocator holds its pools before the window opens. The window then runs
epochs back to back until ``--seconds`` have passed and ends in a
synchronise (``--trace 1``: the cell's
``trace_epochs`` epochs under ``torch.profiler``). Once the window has
closed and the port's state is freed, the plain reference follows the
checked windows from the same weights and rows, and ``correct`` says
whether the port's readings lie within the cell's limits of it.

Exits non-zero with no result when there is no CUDA card (or fewer than
the cell asks for), and when ``jax``, ``jaxlib``, ``flax``,
``distkeras_tpu`` or ``distkeras`` is loaded in this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from portbench import core  # noqa: E402

CACHE = os.path.join(core.ROOT, ".portbench_cache")
PRECISION = {"bfloat16": "bf16", "float32": "f32"}


def fix_environment() -> None:
    """Build caches at fixed paths inside the checkout (the port builds
    its kernels into ``distkeras_tpu_torch/_build/`` itself), and no JAX
    behind a library's back."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    bench: core.Bench
    setup_s: float
    window_s: float
    done: dict            # tokens, samples and engine windows trained
    window_peak_bytes: int | None
    trace: object         # trace.Trace in a traced run, else None
    lead: int             # workers
    window: int           # local steps an engine window
    batch: int            # rows a worker's step
    precision: str        # the step's compute precision (peaks.json key)


def _cuda_ready(bench, err) -> bool:
    import torch

    need = int(bench.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {need} CUDA card(s), found {n}",
              file=err)
        return False
    return True


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reference_readings(bench, drv_layout: dict, seed: int, device,
                       precision: str = "f32") -> dict:
    """The reference over the checked windows, from the weights and rows
    made again from ``seed``."""
    from portbench.reference import train

    lead, window, batch = (drv_layout[k] for k in ("lead", "window",
                                                    "batch"))
    params0 = core.make_params(drv_layout["shapes"], seed, device)
    per = window * batch
    cols = core.make_columns(
        bench.traffic, bench.config, lead,
        (core.CHECKED_WINDOWS + int(bench.cell["windows_per_epoch"])) * per,
        seed, device)
    windows = core.window_slices(cols, lead, window, batch,
                                 core.CHECKED_WINDOWS)
    del cols
    return train.run(bench.config["reference"], bench.config, params0,
                     windows, bench.cell["reference"]["rule"],
                     float(bench.cell["trainer_kwargs"]["learning_rate"]),
                     precision)


def run(bench, seed: int, seconds: float, trace: bool, device="cuda",
        t0: float = T0, err=sys.stderr):
    """One run of ``bench``: ``(result dict, exit code)``; the result is
    None where the run may print none."""
    import torch

    from portbench import trace as tracing

    if device == "cuda" and not _cuda_ready(bench, err):
        return None, 3
    drv = core.load_driver(bench.cell["driver"]).Driver(bench, seed, device)
    layout = dict(lead=drv.lead, window=drv.window, batch=drv.batch,
                  shapes=drv.shapes)
    prog = drv.first_steps()
    drv.epoch()     # one epoch as the window runs it: the allocator's pools
    _sync()
    on_card = device == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if on_card else None
    gc.collect()    # nothing of the set-up's left alive into the window
    if on_card:     # (the allocator keeps its pools: no cudaMalloc in it)
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    tr = None
    if trace:
        epochs = int(bench.cell["trace_epochs"])
        tr = tracing.traced(lambda: [drv.epoch() for _ in range(epochs)])
        window_s = tr.host_s
    else:
        start, epochs = time.perf_counter(), 0
        while True:
            drv.epoch()
            epochs += 1
            if time.perf_counter() - start >= seconds:
                break
        _sync()
        window_s = time.perf_counter() - start
    window_peak = torch.cuda.max_memory_allocated() if on_card else None
    done = {k: v * epochs for k, v in drv.counts.items()}
    drv.release()
    del drv

    ctx = Context(bench=bench, setup_s=setup_s, window_s=window_s,
                  done=done, window_peak_bytes=window_peak, trace=tr,
                  lead=layout["lead"], window=layout["window"],
                  batch=layout["batch"],
                  precision=PRECISION[bench.config["kwargs"]["dtype"]])
    metrics = {}
    for m in (bench.per_layer if trace else bench.end_to_end):
        value = core.load_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ref = reference_readings(bench, layout, seed, device)
    numbers = core.compare(prog, ref)
    correct, checks = core.judge(numbers, bench.cell["limits"])

    loaded = core.forbidden_modules()
    if loaded:
        print(f"portbench: forbidden modules loaded: {', '.join(loaded)}",
              file=err)
        return None, 4
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(bench.workload["chips"]),
           "memory_peak_bytes": max(setup_peak or 0, window_peak or 0)}
    result = {"correct": bool(correct), "attempted": done["windows"],
              "failed": sum(1 for x in prog["loss"] if not math.isfinite(x)),
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    for name, (value, leaf) in numbers.items():
        where = f" (worst leaf {leaf})" if leaf else ""
        print(f"check {name}: {value!r} limit {checks[name]['limit']!r}"
              f"{where}", file=err)
    result["checks"] = checks
    return result, 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fix_environment()
    bench = core.resolve(args.workload)
    result, code = run(bench, args.seed, args.seconds, bool(args.trace))
    if result is not None:
        sys.stdout.write(json.dumps(result) + "\n")
        sys.stdout.flush()
    return code


if __name__ == "__main__":
    sys.exit(main())
