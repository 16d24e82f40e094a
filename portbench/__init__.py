"""The benchmark of ``distkeras_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell once and prints one JSON line::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``cells/<cell>.json`` (the driver and the trainer's settings),
``drivers/<driver>.py`` (how a window drives one path of the port) and
``metrics/<metric>.py`` (one reader per metric). ``flops/`` holds the
operations and bytes of each kernel and model and the table of peaks;
``reference/`` the plain PyTorch reference that decides ``correct``.
Nothing here imports ``jax``, ``jaxlib``, ``flax``, ``distkeras_tpu`` or
``distkeras``.
"""
