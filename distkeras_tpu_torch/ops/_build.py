"""Build-on-first-use for the hand-written CUDA kernels.

Every ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers: a build takes seconds, not minutes). Libraries land in
``distkeras_tpu_torch/_build/`` under a name that carries a hash of the
source, so an edited kernel never loads a stale build. :func:`build` starts
one ``nvcc`` per source, all at once, and waits for them; :func:`load`
builds what it needs and returns the bound library. A failed build raises
with ``nvcc``'s stderr — there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("quant", "flash_attention", "flash_attention_bwd", "adam", "lstm")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "CUDA kernels of distkeras_tpu_torch build on a machine with the "
        "CUDA toolkit"
    )


def build(names=KERNELS) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    process per source, all started together. Returns seconds per name
    (0.0 for a library that was already built)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    seconds = {}
    t0 = time.perf_counter()
    for name in names:
        out = _library_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        _, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {source_path(name)}:\n{err}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders race benignly
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, bind) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it first if
    needed), loaded once per process; ``bind(lib)`` declares its
    functions' ``argtypes``/``restype`` on that first load."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(_library_path(name))
            bind(lib)
            _loaded[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
