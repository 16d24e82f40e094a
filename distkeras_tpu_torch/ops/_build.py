"""Build-on-first-use for the hand-written CUDA kernels.

Every ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers: a build takes seconds, not minutes). Libraries land in
``distkeras_tpu_torch/_build/`` under a name that carries a hash of the
source, of every shared header (``csrc/*.cuh``) and of the flags, so an
edited kernel or header never loads a stale build. :func:`build` starts
one ``nvcc`` per source, all at once, and waits for them; :func:`load`
builds what it needs and returns the bound library. A failed build raises
with ``nvcc``'s stderr — there is no fallback.

Each build keeps ``ptxas -v``'s report beside its library
(:func:`ptxas_report` parses registers and spills per kernel), and
:func:`sass_counts` counts instructions of the built library by opcode
(``cuobjdump -sass``): the check that a kernel reaches the tensor cores
through ``HGMMA`` (wgmma) and loads through ``UTMALDG`` (TMA).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("quant", "flash_attention", "flash_attention_bwd", "adam", "lstm",
           "fused_ce", "moe_gemm")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source_path(name),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _log_path(name: str) -> str:
    return _library_path(name)[:-len(".so")] + ".ptxas.txt"


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = f"/usr/local/cuda/bin/{name}"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        f"{name} not found (neither on PATH nor at /usr/local/cuda/bin): the "
        f"CUDA kernels of distkeras_tpu_torch build on a machine with the "
        f"CUDA toolkit"
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
        cmd = [_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, source_path(name)]
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
        with open(f"{tmp}.log", "w") as f:
            f.write(err)
        os.replace(f"{tmp}.log", _log_path(name))
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


_count_lock = threading.Lock()


def count_launch(fn, attr: str = "launches") -> None:
    """Add one to a kernel wrapper's launch counter (``fn.<attr>``) under a
    lock: worker threads launch kernels at the same time, and ``+= 1`` on
    an attribute is not atomic. Readers and resets use the attribute as
    before."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)


def count_launch_at(fn, attr: str, key) -> None:
    """Add one to entry ``key`` of a kernel wrapper's dict counter
    (``fn.<attr>``), under the same lock."""
    with _count_lock:
        counts = getattr(fn, attr)
        counts[key] = counts.get(key, 0) + 1


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptxas_report(text: str) -> dict[str, dict]:
    """Per kernel (mangled name) of a ``ptxas -v`` report: ``registers``,
    ``spill_stores`` and ``spill_loads`` (bytes), ``stack`` (bytes)."""
    out: dict[str, dict] = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([\w$.]+)'?", line)
        if m:
            current = out.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            current.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return out


def build_log(name: str) -> str:
    """``nvcc``'s report (``ptxas -v``, warnings) of the current build of
    ``csrc/<name>.cu``."""
    build((name,))
    with open(_log_path(name)) as f:
        return f.read()


def count_sass(text: str, opcodes) -> dict[str, dict[str, int]]:
    """Per function of a ``cuobjdump -sass`` listing, how many instructions
    start with each of ``opcodes`` (``HGMMA`` counts ``HGMMA.64x128x16…``)."""
    out: dict[str, dict[str, int]] = {}
    counts = None
    for line in text.splitlines():
        m = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if m:
            counts = out.setdefault(m.group(1), {op: 0 for op in opcodes})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if m and counts is not None:
            op = m.group(1).split(".")[0]
            if op in counts:
                counts[op] += 1
    return out


def sass_counts(name: str, opcodes=("HGMMA", "UTMALDG")) -> dict:
    """:func:`count_sass` over the built library of ``csrc/<name>.cu``."""
    build((name,))
    text = subprocess.run([_tool("cuobjdump"), "-sass", _library_path(name)],
                          capture_output=True, text=True, check=True).stdout
    return count_sass(text, opcodes)
