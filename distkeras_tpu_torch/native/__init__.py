"""The native parameter server's C++ core, built at first use.

Port of ``distkeras_tpu/native/__init__.py``. ``dkps.cpp`` (a host library
with a plain C interface, its own copy of the JAX package's: its wire
format is the contract between the two packages' clients and servers)
compiles once with the system ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` into ``distkeras_tpu_torch/_build/libdkps-<hash>.so``, the hash
taken over the source and the flags so an edited core never loads a stale
build, and binds through ``ctypes``. A failed build raises with the
compiler's output: nothing falls back to another transport.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "dkps.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_cached: ctypes.CDLL | None = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libdkps-{h.hexdigest()[:16]}.so")


def build() -> float:
    """Compile ``dkps.cpp`` unless its library exists; returns the seconds
    the compile took (0.0 when it was already built)."""
    out = library_path()
    if os.path.exists(out):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cannot build libdkps: g++ unavailable: {e}") \
            from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"cannot build libdkps: g++ failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: concurrent builds race benignly
    return time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every C entry point the port calls."""
    f32p = ctypes.POINTER(ctypes.c_float)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    vp, u8, u32, u64, i64 = (ctypes.c_void_p, ctypes.c_uint8,
                             ctypes.c_uint32, ctypes.c_uint64,
                             ctypes.c_int64)
    sig = {
        "dkps_server_create": (vp, [f32p, u64, ctypes.c_int, ctypes.c_double,
                                    ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_double, ctypes.c_double]),
        "dkps_server_port": (ctypes.c_int, [vp]),
        "dkps_server_start": (ctypes.c_int, [vp]),
        "dkps_server_stop": (None, [vp]),
        "dkps_server_destroy": (None, [vp]),
        "dkps_server_num_updates": (u64, [vp]),
        "dkps_server_get_center": (None, [vp, f32p]),
        "dkps_server_set_center": (None, [vp, f32p]),
        "dkps_server_set_pool_size": (None, [vp, i64]),
        "dkps_server_stats": (None, [vp, u64p]),
        "dkps_server_crash": (None, [vp]),
        "dkps_server_wal_open": (ctypes.c_int, [vp, ctypes.c_char_p, u64,
                                                ctypes.c_double]),
        "dkps_server_set_num_updates": (None, [vp, u64]),
        "dkps_server_evicted": (u64, [vp]),
        "dkps_server_wal_pending": (u64, [vp]),
        "dkps_server_restore_worker": (None, [vp, u32, i64, i64, i64]),
        "dkps_server_fence": (u64, [vp, u64]),
        "dkps_server_fence_epoch": (u64, [vp]),
        "dkps_server_set_trace": (None, [vp, ctypes.c_int]),
        "dkps_server_set_shard": (None, [vp, u32, u32]),
        "dkps_server_get_ema": (ctypes.c_int, [vp, f32p]),
        "dkps_server_set_ema": (ctypes.c_int, [vp, f32p]),
        "dkps_client_from_fd": (vp, [ctypes.c_int, u32, u64]),
        # the shm ring lane: Python maps the segment and both endpoints
        # attach by its base address (dkps.cpp "Shared-memory ring lane")
        "dkps_server_attach_shm": (ctypes.c_int, [vp, vp, u64]),
        "dkps_client_connect_shm": (vp, [vp, u64, u32, u64]),
        "dkps_client_set_timeout_ms": (ctypes.c_int, [vp, ctypes.c_int]),
        "dkps_client_pull": (i64, [vp, f32p]),
        "dkps_client_pull_int8": (i64, [vp, f32p]),
        "dkps_client_commit": (ctypes.c_int, [vp, f32p]),
        "dkps_client_commit_int8": (ctypes.c_int, [
            vp, ctypes.POINTER(ctypes.c_int8), u64p, f32p, u32]),
        "dkps_client_exchange": (i64, [vp, u8, u64, u64, f32p, f32p, u64p]),
        "dkps_client_commit_seq": (ctypes.c_int, [vp, u64, f32p]),
        "dkps_client_commit_seq_e": (ctypes.c_int, [vp, u64, u64, f32p,
                                                    u64p]),
        "dkps_client_fence": (i64, [vp, u64]),
        "dkps_client_heartbeat": (ctypes.c_int, [vp, u32]),
        "dkps_client_deregister": (ctypes.c_int, [vp]),
        "dkps_client_join": (ctypes.c_int, [vp, u64p, u64p]),
        "dkps_client_drain": (ctypes.c_int, [vp, u8]),
        "dkps_client_trace_scrape": (i64, [vp, u64p, u64]),
        "dkps_client_shard_info": (ctypes.c_int, [
            vp, ctypes.POINTER(u32), ctypes.POINTER(u32), u64p]),
        "dkps_client_close": (None, [vp]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load_dkps() -> ctypes.CDLL:
    """The bound ``libdkps`` (built first if needed), loaded once per
    process. Raises ``RuntimeError`` with the compiler's output when the
    build fails."""
    global _cached
    with _lock:
        if _cached is None:
            build()
            _cached = _bind(ctypes.CDLL(library_path()))
        return _cached


__all__ = ["build", "load_dkps", "library_path", "SOURCE", "BUILD_DIR"]
