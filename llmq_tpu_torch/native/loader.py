"""ctypes binding of the native queue core, ``native/src/mlq.cpp`` (the
port's own copy of ``llmq_tpu/native/loader.py``, over the same narrow C
ABI: handles in, handles out, error codes back).

The library is built at first use, never at import, with ``g++ -O2
-std=c++17 -fPIC -Wall -Wextra -Werror`` straight from the source into
``llmq_tpu_torch/_build/libmlq-<hash>.so``; the hash of the source and the
flags names the file, so an edited source builds anew. The build is
atomic across processes: under a file lock the compiler writes a
temporary name, which ``os.replace`` moves into place.

``LLMQ_NATIVE_LIB`` names a library to load as it is (no build), e.g. a
sanitizer-instrumented variant; a path that does not load is an error,
never a silent fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

log = logging.getLogger("llmq_tpu_torch.native")

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG.parent / "native" / "src" / "mlq.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-Werror",
             "-shared"]

#: An absolute path loaded as it is in place of the built library.
ENV_OVERRIDE = "LLMQ_NATIVE_LIB"

ERR_NOT_FOUND = -1
ERR_FULL = -2
ERR_EMPTY = -3
ERR_EXISTS = -4

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def library_path() -> Path:
    """Where the library built from :data:`SRC` lies (or will)."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmlq-{digest[:16]}.so"


def build() -> Path:
    """Build the library unless it exists; returns its path. Raises with
    the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libmlq.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():            # another process built it meanwhile
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            try:
                tmp.unlink()
            except OSError:
                pass
            raise RuntimeError(f"g++ failed for {SRC} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    log.info("built the native queue core %s", out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    c_void_p, c_char_p, c_int64 = ctypes.c_void_p, ctypes.c_char_p, \
        ctypes.c_int64
    c_u64p = ctypes.POINTER(ctypes.c_uint64)
    c_dblp = ctypes.POINTER(ctypes.c_double)
    sigs = {
        "mlq_create": (c_void_p, []),
        "mlq_destroy": (None, [c_void_p]),
        "mlq_create_queue": (c_int64, [c_void_p, c_char_p, c_int64]),
        "mlq_remove_queue": (c_int64, [c_void_p, c_char_p]),
        "mlq_has_queue": (c_int64, [c_void_p, c_char_p]),
        "mlq_push": (c_int64, [c_void_p, c_char_p, ctypes.c_uint64,
                               ctypes.c_int32, ctypes.c_double]),
        "mlq_pop": (c_int64, [c_void_p, c_char_p, ctypes.c_double, c_u64p,
                              c_dblp]),
        "mlq_pop_handle": (c_int64, [c_void_p, c_char_p, ctypes.c_uint64,
                                     ctypes.c_double, c_dblp]),
        "mlq_pop_if": (c_int64, [c_void_p, c_char_p, ctypes.c_uint64,
                                 ctypes.c_double]),
        "mlq_peek": (c_int64, [c_void_p, c_char_p, c_u64p]),
        "mlq_size": (c_int64, [c_void_p, c_char_p]),
        "mlq_complete": (c_int64, [c_void_p, c_char_p, ctypes.c_double]),
        "mlq_fail": (c_int64, [c_void_p, c_char_p, ctypes.c_double]),
        "mlq_requeue_accounting": (c_int64, [c_void_p, c_char_p]),
        "mlq_discard": (c_int64, [c_void_p, c_char_p, ctypes.c_uint64]),
        "mlq_stats": (c_int64, [c_void_p, c_char_p,
                                ctypes.POINTER(c_int64), c_dblp]),
        "mlq_queue_names": (c_int64, [c_void_p, c_char_p, c_int64]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load_native() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it cannot be built here (the
    failure is logged once). The ``LLMQ_NATIVE_LIB`` override raises
    instead."""
    global _lib, _load_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        override = os.environ.get(ENV_OVERRIDE, "")
        if override:
            lib = ctypes.CDLL(override)
        else:
            if _load_failed:
                return None
            try:
                lib = ctypes.CDLL(str(build()))
            except Exception as e:  # noqa: BLE001 — any failure: no core
                log.warning("native queue core unavailable: %s", e)
                _load_failed = True
                return None
        _bind(lib)
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


def loaded_path() -> Optional[str]:
    """The path of the loaded library (None before the first load)."""
    return None if _lib is None else _lib._name


class NativeMLQ:
    """Thin wrapper over the C ABI. Raises nothing once built; returns
    error codes, which ``MultiLevelQueue`` maps to typed exceptions."""

    def __init__(self) -> None:
        lib = load_native()
        if lib is None:
            raise RuntimeError("native queue core unavailable")
        self._lib = lib
        self._h = ctypes.c_void_p(lib.mlq_create())

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h and getattr(self, "_lib", None) is not None:
            try:
                self._lib.mlq_destroy(h)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass
            self._h = None

    def create_queue(self, name: str, capacity: int) -> int:
        return self._lib.mlq_create_queue(self._h, name.encode(), capacity)

    def remove_queue(self, name: str) -> int:
        return self._lib.mlq_remove_queue(self._h, name.encode())

    def has_queue(self, name: str) -> bool:
        return bool(self._lib.mlq_has_queue(self._h, name.encode()))

    def push(self, name: str, handle: int, priority: int,
             enqueue_ts: float) -> int:
        return self._lib.mlq_push(self._h, name.encode(), handle, priority,
                                  enqueue_ts)

    def pop(self, name: str, now: float) -> Tuple[int, int, float]:
        """(err, handle, wait)."""
        out_h = ctypes.c_uint64(0)
        out_w = ctypes.c_double(0.0)
        err = self._lib.mlq_pop(self._h, name.encode(), now,
                                ctypes.byref(out_h), ctypes.byref(out_w))
        return err, out_h.value, out_w.value

    def pop_handle(self, name: str, handle: int,
                   now: float) -> Tuple[int, float]:
        """Pop one given pending handle with pop accounting: (err, wait)."""
        out_w = ctypes.c_double(0.0)
        err = self._lib.mlq_pop_handle(self._h, name.encode(), handle, now,
                                       ctypes.byref(out_w))
        return err, out_w.value

    def pop_if(self, name: str, expected_handle: int, now: float) -> int:
        """Pop only if the top is still ``expected_handle``: 0, -5 (the
        top changed) or an error code."""
        return self._lib.mlq_pop_if(self._h, name.encode(), expected_handle,
                                    now)

    def peek(self, name: str) -> Tuple[int, int]:
        out_h = ctypes.c_uint64(0)
        err = self._lib.mlq_peek(self._h, name.encode(), ctypes.byref(out_h))
        return err, out_h.value

    def size(self, name: str) -> int:
        return self._lib.mlq_size(self._h, name.encode())

    def complete(self, name: str, process_time: float) -> int:
        return self._lib.mlq_complete(self._h, name.encode(), process_time)

    def fail(self, name: str, process_time: float) -> int:
        return self._lib.mlq_fail(self._h, name.encode(), process_time)

    def requeue_accounting(self, name: str) -> int:
        return self._lib.mlq_requeue_accounting(self._h, name.encode())

    def discard(self, name: str, handle: int) -> int:
        return self._lib.mlq_discard(self._h, name.encode(), handle)

    def stats(self, name: str) -> Tuple[int, List[int], List[float]]:
        out_i = (ctypes.c_int64 * 5)()
        out_d = (ctypes.c_double * 2)()
        err = self._lib.mlq_stats(self._h, name.encode(), out_i, out_d)
        return err, list(out_i), list(out_d)

    def queue_names(self) -> List[str]:
        # ERR_FULL means the buffer was too small: retry with a doubled
        # one (folding it into "no queues" would hide every queue).
        size = 1 << 16
        while True:
            buf = ctypes.create_string_buffer(size)
            n = self._lib.mlq_queue_names(self._h, buf, len(buf))
            if n == ERR_FULL:
                size *= 2
                if size > (1 << 28):
                    raise RuntimeError(
                        "mlq_queue_names overflow: registry exceeds 256MB")
                continue
            if n <= 0:
                return []
            return buf.value.decode().split("\n")
