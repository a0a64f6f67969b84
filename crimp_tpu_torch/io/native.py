"""ctypes bindings for the native event-I/O runtime (native/crimpio.cpp).

Port of ``crimp_tpu/io/native.py``, with JAX's functions (``load``,
``read_columns``, ``filter_energy``, ``phase_histogram``) and contract: the
library is a large-file accelerator, not a correctness dependency, and
every caller tolerates ``load() is None`` by taking the pure-Python FITS
layer (``io/fitsio``) or ``np.histogram``, which give the same bits.

The source is the repository's ``native/crimpio.cpp``, which the JAX
package owns; this module never writes beside it. It compiles it with
``g++`` and ``native/Makefile``'s flags into ``build/native/libcrimpio.so``
of the checkout, when the library is missing or older than the source (a
compile to a temporary name, then ``os.replace``, so concurrent processes
never load a half-written file). ``BUILD_INFO`` says how the last
``load()`` went.

This is host I/O, not the card: a fallback is allowed, but it is counted.
Each caller that takes the pure path because the library is unavailable
calls :func:`note_fallback`, which adds to the obs counter
``native_fallbacks`` and logs one line.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading
import time

import numpy as np

from crimp_tpu_torch import obs
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "crimpio.cpp"
LIB_PATH = ROOT / "build" / "native" / "libcrimpio.so"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]  # native/Makefile's CXXFLAGS

# path, seconds, cached; "error" when the build or the load failed
BUILD_INFO: dict = {}

_lib = None
_load_attempted = False
_LOCK = threading.Lock()


def build() -> pathlib.Path:
    """Compile ``native/crimpio.cpp`` into ``build/native/libcrimpio.so``
    unless the library is newer than the source; returns its path. Raises
    ``OSError`` without ``g++`` (or a source) and
    ``subprocess.CalledProcessError`` when the compiler fails."""
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
        BUILD_INFO.update(path=str(LIB_PATH), seconds=0.0, cached=True)
        return LIB_PATH
    cxx = shutil.which("g++")
    if cxx is None:
        raise OSError("g++ not found: the native reader cannot be built")
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp.so")
    t0 = time.perf_counter()
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], check=True, capture_output=True)
        os.replace(tmp, LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)
    BUILD_INFO.update(path=str(LIB_PATH), seconds=time.perf_counter() - t0, cached=False)
    return LIB_PATH


def load() -> ctypes.CDLL | None:
    """The loaded library, building it first if necessary; None on failure
    (tried once per process)."""
    global _lib, _load_attempted
    with _LOCK:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.CalledProcessError) as exc:
            BUILD_INFO["error"] = str(exc)
            logger.info("native crimpio unavailable (%s); using the pure-Python FITS path", exc)
            return None
        dp, vp = ctypes.POINTER(ctypes.c_double), ctypes.c_void_p
        lib.cio_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(vp)]
        lib.cio_open.restype = ctypes.c_int
        lib.cio_close.argtypes = [vp]
        lib.cio_find_hdu.argtypes = [vp, ctypes.c_char_p]
        lib.cio_find_hdu.restype = ctypes.c_int
        lib.cio_n_rows.argtypes = [vp, ctypes.c_int]
        lib.cio_n_rows.restype = ctypes.c_long
        lib.cio_read_column_f64.argtypes = [vp, ctypes.c_int, ctypes.c_char_p, dp]
        lib.cio_read_column_f64.restype = ctypes.c_int
        lib.cio_filter_energy.argtypes = [dp, dp, ctypes.c_long, ctypes.c_double, ctypes.c_double,
                                          ctypes.c_double, ctypes.c_double, dp, dp]
        lib.cio_filter_energy.restype = ctypes.c_long
        lib.cio_phase_histogram.argtypes = [dp, ctypes.c_long, ctypes.c_double, ctypes.c_long,
                                            ctypes.POINTER(ctypes.c_int64)]
        lib.cio_phase_histogram.restype = ctypes.c_int
        _lib = lib
        return _lib


def note_fallback(what: str) -> None:
    """Count one fallback to the pure path (obs counter
    ``native_fallbacks``) and log it."""
    obs.counter_add("native_fallbacks")
    logger.warning("native reader unavailable for %s (%s); took the pure path", what,
                   BUILD_INFO.get("error", "see the log"))


def _as_double_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def read_columns(path: str, extname: str, columns: list[str]) -> dict[str, np.ndarray] | None:
    """Read scalar columns of a BINTABLE extension as f64; None if the
    library, the file, the extension or a column is unavailable."""
    lib = load()
    if lib is None:
        return None
    handle = ctypes.c_void_p()
    if lib.cio_open(str(path).encode(), ctypes.byref(handle)) != 0:
        return None
    try:
        hdu = lib.cio_find_hdu(handle, extname.encode())
        if hdu < 0:
            return None
        n = lib.cio_n_rows(handle, hdu)
        if n < 0:
            return None
        out = {}
        for column in columns:
            buf = np.empty(n, dtype=np.float64)
            if lib.cio_read_column_f64(handle, hdu, column.encode(), _as_double_ptr(buf)) != 0:
                return None
            out[column] = buf
        return out
    finally:
        lib.cio_close(handle)


def filter_energy(time: np.ndarray, pi: np.ndarray, scale: float, offset: float, lo: float, hi: float):
    """Fused PI -> keV conversion + band selection: (times kept, keV kept);
    None if unavailable."""
    lib = load()
    if lib is None:
        return None
    time = np.ascontiguousarray(time, dtype=np.float64)
    pi = np.ascontiguousarray(pi, dtype=np.float64)
    time_out = np.empty_like(time)
    kev_out = np.empty_like(pi)
    kept = lib.cio_filter_energy(_as_double_ptr(time), _as_double_ptr(pi), len(time), scale, offset, lo, hi,
                                 _as_double_ptr(time_out), _as_double_ptr(kev_out))
    return time_out[:kept], kev_out[:kept]


def phase_histogram(phases: np.ndarray, upper: float, nbins: int) -> np.ndarray | None:
    """Counts histogram of phases over [0, upper); None if unavailable."""
    lib = load()
    if lib is None:
        return None
    phases = np.ascontiguousarray(phases, dtype=np.float64)
    counts = np.zeros(nbins, dtype=np.int64)
    lib.cio_phase_histogram(_as_double_ptr(phases), len(phases), upper, nbins,
                            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return counts
