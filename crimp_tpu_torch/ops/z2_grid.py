"""The uniform-grid Z^2 tile kernel for Hopper and its plain PyTorch twin.

Counterpart of ``crimp_tpu/ops/pallas_z2.py``. Two kernels live in
``csrc/z2_grid.cu`` (CUDA C++ for ``sm_90a``), built with ``nvcc`` into
``build/kernels/`` on first use and bound with ``ctypes``:

- ``probe`` (K1) replaces ``pallas_minimal_probe``: sum(x + 1) over one
  (8, 128) f32 block, 524800 for ``arange(1024)``. It tells a toolchain
  failure from a kernel failure.
- ``z2_tile_sums`` (K2) replaces ``_make_kernel``/``_tile_chunk_sums``: for
  every (fdot, trial tile) and trial j_lo in the tile it forms
  phase = [frac(f_tile*t) + frac(fdot*t^2/2)] + j_lo*frac(df*t) with the f64
  rows reduced by ``centered_frac`` and cast to f32, re-reduces in f32,
  evaluates the polynomial sin/cos pair, runs the Chebyshev recurrence to
  ``nharm`` and returns the weighted sums C_k, S_k.

Each wrapper takes a CPU tensor to its plain twin (``probe_reference``,
``z2_tile_sums_reference``: the same math in torch ops). A CUDA tensor
launches the kernel or raises; nothing falls back. ``LAUNCHES`` counts,
per wrapper, the calls that launched its kernel (one ``z2_tile_sums`` call
launches ``z2_tile_kernel``, plus ``z2_reduce_splits`` when the events are
split across blocks), so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

from crimp_tpu_torch.ops import fasttrig, search

TRIAL_TILE = 256  # trials per tile = threads per block of K2
EVENT_CHUNK = 1024  # events staged per shared-memory chunk (and twin chunk)
MAX_NHARM = 20  # K2 keeps 4*nharm f32 accumulators per thread in registers

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "z2_grid.cu"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"probe": 0, "z2_tile_sums": 0}

_LIB = None
_LIB_LOCK = threading.Lock()
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the Z^2 kernels need the CUDA toolkit")


def build(force: bool = False) -> pathlib.Path:
    """Compile ``csrc/z2_grid.cu`` into ``build/kernels/`` (keyed by the
    source and flags' hash); records the compiler's ``-Xptxas -v`` report
    and the build time in ``BUILD_INFO``."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libz2grid_{key}.so"
    if out.exists() and not force:
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True, log="")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=seconds, cached=False,
                      log=(proc.stdout + proc.stderr).strip())
    return out


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            lib.z2_probe.argtypes = [vp, vp, ci, vp]
            lib.z2_probe.restype = ci
            lib.z2_grid_sums.argtypes = [vp, ci, cd, cd, cd, vp, ci, ci, ci, ci, ci, vp, vp, vp]
            lib.z2_grid_sums.restype = ci
            _LIB = lib
    return _LIB


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K1: the build-and-launch probe
# ---------------------------------------------------------------------------


def probe_reference(x: torch.Tensor) -> torch.Tensor:
    """sum(x + 1) in torch ops (0-d f32 tensor)."""
    return torch.sum(x + 1.0)


def probe(x: torch.Tensor) -> torch.Tensor:
    """sum(x + 1) over an (8, 128) f32 block: the kernel on a CUDA tensor,
    the twin on a CPU tensor."""
    if x.dtype != torch.float32 or tuple(x.shape) != (8, 128) or not x.is_contiguous():
        raise ValueError("probe takes one contiguous (8, 128) float32 block")
    if x.device.type == "cpu":
        return probe_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"probe: unsupported device {x.device}")
    out = torch.empty((), dtype=torch.float32, device=x.device)
    rc = _lib().z2_probe(x.data_ptr(), out.data_ptr(), x.numel(), _stream(x))
    _check(rc, "z2_probe")
    LAUNCHES["probe"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: uniform-grid tile sums
# ---------------------------------------------------------------------------


def _f_tiles(f0: float, df: float, n_tiles: int, dtype, device) -> torch.Tensor:
    # f0 + tile * (T*df): the association of pallas_z2.py:208
    return f0 + torch.arange(n_tiles, dtype=dtype, device=device) * (TRIAL_TILE * df)


def z2_tile_sums_reference(times: torch.Tensor, f0: float, df: float,
                           half_fdots: torch.Tensor, n_tiles: int, nharm: int,
                           event_chunk: int = EVENT_CHUNK) -> torch.Tensor:
    """Plain twin of K2: (2, n_fdot, n_tiles, nharm, TRIAL_TILE) f32 sums.

    ``times`` are f64 seconds (pre-centered), ``half_fdots`` f64 0.5*fdot
    per row. Events are taken in chunks of ``event_chunk`` (the last padded
    with weight-0 events that add exactly +0.0); per-chunk f32 sums
    accumulate in f32 across chunks, as the Pallas kernel does.
    """
    dev = times.device
    n = times.shape[0]
    n_fdot = half_fdots.shape[0]
    f_tiles = _f_tiles(f0, df, n_tiles, torch.float64, dev)
    j_lo = torch.arange(TRIAL_TILE, dtype=torch.float32, device=dev)
    acc = torch.zeros(2, n_fdot, n_tiles, nharm, TRIAL_TILE, dtype=torch.float32, device=dev)
    for e0 in range(0, n, event_chunk):
        t = times[e0:e0 + event_chunk]
        w = torch.ones(event_chunk, dtype=torch.float32, device=dev)
        if t.shape[0] < event_chunk:
            pad = event_chunk - t.shape[0]
            w[t.shape[0]:] = 0.0
            t = torch.cat([t, torch.zeros(pad, dtype=t.dtype, device=dev)])
        b = fasttrig.centered_frac(df * t).to(torch.float32)
        rows_t = fasttrig.centered_frac(f_tiles[:, None] * t[None, :]).to(torch.float32)
        tt = t * t
        for i in range(n_fdot):
            row_q = fasttrig.centered_frac(half_fdots[i] * tt).to(torch.float32)
            base = rows_t + row_q  # pure f32, (n_tiles, EC)
            phase = base[:, None, :] + j_lo[None, :, None] * b  # (n_tiles, T, EC)
            sin1, cos1 = fasttrig.sincos_cycles(fasttrig.centered_frac(phase))
            c, s = search.chebyshev_weighted_sums(cos1, sin1, w, nharm)  # (nharm, n_tiles, T)
            acc[0, i] += c.transpose(0, 1)
            acc[1, i] += s.transpose(0, 1)
    return acc


def _n_split(n_blocks: int, n_chunks: int, device: torch.device) -> int:
    """Event splits per (fdot, tile) block so the grid fills the card: about
    four blocks of TRIAL_TILE threads per SM, never more splits than chunks."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n_chunks, math.ceil(4 * sms / n_blocks)))


def z2_tile_sums(times: torch.Tensor, f0: float, df: float, half_fdots: torch.Tensor,
                 n_tiles: int, nharm: int) -> torch.Tensor:
    """(2, n_fdot, n_tiles, nharm, TRIAL_TILE) f32 trig sums over the grid
    f0 + (tile*TRIAL_TILE + j_lo)*df for each fdot row: K2 on a CUDA tensor,
    the twin on a CPU tensor."""
    if times.dtype != torch.float64 or times.dim() != 1 or not times.is_contiguous():
        raise ValueError("z2_tile_sums takes contiguous 1-D float64 times")
    if half_fdots.dtype != torch.float64 or half_fdots.dim() != 1 or not half_fdots.is_contiguous():
        raise ValueError("z2_tile_sums takes contiguous 1-D float64 half_fdots")
    if half_fdots.device != times.device:
        raise ValueError("times and half_fdots must share a device")
    if not 1 <= nharm <= MAX_NHARM:
        raise ValueError(f"nharm must be in [1, {MAX_NHARM}], got {nharm}")
    if n_tiles < 1 or times.shape[0] < 1 or half_fdots.shape[0] < 1:
        raise ValueError("empty grid or event list")
    if times.shape[0] >= 2**31 - EVENT_CHUNK:
        raise ValueError("z2_tile_sums indexes events with 32-bit ints")
    if times.device.type == "cpu":
        return z2_tile_sums_reference(times, f0, df, half_fdots, n_tiles, nharm)
    if times.device.type != "cuda":
        raise ValueError(f"z2_tile_sums: unsupported device {times.device}")
    n = times.shape[0]
    n_fdot = half_fdots.shape[0]
    n_chunks = -(-n // EVENT_CHUNK)
    n_split = _n_split(n_fdot * n_tiles, n_chunks, times.device)
    per_split = -(-n_chunks // n_split) * EVENT_CHUNK
    n_split = -(-n // per_split)
    shape = (2, n_fdot, n_tiles, nharm, TRIAL_TILE)
    out = torch.empty(shape, dtype=torch.float32, device=times.device)
    partial = (torch.empty((n_split,) + shape, dtype=torch.float32, device=times.device)
               if n_split > 1 else out)
    rc = _lib().z2_grid_sums(
        times.data_ptr(), n, float(f0), float(TRIAL_TILE * df), float(df),
        half_fdots.data_ptr(), n_fdot, n_tiles, nharm, n_split, per_split,
        partial.data_ptr(), out.data_ptr(), _stream(times),
    )
    _check(rc, "z2_grid_sums")
    LAUNCHES["z2_tile_sums"] += 1
    return out


def flops_per_pair(nharm: int) -> int:
    """f32 FLOPs K2 spends per (trial, event) pair, FMA counted as 2: phase
    (mul, add) 2 + f32 centered_frac 3 + polynomial sin/cos 24 + first
    harmonic sums 2 + 2*cos1 1 + 6 per further harmonic (two recurrences
    as FMA, two sums)."""
    return 26 + 6 * nharm
