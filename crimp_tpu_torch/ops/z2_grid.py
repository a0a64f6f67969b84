"""The uniform-grid Z^2 tile kernel for Hopper and its plain PyTorch twin.

Counterpart of ``crimp_tpu/ops/pallas_z2.py``. Two kernels live in
``csrc/z2_grid.cu`` (CUDA C++ for ``sm_90a``), built with ``nvcc`` into
``build/kernels/`` on first use and bound with ``ctypes``:

- ``probe`` (K1) replaces ``pallas_minimal_probe``: sum(x + 1) over one
  (8, 128) f32 block, 524800 for ``arange(1024)``. It tells a toolchain
  failure from a kernel failure.
- ``z2_tile_sums`` (K2) replaces ``_make_kernel``/``_tile_chunk_sums``: for
  every (fddot, fdot, trial tile) and trial j_lo in the tile it forms
  phase = [(frac(f_tile*t) + frac(fdot*t^2/2)) + frac(fdd*t^3/6)]
  + j_lo*frac(df*t) with the f64 rows reduced by ``centered_frac`` and cast
  to f32, re-reduces in f32, evaluates the sin/cos pair (the polynomial, or
  f32 sin/cos of 2*pi*frac), runs the Chebyshev recurrence to ``nharm`` and
  returns the (optionally weighted) sums C_k, S_k.

``build()`` compiles every source of ``csrc/`` (this one, K3's
``z2_general.cu`` and K4's ``deltafold.cu``), one ``nvcc`` per source, all
started together, into ``build_dir()`` (``build/kernels/`` unless
CRIMP_TORCH_COMPILE_CACHE says otherwise).

Each wrapper takes a CPU tensor to its plain twin (``probe_reference``,
``z2_tile_sums_reference``: the same math in torch ops). A CUDA tensor
launches the kernel or raises; nothing falls back. A missing ``nvcc``, a
failed build and a launch that returns a CUDA error raise ``KernelError``
(``resilience.taxonomy``), which no degradation ladder catches. ``LAUNCHES`` counts,
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
import re
import shutil
import subprocess
import threading
import time

import torch

from crimp_tpu_torch.ops import fasttrig, search
from crimp_tpu_torch.resilience.taxonomy import KernelError
from crimp_tpu_torch.utils import profiling

TRIAL_TILE = 256  # trials per tile = threads per block of K2
EVENT_CHUNK = 1024  # events staged per shared-memory chunk (and twin chunk)
MAX_NHARM = 20  # K2 keeps 4*nharm f32 accumulators per thread in registers
MAX_ROWS = 65535  # n_fddot * n_fdot rides gridDim.y

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"z2_grid": CSRC / "z2_grid.cu", "z2_general": CSRC / "z2_general.cu",
           "deltafold": CSRC / "deltafold.cu"}
SOURCE = SOURCES["z2_grid"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {"probe": 0, "z2_tile_sums": 0}

_LIB = None
_LIB_LOCK = threading.Lock()
# per source: path, seconds, cached, log; "seconds" is the wall time of the
# last (parallel) build, "built" / "reused" count the libraries compiled and
# found in the build directory over the process
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
    raise KernelError("nvcc not found: the Z^2 kernels need the CUDA toolkit")


_TMP_BUILD_DIR: pathlib.Path | None = None


def build_dir() -> pathlib.Path:
    """Where ``build()`` puts the libraries: ``utils/platform``'s build
    directory (CRIMP_TORCH_COMPILE_CACHE, default ``build/kernels/``), or a
    per-process temporary directory when that is disabled."""
    global _TMP_BUILD_DIR
    from crimp_tpu_torch.utils import platform

    target = platform.configure_compilation_cache()
    if target is not None:
        return target
    if _TMP_BUILD_DIR is None:
        import tempfile

        _TMP_BUILD_DIR = pathlib.Path(tempfile.mkdtemp(prefix="crimp_tpu_torch_kernels_"))
    return _TMP_BUILD_DIR


def build(force: bool = False) -> dict:
    """Compile every ``csrc/*.cu`` into ``build_dir()`` (each keyed by its
    source and flags' hash), one ``nvcc`` process per source, all started
    together. Records each compiler's ``-Xptxas -v`` report and time in
    ``BUILD_INFO``; returns {name: library path}."""
    out_dir = build_dir()
    paths, running = {}, {}
    t0 = time.perf_counter()
    for name, src_path in SOURCES.items():
        src = src_path.read_bytes()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = out_dir / f"lib{name}_{key}.so"
        paths[name] = out
        if out.exists() and not force:
            BUILD_INFO[name] = dict(path=str(out), seconds=0.0, cached=True, log="")
            BUILD_INFO["reused"] = BUILD_INFO.get("reused", 0) + 1
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src_path)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {SOURCES[name].name} failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[name] = dict(path=str(out), seconds=seconds, cached=False, log=log.strip())
        BUILD_INFO["built"] = BUILD_INFO.get("built", 0) + 1
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    if failed:
        raise KernelError("\n".join(failed))
    return paths


def ptxas_entries(text: str) -> list[dict]:
    """Each kernel of an ``nvcc -Xptxas -v`` report: mangled ``name``,
    ``registers``, ``stack`` (bytes of stack frame) and ``spill`` (bytes of
    spill stores plus loads)."""
    entries, current, props = [], None, {}
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = dict(name=m.group(1), registers=0, stack=0, spill=0)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = {"name": m.group(1)}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None and props.get("name") == current["name"]:
            current.update(stack=int(m.group(1)), spill=int(m.group(2)) + int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
            entries.append(current)
            current = None
    return entries


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()["z2_grid"]))
            vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            lib.z2_probe.argtypes = [vp, vp, ci, vp]
            lib.z2_probe.restype = ci
            lib.z2_empty.argtypes = [vp]
            lib.z2_empty.restype = ci
            lib.z2_grid_sums.argtypes = [vp, ci, cd, cd, cd, vp, ci, vp, ci, vp, ci, ci, ci,
                                         ci, ci, ci, vp, vp, vp]
            lib.z2_grid_sums.restype = ci
            _LIB = lib
    return _LIB


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"{name}: CUDA error {rc} at launch")


def to_host(t: torch.Tensor, name: str):
    """``t.cpu().numpy()`` for a hand kernel's output. The launch is
    asynchronous, so a fault of the kernel on the card shows at this copy:
    it raises ``KernelError``, which no ladder takes for a rung."""
    try:
        return t.cpu().numpy()
    except RuntimeError as exc:
        if t.device.type != "cuda":
            raise
        raise KernelError(f"{name}: device fault seen at the copy to the host: {exc}") from exc


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def n_split_for(n_blocks: int, n_chunks: int, device: torch.device) -> int:
    """Event splits per block of the grid so it fills the card: about four
    blocks of 256 threads per SM, never more splits than chunks."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n_chunks, math.ceil(4 * sms / n_blocks)))


def default_per_split(n_events: int, n_blocks: int, device: torch.device) -> int:
    """K2's static launch plan: the event split length that gives each of
    the grid's ``n_blocks`` (tile, row) blocks ``n_split_for`` splits on the
    card; one split (every event) off the card, where the twin runs."""
    n_chunks = -(-int(n_events) // EVENT_CHUNK)
    if torch.device(device).type != "cuda":
        return max(1, n_chunks) * EVENT_CHUNK
    n_split = n_split_for(n_blocks, n_chunks, torch.device(device))
    return -(-n_chunks // n_split) * EVENT_CHUNK


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
    with torch.cuda.device(x.device):
        rc = _lib().z2_probe(x.data_ptr(), out.data_ptr(), x.numel(), stream_of(x))
    check_launch(rc, "z2_probe")
    LAUNCHES["probe"] += 1
    return out


def empty_launch(device: torch.device) -> None:
    """Launch a kernel that does nothing, through the same ctypes path as
    the probe: the floor under any launch's time. Not a port of anything,
    so not counted in ``LAUNCHES``."""
    with torch.cuda.device(device):
        check_launch(_lib().z2_empty(torch.cuda.current_stream(device).cuda_stream), "z2_empty")


# ---------------------------------------------------------------------------
# K2: uniform-grid tile sums
# ---------------------------------------------------------------------------


def _f_tiles(f0: float, df: float, n_tiles: int, dtype, device, tile0: int = 0) -> torch.Tensor:
    # f0 + tile * (T*df): the association of pallas_z2.py:208
    return f0 + (torch.arange(n_tiles, dtype=dtype, device=device) + tile0) * (TRIAL_TILE * df)


def z2_tile_sums_reference(times: torch.Tensor, f0: float, df: float,
                           half_fdots: torch.Tensor, n_tiles: int, nharm: int,
                           event_chunk: int = EVENT_CHUNK, sixth_fddots: torch.Tensor | None = None,
                           weights: torch.Tensor | None = None, poly: bool = True,
                           per_split: int | None = None, tile0: int = 0) -> torch.Tensor:
    """Plain twin of K2: (2, n_fdot, n_tiles, nharm, TRIAL_TILE) f32 sums, or
    (2, n_fddot, n_fdot, n_tiles, nharm, TRIAL_TILE) with ``sixth_fddots``,
    for the tiles [tile0, tile0 + n_tiles) of the grid that starts at f0.

    ``times`` are f64 seconds (pre-centered), ``half_fdots`` f64 0.5*fdot
    and ``sixth_fddots`` f64 fdd/6 per row, ``weights`` optional f32 per
    event. Events are taken in chunks of ``event_chunk`` (the last padded
    with weight-0 events that add exactly +0.0); per-chunk f32 sums
    accumulate in f32 across chunks, as the Pallas kernel does. With
    ``per_split`` the events are cut into ranges of that many, each summed
    from zero, and the ranges added in order, as the kernel's split plan.
    """
    n = times.shape[0]
    if per_split is not None and per_split < n:
        parts = [z2_tile_sums_reference(times[e0:e0 + per_split], f0, df, half_fdots, n_tiles,
                                        nharm, event_chunk, sixth_fddots,
                                        None if weights is None else weights[e0:e0 + per_split],
                                        poly, tile0=tile0)
                 for e0 in range(0, n, per_split)]
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out
    dev = times.device
    n_fdot = half_fdots.shape[0]
    sixth = torch.zeros(1, dtype=torch.float64, device=dev) if sixth_fddots is None else sixth_fddots
    f_tiles = _f_tiles(f0, df, n_tiles, torch.float64, dev, tile0)
    j_lo = torch.arange(TRIAL_TILE, dtype=torch.float32, device=dev)
    acc = torch.zeros(2, sixth.shape[0], n_fdot, n_tiles, nharm, TRIAL_TILE, dtype=torch.float32,
                      device=dev)
    for e0 in range(0, n, event_chunk):
        t = times[e0:e0 + event_chunk]
        w = (torch.ones(t.shape[0], dtype=torch.float32, device=dev) if weights is None
             else weights[e0:e0 + event_chunk])
        if t.shape[0] < event_chunk:
            pad = event_chunk - t.shape[0]
            w = torch.cat([w, torch.zeros(pad, dtype=torch.float32, device=dev)])
            t = torch.cat([t, torch.zeros(pad, dtype=t.dtype, device=dev)])
        b = fasttrig.centered_frac(df * t).to(torch.float32)
        rows_t = fasttrig.centered_frac(f_tiles[:, None] * t[None, :]).to(torch.float32)
        tt = t * t
        for l in range(sixth.shape[0]):
            row_r = (None if sixth_fddots is None
                     else fasttrig.centered_frac(sixth[l] * (tt * t)).to(torch.float32))
            for i in range(n_fdot):
                row_q = fasttrig.centered_frac(half_fdots[i] * tt).to(torch.float32)
                base = rows_t + row_q  # pure f32, (n_tiles, EC)
                if row_r is not None:
                    base = base + row_r  # the association (row_t + row_q) + row_r
                phase = base[:, None, :] + j_lo[None, :, None] * b  # (n_tiles, T, EC)
                frac = fasttrig.centered_frac(phase)
                if poly:
                    sin1, cos1 = fasttrig.sincos_cycles(frac)
                else:
                    theta = (2 * math.pi) * frac
                    sin1, cos1 = torch.sin(theta), torch.cos(theta)
                c, s = search.chebyshev_weighted_sums(cos1, sin1, w, nharm)  # (nharm, n_tiles, T)
                acc[0, l, i] += c.transpose(0, 1)
                acc[1, l, i] += s.transpose(0, 1)
    return acc[:, 0] if sixth_fddots is None else acc


def _check_f64_vector(x: torch.Tensor, name: str, device: torch.device) -> None:
    if x.dtype != torch.float64 or x.dim() != 1 or not x.is_contiguous() or x.shape[0] < 1:
        raise ValueError(f"{name} must be a non-empty contiguous 1-D float64 tensor")
    if x.device != device:
        raise ValueError(f"{name} must lie on the times' device")


def z2_tile_sums(times: torch.Tensor, f0: float, df: float, half_fdots: torch.Tensor,
                 n_tiles: int, nharm: int, *, sixth_fddots: torch.Tensor | None = None,
                 weights: torch.Tensor | None = None, poly: bool = True,
                 per_split: int | None = None, tile0: int = 0, splits: bool = False) -> torch.Tensor:
    """f32 trig sums over the grid f0 + ((tile0 + tile)*TRIAL_TILE + j_lo)*df for each
    fdot row, (2, n_fdot, n_tiles, nharm, TRIAL_TILE), or for each (fddot,
    fdot) row of the cube, (2, n_fddot, n_fdot, n_tiles, nharm, TRIAL_TILE),
    when ``sixth_fddots`` (f64 fdd/6) is given: K2 on a CUDA tensor, the twin
    on a CPU tensor.

    ``weights`` (f32 per event) multiply every harmonic's terms; ``poly``
    picks the polynomial sin/cos (True) or f32 sin/cos of 2*pi*frac;
    ``per_split`` fixes the event split length (a multiple of EVENT_CHUNK;
    default: enough splits to fill the card); ``tile0`` > 0 computes the
    tiles [tile0, tile0 + n_tiles) of the grid that starts at ``f0``, the
    same bits as those tiles of one call over the whole grid. With
    ``splits`` the per-split partial sums come back unreduced, stacked on a
    leading split axis (one entry for a single split): the sharded twins
    add them across event shards in split order, as the kernel's reduce
    adds them.
    """
    if times.dtype != torch.float64 or times.dim() != 1 or not times.is_contiguous():
        raise ValueError("z2_tile_sums takes contiguous 1-D float64 times")
    _check_f64_vector(half_fdots, "half_fdots", times.device)
    n_fddot = 1
    if sixth_fddots is not None:
        _check_f64_vector(sixth_fddots, "sixth_fddots", times.device)
        n_fddot = sixth_fddots.shape[0]
    if weights is not None and (weights.dtype != torch.float32 or weights.shape != times.shape
                                or not weights.is_contiguous() or weights.device != times.device):
        raise ValueError("weights must be a contiguous float32 tensor shaped like times")
    if not 1 <= nharm <= MAX_NHARM:
        raise ValueError(f"nharm must be in [1, {MAX_NHARM}], got {nharm}")
    if n_tiles < 1 or times.shape[0] < 1:
        raise ValueError("empty grid or event list")
    if tile0 < 0 or tile0 + n_tiles >= 2**31:
        raise ValueError("tile0 must be >= 0 and tile0 + n_tiles fit 32-bit ints")
    if n_fddot * half_fdots.shape[0] > MAX_ROWS:
        raise ValueError(f"n_fddot * n_fdot must be <= {MAX_ROWS}")
    if per_split is not None and (per_split < EVENT_CHUNK or per_split % EVENT_CHUNK):
        raise ValueError(f"per_split must be a positive multiple of {EVENT_CHUNK}")
    if times.shape[0] >= 2**31 - EVENT_CHUNK:
        raise ValueError("z2_tile_sums indexes events with 32-bit ints")
    if times.device.type == "cpu":
        if splits:
            step = times.shape[0] if per_split is None else per_split
            return torch.stack([
                z2_tile_sums_reference(times[e0:e0 + step], f0, df, half_fdots, n_tiles, nharm,
                                       sixth_fddots=sixth_fddots, poly=poly, tile0=tile0,
                                       weights=None if weights is None else weights[e0:e0 + step])
                for e0 in range(0, times.shape[0], step)])
        return z2_tile_sums_reference(times, f0, df, half_fdots, n_tiles, nharm,
                                      sixth_fddots=sixth_fddots, weights=weights, poly=poly,
                                      per_split=per_split, tile0=tile0)
    if times.device.type != "cuda":
        raise ValueError(f"z2_tile_sums: unsupported device {times.device}")
    n = times.shape[0]
    n_fdot = half_fdots.shape[0]
    if per_split is None:
        per_split = default_per_split(n, n_fddot * n_fdot * n_tiles, times.device)
    n_split = -(-n // per_split)
    shape = (2, n_fddot, n_fdot, n_tiles, nharm, TRIAL_TILE)
    out = torch.empty(shape, dtype=torch.float32, device=times.device)
    partial = (torch.empty((n_split,) + shape, dtype=torch.float32, device=times.device)
               if n_split > 1 else out)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib, stream = _lib(), stream_of(times)
    with profiling.launch_window(times.device):
        rc = lib.z2_grid_sums(
            times.data_ptr(), n, float(f0), float(TRIAL_TILE * df), float(df),
            half_fdots.data_ptr(), n_fdot, ptr(sixth_fddots), n_fddot, ptr(weights),
            n_tiles, int(tile0), nharm, int(bool(poly)), n_split, per_split,
            partial.data_ptr(), out.data_ptr(), stream,
        )
    check_launch(rc, "z2_grid_sums")
    LAUNCHES["z2_tile_sums"] += 1
    if splits:
        stacked = partial if n_split > 1 else out[None]
        return stacked[:, :, 0] if sixth_fddots is None else stacked
    return out[:, 0] if sixth_fddots is None else out


def flops_per_pair(nharm: int) -> int:
    """f32 FLOPs K2 spends per (trial, event) pair, FMA counted as 2: phase
    (mul, add) 2 + f32 centered_frac 3 + polynomial sin/cos 24 + first
    harmonic sums 2 + 2*cos1 1 + 6 per further harmonic (two recurrences
    as FMA, two sums)."""
    return 26 + 6 * nharm
