"""Delta-fold engine: incremental refolds through an event Taylor basis.

Port of ``crimp_tpu/ops/deltafold.py``. The model phase is exactly linear in
the spin Taylor terms F0..F12 and in the glitch amplitudes (GLPH, GLF0,
GLF1, GLF2, GLF0D) once the epochs (PEPOCH, GLEP, GLTD, wave shape) are
fixed:

    phi(t; p + dp) = phi(t; p) + B(t) @ dp
    B[e, m]          = dt_e^(m+1)/(m+1)!        (dt_e seconds from PEPOCH)
    B[e, glitch amp] = [1, dt_g, dt_g^2/2, dt_g^3/6, tau (1 - e^{-dt_g/tau})]
                       masked by t >= GLEP      (dt_g seconds from GLEP)

and frac(phi + dphi) = frac(frac(phi) + dphi), so a refold under a linear
parameter update is ``frac(folded + B @ dp)`` against the cached phases of
an exact fold. That refold is K4 (``csrc/deltafold.cu``), a hand-written
kernel: ``refold`` / ``refold_batch`` launch it on a CUDA tensor and run
the plain twin ``refold_reference`` (the same fixed-order column
accumulation in torch ops) on a CPU tensor. ``LAUNCHES["refold"]`` counts
the calls that launched K4.

The host guard bounds the refold's f64 error by
``2^-46 * sum_k max_e |B[e,k]| * |dp_k|`` (``F64_MULT_EPS`` is the JAX
package's figure, kept so the guard admits and trips where JAX's does) and
folds exactly when the bound exceeds ``budget`` (default 1e-9 cycles).

The fold cache keys products on (event-set sha, segment sizes, anchor sha,
device fingerprint, model sha, tag). ``fold_cache`` selects the storage
(the argument, else CRIMP_TORCH_FOLD_CACHE): ``"off"``, ``"mem"`` (an
in-process LRU of 64 products, the default) or a directory (the LRU plus
npz files with a sha256 footer; a torn or corrupt file is renamed to
``*.corrupt`` and the fold runs exactly). ``resolve_delta_fold`` reads
CRIMP_TORCH_DELTA_FOLD and CRIMP_TORCH_DELTA_FOLD_BUDGET under explicit
arguments. The fold ladder keeps one rung of the JAX package's: a failure
on the cache path drops to the exact fold (``degraded_fold_exact_refold``).
A refold is not a rung: whether K4 takes an update is decided before it
is launched (``refold_supported``; a shape it cannot take folds exactly as
a normal mode, ``info["fallback"] == "unsupported"``), and any failure of
the refold itself propagates, a device fault as ``KernelError``. The
``delta_fold_*`` obs counters are the JAX package's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import threading
import zipfile
from collections import OrderedDict
from dataclasses import dataclass, fields

import numpy as np
import torch

from crimp_tpu_torch import knobs, obs, resilience
from crimp_tpu_torch.models import timing
from crimp_tpu_torch.obs import costmodel
from crimp_tpu_torch.models.timing import N_FREQ_TERMS, TimingParams
from crimp_tpu_torch.resilience import faultinject
from crimp_tpu_torch.utils import profiling
from crimp_tpu_torch.utils.device import resolve_device
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

SECONDS_PER_DAY = 86400.0
# the JAX package's emulated-f64 multiply noise; the card's native f64 would
# allow 2^-53, which may come later as an option
F64_MULT_EPS = 2.0 ** -46
DEFAULT_BUDGET = 1e-9  # cycles (crimp_tpu/ops/autotune.py DELTA_FOLD_BUDGET_DEFAULT)
N_GLITCH_AMP = 5  # columns per glitch: GLPH, GLF0, GLF1, GLF2, GLF0D

CACHE_VERSION = 2  # the npz layout with the sha256 payload footer
_MEM_CAP = 64  # in-process LRU slots: the serving engine's warm population fits

LAUNCHES = {"refold": 0}

_LIB = None
_LIB_LOCK = threading.Lock()


def resolve_delta_fold(delta_fold=None, budget=None, n_events: int = 1, device=None) -> tuple[int, float]:
    """(delta_fold, budget): explicit arguments, else
    ``autotune.resolve_delta_fold(n_events)``: CRIMP_TORCH_DELTA_FOLD
    (strict 0/1) and CRIMP_TORCH_DELTA_FOLD_BUDGET (> 0), then a cached
    A/B verdict of ``device``, then off and 1e-9 cycles, the JAX package's
    defaults."""
    if delta_fold is None or budget is None:
        from crimp_tpu_torch.ops import autotune

        cfg = autotune.resolve_delta_fold(n_events, device=device)
        delta_fold = cfg["delta_fold"] if delta_fold is None else delta_fold
        budget = cfg["budget"] if budget is None else budget
    return int(bool(delta_fold)), float(budget)


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# ---------------------------------------------------------------------------
# Linear / non-linear parameter split
# ---------------------------------------------------------------------------


def n_params(n_glitch: int) -> int:
    """Basis width: 13 Taylor columns + 5 amplitude columns per glitch."""
    return N_FREQ_TERMS + N_GLITCH_AMP * int(n_glitch)


def linear_param_vector(tm: TimingParams) -> np.ndarray:
    """The (13 + 5G,) vector the phase is linear in: [F0..F12] then per-glitch
    [GLPH, GLF0, GLF1, GLF2, GLF0D] blocks (glitch-major)."""
    cols = [tm.numpy("f")]
    for g in range(tm.n_glitch):
        cols.append(np.array([tm.numpy(name)[g] for name in ("glph", "glf0", "glf1", "glf2", "glf0d")]))
    return np.concatenate(cols)


def nonlinear_sha(tm: TimingParams) -> str:
    """sha256 over every parameter the basis depends on (epochs and shapes),
    byte for byte the JAX package's digest for the same model."""
    h = hashlib.sha256()
    for name in ("pepoch", "glep", "gltd", "wave_epoch", "wave_om", "wave_a", "wave_b"):
        h.update(np.ascontiguousarray(np.atleast_1d(tm.numpy(name).astype(np.float64))).tobytes())
        h.update(b"|")
    return h.hexdigest()


def delta_params(tm_old: TimingParams, tm_new: TimingParams) -> np.ndarray | None:
    """dp = p_new - p_old when only linear parameters moved, else None."""
    if tm_old.n_glitch != tm_new.n_glitch or tm_old.n_wave != tm_new.n_wave:
        return None
    if nonlinear_sha(tm_old) != nonlinear_sha(tm_new):
        return None
    return linear_param_vector(tm_new) - linear_param_vector(tm_old)


# ---------------------------------------------------------------------------
# Basis build (anchored coordinates)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BasisSpec:
    """Host-prepared anchor geometry the basis rows are built from (the
    non-linear half of the model, in anchored coordinates), f64 tensors."""

    dt_ref_sec: torch.Tensor  # (A,) anchor seconds from PEPOCH (exact -> f64)
    glep_off: torch.Tensor  # (A, G) (t_ref - GLEP) seconds (-inf padding)
    gltd_sec: torch.Tensor  # (G,) recovery timescale seconds (1 s padding)
    glf0d_on: torch.Tensor  # (G,) 0 where GLTD == 0 (recovery disabled)
    wep_off: torch.Tensor  # (A,) (t_ref - WAVEEPOCH) seconds
    wave_om_sec: torch.Tensor  # scalar rad/s
    wave_a: torch.Tensor  # (W,)
    wave_b: torch.Tensor  # (W,)

    def to(self, device) -> "BasisSpec":
        return BasisSpec(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})


def basis_spec(tm, t_ref_mjd) -> BasisSpec:
    """The BasisSpec for anchors t_ref (MJD), on the CPU, with the anchored
    prepare's conventions: -inf offsets for padded glitches, 1 s and a
    disabled recovery where GLTD == 0."""
    tm = timing.resolve(tm)
    t_ref = np.atleast_1d(np.asarray(t_ref_mjd, dtype=np.float64))
    ld = np.longdouble
    dt_ref = ((np.asarray(t_ref, dtype=ld) - ld(float(tm.pepoch))) * ld(SECONDS_PER_DAY)).astype(np.float64)
    glep = tm.numpy("glep")
    glep_off = np.where(np.isfinite(glep)[None, :], (t_ref[:, None] - glep[None, :]) * SECONDS_PER_DAY, -np.inf)
    gltd = tm.numpy("gltd")
    t64 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64))  # noqa: E731
    return BasisSpec(
        dt_ref_sec=t64(dt_ref),
        glep_off=t64(glep_off),
        gltd_sec=t64(np.where(gltd == 0.0, 1.0, gltd * SECONDS_PER_DAY)),
        glf0d_on=t64(np.where(gltd == 0.0, 0.0, 1.0)),
        wep_off=t64((t_ref - float(tm.wave_epoch)) * SECONDS_PER_DAY),
        wave_om_sec=t64(float(tm.wave_om) / SECONDS_PER_DAY),
        wave_a=t64(tm.numpy("wave_a")),
        wave_b=t64(tm.numpy("wave_b")),
    )


def basis_rows(spec: BasisSpec, delta: torch.Tensor, anchor_idx: torch.Tensor,
               wave_in_f0: bool = True) -> torch.Tensor:
    """(N, 13 + 5G) f64 basis rows for events at anchored second offsets, on
    the tensors' device, in the JAX package's order of operations.

    Column m < 13 is dt^(m+1)/(m+1)! with dt the event's seconds from PEPOCH
    (``acc = acc * dt / m``); with whitening waves and ``wave_in_f0`` the F0
    column also carries the wave shape (W = F0 * shape). Glitch blocks are
    masked by t >= GLEP.
    """
    dt = spec.dt_ref_sec[anchor_idx] + delta
    acc = dt
    cols = [acc]
    for m in range(2, N_FREQ_TERMS + 1):
        acc = acc * dt / m
        cols.append(acc)
    n_wave = spec.wave_a.shape[0]
    if n_wave and wave_in_f0:
        base = (delta + spec.wep_off[anchor_idx]) * spec.wave_om_sec
        shape = torch.zeros_like(delta)
        for k in range(1, n_wave + 1):
            shape = shape + spec.wave_a[k - 1] * torch.sin(k * base) + spec.wave_b[k - 1] * torch.cos(k * base)
        cols[0] = cols[0] + shape
    for g in range(spec.glep_off.shape[1]):
        dtg_raw = delta + spec.glep_off[anchor_idx, g]
        after = dtg_raw >= 0.0
        dtg = torch.where(after, dtg_raw, 0.0)
        tau = spec.gltd_sec[g]
        recovery = spec.glf0d_on[g] * tau * (1.0 - torch.exp(-dtg / tau))
        cols.append(torch.where(after, 1.0, 0.0).to(delta.dtype))  # GLPH
        cols.append(dtg)  # GLF0
        cols.append(0.5 * dtg**2)  # GLF1
        cols.append((1.0 / 6.0) * dtg**3)  # GLF2
        cols.append(recovery)  # GLF0D
    return torch.stack(cols, dim=-1)


def taylor_basis_seconds(dt_sec, order: int) -> np.ndarray:
    """(..., order) pure-Taylor basis columns dt^m/m!, m = 1..order: the
    rank-``order`` delta-fold of a local [F0, F1] window trial."""
    dt = np.asarray(dt_sec, dtype=np.float64)
    cols = []
    acc = dt
    for m in range(1, order + 1):
        if m > 1:
            acc = acc * dt / m
        cols.append(acc)
    return np.stack(cols, axis=-1)


@dataclass
class FoldBasis:
    """Device basis matrix + the host column maxima the guard needs."""

    b: torch.Tensor  # (N, P) f64 on the device
    colmax: np.ndarray  # (P,) max_e |B[e, k]|


def build_basis(tm, t_ref_mjd, delta, anchor_idx, wave_in_f0: bool = True, device=None) -> FoldBasis:
    """One basis build for an event set, on ``device`` (default cuda)."""
    dev = resolve_device(device)
    spec = basis_spec(tm, t_ref_mjd).to(dev)
    b = basis_rows(spec, torch.as_tensor(np.asarray(delta, dtype=np.float64), device=dev),
                   torch.as_tensor(np.asarray(anchor_idx, dtype=np.int64), device=dev), wave_in_f0=wave_in_f0)
    colmax = torch.amax(torch.abs(b), dim=0).cpu().numpy() if b.shape[0] else np.zeros(b.shape[1])
    return FoldBasis(b=b, colmax=colmax)


def error_bound_cycles(colmax: np.ndarray, dp: np.ndarray) -> float:
    """Bound on the refold's f64 error (cycles): 2^-46 per multiply against
    the worst-case |dphi| = sum_k max|B_k| |dp_k|."""
    return float(F64_MULT_EPS * np.dot(np.asarray(colmax), np.abs(np.asarray(dp))))


# ---------------------------------------------------------------------------
# K4: the refold
# ---------------------------------------------------------------------------


def _lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from crimp_tpu_torch.ops import z2_grid

            lib = ctypes.CDLL(str(z2_grid.build()["deltafold"]))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.deltafold_refold.argtypes = [vp, vp, vp, vp, ci, ctypes.c_longlong, ci, vp]
            lib.deltafold_refold.restype = ci
            lib.deltafold_max_params.argtypes = []
            lib.deltafold_max_params.restype = ci
            _LIB = lib
    return _LIB


def refold_reference(folded: torch.Tensor, basis: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """Plain twin of K4: frac(folded + B @ dp) as a fixed-order column
    accumulation, ``p = p + B[..., k] * dp[..., k]`` for k = 0..P-1, each
    product and sum rounded on its own. Takes (E,) / (E, P) / (P,) or the
    batched (B, E) / (B, E, P) / (B, P)."""
    p = folded
    for k in range(basis.shape[-1]):
        p = p + basis[..., k] * dp[..., k, None]
    return p - torch.floor(p)


def _launch_refold(folded: torch.Tensor, basis: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """Check the batched operands and launch K4 (CUDA) or run the twin (CPU)."""
    for x, name, ndim in ((folded, "folded", 2), (basis, "basis", 3), (dp, "dp", 2)):
        if x.dtype != torch.float64 or x.dim() != ndim or not x.is_contiguous():
            raise ValueError(f"refold: {name} must be a contiguous {ndim}-D float64 tensor "
                             f"(got {x.dtype}, shape {tuple(x.shape)}, contiguous {x.is_contiguous()})")
        if x.device != folded.device:
            raise ValueError(f"refold: {name} must lie on the phases' device")
    n_batch, n_events = folded.shape
    if basis.shape[:2] != folded.shape or dp.shape != (n_batch, basis.shape[2]):
        raise ValueError(f"refold: shapes {tuple(folded.shape)}, {tuple(basis.shape)}, {tuple(dp.shape)} "
                         "do not line up as (B, E), (B, E, P), (B, P)")
    if folded.device.type == "cpu":
        return refold_reference(folded, basis, dp)
    if folded.device.type != "cuda":
        raise ValueError(f"refold: unsupported device {folded.device}")
    if n_batch < 1 or n_events < 1 or basis.shape[2] < 1:
        raise ValueError("refold: empty batch, event list or basis")
    lib = _lib()
    if n_batch > 65535 or basis.shape[2] > lib.deltafold_max_params():
        raise ValueError(f"refold: at most 65535 batch rows and {lib.deltafold_max_params()} basis columns")
    from crimp_tpu_torch.ops import z2_grid

    out = torch.empty_like(folded)
    stream = z2_grid.stream_of(folded)
    with profiling.launch_window(folded.device):
        rc = lib.deltafold_refold(folded.data_ptr(), basis.data_ptr(), dp.data_ptr(), out.data_ptr(),
                                  n_batch, n_events, basis.shape[2], stream)
    z2_grid.check_launch(rc, "deltafold_refold")
    LAUNCHES["refold"] += 1
    return out


def refold_supported(n_events: int, n_params: int, device) -> bool:
    """Whether :func:`refold` takes one client of ``n_events`` events and
    ``n_params`` basis columns on ``device``: the twin takes any; K4 at
    least one of each and at most ``deltafold_max_params()`` columns (the
    basis rows of a block must fit its shared memory)."""
    if torch.device(device).type != "cuda":
        return True
    return n_events >= 1 and 1 <= n_params <= _lib().deltafold_max_params()


def refold(folded: torch.Tensor, basis: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """frac(folded + B @ dp) for (N,) phases, an (N, P) basis and a (P,)
    update, all contiguous f64 on one device: K4 on a CUDA tensor, the twin
    on a CPU tensor."""
    if folded.dim() != 1 or basis.dim() != 2 or dp.dim() != 1:
        raise ValueError("refold takes (N,) phases, an (N, P) basis and a (P,) update")
    return _launch_refold(folded[None], basis[None], dp[None])[0]


def refold_batch(folded: torch.Tensor, basis: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """:func:`refold` over a leading client axis: (B, E) phases, (B, E, P)
    bases, (B, P) updates -> (B, E). Each row equals the solo refold bit for
    bit, and zero padding (zero basis columns with zero dp, padded events)
    is inert."""
    return _launch_refold(folded, basis, dp)


# ---------------------------------------------------------------------------
# Fingerprinted fold cache
# ---------------------------------------------------------------------------


@dataclass
class FoldProduct:
    """An exact fold's reusable output: phases + the parameter split that
    decides whether a later request can reuse or delta them. The basis and
    the device-resident phases attach on first delta use."""

    phases: np.ndarray  # (N,) folded [0,1) cycles (exact-path output)
    t_ref: np.ndarray  # (A,) anchors (MJD)
    sizes: tuple  # per-segment event counts
    pvec: np.ndarray  # linear parameter vector at fold time
    nonlin: str  # nonlinear_sha at fold time
    basis: FoldBasis | None = None
    phases_dev: torch.Tensor | None = None


_MEM_CACHE: OrderedDict[str, FoldProduct] = OrderedDict()
_last_info: dict = {"mode": None}


def last_fold_info() -> dict:
    """The most recent cached_fold call: mode (exact / cache / delta), guard
    bound, and the reason an update was not refolded (``fallback``:
    ``budget`` or ``nonlinear``)."""
    return dict(_last_info)


def clear_cache() -> None:
    """Drop the in-process fold cache."""
    _MEM_CACHE.clear()


def fold_cache_mode(fold_cache=None) -> tuple[str, pathlib.Path | None]:
    """``fold_cache`` (None: CRIMP_TORCH_FOLD_CACHE) -> ('off' | 'mem' |
    'disk', directory or None): 0/off stores nothing; unset/auto/mem keeps
    products in-process (the default); 1/disk/on uses
    $XDG_CACHE_HOME/crimp_tpu_torch/foldcache; any other value is a
    directory for the on-disk tier."""
    env = knobs.raw("CRIMP_TORCH_FOLD_CACHE") if fold_cache is None else str(fold_cache).strip()
    low = env.lower()
    if low in knobs.OFF_WORDS:
        return "off", None
    if low in ("", "auto", "mem", "memory"):
        return "mem", None
    if low in ("1", "disk", "on", "true"):
        return "disk", pathlib.Path(knobs.cache_home()) / "crimp_tpu_torch" / "foldcache"
    return "disk", pathlib.Path(env)


def device_fingerprint(device) -> tuple[str, str]:
    """(device type, card name on cuda): fold bits depend on the device, so
    products never cross between the CPU and a card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "cuda", torch.cuda.get_device_name(dev)
    return dev.type, dev.type


def fold_key(times_cat: np.ndarray, sizes, t_ref: np.ndarray, model_sha: str | None = None,
             tag: str | None = None, device=None) -> str:
    """Cache key: event-set sha + segment layout + anchor sha + the device
    fingerprint, plus the model's non-linear sha (two models over identical
    events never share a slot) and an optional caller ``tag``."""
    kind, name = device_fingerprint(resolve_device(device))
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(times_cat, dtype=np.float64)).tobytes())
    h.update(("|" + ",".join(str(int(s)) for s in sizes) + "|").encode())
    h.update(np.ascontiguousarray(np.asarray(t_ref, dtype=np.float64)).tobytes())
    h.update(f"|{kind}|{name}|v{CACHE_VERSION}".encode())
    if model_sha is not None:
        h.update(f"|model:{model_sha}".encode())
    if tag is not None:
        h.update(f"|tag:{tag}".encode())
    return h.hexdigest()


def _mem_get(key: str) -> FoldProduct | None:
    prod = _MEM_CACHE.get(key)
    if prod is not None:
        _MEM_CACHE.move_to_end(key)
    return prod


def _mem_put(key: str, prod: FoldProduct) -> None:
    _MEM_CACHE[key] = prod
    _MEM_CACHE.move_to_end(key)
    while len(_MEM_CACHE) > _MEM_CAP:
        _MEM_CACHE.popitem(last=False)


def _product_sha(prod: FoldProduct) -> str:
    """sha256 over the payload arrays: the npz footer that detects a torn or
    bit-flipped product on load."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(prod.phases, dtype=np.float64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(prod.t_ref, dtype=np.float64)).tobytes())
    h.update(np.asarray(prod.sizes, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(np.asarray(prod.pvec, dtype=np.float64)).tobytes())
    h.update(prod.nonlin.encode())
    return h.hexdigest()


def _disk_get(key: str, disk_dir: pathlib.Path) -> FoldProduct | None:
    path = disk_dir / f"{key}.npz"
    if not path.exists():
        return None
    try:
        faultinject.fire("fold_cache")
        with np.load(path, allow_pickle=False) as doc:
            if int(doc["version"]) != CACHE_VERSION:
                return None  # an older schema, not corruption
            prod = FoldProduct(
                phases=np.asarray(doc["phases"], dtype=np.float64),
                t_ref=np.asarray(doc["t_ref"], dtype=np.float64),
                sizes=tuple(int(s) for s in doc["sizes"]),
                pvec=np.asarray(doc["pvec"], dtype=np.float64),
                nonlin=str(doc["nonlin"]),
            )
            if str(doc["sha"]) != _product_sha(prod):
                raise resilience.CacheCorruptError(f"fold cache {path.name}: sha footer mismatch")
            return prod
    except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile, resilience.CacheCorruptError):
        # torn write or bit rot: quarantine to *.corrupt and fold exactly
        resilience.quarantine_file(path, label="fold_cache")
        return None


def _disk_put(key: str, prod: FoldProduct, disk_dir: pathlib.Path) -> None:
    try:
        disk_dir.mkdir(parents=True, exist_ok=True)
        path = disk_dir / f"{key}.npz"
        tmp = disk_dir / f"{key}.npz.{os.getpid()}.tmp"
        with open(tmp, "wb") as fh:  # np.savez(path) would append .npz
            np.savez(fh, version=CACHE_VERSION, phases=prod.phases, t_ref=prod.t_ref,
                     sizes=np.asarray(prod.sizes), pvec=prod.pvec, nonlin=np.str_(prod.nonlin),
                     sha=np.str_(_product_sha(prod)))
        os.replace(tmp, path)
    except OSError as exc:
        logger.warning("fold cache write failed (%s); continuing", exc)


def _lookup(key: str, mode: str, disk_dir) -> FoldProduct | None:
    prod = _mem_get(key)
    if prod is None and mode == "disk":
        prod = _disk_get(key, disk_dir)
        if prod is not None:
            _mem_put(key, prod)
    return prod


def store_product(tm, times_cat, sizes, t_ref, phases, tag: str | None = None, fold_cache=None,
                  device=None) -> str | None:
    """Seed the fold cache with an exact fold computed elsewhere (the
    serving engine's batched cold folds), so the next request of that tag
    takes the cache-hit or delta path. Returns the key, None when off."""
    mode, disk_dir = fold_cache_mode(fold_cache)
    if mode == "off":
        return None
    tm = timing.resolve(tm)
    key = fold_key(times_cat, sizes, t_ref, model_sha=nonlinear_sha(tm), tag=tag, device=device)
    prod = FoldProduct(
        phases=np.ascontiguousarray(np.asarray(phases, dtype=np.float64)),
        t_ref=np.asarray(t_ref, dtype=np.float64),
        sizes=tuple(int(s) for s in sizes),
        pvec=linear_param_vector(tm),
        nonlin=nonlinear_sha(tm),
    )
    _mem_put(key, prod)
    if mode == "disk":
        _disk_put(key, prod, disk_dir)
    obs.counter_add("delta_fold_seeded")
    return key


def _ensure_basis(prod: FoldProduct, tm, delta, anchor_idx, device) -> FoldBasis:
    if prod.basis is None:
        prod.basis = build_basis(tm, prod.t_ref, delta, anchor_idx, device=device)
    return prod.basis


def cached_fold(tm, times_cat, sizes, t_ref, delta, anchor_idx, exact_fn, budget: float = DEFAULT_BUDGET,
                tag: str | None = None, fold_cache=None, device=None) -> tuple[np.ndarray, dict]:
    """The engine's entry point (``anchored.fold_segments(delta_fold=1)``):
    returns (folded phases (N,), info).

    In order: a bitwise cache hit (same linear vector, same non-linear sha);
    the delta refold through K4 (a linear move within the budget, always
    against the stored exact product, so refolds never accumulate error);
    the exact fold ``exact_fn()``, stored as the new product. The fold
    ladder: a failing cache lookup drops to the exact fold (recorded,
    ``info["fallback"]`` the failure's kind). A move K4 cannot take folds
    exactly (``info["fallback"] == "unsupported"``, not a degradation); a
    failing refold raises, a device fault as ``KernelError``.
    """
    global _last_info
    dev = resolve_device(device)
    tm = timing.resolve(tm)
    mode, disk_dir = fold_cache_mode(fold_cache)
    pvec = linear_param_vector(tm)
    nonlin = nonlinear_sha(tm)
    info: dict = {"mode": "exact", "n_events": int(np.size(times_cat)), "tag": tag, "stored": mode != "off"}
    key = None
    prod = None
    if mode != "off":
        key = fold_key(times_cat, sizes, t_ref, model_sha=nonlin, tag=tag, device=dev)
        info["key"] = key[:16]
        try:
            prod = _lookup(key, mode, disk_dir)
        except resilience.KernelError:
            raise
        except Exception as exc:  # fold ladder: the cache path fell
            kind = resilience.classify(exc)
            resilience.record_degradation("fold", "exact_refold", kind)
            info["fallback"] = kind.value
            prod = None
    if prod is not None and prod.nonlin == nonlin and prod.pvec.shape == pvec.shape:
        dp = pvec - prod.pvec
        if not np.any(dp):
            info["mode"] = "cache"
            obs.counter_add("delta_fold_cache_hits")
            _last_info = info
            return prod.phases.copy(), info
        if not refold_supported(int(np.size(times_cat)), int(dp.size), dev):
            info["fallback"] = "unsupported"
        else:
            basis = _ensure_basis(prod, tm, delta, anchor_idx, dev)
            bound = error_bound_cycles(basis.colmax, dp)
            info["bound_cycles"] = bound
            if bound <= budget:
                from crimp_tpu_torch.ops import z2_grid

                if prod.phases_dev is None:
                    prod.phases_dev = torch.as_tensor(prod.phases, device=dev)
                dp_dev = torch.as_tensor(dp, device=dev)
                with costmodel.kernel_span("delta_refold"):
                    out = refold(prod.phases_dev, basis.b, dp_dev)
                costmodel.capture("delta_refold", refold, prod.phases_dev, basis.b, dp_dev, out=out,
                                  counts=lambda: costmodel.k4_counts(1, basis.b.shape[0], basis.b.shape[1]))
                folded = z2_grid.to_host(out, "deltafold_refold")
                info["mode"] = "delta"
                obs.counter_add("delta_fold_refolds")
                _last_info = info
                return folded, info
            info["fallback"] = "budget"
            obs.counter_add("delta_fold_guard_trips")
    elif prod is not None:
        info["fallback"] = "nonlinear"
        obs.counter_add("delta_fold_nonlinear_fallbacks")
    obs.counter_add("delta_fold_exact_folds")
    folded = np.asarray(exact_fn())
    if mode != "off":
        new = FoldProduct(phases=folded, t_ref=np.asarray(t_ref), sizes=tuple(int(s) for s in sizes),
                          pvec=pvec, nonlin=nonlin)
        _mem_put(key, new)
        if mode == "disk":
            _disk_put(key, new, disk_dir)
    _last_info = info
    return folded, info


# ---------------------------------------------------------------------------
# Batched warm refolds (the serving engine's one-launch steady state)
# ---------------------------------------------------------------------------


def _warm_entry(tm, seg_times):
    """One client's refold operands, with fold_segments' layout conventions
    byte for byte so the cache key matches the seeded one."""
    tm = timing.resolve(tm)
    seg = [np.atleast_1d(np.asarray(t, dtype=np.float64)) for t in seg_times]
    t_ref = np.asarray([(t[-1] - t[0]) / 2 + t[0] if t.size else 0.0 for t in seg])
    sizes = [t.size for t in seg]
    times_cat = np.concatenate(seg) if seg else np.zeros(0, dtype=np.float64)
    return tm, t_ref, sizes, times_cat


def delta_refold_batch(tms, seg_times_lists, tags=None, budget: float = DEFAULT_BUDGET, fold_cache=None,
                       device=None):
    """Refold every admitted warm client in ONE K4 launch.

    Parallel lists, one slot per client: timing models, per-segment event
    times as ``fold_segments`` would see them, and cache tags. Returns
    ``(phase_lists, t_refs, infos)``; ``phase_lists[i]`` is the per-segment
    refolded phases, or None when client i must take the solo path: a cache
    miss, a non-linear move or a guard trip demotes only that client
    (``infos[i]["fallback"]`` says why). Admitted clients pad to the batch's
    (max events x max params); the padding is inert, so each row equals the
    solo refold's bits. Zero-``dp`` clients return their stored product.
    """
    from crimp_tpu_torch.ops import anchored

    dev = resolve_device(device)
    n = len(tms)
    tags = list(tags) if tags is not None else [None] * n
    phase_lists: list = [None] * n
    t_refs: list = [None] * n
    infos: list = [{} for _ in range(n)]
    mode, disk_dir = fold_cache_mode(fold_cache)
    admitted = []  # (slot, prod, basis, dp, sizes, n_events)
    for i in range(n):
        tm, t_ref, sizes, times_cat = _warm_entry(tms[i], seg_times_lists[i])
        t_refs[i] = t_ref
        info = infos[i]
        info.update({"mode": None, "n_events": int(times_cat.size), "tag": tags[i]})
        if mode == "off" or not times_cat.size:
            info["fallback"] = "cache_off" if mode == "off" else "empty"
            continue
        pvec = linear_param_vector(tm)
        nonlin = nonlinear_sha(tm)
        key = fold_key(times_cat, sizes, t_ref, model_sha=nonlin, tag=tags[i], device=dev)
        info["key"] = key[:16]
        try:
            prod = _lookup(key, mode, disk_dir)
        except resilience.KernelError:
            raise
        except Exception as exc:  # a cache-path failure demotes this client to the
            # solo path, where cached_fold's own fold ladder records it
            info["fallback"] = resilience.classify(exc).value
            continue
        if prod is None:
            info["fallback"] = "miss"
            continue
        if prod.nonlin != nonlin or prod.pvec.shape != pvec.shape:
            info["fallback"] = "nonlinear"
            continue
        dp = pvec - prod.pvec
        if not np.any(dp):
            info["mode"] = "cache"
            obs.counter_add("delta_fold_cache_hits")
            phase_lists[i] = np.split(prod.phases.copy(), np.cumsum(sizes)[:-1])
            continue
        if not refold_supported(int(times_cat.size), int(dp.size), dev):
            info["fallback"] = "unsupported"
            continue
        anchor_idx = np.repeat(np.arange(len(sizes)), sizes)
        delta = anchored.anchor_deltas(times_cat, t_ref, anchor_idx)
        basis = _ensure_basis(prod, tm, delta, anchor_idx, dev)
        bound = error_bound_cycles(basis.colmax, dp)
        info["bound_cycles"] = bound
        if bound > budget:
            info["fallback"] = "budget"
            obs.counter_add("delta_fold_guard_trips")
            continue
        admitted.append((i, prod, basis, dp, sizes, times_cat.size))
    if not admitted:
        return phase_lists, t_refs, infos
    n_ev = max(a[5] for a in admitted)
    n_par = max(int(a[2].b.shape[1]) for a in admitted)
    folded_pad = torch.zeros((len(admitted), n_ev), dtype=torch.float64, device=dev)
    basis_pad = torch.zeros((len(admitted), n_ev, n_par), dtype=torch.float64, device=dev)
    dp_pad = torch.zeros((len(admitted), n_par), dtype=torch.float64, device=dev)
    for r, (_, prod, basis, dp, _, n_i) in enumerate(admitted):
        folded_pad[r, :n_i] = torch.as_tensor(prod.phases, device=dev)
        basis_pad[r, :n_i, :basis.b.shape[1]] = basis.b
        dp_pad[r, :dp.size] = torch.as_tensor(dp, device=dev)
    from crimp_tpu_torch.ops import z2_grid

    with costmodel.kernel_span("delta_refold_batch"):
        out_dev = refold_batch(folded_pad, basis_pad, dp_pad)
    costmodel.capture("delta_refold_batch", refold_batch, folded_pad, basis_pad, dp_pad, out=out_dev,
                      counts=lambda: costmodel.k4_counts(*basis_pad.shape))
    out = z2_grid.to_host(out_dev, "deltafold_refold")
    obs.counter_add("delta_fold_refolds", len(admitted))
    for r, (i, _, _, _, sizes, n_i) in enumerate(admitted):
        infos[i]["mode"] = "delta"
        infos[i]["batched"] = True
        phase_lists[i] = np.split(np.ascontiguousarray(out[r, :n_i]), np.cumsum(sizes)[:-1])
    return phase_lists, t_refs, infos
