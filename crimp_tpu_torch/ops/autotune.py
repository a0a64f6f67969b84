"""Launch-plan autotuner and knob resolution with a fingerprinted cache.

Port of ``crimp_tpu/ops/autotune.py``:

- ``tune()`` times a small candidate grid on the canonical A/B workload
  (``utils/benchwork.py``) and persists the winner in the cache file;
- ``resolve_blocks()`` is the single resolution point of the search
  kernels' launch plan: explicit arguments and CRIMP_TORCH_GRID_BLOCKS are
  hard overrides, a cached winner is used when present, eager mode
  (CRIMP_TORCH_AUTOTUNE=1/on/eager) tunes on a miss, and the static plan
  remains the fallback, so an empty cache gives exactly the plan the
  kernels choose by themselves;
- the knob resolvers (toafit, grid_mxu, grid3d_mxu, delta_fold, mcmc_delta,
  multisource, serve_warm_batch): per knob the environment, then a cached
  verdict, then JAX's defaults. Only ``tune()`` times anything, and only
  the block plan is tuned implicitly (eager mode); the other verdicts are
  stored by their A/B tooling (``store_*``).

What the (event_block, trial_block) pair means in the port. The hand
kernels fix their tiles at compile time (K2: ``TRIAL_TILE`` 256 trials per
block, ``EVENT_CHUNK`` 1024 events per shared-memory stage; K3: ``THREADS``
128 threads of R trials). What a launch still chooses is how the events are
split across blocks: ``event_block`` is the split length ``per_split`` (a
multiple of 1024 events; each split is summed from zero and the splits are
added in order), ``trial_block`` the kernel's fixed trial tile. The static
plan is ``z2_grid.default_per_split`` for K2 and
``z2_general.default_per_split`` for K3, each ``z2_general.plan_splits``
fed its kernel's resident blocks. The split length
moves f32/f64 rounding, never the statistic beyond the twin tolerances. For
the factorized ("grid_mxu") path the pair is its matmul block shape.

Cache key schema (one JSON file, atomic tmp + rename writes)::

    <platform>|<device_kind>|<kernel>|poly<0/1>|ev<ceil log2 n_events>|tr<ceil log2 n_trials>

``n_trials`` counts every trial the launch computes (frequencies times
(fdot, fddot) rows), since the split plan depends on the grid's block
count. The cache is the port's own file, ``CRIMP_TORCH_AUTOTUNE_CACHE``
(default ``<cache home>/crimp_tpu_torch/autotune.json``), keyed on the
device of the call (``cuda`` and ``torch.cuda.get_device_name``, or
``cpu``; every resolver takes ``device=``), so a verdict taken on a TPU
never steers the card and a card's verdict never steers a CPU call. A torn or
corrupt cache file is renamed to ``*.corrupt`` and the defaults apply.
``CRIMP_TORCH_AUTOTUNE=0`` ignores the cache. A caller that resolves many
times reads the file once (:func:`load_entries`) and hands the entries to
the resolvers. ``cost|`` keys hold ``obs/costmodel.py``'s rows.

A ``resilience.KernelError`` (no nvcc, a failed build, a launch's CUDA
error) is never turned into an error row or a fallback: it propagates out
of ``sweep_candidates``, ``tune`` and ``resolve_blocks``. Like every entry
point of the port, ``tune`` and ``sweep_candidates`` take ``device=None`` as
the card and raise without one; they time the CPU twins only when asked for
``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import pathlib
import threading
import time

from crimp_tpu_torch import knobs, obs, resilience
from crimp_tpu_torch.resilience import faultinject
from crimp_tpu_torch.utils.device import resolve_device
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# 2: K2 forms one sin/cos per register block of trials and rotates for the
# rest, with a wave-fitted static plan; split verdicts and cost rows taken on
# the direct-form kernel (version 1) no longer apply, so such a file is read
# as empty and rewritten whole by the next store
CACHE_VERSION = 2

MULTISOURCE_ENV = "CRIMP_TORCH_MULTISOURCE"
MULTISOURCE_MAX_PAD_ENV = "CRIMP_TORCH_MULTISOURCE_MAX_PAD"
MULTISOURCE_BATCH_ENV = "CRIMP_TORCH_MULTISOURCE_BATCH"
MULTISOURCE_MAX_PAD_DEFAULT = 4.0
SERVE_WARM_BATCH_ENV = "CRIMP_TORCH_SERVE_WARM_BATCH"
# (event_block, source_block) of the "multisource" key: the padded
# per-source event width and the source rows per dispatch; together they
# bound a dispatch to ~event_block * source_block padded cells
MULTISOURCE_EVENT_BLOCK = 1 << 15
MULTISOURCE_SOURCE_BLOCK = 256


# -- policy / key -----------------------------------------------------------


def autotune_mode() -> str:
    """'off' | 'auto' | 'eager' from CRIMP_TORCH_AUTOTUNE (malformed raises)."""
    env = knobs.raw("CRIMP_TORCH_AUTOTUNE").lower()
    if env in knobs.OFF_WORDS:
        return "off"
    if env in ("", "auto", "cache"):
        return "auto"
    if env in ("1", "on", "true", "eager"):
        return "eager"
    raise ValueError(f"CRIMP_TORCH_AUTOTUNE={env!r} not recognized; expected 0/off, auto, "
                     "or 1/on (eager tuning)")


def cache_path() -> pathlib.Path:
    env = knobs.raw("CRIMP_TORCH_AUTOTUNE_CACHE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(knobs.cache_home()) / "crimp_tpu_torch" / "autotune.json"


def _bucket(n: int) -> int:
    """ceil(log2(n)): problem sizes within a factor of 2 share a verdict."""
    return max(1, int(n) - 1).bit_length()


def device_fingerprint(device=None) -> tuple[str, str]:
    """(platform, device kind) of ``device``: ("cuda", the card's name) or
    ("cpu", "cpu"). None: the device the port runs on by default, the card
    when there is one, else the CPU."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return "cuda", torch.cuda.get_device_name(0 if dev.index is None else dev.index)
    return dev.type, dev.type


def cache_key(kernel: str, poly: bool, n_events: int, n_trials: int, platform: str | None = None,
              device_kind: str | None = None, *, device=None) -> str:
    """The verdict's key on the device the call runs on (``device``, None
    as in :func:`device_fingerprint`), unless platform and kind are given."""
    if platform is None or device_kind is None:
        platform, device_kind = device_fingerprint(device)
    return "|".join([platform, device_kind, kernel, f"poly{int(bool(poly))}", f"ev{_bucket(n_events)}",
                     f"tr{_bucket(n_trials)}"])


# -- on-disk cache ----------------------------------------------------------


def _load_cache(path: pathlib.Path | None = None) -> dict:
    path = cache_path() if path is None else path
    try:
        faultinject.fire("tuner_cache")
        doc = json.loads(path.read_text())
    except OSError:
        return {}  # missing or unreadable: nothing to quarantine
    except (json.JSONDecodeError, ValueError, resilience.CacheCorruptError):
        # a torn or corrupt file is quarantined (renamed to *.corrupt), not
        # reparsed and refailed on every resolution
        resilience.quarantine_file(path, label="tuner_cache")
        _forget_plans()
        return {}
    if not isinstance(doc, dict) or doc.get("version") != CACHE_VERSION:
        return {}
    entries = doc.get("entries")
    return entries if isinstance(entries, dict) else {}


def _store_entry(key: str, entry: dict, path: pathlib.Path | None = None) -> None:
    """Merge one verdict into the cache file (atomic tmp + rename)."""
    path = cache_path() if path is None else path
    entries = _load_cache(path)
    entries[key] = entry
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps({"version": CACHE_VERSION, "entries": entries}, indent=2) + "\n")
    tmp.rename(path)
    _forget_plans()


def _count_cache(hit: bool) -> None:
    """Verdict-cache effectiveness telemetry (no-op when obs is off)."""
    counted = getattr(_COUNTED, "hits", None)
    if counted is not None:
        counted.append(hit)
    obs.counter_add("autotune_cache_hits" if hit else "autotune_cache_misses")


# -- the card's plans, kept per shape ---------------------------------------------
#
# A resolution reads knobs, the verdict-cache file (a file-system call that
# can take a fraction of a millisecond) and the card's occupancy before a
# kernel can launch. On a card, a call of a shape resolved before takes the
# plan it resolved and counts the verdict-cache hits and misses that
# resolution counted. A kept plan holds while the knobs below and the
# locations of the cache file are unchanged and no verdict was stored (or
# quarantined) in this process; a verdict another process stores reaches
# a new shape or a new process. Off the card, under an entries scope, with
# a fault armed or in eager mode every call resolves.

_PLAN_KNOBS = ("CRIMP_TORCH_AUTOTUNE", "CRIMP_TORCH_AUTOTUNE_CACHE", "CRIMP_TORCH_GRID_BLOCKS",
               "CRIMP_TORCH_GRID_MXU", "CRIMP_TORCH_MXU_BF16")
_PLANS: dict = {}
_PLANS_KEEP = 256
_PLANS_LOCK = threading.Lock()
_COUNTED = threading.local()


def _forget_plans() -> None:
    with _PLANS_LOCK:
        _PLANS.clear()


def _kept(family: str, args: tuple, entries: dict | None, device, resolve):
    """``resolve()``, or the plan kept for (family, args) on a card (see
    the note above); the result is the caller's to change."""
    import torch

    dev = None if device is None else torch.device(device)
    if (dev is None or dev.type != "cuda" or entries is not None or getattr(_SCOPE, "entries", None) is not None
            or knobs.is_set("CRIMP_TORCH_FAULTS") or autotune_mode() == "eager"):
        return resolve()
    key = (family, args, str(dev), tuple(os.environ.get(k, "") for k in _PLAN_KNOBS + ("XDG_CACHE_HOME", "HOME")))
    with _PLANS_LOCK:
        hit = _PLANS.get(key)
    if hit is not None:
        for counted in hit[1]:
            _count_cache(counted)
        return copy.deepcopy(hit[0])
    _COUNTED.hits = counted = []
    try:
        out = resolve()
    finally:
        _COUNTED.hits = None
    with _PLANS_LOCK:
        if len(_PLANS) >= _PLANS_KEEP:
            _PLANS.clear()
        _PLANS[key] = (copy.deepcopy(out), tuple(counted))
    return out


def _guarded(lookup, what: str):
    """``lookup()``, or None: the cache is skipped under
    CRIMP_TORCH_AUTOTUNE=0, and a failing lookup never takes the caller
    down (logged, classified, defaults)."""
    if autotune_mode() == "off":
        return None
    try:
        return lookup()
    except resilience.KernelError:
        raise
    except Exception as exc:  # a corrupt cache or a card that cannot report its name
        logger.warning("%s verdict-cache lookup failed (%s); using static defaults",
                       what, resilience.classify(exc).value, exc_info=True)
        return None


def _cached(lookup, what: str):
    """A resolver's cached verdict, or None, counted as a hit or a miss."""
    cached = _guarded(lookup, what)
    _count_cache(bool(cached))
    return cached


_SCOPE = threading.local()


@contextlib.contextmanager
def entries_scope(entries: dict):
    """Within the block, resolvers called without ``entries`` on this thread
    read ``entries`` (from :func:`load_entries`) instead of the file: a
    caller that runs many resolutions (a survey, a serving round) reads the
    cache once."""
    prev = getattr(_SCOPE, "entries", None)
    _SCOPE.entries = entries
    try:
        yield
    finally:
        _SCOPE.entries = prev


def _scoped(entries: dict | None) -> dict:
    """``entries``, else the active :func:`entries_scope`'s, else the file's."""
    if entries is not None:
        return entries
    scoped = getattr(_SCOPE, "entries", None)
    return _load_cache() if scoped is None else scoped


def load_entries() -> dict:
    """The cache's entries, read once for a caller that resolves many times
    (the serving engine, once per engine rather than once a round): {}
    under CRIMP_TORCH_AUTOTUNE=0 or when the reading fails."""
    return _guarded(_load_cache, "verdict cache") or {}


# -- launch plans (resolve_blocks) ---------------------------------------------

# The kernel families resolve_blocks() plans. "grid" is K2 on 1-D and 2-D
# grids, "grid3d" K2 on the cube, "semicoherent" K2 per segment of the
# stacked cube, "general" K3, "grid_mxu" the factorized matmul path,
# "multisource" the survey engine ((padded per-source event width, source
# rows per dispatch)).
BLOCK_KERNELS = ("grid", "grid_mxu", "grid3d", "semicoherent", "general", "multisource")
_K2_KERNELS = ("grid", "grid3d", "semicoherent")

# The split lengths tune() times besides the static plan (which it always
# adds): about 6, 3 and 1 splits of the 8e5-event A/B workload.
DEFAULT_CANDIDATES = (1 << 17, 1 << 18, 1 << 20)


def fixed_trial_block(kernel: str) -> int:
    """The trial tile the kernel family is compiled with (K2 256 trials per
    block, K3 128 threads per block, the factorized path's sweep width)."""
    from crimp_tpu_torch.ops import search, z2_general, z2_grid

    if kernel == "general":
        return z2_general.THREADS
    if kernel == "grid_mxu":
        return search.MXU_TRIAL_BLOCK
    if kernel == "multisource":
        return MULTISOURCE_SOURCE_BLOCK
    return z2_grid.TRIAL_TILE


def static_defaults(kernel: str, n_events: int = 1, n_trials: int = 1, *, n_rows: int = 1,
                    nharm: int = 2, poly: bool = True, trig_dtype=None, device=None) -> tuple[int, int]:
    """The plan a kernel family takes with nothing cached: K2's
    ``default_per_split`` and K3's ``default_per_split`` for this problem
    (``n_trials`` = frequencies x ``n_rows``) on ``device`` (None: the
    card, raising without one), with the family's trial tile; the module
    constants for the factorized path and the survey engine."""
    from crimp_tpu_torch.ops import search, z2_general, z2_grid

    if kernel == "multisource":
        return multisource_blocks()
    if kernel == "grid_mxu":
        return search.MXU_EVENT_BLOCK, search.MXU_TRIAL_BLOCK
    dev = resolve_device(device)
    n_freq = -(-int(n_trials) // max(1, int(n_rows)))
    if kernel == "general":
        import torch

        trig = torch.float32 if trig_dtype is None else trig_dtype
        return (z2_general.default_per_split(n_events, n_freq, n_rows, nharm, trig, poly and trig == torch.float32,
                                             dev), z2_general.THREADS)
    n_blocks = int(n_rows) * -(-n_freq // z2_grid.TRIAL_TILE)
    return z2_grid.default_per_split(n_events, n_blocks, dev, nharm, poly), z2_grid.TRIAL_TILE


def _valid_blocks(kernel: str, eb, tb) -> bool:
    """Whether (eb, tb) is a plan the family can launch: positive ints, the
    family's own trial tile, and for K2/K3 a split length that is a whole
    number of 1024-event chunks."""
    from crimp_tpu_torch.ops import z2_grid

    if not (isinstance(eb, int) and isinstance(tb, int) and eb > 0 and tb > 0):
        return False
    if kernel in _K2_KERNELS or kernel == "general":
        return eb % z2_grid.EVENT_CHUNK == 0 and tb == fixed_trial_block(kernel)
    return True


def env_blocks_override(kernel: str) -> tuple[int, int] | None:
    """The live CRIMP_TORCH_GRID_BLOCKS value for the grid kernels (None for
    "general" and "multisource", as in the JAX package). Malformed raises,
    and so does a trial tile other than the family's own."""
    if kernel in ("general", "multisource") or not knobs.is_set("CRIMP_TORCH_GRID_BLOCKS"):
        return None
    env = knobs.raw("CRIMP_TORCH_GRID_BLOCKS")
    try:
        eb_s, tb_s = env.split(",")
        eb, tb = int(eb_s), int(tb_s)
        if not _valid_blocks(kernel, eb, tb):
            raise ValueError
    except ValueError:
        raise ValueError(f"CRIMP_TORCH_GRID_BLOCKS={env!r} not recognized; expected "
                         f"'<per_split>,{fixed_trial_block(kernel)}' with per_split a positive "
                         "multiple of 1024 (e.g. 262144,256)") from None
    return eb, tb


def cached_blocks(kernel: str, poly: bool, n_events: int, n_trials: int,
                  entries: dict | None = None, device=None) -> tuple[int, int] | None:
    entries = _scoped(entries)
    entry = entries.get(cache_key(kernel, poly, n_events, n_trials, device=device))
    if not isinstance(entry, dict):
        return None
    eb, tb = entry.get("event_block"), entry.get("trial_block")
    return (eb, tb) if _valid_blocks(kernel, eb, tb) else None


def resolve_blocks(kernel: str, n_events: int, n_trials: int, poly: bool = False,
                   event_block: int | None = None, trial_block: int | None = None, *,
                   n_rows: int = 1, nharm: int = 2, trig_dtype=None, device=None,
                   entries: dict | None = None) -> tuple[int, int]:
    """The single launch-plan resolution point of the search kernels.

    Precedence: explicit arguments > CRIMP_TORCH_GRID_BLOCKS (grid kernels)
    > cached tuner winner (unless CRIMP_TORCH_AUTOTUNE=0) > eager tune on a
    miss (CRIMP_TORCH_AUTOTUNE=1 only) > ``static_defaults``. Never times
    anything unless eager mode is asked for. ``n_trials`` counts
    frequencies times ``n_rows``; ``entries`` as in :func:`load_entries`.
    The cached verdict, the eager tune and the static plan are those of
    ``device`` (None: the card, raising without one): a CPU call never
    takes the card's plan, nor starts a sweep on it.
    """
    if kernel not in BLOCK_KERNELS:
        raise ValueError(f"unknown kernel variant {kernel!r}")
    if event_block is not None and trial_block is not None:
        return int(event_block), int(trial_block)
    return _kept("blocks", (kernel, n_events, n_trials, bool(poly), event_block, trial_block, n_rows, nharm,
                            str(trig_dtype)), entries, device,
                 lambda: _resolve_blocks(kernel, n_events, n_trials, poly, event_block, trial_block, n_rows=n_rows,
                                         nharm=nharm, trig_dtype=trig_dtype, device=device, entries=entries))


def _resolve_blocks(kernel: str, n_events: int, n_trials: int, poly: bool, event_block: int | None,
                    trial_block: int | None, *, n_rows: int, nharm: int, trig_dtype, device,
                    entries: dict | None) -> tuple[int, int]:
    resolved = env_blocks_override(kernel)
    mode = autotune_mode()
    if resolved is None:
        dev = resolve_device(device)
        if mode != "off":
            resolved = _cached(lambda: cached_blocks(kernel, poly, n_events, n_trials, entries, device=dev),
                               "blocks")
        if resolved is None and mode == "eager":
            try:
                out = tune(kernel, n_events, n_trials, poly=poly, nharm=nharm, device=dev)
                resolved = (out["event_block"], out["trial_block"])
            except resilience.KernelError:
                raise
            except Exception as exc:  # a failed eager tune falls to the static plan
                logger.warning("eager autotune failed (%s); using the static plan",
                               resilience.classify(exc).value, exc_info=True)
        if resolved is None:
            resolved = static_defaults(kernel, n_events, n_trials, n_rows=n_rows, nharm=nharm, poly=poly,
                                       trig_dtype=trig_dtype, device=dev)
    eb = int(event_block) if event_block is not None else int(resolved[0])
    tb = int(trial_block) if trial_block is not None else int(resolved[1])
    return eb, tb


# -- ToA-engine knobs (toafit) ---------------------------------------------------
#
# The dense error-scan window (any value gives the same bits) and the bf16
# Fourier profile sweep (accuracy-gated: only an A/B with its deviation
# check may cache a 1). Key: <platform>|<device_kind>|toafit|seg<..>|ev<..>.
# Never tuned implicitly.

TOAFIT_DENSE_WINDOW_ENV = "CRIMP_TORCH_TOA_DENSE_WINDOW"
MXU_BF16_ENV = "CRIMP_TORCH_MXU_BF16"


def toafit_defaults() -> dict:
    from crimp_tpu_torch.ops import toafit

    return {"err_dense_window": toafit.DENSE_WINDOW_DEFAULT, "mxu_bf16": 0}


def toafit_cache_key(n_segments: int, n_events: int, platform: str | None = None,
                     device_kind: str | None = None, *, device=None) -> str:
    if platform is None or device_kind is None:
        platform, device_kind = device_fingerprint(device)
    return "|".join([platform, device_kind, "toafit", f"seg{_bucket(n_segments)}", f"ev{_bucket(n_events)}"])


def cached_toafit(n_segments: int, n_events: int, entries: dict | None = None, device=None) -> dict | None:
    entries = _scoped(entries)
    entry = entries.get(toafit_cache_key(n_segments, n_events, device=device))
    if not isinstance(entry, dict):
        return None
    w, b = entry.get("err_dense_window"), entry.get("mxu_bf16")
    if isinstance(w, int) and w >= 0 and b in (0, 1):
        return {"err_dense_window": w, "mxu_bf16": b}
    return None


def store_toafit(n_segments: int, n_events: int, entry: dict, path: pathlib.Path | None = None,
                 device=None) -> None:
    """Persist a gated ToA-knob verdict."""
    _store_entry(toafit_cache_key(n_segments, n_events, device=device), entry, path)


def resolve_toafit(n_segments: int, n_events: int, entries: dict | None = None, device=None) -> dict:
    """Resolve {err_dense_window, mxu_bf16} for a ToA workload: per knob
    CRIMP_TORCH_TOA_DENSE_WINDOW / CRIMP_TORCH_MXU_BF16 (hard overrides,
    honored with the cache off too; malformed raises) > the cached verdict
    (unless CRIMP_TORCH_AUTOTUNE=0) on ``device`` (None as in
    :func:`device_fingerprint`) > DENSE_WINDOW_DEFAULT and bf16 off."""
    out = toafit_defaults()
    env_w = knobs.env_nonneg_int(TOAFIT_DENSE_WINDOW_ENV)
    env_b = knobs.env_nonneg_int(MXU_BF16_ENV, valid=(0, 1))
    if env_w is None or env_b is None:
        cached = _cached(lambda: cached_toafit(n_segments, n_events, entries, device), "toafit")
        if cached:
            out.update(cached)
    if env_w is not None:
        out["err_dense_window"] = env_w
    if env_b is not None:
        out["mxu_bf16"] = env_b
    return out


# -- factorized grid knobs (grid_mxu, grid3d_mxu) --------------------------------
#
# CRIMP_TORCH_GRID_MXU switches the uniform grids between K2 and the
# factorized matmul path; accuracy-gated like bf16. The entry carries the
# reseed stride and the bf16 operand mode. "grid_mxu_enable" /
# "grid3d_mxu_enable" keys never collide with the block entries.

GRID_MXU_ENV = "CRIMP_TORCH_GRID_MXU"
GRID_MXU_RESEED_DEFAULT = 64


def grid_mxu_defaults() -> dict:
    return {"grid_mxu": 0, "reseed": GRID_MXU_RESEED_DEFAULT, "mxu_bf16": 0}


def grid_mxu_cache_key(poly: bool, n_events: int, n_trials: int, platform: str | None = None,
                       device_kind: str | None = None, *, device=None) -> str:
    return cache_key("grid_mxu_enable", poly, n_events, n_trials, platform=platform, device_kind=device_kind,
                     device=device)


def grid3d_mxu_cache_key(poly: bool, n_events: int, n_trials: int, platform: str | None = None,
                         device_kind: str | None = None, *, device=None) -> str:
    return cache_key("grid3d_mxu_enable", poly, n_events, n_trials, platform=platform,
                     device_kind=device_kind, device=device)


def _mxu_entry(entry) -> dict | None:
    if not isinstance(entry, dict):
        return None
    m, r, b = entry.get("grid_mxu"), entry.get("reseed"), entry.get("mxu_bf16")
    if m in (0, 1) and isinstance(r, int) and r > 0 and b in (0, 1):
        return {"grid_mxu": m, "reseed": r, "mxu_bf16": b}
    return None


def cached_grid_mxu(poly: bool, n_events: int, n_trials: int, entries: dict | None = None,
                    device=None) -> dict | None:
    entries = _scoped(entries)
    return _mxu_entry(entries.get(grid_mxu_cache_key(poly, n_events, n_trials, device=device)))


def cached_grid3d_mxu(poly: bool, n_events: int, n_trials: int, entries: dict | None = None,
                      device=None) -> dict | None:
    entries = _scoped(entries)
    return _mxu_entry(entries.get(grid3d_mxu_cache_key(poly, n_events, n_trials, device=device)))


def store_grid_mxu(poly: bool, n_events: int, n_trials: int, entry: dict,
                   path: pathlib.Path | None = None, device=None) -> None:
    """Persist a gated grid_mxu A/B verdict."""
    _store_entry(grid_mxu_cache_key(poly, n_events, n_trials, device=device), entry, path)


def store_grid3d_mxu(poly: bool, n_events: int, n_trials: int, entry: dict,
                     path: pathlib.Path | None = None, device=None) -> None:
    """Persist a gated grid3d_mxu A/B verdict."""
    _store_entry(grid3d_mxu_cache_key(poly, n_events, n_trials, device=device), entry, path)


def _resolve_mxu(lookup, what: str) -> dict:
    out = grid_mxu_defaults()
    env_m = knobs.env_nonneg_int(GRID_MXU_ENV, valid=(0, 1))
    env_b = knobs.env_nonneg_int(MXU_BF16_ENV, valid=(0, 1))
    cached = _cached(lookup, what)
    if cached:
        out.update(cached)
    if env_m is not None:
        out["grid_mxu"] = env_m
    if env_b is not None:
        out["mxu_bf16"] = env_b
    return out


def resolve_grid_mxu(n_events: int, n_trials: int, poly: bool = False, entries: dict | None = None,
                     device=None) -> dict:
    """Resolve {grid_mxu, reseed, mxu_bf16} for a uniform-grid search:
    CRIMP_TORCH_GRID_MXU (hard override either way, honored with the cache
    off too; malformed raises) > the cached verdict (unless
    CRIMP_TORCH_AUTOTUNE=0; the verdict of ``device``, None as in
    :func:`device_fingerprint`) > off, reseed 64; CRIMP_TORCH_MXU_BF16 is
    the operand-precision override."""
    return _kept("grid_mxu", (n_events, n_trials, bool(poly)), entries, device,
                 lambda: _resolve_mxu(lambda: cached_grid_mxu(poly, n_events, n_trials, entries, device),
                                      "grid_mxu"))


def resolve_grid3d_mxu(n_events: int, n_trials: int, poly: bool = False, entries: dict | None = None,
                       device=None) -> dict:
    """``resolve_grid_mxu`` for the cube, under its own cached verdict (the
    same CRIMP_TORCH_GRID_MXU override)."""
    return _kept("grid3d_mxu", (n_events, n_trials, bool(poly)), entries, device,
                 lambda: _resolve_mxu(lambda: cached_grid3d_mxu(poly, n_events, n_trials, entries, device),
                                      "grid3d_mxu"))


# -- delta-fold and delta-MCMC knobs ---------------------------------------------
#
# CRIMP_TORCH_DELTA_FOLD switches anchored.fold_segments to the delta-fold
# engine, CRIMP_TORCH_MCMC_DELTA the sampler to the delta-basis likelihood;
# both accuracy-gated, off by default, their budget
# CRIMP_TORCH_DELTA_FOLD_BUDGET. "delta_fold_enable" / "mcmc_delta_enable"
# keys.

DELTA_FOLD_ENV = "CRIMP_TORCH_DELTA_FOLD"
DELTA_FOLD_BUDGET_ENV = "CRIMP_TORCH_DELTA_FOLD_BUDGET"
MCMC_DELTA_ENV = "CRIMP_TORCH_MCMC_DELTA"
# guard threshold in cycles: two decades under the <1e-8 anchored-fold budget
DELTA_FOLD_BUDGET_DEFAULT = 1e-9


def delta_fold_defaults() -> dict:
    return {"delta_fold": 0, "budget": DELTA_FOLD_BUDGET_DEFAULT}


def mcmc_delta_defaults() -> dict:
    return {"mcmc_delta": 0, "budget": DELTA_FOLD_BUDGET_DEFAULT}


def delta_fold_cache_key(n_events: int, platform: str | None = None, device_kind: str | None = None, *,
                         device=None) -> str:
    return cache_key("delta_fold_enable", False, n_events, 1, platform=platform, device_kind=device_kind,
                     device=device)


def mcmc_delta_cache_key(n_toas: int, platform: str | None = None, device_kind: str | None = None, *,
                         device=None) -> str:
    return cache_key("mcmc_delta_enable", False, n_toas, 1, platform=platform, device_kind=device_kind,
                     device=device)


def _switch_entry(entry, name: str) -> dict | None:
    if not isinstance(entry, dict):
        return None
    d, b = entry.get(name), entry.get("budget")
    if d in (0, 1) and isinstance(b, (int, float)) and 0.0 < b < float("inf"):
        return {name: d, "budget": float(b)}
    return None


def cached_delta_fold(n_events: int, entries: dict | None = None, device=None) -> dict | None:
    entries = _scoped(entries)
    return _switch_entry(entries.get(delta_fold_cache_key(n_events, device=device)), "delta_fold")


def cached_mcmc_delta(n_toas: int, entries: dict | None = None, device=None) -> dict | None:
    entries = _scoped(entries)
    return _switch_entry(entries.get(mcmc_delta_cache_key(n_toas, device=device)), "mcmc_delta")


def store_delta_fold(n_events: int, entry: dict, path: pathlib.Path | None = None, device=None) -> None:
    """Persist a gated delta-fold A/B verdict."""
    _store_entry(delta_fold_cache_key(n_events, device=device), entry, path)


def store_mcmc_delta(n_toas: int, entry: dict, path: pathlib.Path | None = None, device=None) -> None:
    """Persist a gated delta-basis MCMC A/B verdict."""
    _store_entry(mcmc_delta_cache_key(n_toas, device=device), entry, path)


def _resolve_switch(name: str, env_name: str, lookup) -> dict:
    out = {name: 0, "budget": DELTA_FOLD_BUDGET_DEFAULT}
    env_d = knobs.env_nonneg_int(env_name, valid=(0, 1))
    env_b = knobs.env_pos_float(DELTA_FOLD_BUDGET_ENV)
    cached = _cached(lookup, name)
    if cached:
        out.update(cached)
    if env_d is not None:
        out[name] = env_d
    if env_b is not None:
        out["budget"] = env_b
    return out


def resolve_delta_fold(n_events: int, entries: dict | None = None, device=None) -> dict:
    """Resolve {delta_fold, budget} for a fold of n_events: per knob
    CRIMP_TORCH_DELTA_FOLD / CRIMP_TORCH_DELTA_FOLD_BUDGET (hard overrides
    either way; malformed raises) > the cached verdict of ``device`` (None
    as in :func:`device_fingerprint`; unless CRIMP_TORCH_AUTOTUNE=0) > off
    at 1e-9 cycles."""
    return _resolve_switch("delta_fold", DELTA_FOLD_ENV, lambda: cached_delta_fold(n_events, entries, device))


def resolve_mcmc_delta(n_toas: int, entries: dict | None = None, device=None) -> dict:
    """Resolve {mcmc_delta, budget} for an n_toas posterior fit: per knob
    CRIMP_TORCH_MCMC_DELTA / CRIMP_TORCH_DELTA_FOLD_BUDGET > the cached
    verdict of ``device`` (unless CRIMP_TORCH_AUTOTUNE=0) > off at 1e-9
    cycles."""
    return _resolve_switch("mcmc_delta", MCMC_DELTA_ENV, lambda: cached_mcmc_delta(n_toas, entries, device))


# -- multisource survey engine ------------------------------------------------


def multisource_defaults() -> dict:
    return {"multisource": 1, "max_pad": MULTISOURCE_MAX_PAD_DEFAULT, "batch_cap": 0}


def multisource_blocks() -> tuple[int, int]:
    """(event_block, source_block) for the survey batch engine."""
    return MULTISOURCE_EVENT_BLOCK, MULTISOURCE_SOURCE_BLOCK


def multisource_cache_key(n_sources: int, n_events: int, platform: str | None = None,
                          device_kind: str | None = None, *, device=None) -> str:
    # "multisource_enable", so the entry never collides with block entries
    return cache_key("multisource_enable", False, n_events, n_sources, platform=platform,
                     device_kind=device_kind, device=device)


def cached_multisource(n_sources: int, n_events: int, entries: dict | None = None,
                       device=None) -> dict | None:
    entries = _scoped(entries)
    entry = entries.get(multisource_cache_key(n_sources, n_events, device=device))
    if not isinstance(entry, dict):
        return None
    m = entry.get("multisource")
    if m not in (0, 1):
        return None
    out = {"multisource": m}
    p = entry.get("max_pad")
    if isinstance(p, (int, float)) and 0.0 < p < float("inf"):
        out["max_pad"] = float(p)
    return out


def store_multisource(n_sources: int, n_events: int, entry: dict, path: pathlib.Path | None = None,
                      device=None) -> None:
    """Persist a multisource A/B verdict."""
    _store_entry(multisource_cache_key(n_sources, n_events, device=device), entry, path)


def resolve_multisource(n_sources: int, n_events: int, entries: dict | None = None, device=None) -> dict:
    """Resolve {multisource, max_pad, batch_cap} for a survey workload.

    Per knob: CRIMP_TORCH_MULTISOURCE / _MAX_PAD / _BATCH (hard overrides,
    honored with the cache off too; malformed raises) > the cached verdict
    for (n_sources, n_events) on ``device`` (None as in
    :func:`device_fingerprint`) unless CRIMP_TORCH_AUTOTUNE=0 > defaults
    (batched path on, max_pad 4.0, no batch cap). ``entries``: the cache
    as :func:`load_entries` read it (None reads the file).
    """
    out = multisource_defaults()
    env_m = knobs.env_nonneg_int(MULTISOURCE_ENV, valid=(0, 1))
    env_p = knobs.env_pos_float(MULTISOURCE_MAX_PAD_ENV)
    env_b = knobs.env_nonneg_int(MULTISOURCE_BATCH_ENV)
    cached = _cached(lambda: cached_multisource(n_sources, n_events, entries, device), "multisource")
    if cached:
        out.update(cached)
    if env_m is not None:
        out["multisource"] = env_m
    if env_p is not None:
        out["max_pad"] = env_p
    if env_b is not None:
        out["batch_cap"] = env_b
    return out


# -- serving warm-batch knob --------------------------------------------------


def serve_warm_batch_defaults() -> dict:
    return {"serve_warm_batch": 1}


def serve_warm_batch_cache_key(n_clients: int, n_events: int, platform: str | None = None,
                               device_kind: str | None = None, *, device=None) -> str:
    return cache_key("serve_warm_batch_enable", False, n_events, n_clients, platform=platform,
                     device_kind=device_kind, device=device)


def cached_serve_warm_batch(n_clients: int, n_events: int, entries: dict | None = None,
                            device=None) -> dict | None:
    entries = _scoped(entries)
    entry = entries.get(serve_warm_batch_cache_key(n_clients, n_events, device=device))
    if not isinstance(entry, dict):
        return None
    m = entry.get("serve_warm_batch")
    if m not in (0, 1):
        return None
    return {"serve_warm_batch": m}


def store_serve_warm_batch(n_clients: int, n_events: int, entry: dict, path: pathlib.Path | None = None,
                           device=None) -> None:
    """Persist a warm-batch A/B verdict."""
    _store_entry(serve_warm_batch_cache_key(n_clients, n_events, device=device), entry, path)


def resolve_serve_warm_batch(n_clients: int, n_events: int, entries: dict | None = None,
                             device=None) -> dict:
    """Resolve {serve_warm_batch} for a serving round's warm population.

    CRIMP_TORCH_SERVE_WARM_BATCH (a hard override either way, honored with
    the cache off too; malformed raises) > the cached verdict of ``device``
    unless CRIMP_TORCH_AUTOTUNE=0 > on. ``entries`` and ``device`` as in
    :func:`resolve_multisource`.
    """
    out = serve_warm_batch_defaults()
    env_m = knobs.env_nonneg_int(SERVE_WARM_BATCH_ENV, valid=(0, 1))
    cached = _cached(lambda: cached_serve_warm_batch(n_clients, n_events, entries, device), "serve_warm_batch")
    if cached:
        out.update(cached)
    if env_m is not None:
        out["serve_warm_batch"] = env_m
    return out


# -- timing / tuning ----------------------------------------------------------


def _candidate_pairs(kernel: str, candidates) -> list[tuple[int, int]]:
    """(event_block, trial_block) pairs from ``candidates`` (pairs, or bare
    split lengths that take the family's trial tile)."""
    tile = fixed_trial_block(kernel)
    return [tuple(int(v) for v in c) if isinstance(c, (tuple, list)) else (int(c), tile)
            for c in candidates]


def sweep_candidates(kernel: str = "grid", n_events: int | None = None, n_trials: int | None = None,
                     poly: bool = True, nharm: int = 2, candidates=None, repeats: int = 3,
                     on_row=None, device=None) -> list[dict]:
    """Time each (event_block, trial_block) candidate on the canonical
    benchwork workload; one row per candidate. A candidate that fails
    (out of memory, a plan the kernel refuses) becomes an error row and the
    sweep goes on; a ``KernelError`` propagates. ``device`` None is the
    card, and the sweep raises without one: it never measures the CPU
    twins unless asked for ``device="cpu"``."""
    from crimp_tpu_torch.utils import benchwork

    n_events = benchwork.AB_N_EVENTS if n_events is None else int(n_events)
    n_trials = benchwork.AB_N_TRIALS if n_trials is None else int(n_trials)
    dev = resolve_device(device)
    if candidates is None:
        candidates = DEFAULT_CANDIDATES
    # the static plan is always a candidate: the tuned plan can then never
    # be slower than the untuned one
    default = static_defaults(kernel, n_events, n_trials, nharm=nharm, poly=poly, device=dev)
    cand = list(dict.fromkeys(_candidate_pairs(kernel, candidates) + [default]))
    sec, freqs, f0, df = benchwork.ab_workload(n_events, n_trials)
    rows = []
    for eb, tb in cand:
        try:
            rate = benchwork.candidate_rate(kernel, sec, freqs, f0, df, n_trials, nharm, eb, tb, poly,
                                            repeats=repeats, device=dev)
            row = {"event_block": int(eb), "trial_block": int(tb), "trials_per_sec": round(float(rate), 1)}
        except resilience.KernelError:
            raise
        except Exception as exc:  # record the failed candidate and go on
            row = {"event_block": int(eb), "trial_block": int(tb), "kind": resilience.classify(exc).value,
                   "error": f"{type(exc).__name__}: {str(exc)[:200]}"}
        row["static"] = (eb, tb) == default
        rows.append(row)
        if on_row is not None:
            on_row(row)
    return rows


def tune(kernel: str = "grid", n_events: int | None = None, n_trials: int | None = None, poly: bool = True,
         nharm: int = 2, candidates=None, repeats: int = 3, persist: bool = True, on_row=None,
         device=None) -> dict:
    """Sweep the candidates, persist the winner, return it.

    The measurement runs at the benchwork scale capped at the requested
    problem size; the cache key carries the caller's bucketed size, so a
    later resolve at that size finds the winner with no timing run, on
    the device it was measured on (``device``, None: the card, raising
    without one)."""
    from crimp_tpu_torch.utils import benchwork

    dev = resolve_device(device)
    n_events = benchwork.AB_N_EVENTS if n_events is None else int(n_events)
    n_trials = benchwork.AB_N_TRIALS if n_trials is None else int(n_trials)
    meas_events = min(n_events, benchwork.AB_N_EVENTS)
    meas_trials = min(n_trials, benchwork.AB_N_TRIALS)
    t0 = time.perf_counter()
    rows = sweep_candidates(kernel, meas_events, meas_trials, poly, nharm, candidates, repeats, on_row, dev)
    timed = [r for r in rows if "trials_per_sec" in r]
    if not timed:
        raise RuntimeError(f"autotune sweep produced no timed candidates: {rows}")
    winner = max(timed, key=lambda r: r["trials_per_sec"])
    key = cache_key(kernel, poly, n_events, n_trials, device=dev)
    entry = {
        "event_block": winner["event_block"],
        "trial_block": winner["trial_block"],
        "trials_per_sec": winner["trials_per_sec"],
        "measured_events": meas_events,
        "measured_trials": meas_trials,
        "n_candidates": len(rows),
        "tune_wall_s": round(time.perf_counter() - t0, 2),
    }
    if persist:
        _store_entry(key, entry)
        logger.info("autotune: cached %s -> (%d, %d) at %.0f trials/s", key, entry["event_block"],
                    entry["trial_block"], entry["trials_per_sec"])
    return {"key": key, "rows": rows, **entry}
