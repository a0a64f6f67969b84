"""Knob resolution with a fingerprinted verdict cache.

Port of the verdict-cache tier of ``crimp_tpu/ops/autotune.py``: the
policy and cache-file helpers (``autotune_mode``, ``cache_path``,
``_bucket``, ``device_fingerprint``, ``cache_key``, ``_load_cache``,
``_store_entry``) and two resolvers, ``resolve_multisource`` (the survey
engine) and ``resolve_serve_warm_batch`` (the serving engine's warm path).
Each knob resolves as the JAX package's does: the environment, then a
cached A/B verdict, then the defaults. Nothing here times anything; a
verdict enters the cache only through ``store_multisource`` /
``store_serve_warm_batch``, and no code of the port calls them yet (the
tuner that writes verdicts is still to come), so until then the cache tier
steers only what a caller stored. ``CRIMP_TORCH_AUTOTUNE=1``/``on``/``eager``
(eager tuning) raises for the same reason rather than reading the cache as
``auto`` does. A caller that resolves many times reads the file once
(:func:`load_entries`) and hands the entries to the resolvers.

The cache is the port's own file, ``CRIMP_TORCH_AUTOTUNE_CACHE`` (default
``<cache home>/crimp_tpu_torch/autotune.json``), keyed on the device the
port runs on (``cuda`` and ``torch.cuda.get_device_name``, or ``cpu``), so
a verdict taken on a TPU can never steer the card. A torn or corrupt
cache file is renamed to ``*.corrupt`` and the defaults apply.
``CRIMP_TORCH_AUTOTUNE=0`` ignores the cache.
"""

from __future__ import annotations

import json
import pathlib

from crimp_tpu_torch import knobs, obs, resilience
from crimp_tpu_torch.resilience import faultinject
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

CACHE_VERSION = 1

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
    """'off' | 'auto' from CRIMP_TORCH_AUTOTUNE. Malformed raises, and so
    does eager tuning (1/on/true/eager): the port has no tuner yet, and a
    silent alias of 'auto' would hide that."""
    env = knobs.raw("CRIMP_TORCH_AUTOTUNE").lower()
    if env in knobs.OFF_WORDS:
        return "off"
    if env in ("", "auto", "cache"):
        return "auto"
    if env in ("1", "on", "true", "eager"):
        raise ValueError(f"CRIMP_TORCH_AUTOTUNE={env!r}: eager tuning is not in the port yet; "
                         "expected 0/off or auto")
    raise ValueError(f"CRIMP_TORCH_AUTOTUNE={env!r} not recognized; expected 0/off or auto")


def cache_path() -> pathlib.Path:
    env = knobs.raw("CRIMP_TORCH_AUTOTUNE_CACHE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(knobs.cache_home()) / "crimp_tpu_torch" / "autotune.json"


def _bucket(n: int) -> int:
    """ceil(log2(n)): problem sizes within a factor of 2 share a verdict."""
    return max(1, int(n) - 1).bit_length()


def device_fingerprint() -> tuple[str, str]:
    """(platform, device kind) of the device the port runs on by default:
    ("cuda", the card's name) with a card, else ("cpu", "cpu")."""
    import torch

    if torch.cuda.is_available():
        return "cuda", torch.cuda.get_device_name(0)
    return "cpu", "cpu"


def cache_key(kernel: str, poly: bool, n_events: int, n_trials: int, platform: str | None = None,
              device_kind: str | None = None) -> str:
    if platform is None or device_kind is None:
        platform, device_kind = device_fingerprint()
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


def _count_cache(hit: bool) -> None:
    """Verdict-cache effectiveness telemetry (no-op when obs is off)."""
    obs.counter_add("autotune_cache_hits" if hit else "autotune_cache_misses")


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


def load_entries() -> dict:
    """The cache's entries, read once for a caller that resolves many times
    (the serving engine, once per engine rather than once a round): {}
    under CRIMP_TORCH_AUTOTUNE=0 or when the reading fails."""
    return _guarded(_load_cache, "verdict cache") or {}


# -- multisource survey engine ------------------------------------------------


def multisource_defaults() -> dict:
    return {"multisource": 1, "max_pad": MULTISOURCE_MAX_PAD_DEFAULT, "batch_cap": 0}


def multisource_blocks() -> tuple[int, int]:
    """(event_block, source_block) for the survey batch engine."""
    return MULTISOURCE_EVENT_BLOCK, MULTISOURCE_SOURCE_BLOCK


def multisource_cache_key(n_sources: int, n_events: int, platform: str | None = None,
                          device_kind: str | None = None) -> str:
    # "multisource_enable", so the entry never collides with block entries
    return cache_key("multisource_enable", False, n_events, n_sources, platform=platform,
                     device_kind=device_kind)


def cached_multisource(n_sources: int, n_events: int, entries: dict | None = None) -> dict | None:
    entries = _load_cache() if entries is None else entries
    entry = entries.get(multisource_cache_key(n_sources, n_events))
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


def store_multisource(n_sources: int, n_events: int, entry: dict, path: pathlib.Path | None = None) -> None:
    """Persist a multisource A/B verdict."""
    _store_entry(multisource_cache_key(n_sources, n_events), entry, path)


def resolve_multisource(n_sources: int, n_events: int, entries: dict | None = None) -> dict:
    """Resolve {multisource, max_pad, batch_cap} for a survey workload.

    Per knob: CRIMP_TORCH_MULTISOURCE / _MAX_PAD / _BATCH (hard overrides,
    honored with the cache off too; malformed raises) > the cached verdict
    for (n_sources, n_events) unless CRIMP_TORCH_AUTOTUNE=0 > defaults
    (batched path on, max_pad 4.0, no batch cap). ``entries``: the cache
    as :func:`load_entries` read it (None reads the file).
    """
    out = multisource_defaults()
    env_m = knobs.env_nonneg_int(MULTISOURCE_ENV, valid=(0, 1))
    env_p = knobs.env_pos_float(MULTISOURCE_MAX_PAD_ENV)
    env_b = knobs.env_nonneg_int(MULTISOURCE_BATCH_ENV)
    cached = _cached(lambda: cached_multisource(n_sources, n_events, entries), "multisource")
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
                               device_kind: str | None = None) -> str:
    return cache_key("serve_warm_batch_enable", False, n_events, n_clients, platform=platform,
                     device_kind=device_kind)


def cached_serve_warm_batch(n_clients: int, n_events: int, entries: dict | None = None) -> dict | None:
    entries = _load_cache() if entries is None else entries
    entry = entries.get(serve_warm_batch_cache_key(n_clients, n_events))
    if not isinstance(entry, dict):
        return None
    m = entry.get("serve_warm_batch")
    if m not in (0, 1):
        return None
    return {"serve_warm_batch": m}


def store_serve_warm_batch(n_clients: int, n_events: int, entry: dict, path: pathlib.Path | None = None) -> None:
    """Persist a warm-batch A/B verdict."""
    _store_entry(serve_warm_batch_cache_key(n_clients, n_events), entry, path)


def resolve_serve_warm_batch(n_clients: int, n_events: int, entries: dict | None = None) -> dict:
    """Resolve {serve_warm_batch} for a serving round's warm population.

    CRIMP_TORCH_SERVE_WARM_BATCH (a hard override either way, honored with
    the cache off too; malformed raises) > the cached verdict unless
    CRIMP_TORCH_AUTOTUNE=0 > on. ``entries`` as in
    :func:`resolve_multisource`.
    """
    out = serve_warm_batch_defaults()
    env_m = knobs.env_nonneg_int(SERVE_WARM_BATCH_ENV, valid=(0, 1))
    cached = _cached(lambda: cached_serve_warm_batch(n_clients, n_events, entries), "serve_warm_batch")
    if cached:
        out.update(cached)
    if env_m is not None:
        out["serve_warm_batch"] = env_m
    return out
