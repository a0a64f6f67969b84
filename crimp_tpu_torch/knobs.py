"""Registry of the port's ``CRIMP_TORCH_*`` environment knobs + parse helpers.

Port of ``crimp_tpu/knobs.py``. Every environment read of the port goes
through this module, and every knob it reads is declared here. The port
uses its own prefix, ``CRIMP_TORCH_``, so a process that imports both
packages (as the parity tests do) never lets one package's setting steer
the other. Each knob keeps the JAX package's suffix, kind and default, and
the registry holds only the knobs whose consumer the port has.

Precedence at every consumer: an explicit argument, then the environment,
then the JAX package's default.

The word sets below are the single definition of truthy/falsy strings.
Strict integer knobs (0/1 switches like CRIMP_TORCH_GRID_MXU) do NOT accept
the word forms: "on"/"yes" raise there, so a typo'd numeric override can
never silently pick a direction.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

PREFIX = "CRIMP_TORCH_"

ON_WORDS = frozenset(("1", "on", "true", "always"))
OFF_WORDS = frozenset(("0", "off", "false", "never"))
AUTO_WORDS = frozenset(("", "auto"))


@dataclass(frozen=True)
class Knob:
    """One declared ``CRIMP_TORCH_*`` environment knob.

    ``numeric_key`` names the numeric mode the knob's value can change
    (None for knobs that cannot change computed bits: throughput, caching,
    telemetry and chaos knobs).
    """

    name: str
    default: str  # human-readable default
    kind: str  # bool | enum | int | float | str | path
    numeric_key: str | None = None
    consumer: str = ""  # which layer reads it
    doc: str = ""  # one-line effect summary

    @property
    def numeric(self) -> bool:
        return self.numeric_key is not None


def _build_registry(knobs: tuple[Knob, ...]) -> dict[str, Knob]:
    out: dict[str, Knob] = {}
    for k in knobs:
        if not k.name.startswith(PREFIX):
            raise ValueError(f"knob {k.name!r} outside the {PREFIX} namespace")
        if k.name in out:
            raise ValueError(f"duplicate knob registration {k.name!r}")
        out[k.name] = k
    return out


REGISTRY: dict[str, Knob] = _build_registry((
    # -- kernel numeric modes ------------------------------------------------
    # Auto is on for the card and off on the CPU: the card plays the TPU's
    # part in the JAX package's auto rule, being the accelerator the hand
    # kernels were written for, and off on the CPU is JAX's own default
    # there. On an H100, K3 with the polynomial ran 88.18-88.88 ms against
    # 121.30-122.13 ms with sincosf at the same shape (PERF.md, kernel table).
    Knob("CRIMP_TORCH_POLY_TRIG", "auto (on for the card, off on the CPU)", "bool",
         numeric_key="poly_trig", consumer="ops/fasttrig.py",
         doc="polynomial sin/cos pair in the search kernels"),
    Knob("CRIMP_TORCH_GRID_FASTPATH", "auto (nharm-based)", "bool",
         numeric_key="grid_fastpath", consumer="ops/search.py",
         doc="uniform-grid kernel K2 vs the general exact-phase kernel K3"),
    Knob("CRIMP_TORCH_GRID_BLOCKS", "unset (autotuner)", "blocks",
         numeric_key="grid_blocks", consumer="ops/search.py via ops/autotune.py",
         doc="hard (event_block, trial_block) override for the grid kernels: the event split "
             "length per_split and K2's trial tile"),
    Knob("CRIMP_TORCH_GRID_MXU", "unset (off unless a tuner winner)", "int",
         numeric_key="grid_mxu", consumer="ops/search.py via ops/autotune.py",
         doc="factorized angle-addition matmul grids on/off"),
    Knob("CRIMP_TORCH_MXU_BF16", "unset (off unless a tuner winner)", "int",
         numeric_key="grid_mxu", consumer="ops/toafit.py + ops/search.py via ops/autotune.py",
         doc="bf16 operands (f32 accumulation) for profile sweeps and factorized grids"),
    Knob("CRIMP_TORCH_DELTA_FOLD", "unset (off unless a tuner winner)", "int",
         numeric_key="delta_fold", consumer="ops/anchored.py via ops/autotune.py",
         doc="incremental delta-fold engine on/off"),
    Knob("CRIMP_TORCH_DELTA_FOLD_BUDGET", "1e-9 cycles", "float",
         numeric_key="delta_fold", consumer="ops/anchored.py + pipelines/fit_toas.py",
         doc="delta-fold and delta-MCMC precision-guard budget"),
    Knob("CRIMP_TORCH_MCMC_DELTA", "unset (off unless a tuner winner)", "int",
         numeric_key="mcmc_delta", consumer="pipelines/fit_toas.py via ops/autotune.py",
         doc="delta-basis MCMC likelihood on/off"),
    # -- throughput / caching (bit-identical by construction) ---------------
    Knob("CRIMP_TORCH_TOA_DENSE_WINDOW", "unset (auto: 32)", "int",
         consumer="ops/toafit.py via ops/autotune.py",
         doc="dense error-scan first-window width (any value is bit-identical)"),
    Knob("CRIMP_TORCH_STREAM_MIN_EVENTS", "unset (2^22)", "int",
         consumer="ops/search.py",
         doc="event count above which grid chunks stream double-buffered (bit-exact)"),
    Knob("CRIMP_TORCH_FOLD_CACHE", "unset (in-process LRU)", "enum",
         consumer="ops/deltafold.py",
         doc="fold-product cache tier: off / mem / disk / explicit dir"),
    Knob("CRIMP_TORCH_MULTISOURCE", "unset (batched engine on)", "int",
         consumer="pipelines/survey.py via ops/autotune.py",
         doc="survey multi-source batch engine on/off (0 forces the per-source loop)"),
    Knob("CRIMP_TORCH_MULTISOURCE_MAX_PAD", "4.0", "float",
         consumer="ops/multisource.py via ops/autotune.py",
         doc="bucket-merge padding-waste cap for survey source buckets"),
    Knob("CRIMP_TORCH_MULTISOURCE_BATCH", "unset (resolved source block)", "int",
         consumer="ops/multisource.py via ops/autotune.py",
         doc="hard cap on sources per batched survey dispatch (0 = no cap)"),
    Knob("CRIMP_TORCH_SHARD", "auto", "bool", consumer="parallel/mesh.py",
         doc="multi-device auto-sharding opt-out (mesh-shape invariance is pinned by tests)"),
    Knob("CRIMP_TORCH_AUTOTUNE", "auto", "enum", consumer="ops/autotune.py",
         doc="tuner policy: off / auto (cached winners only) / eager"),
    Knob("CRIMP_TORCH_AUTOTUNE_CACHE", "~/.cache/crimp_tpu_torch/autotune.json", "path",
         consumer="ops/autotune.py",
         doc="fingerprinted verdict-cache location"),
    Knob("CRIMP_TORCH_COMPILE_CACHE", "build/kernels (in the checkout)", "path",
         consumer="utils/platform.py + ops/z2_grid.py",
         doc="nvcc build directory of the hand kernels; 0/off/none builds into a fresh "
             "per-process directory"),
    Knob("CRIMP_TORCH_TRACE_DIR", "unset", "path", consumer="utils/profiling.py",
         doc="torch.profiler trace directory for profiling.trace()"),
    # -- serving (host-side orchestration; numeric-neutral by contract) -----
    # -- multi-process execution (the process axis carries trials and
    #    sources, never a reduction: bitwise at 1, 2 and 4 processes) -------
    Knob("CRIMP_TORCH_DIST", "unset (single process)", "str",
         consumer="parallel/multihost.py",
         doc="torch.distributed bring-up spec 'host:port,num_processes,process_id'; unset/off = "
             "single-process. NCCL when the ranks' tensors live on the card, gloo on the CPU"),
    Knob("CRIMP_TORCH_SERVE_QUEUE", "64", "int",
         consumer="crimp_tpu_torch/serve/admission.py",
         doc="admission-queue capacity per priority class; a full class rejects new requests "
             "with a typed RESOURCE_EXHAUSTED (backpressure, never unbounded blocking)"),
    Knob("CRIMP_TORCH_SERVE_DEADLINE_MS", "unset (no default deadline)", "float",
         consumer="crimp_tpu_torch/serve/scheduler.py",
         doc="default per-request deadline for requests submitted without one; the scheduler "
             "degrades pre-emptively when the remaining budget cannot afford the top rung"),
    Knob("CRIMP_TORCH_SERVE_BREAKER", "5", "int",
         consumer="crimp_tpu_torch/serve/breaker.py",
         doc="consecutive classified failures at a ladder rung before its circuit breaker "
             "opens (half-opens on probe); 0 disables"),
    Knob("CRIMP_TORCH_SERVE_WARM_BATCH", "unset (batched warm path on)", "int",
         consumer="crimp_tpu_torch/serve/engine.py via ops/autotune.py",
         doc="warm re-timing path: 1 refolds every warm client of a round in one K4 launch, "
             "0 pins the per-request loop; the refolded phases are the same bits either way"),
    Knob("CRIMP_TORCH_SERVE_PREP_OVERLAP", "unset (overlap on)", "bool",
         consumer="crimp_tpu_torch/serve/engine.py",
         doc="overlap host-side request prep with the previous round's dispatch on one worker "
             "thread; 0 pins the serial prep order (results bit-identical either way)"),
    # -- observability (host-side telemetry; numeric-neutral by contract) ---
    Knob("CRIMP_TORCH_OBS", "unset (off)", "bool", consumer="crimp_tpu_torch/obs",
         doc="flight-recorder telemetry: spans/counters + an atomic run manifest"),
    Knob("CRIMP_TORCH_OBS_DIR", "obs_runs", "path", consumer="crimp_tpu_torch/obs",
         doc="where run manifests + JSONL event streams land"),
    Knob("CRIMP_TORCH_OBS_EVENTS", "on (when obs is on)", "bool",
         consumer="crimp_tpu_torch/obs",
         doc="append-only JSONL event stream alongside the manifest"),
    Knob("CRIMP_TORCH_OBS_HEARTBEAT_S", "30 (when obs is on)", "float",
         consumer="crimp_tpu_torch/obs/heartbeat.py",
         doc="heartbeat period: progress/ETA events + an atomically rewritten "
             "sidecar; 0/off disables"),
    Knob("CRIMP_TORCH_OBS_COST", "on (when obs is on)", "bool",
         consumer="crimp_tpu_torch/obs/costmodel.py",
         doc="cost-model capture (FLOPs/bytes per kernel call) feeding the manifest costmodel "
             "table and `obs roofline`; 0 disables"),
    Knob("CRIMP_TORCH_HBM_WARN_PCT", "90", "float",
         consumer="crimp_tpu_torch/obs/core.py",
         doc="warn (once per run) when the card's peak allocated bytes exceed this percent of "
             "its memory at a stage boundary; 0 disables"),
    Knob("CRIMP_TORCH_OBS_LEDGER", "unset (off)", "path",
         consumer="crimp_tpu_torch/obs/ledger.py",
         doc="append-only performance-ledger JSONL (`obs ledger add|show|check`)"),
    Knob("CRIMP_TORCH_OBS_HOST", "unset (torch.distributed rank)", "int",
         consumer="crimp_tpu_torch/obs/core.py",
         doc="host index override for obs artifact suffixing"),
    # -- resilience ---------------------------------------------------------
    Knob("CRIMP_TORCH_RETRIES", "1", "int",
         consumer="crimp_tpu_torch/resilience/policy.py",
         doc="same-mode retries after a transient classified failure "
             "(a successful retry is bit-identical)"),
    Knob("CRIMP_TORCH_BACKOFF_S", "0.05", "float",
         consumer="crimp_tpu_torch/resilience/policy.py",
         doc="base retry backoff; doubles per attempt with deterministic "
             "jitter (0 disables sleeping)"),
    Knob("CRIMP_TORCH_FAULTS", "unset (injector disarmed)", "str",
         consumer="crimp_tpu_torch/resilience/faultinject.py",
         doc="deterministic fault plan 'kind:point:n,...' for chaos tests "
             "(test instrumentation; never set in production)"),
))


def knob(name: str) -> Knob:
    """Look up a declared knob; unknown names raise (register first)."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"{name!r} is not a registered {PREFIX} knob; declare it in "
                       "crimp_tpu_torch/knobs.py REGISTRY") from None


def raw(name: str) -> str:
    """The stripped env value of a REGISTERED knob ('' when unset): the one
    environment read of the port's knobs."""
    knob(name)
    return os.environ.get(name, "").strip()


def is_set(name: str) -> bool:
    """Whether the knob has a non-blank value in the environment."""
    return bool(raw(name))


def parse_onoff(value: str) -> bool | None:
    """True for the ON_WORDS, False for the OFF_WORDS, None otherwise."""
    low = value.strip().lower()
    if low in ON_WORDS:
        return True
    if low in OFF_WORDS:
        return False
    return None


def env_onoff(name: str, *, auto_ok: bool = True) -> bool | None:
    """Parse a boolean-word knob: True/False for on/off words, None for
    unset (or explicit "auto" when ``auto_ok``); anything else raises."""
    env = raw(name)
    state = parse_onoff(env)
    if state is not None:
        return state
    if not env or (auto_ok and env.lower() == "auto"):
        return None
    raise ValueError(
        f"{name}={env!r} not recognized; use 1/on/true/always, "
        "0/off/false/never" + (", or auto/unset for the default" if auto_ok else "")
    )


def env_nonneg_int(name: str, valid=None) -> int | None:
    """Parse an integer knob; unset/blank -> None, malformed raises. Word
    forms raise here: "on"/"yes" are typos for the strict 0/1 switches."""
    env = raw(name)
    if not env:
        return None
    try:
        val = int(env)
    except ValueError:
        raise ValueError(f"{name}={env!r} is not an integer") from None
    if val < 0 or (valid is not None and val not in valid):
        allowed = "/".join(map(str, valid)) if valid else ">= 0"
        raise ValueError(f"{name}={env!r} out of range (expected {allowed})")
    return val


def env_pos_float(name: str) -> float | None:
    """Parse a positive-float knob; unset/blank -> None, malformed or
    non-positive/non-finite raises."""
    env = raw(name)
    if not env:
        return None
    try:
        val = float(env)
    except ValueError:
        raise ValueError(f"{name}={env!r} is not a number") from None
    if not (0.0 < val < float("inf")):
        raise ValueError(f"{name}={env!r} out of range (expected > 0)")
    return val


def env_float(name: str, default: float) -> float:
    """Parse a float knob with a default for unset/blank; malformed raises."""
    env = raw(name)
    if not env:
        return float(default)
    try:
        return float(env)
    except ValueError:
        raise ValueError(f"{name}={env!r} is not a number") from None


def env_int(name: str, default: int) -> int:
    """Parse an integer knob with a default for unset/blank; malformed raises."""
    env = raw(name)
    if not env:
        return int(default)
    try:
        return int(env)
    except ValueError:
        raise ValueError(f"{name}={env!r} is not an integer") from None


def env_str(name: str, default: str = "") -> str:
    """The stripped string value, or ``default`` when unset/blank."""
    return raw(name) or default


def cache_home() -> str:
    """$XDG_CACHE_HOME or ~/.cache: the base of the on-disk fold cache."""
    return os.environ.get("XDG_CACHE_HOME", "").strip() or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
