"""Failure taxonomy: map raw exceptions to a closed set of FailureKinds.

Port of ``crimp_tpu/resilience/taxonomy.py``. Everything downstream of a
failure (degradation ladders, the ``last_survey_info()`` error records)
keys off the *kind* of a failure. ``classify()`` is the single funnel: our
own typed errors carry their kind; torch and CUDA errors are recognised by
type first (``torch.cuda.OutOfMemoryError`` is
RESOURCE_EXHAUSTED), then by message; builtins come last.

A card that is gone (no CUDA-capable device, an ECC error, a GPU fallen off
the bus) is DEVICE_LOST. A kernel fault (an illegal memory access, a
misaligned address, a device-side assert, an unspecified launch failure)
is not: it is a defect of the code that launched it, and it classifies
UNKNOWN. ``KernelError`` marks a hand-written kernel that could not be
built or whose launch returned a CUDA error; every ladder re-raises it
before it classifies anything, so no rung ever hides one.
"""

from __future__ import annotations

import enum
import errno
import json
import zipfile

import torch


class FailureKind(enum.Enum):
    """Closed classification of runtime failures."""

    RESOURCE_EXHAUSTED = "resource_exhausted"
    DEVICE_LOST = "device_lost"
    NONFINITE_RESULT = "nonfinite_result"
    CACHE_CORRUPT = "cache_corrupt"
    TIMEOUT = "timeout"
    DATA_ERROR = "data_error"
    UNKNOWN = "unknown"


class CrimpError(Exception):
    """Base for the port's typed errors; subclasses pin a FailureKind."""

    kind: FailureKind = FailureKind.UNKNOWN


class NonfiniteResultError(CrimpError):
    """A kernel produced NaN/Inf where the contract requires finite output."""

    kind = FailureKind.NONFINITE_RESULT


class CacheCorruptError(CrimpError):
    """An on-disk cache product failed validation (torn write, bad sha)."""

    kind = FailureKind.CACHE_CORRUPT


class DataError(CrimpError):
    """Caller-supplied data violated an invariant (empty source, bad shape)."""

    kind = FailureKind.DATA_ERROR


class KernelError(CrimpError, RuntimeError):
    """A hand-written kernel failed: no nvcc, a failed build, or a launch
    that returned a CUDA error. Never taken down a ladder."""

    kind = FailureKind.UNKNOWN


class InjectedFault(CrimpError):
    """Raised by the fault injector; carries the kind it is impersonating."""

    def __init__(self, kind: FailureKind, point: str, call_no: int):
        super().__init__(f"injected {kind.value} fault at point '{point}' (call #{call_no})")
        self.kind = kind
        self.point = point


# Message fragments, lowercased, as in the JAX package; CUDA's own wording
# joins the device and kernel-fault sets.
_RESOURCE_PATTERNS = (
    "resource_exhausted",
    "resource exhausted",
    "out of memory",
    "out-of-memory",
    "oom",
    "failed to allocate",
    "allocation failure",
    "hbm",
)
_TIMEOUT_PATTERNS = (
    "deadline_exceeded",
    "deadline exceeded",
    "timed out",
    "timeout",
)
_DEVICE_PATTERNS = (
    "device_lost",
    "device lost",
    "device or resource busy",
    "device halted",
    "tpu driver",
    "device unavailable",
    "failed_precondition: device",
    "no cuda-capable device",
    "ecc error",
    "uncorrectable ecc",
    "fallen off the bus",
)
_KERNEL_FAULT_PATTERNS = (
    "illegal memory access",
    "misaligned address",
    "device-side assert",
    "unspecified launch failure",
    "illegal instruction",
)
_NONFINITE_PATTERNS = (
    "nan",
    "non-finite",
    "nonfinite",
    "not finite",
)


def _match(text: str, patterns: tuple[str, ...]) -> bool:
    return any(p in text for p in patterns)


def classify(exc: BaseException) -> FailureKind:
    """Map an exception to its FailureKind.

    Order: typed errors carry their own kind; torch's out-of-memory type;
    accelerator-runtime errors by message (kernel faults first, so a
    device-side assert is never mistaken for a lost card); builtins last.
    """
    kind = getattr(exc, "kind", None)
    if isinstance(kind, FailureKind):
        return kind
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return FailureKind.RESOURCE_EXHAUSTED

    text = str(exc).lower()
    module = type(exc).__module__ or ""
    from_runtime = (module.startswith("torch") or "cuda error" in text
                    or type(exc).__name__ == "AcceleratorError")
    if from_runtime and _match(text, _KERNEL_FAULT_PATTERNS):
        return FailureKind.UNKNOWN
    if from_runtime or _match(text, _RESOURCE_PATTERNS + _TIMEOUT_PATTERNS + _DEVICE_PATTERNS):
        if _match(text, _RESOURCE_PATTERNS):
            return FailureKind.RESOURCE_EXHAUSTED
        if _match(text, _DEVICE_PATTERNS):
            return FailureKind.DEVICE_LOST
        if _match(text, _TIMEOUT_PATTERNS):
            return FailureKind.TIMEOUT
        if from_runtime and _match(text, _NONFINITE_PATTERNS):
            return FailureKind.NONFINITE_RESULT

    if isinstance(exc, MemoryError):
        return FailureKind.RESOURCE_EXHAUSTED
    if isinstance(exc, TimeoutError):
        return FailureKind.TIMEOUT
    if isinstance(exc, FloatingPointError):
        return FailureKind.NONFINITE_RESULT
    # JSONDecodeError subclasses ValueError: check cache-corruption shapes
    # before the generic data-error bucket.
    if isinstance(exc, (json.JSONDecodeError, zipfile.BadZipFile, EOFError)):
        return FailureKind.CACHE_CORRUPT
    if isinstance(exc, OSError):
        if exc.errno in (errno.ENOSPC, errno.EDQUOT):
            return FailureKind.RESOURCE_EXHAUSTED
        return FailureKind.DATA_ERROR
    if isinstance(exc, (ValueError, KeyError, TypeError, IndexError, AssertionError)):
        return FailureKind.DATA_ERROR
    return FailureKind.UNKNOWN


def sticky_cuda_error(exc: BaseException) -> bool:
    """Whether ``exc`` is a kernel fault that poisons the CUDA context (an
    illegal address, a device-side assert, ...): every later call on the
    card fails the same way, so no retry may follow it."""
    text = str(exc).lower()
    return _match(text, _KERNEL_FAULT_PATTERNS) and (
        (type(exc).__module__ or "").startswith("torch") or "cuda" in text
        or type(exc).__name__ == "AcceleratorError")


def error_record(exc: BaseException) -> dict:
    """Uniform error record for info dicts: kind + class + message."""
    return {
        "kind": classify(exc).value,
        "type": type(exc).__name__,
        "message": str(exc),
    }
