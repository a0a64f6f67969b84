"""Resilience layer: failure taxonomy, degradation policy, faults.

Port of ``crimp_tpu/resilience``:

* ``classify(exc) -> FailureKind``: the single exception-classification
  funnel, torch and CUDA errors included;
* ``retry_call`` / ``RetryPolicy``: bounded same-mode retry, never of a
  ``KernelError`` or a sticky CUDA error;
* ``record_degradation`` / ``LADDERS``: stamp the obs run degraded when an
  engine falls to a lower parity-pinned rung;
* ``quarantine_file``: atomic ``*.corrupt`` rename for bad cache files;
* ``faultinject.fire(point)``: deterministic chaos injection, armed by
  ``CRIMP_TORCH_FAULTS``, a no-op otherwise;
* ``KernelError``: a hand-written kernel's build or launch failure, which
  every ladder re-raises untouched.
"""

from crimp_tpu_torch.resilience import faultinject, policy, taxonomy
from crimp_tpu_torch.resilience.policy import (LADDERS, RetryPolicy, default_policy, quarantine_file,
                                               record_degradation, retry_call)
from crimp_tpu_torch.resilience.taxonomy import (CacheCorruptError, CrimpError, DataError,
                                                 FailureKind, InjectedFault, KernelError,
                                                 NonfiniteResultError, classify, error_record)

__all__ = [
    "CacheCorruptError", "CrimpError", "DataError", "FailureKind", "InjectedFault",
    "KernelError", "LADDERS", "NonfiniteResultError", "RetryPolicy", "classify", "default_policy",
    "error_record", "faultinject", "policy", "quarantine_file", "record_degradation", "retry_call",
    "taxonomy",
]
