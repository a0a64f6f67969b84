"""crimp_tpu_torch.obs: host-side flight-recorder telemetry.

Port of ``crimp_tpu/obs``:

- **Spans + metrics core** (:mod:`crimp_tpu_torch.obs.core`): hierarchical
  spans (run -> pipeline stage -> kernel) plus typed counters and gauges,
  :func:`run` (an append-only JSONL event stream and an atomic end-of-run
  JSON manifest in the JAX package's schema) and :func:`mark_degraded`.
- **Heartbeats** (:mod:`crimp_tpu_torch.obs.heartbeat`): :func:`beat`,
  periodic progress/ETA events and an atomic sidecar.
- **Readers**: :mod:`~crimp_tpu_torch.obs.manifest` (schema validation and
  loading), :mod:`~crimp_tpu_torch.obs.report` (summary, diff, Chrome
  trace, Prometheus), :mod:`~crimp_tpu_torch.obs.salvage` (a killed run's
  event stream into a manifest; live tail), :mod:`~crimp_tpu_torch.obs.merge`
  (per-host streams of one run into one manifest), and the CLI over them,
  ``python -m crimp_tpu_torch.obs``.
- **Cost model and roofline** (:mod:`~crimp_tpu_torch.obs.costmodel`,
  :mod:`~crimp_tpu_torch.obs.roofline`): FLOP and byte counts per kernel
  call, joined against the kernel spans' device time into each kernel's
  share of the H100 roofline (``obs roofline``).
- **Ledger** (:mod:`~crimp_tpu_torch.obs.ledger`): the append-only
  performance ledger, ``obs ledger add|show|check``.

Disabled (``CRIMP_TORCH_OBS`` unset/off, the default) every hook is a
strict no-op: :func:`span` returns a shared singleton and
:func:`counter_add` returns after one global ``None`` check.
"""

from crimp_tpu_torch.obs.core import (  # noqa: F401
    NULL_SPAN,
    OBS_SCHEMA,
    OBS_SCHEMA_VERSION,
    active,
    counter_add,
    current_span_name,
    enabled,
    gauge_set,
    last_manifest_path,
    mark_degraded,
    record_cost,
    record_device_span,
    record_numeric_mode,
    record_span,
    run,
    span,
)
from crimp_tpu_torch.obs import heartbeat  # noqa: F401
from crimp_tpu_torch.obs.heartbeat import beat  # noqa: F401
