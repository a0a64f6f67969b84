"""Knob resolution for the multi-source survey engine.

Port of the multisource part of ``crimp_tpu/ops/autotune.py``
(``multisource_defaults``, ``resolve_multisource`` and the "multisource"
block defaults). The JAX package also consults a cached bench A/B verdict
between the environment and the defaults; the port has no tuner cache
yet, so the resolution is the environment over the defaults, which is
what the JAX package returns when no cache is present.
"""

from __future__ import annotations

from crimp_tpu_torch import knobs

MULTISOURCE_ENV = "CRIMP_TORCH_MULTISOURCE"
MULTISOURCE_MAX_PAD_ENV = "CRIMP_TORCH_MULTISOURCE_MAX_PAD"
MULTISOURCE_BATCH_ENV = "CRIMP_TORCH_MULTISOURCE_BATCH"
MULTISOURCE_MAX_PAD_DEFAULT = 4.0
# (event_block, source_block) of the "multisource" key: the padded
# per-source event width and the source rows per dispatch; together they
# bound a dispatch to ~event_block * source_block padded cells
MULTISOURCE_EVENT_BLOCK = 1 << 15
MULTISOURCE_SOURCE_BLOCK = 256


def multisource_defaults() -> dict:
    return {"multisource": 1, "max_pad": MULTISOURCE_MAX_PAD_DEFAULT, "batch_cap": 0}


def multisource_blocks() -> tuple[int, int]:
    """(event_block, source_block) for the survey batch engine."""
    return MULTISOURCE_EVENT_BLOCK, MULTISOURCE_SOURCE_BLOCK


def resolve_multisource(n_sources: int, n_events: int) -> dict:
    """Resolve {multisource, max_pad, batch_cap} for a survey workload.

    Per knob: CRIMP_TORCH_MULTISOURCE / _MAX_PAD / _BATCH (hard overrides;
    malformed raises) > defaults (batched path on, max_pad 4.0, no batch
    cap). ``n_sources`` and ``n_events`` key the JAX package's cached
    verdict, which the port does not have yet.
    """
    out = multisource_defaults()
    env_m = knobs.env_nonneg_int(MULTISOURCE_ENV, valid=(0, 1))
    env_p = knobs.env_pos_float(MULTISOURCE_MAX_PAD_ENV)
    env_b = knobs.env_nonneg_int(MULTISOURCE_BATCH_ENV)
    if env_m is not None:
        out["multisource"] = env_m
    if env_p is not None:
        out["max_pad"] = env_p
    if env_b is not None:
        out["batch_cap"] = env_b
    return out
