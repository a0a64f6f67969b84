"""Binned pulse profiles from folded phases (host numpy).

Port of ``crimp_tpu/ops/binprofile.py`` (parity with CRIMP's binphases.py):
phases may live on [0,1) (Fourier convention) or [0,2pi) (von Mises /
Cauchy convention); bins are uniform with sqrt(N) count errors. From
NATIVE_MIN_PHASES phases on, the counts come from the native single-pass
histogram (``io/native``: ``np.histogram``'s counts) when its library loads;
the fallback to ``np.histogram`` is counted (``native_fallbacks``).
"""

from __future__ import annotations

import numpy as np

NATIVE_MIN_PHASES = 1_000_000


def bin_phases(phases: np.ndarray, nbrBins: int = 15) -> dict:
    """Histogram folded phases into a counts profile.

    Returns {'ppBins' (bin centers), 'ppBinsRange' (half-width),
    'ctsBins', 'ctsBinsErr'}.
    """
    phases = np.asarray(phases)
    if ((phases >= 0) & (phases <= 1)).all():
        upper = 1.0
    elif ((phases >= 0) & (phases <= 2 * np.pi)).all():
        upper = 2 * np.pi
    else:
        raise ValueError("phase array is not cycle folded to [0,1) or [0,2*pi)")

    half_bin = (upper / nbrBins) / 2
    centers = np.linspace(0, upper, nbrBins, endpoint=False) + half_bin
    counts = None
    if phases.size >= NATIVE_MIN_PHASES:
        # large arrays: the C++ single-pass histogram (native/crimpio.cpp)
        # avoids numpy's edge binary-search
        from crimp_tpu_torch.io import native

        counts = native.phase_histogram(phases, upper, nbrBins)
        if counts is None:
            native.note_fallback("phase histogram")
    if counts is None:
        edges = np.linspace(0, upper, nbrBins + 1, endpoint=True)
        counts = np.histogram(phases, bins=edges)[0]
    return {
        "ppBins": centers,
        "ppBinsRange": half_bin,
        "ctsBins": counts,
        "ctsBinsErr": np.sqrt(counts),
    }


# Reference-named alias (binphases.py:9), as in the JAX package.
binphases = bin_phases
