"""Phase-shift -> .tim conversion.

Port of ``crimp_tpu/pipelines/tim_tools.py::phshift_to_timfile`` (semantics
of CRIMP's timfile.py:164-233): each ToA is anchored at the nearest earlier
integer-rotation epoch of the spin-down model, then
ToA = T_int + (dphi/2pi)/f; errors are hypot(LL, UL)/sqrt(2) converted to
microseconds; optional -pn pulse numbers normalized to the first ToA. The
whole batch is anchored in one vectorized host solve.
"""

from __future__ import annotations

import numpy as np

from crimp_tpu_torch import obs
from crimp_tpu_torch.io import tim as tim_io
from crimp_tpu_torch.io.table import read_columns
from crimp_tpu_torch.models import timing
from crimp_tpu_torch.obs import names as spans
from crimp_tpu_torch.ops.ephem import integer_rotation_host


def toas_to_tim_table(toa_mids, ph_shift, ph_ll, ph_ul, timMod, tempModPP: str = "ppTemplateMod",
                      inst: str = "Xray", addpn: bool = False) -> dict:
    """FORMAT-1 .tim columns from per-ToA epochs (MJD) and phase shifts (rad)."""
    with obs.profiler_range(spans.TIM_ROTATION):
        toa_mids = np.asarray(toa_mids, dtype=float)
        tm = timing.resolve(timMod)
        anchors = integer_rotation_host(tm, toa_mids)
    with obs.profiler_range(spans.TIM_TABLE):
        dphi_cycles = np.asarray(ph_shift, dtype=float) / (2 * np.pi)
        dphi_err_cycles = np.hypot(
            np.asarray(ph_ll, dtype=float) / (2 * np.pi),
            np.asarray(ph_ul, dtype=float) / (2 * np.pi),
        ) / np.sqrt(2)
        freq = anchors["freq_intRotation"]
        toa_tim = anchors["Tmjd_intRotation"] + (dphi_cycles / freq) / 86400.0
        toa_err_us = (dphi_err_cycles / freq) * 1e6

        n = len(toa_mids)
        out = {
            "template": np.full(n, tempModPP),
            "Frequency": np.full(n, 700),
            "TOA": np.round(toa_tim, 12),
            "TOA_err": np.round(toa_err_us, 5),
            "timeunit": np.full(n, "@"),
            "flag_instrument": np.full(n, "-i"),
            "instrument": np.full(n, inst),
        }
        if addpn:
            pulse_number = anchors["ph_intRotation"]
            pulse_number = pulse_number - np.min(pulse_number)
            out["pulsenumberflag"] = np.full(n, "-pn")
            out["pulsenumber"] = np.round(pulse_number).astype(np.int64)
    return out


def phshift_to_timfile(
    ToAs: str,
    timMod,
    timfile: str = "residuals",
    tempModPP: str = "ppTemplateMod",
    inst: str = "Xray",
    addpn: bool = False,
    clobber: bool = False,
) -> dict:
    """Convert a ToAs.txt phase-shift table into a FORMAT-1 .tim file."""
    toas = read_columns(ToAs)
    table = toas_to_tim_table(
        toas["ToA_mid"], toas["phShift"], toas["phShift_LL"], toas["phShift_UL"],
        timMod, tempModPP=tempModPP, inst=inst, addpn=addpn,
    )
    tim_io.write_tim(timfile, table, clobber=clobber)
    return table


# Reference-named alias (timfile.py:164), as in the JAX package.
phshiftTotimfile = phshift_to_timfile
