"""X-ray event-file operations on top of the self-contained FITS layer.

Port of ``crimp_tpu/io/events.py`` without pandas: the TIME/PI table is a
dict of numpy columns (``time_energy_df["TIME"]`` keeps the reference's
name). The TIME/PI columns come from the native mmap reader (``io/native``,
``native/crimpio.cpp``) when its library loads, else from the pure-Python
FITS layer, with the same bits; ``EventFile.reader`` says which one ran,
and each fallback is counted (``native_fallbacks``).

- essential header keywords (TELESCOP/INSTRUME/TSTART/TSTOP/TIMESYS/MJDREF
  from MJDREFI+MJDREFF or MJDREF, plus optional mission keywords),
- GTI tables with mission-specific extension names, converted to MJD,
- the TIME/PI table with per-telescope PI -> keV conversion
  (NICER/Swift x0.01; NuSTAR x0.04+1.6; XMM x0.001; IXPE x0.04; GBM raw PHA),
- inclusive energy/time filters,
- NICER FPM_SEL condensation (per-timestamp selected/on detector counts),
- a folded PHASE column appended to the event file (``add_phase_column``).
"""

from __future__ import annotations

import numpy as np

from crimp_tpu_torch.io import fitsio
from crimp_tpu_torch.utils.device import resolve_device
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# keV per PI channel (offset, scale) by telescope.
_PI_TO_KEV = {
    "NICER": (0.0, 0.01),
    "SWIFT": (0.0, 0.01),
    "NuSTAR": (1.6, 0.04),
    "XMM": (0.0, 0.001),
    "IXPE": (0.0, 0.04),
}

_OPTIONAL_KEYS = [
    "TIMEZERO",
    "OBS_ID",
    "LIVETIME",
    "ONTIME",
    "DETNAME",
    "DATATYPE",
    "CCDSRC",
]


def _select(table: dict, mask: np.ndarray) -> dict:
    return {name: col[mask] for name, col in table.items()}


class EventFile:
    """Operations on one FITS event file (header, GTIs, events, filters)."""

    def __init__(self, evtFile: str):
        self.evtFile = str(evtFile)
        self.time_energy_df: dict | None = None
        self.reader: str | None = None  # "native" or "pure": the last column read
        self._fits: fitsio.FITSFile | None = None

    def _open(self) -> fitsio.FITSFile:
        if self._fits is None:
            self._fits = fitsio.read_fits(self.evtFile)
        return self._fits

    def read_header_keywords(self) -> dict:
        """Essential keywords from the EVENTS extension header."""
        header = self._open()["EVENTS"].header
        keywords = {
            "TELESCOPE": header["TELESCOP"],
            "INSTRUME": header["INSTRUME"],
            "TSTART": header["TSTART"],
            "TSTOP": header["TSTOP"],
            "TIMESYS": header["TIMESYS"],
            "DATEOBS": header.get("DATE-OBS"),
        }
        for key in _OPTIONAL_KEYS:
            keywords[key] = header.get(key)
        if "MJDREFI" in header:
            keywords["MJDREF"] = header["MJDREFI"] + header["MJDREFF"]
        elif "MJDREF" in header:
            keywords["MJDREF"] = header["MJDREF"]
        else:
            logger.error(
                "No reference time in event file, need either MJDREFI or MJDREF keywords"
            )
            keywords["MJDREF"] = None
        if keywords["TIMESYS"] != "TDB":
            logger.warning("\n Event file is not barycentered. Proceed with care!")
        return keywords

    def read_gti(self):
        """(keywords, gti_list) with GTIs as an (N,2) MJD array."""
        keywords = self.read_header_keywords()
        telescope = keywords["TELESCOPE"]
        fits = self._open()

        if telescope == "XMM":
            ccdsrc = int(keywords["CCDSRC"])
            ext = f"STDGTI{ccdsrc:02d}" if ccdsrc < 10 else f"STDGTI{ccdsrc}"
            gti_hdu = fits[ext]
        elif telescope in ("NICER", "SWIFT", "NuSTAR", "IXPE"):
            gti_hdu = fits["GTI"]
        elif telescope == "GLAST":
            gti_hdu = fits["GTI"]
            if fits[0].header.get("DATATYPE") == "TTE":
                logger.warning(
                    "Default GTI of GBM TTE file is simply start and end time of day."
                )
        else:
            raise ValueError(
                f"TELESCOP {telescope!r} not supported; check the event file keywords"
            )

        start = np.asarray(gti_hdu.column("START"), dtype=np.float64)
        stop = np.asarray(gti_hdu.column("STOP"), dtype=np.float64)
        gti_list = np.column_stack([start, stop]) / 86400.0 + keywords["MJDREF"]
        return keywords, gti_list

    def build_time_energy_df(self) -> "EventFile":
        """Build the TIME (MJD) / PI (keV) columns from the EVENTS table.

        Large files go through the native mmap reader (``io/native``) when
        its library loads; the pure-Python FITS layer is the always-correct
        fallback, counted in ``native_fallbacks``."""
        from crimp_tpu_torch.io import native

        keywords = self.read_header_keywords()
        telescope = keywords["TELESCOPE"]
        energy_col = "PHA" if telescope == "GLAST" else "PI"

        columns = native.read_columns(self.evtFile, "EVENTS", ["TIME", energy_col])
        if columns is not None:
            time_met, energy = columns["TIME"], columns[energy_col]
            self.reader = "native"
        else:
            native.note_fallback(f"{self.evtFile} EVENTS")
            events = self._open()["EVENTS"]
            time_met = np.asarray(events.column("TIME"), dtype=np.float64)
            energy = np.asarray(events.column(energy_col), dtype=np.float64)
            self.reader = "pure"

        time_mjd = time_met / 86400.0 + keywords["MJDREF"]
        if telescope == "GLAST":
            logger.warning(
                "GBM only provides PHAs; energy filters operate on raw PHA values."
            )
            self.time_energy_df = {"TIME": time_mjd, "PHA": energy}
        else:
            offset, scale = _PI_TO_KEV[telescope]
            self.time_energy_df = {"TIME": time_mjd, "PI": energy * scale + offset}
        return self

    def filtenergy(self, eneLow: float, eneHigh: float) -> "EventFile":
        """Keep events with PI (keV) in [eneLow, eneHigh]."""
        if self.time_energy_df is None:
            raise RuntimeError("call build_time_energy_df() before filtering")
        if "PI" not in self.time_energy_df:
            raise RuntimeError("no PI column to filter against")
        pi = self.time_energy_df["PI"]
        self.time_energy_df = _select(self.time_energy_df, (pi >= eneLow) & (pi <= eneHigh))
        return self

    def filttime(self, t_start: float | None = None, t_end: float | None = None):
        """Keep events with TIME (MJD) in [t_start, t_end]."""
        if self.time_energy_df is None:
            raise RuntimeError("call build_time_energy_df() before filtering")
        lo = -np.inf if t_start is None else t_start
        hi = np.inf if t_end is None else t_end
        t = self.time_energy_df["TIME"]
        self.time_energy_df = _select(self.time_energy_df, (t >= lo) & (t <= hi))
        return self

    def read_fpmsel(self):
        """NICER FPM_SEL table condensed to per-timestamp detector counts."""
        keywords = self.read_header_keywords()
        if keywords["TELESCOPE"] != "NICER":
            raise ValueError("FPM selection is only available for NICER observations")
        hdu = self._open()["FPM_SEL"]
        time_mjd = (
            np.asarray(hdu.column("TIME"), dtype=np.float64) / 86400.0
            + keywords["MJDREF"]
        )
        fpm_sel = np.asarray(hdu.column("FPM_SEL"))
        fpm_on = np.asarray(hdu.column("FPM_ON"))
        condensed = {
            "TIME": time_mjd,
            "TOTFPMSEL": fpm_sel.reshape(len(time_mjd), -1).sum(axis=1),
            "TOTFPMON": fpm_on.reshape(len(time_mjd), -1).sum(axis=1),
        }
        return hdu.data, condensed

    def add_phase_column(self, timMod: str, nonBaryEvtFile: str | None = None, device=None) -> dict:
        """Fold the EVENTS TIME column on ``device`` (default cuda) and append
        a PHASE column in place.

        Optionally mirrors the same PHASE column into a non-barycentered
        sibling file (for phase-resolved spectroscopy workflows).
        """
        from crimp_tpu_torch.ops.fold import fold_phases

        device = resolve_device(device)
        keywords = self.read_header_keywords()
        fits = self._open()
        events = fits["EVENTS"]
        time_mjd = (
            np.asarray(events.column("TIME"), dtype=np.float64) / 86400.0
            + keywords["MJDREF"]
        )
        _, folded = fold_phases(time_mjd, timMod, device=device)
        folded = np.asarray(folded)
        fitsio.add_table_column(events, "PHASE", folded, tform="D")
        fitsio.write_fits(self.evtFile, fits)
        self._fits = None  # invalidate cache after rewrite

        if nonBaryEvtFile is not None:
            other = fitsio.read_fits(nonBaryEvtFile)
            fitsio.add_table_column(other["EVENTS"], "PHASE", folded, tform="D")
            fitsio.write_fits(nonBaryEvtFile, other)
        return keywords


# Reference-named alias (eventfile.py:33).
EvtFileOps = EventFile
