"""ToA time-interval builder (CLI: timeintervalsfortoas), without pandas.

Port of ``crimp_tpu/pipelines/intervals.py`` (behaviour of CRIMP's
buildtimeintervalsToAs.py:64-365): bunch GTIs at gaps larger than
waitTimeCutoff, slice each bunch into ToAs of totCtsEachToA counts, clip
GTIs to each ToA window for exact livetime, skip zero-exposure windows,
merge trailing low-count intervals into their predecessor, and optionally
correct NICER count rates for the number of selected FPMs (52-detector
normalization).

This stage is data-dependent host logic: it runs in numpy. The interval
table is a dict of numpy columns; ``<outputFile>.txt`` is written as the
JAX package writes it (tab-separated, a ``ToA`` index column, every value
a float in its shortest round-trip form), so either package's
``measuretoas`` reads either package's file.
"""

from __future__ import annotations

import numpy as np

from crimp_tpu_torch.io.events import EventFile
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

COLUMNS = ["ToA_tstart", "ToA_tend", "ToA_lenInt", "ToA_exposure", "Events", "ct_rate"]


def _clipped_exposure_days(gti: np.ndarray, t_start: float, t_end: float) -> float:
    """Livetime within [t_start, t_end]: GTIs clipped to the window."""
    keep = (gti[:, 1] > t_start) & (gti[:, 0] < t_end)
    if not keep.any():
        return 0.0
    clipped = gti[keep].copy()
    # t_start/t_end are event times inside the first/last kept GTI, so the
    # window edges replace those GTI edges outright (CRIMP semantics,
    # buildtimeintervalsToAs.py:239-242).
    clipped[0, 0] = t_start
    clipped[-1, -1] = t_end
    return float(np.sum(clipped[:, 1] - clipped[:, 0]))


def _table(rows: list[dict]) -> dict:
    """Rows -> {column: float64 array} (Events too, as pandas stores them)."""
    return {c: np.asarray([row[c] for row in rows], dtype=np.float64) for c in COLUMNS}


def write_intervals(path: str, intervals: dict) -> None:
    """The interval table as tab-separated text with a ``ToA`` index."""
    with open(path, "w") as fh:
        fh.write("\t".join(["ToA"] + COLUMNS) + "\n")
        for i in range(len(intervals["ToA_tstart"])):
            fh.write("\t".join([str(i)] + [repr(float(intervals[c][i])) for c in COLUMNS]) + "\n")


def build_time_intervals(
    evtFile: str,
    totCtsEachToA: int = 1000,
    waitTimeCutoff: float = 1.0,
    eneLow: float = 0.5,
    eneHigh: float = 10.0,
    min_counts: int | None = None,
    max_wait: float | None = None,
    outputFile: str = "timIntToAs",
    correxposure: bool = False,
) -> dict:
    """Build per-ToA [start, end] windows; writes <outputFile>.txt (+_bunches)."""
    if min_counts is None:
        min_counts = int(totCtsEachToA / 2)
    if max_wait is None:
        max_wait = waitTimeCutoff

    logger.info(
        "\n Running build_time_intervals: evtFile=%s totCtsEachToA=%s waitTimeCutoff=%s "
        "eneLow=%s eneHigh=%s min_counts=%s max_wait=%s outputFile=%s",
        evtFile, totCtsEachToA, waitTimeCutoff, eneLow, eneHigh, min_counts, max_wait, outputFile,
    )

    ef = EventFile(evtFile)
    keywords, gti = ef.read_gti()
    times = ef.build_time_energy_df().filtenergy(eneLow, eneHigh).time_energy_df["TIME"]

    # --- bunch GTIs at gaps > waitTimeCutoff -------------------------------
    gaps = gti[1:, 0] - gti[:-1, 1]
    bunch_breaks = np.nonzero(gaps > waitTimeCutoff)[0] + 1
    bunch_edges = np.concatenate([[0], bunch_breaks, [len(gti)]])

    bunches = []
    for lo, hi in zip(bunch_edges[:-1], bunch_edges[1:]):
        seg = gti[lo:hi]
        bunches.append(
            (
                seg[0, 0],
                seg[-1, 1],
                float(np.sum(seg[:, 1] - seg[:, 0])),
                seg[-1, 1] - seg[0, 0],
            )
        )

    with open(outputFile + "_bunches.txt", "w") as fh:
        fh.write("ToABunch_tstart \t ToABunch_tend \t ToABunch_exp \t ToABunch_lenInt\n")
        for start, end, exp_days, length in bunches:
            fh.write(f"{start}\t{end}\t{exp_days * 86400}\t{length}\n")

    # --- slice each bunch into count-limited ToA windows -------------------
    rows = []
    for start, end, _, _ in bunches:
        in_bunch = times[(times >= start) & (times <= end)]
        n_toas = int(np.ceil(len(in_bunch) / totCtsEachToA))
        for k in range(n_toas):
            chunk = in_bunch[k * totCtsEachToA : (k + 1) * totCtsEachToA] if k < n_toas - 1 else in_bunch[k * totCtsEachToA :]
            if len(chunk) == 0:
                continue
            exposure_days = _clipped_exposure_days(gti, chunk[0], chunk[-1])
            if exposure_days == 0:
                logger.warning(
                    "At %s MJD: exposure = 0 likely caused by a single timestamp in interval - skipping",
                    chunk[0],
                )
                continue
            exposure_sec = exposure_days * 86400.0
            rows.append(
                {
                    "ToA_tstart": float(chunk[0]),
                    "ToA_tend": float(chunk[-1]),
                    "ToA_lenInt": float(chunk[-1] - chunk[0]),
                    "ToA_exposure": exposure_sec,
                    "Events": len(chunk),
                    "ct_rate": len(chunk) / exposure_sec,
                }
            )

    intervals = merge_adjacent_intervals(rows, min_counts, max_wait)
    n_total = len(intervals["ToA_tstart"])

    # --- NICER FPM-selection exposure correction ---------------------------
    if keywords["TELESCOPE"] == "NICER":
        logger.warning(
            "\n If NICER event files were generated with HEASOFT 6.32+, correct for "
            "the number of selected FPMs (-ce) for accurate count rates\n"
        )
        if correxposure:
            _, fpm = ef.read_fpmsel()
            for i in range(n_total):
                window = (fpm["TIME"] >= intervals["ToA_tstart"][i]) & (fpm["TIME"] <= intervals["ToA_tend"][i])
                n_selected = float(np.sum(fpm["TOTFPMSEL"][window]))
                expected = 52.0 * intervals["ToA_exposure"][i]
                if n_selected > 0:
                    intervals["ct_rate"][i] *= expected / n_selected
    elif keywords["TELESCOPE"] == "NuSTAR":
        logger.warning(
            "\n If NuSTAR event files merge FPMA and FPMB, count rates are a factor of 2 smaller.\n"
        )

    print(f"Total number of time intervals that define the TOAs: {n_total}")
    write_intervals(outputFile + ".txt", intervals)
    logger.info(
        "\n End of build_time_intervals run: %s intervals; wrote %s_bunches.txt and %s.txt",
        n_total, outputFile, outputFile,
    )
    return intervals


def merge_adjacent_intervals(rows: list[dict], events_max: int, dtstart_max_days: float) -> dict:
    """Merge a row into its predecessor when Events < events_max and the gap
    to the previous interval end is < dtstart_max_days; returns the table."""
    if not rows:
        return _table([])
    merged = []
    current = dict(rows[0])
    for row in rows[1:]:
        if row["Events"] < events_max and (row["ToA_tstart"] - current["ToA_tend"]) < dtstart_max_days:
            current["ToA_tend"] = row["ToA_tend"]
            current["ToA_lenInt"] = current["ToA_tend"] - current["ToA_tstart"]
            current["ToA_exposure"] = current["ToA_exposure"] + row["ToA_exposure"]
            current["Events"] = current["Events"] + row["Events"]
            current["ct_rate"] = (
                current["Events"] / current["ToA_exposure"]
                if current["ToA_exposure"] != 0
                else float("nan")
            )
        else:
            merged.append(current)
            current = dict(row)
    merged.append(current)
    return _table(merged)


# Reference-named alias (buildtimeintervalsToAs.py:64).
timeintervalsToAs = build_time_intervals
