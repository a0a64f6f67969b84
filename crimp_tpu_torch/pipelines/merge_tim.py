"""Merge overlapping .tim files carrying pulse numbers (CLI: mergeoverlappingtims).

Port of ``crimp_tpu/pipelines/merge_tim.py`` (CRIMP's
merge_overlapping_timfiles.py:109-214) on the port's numpy ``.tim`` tables:
consecutive files must share at least one ToA (matched after rounding MJDs
to 12 decimals); the integer pulse-number shift is anchored on the FIRST
overlap, every other overlap must then agree (else a ValueError), and a
duplicated ToA keeps the earlier file's row. Rows sort as pandas'
``sort_values`` sorts them (numpy's quicksort).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from crimp_tpu_torch.io.tim import PulseToAs, read_tim, select_rows
from crimp_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

TOA_ROUND_DECIMALS = 12  # fixed by design


def _sorted_by_toa(table: dict) -> dict:
    return select_rows(table, np.argsort(np.asarray(table["pulse_ToA"], dtype=float), kind="quicksort"))


def _load_tim(timfile: str) -> dict:
    table = read_tim(timfile, skiprows=1)
    absent = [col for col in ("pulse_ToA", "pn") if col not in table]
    if absent:
        raise ValueError(
            f"{timfile} lacks {absent}: a mergeable .tim needs ToA epochs and "
            "a '-pn <int>' pulse-number flag on every line"
        )
    table["pn"] = np.asarray(table["pn"], dtype=np.int64)
    return _sorted_by_toa(table)


def expand_inputs(inputs: list[str]) -> list[str]:
    """.tim paths, or .txt list files with one .tim per line, in order."""

    def entries(item: str) -> list[str]:
        path = Path(item)
        if path.suffix.lower() != ".txt":
            return [item]
        if not path.exists():
            raise FileNotFoundError(f"list file does not exist: {item}")
        lines = (raw.strip() for raw in path.read_text().splitlines())
        return [line for line in lines if line and not line.startswith("#")]

    timfiles = [t for item in inputs for t in entries(item)]
    absent = [t for t in timfiles if not Path(t).exists()]
    if absent:
        raise FileNotFoundError("cannot merge, inputs not found: " + ", ".join(absent))
    if len(timfiles) < 2:
        raise ValueError(f"merging requires at least two .tim files (got {len(timfiles)})")
    return timfiles


def _key(table: dict) -> np.ndarray:
    return np.round(np.asarray(table["pulse_ToA"], dtype=float), TOA_ROUND_DECIMALS)


def _first_pn(keys: np.ndarray, pn: np.ndarray, shared: np.ndarray) -> dict:
    """{key: pn of the first row with that key} over the shared keys."""
    _, first = np.unique(keys, return_index=True)
    return {float(keys[i]): int(pn[i]) for i in first if keys[i] in shared}


def _concat(a: dict, b: dict) -> dict:
    """Row-wise union of two tables; a column one side lacks reads as None."""
    names = list(a) + [n for n in b if n not in a]
    out = {}
    for name in names:
        cols = [t[name] if name in t else np.full(len(t["pulse_ToA"]), None, dtype=object) for t in (a, b)]
        out[name] = np.concatenate(cols)
    return out


def _merge_pair(merged: dict, nxt: dict) -> dict:
    key_prev, key_next = _key(merged), _key(nxt)
    shared = np.intersect1d(key_prev, key_next)
    if shared.size == 0:
        raise ValueError(
            "consecutive .tim files share no ToAs (after rounding to "
            f"{TOA_ROUND_DECIMALS} decimals); cannot anchor a pulse-number shift"
        )
    anchor = float(shared.min())
    shift = int(merged["pn"][key_prev == anchor][0]) - int(nxt["pn"][key_next == anchor][0])
    shifted = select_rows(nxt, slice(None))
    shifted["pn"] = (shifted["pn"] + shift).astype(np.int64)

    # after the shift, EVERY overlapping ToA must agree on pn
    prev_map = _first_pn(key_prev, merged["pn"], shared)
    next_map = _first_pn(key_next, shifted["pn"], shared)
    mismatched = [(k, prev_map[k], next_map[k]) for k in sorted(prev_map) if prev_map[k] != next_map[k]]
    if mismatched:
        raise ValueError(
            "Overlap validation failed: overlapping TOAs have inconsistent pulse "
            f"numbers after shifting.\nFirst mismatches (ToA, pn_prev, pn_next):\n{mismatched[:10]}"
        )

    both = _concat(merged, shifted)
    keys = np.concatenate([key_prev, key_next])
    order = np.argsort(np.asarray(both["pulse_ToA"], dtype=float), kind="quicksort")
    keys = keys[order]
    _, first = np.unique(keys, return_index=True)
    out = select_rows(both, order[np.sort(first)])
    logger.info("Applied shift %+d and merged (now %d TOAs).", shift, len(out["pulse_ToA"]))
    return out


def merge_tim_files(timfiles_or_listfiles: list[str]) -> dict:
    """Merge a sequence of .tim files with consistent pulse numbering."""
    timfiles = expand_inputs(timfiles_or_listfiles)
    logger.info("Merging %d .tim files...", len(timfiles))
    merged = _load_tim(timfiles[0])
    for tf in timfiles[1:]:
        merged = _merge_pair(merged, _load_tim(tf))
    return merged


def write_merged_tim(table: dict, outprefix: str, clobber: bool = False) -> None:
    """Write the merged table through the FORMAT-1 writer, restoring the -pn
    flag column."""
    out = select_rows(table, slice(None))
    if "pn" in out and "pn_flag" in out:
        out["pn_flag"] = np.full(len(out["pn"]), "-pn", dtype=object)
    PulseToAs(out).writetimfile(outprefix, clobber=clobber)
