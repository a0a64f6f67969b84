"""tempo2/PINT FORMAT-1 ``.tim`` ToA files (read/write), without pandas.

Port of ``crimp_tpu/io/tim.py``. The first line is ``FORMAT 1``; each data
line is ``template frequency toa_mjd toa_err_us site [-flag value ...]``
with one leading space, ``C`` comments, and trailing flag pairs (``-i``,
``-pn``). Tables are dicts of numpy columns: ``frequency``, ``pulse_ToA``
and ``pulse_ToA_err`` are numeric (int64 when every cell is an integer),
``pn`` is int64; a flag a line lacks reads as None. ``PulseToAs`` wraps
such a table for time filtering, reset and writing.
"""

from __future__ import annotations

import numpy as np

FIXED_COLUMNS = ["template", "frequency", "pulse_ToA", "pulse_ToA_err", "time_ref"]
_FLOAT_COLUMNS = ["frequency", "pulse_ToA", "pulse_ToA_err"]


def _numeric(tokens: list) -> np.ndarray:
    """int64 when every cell is an integer literal (as pandas' to_numeric
    keeps it), else float64 with NaN for cells that do not parse."""
    try:
        return np.asarray([int(v) for v in tokens], dtype=np.int64)
    except (TypeError, ValueError):
        pass
    out = np.full(len(tokens), np.nan)
    for i, v in enumerate(tokens):
        try:
            out[i] = float(v)
        except (TypeError, ValueError):
            pass
    return out


def read_tim(path: str, comment: str = "C", skiprows: int = 1) -> dict:
    """Read a .tim file into ``{column: array}`` with fixed + flag columns."""
    records = []
    with open(path, "r") as fh:
        for i, raw in enumerate(fh):
            if i < skiprows:
                continue
            line = raw.strip()
            if not line or line.startswith(comment):
                continue
            tokens = line.split()
            rec = dict(zip(FIXED_COLUMNS, tokens[:5]))
            extras = tokens[5:]
            j = 0
            while j < len(extras):
                tok = extras[j]
                if tok.startswith("-"):
                    key = tok.lstrip("-")
                    rec[f"{key}_flag"] = tok
                    rec[key] = extras[j + 1] if j + 1 < len(extras) else None
                    j += 2
                else:
                    j += 1
            records.append(rec)
    names: list[str] = []
    for rec in records:
        names.extend(k for k in rec if k not in names)
    table = {}
    for name in names:
        values = [rec.get(name) for rec in records]
        if name in _FLOAT_COLUMNS:
            table[name] = _numeric(values)
        elif name == "pn":
            table[name] = np.asarray([int(v) for v in values], dtype=np.int64)
        else:
            table[name] = np.asarray(values, dtype=object)
    return table


def write_tim(path_stem: str, table: dict, clobber: bool = False) -> str:
    """Write a column table as ``<path_stem>.tim`` (FORMAT 1), columns in
    the table's order; None and NaN cells are skipped like the reference."""
    path = path_stem + ".tim"
    mode = "w" if clobber else "x"
    columns = [np.asarray(col).tolist() for col in table.values()]
    with open(path, mode) as fh:
        fh.write("FORMAT 1\n")
        for row in zip(*columns):
            fields = [str(v) for v in row if v is not None and v == v]
            fh.write(" " + " ".join(fields) + "\n")
    return path


def select_rows(table: dict, rows) -> dict:
    """A new table of copies of the given rows (mask, indices or a slice)."""
    return {name: np.array(np.asarray(col)[rows]) for name, col in table.items()}


class PulseToAs:
    """Column-table wrapper for .tim content: reset / time filter / write."""

    def __init__(self, pulsetoas: dict):
        self._original = select_rows(pulsetoas, slice(None))
        self.df = select_rows(pulsetoas, slice(None))

    def reset(self) -> "PulseToAs":
        self.df = select_rows(self._original, slice(None))
        return self

    def time_filter(
        self,
        t_start: float | None = None,
        t_end: float | None = None,
        inplace: bool = True,
    ):
        lo = -np.inf if t_start is None else t_start
        hi = np.inf if t_end is None else t_end
        toa = np.asarray(self.df["pulse_ToA"], dtype=float)
        filtered = select_rows(self.df, (toa >= lo) & (toa <= hi))
        if inplace:
            self.df = filtered
            return self
        return filtered

    def writetimfile(self, timfilename: str, clobber: bool = False) -> None:
        write_tim(timfilename, self.df, clobber=clobber)


# Reference-named alias.
readtimfile = read_tim
