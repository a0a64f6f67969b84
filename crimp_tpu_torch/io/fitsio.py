"""Self-contained FITS binary-table reader/writer.

The port's own copy of ``crimp_tpu/io/fitsio.py`` (numpy only; importing
the JAX package would pull in JAX). It covers what X-ray event files need
(behavioral parity target: the astropy usage in CRIMP's eventfile.py):

- read primary + BINTABLE extension headers (keyword -> value),
- decode binary-table columns (L/X/B/I/J/K/E/D/A + fixed repeat counts)
  honoring TSCALn/TZEROn,
- append a column to a table HDU and write the whole file back out
  (used by ``addphasecolumn``).

FITS structure recap: a file is a sequence of HDUs; each HDU is an ASCII
header of 80-char cards in 2880-byte blocks terminated by END, followed by
big-endian binary data padded to 2880 bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

BLOCK = 2880
CARD = 80

# FITS TFORM letter -> (numpy dtype string, itemsize in bytes)
_TFORM_DTYPES = {
    "L": (">i1", 1),  # logical, stored as 'T'/'F' bytes
    "X": (">u1", None),  # bit array: repeat = number of BITS
    "B": (">u1", 1),
    "I": (">i2", 2),
    "J": (">i4", 4),
    "K": (">i8", 8),
    "E": (">f4", 4),
    "D": (">f8", 8),
    "C": (">c8", 8),
    "M": (">c16", 16),
    "A": ("S", 1),  # character
}


def _parse_tform(tform: str) -> tuple[int, str]:
    """Parse a TFORM value like '1D', '8X', '32A' into (repeat, code)."""
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    if code == "P" or code == "Q":
        raise NotImplementedError("variable-length FITS arrays are not supported")
    return repeat, code


def _tform_nbytes(tform: str) -> int:
    repeat, code = _parse_tform(tform)
    if code == "X":
        return (repeat + 7) // 8
    if code == "A":
        return repeat
    return repeat * _TFORM_DTYPES[code][1]


def _parse_card(card: str) -> tuple[str, object, str] | None:
    """Parse one 80-char header card into (keyword, value, comment)."""
    keyword = card[:8].strip()
    if not keyword or keyword in ("COMMENT", "HISTORY", "END"):
        return None
    if card[8:10] != "= ":
        return None
    body = card[10:]
    comment = ""
    if body.lstrip().startswith("'"):
        # String value: ends at first single quote not doubled.
        s = body.lstrip()
        out, i = [], 1
        while i < len(s):
            if s[i] == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(s[i])
            i += 1
        value: object = "".join(out).rstrip()
        rest = s[i + 1 :]
        if "/" in rest:
            comment = rest.split("/", 1)[1].strip()
    else:
        if "/" in body:
            raw, comment = body.split("/", 1)
            comment = comment.strip()
        else:
            raw = body
        raw = raw.strip()
        if raw in ("T", "F"):
            value = raw == "T"
        elif raw == "":
            value = None
        else:
            try:
                value = int(raw)
            except ValueError:
                try:
                    value = float(raw.replace("D", "E").replace("d", "e"))
                except ValueError:
                    value = raw
    return keyword, value, comment


@dataclass
class HDU:
    """One FITS header-data unit: parsed header, raw cards, and data.

    Data access is lazy: ``_raw`` is a zero-copy view into the mmap'd file;
    the structured-table view and per-column decoding happen on demand so
    opening a multi-GB event file costs only the header walk."""

    header: dict = field(default_factory=dict)
    cards: list = field(default_factory=list)  # raw 80-char cards in file order
    _raw: memoryview | bytes | None = None  # raw data block (any HDU type)
    _table: np.ndarray | None = None  # materialized structured table (BINTABLE)
    _decoded: dict = field(default_factory=dict)  # column cache

    @property
    def name(self) -> str:
        return str(self.header.get("EXTNAME", "")).strip()

    @property
    def is_table(self) -> bool:
        return str(self.header.get("XTENSION", "")).strip() == "BINTABLE"

    @property
    def data(self) -> np.ndarray | None:
        """Structured-array view of a BINTABLE (lazy, zero-copy until written)."""
        if self._table is None and self.is_table and self._raw is not None:
            dtype = _table_dtype(self.header)
            nrows = int(self.header["NAXIS2"])
            self._table = np.frombuffer(
                self._raw, dtype=dtype, count=nrows
            )
        return self._table

    @data.setter
    def data(self, value: np.ndarray | None) -> None:
        self._table = value
        self._decoded = {}

    def column(self, name: str) -> np.ndarray:
        """Decoded (TSCAL/TZERO-applied) column by name (case-insensitive)."""
        table = self.data
        if table is None:
            raise KeyError(f"HDU {self.name!r} has no table data")
        for i in range(1, int(self.header["TFIELDS"]) + 1):
            ttype = str(self.header.get(f"TTYPE{i}", f"COL{i}")).strip()
            if ttype.upper() == name.upper():
                if ttype not in self._decoded:
                    self._decoded[ttype] = _decode_column(self.header, table, i, ttype)
                return self._decoded[ttype]
        raise KeyError(f"column {name!r} not in table {self.name!r}")

    @property
    def columns(self) -> dict:
        """All decoded columns (materializes everything; prefer column())."""
        if self.data is not None:
            for i in range(1, int(self.header["TFIELDS"]) + 1):
                ttype = str(self.header.get(f"TTYPE{i}", f"COL{i}")).strip()
                if ttype not in self._decoded:
                    self._decoded[ttype] = _decode_column(self.header, self.data, i, ttype)
        return self._decoded


class FITSFile:
    """A parsed FITS file: primary HDU + extensions, addressable by EXTNAME."""

    def __init__(self, hdus: list[HDU]):
        self.hdus = hdus

    def __getitem__(self, key: str | int) -> HDU:
        if isinstance(key, int):
            return self.hdus[key]
        for hdu in self.hdus:
            if hdu.name.upper() == key.upper():
                return hdu
        raise KeyError(f"no HDU named {key!r}")

    def __contains__(self, key: str) -> bool:
        try:
            self[key]
            return True
        except KeyError:
            return False


def _read_header(buf, pos: int) -> tuple[dict, list, int]:
    header: dict = {}
    cards: list = []
    done = False
    while not done:
        block = bytes(buf[pos : pos + BLOCK])
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        pos += BLOCK
        for i in range(0, BLOCK, CARD):
            card = block[i : i + CARD].decode("ascii", "replace")
            if card.startswith("END") and card[3:].strip() == "":
                done = True
                break
            parsed = _parse_card(card)
            cards.append(card)
            if parsed:
                keyword, value, _ = parsed
                header[keyword] = value
    return header, cards, pos


def _table_dtype(header: dict) -> np.dtype:
    nfields = int(header["TFIELDS"])
    fields = []
    for i in range(1, nfields + 1):
        name = str(header.get(f"TTYPE{i}", f"COL{i}")).strip()
        tform = str(header[f"TFORM{i}"]).strip()
        repeat, code = _parse_tform(tform)
        if code == "X":
            nbytes = (repeat + 7) // 8
            fields.append((name, ">u1", (nbytes,)) if nbytes > 1 else (name, ">u1"))
        elif code == "A":
            fields.append((name, f"S{repeat}"))
        else:
            base = _TFORM_DTYPES[code][0]
            fields.append((name, base, (repeat,)) if repeat > 1 else (name, base))
    return np.dtype(fields)


def _decode_column(header: dict, table: np.ndarray, index: int, name: str) -> np.ndarray:
    """Decode one column: native-endian copy with TSCAL/TZERO applied."""
    arr = np.asarray(table[name])
    if arr.dtype.kind in "iufc":
        arr = arr.astype(arr.dtype.newbyteorder("="))
    tscal = header.get(f"TSCAL{index}")
    tzero = header.get(f"TZERO{index}")
    if tscal is not None or tzero is not None:
        scale = float(tscal) if tscal is not None else 1.0
        zero = float(tzero) if tzero is not None else 0.0
        # Unsigned-int convention (TZERO=2^(bits-1), TSCAL=1) keeps ints.
        if scale == 1.0 and zero == float(int(zero)) and arr.dtype.kind == "i":
            arr = arr.astype(np.int64) + int(zero)
        else:
            arr = arr.astype(np.float64) * scale + zero
    return arr


def read_fits(path: str) -> FITSFile:
    """Parse a FITS file into lazily-decoded HDUs (mmap-backed: opening a
    multi-GB file costs only the header walk)."""
    import mmap

    with open(path, "rb") as fh:
        try:
            buf = memoryview(mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ))
        except (ValueError, OSError):  # empty file / mmap-hostile fs
            buf = memoryview(fh.read())
    hdus: list[HDU] = []
    pos = 0
    while pos < len(buf):
        header, cards, pos = _read_header(buf, pos)
        hdu = HDU(header=header, cards=cards)
        naxis = int(header.get("NAXIS", 0) or 0)
        if naxis > 0:
            bitpix = abs(int(header.get("BITPIX", 8)))
            nbytes = bitpix // 8
            for ax in range(1, naxis + 1):
                nbytes *= int(header.get(f"NAXIS{ax}", 0) or 0)
            nbytes += int(header.get("PCOUNT", 0) or 0)
            # Raw block kept for EVERY HDU type so write_fits round-trips
            # image extensions and primary arrays untouched.
            hdu._raw = buf[pos : pos + nbytes]
            pos += (nbytes + BLOCK - 1) // BLOCK * BLOCK
        hdus.append(hdu)
    return FITSFile(hdus)


# ---------------------------------------------------------------------------
# Writing: append a column to a BINTABLE HDU and serialize the file back.
# ---------------------------------------------------------------------------


def _format_card(keyword: str, value, comment: str = "") -> str:
    if isinstance(value, bool):
        body = f"{'T' if value else 'F':>20}"
    elif isinstance(value, (int, np.integer)):
        body = f"{int(value):>20}"
    elif isinstance(value, (float, np.floating)):
        body = f"{float(value):>20.14G}"
    else:
        text = str(value).replace("'", "''")
        body = f"'{text:<8}'"
    card = f"{keyword:<8}= {body}"
    if comment:
        card += f" / {comment}"
    return card[:CARD].ljust(CARD)


def _pad_block(data: bytes, fill: bytes = b"\x00") -> bytes:
    rem = len(data) % BLOCK
    if rem:
        data += fill * (BLOCK - rem)
    return data


def _serialize_header(cards: list[str]) -> bytes:
    text = "".join(card.ljust(CARD)[:CARD] for card in cards) + "END".ljust(CARD)
    return _pad_block(text.encode("ascii"), b" ")


def write_fits(path: str, fits: FITSFile) -> None:
    """Serialize a FITSFile: modified tables are re-encoded; every other
    HDU's data block (image extensions, primary arrays) is copied verbatim."""
    out = bytearray()
    for hdu in fits.hdus:
        out += _serialize_header(hdu.cards)
        if hdu._table is not None:
            out += _pad_block(hdu._table.tobytes())
        elif hdu._raw is not None:
            out += _pad_block(bytes(hdu._raw))
    with open(path, "wb") as fh:
        fh.write(bytes(out))


def add_table_column(hdu: HDU, name: str, values: np.ndarray, tform: str = "D") -> None:
    """Append a column to a BINTABLE HDU in place (data + header cards)."""
    if hdu.data is None:
        raise ValueError("HDU has no table data")
    old_dtype = hdu.data.dtype
    if name in old_dtype.names:
        raise ValueError(f"column {name!r} already exists")
    repeat, code = _parse_tform(tform)
    if repeat != 1:
        raise NotImplementedError("add_table_column supports scalar columns only")
    base = _TFORM_DTYPES[code][0]
    new_fields = [(n, old_dtype[n]) for n in old_dtype.names]
    new_fields.append((name, np.dtype(base)))
    new_dtype = np.dtype(new_fields)
    new_data = np.empty(len(hdu.data), dtype=new_dtype)
    for n in old_dtype.names:
        new_data[n] = hdu.data[n]
    new_data[name] = np.asarray(values)
    hdu.data = new_data

    nfields = int(hdu.header["TFIELDS"]) + 1
    naxis1 = new_dtype.itemsize
    hdu.header["TFIELDS"] = nfields
    hdu.header["NAXIS1"] = naxis1
    hdu.header[f"TTYPE{nfields}"] = name
    hdu.header[f"TFORM{nfields}"] = tform
    hdu._decoded[name] = np.asarray(values)

    # Rewrite the affected cards; append the new TTYPE/TFORM before END.
    new_cards = []
    for card in hdu.cards:
        keyword = card[:8].strip()
        if keyword == "TFIELDS":
            new_cards.append(_format_card("TFIELDS", nfields))
        elif keyword == "NAXIS1":
            new_cards.append(_format_card("NAXIS1", naxis1))
        else:
            new_cards.append(card)
    new_cards.append(_format_card(f"TTYPE{nfields}", name))
    new_cards.append(_format_card(f"TFORM{nfields}", tform))
    hdu.cards = new_cards
