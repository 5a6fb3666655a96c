"""Minimal FITS reader and writer in numpy (a copy of the JAX package's
``utils/io/minifits.py``).

astropy is not a dependency, so the FITS layer (``utils/io/fits.py``)
rests on this implementation of the FITS subset the package's files use:

- primary and IMAGE extensions (integer and float images of any rank;
  dtypes without a native BITPIX widen without loss: bool, int8,
  uint16/32/64, float16),
- BINTABLE extensions with logical, integer, float and string columns,
- standard 80-character header cards in 2880-byte blocks, big-endian data,
- OGIP 1.0 CONTINUE long-string cards (read and write),
- BSCALE/BZERO scaling on read, including the standard unsigned-integer
  BZERO patterns astropy and cfitsio write.

Files written here conform to the standard and read in astropy and
cfitsio; reading supports the same subset.
"""

import logging
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

BLOCK = 2880
CARD = 80

__all__ = [
    "Header",
    "ImageHDU",
    "BinTableHDU",
    "write_hdulist",
    "read_hdulist",
]


class Header(dict):
    """Ordered FITS header keywords (a dict with FITS value rules)."""


def _format_value(value):
    if isinstance(value, (bool, np.bool_)):
        return ("T" if value else "F").rjust(20)
    if isinstance(value, (int, np.integer)):
        return str(int(value)).rjust(20)
    if isinstance(value, (float, np.floating)):
        text = repr(float(value))
        return text.rjust(20)
    # string
    text = str(value).replace("'", "''")
    return f"'{text:<8s}'"


# a string card is "KEY     = '...'": 8 key + "= " + 2 quotes leaves
# 68 chars of escaped text; keep 2 in reserve for the '&' continuation
# marker and the final escape possibly being 2 chars wide
_STR_CHUNK = 66


def _escaped_chunks(text):
    """Split ``text`` into chunks whose quote-escaped form fits a card."""
    chunks, current, width = [], [], 0
    for char in text:
        piece = "''" if char == "'" else char
        if width + len(piece) > _STR_CHUNK:
            chunks.append("".join(current))
            current, width = [], 0
        current.append(piece)
        width += len(piece)
    chunks.append("".join(current))
    return chunks


def _format_card(key, value, comment=None):
    """Format one 80-char card — or, for string values too long for a
    single card, a concatenation of 80-char pieces using the OGIP 1.0
    long-string convention (``'...&'`` + ``CONTINUE`` cards, the same
    one astropy emits), so values are never silently truncated."""
    if isinstance(value, str) and len(value.replace("'", "''")) > 68:
        chunks = _escaped_chunks(value)
        pieces = []
        for i, chunk in enumerate(chunks):
            marker = "&" if i + 1 < len(chunks) else ""
            body = f"'{chunk}{marker}'"
            if i == 0:
                piece = f"{key.upper():<8s}= {body}"
            else:
                piece = f"CONTINUE  {body}"
            pieces.append(piece[:CARD].ljust(CARD))
        return "".join(pieces)
    card = f"{key.upper():<8s}= {_format_value(value)}"
    if comment:
        card += f" / {comment}"
    return card[:CARD].ljust(CARD)


def _parse_value(text):
    text = text.strip()
    if text.startswith("'"):
        # string: strip quotes, unescape, rstrip padding
        inner = text[1:]
        end = inner.find("'")
        while end != -1 and end + 1 < len(inner) and inner[end + 1] == "'":
            end = inner.find("'", end + 2)
        return inner[:end].replace("''", "'").rstrip()
    if text == "T":
        return True
    if text == "F":
        return False
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        return text


def _write_header(fh, cards):
    raw = "".join(cards) + "END".ljust(CARD)
    pad = (-len(raw)) % BLOCK
    fh.write((raw + " " * pad).encode("ascii"))


def _write_data(fh, raw):
    fh.write(raw)
    pad = (-len(raw)) % BLOCK
    fh.write(b"\x00" * pad)


def _read_header(fh):
    cards = {}
    order = []
    pending = None  # key whose string value ended with '&'
    while True:
        block = fh.read(BLOCK)
        if len(block) < BLOCK:
            if not block:
                return None
            raise OSError("Truncated FITS header")
        done = False
        for i in range(0, BLOCK, CARD):
            card = block[i : i + CARD].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if key == "CONTINUE" and pending is not None:
                # OGIP 1.0 long-string continuation: "CONTINUE  '...'".
                # The pending value keeps its trailing '&' until a
                # CONTINUE actually follows, so a short string that
                # legitimately ends with '&' reads back unchanged.
                part = _parse_value(card[10:])
                cards[pending] = cards[pending][:-1]
                if isinstance(part, str) and part.endswith("&"):
                    cards[pending] += part
                else:
                    cards[pending] += str(part)
                    pending = None
                continue
            pending = None
            if not key or key in ("COMMENT", "HISTORY"):
                continue
            if card[8:10] != "= ":
                continue
            rest = card[10:]
            # strip comment (outside strings)
            if rest.lstrip().startswith("'"):
                # find closing quote then comment
                s = rest
                idx = s.find("'")
                j = idx + 1
                while j < len(s):
                    if s[j] == "'":
                        if j + 1 < len(s) and s[j + 1] == "'":
                            j += 2
                            continue
                        break
                    j += 1
                value_text = s[: j + 1]
            else:
                value_text = rest.split("/")[0]
            value = _parse_value(value_text)
            if isinstance(value, str) and value.endswith("&"):
                pending = key  # '&' stripped when a CONTINUE follows
            cards[key] = value
            if key not in order:
                order.append(key)
        if done:
            break
    header = Header()
    for key in order:
        header[key] = cards[key]
    return header


_BITPIX = {
    np.dtype(">u1"): 8,
    np.dtype(">i2"): 16,
    np.dtype(">i4"): 32,
    np.dtype(">i8"): 64,
    np.dtype(">f4"): -32,
    np.dtype(">f8"): -64,
}
_BITPIX_INV = {v: k for k, v in _BITPIX.items()}

# value-preserving promotions onto the FITS-native types above
# (astropy instead uses BZERO offsets for unsigned; a widening cast is
# equally spec-conformant and keeps the reader simple)
_BITPIX_PROMOTE = {
    np.dtype(np.bool_): ">u1",
    np.dtype(np.int8): ">i2",
    np.dtype(np.uint16): ">i4",
    np.dtype(np.uint32): ">i8",
    np.dtype(np.float16): ">f4",
}


def _be_image(data):
    """Big-endian view of ``data`` in a FITS-writable dtype."""
    dtype = data.dtype.newbyteorder(">")
    if dtype in _BITPIX:
        return data.astype(dtype)
    promoted = _BITPIX_PROMOTE.get(data.dtype.newbyteorder("="))
    if promoted is not None:
        return data.astype(promoted)
    if data.dtype == np.uint64:
        if data.size and data.max() > np.iinfo(np.int64).max:
            raise ValueError(
                "uint64 image data exceeds the FITS int64 range"
            )
        return data.astype(">i8")
    raise ValueError(
        f"dtype {data.dtype} has no FITS image representation "
        "(supported: bool, (u)int8-64, float16/32/64)"
    )


class ImageHDU:
    """Image HDU (also used for the primary HDU)."""

    def __init__(self, data=None, header=None, name=""):
        self.data = None if data is None else np.asarray(data)
        self.header = Header(header or {})
        self.name = str(name).upper()

    def _cards(self, primary):
        cards = []
        data = self.data
        if primary:
            cards.append(_format_card("SIMPLE", True, "conforms to FITS"))
        else:
            cards.append(_format_card("XTENSION", "IMAGE", "Image extension"))

        if data is None:
            cards.append(_format_card("BITPIX", 8))
            cards.append(_format_card("NAXIS", 0))
        else:
            be = _be_image(data)
            bitpix = _BITPIX[be.dtype]
            cards.append(_format_card("BITPIX", bitpix))
            cards.append(_format_card("NAXIS", data.ndim))
            for i, n in enumerate(reversed(data.shape)):
                cards.append(_format_card(f"NAXIS{i + 1}", n))
        if not primary:
            cards.append(_format_card("PCOUNT", 0))
            cards.append(_format_card("GCOUNT", 1))
        if self.name:
            cards.append(_format_card("EXTNAME", self.name))
        for key, value in self.header.items():
            cards.append(_format_card(key, value))
        return cards

    def _raw_data(self):
        if self.data is None:
            return b""
        return _be_image(self.data).tobytes()


_TFORM_DTYPES = [
    (np.dtype(np.bool_), "L"),
    (np.dtype(np.int16), "I"),
    (np.dtype(np.int32), "J"),
    (np.dtype(np.int64), "K"),
    (np.dtype(np.float32), "E"),
    (np.dtype(np.float64), "D"),
]


def _column_tform(array):
    if array.dtype.kind in "US":
        width = max(1, array.dtype.itemsize // (4 if array.dtype.kind == "U" else 1))
        return f"{width}A", np.dtype(f"S{width}")
    for dtype, code in _TFORM_DTYPES:
        if array.dtype == dtype:
            return code, dtype.newbyteorder(">")
    # fall back: floats
    return "D", np.dtype(">f8")


_TFORM_SIZES = {"L": 1, "I": 2, "J": 4, "K": 8, "E": 4, "D": 8}


class BinTableHDU:
    """Binary-table HDU built from a dict of 1-D column arrays."""

    def __init__(self, columns=None, header=None, name=""):
        self.columns = {
            key: np.asarray(value) for key, value in (columns or {}).items()
        }
        self.header = Header(header or {})
        self.name = str(name).upper()

    @classmethod
    def from_rows(cls, rows, name=""):
        """Build from a list of row dicts."""
        if not rows:
            return cls(name=name)
        keys = list(rows[0].keys())
        columns = {key: np.asarray([row[key] for row in rows]) for key in keys}
        return cls(columns=columns, name=name)

    def _layout(self):
        layout = []
        for key, array in self.columns.items():
            tform, dtype = _column_tform(array)
            layout.append((key, tform, dtype))
        return layout

    def _cards(self):
        layout = self._layout()
        n_rows = len(next(iter(self.columns.values()))) if self.columns else 0
        row_bytes = sum(
            int(tform[:-1]) if tform.endswith("A") else _TFORM_SIZES[tform]
            for _, tform, _ in layout
        )
        cards = [
            _format_card("XTENSION", "BINTABLE", "binary table extension"),
            _format_card("BITPIX", 8),
            _format_card("NAXIS", 2),
            _format_card("NAXIS1", row_bytes),
            _format_card("NAXIS2", n_rows),
            _format_card("PCOUNT", 0),
            _format_card("GCOUNT", 1),
            _format_card("TFIELDS", len(layout)),
        ]
        for i, (key, tform, _) in enumerate(layout, start=1):
            cards.append(_format_card(f"TTYPE{i}", key))
            cards.append(_format_card(f"TFORM{i}", tform))
        if self.name:
            cards.append(_format_card("EXTNAME", self.name))
        for key, value in self.header.items():
            cards.append(_format_card(key, value))
        return cards

    def _raw_data(self):
        layout = self._layout()
        if not layout:
            return b""
        n_rows = len(next(iter(self.columns.values())))
        fields = []
        for key, tform, dtype in layout:
            array = self.columns[key]
            if tform.endswith("A"):
                width = int(tform[:-1])
                converted = np.array(
                    [str(v).encode("ascii", "replace") for v in array],
                    dtype=f"S{width}",
                )
                fields.append((key, converted, np.dtype(f"S{width}")))
            elif tform == "L":
                # FITS logical columns store ASCII 'T'/'F'
                converted = np.where(
                    array.astype(bool), np.uint8(ord("T")), np.uint8(ord("F"))
                )
                fields.append((key, converted, np.dtype(">u1")))
            else:
                fields.append((key, array.astype(dtype), dtype))
        rec_dtype = np.dtype([(key, dtype) for key, _, dtype in fields])
        rec = np.zeros(n_rows, rec_dtype)
        for key, converted, _ in fields:
            rec[key] = converted
        return rec.tobytes()


def write_hdulist(hdus, filename, overwrite=False):
    """Write a list of HDUs to a FITS file (first becomes primary)."""
    path = Path(filename)
    if path.exists() and not overwrite:
        raise OSError(f"{path} already exists!")

    with path.open("wb") as fh:
        if hdus and isinstance(hdus[0], ImageHDU):
            _write_header(fh, hdus[0]._cards(primary=True))
            _write_data(fh, hdus[0]._raw_data())
            rest = hdus[1:]
        else:
            # tables can never be primary: write an empty primary first
            primary = ImageHDU()
            _write_header(fh, primary._cards(primary=True))
            rest = hdus

        for hdu in rest:
            if isinstance(hdu, BinTableHDU):
                _write_header(fh, hdu._cards())
            else:
                _write_header(fh, hdu._cards(primary=False))
            _write_data(fh, hdu._raw_data())


def _read_image_data(fh, header):
    bitpix = header.get("BITPIX", 8)
    naxis = header.get("NAXIS", 0)
    if naxis == 0:
        return None
    shape = tuple(
        header[f"NAXIS{i}"] for i in range(naxis, 0, -1)
    )
    dtype = _BITPIX_INV[bitpix]
    count = int(np.prod(shape))
    nbytes = count * dtype.itemsize
    raw = fh.read(nbytes)
    fh.read((-nbytes) % BLOCK)
    data = np.frombuffer(raw, dtype=dtype).reshape(shape).astype(
        dtype.newbyteorder("=")
    )
    # physical = BZERO + BSCALE * raw. astropy/cfitsio write unsigned
    # integers through the standard BZERO offset patterns — map those
    # back to the exact unsigned dtype; anything else scales to f64.
    bscale = header.get("BSCALE", 1)
    bzero = header.get("BZERO", 0)
    if bscale == 1 and bzero == 0:
        return data
    unsigned = {
        (8, -128): np.int8,
        (16, 32768): np.uint16,
        (32, 2**31): np.uint32,
        (64, 2**63): np.uint64,
    }.get((bitpix, bzero))
    if bscale == 1 and unsigned is not None:
        if bitpix == 64:
            # modular add in uint64: raw + 2^63 wraps to the physical
            # unsigned value exactly
            return data.astype(np.uint64) + np.uint64(bzero)
        return (data.astype(np.int64) + bzero).astype(unsigned)
    return bzero + bscale * data.astype(np.float64)


def _read_table_data(fh, header):
    n_rows = header["NAXIS2"]
    n_fields = header["TFIELDS"]
    names, dtypes = [], []
    for i in range(1, n_fields + 1):
        name = header[f"TTYPE{i}"]
        tform = str(header[f"TFORM{i}"]).strip()
        if tform.endswith("A"):
            width = int(tform[:-1] or 1)
            dtype = np.dtype(f"S{width}")
        else:
            code = tform[-1]
            repeat = tform[:-1]
            if repeat not in ("", "1"):
                raise OSError(f"Unsupported TFORM {tform}")
            dtype = {
                "L": np.dtype(">u1"),
                "I": np.dtype(">i2"),
                "J": np.dtype(">i4"),
                "K": np.dtype(">i8"),
                "E": np.dtype(">f4"),
                "D": np.dtype(">f8"),
            }[code]
        names.append(name)
        dtypes.append(dtype)

    if not names:
        # empty table (TFIELDS=0): no data block follows
        return {}

    rec_dtype = np.dtype(list(zip(names, dtypes)))
    nbytes = rec_dtype.itemsize * n_rows
    raw = fh.read(nbytes)
    fh.read((-nbytes) % BLOCK)
    rec = np.frombuffer(raw, dtype=rec_dtype)

    columns = {}
    for name, dtype in zip(names, dtypes):
        col = rec[name]
        if dtype.kind == "S":
            columns[name] = np.array(
                [v.decode("ascii").rstrip() for v in col]
            )
        elif dtype.itemsize == 1 and dtype.kind == "u":  # logical
            columns[name] = col == ord("T")
        else:
            columns[name] = col.astype(dtype.newbyteorder("="))
    return columns


def read_hdulist(filename):
    """Read all HDUs of a FITS file.

    Returns
    -------
    hdus : list of `ImageHDU` / `BinTableHDU`
    """
    hdus = []
    with Path(filename).open("rb") as fh:
        while True:
            header = _read_header(fh)
            if header is None:
                break
            name = str(header.pop("EXTNAME", "")).strip()
            xtension = str(header.pop("XTENSION", "")).strip()
            header.pop("SIMPLE", None)
            if xtension == "BINTABLE":
                columns = _read_table_data(fh, header)
                meta = Header(
                    {
                        k: v
                        for k, v in header.items()
                        if not (
                            k.startswith(("NAXIS", "TTYPE", "TFORM"))
                            or k in ("BITPIX", "PCOUNT", "GCOUNT", "TFIELDS")
                        )
                    }
                )
                hdu = BinTableHDU(columns=columns, header=meta, name=name)
            else:
                data = _read_image_data(fh, header)
                meta = Header(
                    {
                        k: v
                        for k, v in header.items()
                        if not k.startswith(("NAXIS",))
                        and k not in ("BITPIX", "PCOUNT", "GCOUNT", "EXTEND")
                    }
                )
                hdu = ImageHDU(data=data, header=meta, name=name)
            hdus.append(hdu)
    return hdus
