"""The pipeline's CSV files without pandas: columns are a dict of numpy arrays.

``write_csv`` writes the bytes that pandas' ``DataFrame.to_csv(index=False)``
writes for the pipeline's frames: a header line, ``\\n`` line ends, fields
quoted only where they hold a comma, a quote or a line break (the csv
module's minimal quoting, which pandas uses), integers as ``str``, floats as
numpy's shortest round-trip text (``11533.0``, ``1e+16``), NaN and None as an
empty field.

``read_csv`` gives each column the dtype ``pandas.read_csv`` infers for these
files: all fields integers (as numpy parses them) -> int64; integers or
floats with empty fields -> float64 with NaN (so an integer column with a gap
reads back as float64 and is written as ``11533.0`` after the next stage
boundary); anything else -> a numpy string array (an empty field stays "").
Booleans, dates and other pandas inferences are not made: the pipeline's
files have none.

``roundtrip`` is a stage boundary: the columns written and read back.
"""

from __future__ import annotations

import csv
import io
from pathlib import Path

import numpy as np


def _field_text(values) -> list[str]:
    """One column as the text of its fields, as pandas writes them."""
    a = np.asarray(values)
    if a.dtype.kind in "iub":
        return a.astype(str).tolist()
    if a.dtype.kind == "f":
        text = a.astype(str)
        text[np.isnan(a)] = ""
        return text.tolist()
    if a.dtype.kind == "U":
        return a.tolist()
    return ["" if v is None or (isinstance(v, float) and v != v) else str(v) for v in a.tolist()]


def write_csv(columns: dict, path_or_file) -> None:
    """Write `columns` (name -> array, all of one length) in their order."""
    names = list(columns)
    texts = [_field_text(columns[name]) for name in names]
    if len({len(t) for t in texts}) > 1:
        raise ValueError(f"columns of different lengths: {[len(t) for t in texts]}")

    def write(f) -> None:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(names)
        writer.writerows(zip(*texts))

    if isinstance(path_or_file, (str, Path)):
        Path(path_or_file).parent.mkdir(parents=True, exist_ok=True)
        with open(path_or_file, "w", newline="") as f:
            write(f)
    else:
        write(path_or_file)


def _infer(fields: tuple) -> np.ndarray:
    """A column's fields as int64, float64 (empty = NaN) or strings."""
    text = np.array(fields, dtype=str) if fields else np.zeros(0, str)
    empty = text == ""
    filled = text[~empty]
    try:
        values = filled.astype(np.int64)
    except (ValueError, OverflowError):
        try:
            values = filled.astype(np.float64)
        except ValueError:
            return text
    else:
        if not empty.any():
            return values
    out = np.full(len(text), np.nan)
    out[~empty] = values
    return out


def read_csv(path_or_file, usecols=None, names=None) -> dict:
    """The columns of a CSV with a header line (those named in `usecols`, in
    the file's order), each with the dtype pandas would infer (module doc).
    With `names` the file has no header line and its columns take these
    names (pandas' ``header=None, names=...``)."""
    if isinstance(path_or_file, (str, Path)):
        with open(path_or_file, newline="") as f:
            return read_csv(f, usecols, names)
    reader = csv.reader(path_or_file)
    header = list(names) if names is not None else next(reader)
    keep = [i for i, name in enumerate(header) if usecols is None or name in usecols]
    if usecols is not None and len(keep) != len(set(usecols)):
        raise ValueError(f"columns {sorted(set(usecols) - set(header))} not in the file")
    rows = list(reader)
    columns = list(zip(*rows)) if rows else [()] * len(header)
    return {header[i]: _infer(columns[i]) for i in keep}


def roundtrip(columns: dict) -> dict:
    """The columns as the next stage of the pipeline reads them from the file
    this one wrote."""
    buf = io.StringIO()
    write_csv(columns, buf)
    buf.seek(0)
    return read_csv(buf)
