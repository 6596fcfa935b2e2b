"""Local CSV column reader. The reference's data path is an HTTP FRED client
(examples/inflation_example.jl:12-23); the framework's reads a vendored CSV
into a contiguous float64 buffer."""
from __future__ import annotations

import csv as _csv

import numpy as np


def read_csv_column(path: str, col: int, delim: str = ",") -> np.ndarray:
    """Read one numeric column (0-indexed, header skipped) as float64.

    Blank lines are skipped; a non-numeric or missing cell reads as NaN."""
    vals = []
    with open(path) as f:
        reader = _csv.reader(f, delimiter=delim)
        next(reader, None)
        for row in reader:
            if not row:
                continue
            try:
                vals.append(float(row[col]))
            except (ValueError, IndexError):
                vals.append(float("nan"))
    return np.asarray(vals, dtype=np.float64)
