"""The vendored-CSV column reader (utils/dataio.py)."""
import numpy as np

from sequential_monte_carlo_tpu.utils.dataio import read_csv_column


def test_read_csv_column(tmp_path):
    """Header skipped, blank lines skipped, bad cells read as NaN, and the
    vendored PCE series loads as 241 finite float64 values."""
    p = tmp_path / "series.csv"
    p.write_text("date,value\n2000-01-01,1.5\n\n2000-04-01,x\n2000-07-01,-2\n")
    col = read_csv_column(str(p), 1)
    assert col.dtype == np.float64
    np.testing.assert_array_equal(col[[0, 2]], [1.5, -2.0])
    assert np.isnan(col[1]) and col.shape == (3,)

    from pathlib import Path

    pce = Path(__file__).resolve().parent.parent / "examples" / "data" / "pce_inflation.csv"
    series = read_csv_column(str(pce), 1)
    assert series.shape == (241,) and np.isfinite(series).all()
