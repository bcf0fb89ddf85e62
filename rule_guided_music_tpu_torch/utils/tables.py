"""CSV tables in the layout pandas gives them, without pandas (the card has
none): the sampling CLIs' ``results.csv``/``summary.csv`` and the
evaluation CLIs' tables.

Writing follows ``DataFrame.to_csv(index=False)``: columns in the order
their keys first appear, floats as their ``repr``, NaN (or a missing key) as
an empty field, a numeric column holding any float (a gap included) written
as floats, and ``\n`` line ends. Reading follows ``read_csv``: a column whose every field parses as
an integer holds ints, one whose non-empty fields parse as numbers holds
floats (NaN where empty), any other holds strings, so list-valued cells stay
strings for ``ast.literal_eval``. :func:`mean` and :func:`std` skip NaN, as
``Series.mean``/``Series.std`` do, and ``std`` uses ddof=1 (NaN below two
values).
"""

from __future__ import annotations

import csv
import math
from typing import Dict, List, Sequence

import numpy as np

NAN = float("nan")


def is_nan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) \
        and not isinstance(v, bool)


def _column(rows: Sequence[dict], name: str) -> list:
    vals = [r.get(name, NAN) for r in rows]
    # a numeric column holding a float (NaN for a gap included) is float
    if all(_is_number(v) for v in vals) and not all(
            isinstance(v, (int, np.integer)) for v in vals):
        vals = [float(v) for v in vals]
    return ["" if is_nan(v) else v for v in vals]


def columns_of(rows: Sequence[dict]) -> List[str]:
    """The union of the rows' keys, in the order they first appear."""
    return list(dict.fromkeys(k for r in rows for k in r))


def write_table(path: str, rows: Sequence[dict], columns=None) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=False)``."""
    columns = list(columns) if columns is not None else columns_of(rows)
    cols = [_column(rows, c) for c in columns]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(zip(*cols))


def _parse(field: str, kind):
    try:
        return kind(field)
    except ValueError:
        return None


def _infer(fields: List[str]) -> list:
    if fields and all(_parse(s, int) is not None for s in fields):
        return [int(s) for s in fields]
    nums = [NAN if s == "" else _parse(s, float) for s in fields]
    if all(v is not None for v in nums):
        return nums
    return [NAN if s == "" else s for s in fields]


def read_table(path: str) -> Dict[str, list]:
    """``pd.read_csv(path)`` as {column: values}, in the file's order."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        body = list(reader)
    return {name: _infer([row[j] if j < len(row) else "" for row in body])
            for j, name in enumerate(header)}


def table_rows(table: Dict[str, list]) -> List[dict]:
    """{column: values} -> one dict per row."""
    return [dict(zip(table, vals)) for vals in zip(*table.values())]


def sort_rows(rows: Sequence[dict], keys: Sequence[str]) -> List[dict]:
    """``sort_values(by=keys)``: a stable sort, NaN last."""
    def key(r):
        return tuple((is_nan(v), 0 if is_nan(v) else v)
                     for v in (r.get(k, NAN) for k in keys))
    return sorted(rows, key=key)


def _finite(vals) -> np.ndarray:
    arr = np.asarray(vals, dtype=np.float64)
    return arr[~np.isnan(arr)]


def mean(vals) -> float:
    arr = _finite(vals)
    return float(arr.mean()) if arr.size else NAN


def std(vals) -> float:
    arr = _finite(vals)
    return float(arr.std(ddof=1)) if arr.size > 1 else NAN


def summarize_losses(rows: Sequence[dict]) -> list:
    """(Attr, Mean, Std) of each ``.loss`` column, as the JAX package's
    ``pipeline.summarize_losses`` computes them with pandas."""
    return [(col, mean([r[col] for r in rows]), std([r[col] for r in rows]))
            for col in [c for c in rows[0] if ".loss" in c]]


def write_summary(path: str, summary: list) -> None:
    """``summary.csv`` in the layout pandas' ``to_csv`` gives it: an unnamed
    index column, then Attr, Mean, Std; NaN as an empty field."""
    write_table(path, [{"": i, "Attr": col, "Mean": m, "Std": s}
                       for i, (col, m, s) in enumerate(summary)],
                columns=["", "Attr", "Mean", "Std"])


def format_table(rows: Sequence[dict], columns=None) -> str:
    """The rows as right-aligned text columns under their names, for
    printing (``DataFrame.to_string(index=False)``'s role)."""
    columns = list(columns) if columns is not None else columns_of(rows)
    cells = [[str(c) for c in columns]] + [
        ["NaN" if is_nan(v) else f"{v:.6g}" if isinstance(v, float) else str(v)
         for v in (r.get(c, NAN) for c in columns)] for r in rows]
    widths = [max(len(row[j]) for row in cells) for j in range(len(columns))]
    return "\n".join(" ".join(s.rjust(w) for s, w in zip(row, widths))
                     for row in cells)
