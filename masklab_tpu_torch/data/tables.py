"""The ETL's tables on disk (TSV / CSV), with the stdlib ``csv`` module.

The reference writes and reads ``label_exists.tsv``, ``boxes.tsv`` and the
split CSVs with pandas (``masklab_tpu/data/process.py``,
``masklab_tpu/data/dataset.py``). The port does not need pandas, so this
module writes and reads the same files and reproduces what pandas does with
them, where that decides bytes or values:

  * floats are written as numpy's ``astype(str)`` writes them (pandas'
    ``to_csv`` does that), booleans as ``True`` / ``False``;
  * floats are read back by ``parse_float``, pandas' default C converter
    (``precise_xstrtod``), which is not correctly rounded: it accumulates up
    to 17 digits in a double and scales by a power of ten, so it differs from
    ``float()`` in the last bit of about one value in five;
  * ``sort_order`` orders rows like ``DataFrame.sort_values`` on one column
    (numpy's unstable quicksort, descending through the reversed rows).
"""
from __future__ import annotations

import csv
from typing import Dict, List, Sequence

import numpy as np

_POW10 = [float(f'1e{i}') for i in range(309)]
_MAX_DIGITS = 17


def parse_float(text: str) -> float:
    """pandas' ``precise_xstrtod`` on one field."""
    s = text.strip()
    n, p = len(s), 0
    negative = p < n and s[p] == '-'
    if p < n and s[p] in '+-':
        p += 1
    number, exponent, digits = 0.0, 0, 0
    while p < n and s[p].isdigit():
        if digits < _MAX_DIGITS:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == '.':
        p += 1
        decimals = 0
        while digits < _MAX_DIGITS and p < n and s[p].isdigit():
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
            decimals += 1
            p += 1
        while p < n and s[p].isdigit():
            p += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError(f'not a number: {text!r}')
    if negative:
        number = -number
    if p < n and s[p] in 'eE':
        p += 1
        sign = -1 if p < n and s[p] == '-' else 1
        if p < n and s[p] in '+-':
            p += 1
        e = 0
        while p < n and s[p].isdigit():
            e = e * 10 + ord(s[p]) - 48
            p += 1
        exponent += sign * e
    if p != n:
        raise ValueError(f'not a number: {text!r}')
    if exponent > 308:
        return -np.inf if negative else np.inf
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return -0.0 if negative else 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def format_column(values: Sequence) -> List[str]:
    """One column's fields as ``DataFrame.to_csv`` writes them: an all-int
    column as integers, a float column through numpy's ``astype(str)``,
    booleans as True / False, anything else by ``str``."""
    if all(isinstance(v, (bool, np.bool_)) for v in values):
        return ['True' if v else 'False' for v in values]
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
           for v in values):
        return [str(int(v)) for v in values]
    if all(isinstance(v, (int, float, np.integer, np.floating))
           for v in values):
        return list(np.asarray(values, np.float64).astype(str))
    return [str(v) for v in values]


def write_table(path: str, columns: Sequence[str], rows: Sequence[Dict],
                sep: str = '\t', header: bool = True) -> None:
    """Rows (dicts keyed by ``columns``) as pandas' ``to_csv(sep=sep,
    index=False)`` writes them."""
    fields = [format_column([r[c] for r in rows]) for c in columns]
    with open(path, 'w', newline='') as f:
        writer = csv.writer(f, delimiter=sep, lineterminator='\n')
        if header:
            writer.writerow(columns)
        writer.writerows(zip(*fields))


def read_table(path: str, sep: str = '\t') -> List[Dict[str, str]]:
    """The rows of a table with a header, as dicts of the raw fields."""
    with open(path, newline='') as f:
        return list(csv.DictReader(f, delimiter=sep))


def sort_order(keys: Sequence, ascending: bool = True) -> np.ndarray:
    """Row order of ``sort_values`` on one column of these keys (no NaN):
    ``np.argsort(kind='quicksort')``, which is not stable, on the keys as
    pandas holds them (categorical codes, or float64); descending sorts the
    reversed rows and reverses the result, as ``pandas.core.sorting.
    nargsort`` does."""
    keys = np.asarray(keys)
    index = np.arange(len(keys))
    if ascending:
        return index[keys.argsort(kind='quicksort')]
    return index[::-1][keys[::-1].argsort(kind='quicksort')][::-1]


def category_codes(values: Sequence[str], categories: Sequence[str]
                   ) -> np.ndarray:
    """pandas' codes of ``values`` in a categorical with these categories,
    in the smallest integer type that holds them."""
    lookup = {c: i for i, c in enumerate(categories)}
    n = len(categories)
    dtype = (np.int8 if n < 2 ** 7 else np.int16 if n < 2 ** 15
             else np.int32 if n < 2 ** 31 else np.int64)
    return np.asarray([lookup[v] for v in values], dtype)
