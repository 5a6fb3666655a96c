"""Minimal column table used for loss traces (astropy.table.Table-like).

A copy of the JAX package's ``utils/table.py`` (numpy only, but
importing it through that package pulls in JAX). Named float/str
columns, ``add_row``, integer row access, column access, negative
indexing, length, and round-tripping through plain dicts.
"""

import numpy as np

__all__ = ["Table"]


class _Row(dict):
    """A single table row (dict with column access)."""


class Table:
    """Simple dict-of-lists table.

    Parameters
    ----------
    names : sequence of str
    dtype : sequence of type, optional
        Entry coercion per column (``float`` or ``str``).
    """

    def __init__(self, names=(), dtype=None):
        self.colnames = list(names)
        self._dtype = list(dtype) if dtype is not None else [float] * len(self.colnames)
        self._columns = {name: [] for name in self.colnames}

    def add_row(self, row):
        """Append a row given as a dict (missing entries become NaN)."""
        for name, dtype in zip(self.colnames, self._dtype):
            value = row.get(name, np.nan if dtype is float else "")
            self._columns[name].append(dtype(value))

    def __len__(self):
        if not self.colnames:
            return 0
        return len(self._columns[self.colnames[0]])

    def __getitem__(self, item):
        if isinstance(item, str):
            dtype = self._dtype[self.colnames.index(item)]
            return np.asarray(
                self._columns[item],
                dtype=float if dtype is float else object,
            )
        if isinstance(item, (int, np.integer)):
            index = int(item)
            return _Row(
                {name: self._columns[name][index] for name in self.colnames}
            )
        raise KeyError(item)

    def to_dict(self):
        """Columns as a plain dict of lists."""
        return {name: list(self._columns[name]) for name in self.colnames}

    @classmethod
    def from_dict(cls, data):
        """Build from a dict of columns."""
        names = list(data.keys())
        dtypes = [
            str if (len(v) and isinstance(v[0], str)) or name == "filename"
            else float
            for name, v in data.items()
        ]
        table = cls(names=names, dtype=dtypes)
        n = max((len(v) for v in data.values()), default=0)
        for i in range(n):
            # ragged columns: add_row NaN/''-fills the missing entries
            table.add_row({
                name: data[name][i]
                for name in names
                if i < len(data[name])
            })
        return table

    def __repr__(self):
        return f"Table(names={self.colnames}, n_rows={len(self)})"
