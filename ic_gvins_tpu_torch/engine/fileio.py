"""Columnar result files (``engine/fileio.py``): the reference's
``fileio/`` layer (``filesaver.{h,cc}`` TEXT/BINARY writers,
``fileloader.{h,cc}`` readers, ``filebase.h`` mode constants).

Rows of doubles are streamed as whitespace text with fixed precision or as
packed little-endian float64 (``filesaver.cc:51-66``) and read back row by
row. As in the JAX package, ``FileSaver`` / ``FileLoader`` return the C++
writer and reader of the port's native library (``native/fileio.cpp``),
byte for byte the JAX package's Python writer; unlike it, they raise when
that library cannot be built instead of falling back to Python classes.
``PyFileSaver`` / ``PyFileLoader`` are those Python classes, writing and
reading the same bytes; a caller who wants them names them.
"""

import os

import numpy as np

from ..native import NativeFileLoader, NativeFileSaver

TEXT = 0
BINARY = 1


def FileSaver(path: str, columns: int, mode: int = TEXT):
    """The native columnar writer (``native.NativeFileSaver``)."""
    if mode not in (TEXT, BINARY):
        raise ValueError(f"bad mode {mode}")
    return NativeFileSaver(path, columns, mode)


def FileLoader(path: str, columns: int, mode: int = TEXT):
    """The native columnar reader (``native.NativeFileLoader``)."""
    if mode not in (TEXT, BINARY):
        raise ValueError(f"bad mode {mode}")
    return NativeFileLoader(path, columns, mode)


class PyFileSaver:
    """Row-oriented columnar writer in Python (``filesaver.cc:51-66``):
    ``dump(row)`` writes one row of ``columns`` doubles, TEXT rows
    whitespace-separated with 9 decimals, BINARY rows packed little-endian
    float64."""

    def __init__(self, path: str, columns: int, mode: int = TEXT):
        if mode not in (TEXT, BINARY):
            raise ValueError(f"bad mode {mode}")
        self.path = path
        self.columns = int(columns)
        self.mode = mode
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "w" if mode == TEXT else "wb")

    def dump(self, row) -> None:
        row = np.asarray(row, np.float64).reshape(-1)
        if row.size != self.columns:
            raise ValueError(f"row has {row.size} values, expected {self.columns}")
        if self.mode == TEXT:
            self._f.write(" ".join(f"{x:.9f}" for x in row) + "\n")
        else:
            self._f.write(row.astype("<f8").tobytes())

    def dumpn(self, rows) -> None:
        for r in rows:
            self.dump(r)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PyFileLoader:
    """Row-oriented columnar reader in Python (``fileloader.cc``):
    ``load()`` returns the next row or None at the end, ``load_all()`` an
    [n, columns] array. TEXT rows may carry ``#`` comments, which are
    skipped."""

    def __init__(self, path: str, columns: int, mode: int = TEXT):
        if mode not in (TEXT, BINARY):
            raise ValueError(f"bad mode {mode}")
        self.path = path
        self.columns = int(columns)
        self.mode = mode
        self._f = open(path, "r" if mode == TEXT else "rb")

    def load(self):
        if self.mode == TEXT:
            for line in self._f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                vals = np.array([float(x) for x in line.split()], np.float64)
                if vals.size != self.columns:
                    raise ValueError(f"{self.path}: row has {vals.size} values, "
                                     f"expected {self.columns}")
                return vals
            return None
        buf = self._f.read(8 * self.columns)
        if len(buf) < 8 * self.columns:
            return None
        return np.frombuffer(buf, "<f8").copy()

    def load_all(self) -> np.ndarray:
        rows = []
        while (r := self.load()) is not None:
            rows.append(r)
        return np.stack(rows) if rows else np.zeros((0, self.columns), np.float64)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
