"""Columnar result files (``engine/fileio.py``): the reference's
``fileio/`` layer (``filesaver.{h,cc}`` TEXT/BINARY writers,
``fileloader.{h,cc}`` readers, ``filebase.h`` mode constants).

Rows of doubles are streamed as whitespace text with fixed precision or as
packed little-endian float64 (``filesaver.cc:51-66``) and read back row by
row. As in the JAX package, ``FileSaver`` / ``FileLoader`` return the C++
writer and reader of the port's native library (``native/fileio.cpp``),
byte for byte the JAX package's Python writer; unlike it, they raise when
that library cannot be built instead of falling back to Python classes.
"""

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
