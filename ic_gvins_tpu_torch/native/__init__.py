"""The native (C++) host library (``native/``): the IMU buffer, the
columnar file writer and reader, and the numeric table parser, bound
through ctypes.

The sources beside this file are the JAX package's
(``imu_buffer.cpp``, ``fileio.cpp``, ``csv.cpp``). ``load`` compiles them at
first use with the JAX package's flags, ``g++ -O3 -fPIC -shared
-std=c++17`` (no ``-march=native``, no ``-ffast-math``: on x86-64 these
flags contract no multiply-add, so a slice is bit-equal to the JAX
library's on any host), into ``build/torch_ext/`` beside the package,
under a name keyed on the sources and flags. Nothing falls back: when the
library cannot be built, ``load`` raises and so does every class here.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCES = ("imu_buffer.cpp", "fileio.cpp", "csv.cpp")
BUILD_DIR = _DIR.parent.parent / "build" / "torch_ext"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lib = None

_dp = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_int64)
# (name, restype, argtypes) of every function of the C API
_API = (
    ("imu_buffer_create", ctypes.c_void_p, [ctypes.c_double]),
    ("imu_buffer_destroy", None, [ctypes.c_void_p]),
    ("imu_buffer_size", ctypes.c_int64, [ctypes.c_void_p]),
    ("imu_buffer_append", ctypes.c_int64,
     [ctypes.c_void_p, ctypes.c_double, ctypes.c_double, _dp, _dp]),
    ("imu_buffer_drop_before", None, [ctypes.c_void_p, ctypes.c_double]),
    ("imu_buffer_last_time", ctypes.c_double, [ctypes.c_void_p]),
    ("imu_buffer_export", ctypes.c_int64,
     [ctypes.c_void_p, ctypes.c_int64, _dp, _dp, _dp, _dp]),
    ("imu_buffer_slice", ctypes.c_int64,
     [ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_int64, ctypes.c_double,
      _dp, _dp, _dp, _dp]),
    ("filesaver_create", ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]),
    ("filesaver_dumpn", ctypes.c_int64, [ctypes.c_void_p, _dp, ctypes.c_int64]),
    ("filesaver_flush", ctypes.c_int, [ctypes.c_void_p]),
    ("filesaver_close", None, [ctypes.c_void_p]),
    ("fileloader_open", ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]),
    ("fileloader_read", ctypes.c_int64, [ctypes.c_void_p, _dp, ctypes.c_int64]),
    ("fileloader_close", None, [ctypes.c_void_p]),
    ("csv_scan", ctypes.c_int, [ctypes.c_char_p, _i64p, _i64p]),
    ("csv_load", ctypes.c_int64, [ctypes.c_char_p, _dp, ctypes.c_int64, ctypes.c_int64]),
)


def library_path() -> Path:
    """Where the library of these sources and flags is (or will be) built."""
    key = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        key.update((_DIR / name).read_bytes())
    return BUILD_DIR / f"libicgvins_native_{key.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the library when ``force`` is set, or when the library of
    this source and flag set is absent or older than a source."""
    so = library_path()
    if not force and so.exists() and all(
            so.stat().st_mtime >= (_DIR / name).stat().st_mtime for name in SOURCES):
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, *(str(_DIR / s) for s in SOURCES), "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed building the native library:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def load():
    """Build (once per source and flag set) and load the library; raises
    when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    for name, restype, argtypes in _API:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _lib = lib
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_dp)


class NativeImuBuffer:
    """The C++ IMU buffer: appends with gap filling at the nominal rate,
    drops old samples, exports them, and cuts interpolated slices."""

    def __init__(self, nominal_dt: float = 0.005):
        self._lib = load()
        self._h = self._lib.imu_buffer_create(nominal_dt)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.imu_buffer_destroy(self._h)
            self._h = None

    def append(self, t, dt, dtheta, dvel) -> int:
        """Store one sample; returns how many samples were stored (more than
        one when a gap in the stamps was filled first)."""
        dth = np.ascontiguousarray(dtheta, np.float64).reshape(3)
        dv = np.ascontiguousarray(dvel, np.float64).reshape(3)
        return self._lib.imu_buffer_append(self._h, float(t), float(dt), _ptr(dth), _ptr(dv))

    def drop_before(self, t):
        self._lib.imu_buffer_drop_before(self._h, float(t))

    def export_arrays(self):
        """(time [n], dt [n], dtheta [n,3], dvel [n,3]) of every stored sample."""
        n = len(self)
        time, dt = np.empty(n), np.empty(n)
        dtheta, dvel = np.empty((n, 3)), np.empty((n, 3))
        got = self._lib.imu_buffer_export(self._h, n, _ptr(time), _ptr(dt), _ptr(dtheta),
                                          _ptr(dvel))
        if got != n:
            raise RuntimeError(f"IMU buffer exported {got} of {n} samples")
        return time, dt, dtheta, dvel

    @property
    def last_time(self) -> float:
        return self._lib.imu_buffer_last_time(self._h)

    def __len__(self):
        return int(self._lib.imu_buffer_size(self._h))

    def slice_between(self, t0, t1, n_pad, min_dt=1e-4):
        """(time [n_pad], dt [n_pad], dtheta [n_pad,3], dvel [n_pad,3]) of the
        series covering (t0, t1], zero-padded, and the number of real
        samples (the leading seed included); raises past ``n_pad``."""
        time, dt = np.empty(n_pad), np.empty(n_pad)
        dtheta, dvel = np.empty((n_pad, 3)), np.empty((n_pad, 3))
        n = self._lib.imu_buffer_slice(self._h, float(t0), float(t1), n_pad, float(min_dt),
                                       _ptr(time), _ptr(dt), _ptr(dtheta), _ptr(dvel))
        if n < 0:
            raise ValueError(f"IMU slice exceeds capacity {n_pad}")
        return time, dt, dtheta, dvel, int(n)


class NativeFileSaver:
    """The C++ columnar writer (``fileio.cpp``), byte for byte the JAX
    package's Python ``PyFileSaver`` (``filesaver.cc:51-66``)."""

    def __init__(self, path: str, columns: int, mode: int = 0):
        self._lib = load()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path, self.columns, self.mode = path, int(columns), mode
        self._h = self._lib.filesaver_create(path.encode(), self.columns, int(mode))
        if not self._h:
            raise OSError(f"cannot open {path}")

    def dump(self, row) -> None:
        row = np.asarray(row, np.float64).reshape(-1)
        if row.size != self.columns:
            raise ValueError(f"row has {row.size} values, expected {self.columns}")
        self.dumpn(row.reshape(1, -1))

    def dumpn(self, rows) -> None:
        rows = np.ascontiguousarray(rows, np.float64).reshape(-1, self.columns)
        n = self._lib.filesaver_dumpn(self._h, _ptr(rows), rows.shape[0])
        if n != rows.shape[0]:
            raise OSError(f"short write to {self.path}")

    def flush(self) -> None:
        self._lib.filesaver_flush(self._h)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.filesaver_close(self._h)
            self._h = None

    __del__ = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeFileLoader:
    """The C++ columnar reader (``fileio.cpp``)."""

    _CHUNK = 4096

    def __init__(self, path: str, columns: int, mode: int = 0):
        self._lib = load()
        self.path, self.columns, self.mode = path, int(columns), mode
        self._h = self._lib.fileloader_open(path.encode(), self.columns, int(mode))
        if not self._h:
            raise OSError(f"cannot open {path}")
        self._buf = np.zeros((0, self.columns))
        self._pos = 0

    def _refill(self) -> bool:
        out = np.empty((self._CHUNK, self.columns))
        n = self._lib.fileloader_read(self._h, _ptr(out), self._CHUNK)
        if n < 0:
            raise ValueError(f"{self.path}: malformed row")
        self._buf, self._pos = out[:n], 0
        return n > 0

    def load(self):
        """The next row, or None at the end of the file."""
        if self._pos >= len(self._buf) and not self._refill():
            return None
        row = self._buf[self._pos].copy()
        self._pos += 1
        return row

    def load_all(self) -> np.ndarray:
        chunks = [self._buf[self._pos:]]
        while self._refill():
            chunks.append(self._buf)
        self._buf = np.zeros((0, self.columns))
        self._pos = 0
        return np.concatenate(chunks, axis=0)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.fileloader_close(self._h)
            self._h = None

    __del__ = close

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_numeric_table(path: str) -> np.ndarray | None:
    """A numeric CSV or whitespace table parsed by ``csv.cpp`` ([rows,
    cols] float64), or None for a ragged table (or one that changed while
    it was read), which the caller hands to numpy so that numpy raises its
    usual error. Raises when the file cannot be read or the library cannot
    be built."""
    lib = load()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.csv_scan(path.encode(), ctypes.byref(rows), ctypes.byref(cols))
    if rc == -1:
        raise OSError(f"cannot read {path}")
    if rc != 0:
        return None
    out = np.empty((rows.value, cols.value))
    n = lib.csv_load(path.encode(), _ptr(out), rows.value, cols.value)
    return out if n == rows.value else None
