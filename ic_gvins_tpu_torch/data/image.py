"""Image files for dataset replay (``data/image.py``): a PNG decoder and
encoder of their own (the standard library's ``zlib`` and numpy; no image
library is needed or used), the Bayer-to-grey conversion of the JAX
package's numpy path, and ``load_gray``.

The decoder reads 8- and 16-bit grey, grey + alpha, RGB and RGBA images,
non-interlaced, with all five row filters. Rows filtered None, Sub or Up
are reconstructed for the whole image at once (cumulative sums modulo
256); Average and Paeth rows depend on their left neighbour's
reconstructed value through a floor or a predictor choice, so they run
byte by byte along the row.
"""

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # samples per pixel -> colour type


def _chunks(data: bytes):
    off = len(_SIGNATURE)
    while off + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[off:off + 8])
        yield kind, data[off + 8:off + 8 + n]
        off += 12 + n
        if kind == b"IEND":
            return


def _unfilter_sequential(ftype, row, prior, bpp):
    """Average (3) or Paeth (4) reconstruction of one row, byte by byte."""
    out = bytearray(row)
    n = len(out)
    if ftype == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + prior[i]) >> 1)) & 0xFF
        return out
    for i in range(n):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _unfilter(raw: np.ndarray, ftypes: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstruct the filtered rows ``raw`` [h, stride] (uint8; sums wrap
    modulo 256 as the filters define)."""
    h, stride = raw.shape
    if np.any(ftypes > 4):
        raise ValueError(f"PNG row filter {int(ftypes.max())} is not defined")
    if not ftypes.any():
        return np.ascontiguousarray(raw)
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero row above the image
    # None and Sub rows need no other row: all at once
    none = ftypes == 0
    out[1:][none] = raw[none]
    sub = ftypes == 1
    if sub.any():
        lanes = raw[sub].reshape(int(sub.sum()), stride // bpp, bpp)
        out[1:][sub] = np.cumsum(lanes, 1, dtype=np.uint8).reshape(-1, stride)
    # Up rows add the reconstructed row above: over each run of Up rows a
    # cumulative sum from the run's base row, which is a None or Sub row,
    # the zero row, or an Average / Paeth row done in order below
    up = np.concatenate([[False], ftypes == 2])
    base = np.maximum.accumulate(np.where(up, 0, np.arange(h + 1)))
    csum = np.zeros((h + 1, stride), np.uint8)
    if up.any():
        csum[up] = raw[up[1:]]
        csum = np.cumsum(csum, 0, dtype=np.uint8)

    def fill_up(lo, hi):
        """Up rows among image rows [lo, hi) (out indices lo+1 .. hi)."""
        r = np.arange(lo + 1, hi + 1)
        r = r[up[r]]
        if len(r):
            b = base[r]
            out[r] = out[b] + csum[r] - csum[b]

    lo = 0
    for k in np.nonzero(ftypes >= 3)[0]:
        fill_up(lo, k)
        out[k + 1] = np.frombuffer(
            _unfilter_sequential(int(ftypes[k]), raw[k].tobytes(), out[k].tobytes(), bpp),
            np.uint8)
        lo = k + 1
    fill_up(lo, h)
    return out[1:]


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file: [h, w] for grey, [h, w, c] otherwise; uint8 or
    (16-bit) uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_SIGNATURE)] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    ihdr, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits is not supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    img = _unfilter(raw[:, 1:], raw[:, 0], bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    return img.reshape((h, w) if ch == 1 else (h, w, ch))


def _filter_rows(x: np.ndarray, ftypes, bpp: int) -> np.ndarray:
    """Filter the image bytes ``x`` [h, stride]: row r with filter
    ftypes[r % len(ftypes)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth),
    each row prefixed with its filter byte."""
    x = x.astype(np.int64)
    a = np.zeros_like(x)  # left, up and up-left neighbours
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    f = np.resize(np.asarray(ftypes, np.int64), x.shape[0])
    rows = (x - pred[f, np.arange(x.shape[0])]) & 0xFF
    return np.concatenate([f[:, None], rows], 1).astype(np.uint8)


def write_png(path: str, img: np.ndarray, level: int = 6, filters=0) -> None:
    """Encode a uint8 or uint16 image ([h, w] grey, or [h, w, c] with c of
    2, 3 or 4 samples) as a PNG whose row r is filtered with
    ``filters[r % len(filters)]`` (an int: every row; 0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not {img.dtype}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 8 * img.dtype.itemsize
    rows = img.astype(img.dtype.newbyteorder(">")).reshape(h, -1).view(np.uint8)
    if np.all(np.asarray(filters) == 0):
        raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    else:
        raw = _filter_rows(rows, np.atleast_1d(filters), ch * depth // 8)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def bayer_to_gray(raw: np.ndarray, pattern: str = "rggb") -> np.ndarray:
    """Demosaic a single-channel Bayer mosaic to grey: each 2x2 cell's
    mean (R + 2G + B) / 4 at full resolution, the same for every pattern
    (the JAX package's path where cv2 is absent)."""
    f = raw.astype(np.float32)
    h2, w2 = (raw.shape[0] // 2) * 2, (raw.shape[1] // 2) * 2
    f = f[:h2, :w2]
    quad = 0.25 * (f[0::2, 0::2] + f[0::2, 1::2] + f[1::2, 0::2] + f[1::2, 1::2])
    up = np.repeat(np.repeat(quad, 2, axis=0), 2, axis=1)
    out = np.zeros(raw.shape, np.float32)
    out[:h2, :w2] = up
    if h2 < raw.shape[0]:
        out[h2:, :] = out[h2 - 1 : h2, :]
    if w2 < raw.shape[1]:
        out[:, w2:] = out[:, w2 - 1 : w2]
    return np.clip(out, 0, 255).astype(raw.dtype)


def load_gray(path: str, bayer: str | None = None) -> np.ndarray:
    """An image file (PNG, or a ``.npy`` array) as a 2-D grey array of its
    own sample type. ``bayer`` ("rggb", "bggr", "grbg", "gbrg") demosaics a
    single-channel mosaic; colour images become the mean of their
    channels."""
    raw = np.load(path) if os.path.splitext(path)[1].lower() == ".npy" else read_png(path)
    if bayer is not None and raw.ndim == 2:
        return bayer_to_gray(raw, bayer)
    if raw.ndim == 3:
        return raw.mean(axis=2).astype(raw.dtype)
    return raw
