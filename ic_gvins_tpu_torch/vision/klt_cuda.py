"""Bidirectional pyramidal LK: the wrapper of the Hopper kernel ``csrc/klt.cu``.

Replaces the TPU kernel ``ic_gvins_tpu/vision/klt_pallas.py:_track_level_pallas``
and the functions around it, ``lk_track_pallas`` / ``lk_track_bidirectional_pallas``;
the kernel's source note says what bounds it (the latency of each
feature's serial chain of level passes and Gauss-Newton steps, not bytes
or operations) and how its design answers that: one block per feature,
the pixels staged in shared memory by asynchronous copies.

``lk_track_bidirectional`` takes the same arguments as the plain version
``klt.lk_track_bidirectional``. For CPU tensors it runs that plain
version; for CUDA tensors it launches the kernel, all levels and both
directions in one launch, or raises. The kernel is built from the
package's sources with ``nvcc`` for ``sm_90a`` at first use, into
``build/torch_ext/`` beside the package, and bound through ctypes (a plain
C interface, so the build takes seconds).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import klt

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "klt.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_ext"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_LEVELS = 8

_lib = None
build_log = ""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the KLT kernel cannot be built")
    return found


def load_library():
    """Build (once per source and flag set) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libklt_{key.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_SRC)],
                              capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {_SRC}:\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.klt_bidirectional_launch
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check_inputs(pyr0, pyr1, pts0, pts1_init, valid):
    if len(pyr0) != len(pyr1) or not 1 <= len(pyr0) <= MAX_LEVELS:
        raise ValueError(f"need two pyramids of 1..{MAX_LEVELS} equal levels")
    dev = pts0.device
    for a, b in zip(pyr0, pyr1):
        for img in (a, b):
            if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
                raise ValueError("pyramid levels must be contiguous 2-D float32")
            if img.device != dev:
                raise ValueError("pyramids and points must share one device")
            if min(img.shape) < 2:
                raise ValueError("pyramid levels must be at least 2 x 2")
        if a.shape != b.shape:
            raise ValueError("both pyramids need the same level shapes")
    n = pts0.shape[0]
    for name, x in (("pts0", pts0), ("pts1_init", pts1_init)):
        if x.dtype != torch.float32 or x.shape != (n, 2) or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [n, 2] tensor")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the points on {dev}")
    if valid.dtype != torch.bool or valid.shape != (n,) or valid.device != dev:
        raise ValueError("valid must be a bool [n] tensor on the points' device")


def _launch(pyr0, pyr1, pts0, pts1_init, valid, fb_thresh):
    """Launch the kernel on checked CUDA inputs: (pts1, ok, fb_err, work)."""
    fn = load_library().klt_bidirectional_launch
    n, levels = pts0.shape[0], len(pyr0)
    # one allocation for all outputs: n x (2 + 1) float32, n x 2 int32, n bool
    out = torch.empty(21 * n, dtype=torch.uint8, device=pts0.device)
    pts1 = out[: 8 * n].view(torch.float32).view(n, 2)
    fb = out[8 * n : 12 * n].view(torch.float32)
    work = out[12 * n : 20 * n].view(torch.int32).view(n, 2)
    ok = out[20 * n :].view(torch.bool)
    if n == 0:  # nothing to launch
        return pts1, ok, fb, work
    imgs = (ctypes.c_void_p * (2 * levels))(*[x.data_ptr() for x in (*pyr0, *pyr1)])
    shapes = (ctypes.c_int * (2 * levels))(*[d for x in pyr0 for d in x.shape])
    with torch.cuda.device(pts0.device):
        err = fn(imgs, shapes, levels, pts0.data_ptr(), pts1_init.data_ptr(),
                 valid.data_ptr(), pts1.data_ptr(), fb.data_ptr(), work.data_ptr(),
                 ok.data_ptr(), n, float(fb_thresh),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"KLT kernel launch failed: cudaError {err}")
    lk_track_bidirectional.launches += 1
    return pts1, ok, fb, work


def lk_track_bidirectional(pyr0, pyr1, pts0, pts1_init, valid, fb_thresh=0.5):
    """Forward + backward pyramidal LK with the forward-backward gate.

    pyr0/pyr1: equal-length tuples of contiguous float32 images, level 0
    first; pts0/pts1_init: contiguous float32 [n, 2] (x, y); valid: bool
    [n]. Returns (pts1 [n, 2], ok [n], fb_err [n])."""
    _check_inputs(pyr0, pyr1, pts0, pts1_init, valid)
    if pts0.device.type == "cpu":
        return klt.lk_track_bidirectional(pyr0, pyr1, pts0, pts1_init, valid,
                                          fb_thresh)
    if pts0.device.type != "cuda":
        raise ValueError(f"no KLT kernel for device {pts0.device}")
    return _launch(pyr0, pyr1, pts0, pts1_init, valid, fb_thresh)[:3]


lk_track_bidirectional.launches = 0


def lk_track_bidirectional_counted(pyr0, pyr1, pts0, pts1_init, valid, fb_thresh=0.5):
    """The kernel's results and the work it did for them: (pts1, ok, fb_err,
    work), work int32 [n, 2] = each feature's (level passes run,
    Gauss-Newton steps taken) over both directions. The passes are packed,
    4 bits per level with level 0 lowest: ``passes_per_level`` unpacks them.
    A call's roofline bound is computed from these counts. CUDA tensors
    only."""
    _check_inputs(pyr0, pyr1, pts0, pts1_init, valid)
    if pts0.device.type != "cuda":
        raise ValueError("the work counts come from the kernel: CUDA tensors only")
    return _launch(pyr0, pyr1, pts0, pts1_init, valid, fb_thresh)


def passes_per_level(work, levels):
    """Level passes of a counted call summed over its features, per level
    (level 0 first), from the packed counts in ``work[:, 0]``."""
    code = work[:, 0].cpu()
    return [int(((code >> (4 * lv)) & 15).sum()) for lv in range(levels)]
