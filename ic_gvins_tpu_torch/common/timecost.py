"""Stopwatch and device timing (``common/timecost.py``).

``TimeCost`` is the reference's stopwatch (``common/timecost.h:29-77``) on
the host clock. ``device_time`` times a callable with the card synchronized
around each call, so the time is the work's and not its enqueue.
``trace`` wraps ``torch.profiler`` for kernel-level traces of the CPU and
the card.
"""

import contextlib
import os
import time

import torch


class TimeCost:
    """Stopwatch: construct to start, ``costms()`` to read, ``restart()``."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def restart(self) -> None:
        self._t0 = time.perf_counter()

    def costs(self) -> float:
        return time.perf_counter() - self._t0

    def costms(self) -> float:
        return self.costs() * 1e3


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def device_time(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median wall seconds per call of ``fn(*args)``, the card synchronized
    before and after each call."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the CPU and, when there is one, the card inside the block;
    writes a Chrome trace (``trace.json``) into ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
