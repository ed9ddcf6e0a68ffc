"""The traced sub-window: ``torch.profiler`` over a bounded stretch of a
run, reduced in memory to what the per-layer metrics read.

Device activity is every operation the profiler saw on the card (kernels,
copies, fills; not the spans' own ranges on the device's timeline); its
union gives ``busy_s``. Launches are the runtime's
kernel-launch calls on the host. Spans are the ``gvbench::<seam>`` records
that ``harness.Seams`` opens around the program's functions.
"""

import bisect
import time

import torch
from torch.autograd import DeviceType

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")
SPAN_PREFIX = "gvbench::"


def union_length(intervals) -> float:
    """Total length covered by ``intervals`` [(start, end)], overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def count_in(points, spans) -> int:
    """How many of the sorted ``points`` lie in one of the ``spans``."""
    return sum(bisect.bisect_right(points, e) - bisect.bisect_left(points, s) for s, e in spans)


class Profile:
    """A profiler started and stopped by the driver around whole calls."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None

    def start(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize(self.device)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def reduce(self, kernel_names=()) -> dict:
        """What the readers need: the window's length, the device's busy
        time, launches and calls per span name, device time of the kernels
        named in ``kernel_names`` (by substring), the top device operations
        and the idle gaps by the host span open at their middle."""
        events = self.prof.events()
        dev, launches, spans = [], [], {}
        by_kernel = {k: 0.0 for k in kernel_names}
        ops = {}
        for e in events:
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                if e.name.startswith(SPAN_PREFIX):
                    continue  # the span's own range on the device's timeline
                dev.append((tr.start, tr.end))
                ops[e.name] = ops.get(e.name, 0.0) + (tr.end - tr.start) * 1e-6
                for k in kernel_names:
                    if k in e.name:
                        by_kernel[k] += (tr.end - tr.start) * 1e-6
            elif e.name in LAUNCH_CALLS:
                launches.append(tr.start)
            elif e.name.startswith(SPAN_PREFIX):
                spans.setdefault(e.name[len(SPAN_PREFIX):], []).append((tr.start, tr.end))
        launches.sort()
        busy_us = union_length(dev)
        window_s = self.t1 - self.t0
        # idle gaps inside the traced stretch, named by the span around them
        m = merged(dev)
        gaps = [(m[i][1], m[i + 1][0]) for i in range(len(m) - 1)]
        flat = sorted((s, e, n) for n, ss in spans.items() for s, e in ss)
        idle = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            name = "host outside the seams"
            for a, b, n in flat:
                if a <= mid <= b:
                    name = n  # the innermost (latest-starting) span wins
                elif a > mid:
                    break
            idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
        return {
            "window_s": window_s,
            "busy_s": busy_us * 1e-6,
            "span_calls": {n: len(ss) for n, ss in spans.items()},
            "span_launches": {n: count_in(launches, merged(ss)) for n, ss in spans.items()},
            "kernel_s": by_kernel,
            "device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
        }
