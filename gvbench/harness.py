"""What every cell shares: finding a cell's files by name, the seams at
which a run watches the program, the comparison's bookkeeping and the
result line.

A cell (``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix. The configuration is the JSON file that its entry in
``configs`` names; the mix is ``gvbench/traffic/<traffic>.json``, whose
``kind`` names the driver (``gvbench/drivers/<kind>.py``); a metric is
read by ``gvbench/metrics/<name>.py`` or, where that file is missing, by
the reader named by the part of the name before its first dot. The limits
of the comparison are ``gvbench/limits/<kind>.json``. A new cell,
configuration, mix or metric is new files and new entries: no file here
changes.
"""

import functools
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ic_gvins_tpu")


class Spec:
    """``BENCHMARK.json`` of a checkout and the files of its cells."""

    def __init__(self, root):
        self.root = Path(root)
        self.bench = self.root / BENCH_DIR.name
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def limits(self, kind: str) -> dict:
        return json.loads((self.bench / "limits" / f"{kind}.json").read_text())

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's metrics: its end-to-end ones, or with ``trace`` its
        per-layer ones (a metric with ``workloads`` only in those cells)."""
        ms = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in ms if "workloads" not in m or cell in m["workloads"]]

    def reader(self, name: str):
        """The ``read(ctx)`` function of a metric."""
        d = self.bench / "metrics"
        path = d / f"{name}.py"
        if not path.exists():
            path = d / f"{name.split('.')[0]}.py"
        spec = importlib.util.spec_from_file_location(
            "gvbench_metric_" + path.stem.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def driver(kind: str):
    return importlib.import_module(f"{BENCH_DIR.name}.drivers.{kind}")


class Sampler:
    """A uniform sample of ``n`` of the calls a seam sees, drawn from
    ``rng`` as they come (reservoir sampling), and with ``key`` also the
    call that ``key(out)`` ranks highest; with ``when()`` only the calls
    made while it holds count. Only the sampled calls' records are kept."""

    def __init__(self, n, rng, key=None, when=None):
        self.n, self.rng, self.key, self.when = n, rng, key, when
        self.seen = 0
        self.kept: dict[int, object] = {}  # reservoir slot -> (call index, record)
        self.top = None  # (key, call index, record)

    def offer(self, make, out):
        """Count one call; ``make()`` gives its record if it is sampled."""
        if self.when is not None and not self.when():
            return
        i = self.seen
        self.seen += 1
        rec = None
        if i < self.n:
            rec = make()
            self.kept[i] = (i, rec)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.n:
                rec = make()
                self.kept[j] = (i, rec)
        if self.key is not None:
            k = self.key(out)
            if self.top is None or k > self.top[0]:
                self.top = (k, i, rec if rec is not None else make())

    def records(self) -> list:
        """The sampled records, in call order."""
        got = dict(self.kept.values())
        if self.top is not None:
            got[self.top[1]] = self.top[2]
        return [got[i] for i in sorted(got)]


class Seams:
    """Wrappers put around program functions for the length of a run: each
    call made while ``on`` is offered to its seam's ``Sampler``, which keeps
    the arguments and results of the calls it samples (as references:
    nothing is copied or read back); with a profiler each call is a named
    span."""

    def __init__(self):
        self.on = False
        self.spans = False
        self.samplers: dict[str, Sampler] = {}
        self.context: dict = {}
        self._undo = []

    def wrap(self, module, attr: str, name: str, sample: Sampler, keep=None):
        """Replace ``module.attr``; ``keep(args, kwargs, out)`` gives what a
        record holds (by default the arguments and the result)."""
        fn = getattr(module, attr)
        self.samplers[name] = sample
        span = f"gvbench::{name}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if self.spans:
                with torch.profiler.record_function(span):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if self.on:
                ctx = dict(self.context)
                sample.offer(lambda: (ctx, keep(args, kwargs, out) if keep
                                      else (args, kwargs, out)), out)
            return out

        setattr(module, attr, wrapper)
        self._undo.append((module, attr, fn))

    def records(self, name: str) -> list:
        s = self.samplers.get(name)
        return s.records() if s is not None else []

    def counts(self) -> dict:
        return {k: s.seen for k, s in self.samplers.items()}

    def restore(self):
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)
        self._undo.clear()


# ---------------------------------------------------------------------------
# comparison


def leaves(tree, prefix=""):
    """(path, tensor) of every tensor in nested NamedTuples."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    elif torch.is_tensor(tree):
        yield prefix.rstrip("."), tree


def to64(tree, device=None):
    """Every floating tensor of ``tree`` as float64 (on ``device``)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to64(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to64(v, device) for v in tree)
    if torch.is_tensor(tree):
        x = tree.to(device) if device is not None else tree
        return x.double() if x.is_floating_point() else x
    return tree


def tree_gap(got, ref) -> float:
    """The worst leaf of ``got`` against ``ref``: max |got - ref| over the
    leaf, against the larger of the leaf's own max |ref| and the median
    leaf's; a flag (bool leaf) that differs anywhere reads 1."""
    pairs = [(a, b) for (_, a), (_, b) in zip(leaves(got), leaves(ref))]
    scales = [float(b.double().abs().max()) for _, b in pairs if b.numel() and
              b.is_floating_point()]
    med = float(np.median(scales)) if scales else 1.0
    worst = 0.0
    for a, b in pairs:
        if not b.numel():
            continue
        if not b.is_floating_point():
            if not torch.equal(a.to(b.device).to(b.dtype), b):
                worst = max(worst, 1.0)
            continue
        d = float((a.to(b.device).double() - b.double()).abs().max())
        if not math.isfinite(d):
            return math.inf
        worst = max(worst, d / max(float(b.double().abs().max()), med, 1e-300))
    return worst


def rel_scalar(a, b) -> float:
    a, b = float(a), float(b)
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-300)


# ---------------------------------------------------------------------------
# the result


def card(device) -> dict:
    return {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu"),
            "count": 1}


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
