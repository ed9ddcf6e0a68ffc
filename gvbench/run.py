"""Run one cell of the benchmark once.

    python3 gvbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program. Prints the result as
the last line of standard output (one JSON object) and the compared
numbers beside their limits as the last lines of standard error. Exits
with another code than 0, and prints no result, without enough CUDA cards,
without the program, or when JAX or the JAX package is loaded.

``--control f32`` or ``--control klt-bf16`` runs one of the comparison's
controls (``controls.py``), and ``--control assembly-fault`` a planted
fault; each has to come out not correct. The run keeps to two fixed cores.
"""

import os
import time

T_START = time.perf_counter()
# one process with few threads: the host work is numpy on small arrays
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
PIN_CORES = 2
if __name__ == "__main__" and hasattr(os, "sched_setaffinity"):
    # the run on fixed cores (the last two it may use), before any thread
    # starts: threads inherit it, and the scheduler does not move them
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-PIN_CORES:])

import argparse  # noqa: E402
import json  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gvbench import controls, harness  # noqa: E402


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=tuple(controls.DTYPES), default="f64",
                    help="run a control of the comparison (controls.py) instead")
    return ap


def host_cpu() -> str:
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=20).stdout
        for line in out.splitlines():
            if line.startswith(("Model name", "Vendor ID")):
                return line.split(":", 1)[1].strip() + f" ({platform.machine()})"
    except (OSError, subprocess.TimeoutExpired):
        pass
    return platform.machine() or "unknown"


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def run_cell(root, name, seed, seconds, trace, device, control="f64", t_start=None):
    """One run of cell ``name`` on ``device`` (``control``: see
    ``controls.py``): (result line as a dict, the record of the run)."""
    spec = harness.Spec(root)
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    drv = harness.driver(traffic["kind"])
    undo = []
    try:
        controls.install(control, undo)
        rec = drv.run(spec, cell, config, traffic, seed, seconds, bool(trace), device,
                      T_START if t_start is None else t_start, dtype=controls.DTYPES[control])
    finally:
        for fn in undo:
            fn()
    ctx = dict(rec, cell=cell, config=config, traffic=traffic)
    metrics = {}
    for m in spec.metrics(name, bool(trace)):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = harness.card(device)
    dev["memory_peak_bytes"] = int(rec["memory_peak"])
    line = {"correct": bool(rec["correct"]), "attempted": int(rec["attempted"]),
            "failed": int(rec["failed"]), "metrics": metrics, "device": dev}
    tr = rec.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": [[k[:160], v] for k, v in tr["device_ops"]],
                             "idle_gaps": [[k, v] for k, v in tr["idle_gaps"]]}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rec["checks"]}
    return line, rec


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    spec = harness.Spec(ROOT)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"gvbench: the cell needs {cell['chips']} CUDA card(s); {n} visible",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cores = sorted(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else []
    print(f"gvbench: {args.workload} seed {args.seed}; host CPU {host_cpu()} "
          f"({os.cpu_count()} cores, run on {cores}); card {power_limit()}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}", file=sys.stderr, flush=True)
    line, rec = run_cell(ROOT, args.workload, args.seed, args.seconds, args.trace, device,
                         args.control)
    bad = harness.forbidden_modules()
    if bad:
        print(f"gvbench: refused: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print("gvbench notes: " + json.dumps(rec.get("notes", {}), default=str), file=sys.stderr)
    print(json.dumps(line), flush=True)
    for n, v, lim in rec["checks"]:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
