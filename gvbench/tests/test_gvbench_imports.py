"""What the benchmark loads, in fresh processes: nothing of JAX or of the
JAX package anywhere, and nothing of the program in the reference and the
generator. Module names are compared by their whole top-level name (the
part before the first dot): the program's name begins with the JAX
package's."""

import json
import subprocess
import sys

from gvbench.tests.tiny import REPO

# everything run.py loads for any cell, the program's modules the drivers
# import when they run included
HARNESS = ["gvbench.run", "gvbench.drivers.replay", "gvbench.drivers.batch", "gvbench.trace",
           "ic_gvins_tpu_torch.engine.pipeline", "ic_gvins_tpu_torch.engine.config",
           "ic_gvins_tpu_torch.parallel.multi_seq", "ic_gvins_tpu_torch.vision.klt_cuda"]
REFERENCE = ["gvbench.reference.frontend", "gvbench.reference.solver.lm",
             "gvbench.reference.factors.marginalization", "gvbench.reference.ins.preintegration",
             "gvbench.reference.data.simulator", "gvbench.reference.common.prng",
             "gvbench.gen.streams", "gvbench.gen.batch", "gvbench.gen.render",
             "gvbench.klt_work", "gvbench.harness"]


def top_level_after_import(modules) -> set:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_loads_jax():
    names = top_level_after_import(HARNESS + REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "ic_gvins_tpu"}
    assert "ic_gvins_tpu_torch" in names  # the check sees the program's imports


def test_reference_imports_no_program():
    names = top_level_after_import(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "ic_gvins_tpu", "ic_gvins_tpu_torch"}
