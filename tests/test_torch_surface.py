"""The port's surface against the JAX package's, read from the source with
``ast`` (neither package is imported).

Every public module, function, class and method of ``ic_gvins_tpu/`` has
a counterpart of the same name at the same module path in
``ic_gvins_tpu_torch/`` (a name the port module binds by import counts),
taking the same argument names (the port may add its own, such as
``device`` or ``dtype``). JAX's command-line runners and its entry points
have counterparts under ``ic_gvins_tpu_torch/`` with the same flags. Every
exception is in a table below with its reason; a name the JAX package
gains, or one the port drops, fails here."""

import ast
import os
from functools import lru_cache

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "ic_gvins_tpu")
PORT = os.path.join(ROOT, "ic_gvins_tpu_torch")

# JAX modules with no module of the same path in the port
MODULES_NOT_PORTED = {
    "common/compile_cache.py": "XLA's persistent compilation cache; eager PyTorch compiles no "
                               "programs to cache (ROADMAP, Do not port)",
    "vision/klt_pallas.py": "the Pallas kernel; its port is the CUDA kernel csrc/klt.cu behind "
                            "vision/klt_cuda.py",
}
# public JAX names with no counterpart
NAMES_NOT_PORTED = {
    ("vision/klt.py", "lk_track_matmul"): "the MXU tracker, the gather-free TPU formulation; "
                                          "csrc/klt.cu and the plain vision/klt.py compute it",
    ("vision/klt.py", "lk_track_bidirectional_matmul"): "the MXU tracker (as above)",
}
# JAX argument names the port takes under another name: any one of these
ARG_RENAMES = {
    "axis_name": ("mesh",),  # a parallel.Mesh (its shards and ranks) instead of a mesh axis name
    "key": ("generator", "u", "draws"),  # torch generators, or the draws themselves (JAX's, in
                                         # numpy by common/prng.py) instead of a JAX PRNG key
}
# JAX arguments the port does not take
ARGS_NOT_PORTED = {
    ("vision/detector.py", "occupancy_mask", "chunk"):
        "the TPU's memory bound on one broadcast; the port computes the mask at once",
    ("vision/ransac.py", "fundamental_ransac", "n_hypotheses"):
        "the hypotheses are the rows of the draws u",
    ("engine/frontend.py", "Frontend.__init__", "use_pallas"):
        "the tensors' device picks the tracker: the CUDA kernel on a card, vision/klt.py on "
        "the CPU",
    ("engine/pipeline.py", "Pipeline.__init__", "use_pallas"):
        "as Frontend's; the pipeline's device argument decides",
    ("solver/assembly.py", "huber_weight", "s"):
        "the port binds factors/residuals.huber_weight, the same function, whose argument is "
        "chi2 (as in the JAX package's residuals.py)",
}
# JAX's commands and their ports
RUNNERS = {
    "tools/run_kaist.py": "tools/run_kaist.py",
    "tools/run_sim.py": "tools/run_sim.py",
    "tools/run_urban.py": "tools/run_urban.py",
    "tools/convert_bag.py": "tools/convert_bag.py",
    "tools/multihost_lm.py": "tools/multihost_lm.py",
    "__graft_entry__.py": "entry.py",
}
FLAG_RENAMES = {
    "--platform": "--device", "--tpu": "--device", "--no-pallas": "--device",
    "--coord": "--init", "--local-devices": "--local-shards",
}
# the JAX package's other scripts: what covers each, or why nothing does
SCRIPTS_NOT_PORTED = {
    "bench.py": "the benchmark's: its port writes BENCHMARK.json, a benchmark change's work "
                "(ROADMAP Queue 1 item 1), not the port's",
    "tools/bench_klt.py": "the TPU kernel's timing; the port's kernel is timed by "
                          "tools/bench_torch_klt.py and chip_smoke.py",
    "tools/bench_optimize.py": "the benchmark covers it (ROADMAP, Do not port)",
    "tools/debug_f32_urban.py": "a JAX development diagnostic (ROADMAP, Do not port)",
    "tools/diag_outage.py": "a JAX development diagnostic (ROADMAP, Do not port)",
    "tools/diag_pipeline_gates.py": "a JAX development diagnostic (ROADMAP, Do not port)",
    "tools/diag_pipeline_gates2.py": "a JAX development diagnostic (ROADMAP, Do not port)",
    "tools/soak_marg.py": "a JAX development diagnostic (ROADMAP, Do not port)",
    "scripts/show_extrinsic.py": "reads output files only and imports no package module",
    "scripts/show_statistics.py": "reads output files only and imports no package module",
    "scripts/show_tracking.py": "reads output files only and imports no package module",
    "scripts/show_trajectory.py": "reads output files only and imports no package module",
}


@lru_cache(maxsize=None)
def _tree(path):
    with open(path) as f:
        return ast.parse(f.read())


def _args(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def _public(name):
    last = name.split(".")[-1]
    return not last.startswith("_") or (last.startswith("__") and last.endswith("__"))


@lru_cache(maxsize=None)
def _defs(path):
    """{name: argument names, or None for a class} of what a module
    defines at its top level, with its classes' methods as
    ``Class.method``."""
    out = {}
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _args(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = _args(item)
    return out


@lru_cache(maxsize=None)
def _surface(path):
    """``_defs`` and every other name the module binds at its top level (by
    import or assignment); a name imported from the same package carries
    its definition's argument names."""
    out = dict(_defs(path))
    for node in _tree(path).body:
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                out.setdefault(alias.asname or alias.name, _imported(path, node, alias.name))
        elif isinstance(node, ast.Import):
            for alias in node.names:
                out.setdefault(alias.asname or alias.name.split(".")[0], None)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                if isinstance(t, ast.Name):
                    out.setdefault(t.id, None)
    return out


def _imported(path, node, name):
    """The argument names of ``name`` imported by a relative ``from``
    within the package, else None."""
    if not node.level:
        return None
    base = os.path.dirname(path)
    for _ in range(node.level - 1):
        base = os.path.dirname(base)
    parts = (node.module or "").split(".") if node.module else []
    mod = os.path.join(base, *parts)
    for cand in (mod + ".py", os.path.join(mod, "__init__.py")):
        if os.path.exists(cand):
            return _surface(cand).get(name)
    return None


def _modules():
    mods = []
    for dirpath, _, files in os.walk(JAX):
        for f in files:
            if f.endswith(".py"):
                mods.append(os.path.relpath(os.path.join(dirpath, f), JAX))
    return sorted(mods)


MODULES = _modules()


def _flags(path):
    flags = set()
    for node in ast.walk(_tree(path)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flags |= {a.value for a in node.args
                      if isinstance(a, ast.Constant) and str(a.value).startswith("-")}
    return flags


def _missing_args(mod, name, jargs, targs):
    missing = []
    for arg in jargs:
        if arg in targs or (mod, name, arg) in ARGS_NOT_PORTED:
            continue
        if any(alt in targs for alt in ARG_RENAMES.get(arg, ())):
            continue
        missing.append(arg)
    return missing


@pytest.mark.parametrize("mod", MODULES)
def test_module_has_its_counterpart(mod):
    """Each public JAX name of the module exists in the port's module of
    the same path, with JAX's argument names (or their listed renames)."""
    if mod in MODULES_NOT_PORTED:
        assert not os.path.exists(os.path.join(PORT, mod)), f"{mod} is ported now"
        return
    port_path = os.path.join(PORT, mod)
    assert os.path.exists(port_path), f"no ic_gvins_tpu_torch/{mod}"
    jax, port = _defs(os.path.join(JAX, mod)), _surface(port_path)
    skipped = {name for m, name in NAMES_NOT_PORTED if m == mod}
    absent, differ = [], []
    for name, jargs in jax.items():
        if not all(_public(part) for part in name.split(".")) or name.split(".")[0] in skipped:
            continue
        if name not in port:
            absent.append(name)
        elif jargs is not None and port[name] is not None:
            missing = _missing_args(mod, name, jargs, port[name])
            if missing:
                differ.append(f"{name} lacks {missing}")
    assert not absent, f"{mod}: not in the port: {absent}"
    assert not differ, f"{mod}: {differ}"


@pytest.mark.parametrize("jax_path", sorted(RUNNERS))
def test_command_has_its_counterpart(jax_path):
    """The port's command takes every flag of JAX's (``--device`` for the
    platform switches, ``--init`` / ``--local-shards`` for the
    coordinator's), and runs as a script."""
    port_path = os.path.join(PORT, RUNNERS[jax_path])
    assert os.path.exists(port_path), port_path
    want = {FLAG_RENAMES.get(f, f) for f in _flags(os.path.join(ROOT, jax_path))}
    missing = want - _flags(port_path)
    assert not missing, f"{RUNNERS[jax_path]} lacks {sorted(missing)}"
    src = open(port_path).read()
    assert 'if __name__ == "__main__":' in src


def test_entry_points_have_their_counterpart():
    """``__graft_entry__.entry()`` and ``dryrun_multichip(n_devices)`` exist
    in ``ic_gvins_tpu_torch/entry.py`` with those arguments; its problem
    constructor is public there as ``tiny_problem``, with JAX's arguments."""
    jax, port = _defs(os.path.join(ROOT, "__graft_entry__.py")), _defs(
        os.path.join(PORT, "entry.py"))
    for name in ("entry", "dryrun_multichip"):
        assert set(jax[name]) <= set(port[name]), name
    assert set(jax["_tiny_problem"]) <= set(port["tiny_problem"])


def test_every_jax_script_is_accounted_for():
    """Each script of the JAX package outside the package (the repo root,
    ``tools/``, ``scripts/``) is a command with a port, or stands in the
    table with its reason. The port's own tools have "torch" in their
    names; the root's conftest.py holds the test suite's settings."""
    scripts = [f for f in os.listdir(ROOT) if f.endswith(".py")
               and f not in ("chip_smoke.py", "conftest.py")]
    for sub in ("tools", "scripts"):
        scripts += [f"{sub}/{f}" for f in os.listdir(os.path.join(ROOT, sub))
                    if f.endswith(".py") and "torch" not in f]
    unknown = [s for s in scripts if s not in RUNNERS and s not in SCRIPTS_NOT_PORTED]
    assert not unknown, f"scripts neither ported nor listed: {unknown}"
    assert SCRIPTS_NOT_PORTED["bench.py"].startswith("the benchmark's")
    assert os.path.exists(os.path.join(ROOT, "tools", "bench_torch_klt.py"))


def test_every_exception_is_still_needed():
    """Each entry of the tables names something that exists in the JAX
    package and is absent from the port, so that the tables do not keep
    what has been ported since."""
    for mod in MODULES_NOT_PORTED:
        assert os.path.exists(os.path.join(JAX, mod)), mod
    for mod, name in NAMES_NOT_PORTED:
        assert name in _defs(os.path.join(JAX, mod))
        assert name not in _surface(os.path.join(PORT, mod)), f"{mod}: {name} is ported now"
    for mod, name, arg in ARGS_NOT_PORTED:
        assert arg in _defs(os.path.join(JAX, mod))[name], (mod, name, arg)
        assert arg not in _surface(os.path.join(PORT, mod))[name], f"{mod}: {name} takes {arg}"
    used = {a for mod in MODULES if mod not in MODULES_NOT_PORTED
            for name, args in _defs(os.path.join(JAX, mod)).items() if args for a in args}
    assert set(ARG_RENAMES) <= used
    renamed = set().union(*(_flags(os.path.join(ROOT, p)) for p in RUNNERS))
    assert set(FLAG_RENAMES) <= renamed
    for script in SCRIPTS_NOT_PORTED:
        assert os.path.exists(os.path.join(ROOT, script)), script
