"""PyTorch port, the native host library (``ic_gvins_tpu_torch/native``):
built from the port's own sources into ``build/torch_ext/`` with the JAX
package's flags, and held against the JAX package's library bit for bit
(IMU buffer appends, gap filling, slices, drops and exports; the columnar
writer's bytes; the table parser). The port's ``Estimator`` with
``use_native_imu_buffer=True`` (the default) against the JAX native run
of ``gap_native`` in ``tests/fixtures/torch_estimator_small.npz`` (a 0.25
s IMU dropout): identical events and decisions, trajectory within
GAP_TRAJ_ATOL. A library that cannot be built raises; the Python buffer
only by asking for it."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from test_torch_solver import one_torch_thread  # noqa: E402, F401

from ic_gvins_tpu import native as jnative  # noqa: E402
from ic_gvins_tpu_torch import native as tnative  # noqa: E402
from ic_gvins_tpu_torch.data import kaist as tkaist  # noqa: E402
from ic_gvins_tpu_torch.engine import config as tconfig  # noqa: E402
from ic_gvins_tpu_torch.engine import estimator as test  # noqa: E402
from ic_gvins_tpu_torch.engine import fileio as tfileio  # noqa: E402

SMALL = os.path.join(ROOT, "tests", "fixtures", "torch_estimator_small.npz")
GAP_TRAJ_ATOL = 1e-8  # m, the port's native run vs the JAX native run


@pytest.fixture(scope="module")
def jlib():
    lib = jnative.load()
    if lib is None:
        pytest.fail("the JAX package's native library does not build here")
    return lib


def test_library_is_the_ports_own():
    """Built from the port's sources with the JAX package's flags, under
    build/torch_ext/, never the .so inside the JAX package."""
    so = tnative.build()
    assert so.parent == tnative.BUILD_DIR and so.name.startswith("libicgvins_native_")
    assert os.path.dirname(os.path.abspath(jnative._SO)) != str(so.parent)
    assert tnative.CXX_FLAGS == ["-O3", "-fPIC", "-shared", "-std=c++17"]
    for name in tnative.SOURCES:
        with open(os.path.join(os.path.dirname(jnative.__file__), name)) as a, \
                open(os.path.join(os.path.dirname(tnative.__file__), name)) as b:
            strip = lambda f: [x for x in f if not x.startswith("//")]  # noqa: E731
            assert strip(a) == strip(b), name  # the code is the JAX package's


def _fill(bufs, rng, n=600, gaps=((200, 0.05), (400, 0.013))):
    """Append the same samples to every buffer (200 Hz, with stamp gaps);
    every append must report the same count."""
    t = 0.0
    for i in range(n):
        t += 0.005 + sum(g for k, g in gaps if k == i)
        dth, dv = rng.standard_normal(3) * 1e-3, rng.standard_normal(3) * 1e-2
        counts = {b.append(t, 0.005, dth, dv) for b in bufs}
        assert len(counts) == 1


@pytest.mark.parametrize("t0,t1", [(0.5, 1.5), (0.5025, 1.0025), (0.9, 1.3), (0.95, 2.1),
                                   (2.9, 3.0)])
def test_imu_buffer_bit_equal(jlib, t0, t1):
    """Appends with gap filling, slices with boundary interpolation, drops
    and exports: bit-equal to the JAX package's library."""
    a, b = tnative.NativeImuBuffer(0.005), jnative.NativeImuBuffer(0.005)
    _fill((a, b), np.random.default_rng(0))
    assert len(a) == len(b) > 600 and a.last_time == b.last_time
    got, ref = a.slice_between(t0, t1, 512), b.slice_between(t0, t1, 512)
    for x, y in zip(got[:4], ref):
        assert np.array_equal(x, y)
    assert got[4] == int((ref[1] > 0).sum()) + 1  # real samples and the seed
    a.drop_before(t0)
    b.drop_before(t0)
    for x, y in zip(a.export_arrays(), b.export_arrays()):
        assert np.array_equal(x, y)


def test_estimator_buffer_matches_jax(jlib):
    """The estimator's wrapper: stamps mirrored for filled gaps, slices at
    their real length equal the JAX wrapper's padded ones."""
    from ic_gvins_tpu.engine import estimator as jest

    a, b = test._NativeImuBuffer(0.005), jest._NativeImuBuffer(0.005)
    _fill((a, b), np.random.default_rng(1))
    assert a.time == b.time
    for t0, t1 in ((0.2, 0.7), (0.99, 1.51), (2.0, 2.999)):
        got, ref = a.slice_between_np(t0, t1), b.slice_between_np(t0, t1, 256)
        n = len(got[0])
        for x, y in zip(got, ref):
            assert np.array_equal(x, y[:n])
        assert np.all(ref[1][n:] == 0.0)
    a.drop_before(1.0)
    b.drop_before(1.0)
    assert a.time == b.time
    for x, y in zip(a.arrays(), b.arrays()):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("mode", [tfileio.TEXT, tfileio.BINARY])
def test_file_writer_and_reader_match_jax(jlib, tmp_path, mode):
    """The port's FileSaver is the native writer: bytes equal to the JAX
    native writer's and to the Python writer's; FileLoader reads them."""
    from ic_gvins_tpu.engine import fileio as jfileio

    rows = np.random.default_rng(mode).standard_normal((4100, 5))  # past one read chunk
    paths = [str(tmp_path / f"{k}.dat") for k in ("port", "jax", "py")]
    saver = tfileio.FileSaver(paths[0], 5, mode)
    assert isinstance(saver, tnative.NativeFileSaver)
    for path, s in zip(paths, (saver, jnative.NativeFileSaver(paths[1], 5, mode),
                               jfileio.PyFileSaver(paths[2], 5, mode))):
        with s:
            s.dump(rows[0])
            s.dumpn(rows[1:])
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1] == data[2]
    with tfileio.FileLoader(paths[0], 5, mode) as fl:
        first = fl.load()
        back = np.concatenate([first[None], fl.load_all()])
    np.testing.assert_allclose(back, rows, rtol=0, atol=1e-8 if mode == tfileio.TEXT else 0)
    with pytest.raises(ValueError):
        tfileio.FileSaver(paths[0], 5, mode).dump(np.zeros(4))


def test_table_parser_matches_jax(jlib, tmp_path):
    """Comma, semicolon, whitespace, comments, CRLF: equal to the JAX
    parser; a ragged table goes to numpy, which raises."""
    path = tmp_path / "t.csv"
    path.write_text("# header\n1700000000000000000,1.5,-2e-3\r\n"
                    "1700000000010000000; 2.5 , 3e+1 # comment\n\n"
                    "1700000000020000000\t3.5\t-0.25\n")
    got, ref = tnative.load_numeric_table(str(path)), jnative.load_numeric_table(str(path))
    assert got.shape == (3, 3) and np.array_equal(got, ref)
    assert np.array_equal(tkaist._load_table(str(path)), got)
    path.write_text("1,2,3\n4,5\n")
    assert tnative.load_numeric_table(str(path)) is None
    with pytest.raises(ValueError):
        tkaist._load_table(str(path))


def test_estimator_native_gap_matches_jax():
    """EngineConfig's C++ buffer through a 0.25 s IMU dropout (gap repair,
    then slices across it): the JAX native run's events, node times,
    keyframes and LM steps exactly, its trajectory within GAP_TRAJ_ATOL."""
    s = chip_smoke.scenario(dict(np.load(SMALL)), "gap_native")
    ref = {k[4:]: v for k, v in s.items() if k.startswith("out/")}
    est, got = chip_smoke.run_estimator(s, "cpu")
    assert est.cfg.use_native_imu_buffer and isinstance(est.imu, test._NativeImuBuffer)
    assert est.imu_repaired > 0
    dp, _ = chip_smoke.compare_estimator(got, ref)
    assert dp <= GAP_TRAJ_ATOL, dp


def test_python_buffer_only_by_request():
    cfg = tconfig.EngineConfig(use_native_imu_buffer=False)
    assert isinstance(test.Estimator(cfg, device="cpu").imu, test._ImuBuffer)
    assert isinstance(test.Estimator(tconfig.EngineConfig(), device="cpu").imu,
                      test._NativeImuBuffer)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No compiler: the native buffer, writer, reader and parser raise (the
    JAX package falls back to Python there); the message names the flag."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="use_native_imu_buffer"):
        test.Estimator(tconfig.EngineConfig(), device="cpu")
    path = str(tmp_path / "x.csv")
    with open(path, "w") as f:
        f.write("1,2\n")
    for make in (lambda: tfileio.FileSaver(str(tmp_path / "o.txt"), 2),
                 lambda: tfileio.FileLoader(path, 2), lambda: tkaist._load_table(path)):
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            make()


def test_build_rebuilds_when_asked_or_stale(monkeypatch, tmp_path):
    """``build()`` reuses a library newer than its sources; ``force=True``
    compiles it again, and so does a library older than a source (into a
    build directory of its own here)."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    so = tnative.build()
    assert so.parent == tmp_path / "build"
    stamp = so.stat().st_mtime_ns
    assert tnative.build() == so and so.stat().st_mtime_ns == stamp
    assert tnative.build(force=True) == so and so.stat().st_mtime_ns != stamp
    src = min((tnative._DIR / name).stat().st_mtime for name in tnative.SOURCES)
    os.utime(so, (src - 60.0, src - 60.0))
    stale = so.stat().st_mtime_ns
    assert tnative.build() == so and so.stat().st_mtime_ns > stale
