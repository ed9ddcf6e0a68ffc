"""PyTorch port, the real-data replay path on the CPU: the PNG codec, the
Bayer conversion, the KAIST and rosbag ingest, the reference-format
writers, the columnar file layer, the drawer and the trajectory metrics,
each against the JAX package's counterpart (or PIL for the PNG decoder),
and ``ic_gvins_tpu_torch.tools.run_kaist`` end to end on a KAIST-layout
directory written from ``tests/test_pipeline.py``'s 320 x 240 scene.

Inputs come from numpy seeds or the stored fixtures. Tolerances: exact
where both sides compute the same numpy expression; GEO_ATOL for local
positions from geodetic ones (differences of ~6.4e6 m ECEF vectors, whose
last bits torch's and XLA's sin/cos round apart); PRINTED for numbers
read back from text files both sides wrote with 9 decimals."""

import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_solver import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

from ic_gvins_tpu_torch.data import image as timage  # noqa: E402
from ic_gvins_tpu_torch.data import kaist as tkaist  # noqa: E402
from ic_gvins_tpu_torch.data import rosbag as trosbag  # noqa: E402
from ic_gvins_tpu_torch.engine import drawer as tdrawer  # noqa: E402
from ic_gvins_tpu_torch.engine import fileio as tfileio  # noqa: E402
from ic_gvins_tpu_torch.engine.outputs import RunWriter  # noqa: E402
from ic_gvins_tpu_torch import eval as teval  # noqa: E402

SMALL = os.path.join(ROOT, "tests", "fixtures", "torch_estimator_small.npz")
ATE_VS_JAX = 0.1  # m, as test_torch_estimator's PIPELINE_ATE_VS_JAX
GEO_ATOL = 1e-8  # m: 1.6e-15 of the Earth radius, a few ulp of an ECEF coordinate
# one unit of the 9th printed decimal, which a last-bit difference flips
# (plus the parse's rounding of that unit)
PRINTED = 1.1e-9


# --- PNG ---------------------------------------------------------------------


_IMAGES = {"grey8": ((29, 41), np.uint8), "grey16": ((29, 41), np.uint16),
           "rgb8": ((23, 31, 3), np.uint8), "rgba8": ((17, 19, 4), np.uint8)}
_FILTERS = ([0], [1], [2], [3], [4], [2, 2, 3, 2, 1, 2, 2, 4, 0, 1])


@pytest.mark.parametrize("kind", list(_IMAGES))
def test_png_decoder_matches_pil(tmp_path, kind):
    """Every filter alone and a mix with runs of Up rows, written by the
    port's encoder and decoded by the port and by PIL: both give the
    image back."""
    shape, dtype = _IMAGES[kind]
    img = np.random.default_rng(len(kind)).integers(0, np.iinfo(dtype).max + 1, shape)
    img = img.astype(dtype)
    path = str(tmp_path / "f.png")
    for ft in _FILTERS:
        timage.write_png(path, img, filters=ft)
        got = timage.read_png(path)
        assert got.dtype == dtype and np.array_equal(got, img), (kind, ft)
        np.testing.assert_array_equal(np.asarray(Image.open(path)).astype(np.int64),
                                      img.astype(np.int64))
        with open(path, "rb") as f:  # the rows carry the filters asked for
            raw = np.frombuffer(zlib.decompress(f.read()[33 + 8:-12]), np.uint8)
        np.testing.assert_array_equal(raw.reshape(shape[0], -1)[:, 0],
                                      np.resize(ft, shape[0]))


@pytest.mark.parametrize("kind", list(_IMAGES))
def test_png_writer_round_trips(tmp_path, kind):
    """The encoder's default files (every row filtered None) read back
    equal through the port and PIL."""
    shape, dtype = _IMAGES[kind]
    img = np.random.default_rng(7).integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "w.png")
    timage.write_png(path, img)
    np.testing.assert_array_equal(timage.read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)).astype(np.int64),
                                  img.astype(np.int64))


def test_bayer_and_load_gray_match_jax(tmp_path, monkeypatch):
    """``bayer_to_gray`` is the JAX package's numpy path (forced by hiding
    cv2); ``load_gray`` of grey, Bayer and RGB files equals JAX's."""
    from ic_gvins_tpu.data import image as jimage

    rng = np.random.default_rng(3)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for shape in ((24, 32), (25, 33)):
        raw = rng.integers(0, 256, shape).astype(np.uint8)
        for pattern in ("rggb", "gbrg"):
            np.testing.assert_array_equal(timage.bayer_to_gray(raw, pattern),
                                          jimage.bayer_to_gray(raw, pattern))
    monkeypatch.undo()
    grey = rng.integers(0, 256, (24, 32)).astype(np.uint8)
    rgb = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)
    for name, img, bayer in (("g", grey, None), ("b", grey, "rggb"), ("c", rgb, None)):
        path = str(tmp_path / f"{name}.png")
        timage.write_png(path, img)
        want = jimage.load_gray(path, bayer=None) if bayer is None else None
        got = timage.load_gray(path, bayer=bayer)
        if bayer is None:
            np.testing.assert_array_equal(got, want)
        else:  # JAX demosaics with cv2 when it can: hold the numpy path
            np.testing.assert_array_equal(got, timage.bayer_to_gray(grey))


# --- KAIST and rosbag ingest ----------------------------------------------------


def _write_kaist(root, rng, std_cols):
    """A short KAIST-layout sequence of random rates and fixes."""
    sensor = os.path.join(root, "sensor_data")
    os.makedirs(sensor, exist_ok=True)
    t_ns = 1544590798_000_000_000 + np.cumsum(rng.integers(9_000_000, 11_000_000, 300))
    imu = np.concatenate([t_ns[:, None], rng.standard_normal((300, 16))], 1)
    np.savetxt(os.path.join(sensor, "xsens_imu.csv"), imu, delimiter=",",
               fmt=["%d"] + ["%.9f"] * 16)
    g = np.stack([t_ns[::50], 36.37 + 1e-5 * rng.standard_normal(6),
                  127.36 + 1e-5 * rng.standard_normal(6), 72.5 + rng.standard_normal(6)], 1)
    if std_cols:
        g = np.concatenate([g, 0.05 + 0.01 * rng.random((6, 3))], 1)
    np.savetxt(os.path.join(sensor, "vrs_gps.csv"), g, delimiter=",",
               fmt=["%d"] + ["%.12f"] * (g.shape[1] - 1))
    img_dir = os.path.join(root, "image", "stereo_left")
    os.makedirs(img_dir, exist_ok=True)
    for t in t_ns[::30]:
        open(os.path.join(img_dir, f"{t}.png"), "wb").close()


@pytest.mark.parametrize("std_cols", [False, True])
def test_kaist_load_sequence_matches_jax(tmp_path, std_cols):
    from ic_gvins_tpu.data import kaist as jkaist

    _write_kaist(str(tmp_path), np.random.default_rng(int(std_cols)), std_cols)
    cols = dict(std=(4, 5, 6)) if std_cols else {}
    got = tkaist.load_sequence(str(tmp_path), gps_cols=tkaist.GpsColumns(**cols))
    want = jkaist.load_sequence(str(tmp_path), gps_cols=jkaist.GpsColumns(**cols))
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(got[1].time, np.asarray(want[1].time))
    np.testing.assert_allclose(got[1].p, np.asarray(want[1].p), rtol=0, atol=GEO_ATOL)
    np.testing.assert_array_equal(got[1].std, np.asarray(want[1].std))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(tkaist.image_timestamps(str(tmp_path)),
                                  jkaist.image_timestamps(str(tmp_path)))


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_convert_bag_matches_jax(tmp_path, compression):
    """The same bag converted by both packages: the same files, the same
    CSV bytes, and equal images (the JAX package writes its PNGs with
    cv2, the port with its own writer; the port's decoder reads both)."""
    from test_rosbag import make_bag

    from ic_gvins_tpu.data import rosbag as jrosbag

    bag = str(tmp_path / "t.bag")
    make_bag(bag, compression=compression)
    out = {}
    for name, mod in (("port", trosbag), ("jax", jrosbag)):
        out[name] = str(tmp_path / name)
        counts = mod.convert_bag(bag, out[name], image_topic="/cam/image")
        assert counts == dict(imu=20, gnss=3, images=2)
    assert list(trosbag.bag_topics(bag).items()) == list(jrosbag.bag_topics(bag).items())
    for sub in ("sensor_data", "image"):
        assert sorted(os.listdir(os.path.join(out["port"], sub))) == sorted(
            os.listdir(os.path.join(out["jax"], sub)))
    for name in ("xsens_imu.csv", "vrs_gps.csv"):
        a, b = (open(os.path.join(out[k], "sensor_data", name), "rb").read() for k in out)
        assert a == b, name
    for name in os.listdir(os.path.join(out["port"], "image")):
        a, b = (timage.read_png(os.path.join(out[k], "image", name)) for k in out)
        np.testing.assert_array_equal(a, b)


def test_convert_bag_command_matches_jax(tmp_path, capsys, monkeypatch):
    """``python -m ic_gvins_tpu_torch.tools.convert_bag`` with the JAX
    command's arguments: the same JSON lines (counts, topic list) and the
    same CSV files as ``tools/convert_bag.py``."""
    from test_rosbag import make_bag

    import tools.convert_bag as jcmd
    from ic_gvins_tpu_torch.tools import convert_bag as tcmd

    bag = str(tmp_path / "t.bag")
    make_bag(bag, compression="bz2")
    lines = {}
    for name, run in (("port", tcmd.main), ("jax", jcmd.main)):
        for extra in (["--image-topic", "/cam/image"], ["--list-topics"]):
            argv = [bag, str(tmp_path / name)] + extra
            if name == "port":
                run(argv)
            else:
                monkeypatch.setattr(sys, "argv", ["convert_bag.py"] + argv)
                run()
            lines[name, extra[0]] = capsys.readouterr().out
    for extra in ("--image-topic", "--list-topics"):
        assert lines["port", extra] == lines["jax", extra]
    assert json.loads(lines["port", "--image-topic"]) == dict(imu=20, gnss=3, images=2)
    for csv in ("xsens_imu.csv", "vrs_gps.csv"):
        a, b = (open(tmp_path / k / "sensor_data" / csv, "rb").read() for k in ("port", "jax"))
        assert a == b, csv


# --- writers, file layer, drawer, metrics ----------------------------------------


def _rows(rng, n=7):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return (1.7e9 + np.arange(n) * 0.1, 30.0 * rng.standard_normal((n, 3)), q,
            rng.standard_normal((n, 3)), 1e-4 * rng.standard_normal((n, 3)),
            1e-3 * rng.standard_normal((n, 3)))


@pytest.mark.parametrize("geodetic", [False, True])
def test_run_writer_matches_jax(tmp_path, geodetic):
    """The same rows through both ``RunWriter``s: every file has the same
    rows, read back to PRINTED."""
    import jax.numpy as jnp

    from ic_gvins_tpu.data.types import NavState as JNav
    from ic_gvins_tpu.engine.outputs import RunWriter as JWriter
    from ic_gvins_tpu_torch.data.types import NavState as TNav

    rng = np.random.default_rng(int(geodetic))
    origin = np.array([0.532, 2.23, 40.0]) if geodetic else None
    nav_rows = list(zip(*_rows(rng)))
    stats = [dict(t=1.0, cost0=2.5, iterations=3), dict(t=2.0, cost0=1.5, iterations=4)]
    track = dict(t=3.0, interval=0.5, parallax=12.3, translation=1.2, rotation=0.3,
                 n_mappoints=42, cost_ms=5.5)
    points = [rng.standard_normal(3) for _ in range(4)]
    dirs = {k: str(tmp_path / k) for k in ("port", "jax")}
    for k, (writer, nav, arr) in {"port": (RunWriter, TNav, torch.as_tensor),
                                  "jax": (JWriter, JNav, jnp.asarray)}.items():
        w = writer(dirs[k], origin_blh=origin)
        for t, p, q, v, bg, ba in nav_rows:
            w.write_nav(nav(time=arr(t), p=arr(p), q=arr(q), v=arr(v), bg=arr(bg), ba=arr(ba)),
                        decimate=2)
        for r in stats:
            w.write_statistics(r)
        w.write_tracking(**track)
        w.write_mappoints(points)
        w.write_extrinsic(4.0, arr(np.array([0.1, -0.2, 0.3])),
                          arr(np.array([0.5, 0.5, 0.5, 0.5])), arr(0.01))
        w.close()
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"]))
    for name in names:
        a, b = (np.loadtxt(os.path.join(dirs[k], name), ndmin=2) for k in ("port", "jax"))
        assert a.shape == b.shape and a.size, name
        np.testing.assert_allclose(a, b, rtol=0, atol=PRINTED, err_msg=name)


@pytest.mark.parametrize("mode", [tfileio.TEXT, tfileio.BINARY])
def test_file_saver_matches_jax(tmp_path, mode):
    """Byte-identical to the JAX package's Python writer; reads back the
    JAX package's files."""
    from ic_gvins_tpu.engine import fileio as jfileio

    rows = np.random.default_rng(mode).standard_normal((9, 5))
    paths = [str(tmp_path / f"{k}.dat") for k in ("port", "jax")]
    for path, saver in zip(paths, (tfileio.FileSaver, jfileio.PyFileSaver)):
        with saver(path, 5, mode) as fs:
            fs.dumpn(rows)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    with tfileio.FileLoader(paths[1], 5, mode) as fl:
        back = fl.load_all()
    np.testing.assert_allclose(back, rows, rtol=0, atol=1e-8 if mode == tfileio.TEXT else 0)


def test_drawer_matches_jax():
    """Annotated tracking images and the drawer's state equal JAX's."""
    from ic_gvins_tpu.engine import drawer as jdrawer

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (96, 128)).astype(np.uint8)
    n = 12
    args = (rng.random((n, 2)) * [140, 110] - 5, rng.random((n, 2)) * [140, 110] - 5,
            rng.integers(0, 5, n), rng.random((6, 2)) * 128, rng.random((6, 2)) * 96)
    np.testing.assert_array_equal(tdrawer.draw_tracking_image(img, *args),
                                  jdrawer.draw_tracking_image(img, *args))
    big = np.full((640, 800), 90, np.uint8)
    np.testing.assert_array_equal(tdrawer.draw_tracking_image(big, *args),
                                  jdrawer.draw_tracking_image(big, *args))
    ds = [tdrawer.Drawer(keep_images=2), jdrawer.Drawer(keep_images=2)]
    for d in ds:
        d.update_tracked_mappoints(args[0], args[1], args[2])
        d.update_tracked_refpoints(args[3], args[4])
        for k in range(3):
            d.update_frame(img + k)
        d.update_odometry(0.1, [1.0, 2.0, 3.0])
    for a, b in zip(ds[0].images, ds[1].images):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ds[0].path_p, ds[1].path_p)


def test_trajectory_metrics_match_jax(tmp_path):
    """Association, Umeyama alignment, ATE and RPE, and the TUM / KAIST
    loaders equal the JAX package's."""
    from ic_gvins_tpu import eval as jeval

    rng = np.random.default_rng(11)
    t_ref = np.arange(0.0, 30.0, 0.1)
    p_ref = np.cumsum(rng.standard_normal((len(t_ref), 3)), 0)
    t_est = np.sort(rng.uniform(0.0, 30.0, 120))
    p_est = np.interp(t_est, t_ref, p_ref[:, 0])[:, None] + 0.1 * rng.standard_normal((120, 3))
    ref_t = teval.Trajectory(t=t_ref, p=p_ref)
    est_t = teval.Trajectory(t=t_est, p=p_est)
    ref_j = jeval.Trajectory(t=t_ref, p=p_ref)
    est_j = jeval.Trajectory(t=t_est, p=p_est)
    for g, w in zip(teval.associate(est_t, ref_t, 0.05), jeval.associate(est_j, ref_j, 0.05)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(teval.umeyama_alignment(p_est, p_ref[:120], True),
                    jeval.umeyama_alignment(p_est, p_ref[:120], True)):
        np.testing.assert_array_equal(g, w)
    for kw in (dict(align=False), dict(align=True, t_min=5.0)):
        assert teval.absolute_trajectory_error(est_t, ref_t, 0.05, **kw) == \
            jeval.absolute_trajectory_error(est_j, ref_j, 0.05, **kw)
    assert teval.relative_pose_error(est_t, ref_t, 1.0, 0.05) == \
        jeval.relative_pose_error(est_j, ref_j, 1.0, 0.05)
    tum = str(tmp_path / "t.txt")
    np.savetxt(tum, np.concatenate([t_ref[:, None], p_ref, rng.standard_normal((len(t_ref), 4))],
                                   1))
    gp = str(tmp_path / "global_pose.csv")
    mats = np.linalg.qr(rng.standard_normal((5, 3, 3)))[0]
    np.savetxt(gp, np.concatenate([np.arange(5)[:, None] * 1e8, np.concatenate(
        [mats, rng.standard_normal((5, 3, 1))], 2).reshape(5, 12)], 1), delimiter=",")
    for load in ("load_tum", "load_kaist_global_pose"):
        g, w = getattr(teval, load)(tum if load == "load_tum" else gp), \
            getattr(jeval, load)(tum if load == "load_tum" else gp)
        for f in ("t", "p", "q"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))


# --- the replay command -----------------------------------------------------------


def test_run_kaist_on_the_pipeline_scene(tmp_path):
    """``run_kaist.main([... "--device", "cpu"])`` on a KAIST-layout
    directory written from the stored ``pipeline`` scenario (IMU and GNSS
    as CSV, 8-bit PNG frames, TUM truth): the reference-format outputs
    exist, the JSON line's ATE equals the ATE of trajectory.csv against
    the truth, is under 0.45 m and within ATE_VS_JAX of the JAX
    ``Pipeline``'s stored ATE."""
    from ic_gvins_tpu_torch.engine import config as tconfig
    from ic_gvins_tpu_torch.tools import run_kaist

    s = chip_smoke.scenario(dict(np.load(SMALL)), "pipeline")
    cfg = chip_smoke.engine_config(tconfig, s)
    root, out = str(tmp_path / "seq"), str(tmp_path / "run")
    cfg_path, truth_path, truth_t, truth_p, _ = chip_smoke.write_kaist_dir(root, s, cfg)
    res = run_kaist.main(["--data", root, "--config", cfg_path, "--out", out,
                          "--ref", truth_path, "--gps-default-std", "0.05", "--bayer", "none",
                          "--max-nodes", str(cfg.max_nodes),
                          "--max-landmarks", str(cfg.max_landmarks), "--device", "cpu"])
    assert res["state"] != 0 and res["frames"] == len(s["frame_t"])
    assert res["keyframes"] >= 2 and res["dropped_gnss"] == 0
    for name in ("gvins.nav", "trajectory.csv", "statistics.txt", "tracking.txt",
                 "IMU_ERR.txt", "extrinsic.txt"):
        assert os.path.getsize(os.path.join(out, name)) > 0, name
    t, err = chip_smoke.replay_errors(out, truth_t, truth_p)
    ate = chip_smoke.rms(err[t >= t[0] + 5.0])
    assert abs(res["ate_rmse_m"] - ate) <= 1e-4, (res, ate)
    assert res["ate_rmse_m"] < chip_smoke.PIPELINE_ATE
    jax_ate = float(s["out/ate_rmse"])
    assert abs(res["ate_rmse_m"] - jax_ate) <= ATE_VS_JAX, (res["ate_rmse_m"], jax_ate)


def test_pipeline_pushes_drawer():
    """The port's ``Pipeline`` forwards each frame's tracks, image and
    pose to a drawer (tests/test_drawer.py's scene)."""
    from ic_gvins_tpu_torch.engine.config import CameraConfig, EngineConfig
    from ic_gvins_tpu_torch.engine.pipeline import Pipeline

    cfg = EngineConfig(max_nodes=8, max_landmarks=16, track_max_features=16,
                       cam=CameraConfig(intrinsic=(100.0, 100.0, 64.0, 48.0),
                                        distortion=(0.0, 0.0, 0.0, 0.0), resolution=(128, 96)))
    d = tdrawer.Drawer()
    pipe = Pipeline(cfg, device="cpu", use_clahe=False, drawer=d)
    rng = np.random.RandomState(0)
    img0 = (rng.rand(96, 128) * 255).astype(np.float32)
    pipe.add_image(0.0, img0)
    pipe.add_image(0.1, np.roll(img0, (1, 2), axis=(0, 1)))
    assert len(d.images) >= 1 and d.images[-1].shape == (96, 128, 3)
    assert len(pipe.frontend.last_tracked_ids) > 0


def test_run_kaist_converts_and_replays_a_rosbag(tmp_path, capsys):
    """``--data x.bag``: the bag is converted once beside itself into the
    KAIST layout and replayed (GNSS/INS only); the printed JSON line has
    the JAX runner's keys (``tools/run_kaist.py``'s ``result``). The bag's
    IMU runs at 100 Hz against the 200 Hz nominal rate, so each increment
    after the first one fed (18 of them) is split in two."""
    import json

    from test_rosbag import make_bag

    from ic_gvins_tpu_torch.tools import run_kaist

    bag = str(tmp_path / "t.bag")
    make_bag(bag, compression="bz2")
    res = run_kaist.main(["--data", bag, "--no-vision", "--out", str(tmp_path / "run"),
                          "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert sorted(res) == sorted(["nodes", "frames", "keyframes", "state", "imu_repaired",
                                  "dropped_gnss", "wall_s", "replay_rate", "outdir"])
    assert res["imu_repaired"] == 18 and res["frames"] == 0
    assert sorted(os.listdir(tmp_path / "t_kaist" / "sensor_data")) == ["vrs_gps.csv",
                                                                      "xsens_imu.csv"]
    assert os.path.exists(tmp_path / "run" / "gvins.nav")
