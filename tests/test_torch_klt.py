"""PyTorch port: the plain KLT tracker against the JAX trackers, and the
kernel wrapper's contract (CPU -> plain version, bad input -> error).

Inputs are made with numpy from fixed seeds and handed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_solver import one_torch_thread  # noqa: F401
from test_vision import random_texture, shift_image

from ic_gvins_tpu.vision import klt as jklt
from ic_gvins_tpu.vision import klt_pallas, pyramid as jpyr
from ic_gvins_tpu_torch.vision import klt as tklt
from ic_gvins_tpu_torch.vision import klt_cuda
from ic_gvins_tpu_torch.vision import pyramid as tpyr

# Both trackers run the same float32 arithmetic in the same order except
# for the 441-term window sums, whose reduction order differs between XLA
# and PyTorch: points agree to float32 rounding.
PTS_ATOL = 1e-3  # px, where both are ok


def _pair(h, w, seed, dx, dy):
    img0 = random_texture(h, w, seed=seed)
    img1 = np.array(shift_image(img0, dx, dy), np.float32)
    jp = (jpyr.build_pyramid(jnp.asarray(img0), 3), jpyr.build_pyramid(jnp.asarray(img1), 3))
    tp = (tpyr.build_pyramid(torch.from_numpy(img0), 3),
          tpyr.build_pyramid(torch.from_numpy(img1), 3))
    return jp, tp


def _points(n, h, w, seed, margin=6.0):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2)) * [w - 2 * margin, h - 2 * margin] + margin
    return pts.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_plain_tracker_matches_jax(seed, bidirectional):
    """16 features (some near the border) on 120x160 textured frames with a
    subpixel shift, 4 pyramid images; the last feature starts invalid."""
    (jp0, jp1), (tp0, tp1) = _pair(120, 160, 7 + seed, 2.3, -1.7)
    pts = _points(16, 120, 160, seed)
    init = pts + np.float32([1.0, -0.5])
    valid = np.ones(16, bool)
    valid[-1] = False
    if bidirectional:
        j = jklt.lk_track_bidirectional(jp0, jp1, jnp.asarray(pts), jnp.asarray(init),
                                        jnp.asarray(valid))
        t = tklt.lk_track_bidirectional(tp0, tp1, torch.from_numpy(pts),
                                        torch.from_numpy(init), torch.from_numpy(valid))
    else:
        j = jklt.lk_track(jp0, jp1, jnp.asarray(pts), jnp.asarray(init), jnp.asarray(valid))
        t = tklt.lk_track(tp0, tp1, torch.from_numpy(pts), torch.from_numpy(init),
                          torch.from_numpy(valid))
    ok = np.asarray(j[1])
    np.testing.assert_array_equal(ok, t[1].numpy())
    assert ok.sum() >= 8
    np.testing.assert_allclose(t[0].numpy()[ok], np.asarray(j[0])[ok], atol=PTS_ATOL, rtol=0)
    if bidirectional:
        np.testing.assert_allclose(t[2].numpy()[ok], np.asarray(j[2])[ok], atol=PTS_ATOL, rtol=0)


def test_plain_tracker_matches_pallas_interpret():
    """Interior points against the Pallas kernel run by the interpreter.
    The Pallas kernel's search-window gate and its 1 px narrower entry
    gate differ from klt.py only near borders and for long moves, so the
    tolerance is the one tests/test_klt_pallas.py uses (0.05 px)."""
    (jp0, jp1), (tp0, tp1) = _pair(240, 320, 7, 4.2, -3.1)
    pts = np.array([[60.0, 80.0], [160.0, 120.0], [250.0, 200.0], [100.0, 60.0]],
                   np.float32)
    valid = np.ones(4, bool)
    jp_pts, jp_ok, _ = klt_pallas.lk_track_bidirectional_pallas(
        jp0, jp1, jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(valid), interpret=True)
    t_pts, t_ok, _ = tklt.lk_track_bidirectional(
        tp0, tp1, torch.from_numpy(pts), torch.from_numpy(pts), torch.from_numpy(valid))
    assert bool(np.all(np.asarray(jp_ok))) and bool(t_ok.all())
    np.testing.assert_allclose(t_pts.numpy(), np.asarray(jp_pts), atol=0.05, rtol=0)


def test_wrapper_uses_plain_version_on_cpu():
    _, (tp0, tp1) = _pair(60, 80, 3, 1.2, 0.4)
    pts = torch.from_numpy(_points(8, 60, 80, 5, margin=12.0))
    valid = torch.ones(8, dtype=torch.bool)
    before = klt_cuda.lk_track_bidirectional.launches
    got = klt_cuda.lk_track_bidirectional(tp0, tp1, pts, pts, valid)
    want = tklt.lk_track_bidirectional(tp0, tp1, pts, pts, valid)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert klt_cuda.lk_track_bidirectional.launches == before  # no kernel launch


@pytest.mark.parametrize("fault", ["f64_points", "strided_points", "shape", "valid_dtype",
                                   "level_mismatch", "f64_image"])
def test_wrapper_rejects_bad_inputs(fault):
    _, (tp0, tp1) = _pair(60, 80, 3, 1.2, 0.4)
    pts = torch.from_numpy(_points(8, 60, 80, 5, margin=12.0))
    valid = torch.ones(8, dtype=torch.bool)
    args = [tp0, tp1, pts, pts, valid]
    if fault == "f64_points":
        args[2] = pts.double()
    elif fault == "strided_points":
        args[3] = torch.cat([pts, pts], 1)[:, ::2]
    elif fault == "shape":
        args[3] = pts[:4]
    elif fault == "valid_dtype":
        args[4] = valid.to(torch.uint8)
    elif fault == "level_mismatch":
        args[1] = tp1[:-1]
    elif fault == "f64_image":
        args[0] = (tp0[0].double(),) + tp0[1:]
    with pytest.raises(ValueError):
        klt_cuda.lk_track_bidirectional(*args)

