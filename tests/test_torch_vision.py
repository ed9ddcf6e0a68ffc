"""PyTorch port: pyramid, camera, detector (+ subpixel) and triangulation
against the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_solver import one_torch_thread  # noqa: F401
from test_vision import make_camera, random_texture

from ic_gvins_tpu.common import rotation as jrot
from ic_gvins_tpu.vision import camera as jcam
from ic_gvins_tpu.vision import detector as jdet
from ic_gvins_tpu.vision import pyramid as jpyr
from ic_gvins_tpu.vision import triangulation as jtri
from ic_gvins_tpu_torch.convert import to_numpy, to_torch
from ic_gvins_tpu_torch.vision import camera as tcam
from ic_gvins_tpu_torch.vision import detector as tdet
from ic_gvins_tpu_torch.vision import pyramid as tpyr
from ic_gvins_tpu_torch.vision import triangulation as ttri


def _t(x):
    return torch.from_numpy(np.array(x))


def test_pyramid_matches_jax():
    """Same float32 taps in the same order: equal to float32 rounding."""
    img = random_texture(97, 131, seed=2)
    jp = jpyr.build_pyramid(jnp.asarray(img), 3)
    tp = tpyr.build_pyramid(_t(img), 3)
    assert [tuple(x.shape) for x in tp] == [tuple(x.shape) for x in jp]
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-4)


def test_pyramid_sizes_at_engine_resolution():
    tp = tpyr.build_pyramid(torch.zeros(1022, 1278), 3)
    assert [tuple(x.shape) for x in tp] == [(1022, 1278), (511, 639), (256, 320), (128, 160)]


@pytest.fixture(scope="module")
def cams():
    jc = make_camera()
    return jc, to_torch(tcam.Camera, to_numpy(jc), "cpu")


def test_camera_and_depth_helpers_match_jax(cams):
    """``pixel_to_unit_cam``, ``pixel_to_world``, ``reprojection_error_px``
    and ``triangulation.depth_in_frame`` on the same inputs: 1e-9."""
    jc, tc = cams
    rng = np.random.default_rng(4)
    uv = rng.random((32, 2)) * [1278, 1022]
    depth = 2 + 20 * rng.random(32)
    r = np.asarray(jrot.quat_to_matrix(jnp.asarray(np.r_[0.9, 0.1, -0.3, 0.2]
                                                   / np.linalg.norm([0.9, 0.1, -0.3, 0.2]))))
    t = np.array([3.0, -1.0, 0.5])
    pw = np.asarray(jcam.pixel_to_world(jc, jnp.asarray(uv), jnp.asarray(depth), r, t))
    pw_noisy = pw + 0.05 * rng.standard_normal(pw.shape)
    pairs = (
        (tcam.pixel_to_unit_cam(tc, _t(uv)), jcam.pixel_to_unit_cam(jc, jnp.asarray(uv))),
        (tcam.pixel_to_world(tc, _t(uv), _t(depth), _t(r), _t(t)), pw),
        (tcam.reprojection_error_px(tc, _t(pw_noisy), _t(r), _t(t), _t(uv)),
         jcam.reprojection_error_px(jc, jnp.asarray(pw_noisy), r, t, jnp.asarray(uv))),
        (ttri.depth_in_frame(_t(pw), _t(r), _t(t)), jtri.depth_in_frame(jnp.asarray(pw), r, t)),
    )
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ttri.depth_in_frame(_t(pw), _t(r), _t(t)).numpy(), depth,
                               rtol=1e-9)


def test_camera_matches_jax(cams):
    """float64 closed forms and the same 8-step undistortion: 1e-12."""
    jc, tc = cams
    rng = np.random.default_rng(0)
    uv = rng.random((40, 2)) * [1278, 1022]
    pc = np.concatenate([rng.random((40, 2)) - 0.5, 2 + rng.random((40, 1)) * 8], 1)
    np.testing.assert_allclose(tcam.pixel_to_cam(tc, _t(uv)).numpy(),
                               np.asarray(jcam.pixel_to_cam(jc, jnp.asarray(uv))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tcam.cam_to_pixel(tc, _t(pc)).numpy(),
                               np.asarray(jcam.cam_to_pixel(jc, jnp.asarray(pc))),
                               rtol=0, atol=1e-9)
    q = np.array([0.9, 0.1, -0.2, 0.3])
    q = q / np.linalg.norm(q)
    r_wc = np.asarray(jrot.quat_to_matrix(jnp.asarray(q)))
    t_wc = np.array([1.0, -2.0, 0.5])
    pw = pc @ r_wc.T + t_wc
    np.testing.assert_allclose(
        tcam.world_to_pixel(tc, _t(pw), _t(r_wc), _t(t_wc)).numpy(),
        np.asarray(jcam.world_to_pixel(jc, jnp.asarray(pw), jnp.asarray(r_wc),
                                       jnp.asarray(t_wc))),
        rtol=0, atol=1e-9)


def test_camera_create_defaults():
    tc = tcam.Camera.create(tcam.DEFAULT_INTRINSIC, tcam.DEFAULT_DISTORTION,
                            tcam.DEFAULT_RESOLUTION, device="cpu")
    jc = make_camera()
    for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3", "skew"):
        assert float(getattr(tc, k)) == float(getattr(jc, k))
    assert (tc.width, tc.height) == (jc.width, jc.height)


def _det_inputs(seed):
    img = random_texture(120, 160, seed=seed)
    rng = np.random.default_rng(seed)
    pts = (rng.random((12, 2)) * [150, 110] + 5).astype(np.float32)
    valid = rng.random(12) < 0.7
    return img, pts, valid


def test_shi_tomasi_and_occupancy_match_jax():
    """Response: float32 with another fusion of the same terms (1e-6 of
    the peak); the occupancy mask uses the same distance rule: exact."""
    img, pts, valid = _det_inputs(4)
    a = np.asarray(jdet.shi_tomasi_response(jnp.asarray(img)))
    b = tdet.shi_tomasi_response(_t(img)).numpy()
    assert np.max(np.abs(a - b)) <= 1e-6 * np.max(np.abs(a))
    np.testing.assert_array_equal(
        tdet.occupancy_mask((120, 160), _t(pts), _t(valid)).numpy(),
        np.asarray(jdet.occupancy_mask((120, 160), jnp.asarray(pts), jnp.asarray(valid))))


@pytest.mark.parametrize("seed", [4, 5])
def test_detect_and_subpix_match_jax(seed):
    """Same cells, order and gates; the scores differ by float32 rounding
    and the subpixel points by < 1e-3 px (rounding of the window sums)."""
    img, pts, valid = _det_inputs(seed)
    jp, js, jo = jdet.detect_features(jnp.asarray(img), jnp.asarray(pts),
                                      jnp.asarray(valid), cell=32, max_new=16)
    tp, ts, to = tdet.detect_features(_t(img), _t(pts), _t(valid), cell=32, max_new=16)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-3)
    j_sub = np.asarray(jdet.corner_subpix(jnp.asarray(img), jp, jo))
    t_sub = tdet.corner_subpix(_t(img), tp, to).numpy()
    np.testing.assert_allclose(t_sub, j_sub, rtol=0, atol=1e-3)


@pytest.mark.parametrize("min_parallax", [0.0, 0.02])
def test_triangulate_checked_matches_jax(min_parallax):
    """float64 closed form (adjugate solve): 1e-9 relative; equal gates."""
    rng = np.random.default_rng(1)
    n = 64
    pw = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3, 3, n), rng.uniform(2, 40, n)], 1)
    q0 = np.array([1.0, 0.0, 0.0, 0.0])
    q1 = np.array([0.995, 0.02, -0.05, 0.08])
    q1 /= np.linalg.norm(q1)
    r0 = np.asarray(jrot.quat_to_matrix(jnp.asarray(q0)))
    r1 = np.asarray(jrot.quat_to_matrix(jnp.asarray(q1)))
    t0, t1 = np.zeros(3), np.array([0.8, 0.1, 0.3])

    def obs(r, t):
        pc = (pw - t) @ r
        return pc[:, :2] / pc[:, 2:] + rng.normal(0, 1e-3, (n, 2))

    xy0, xy1 = obs(r0, t0), obs(r1, t1)
    b = lambda x: np.broadcast_to(x, (n,) + x.shape).copy()  # noqa: E731
    args = (b(r0), b(t0), b(r1), b(t1), xy0, xy1)
    jw, ji, jo = jtri.triangulate_checked(*map(jnp.asarray, args), min_parallax=min_parallax)
    tw, ti, to = ttri.triangulate_checked(*map(_t, args), min_parallax=min_parallax)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-9, atol=0)
    assert np.asarray(jo).any()
