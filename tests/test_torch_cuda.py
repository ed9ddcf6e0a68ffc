"""PyTorch port on the card: the Hopper KLT kernel against its plain
PyTorch version, and the solver's fixed-order sum. Imports neither jax nor the JAX package, so it also runs
on a machine without them:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips."""

import numpy as np
import pytest
import torch

from ic_gvins_tpu_torch.solver.assembly import index_sum_
from ic_gvins_tpu_torch.vision import klt, klt_cuda
from ic_gvins_tpu_torch.vision.pyramid import build_pyramid


def _texture(h, w, seed):
    """Smooth random texture plus fine detail (bilinear-upsampled grid)."""
    rng = np.random.RandomState(seed)
    coarse = rng.rand(h // 16 + 2, w // 16 + 2) * 255
    ys, xs = np.arange(h) / 16, np.arange(w) / 16
    y0, x0 = ys.astype(int), xs.astype(int)
    ay, ax = (ys - y0)[:, None], (xs - x0)[None, :]
    img = (coarse[y0][:, x0] * (1 - ay) * (1 - ax) + coarse[y0][:, x0 + 1] * (1 - ay) * ax
           + coarse[y0 + 1][:, x0] * ay * (1 - ax) + coarse[y0 + 1][:, x0 + 1] * ay * ax)
    return (img + rng.rand(h, w) * 40).astype(np.float32)


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 64, 513, 4000, "border"])
def test_kernel_matches_plain_version(n):
    """Kernel vs plain version on one card; the window sums are reduced in
    another order, so points agree to rounding except where a step sits on
    the 0.01 px stop threshold (< 0.05 px). "border" puts 64 features on
    the entry gate's edges (x = 10, x = w - 11, y = 10, y = h - 11), where
    the staged tiles reach past the image."""
    dev = _device()
    img0 = _texture(240, 320, 7)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    pyr0 = build_pyramid(torch.from_numpy(img0).to(dev), 3)
    pyr1 = build_pyramid(torch.from_numpy(img1).to(dev), 3)
    if n == "border":
        n = 64
        rng = np.random.default_rng(0)
        pts = rng.random((n, 2)) * [300, 220] + 10
        pts[0::4, 0], pts[1::4, 0], pts[2::4, 1], pts[3::4, 1] = 10, 320 - 11, 10, 240 - 11
    else:
        rng = np.random.default_rng(n)
        pts = rng.random((n, 2)) * [300, 220] + 10
    pts = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
    before = klt_cuda.lk_track_bidirectional.launches
    pk, ok_k, fb_k = klt_cuda.lk_track_bidirectional(pyr0, pyr1, pts, pts, valid)
    pp, ok_p, _ = klt.lk_track_bidirectional(pyr0, pyr1, pts, pts, valid)
    torch.cuda.synchronize()
    assert klt_cuda.lk_track_bidirectional.launches == before + 1
    assert pk.shape == (n, 2) and pk.is_contiguous() and ok_k.dtype == torch.bool
    assert not bool((ok_k & ~valid).any())
    assert float((ok_k == ok_p).float().mean()) >= 0.95
    both = ok_k & ok_p
    if bool(both.any()):
        assert float((pk - pp).abs()[both].max()) <= 0.05
        assert bool(torch.isfinite(fb_k[both]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("move", [(-16, 0), (0, 16), (12, -12)])
def test_kernel_follows_a_long_move_within_one_level(move):
    """One pyramid image of a very smooth texture, moved by more than the
    staged search tile's margin: the estimate leaves the tile, the kernel
    reloads it around the new estimate and still agrees with the plain
    version."""
    dev = _device()
    rng = np.random.RandomState(3)
    coarse = rng.rand(8, 10) * 255  # one blob per 48 px: LK converges from 16 px away
    ys, xs = np.linspace(0, 6.999, 288), np.linspace(0, 8.999, 384)
    y0, x0 = ys.astype(int), xs.astype(int)
    sy, sx = ys - y0, xs - x0
    sy, sx = (sy * sy * (3 - 2 * sy))[:, None], (sx * sx * (3 - 2 * sx))[None, :]
    img0 = np.ascontiguousarray(
        coarse[y0][:, x0] * (1 - sy) * (1 - sx) + coarse[y0][:, x0 + 1] * (1 - sy) * sx
        + coarse[y0 + 1][:, x0] * sy * (1 - sx) + coarse[y0 + 1][:, x0 + 1] * sy * sx,
        dtype=np.float32)
    img1 = np.roll(img0, (move[1], move[0]), axis=(0, 1))
    pyr0 = (torch.from_numpy(img0).to(dev),)
    pyr1 = (torch.from_numpy(img1).to(dev),)
    pts = torch.as_tensor(rng.rand(64, 2) * [280, 190] + 50, dtype=torch.float32, device=dev)
    valid = torch.ones(64, dtype=torch.bool, device=dev)
    pk, ok_k, _ = klt_cuda.lk_track_bidirectional(pyr0, pyr1, pts, pts, valid, fb_thresh=2.0)
    pp, ok_p, _ = klt.lk_track_bidirectional(pyr0, pyr1, pts, pts, valid, fb_thresh=2.0)
    torch.cuda.synchronize()
    both = ok_k & ok_p
    far = ((pk - pts).abs().max(1).values > 11.0) & both  # these left the first tile
    assert int(far.sum()) >= 8
    assert float((ok_k == ok_p).float().mean()) >= 0.95
    assert float((pk - pp).abs()[both].max()) <= 0.05


@pytest.mark.cuda
def test_kernel_counts_its_work():
    """The counted call gives the same results plus per-feature work: an
    invalid feature runs nothing, a valid interior one 8 level passes (4
    levels, both directions) and at least one step per pass."""
    dev = _device()
    pyr = build_pyramid(torch.from_numpy(_texture(240, 320, 7)).to(dev), 3)
    pts = torch.tensor([[160.0, 120.0], [100.0, 90.0]], device=dev)
    valid = torch.tensor([True, False], device=dev)
    pk, ok, fb, work = klt_cuda.lk_track_bidirectional_counted(pyr, pyr, pts, pts, valid)
    pp, ok_p, fb_p = klt_cuda.lk_track_bidirectional(pyr, pyr, pts, pts, valid)
    assert torch.equal(pk, pp) and torch.equal(ok, ok_p) and torch.equal(fb, fb_p)
    assert ok.tolist() == [True, False]
    assert work[1].tolist() == [0, 0]
    assert int(work[0, 0]) == 0x2222 and 8 <= int(work[0, 1]) <= 8 * 30
    assert klt_cuda.passes_per_level(work, 4) == [2, 2, 2, 2]
    with pytest.raises(ValueError):
        klt_cuda.lk_track_bidirectional_counted(
            tuple(x.cpu() for x in pyr), tuple(x.cpu() for x in pyr), pts.cpu(), pts.cpu(),
            valid.cpu())


@pytest.mark.cuda
def test_no_features_no_launch():
    dev = _device()
    pyr = build_pyramid(torch.from_numpy(_texture(64, 64, 1)).to(dev), 2)
    pts = torch.zeros((0, 2), device=dev)
    before = klt_cuda.lk_track_bidirectional.launches
    pk, ok, fb = klt_cuda.lk_track_bidirectional(pyr, pyr, pts, pts,
                                                 torch.zeros(0, dtype=torch.bool, device=dev))
    assert pk.shape == (0, 2) and ok.shape == (0,) and fb.shape == (0,)
    assert klt_cuda.lk_track_bidirectional.launches == before


@pytest.mark.cuda
def test_kernel_rejects_cpu_cuda_mix():
    dev = _device()
    pyr = build_pyramid(torch.from_numpy(_texture(64, 64, 1)).to(dev), 2)
    pts = torch.full((4, 2), 32.0)
    with pytest.raises(ValueError):
        klt_cuda.lk_track_bidirectional(pyr, pyr, pts, pts, torch.ones(4, dtype=torch.bool))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_index_sum_repeats_on_the_card(dtype):
    """``index_sum_`` on the card, 6 x 6 blocks of 4096 landmarks into their
    24 anchor nodes: the same bits on every call (``index_add_``'s atomics
    give no such promise), and the CPU's float64 sum to rounding."""
    dev = _device()
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 24, 4096))
    src = torch.from_numpy(rng.standard_normal((4096, 6, 6)))
    outs = [index_sum_(torch.zeros((24, 6, 6), dtype=dtype, device=dev), idx.to(dev),
                       src.to(dev, dtype)) for _ in range(5)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = torch.zeros((24, 6, 6), dtype=torch.float64).index_add_(0, idx, src.to(dtype).double())
    tol = 1e-4 if dtype == torch.float32 else 1e-12
    assert float((outs[0].cpu().double() - ref).abs().max()) <= tol
