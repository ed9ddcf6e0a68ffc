"""PyTorch port on the card: the Hopper KLT kernel against its plain
PyTorch version. Imports neither jax nor the JAX package, so it also runs
on a machine without them:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Without a CUDA device every test here skips."""

import numpy as np
import pytest
import torch

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
@pytest.mark.parametrize("n", [1, 64, 513])
def test_kernel_matches_plain_version(n):
    """Kernel vs plain version on one card; the window sums are reduced in
    another order, so points agree to rounding except where a step sits on
    the 0.01 px stop threshold (< 0.05 px)."""
    dev = _device()
    img0 = _texture(240, 320, 7)
    img1 = np.roll(img0, (2, -3), axis=(0, 1))
    pyr0 = build_pyramid(torch.from_numpy(img0).to(dev), 3)
    pyr1 = build_pyramid(torch.from_numpy(img1).to(dev), 3)
    rng = np.random.default_rng(n)
    pts = torch.as_tensor(rng.random((n, 2)) * [300, 220] + 10, dtype=torch.float32,
                          device=dev)
    valid = torch.as_tensor(rng.random(n) < 0.9, device=dev)
    before = klt_cuda.lk_track_bidirectional.launches
    pk, ok_k, fb_k = klt_cuda.lk_track_bidirectional(pyr0, pyr1, pts, pts, valid)
    pp, ok_p, _ = klt.lk_track_bidirectional(pyr0, pyr1, pts, pts, valid)
    torch.cuda.synchronize()
    assert klt_cuda.lk_track_bidirectional.launches == before + 1
    assert not bool((ok_k & ~valid).any())
    assert float((ok_k == ok_p).float().mean()) >= 0.95
    both = ok_k & ok_p
    if bool(both.any()):
        assert float((pk - pp).abs()[both].max()) <= 0.05
        assert bool(torch.isfinite(fb_k[both]).all())


@pytest.mark.cuda
def test_kernel_rejects_cpu_cuda_mix():
    dev = _device()
    pyr = build_pyramid(torch.from_numpy(_texture(64, 64, 1)).to(dev), 2)
    pts = torch.full((4, 2), 32.0)
    with pytest.raises(ValueError):
        klt_cuda.lk_track_bidirectional(pyr, pyr, pts, pts, torch.ones(4, dtype=torch.bool))
