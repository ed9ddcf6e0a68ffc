# Frozen copy of ic_gvins_tpu_torch/vision/klt.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""Batched pyramidal Lucas-Kanade optical flow, plain PyTorch (``vision/klt.py``).

21x21 window, coarse-to-fine over the pyramid, up to 30 Gauss-Newton steps
per level that stop at |step| < 0.01 px and freeze on a step that leaves
the image, and the forward-backward gate (< 0.5 px). All features are
tracked at once: every function works on [F, ...] tensors.

This is the plain version of the Hopper kernel in ``klt_cuda.py``: the
CPU path runs it, and the kernel is held against it on the card.
"""

import torch

WIN = 21  # window size
HALF = WIN // 2
MAX_ITERS = 30
EPS_STEP = 0.01  # convergence threshold on the update norm (px)
MIN_EIG = 1e-4  # minimum normalized eigenvalue of the gradient matrix


def _bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """Sample img at float coords (y, x); the base index is clipped to
    [0, w-2] x [0, h-2], the weights come from the unclipped floor."""
    h, w = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    ax = x - x0
    ay = y - y0
    x0c = torch.clamp(x0.to(torch.int64), 0, w - 2)
    y0c = torch.clamp(y0.to(torch.int64), 0, h - 2)
    flat = img.reshape(-1)
    idx = y0c * w + x0c
    shape, idx = idx.shape, idx.reshape(-1)
    # index_select: the same reads as flat[idx], several times faster on the CPU
    i00, i01, i10, i11 = (flat.index_select(0, i).reshape(shape)
                          for i in (idx, idx + 1, idx + w, idx + w + 1))
    return (
        i00 * (1 - ay) * (1 - ax)
        + i01 * (1 - ay) * ax
        + i10 * ay * (1 - ax)
        + i11 * ay * ax
    )


def _patch_grid(device):
    r = torch.arange(WIN, dtype=torch.float32, device=device) - HALF
    return torch.meshgrid(r, r, indexing="ij")  # (dy, dx)


def _in_bounds(img, pt):
    h, w = img.shape
    return (
        (pt[..., 0] >= HALF) & (pt[..., 0] <= w - 1 - HALF)
        & (pt[..., 1] >= HALF) & (pt[..., 1] <= h - 1 - HALF)
    )


def _track_level(img0, img1, pt0, pt1_init, ok_in):
    """LK at one pyramid level for all features: pt0, pt1_init [F, 2]."""
    dy, dx = _patch_grid(img0.device)
    ys = pt0[:, 1, None, None] + dy
    xs = pt0[:, 0, None, None] + dx
    t = _bilinear(img0, ys, xs)
    gx = 0.5 * (_bilinear(img0, ys, xs + 1.0) - _bilinear(img0, ys, xs - 1.0))
    gy = 0.5 * (_bilinear(img0, ys + 1.0, xs) - _bilinear(img0, ys - 1.0, xs))

    gxx = torch.sum(gx * gx, (1, 2))
    gxy = torch.sum(gx * gy, (1, 2))
    gyy = torch.sum(gy * gy, (1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / (WIN * WIN)
    good = min_eig > MIN_EIG
    pos = det > 1e-12
    inv = torch.where(pos, 1.0 / torch.where(pos, det, torch.ones_like(det)),
                      torch.zeros_like(det))

    ok0 = ok_in & _in_bounds(img0, pt0) & _in_bounds(img1, pt1_init) & good
    pt = pt1_init
    done = ~ok0
    # the JAX tracker runs a fixed 30-trip loop that freezes converged
    # features; stopping once every feature is frozen gives the same result
    for _ in range(MAX_ITERS):
        if bool(done.all()):
            break
        patch = _bilinear(img1, pt[:, 1, None, None] + dy, pt[:, 0, None, None] + dx)
        diff = patch - t
        b1 = torch.sum(diff * gx, (1, 2))
        b2 = torch.sum(diff * gy, (1, 2))
        dpt = -inv[:, None] * torch.stack([gyy * b1 - gxy * b2, gxx * b2 - gxy * b1], -1)
        step_ok = _in_bounds(img1, pt + dpt)
        frozen = done | ~step_ok
        pt = torch.where(frozen[:, None], pt, pt + dpt)
        done = done | (torch.linalg.norm(dpt, dim=-1) < EPS_STEP) | ~step_ok
    return pt, ok0 & _in_bounds(img1, pt)


def lk_track(pyr0, pyr1, pts0, pts1_init, valid):
    """Track pts0 [F, 2] (x, y level-0 pixels) from pyramid pyr0 to pyr1,
    starting from pts1_init. Every level starts from the input ``valid``;
    only level 0's ok counts. Returns (pts1 [F, 2] f32, ok [F])."""
    levels = len(pyr0)
    pts0 = pts0.to(torch.float32)
    pt1 = pts1_init.to(torch.float32) / 2.0 ** (levels - 1)
    ok = valid
    for lv in range(levels - 1, -1, -1):
        if lv < levels - 1:
            pt1 = pt1 * 2.0
        pt1, ok_lv = _track_level(pyr0[lv], pyr1[lv], pts0 / 2.0**lv, pt1, valid)
        if lv == 0:
            ok = ok & ok_lv
    return pt1, ok


def lk_track_bidirectional(pyr0, pyr1, pts0, pts1_init, valid, fb_thresh=0.5):
    """Forward + backward LK with the consistency gate. The backward pass
    starts from the forward result, seeds from pts0 and takes the forward
    ok as its valid. Returns (pts1, ok, fb_err)."""
    pts1, ok_f = lk_track(pyr0, pyr1, pts0, pts1_init, valid)
    pts0_back, ok_b = lk_track(pyr1, pyr0, pts1, pts0, ok_f)
    fb_err = torch.linalg.norm(pts0_back - pts0.to(torch.float32), dim=-1)
    return pts1, ok_f & ok_b & (fb_err < fb_thresh), fb_err
