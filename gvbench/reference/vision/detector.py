# Frozen copy of ic_gvins_tpu_torch/vision/detector.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""Shi-Tomasi corner detection with grid-cell selection, occupancy mask and
subpixel refinement (``vision/detector.py``).

The filters are shifted slices with edge replication (no convolution
library call); the occupancy mask stamps a disc around each existing
feature; the subpixel refinement runs all points at once, each with its
own stop flag.
"""

import torch

MASK_RADIUS = 25.0  # min distance to existing features (px)
_SUBPIX_PATCH = 32  # per-point working patch (covers window + drift + taps)


def _pad1(img):
    """Replicate-pad by one pixel on every side."""
    img = torch.cat([img[:1], img, img[-1:]], 0)
    return torch.cat([img[:, :1], img, img[:, -1:]], 1)


def _sobel(img):
    p = _pad1(img)
    gx = (
        (p[:-2, 2:] + 2 * p[1:-1, 2:] + p[2:, 2:])
        - (p[:-2, :-2] + 2 * p[1:-1, :-2] + p[2:, :-2])
    ) * 0.125
    gy = (
        (p[2:, :-2] + 2 * p[2:, 1:-1] + p[2:, 2:])
        - (p[:-2, :-2] + 2 * p[:-2, 1:-1] + p[:-2, 2:])
    ) * 0.125
    return gx, gy


def _box3(img):
    p = _pad1(img)
    return (
        p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:]
        + p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:]
        + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]
    ) / 9.0


def shi_tomasi_response(img: torch.Tensor) -> torch.Tensor:
    """Min eigenvalue of the 3x3-windowed Sobel structure tensor."""
    gx, gy = _sobel(img.to(torch.float32))
    jxx = _box3(gx * gx)
    jxy = _box3(gx * gy)
    jyy = _box3(gy * gy)
    tr = jxx + jyy
    det = jxx * jyy - jxy * jxy
    return 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))


def occupancy_mask(shape, pts, valid, radius=MASK_RADIUS):
    """False within ``radius`` px of any valid existing feature: the
    pixels of the (2r+2)^2 box around each feature are tested with the
    exact distance rule and stamped."""
    h, w = shape
    dev = pts.device
    pts = pts.to(torch.float32)
    r = int(radius) + 1
    off = torch.arange(-r, r + 1, device=dev)
    bx = torch.floor(pts[:, 0]).to(torch.int64)[:, None, None] + off[None, None, :]
    by = torch.floor(pts[:, 1]).to(torch.int64)[:, None, None] + off[None, :, None]
    d2 = (by.to(torch.float32) - pts[:, 1, None, None]) ** 2 + (
        bx.to(torch.float32) - pts[:, 0, None, None]
    ) ** 2
    hit = (
        (d2 < radius * radius) & valid[:, None, None]
        & (bx >= 0) & (bx < w) & (by >= 0) & (by < h)
    )
    occ = torch.zeros(h * w, dtype=torch.bool, device=dev)
    occ[(by * w + bx)[hit]] = True
    return ~occ.reshape(h, w)


def detect_features(img, existing_pts, existing_valid, cell: int = 64,
                    max_new: int = 128, border: int = 16,
                    quality_rel: float = 0.01):
    """Grid-cell Shi-Tomasi detection: the best corner of each cell that
    passes the occupancy and quality gates, strongest cells first.
    Returns (pts [max_new, 2] f32, score [max_new], ok [max_new])."""
    h, w = img.shape
    dev = img.device
    resp = shi_tomasi_response(img)
    free = occupancy_mask((h, w), existing_pts, existing_valid)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    resp = torch.where(free & inb, resp, torch.full_like(resp, -1.0))

    gh, gw = h // cell, w // cell
    blocks = resp[: gh * cell, : gw * cell].reshape(gh, cell, gw, cell)
    blocks = blocks.permute(0, 2, 1, 3).reshape(gh * gw, cell * cell)
    best = torch.argmax(blocks, 1)  # first maximum, as jnp.argmax
    score = torch.gather(blocks, 1, best[:, None])[:, 0]
    cells = torch.arange(gh * gw, device=dev)
    cy = best // cell + (cells // gw) * cell
    cx = best % cell + (cells % gw) * cell
    pts = torch.stack([cx, cy], -1).to(torch.float32)

    thr = quality_rel * torch.max(score)
    ok = score > torch.clamp(thr, min=0.0)
    take = torch.argsort(-score, stable=True)[:max_new]
    return pts[take], score[take], ok[take]


def corner_subpix(img, pts, valid, win: int = 5, max_iters: int = 20,
                  eps: float = 0.01):
    """Subpixel corner refinement (cornerSubPix: 5x5 half-window, no zero
    zone, 20 iterations, eps 0.01) for all points at once.

    Each point works in a 32x32 patch around its rounded position (clipped
    into the image); a point whose refinement drifts beyond the window, or
    whose sampling window ever clamps against the patch border, reverts to
    its input. Returns refined pts [N, 2] f32."""
    imgf = img.to(torch.float32)
    h, w = imgf.shape
    dev = imgf.device
    P = _SUBPIX_PATCH
    size = 2 * win + 1  # 11
    taps = size + 2  # 13: window plus the +-1 gradient taps
    r = (torch.arange(size, dtype=torch.float32, device=dev) - win) / win
    wts = torch.exp(-r * r)[:, None] * torch.exp(-r * r)[None, :]
    px = (torch.arange(size, dtype=torch.float32, device=dev) - win)[None, :]
    py = (torch.arange(size, dtype=torch.float32, device=dev) - win)[:, None]
    ar = torch.arange(taps + 1, device=dev)

    pts32 = pts.to(torch.float32)
    hi = torch.tensor([w - P, h - P], device=dev)
    base = torch.minimum(torch.clamp(torch.round(pts32).to(torch.int64) - P // 2, min=0), hi)
    basef = base.to(torch.float32)
    pt0 = pts32 - basef  # patch-local
    pt = pt0.clone()
    err = torch.full((pts.shape[0],), float("inf"), device=dev)
    shifted = torch.zeros(pts.shape[0], dtype=torch.bool, device=dev)

    def inside(p):
        return (p[:, 0] >= 0) & (p[:, 0] < P) & (p[:, 1] >= 0) & (p[:, 1] < P)

    active = inside(pt) & (err > eps * eps)
    for _ in range(max_iters):
        if not bool(active.any()):
            break
        org = pt - (win + 1)
        oi_true = torch.floor(org).to(torch.int64)
        oi = torch.clamp(oi_true, 0, P - taps - 1)
        sh = torch.any(oi != oi_true, 1)
        a = org - oi.to(torch.float32)
        rows = (base[:, 1] + oi[:, 1])[:, None, None] + ar[None, :, None]
        cols = (base[:, 0] + oi[:, 0])[:, None, None] + ar[None, None, :]
        blk = imgf[rows, cols]  # [N, taps+1, taps+1]
        ax = a[:, 0, None, None]
        ay = a[:, 1, None, None]
        s = (
            blk[:, :taps, :taps] * (1 - ay) * (1 - ax)
            + blk[:, :taps, 1:] * (1 - ay) * ax
            + blk[:, 1:, :taps] * ay * (1 - ax)
            + blk[:, 1:, 1:] * ay * ax
        )
        gx = s[:, 1:-1, 2:] - s[:, 1:-1, :-2]
        gy = s[:, 2:, 1:-1] - s[:, :-2, 1:-1]
        gxx = gx * gx * wts
        gxy = gx * gy * wts
        gyy = gy * gy * wts
        aa = torch.sum(gxx, (1, 2))
        bb = torch.sum(gxy, (1, 2))
        cc = torch.sum(gyy, (1, 2))
        bb1 = torch.sum(gxx * px + gxy * py, (1, 2))
        bb2 = torch.sum(gxy * px + gyy * py, (1, 2))
        det = aa * cc - bb * bb
        ok = torch.abs(det) > 1e-12
        scale = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                            torch.zeros_like(det))
        d = torch.stack([cc * bb1 - bb * bb2, aa * bb2 - bb * bb1], -1) * scale[:, None]
        e = torch.where(ok, torch.sum(d * d, -1), torch.zeros_like(det))
        pt = torch.where(active[:, None], pt + d, pt)
        err = torch.where(active, e, err)
        shifted = shifted | (active & sh)
        active = active & (err > eps * eps) & inside(pt)

    drift = torch.abs(pt - pt0)
    bad = (drift[:, 0] > win + 1) | (drift[:, 1] > win + 1) | shifted
    out = torch.where(bad[:, None], pt0, pt) + basef
    return torch.where(valid[:, None], out, pts32)
