"""The work of a bidirectional pyramidal KLT call, counted from its inputs,
and the H100's roofline bound of it.

The arithmetic is chip_smoke.py's (``klt_bound`` and the constants above
it) at commit ab7fbd6. Changed from it: the level passes and Gauss-Newton
steps are not the counts the kernel reports but those of the frozen plain
tracker (``reference/vision/klt.py``, whose loop this copies with
counters) on the same pyramids and points, so that any implementation of
the kernel is held to the same yardstick.
"""

import torch

from .reference.vision import klt

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM3, and
# float32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# Per window pixel: a bilinear sample is 4 multiply-adds (8 flop); a level
# pass builds the template (5 samples, 4 flop of gradients, 6 of the
# structure tensor); a Gauss-Newton step takes 1 sample, 1 subtraction and
# 2 multiply-adds; the weights cost 8 flop per pass and per step.
NPIX = klt.WIN * klt.WIN
FLOP_WEIGHTS = 8
FLOP_PER_PASS = NPIX * (5 * 8 + 4 + 6) + FLOP_WEIGHTS
FLOP_PER_STEP = NPIX * (8 + 1 + 4) + FLOP_WEIGHTS
# A level pass must read the 25 x 25 template neighbourhood and the 23 x 23
# footprint of the search window, 4 bytes a pixel.
BYTES_PER_PASS = (25 * 25 + 23 * 23) * 4
# Bytes in and out per feature: two points in, the valid flag, the point,
# the forward-backward error and the ok flag out.
BYTES_PER_FEATURE = 8 + 8 + 1 + 8 + 4 + 1


def _track_level(img0, img1, pt0, pt1_init, ok_in):
    """``klt._track_level`` with its work: (pt, ok, passes, steps)."""
    dy, dx = klt._patch_grid(img0.device)
    ys = pt0[:, 1, None, None] + dy
    xs = pt0[:, 0, None, None] + dx
    gx = 0.5 * (klt._bilinear(img0, ys, xs + 1.0) - klt._bilinear(img0, ys, xs - 1.0))
    gy = 0.5 * (klt._bilinear(img0, ys + 1.0, xs) - klt._bilinear(img0, ys - 1.0, xs))
    t = klt._bilinear(img0, ys, xs)
    gxx = torch.sum(gx * gx, (1, 2))
    gxy = torch.sum(gx * gy, (1, 2))
    gyy = torch.sum(gy * gy, (1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    min_eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) / NPIX
    good = min_eig > klt.MIN_EIG
    pos = det > 1e-12
    inv = torch.where(pos, 1.0 / torch.where(pos, det, torch.ones_like(det)),
                      torch.zeros_like(det))
    gates = ok_in & klt._in_bounds(img0, pt0) & klt._in_bounds(img1, pt1_init)
    passes = int(gates.sum())
    ok0 = gates & good
    pt = pt1_init
    done = ~ok0
    steps = 0
    for _ in range(klt.MAX_ITERS):
        if bool(done.all()):
            break
        steps += int((~done).sum())
        patch = klt._bilinear(img1, pt[:, 1, None, None] + dy, pt[:, 0, None, None] + dx)
        diff = patch - t
        b1 = torch.sum(diff * gx, (1, 2))
        b2 = torch.sum(diff * gy, (1, 2))
        dpt = -inv[:, None] * torch.stack([gyy * b1 - gxy * b2, gxx * b2 - gxy * b1], -1)
        step_ok = klt._in_bounds(img1, pt + dpt)
        frozen = done | ~step_ok
        pt = torch.where(frozen[:, None], pt, pt + dpt)
        done = done | (torch.linalg.norm(dpt, dim=-1) < klt.EPS_STEP) | ~step_ok
    return pt, ok0 & klt._in_bounds(img1, pt), passes, steps


def _track(pyr0, pyr1, pts0, pts1_init, valid, passes, steps):
    levels = len(pyr0)
    pts0 = pts0.to(torch.float32)
    pt1 = pts1_init.to(torch.float32) / 2.0 ** (levels - 1)
    ok = valid
    for lv in range(levels - 1, -1, -1):
        if lv < levels - 1:
            pt1 = pt1 * 2.0
        pt1, ok_lv, p, s = _track_level(pyr0[lv], pyr1[lv], pts0 / 2.0**lv, pt1, valid)
        passes[lv] += p
        steps[0] += s
        if lv == 0:
            ok = ok & ok_lv
    return pt1, ok


def count(pyr0, pyr1, pts0, pts1_init, valid, fb_thresh=0.5):
    """Level passes per level (level 0 first) and Gauss-Newton steps of one
    bidirectional call, both directions."""
    passes, steps = [0] * len(pyr0), [0]
    pts1, ok_f = _track(pyr0, pyr1, pts0, pts1_init, valid, passes, steps)
    _track(pyr1, pyr0, pts1, pts0, ok_f, passes, steps)
    return passes, steps[0]


def bound(passes, steps, n, pyr):
    """(seconds, "bytes" or "operations"): the least time the H100 takes
    for the work. Bytes: at each level what its passes must read, at most
    that level of both pyramids once, plus the points in and out;
    operations: the float32 flop of the passes and steps."""
    pixels = sum(min(p * BYTES_PER_PASS, 2 * x.numel() * 4) for p, x in zip(passes, pyr))
    nbytes = pixels + n * BYTES_PER_FEATURE
    flop = sum(passes) * FLOP_PER_PASS + steps * FLOP_PER_STEP
    t_bytes, t_flop = nbytes / PEAK_BYTES_S, flop / PEAK_F32_FLOP_S
    return max(t_bytes, t_flop), ("bytes" if t_bytes >= t_flop else "operations")
