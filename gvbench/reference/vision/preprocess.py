# Frozen copy of ic_gvins_tpu_torch/vision/preprocess.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""Image preprocessing: CLAHE and the illumination-glitch gate
(``vision/preprocess.py``).

* ``clahe``: contrast-limited adaptive histogram equalization (clip 3.0,
  8 x 8 tiles): per-tile 256-bin histograms, clip and spread the excess
  evenly, per-tile CDF lookup tables, bilinear blend of the four
  surrounding tiles' tables.
* ``histogram_correlation``: correlation of two frames' 256-bin
  histograms; a sudden illumination change gives a low value and the
  front end skips the frame.

Histograms are integer bin counts (``torch.bincount`` over
``tile * 256 + value``), not one-hot sums: a one-hot of a 1278 x 1022
frame would be 1.3 GB.
"""

import torch

BINS = 256


def _bin_values(img: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 255], then truncate to an integer bin."""
    return torch.clamp(img, 0, 255).to(torch.int64)


def _tile_histograms(img: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """[ty, tx, 256] float32 counts of the whole th x tw tiles; remainder
    rows and columns are left out."""
    h, w = img.shape
    ty, tx = h // th, w // tw
    vals = _bin_values(img[: ty * th, : tx * tw])
    row = torch.arange(ty * th, device=img.device) // th
    col = torch.arange(tx * tw, device=img.device) // tw
    tile = row[:, None] * tx + col[None, :]
    counts = torch.bincount((tile * BINS + vals).reshape(-1), minlength=ty * tx * BINS)
    return counts.reshape(ty, tx, BINS).to(torch.float32)


def clahe(img: torch.Tensor, tiles: int = 8, clip_limit: float = 3.0) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of a [h, w] image
    with values in the uint8 range; returns float32 in [0, 255]."""
    img = img.to(torch.float32)
    h, w = img.shape
    th, tw = h // tiles, w // tiles
    hist = _tile_histograms(img, th, tw)
    ty, tx = hist.shape[:2]

    # clip, and spread the excess evenly over the bins
    limit = clip_limit * (th * tw) / BINS
    excess = torch.clamp(hist - limit, min=0.0).sum(-1, keepdim=True)
    hist = torch.clamp(hist, max=limit) + excess / BINS

    # each tile's CDF, normalized by its own first and last entries
    cdf = torch.cumsum(hist, -1)
    cdf = (cdf - cdf[..., :1]) / torch.clamp(cdf[..., -1:] - cdf[..., :1], min=1.0)
    lut = cdf * 255.0

    # bilinear blend of the four surrounding tiles' tables
    def axis(n, t, nt):
        f = torch.clamp((torch.arange(n, dtype=torch.float32, device=img.device) - t / 2) / t,
                        0.0, nt - 1.0)
        if nt == 1:
            return torch.zeros(n, dtype=torch.int64, device=img.device), torch.zeros_like(f)
        i0 = torch.clamp(torch.floor(f).to(torch.int64), 0, nt - 2)
        return i0, f - i0

    y0, ay = axis(h, th, ty)
    x0, ax = axis(w, tw, tx)
    y0, ay, y1 = y0[:, None], ay[:, None], torch.clamp(y0 + 1, max=ty - 1)[:, None]
    x0, ax, x1 = x0[None, :], ax[None, :], torch.clamp(x0 + 1, max=tx - 1)[None, :]
    v = _bin_values(img)
    return (
        lut[y0, x0, v] * (1 - ay) * (1 - ax)
        + lut[y0, x1, v] * (1 - ay) * ax
        + lut[y1, x0, v] * ay * (1 - ax)
        + lut[y1, x1, v] * ay * ax
    )


def histogram_correlation(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """Correlation of the two frames' 256-bin histograms (0-dim float32)."""
    def hist(img):
        return torch.bincount(_bin_values(img).reshape(-1), minlength=BINS).to(torch.float32)

    h0, h1 = hist(img0), hist(img1)
    d0, d1 = h0 - h0.mean(), h1 - h1.mean()
    return torch.sum(d0 * d1) / torch.clamp(
        torch.sqrt(torch.sum(d0**2) * torch.sum(d1**2)), min=1e-9
    )
