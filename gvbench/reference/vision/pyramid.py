# Frozen copy of ic_gvins_tpu_torch/vision/pyramid.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""Image pyramid with OpenCV pyrDown semantics (``vision/pyramid.py``).

Each level blurs with the separable 5-tap binomial [1 4 6 4 1]/16 under
edge replication and keeps every second pixel, so odd sizes round up:
1278 x 1022 -> 639 x 511 -> 320 x 256 -> 160 x 128.
"""

import torch

_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _blur5(img: torch.Tensor) -> torch.Tensor:
    """Separable 5x5 binomial blur with edge replication."""
    h, w = img.shape
    pad = torch.cat([img[:1].expand(2, w), img, img[-1:].expand(2, w)], 0)
    img = sum(_K5[i] * pad[i : i + h, :] for i in range(5))
    pad = torch.cat([img[:, :1].expand(h, 2), img, img[:, -1:].expand(h, 2)], 1)
    return sum(_K5[i] * pad[:, i : i + w] for i in range(5))


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    return _blur5(img)[::2, ::2].contiguous()


def build_pyramid(img: torch.Tensor, levels: int = 3):
    """(levels + 1) float32 images, level 0 at full resolution."""
    img = img.to(torch.float32).contiguous()
    out = [img]
    for _ in range(levels):
        img = pyr_down(img)
        out.append(img)
    return tuple(out)
