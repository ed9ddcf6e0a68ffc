# Frozen copy of ic_gvins_tpu_torch/device.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""Where the port's entry points put their tensors when the caller does
not say: on the first CUDA card. Nothing falls back to the CPU on its own;
a caller who wants the CPU (the tests do) passes ``device="cpu"``."""

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda:0`` and
    raises when there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: ic_gvins_tpu_torch runs on the GPU by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", 0)
