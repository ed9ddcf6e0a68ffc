"""ic_gvins_tpu_torch: the GVINS engine in PyTorch, for an NVIDIA H100.

A port of ``ic_gvins_tpu`` (JAX/XLA/Pallas), which stays the reference it
is tested against. The module layout mirrors the JAX package so each
counterpart is easy to find. State is NamedTuples of tensors, functions
are plain tensor code with the batch dimensions written out, and the one
TPU kernel of the package (the pyramidal LK tracker) is a CUDA kernel
written for Hopper (``vision/klt_cuda.py`` + ``csrc/klt.cu``).

This package imports torch and numpy only: never jax, and nothing of
``ic_gvins_tpu`` (whose ``__init__`` imports jax).
"""

import torch as _torch

__version__ = "0.1.0"

# Counterpart of the JAX package's matmul precision pin: TF32 matmul or
# convolution inputs keep ~3 decimal digits, and reduced-precision inputs
# are what diverged the JAX solver. Both switches are set explicitly
# (cuDNN's default is TF32 on).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
