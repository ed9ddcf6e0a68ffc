# Frozen copy of ic_gvins_tpu_torch/data/types.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""Core data containers as NamedTuples of tensors (``data/types.py``).

Every field keeps the JAX layout: a single state has trailing shapes, a
batch adds leading axes to every field.
"""

from typing import NamedTuple

import torch

from ..device import resolve_device


class ImuSeq(NamedTuple):
    """IMU increment series (dtheta = gyro increment, dvel = specific-force
    increment over dt)."""

    time: torch.Tensor  # [..., N] end-of-interval timestamps (s)
    dt: torch.Tensor  # [..., N] interval lengths (s)
    dtheta: torch.Tensor  # [..., N, 3] rad
    dvel: torch.Tensor  # [..., N, 3] m/s

    @property
    def n(self) -> int:
        """Samples in the series."""
        return self.time.shape[-1]

    def slice(self, start: int, size: int) -> "ImuSeq":
        """``size`` samples from ``start`` as JAX's ``dynamic_slice`` takes
        them: a negative start counts from the end, and the start moves
        into [0, n - size] so that the slice fits."""
        start = int(start) + (self.n if start < 0 else 0)
        start = min(max(start, 0), self.n - size)
        return ImuSeq(self.time.narrow(-1, start, size), self.dt.narrow(-1, start, size),
                      self.dtheta.narrow(-2, start, size), self.dvel.narrow(-2, start, size))


class NavState(NamedTuple):
    """Navigation state in the local n-frame; q is the body->nav unit
    quaternion, scalar-first."""

    time: torch.Tensor  # [...]
    p: torch.Tensor  # [..., 3]
    q: torch.Tensor  # [..., 4]
    v: torch.Tensor  # [..., 3]
    bg: torch.Tensor  # [..., 3] gyro bias (rad/s)
    ba: torch.Tensor  # [..., 3] accel bias (m/s^2)

    @staticmethod
    def zero(dtype=torch.float64, device=None) -> "NavState":
        """The state at the origin at rest, identity attitude, zero biases,
        on ``device`` (``cuda:0`` unless told)."""
        kw = dict(dtype=dtype, device=resolve_device(device))
        return NavState(time=torch.zeros((), **kw), p=torch.zeros(3, **kw),
                        q=torch.tensor([1.0, 0.0, 0.0, 0.0], **kw), v=torch.zeros(3, **kw),
                        bg=torch.zeros(3, **kw), ba=torch.zeros(3, **kw))

    def index(self, i) -> "NavState":
        """The state(s) at index ``i`` of the leading axis."""
        return NavState(*(x[i] for x in self))


class Gnss(NamedTuple):
    """A GNSS fix already converted to the local n-frame."""

    time: torch.Tensor
    p: torch.Tensor  # [..., 3] position in the local n-frame
    std: torch.Tensor  # [..., 3] per-axis std (m)


class IntegrationParams(NamedTuple):
    """IMU noise model + environment."""

    gyr_arw: torch.Tensor  # rad/sqrt(s)
    acc_vrw: torch.Tensor  # m/s/sqrt(s)
    gyr_bias_std: torch.Tensor  # rad/s
    acc_bias_std: torch.Tensor  # m/s^2
    corr_time: torch.Tensor  # s
    gravity: torch.Tensor  # (3,) n-frame gravity vector
    iewn: torch.Tensor  # (3,) earth rotation rate in n-frame (zeros if off)
