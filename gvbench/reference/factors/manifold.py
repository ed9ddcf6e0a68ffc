# Frozen copy of ic_gvins_tpu_torch/factors/manifold.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""Error-state manifold for the sliding-window problem (``factors/manifold.py``).

Pose deltas apply as ``p += dp``, ``q = q ⊗ exp(dtheta)``; velocity and
bias deltas are additive. Per-node ordering (15):
``[dp 0:3, dtheta 3:6, dv 6:9, dbg 9:12, dba 12:15]``.
"""

import torch

from ..common import rotation as rot
from ..data.types import NavState


def pose_boxplus(p: torch.Tensor, q: torch.Tensor, delta6: torch.Tensor):
    """Apply a 6-dof pose delta."""
    return p + delta6[..., 0:3], rot.quat_normalize(
        rot.quat_mul(q, rot.rotvec_to_quat(delta6[..., 3:6]))
    )


def pose_boxminus(p, q, p0, q0) -> torch.Tensor:
    """Local coordinates of (p, q) around (p0, q0): [p - p0, log(q0^-1 q)]."""
    dq = rot.quat_mul(rot.quat_inv(q0), q)
    return torch.cat([p - p0, rot.quat_to_rotvec(dq)], -1)


def node_boxplus(state: NavState, delta: torch.Tensor) -> NavState:
    """Apply a 15-dof node delta (batched over leading axes)."""
    p, q = pose_boxplus(state.p, state.q, delta[..., 0:6])
    return state._replace(
        p=p,
        q=q,
        v=state.v + delta[..., 6:9],
        bg=state.bg + delta[..., 9:12],
        ba=state.ba + delta[..., 12:15],
    )


def node_boxminus(state: NavState, ref: NavState) -> torch.Tensor:
    """15-dof local coordinates of ``state`` around ``ref``."""
    dpose = pose_boxminus(state.p, state.q, ref.p, ref.q)
    return torch.cat(
        [dpose, state.v - ref.v, state.bg - ref.bg, state.ba - ref.ba], -1
    )
