"""The device stages of one GVINS keyframe round, for a window whose
intervals' raw IMU is at hand: the estimator's calls into
``preintegrate``, ``triangulate_checked``, ``optimize_impl`` and
``marginalize_and_slide`` batched over a whole window, without its host
bookkeeping (``engine/estimator.py``), so that one round can be timed and
held against the JAX package alone.

``preintegrate_window`` integrates every interval from its start node in
one batched pass; ``triangulate_window`` re-triangulates each valid
landmark between its anchor node and the newest node that observes it.
"""

import torch

from ..common import rotation as rot
from ..data.types import ImuSeq, IntegrationParams, NavState
from ..ins.preintegration import preintegrate
from ..solver.window import Window
from ..vision.triangulation import triangulate_checked


def preintegrate_window(window: Window, params: IntegrationParams,
                        imu: ImuSeq) -> Window:
    """Preintegrate interval i (``imu`` fields [N-1, n, ...]) from node i
    and store the results in the window."""
    n = window.n_nodes
    state0 = NavState(*(x[: n - 1] for x in window.nodes))
    return window._replace(preint=preintegrate(params, state0, imu))


def _cam_pose(window: Window, k):
    q = window.nodes.q[k]
    r_wc = rot.quat_to_matrix(rot.quat_mul(q, window.ext_q))
    t_wc = window.nodes.p[k] + rot.quat_rotate(q, window.ext_p)
    return r_wc, t_wc


def triangulate_window(window: Window, reproj_thresh: float = 0.01):
    """Triangulate every valid landmark between its anchor node and the
    newest node observing it; successful ones take the new inverse depth.
    Returns (window, invdepth [L], ok [L])."""
    L, N = window.obs_valid.shape
    ref = window.lm_ref.long()
    k_idx = torch.arange(N, device=ref.device)
    last = torch.max(torch.where(window.obs_valid, k_idx, -1), 1).values
    last = torch.clamp(last, min=0)
    lidx = torch.arange(L, device=ref.device)
    r0, t0 = _cam_pose(window, ref)
    r1, t1 = _cam_pose(window, last)
    _, invd, ok = triangulate_checked(
        r0, t0, r1, t1, window.obs_uv[lidx, ref], window.obs_uv[lidx, last],
        reproj_thresh=reproj_thresh,
    )
    ok = ok & window.lm_valid & (last != ref)
    new_invd = torch.where(ok, invd, window.lm_invdepth)
    return window._replace(lm_invdepth=new_invd), invd, ok
