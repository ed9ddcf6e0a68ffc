# Frozen copy of ic_gvins_tpu_torch/solver/window.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
# Changed: ``empty_window`` allocates no odometer intervals (no cell runs
# the odometer); the scale's slot in the layout stays.
"""Fixed-shape sliding-window problem state (``solver/window.py``).

Layout of the error-state vector (dimension ``dim_total``):

    [ node 0 (15) | ... | node N-1 (15) | ext (6) | td (1) | sodo (1) | landmarks (L) ]

per node: [dp 0:3, dtheta 3:6, dv 6:9, dbg 9:12, dba 12:15]. ``sodo`` is
the odometer scale factor, one window-global state, never free here.
"""

from typing import NamedTuple, Optional

import torch

from ..data.types import NavState
from ..device import resolve_device
from ..factors.manifold import node_boxminus, node_boxplus, pose_boxminus, pose_boxplus
from ..ins.preintegration import PreintData

NODE_DOF = 15
EXT_DOF = 8  # 6 extrinsic + 1 time delay + 1 odometer scale
EXTTD_DOF = 7  # the part reprojection factors touch (ext + td)


class Window(NamedTuple):
    """Sliding-window estimate. N nodes, L landmarks, all masked."""

    nodes: NavState  # [N]
    node_valid: torch.Tensor  # [N] bool
    node_is_kf: torch.Tensor  # [N] bool
    preint: PreintData  # [N-1]; interval i joins node i -> i+1 (OdoPreintData with the odometer)
    preint_valid: torch.Tensor  # [N-1] bool
    gnss_p: torch.Tensor  # [N,3]
    gnss_std: torch.Tensor  # [N,3] effective std (chi2-reweighted)
    gnss_std_base: torch.Tensor  # [N,3] as-ingested std
    gnss_valid: torch.Tensor  # [N] bool
    ext_p: torch.Tensor  # (3,) camera-IMU translation
    ext_q: torch.Tensor  # (4,) camera-IMU rotation
    td: torch.Tensor  # () camera-IMU time delay
    sodo: torch.Tensor  # () odometer scale (frozen without the odometer)
    frame_td: torch.Tensor  # [N] per-frame time-delay base
    lm_invdepth: torch.Tensor  # [L]
    lm_ref: torch.Tensor  # [L] int anchor node index
    lm_valid: torch.Tensor  # [L] bool
    obs_uv: torch.Tensor  # [L,N,2] normalized-plane observation
    obs_vel: torch.Tensor  # [L,N,2] normalized-plane velocity
    obs_valid: torch.Tensor  # [L,N] bool

    @property
    def n_nodes(self) -> int:
        return self.node_valid.shape[0]

    @property
    def n_landmarks(self) -> int:
        return self.lm_valid.shape[0]

    @property
    def dim_x(self) -> int:
        """States-only dimension (nodes + extrinsic + td + sodo)."""
        return self.n_nodes * NODE_DOF + EXT_DOF

    @property
    def dim_total(self) -> int:
        return self.dim_x + self.n_landmarks


class Prior(NamedTuple):
    """Marginalization prior as a quadratic form over the states-only
    coordinates: cost(x) = const + g.dx + 0.5 dx^T H dx, dx = x ⊟ lin."""

    H: torch.Tensor  # [DX, DX]
    g: torch.Tensor  # [DX]
    lin_nodes: NavState  # [N] linearization snapshot
    lin_ext_p: torch.Tensor
    lin_ext_q: torch.Tensor
    lin_td: torch.Tensor
    lin_sodo: torch.Tensor


class SolverConfig(NamedTuple):
    """Solver tunables."""

    antlever: torch.Tensor  # (3,)
    reproj_std: torch.Tensor  # () normalized-coordinate reprojection std
    bias_prior_bg_std: torch.Tensor  # ()
    bias_prior_ba_std: torch.Tensor  # ()
    estimate_extrinsic: torch.Tensor  # () bool
    estimate_td: torch.Tensor  # () bool
    estimate_sodo: torch.Tensor  # () bool
    sodo_prior_std: torch.Tensor  # ()
    # None: GNSS chi2 inflation recomputed from the base std each round;
    # a bool tensor selects the compounding variant where it is True
    chi2_compound: Optional[torch.Tensor] = None


def _identity_quats(n, dtype, device):
    q = torch.zeros((n, 4), dtype=dtype, device=device)
    q[:, 0] = 1.0
    return q


def _zero_nodes(n, dtype, device) -> NavState:
    z3 = lambda: torch.zeros((n, 3), dtype=dtype, device=device)  # noqa: E731
    return NavState(
        time=torch.zeros(n, dtype=dtype, device=device), p=z3(),
        q=_identity_quats(n, dtype, device), v=z3(), bg=z3(), ba=z3(),
    )


def empty_window(n_nodes: int, n_landmarks: int, dtype=torch.float64,
                 device=None) -> Window:
    device = resolve_device(device)
    N, L = n_nodes, n_landmarks
    kw = dict(dtype=dtype, device=device)
    eye = torch.eye(NODE_DOF, **kw).expand(N - 1, NODE_DOF, NODE_DOF)
    preint = PreintData(
        dp=torch.zeros((N - 1, 3), **kw),
        dv=torch.zeros((N - 1, 3), **kw),
        dq=_identity_quats(N - 1, dtype, device),
        jac=eye.clone(),
        cov=eye.clone(),
        dt=torch.zeros(N - 1, **kw),
        sum_dt_pn=torch.zeros((N - 1, 3), **kw),
        bg_ref=torch.zeros((N - 1, 3), **kw),
        ba_ref=torch.zeros((N - 1, 3), **kw),
        end_state=_zero_nodes(N - 1, dtype, device),
    )
    nobool = lambda *s: torch.zeros(s, dtype=torch.bool, device=device)  # noqa: E731
    return Window(
        nodes=_zero_nodes(N, dtype, device),
        node_valid=nobool(N),
        node_is_kf=nobool(N),
        preint=preint,
        preint_valid=nobool(N - 1),
        gnss_p=torch.zeros((N, 3), **kw),
        gnss_std=torch.ones((N, 3), **kw),
        gnss_std_base=torch.ones((N, 3), **kw),
        gnss_valid=nobool(N),
        ext_p=torch.zeros(3, **kw),
        ext_q=_identity_quats(1, dtype, device)[0],
        td=torch.zeros((), **kw),
        sodo=torch.zeros((), **kw),
        frame_td=torch.zeros(N, **kw),
        lm_invdepth=torch.full((L,), 0.1, **kw),
        lm_ref=torch.zeros(L, dtype=torch.int32, device=device),
        lm_valid=nobool(L),
        obs_uv=torch.zeros((L, N, 2), **kw),
        obs_vel=torch.zeros((L, N, 2), **kw),
        obs_valid=nobool(L, N),
    )


def empty_prior(n_nodes: int, dtype=torch.float64, device=None) -> Prior:
    device = resolve_device(device)
    dx = n_nodes * NODE_DOF + EXT_DOF
    kw = dict(dtype=dtype, device=device)
    return Prior(
        H=torch.zeros((dx, dx), **kw),
        g=torch.zeros(dx, **kw),
        lin_nodes=_zero_nodes(n_nodes, dtype, device),
        lin_ext_p=torch.zeros(3, **kw),
        lin_ext_q=_identity_quats(1, dtype, device)[0],
        lin_td=torch.zeros((), **kw),
        lin_sodo=torch.zeros((), **kw),
    )


def make_init_prior(window: Window, pose_std6: torch.Tensor,
                    mix_std9: torch.Tensor,
                    ext_std7: Optional[torch.Tensor] = None) -> Prior:
    """Initialization prior on node 0 (and optionally the extrinsic + td)
    as r = J dx with J = diag(1/std)."""
    p = window.nodes.p
    diag = torch.zeros(window.dim_x, dtype=p.dtype, device=p.device)
    diag[:NODE_DOF] = 1.0 / torch.cat([pose_std6, mix_std9])
    if ext_std7 is not None:
        ext_std = ext_std7.to(p.dtype)
        if ext_std.shape[0] == EXTTD_DOF:  # no sodo entry: leave it free
            ext_std = torch.cat([ext_std, ext_std.new_tensor([1e6])])
        n15 = window.n_nodes * NODE_DOF
        diag[n15 : n15 + EXT_DOF] = 1.0 / ext_std
    return Prior(
        H=torch.diag(diag**2),
        g=torch.zeros_like(diag),
        lin_nodes=window.nodes,
        lin_ext_p=window.ext_p,
        lin_ext_q=window.ext_q,
        lin_td=window.td,
        lin_sodo=window.sodo,
    )


def apply_delta(window: Window, dx: torch.Tensor) -> Window:
    """Apply a full error-state delta to the window estimate."""
    N = window.n_nodes
    n15 = N * NODE_DOF
    nodes = node_boxplus(window.nodes, dx[:n15].reshape(N, NODE_DOF))
    ext_p, ext_q = pose_boxplus(window.ext_p, window.ext_q, dx[n15 : n15 + 6])
    return window._replace(
        nodes=nodes, ext_p=ext_p, ext_q=ext_q,
        td=window.td + dx[n15 + 6], sodo=window.sodo + dx[n15 + 7],
        lm_invdepth=window.lm_invdepth + dx[n15 + EXT_DOF :],
    )


def state_boxminus(window: Window, prior: Prior) -> torch.Tensor:
    """States-only local coordinates of the window around the prior's
    linearization point."""
    node_dx = node_boxminus(window.nodes, prior.lin_nodes)
    ext_dx = pose_boxminus(window.ext_p, window.ext_q, prior.lin_ext_p,
                           prior.lin_ext_q)
    return torch.cat([
        node_dx.reshape(-1), ext_dx,
        (window.td - prior.lin_td)[None], (window.sodo - prior.lin_sodo)[None],
    ])
