"""Long-window bundle adjustment with the node axis cut into chunks
(``parallel/ba_nodes.py``): one level of nested dissection.

The state system after landmark elimination is block-banded:
block-tridiagonal from the preintegration chain, block-diagonal from GNSS,
plus short-range coupling from landmarks seen by a few consecutive
nodes. The node axis is cut into S contiguous chunks of C nodes; the last
``sep_width`` (B) nodes of each chunk form a separator band, the rest is
the chunk's interior. Each chunk

* eliminates its landmarks (a diagonal divide, as the sliding-window
  solver does) and assembles its local system over its C + B local nodes
  (the previous chunk's band and its own C nodes),
* eliminates its interior block by a dense Cholesky of (C - B) * 15
  dimensions onto its two bands,

the S * B * 15-dimensional separator system is summed over the chunks
(the JAX ``psum``) and solved on every rank, and the interior and
landmark back-substitutions stay per chunk. The JAX package puts one
chunk on each device of the mesh axis ``"nodes"``; here each rank holds
``mesh.local("nodes")`` chunks as a leading tensor axis, every step
batched over it, and the sums run over the rank's chunks, then over the
ranks. The node step is put together as JAX does it: each rank's chunks
give their interior rows, one collective joins them, and the separator
bands come from the separator solve.

Every factor's nodes must lie inside one chunk's local node set. The
preintegration chain always does. A landmark lands in the chunk of its
anchor (a band's anchor in the next chunk), and its observations fit when
the band is at least as wide as its forward span; ``build_nodes_ba`` masks
and counts the observations that do not. The camera extrinsic and time
delay are frozen here.
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..data.types import IntegrationParams, NavState
from ..device import resolve_device
from ..factors.manifold import node_boxplus
from ..factors.residuals import gnss_residual_jac, huber_weight, reprojection_residual_jac
from ..ins.preintegration import PreintData, preint_residual_jac, sqrt_information
from ..solver.assembly import huber_rho, index_sum_
from . import assemble, psum, psum_packed

AXIS = "nodes"
NODE_DOF = 15
# the NodesBA fields with a leading chunk axis [S], the ones a rank holds a
# slice of
CHUNK_FIELDS = ("preint", "preint_valid", "gnss_p", "gnss_std", "gnss_valid", "lm_invdepth",
                "lm_ref_local", "lm_valid", "obs_node_local", "obs_uv", "obs_ref_uv", "obs_valid")


class NodesBA(NamedTuple):
    """Long-window BA problem, the node axis cut for S chunks.

    Shapes: S chunks, C nodes per chunk (N = S * C), Lp landmark slots per
    chunk, W observation slots per landmark. Leading [S] axes are per
    chunk; ``nodes`` is shared."""

    nodes: NavState  # [N]
    node_valid: torch.Tensor  # [N]
    # preintegration slab per chunk: slot f of chunk c is the global
    # interval (cC - 1 + f, cC + f); slot 0 of chunk 0 is a masked dummy
    preint: PreintData  # [S, C, ...]
    preint_valid: torch.Tensor  # [S, C]
    gnss_p: torch.Tensor  # [S, C, 3] fixes at the chunk's own nodes
    gnss_std: torch.Tensor  # [S, C, 3]
    gnss_valid: torch.Tensor  # [S, C]
    ext_p: torch.Tensor  # (3,) frozen camera extrinsic
    ext_q: torch.Tensor  # (4,)
    # landmarks by anchor chunk; node indices are local to the chunk's node
    # set [cC - B, (c + 1)C), i.e. in [0, C + B)
    lm_invdepth: torch.Tensor  # [S, Lp]
    lm_ref_local: torch.Tensor  # [S, Lp] local anchor node
    lm_valid: torch.Tensor  # [S, Lp]
    obs_node_local: torch.Tensor  # [S, Lp, W] local observing node
    obs_uv: torch.Tensor  # [S, Lp, W, 2]
    obs_ref_uv: torch.Tensor  # [S, Lp, 2] anchor observation
    obs_valid: torch.Tensor  # [S, Lp, W]
    reproj_std: torch.Tensor  # ()

    @property
    def n_shards(self) -> int:
        return self.preint_valid.shape[0]

    @property
    def chunk(self) -> int:
        return self.preint_valid.shape[1]

    @property
    def n_nodes(self) -> int:
        return self.node_valid.shape[0]


def build_nodes_ba(
    nodes: NavState,
    preint: PreintData,
    gnss_p, gnss_std, gnss_valid,
    lm_invdepth, lm_ref,
    obs_uv_dense,  # [L, N, 2]
    obs_valid_dense,  # [L, N]
    ext_p, ext_q, reproj_std: float,
    n_chunks: int,
    stencil: int = 16,
    sep_width: int = 1,
    dtype=None,
    device=None,
) -> tuple[NodesBA, int]:
    """On the host (numpy): cut the node axis into chunks, put each
    landmark in the chunk of its anchor, and pack its observations into the
    W = ``stencil`` slots of local node indices. Returns (problem on
    ``device``, number of masked observations): an observation outside the
    anchor chunk's local node set [cC - B, (c + 1)C), or beyond the
    stencil, is masked and counted; with ``sep_width`` at least the longest
    forward span the count is 0. ``sep_width`` (B) must match the value
    given to ``ba_nodes_solve``."""
    host = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)  # noqa: E731
    nodes = pytree.tree_map(host, nodes)
    preint = pytree.tree_map(host, preint)
    N = int(nodes.p.shape[0])
    S = int(n_chunks)
    if N % S != 0:
        raise ValueError(f"n_nodes {N} must divide n_chunks {S}")
    C = N // S
    B = int(sep_width)
    if not (1 <= B < C) and S > 1:
        raise ValueError(f"sep_width {B} must be in [1, chunk {C})")
    lm_ref = host(lm_ref)
    lm_invdepth = host(lm_invdepth)
    obs_uv_dense = host(obs_uv_dense)
    obs_valid_dense = host(obs_valid_dense)
    L = len(lm_ref)
    dtype = dtype or nodes.p.dtype

    # preintegration slabs: chunk c takes the intervals [cC - 1, (c+1)C - 1);
    # the pad slot repeats interval 0 (a zero covariance would give NaNs
    # in the whitening before the mask applies)
    def slab(arr):
        ext = np.concatenate([arr[:1], arr])  # global interval j at ext[j + 1]
        return np.stack([ext[c * C:(c + 1) * C] for c in range(S)])

    pre_s = pytree.tree_map(slab, preint)
    pre_valid = slab(np.ones(N - 1, bool))
    pre_valid[0, 0] = False  # the dummy interval (-1, 0)

    g_p = host(gnss_p).reshape(S, C, 3)
    g_std = host(gnss_std).reshape(S, C, 3)
    g_val = host(gnss_valid).reshape(S, C)

    # a landmark anchored in chunk c's band belongs to chunk c + 1, whose
    # previous band it is: the anchor and its forward observations then lie
    # in c + 1's local node set
    anchor_chunk = np.clip((lm_ref + B) // C, 0, S - 1)
    per_chunk: list[list[int]] = [[] for _ in range(S)]
    for l in range(L):
        per_chunk[int(anchor_chunk[l])].append(l)
    Lp = max(1, max(len(b) for b in per_chunk))
    W = int(stencil)

    lm_inv = np.zeros((S, Lp), dtype)
    lm_refl = np.zeros((S, Lp), np.int64)
    lm_val = np.zeros((S, Lp), bool)
    obs_nl = np.zeros((S, Lp, W), np.int64)
    obs_uv = np.zeros((S, Lp, W, 2), dtype)
    obs_ruv = np.zeros((S, Lp, 2), dtype)
    obs_val = np.zeros((S, Lp, W), bool)
    dropped = 0
    for c in range(S):
        lo, hi = c * C - B, (c + 1) * C  # local node set [lo, hi)
        for slot, l in enumerate(per_chunk[c]):
            a = int(lm_ref[l])
            lm_inv[c, slot] = lm_invdepth[l]
            lm_refl[c, slot] = a - lo
            lm_val[c, slot] = True
            obs_ruv[c, slot] = obs_uv_dense[l, a]
            ks = np.nonzero(obs_valid_dense[l])[0]
            w = 0
            for k in ks[ks != a]:
                if not (lo <= k < hi) or w >= W:
                    dropped += 1
                    continue
                obs_nl[c, slot, w] = k - lo
                obs_uv[c, slot, w] = obs_uv_dense[l, k]
                obs_val[c, slot, w] = True
                w += 1

    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(np.array(x), device=dev)  # noqa: E731
    tf = lambda x: torch.as_tensor(np.array(x, dtype), device=dev)  # noqa: E731
    ba = NodesBA(
        nodes=pytree.tree_map(tf, nodes),
        node_valid=torch.ones(N, dtype=torch.bool, device=dev),
        preint=pytree.tree_map(tf, pre_s),
        preint_valid=t(pre_valid),
        gnss_p=tf(g_p), gnss_std=tf(g_std), gnss_valid=t(g_val),
        ext_p=tf(host(ext_p)), ext_q=tf(host(ext_q)),
        lm_invdepth=tf(lm_inv), lm_ref_local=t(lm_refl), lm_valid=t(lm_val),
        obs_node_local=t(obs_nl), obs_uv=tf(obs_uv), obs_ref_uv=tf(obs_ruv),
        obs_valid=t(obs_val),
        reproj_std=tf(reproj_std),
    )
    return ba, dropped


# ---------------------------------------------------------------------------
# Per-chunk evaluation, batched over the chunk axis [S]
# ---------------------------------------------------------------------------


def local_node_index(S: int, C: int, B: int, device=None, first: int = 0):
    """Global node index [S, C + B] of the local node sets [cC - B,
    (c + 1)C) of the S chunks from chunk ``first`` on, and their mask:
    chunk 0 has no previous band, and its locals 0..B-1 are masked dummies
    that repeat node 0 (zeros would give NaNs in the factor math before the
    mask applies)."""
    g = ((first + torch.arange(S, device=device))[:, None] * C - B
         + torch.arange(C + B, device=device)[None, :])
    return torch.clamp(g, min=0), g >= 0


def _pair_add(acc, n: int, s, a, b, x):
    """acc [S * n * n, k, k] += x at the block (a, b) of chunk s."""
    return index_sum_(acc, ((s * n + a) * n + b).reshape(-1), x.reshape((-1,) + x.shape[-2:]))


def _eval_local(ba: NodesBA, nodes: NavState, lm_invd, params: IntegrationParams, B: int,
                with_system: bool = True, first: int = 0):
    """Each chunk's local system before landmark elimination, for the S
    chunks of ``ba`` (global chunks ``first`` on):
    (H [S, D, D], g [S, D], Hxl [S, D, Lp], hll [S, Lp], gl [S, Lp],
    cost [S], loc_valid [S, C + B]) with D = (C + B) * 15. With
    ``with_system=False`` only the costs (and the mask)."""
    S, C = ba.n_shards, ba.chunk
    n = C + B
    dev = ba.node_valid.device
    idx, ok = local_node_index(S, C, B, dev, first)
    loc = NavState(*(x[idx] for x in nodes))  # [S, n, ...]
    loc_valid = ok & ba.node_valid[idx]
    dtype = loc.p.dtype
    sid = torch.arange(S, device=dev)

    # --- preintegration chain: slot f joins locals (B - 1 + f, B + f) ---
    s0 = NavState(*(x[:, B - 1:B - 1 + C] for x in loc))
    s1 = NavState(*(x[:, B:] for x in loc))
    r_pre, J_pre = preint_residual_jac(ba.preint, s0, s1, params)
    Sq = sqrt_information(ba.preint.cov)
    m_pre = (ba.preint_valid & loc_valid[:, B - 1:B - 1 + C] & loc_valid[:, B:]).to(dtype)
    r_pre = (Sq @ r_pre[..., None])[..., 0] * m_pre[..., None]
    J_pre = (Sq @ J_pre) * m_pre[..., None, None]
    cost = 0.5 * torch.sum(r_pre**2, (1, 2))

    # --- GNSS on the chunk's own nodes (locals B .. B + C - 1) ---
    own = NavState(*(x[:, B:] for x in loc))
    zero3 = own.p.new_zeros(3)
    r_g, J_g = gnss_residual_jac(own.p, own.q, zero3, ba.gnss_p, torch.clamp(ba.gnss_std, min=1e-6))
    m_g = (ba.gnss_valid & loc_valid[:, B:]).to(dtype)
    r_g = r_g * m_g[..., None]
    J_g = J_g * m_g[..., None, None]
    chi_g = torch.sum(r_g**2, -1)
    cost = cost + 0.5 * torch.sum(huber_rho(chi_g) * (chi_g > 0), 1)

    # --- reprojection factors over the stencil ---
    Lp, W = ba.obs_valid.shape[1:]
    ref = ba.lm_ref_local
    obs = ba.obs_node_local
    at = lambda x, i: x[sid.reshape((S,) + (1,) * (i.dim() - 1)), i]  # noqa: E731
    ex = lambda x: x[:, :, None].expand((S, Lp, W) + x.shape[2:])  # noqa: E731
    invd = ex(lm_invd)
    guarded = torch.abs(invd) < 1e-4
    invd = torch.where(guarded, torch.full_like(invd, 1e-4), invd)
    zw = invd.new_zeros((S, Lp, W))
    z2 = invd.new_zeros((S, Lp, W, 2))
    r_v, J_v = reprojection_residual_jac(
        ex(at(loc.p, ref)), ex(at(loc.q, ref)), at(loc.p, obs), at(loc.q, obs),
        ba.ext_p, ba.ext_q, invd, zw, ex(ba.obs_ref_uv), ba.obs_uv, z2, z2, zw, zw,
        ba.reproj_std)
    m_v = (ba.obs_valid & ba.lm_valid[..., None] & at(loc_valid, ref)[..., None]
           & at(loc_valid, obs) & (obs != ref[..., None])).to(dtype)
    r_v = r_v * m_v[..., None]
    chi_v = torch.sum(r_v**2, -1)
    cost = cost + 0.5 * torch.sum(huber_rho(chi_v) * (chi_v > 0), (1, 2))
    if not with_system:
        return None, None, None, None, None, cost, loc_valid

    Hpre = J_pre.new_zeros((S * n * n, NODE_DOF, NODE_DOF))
    g_n = J_pre.new_zeros((S * n, NODE_DOF))
    fi = (B - 1 + torch.arange(C, device=dev)).expand(S, C)
    fj = fi + 1
    s_c = sid[:, None].expand(S, C)
    Ji = J_pre[..., :NODE_DOF]
    Jj = J_pre[..., NODE_DOF:]
    tr = lambda x: x.transpose(-1, -2)  # noqa: E731
    Aij = tr(Ji) @ Jj
    _pair_add(Hpre, n, s_c, fi, fi, tr(Ji) @ Ji)
    _pair_add(Hpre, n, s_c, fj, fj, tr(Jj) @ Jj)
    _pair_add(Hpre, n, s_c, fi, fj, Aij)
    _pair_add(Hpre, n, s_c, fj, fi, tr(Aij))
    index_sum_(g_n, (s_c * n + fi).reshape(-1),
               (tr(Ji) @ r_pre[..., None])[..., 0].reshape(-1, NODE_DOF))
    index_sum_(g_n, (s_c * n + fj).reshape(-1),
               (tr(Jj) @ r_pre[..., None])[..., 0].reshape(-1, NODE_DOF))

    # GNSS: 6 x 6 pose blocks of the own nodes
    Hvis = J_pre.new_zeros((S * n * n, 6, 6))
    g_v = J_pre.new_zeros((S * n, 6))
    w_g = huber_weight(chi_g)
    kown = (B + torch.arange(C, device=dev)).expand(S, C)
    _pair_add(Hvis, n, s_c, kown, kown, w_g[..., None, None] * (tr(J_g) @ J_g))
    index_sum_(g_v, (s_c * n + kown).reshape(-1),
               (w_g[..., None] * (tr(J_g) @ r_g[..., None])[..., 0]).reshape(-1, 6))

    # reprojection: ref pose, obs pose and inverse depth columns
    J_v = J_v * m_v[..., None, None]
    w_v = huber_weight(chi_v)
    Jr = J_v[..., 0:6]
    Jo = J_v[..., 6:12]
    Jl = J_v[..., 19] * (~guarded).to(dtype)[..., None]  # a guarded depth is a constant
    wJr = w_v[..., None, None] * Jr
    wJo = w_v[..., None, None] * Jo
    wJl = w_v[..., None] * Jl
    s_lw = sid[:, None, None].expand(S, Lp, W)
    ref_w = ref[..., None].expand(S, Lp, W)
    _pair_add(Hvis, n, s_lw, obs, obs, tr(wJo) @ Jo)
    _pair_add(Hvis, n, s_lw, ref_w, ref_w, tr(wJr) @ Jr)
    H_ro = tr(wJr) @ Jo
    _pair_add(Hvis, n, s_lw, ref_w, obs, H_ro)
    _pair_add(Hvis, n, s_lw, obs, ref_w, tr(H_ro))
    index_sum_(g_v, (s_lw * n + obs).reshape(-1),
               (tr(wJo) @ r_v[..., None])[..., 0].reshape(-1, 6))
    index_sum_(g_v, (s_lw * n + ref_w).reshape(-1),
               (tr(wJr) @ r_v[..., None])[..., 0].reshape(-1, 6))
    hll = torch.sum(wJl * Jl, (2, 3))
    gl = torch.sum(wJl * r_v, (2, 3))
    # landmark-node cross terms [S, n, 6, Lp]
    Hln = J_pre.new_zeros((S * n, Lp, 6))
    l_w = torch.arange(Lp, device=dev)[None, :, None].expand(S, Lp, W)
    cross = lambda J: (wJl[..., None, :] @ J)[..., 0, :]  # noqa: E731  [S,Lp,W,6]
    Hln.index_put_(((s_lw * n + obs).reshape(-1), l_w.reshape(-1)),
                   cross(Jo).reshape(-1, 6), accumulate=True)
    Hln.index_put_(((s_lw * n + ref_w).reshape(-1), l_w.reshape(-1)),
                   cross(Jr).reshape(-1, 6), accumulate=True)

    H = Hpre.reshape(S, n, n, NODE_DOF, NODE_DOF)
    H[..., 0:6, 0:6] += Hvis.reshape(S, n, n, 6, 6)
    D = n * NODE_DOF
    H = H.permute(0, 1, 3, 2, 4).reshape(S, D, D)
    g = g_n.reshape(S, n, NODE_DOF)
    g[..., 0:6] += g_v.reshape(S, n, 6)
    Hxl = Hln.new_zeros((S, n, NODE_DOF, Lp))
    Hxl[:, :, 0:6, :] = Hln.reshape(S, n, Lp, 6).transpose(-1, -2)
    return H, g.reshape(S, D), Hxl.reshape(S, D, Lp), hll, gl, cost, loc_valid


def take_local(ba: NodesBA, mesh) -> NodesBA:
    """This rank's chunks of a problem built with all of them: the
    ``CHUNK_FIELDS`` cut to the rank's ``mesh.local("nodes")`` chunks, the
    shared fields as they are (JAX's ``shard_map`` in_specs). With one rank
    the problem itself."""
    if not mesh.distributed:
        return ba
    first, n = mesh.first(AXIS), mesh.local(AXIS)
    cut = lambda x: x[first:first + n]  # noqa: E731
    return ba._replace(**{f: pytree.tree_map(cut, getattr(ba, f)) for f in CHUNK_FIELDS})


def ba_nodes_solve(ba: NodesBA, params: IntegrationParams, mesh=None, iters: int = 10,
                   lam0: float = 1e-4, sep_width: int = 1):
    """Damped Gauss-Newton (LM accept / reject) over the chunked problem.
    Returns (problem with the updated nodes and inverse depths, (cost0,
    cost1, accepted, iters_run)). ``sep_width`` must match the value the
    problem was built with; ``mesh``, when given, must have ``n_shards``
    shards on its axis "nodes" and this rank's device. Every rank passes
    the whole problem, works on its own chunks and gets the whole result
    back, the same on every rank. The damping and the accept / reject
    decisions are made on the costs summed over the chunks and ranks."""
    S_all, C, N = ba.n_shards, ba.chunk, ba.n_nodes
    first = 0
    if mesh is not None:
        if mesh.shape[AXIS] != S_all:
            raise ValueError(f"the problem has {S_all} chunks, the mesh {mesh.shape[AXIS]} shards")
        if ba.node_valid.device != mesh.device:
            raise ValueError(f"the problem is on {ba.node_valid.device}, rank {mesh.rank}'s "
                             f"mesh on {mesh.device}")
        ba_all, ba = ba, take_local(ba, mesh)
        first = mesh.first(AXIS)
    S = ba.n_shards  # this rank's chunks, global chunks first .. first + S - 1
    B = int(sep_width)
    dev = ba.node_valid.device
    BD = B * NODE_DOF  # one band's dimensions
    DI = (C - B) * NODE_DOF  # interior dimensions (locals B .. C - 1)
    DL = (C + B) * NODE_DOF
    DB = S_all * BD  # the separator system
    sid = torch.arange(S_all, device=dev)
    cid = first + torch.arange(S, device=dev)
    # the chunk's two bands (locals [0, B) and [C, C + B)) are the global
    # bands c - 1 and c; chunk 0's previous band is a dummy (a zero row)
    OH = torch.stack([(sid[None, :] == cid[:, None] - 1), (sid[None, :] == cid[:, None])],
                     1).to(ba.nodes.p.dtype)  # [S(chunk), 2, S_all(band)]
    bsel = torch.cat([torch.arange(BD, device=dev), C * NODE_DOF + torch.arange(BD, device=dev)])
    isel = BD + torch.arange(DI, device=dev)
    int_mask = torch.zeros(DL, dtype=ba.nodes.p.dtype, device=dev)
    int_mask[isel] = 1.0
    lm_free = (ba.lm_valid & (torch.sum(ba.obs_valid & (ba.obs_node_local != ba.lm_ref_local[..., None]),
                                        -1) > 0)).to(ba.nodes.p.dtype)
    cho = lambda Lc, b: torch.cholesky_solve(b, Lc)  # noqa: E731

    def step(nodes, lm_invd, lam):
        H, g, Hxl, hll, gl, _, loc_valid = _eval_local(ba, nodes, lm_invd, params, B,
                                                       first=first)
        # landmark elimination, per chunk
        hll = torch.where(hll * lm_free > 1e-12, hll, torch.ones_like(hll))
        hll_d = hll * (1.0 + lam)
        glf = gl * lm_free
        Hxlf = Hxl * lm_free[:, None, :]
        H = H - (Hxlf / hll_d[:, None, :]) @ Hxlf.transpose(-1, -2)
        g = g - (Hxlf @ (glf / hll_d)[..., None])[..., 0]

        # damp, freeze invalid local nodes; a unit diagonal for the empty
        # interior dims only (a band dim empty here may get terms from the
        # neighbouring chunk: it is regularized after the sum)
        free = loc_valid.repeat_interleave(NODE_DOF, 1).to(H.dtype)
        H = H * free[:, :, None] * free[:, None, :]
        g = g * free
        dH = torch.diagonal(H, dim1=1, dim2=2)
        H = H + torch.diag_embed(lam * dH + int_mask * (dH < 1e-12).to(H.dtype))

        Hii = H[:, isel][:, :, isel]
        Hib = H[:, isel][:, :, bsel]
        Hbb = H[:, bsel][:, :, bsel]
        gi, gb = g[:, isel], g[:, bsel]
        Lc = torch.linalg.cholesky(Hii)  # batched over the chunks
        HiiInvHib = cho(Lc, Hib)
        HiiInvGi = cho(Lc, gi[..., None])[..., 0]
        Sbb = Hbb - Hib.transpose(-1, -2) @ HiiInvHib  # [S, 2BD, 2BD]
        sb = gb - (Hib.transpose(-1, -2) @ HiiInvGi[..., None])[..., 0]

        # each chunk's two bands into the separator system, summed over the
        # chunks and the ranks in one collective
        Sg, sg = psum_packed(
            [torch.einsum("cas,caibj,cbt->csitj", OH, Sbb.reshape(S, 2, BD, 2, BD), OH)
             .reshape(S, DB, DB),
             torch.einsum("cas,cai->csi", OH, sb.reshape(S, 2, BD)).reshape(S, DB)], mesh)
        dS = torch.diagonal(Sg)
        Sg = Sg + torch.diag((dS < 1e-12).to(Sg.dtype))  # bands nothing touched
        dx_b = -torch.cholesky_solve(sg[:, None], torch.linalg.cholesky(Sg))[:, 0]

        # back-substitution, per chunk
        dx_b_loc = torch.einsum("cas,si->cai", OH, dx_b.reshape(S_all, BD)).reshape(S, 2 * BD)
        dx_i = -HiiInvGi - (HiiInvHib @ dx_b_loc[..., None])[..., 0]
        dx_loc = H.new_zeros((S, DL))
        dx_loc[:, isel] = dx_i
        dx_loc[:, bsel] = dx_b_loc
        dx_loc = dx_loc * free
        dx_l = -lm_free * (glf + (Hxlf.transpose(-1, -2) @ dx_loc[..., None])[..., 0]) / hll_d
        # chunk c's interior is nodes cC .. (c+1)C - B - 1, its own rows;
        # its band the next B, from the separator solve every rank made
        dx_nodes = torch.cat([dx_i.reshape(S, C - B, NODE_DOF),
                              dx_b.reshape(S_all, B, NODE_DOF)[first:first + S]],
                             1).reshape(S * C, NODE_DOF)
        if mesh is not None:
            (dx_nodes,) = assemble([(dx_nodes, first * C, N)], mesh)
        return dx_nodes, dx_l

    def total_cost(nodes, lm_invd):
        return psum(_eval_local(ba, nodes, lm_invd, params, B, with_system=False,
                                first=first)[5], mesh)

    nodes, lm_invd = ba.nodes, ba.lm_invdepth
    cost0 = total_cost(nodes, lm_invd)
    cost, lam, nacc, it = cost0, lam0, 0, 0
    while it < iters:
        dx_nodes, dx_l = step(nodes, lm_invd, lam)
        nodes_new = node_boxplus(nodes, dx_nodes)
        lm_new = lm_invd + dx_l
        cost_new = total_cost(nodes_new, lm_new)
        cur_f, new_f = torch.stack([cost, cost_new]).tolist()  # one host read
        it += 1
        accept = new_f < cur_f
        converged = False
        if accept:
            nodes, lm_invd, cost = nodes_new, lm_new, cost_new
            lam = max(lam / 3.0, 1e-10)
            nacc += 1
            converged = abs(cur_f - new_f) < 1e-6 * max(cur_f, 1e-30)
        else:
            lam = lam * 4.0
        if converged or lam > 1e10:
            break
    if mesh is not None:
        (lm_invd,) = assemble([(lm_invd, first, S_all)], mesh)
        ba = ba_all
    return ba._replace(nodes=nodes, lm_invdepth=lm_invd), (cost0, cost, nacc, it)
