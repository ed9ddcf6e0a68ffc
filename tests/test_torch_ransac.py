"""PyTorch port: FM-RANSAC against the JAX package. The 8-point subsets
are drawn once, as the JAX function draws them from its key, and handed
to the port's ``fundamental_ransac_idx``; the port's ``fundamental_ransac``
on the front end's uniforms (``common/prng.py``) is held by properties of
the inlier set."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_solver import one_torch_thread  # noqa: F401

from ic_gvins_tpu.vision import ransac as jransac
from ic_gvins_tpu_torch.common import prng
from ic_gvins_tpu_torch.vision import ransac as transac

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import two_view_scene  # noqa: E402


def _jax_idx(valid, key):
    """The sample indices ``jransac.fundamental_ransac`` forms from ``key``."""
    order = np.argsort(~valid, kind="stable")
    m = max(int(valid.sum()), 1)
    u = np.asarray(jax.random.uniform(key, (jransac.N_HYPOTHESES, 8)))
    return order[np.minimum((u * m).astype(np.int32), m - 1)]


def _scene(case):
    uv0, uv1, is_out = two_view_scene(80, 12, seed=3)
    valid = np.ones(80, bool)
    if case == "masked":
        valid[::4] = False
    elif case == "sparse":
        valid = np.arange(80) % 2 == 0
    return uv0, uv1, is_out, valid


@pytest.mark.parametrize("case", ["all_valid", "masked", "sparse"])
def test_ransac_matches_jax_on_same_samples(case):
    """float64 on both sides: inlier masks equal; F equal up to sign and
    scale to 1e-8 (eigh may return the other sign of the eigenvector)."""
    uv0, uv1, _, valid = _scene(case)
    key = jax.random.PRNGKey(4)
    j_inl, j_F = jransac.fundamental_ransac(uv0, uv1, jnp.asarray(valid), 1.5, key)
    idx = _jax_idx(valid, key)
    t_inl, t_F = transac.fundamental_ransac_idx(
        torch.from_numpy(uv0), torch.from_numpy(uv1), torch.from_numpy(valid), 1.5,
        torch.from_numpy(idx))
    np.testing.assert_array_equal(t_inl.numpy(), np.asarray(j_inl))
    unit = lambda F: F / np.linalg.norm(F) * np.sign(F.flat[np.argmax(np.abs(F))])  # noqa: E731
    np.testing.assert_allclose(unit(t_F.numpy()), unit(np.asarray(j_F)), rtol=0, atol=1e-8)
    assert np.asarray(j_inl).sum() >= 0.6 * valid.sum()


def test_sample_indices_follow_the_reference_rule():
    """Valid indices packed first (stable), u * m truncated, capped at m - 1."""
    valid = np.ones(40, bool)
    valid[::3] = False
    u = torch.rand((64, 8), generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    idx = transac.sample_indices(torch.from_numpy(valid), u)
    order = np.argsort(~valid, kind="stable")
    m = int(valid.sum())
    np.testing.assert_array_equal(idx.numpy(), order[np.minimum((u.numpy() * m).astype(int), m - 1)])
    assert valid[idx.numpy()].all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_with_own_generator(seed):
    """200 correspondences, 20% gross outliers, every fifth entry invalid:
    at least 95% of the true inliers kept, no gross outlier kept, invalid
    entries never inliers, rank-2 F, and the same result for the same
    draws (the front end's uniforms of frame ``seed``)."""
    uv0, uv1, is_out = two_view_scene(200, 40, seed=10 + seed)
    valid = np.ones(200, bool)
    valid[4::5] = False
    args = (torch.from_numpy(uv0), torch.from_numpy(uv1), torch.from_numpy(valid), 1.5)
    inl, F = transac.fundamental_ransac(*args, prng.ransac_uniforms(seed))
    inl = inl.numpy()
    assert not inl[is_out].any()
    assert not inl[~valid].any()
    assert inl[valid & ~is_out].mean() >= 0.95
    s = np.linalg.svd(F.numpy(), compute_uv=False)
    assert s[2] < 1e-8 * s[0]
    inl2, F2 = transac.fundamental_ransac(*args, prng.ransac_uniforms(seed))
    assert torch.equal(inl2, torch.from_numpy(inl)) and torch.equal(F2, F)
