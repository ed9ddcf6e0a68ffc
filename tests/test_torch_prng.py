"""PyTorch port: ``common/prng.py``, JAX's threefry random numbers in
numpy, bit for bit against ``jax.random`` (float64, as the JAX package's
tests run it), and the front end's FM-RANSAC subsets drawn with them
against the subsets the JAX front end draws for the same frame."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_solver import one_torch_thread  # noqa: F401

from ic_gvins_tpu.vision import ransac as jransac
from ic_gvins_tpu_torch.common import prng
from ic_gvins_tpu_torch.vision import ransac as transac

# about 200 frame counters up to 10^6: the first frames, then spread out
FRAMES = np.unique(np.concatenate([
    np.arange(40),
    np.random.default_rng(7).integers(40, 10**6, 158),
    [10**6, 2**31 - 1, 2**32 - 1],
]))


def _bits(x):
    return np.asarray(x, np.float64).view(np.uint64)


@pytest.mark.parametrize("shape", [(128, 8), (5, 3), (1,)])
def test_uniforms_are_jax_bit_for_bit(shape):
    """uniform(fold_in(PRNGKey(0), i), shape) equals jax.random's, every
    bit, for about 200 frame counters up to 10^6 (and the uint32 ends)."""
    assert len(FRAMES) >= 200
    draw = jax.jit(jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(0), i), shape)))
    wants = np.asarray(draw(jnp.asarray(FRAMES, jnp.uint32)))
    for i, want in zip(FRAMES, wants):
        got = prng.uniform(prng.fold_in(prng.prng_key(0), int(i)), shape)
        assert got.dtype == np.float64 and got.shape == shape
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"frame {i}")
        if shape == (128, 8):
            np.testing.assert_array_equal(_bits(prng.ransac_uniforms(int(i))), _bits(want))


@pytest.mark.parametrize("seed", [0, 1, 5, 2**32 + 3, 2**63 - 1])
def test_keys_and_fold_in_are_jax(seed):
    key = prng.prng_key(seed)
    np.testing.assert_array_equal(key, np.asarray(jax.random.PRNGKey(seed)))
    for data in (0, 1, 123456, 2**32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(key, data),
            np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(data))))


@pytest.mark.parametrize("frame", [1, 14, 977, 10**6])
def test_ransac_subsets_are_the_jax_front_ends(frame):
    """The port's ``sample_indices`` on frame ``frame``'s uniforms picks
    the indices JAX's ``fundamental_ransac`` forms from its key
    ``fold_in(PRNGKey(0), frame)`` (valid points first, u * m truncated)."""
    valid = np.random.default_rng(frame).random(60) < 0.6
    key = jax.random.fold_in(jax.random.PRNGKey(0), jnp.asarray(frame, jnp.uint32))
    u = np.asarray(jax.random.uniform(key, (jransac.N_HYPOTHESES, 8)))
    order = np.argsort(~valid, kind="stable")
    m = max(int(valid.sum()), 1)
    want = order[np.minimum((u * m).astype(np.int32), m - 1)]
    got = transac.sample_indices(torch.from_numpy(valid), prng.ransac_uniforms(frame))
    np.testing.assert_array_equal(got.numpy(), want)
