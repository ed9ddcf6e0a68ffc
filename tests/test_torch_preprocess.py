"""PyTorch port: CLAHE and the histogram correlation against the JAX
package on the same numpy images."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_solver import one_torch_thread  # noqa: F401
from test_vision import random_texture

from ic_gvins_tpu.vision import preprocess as jpre
from ic_gvins_tpu_torch.vision import preprocess as tpre


def _image(h, w, seed):
    """Texture with values below 0 and above 255, so the clip counts."""
    return random_texture(h, w, seed=seed) * 1.1 - 10.0


# Both sides take the same integer bin counts and the same float32
# arithmetic; only the 256-term cumulative sums may associate in another
# order, and XLA fuses the blend's multiply-adds: a few float32 roundings
# of values up to 255 (one is 1.5e-5). Measured: 1.1e-4 at most.
CLAHE_ATOL = 1e-3  # grey levels


@pytest.mark.parametrize("shape", [(120, 160), (97, 131)])
@pytest.mark.parametrize("tiles", [8, 1])
def test_clahe_matches_jax(shape, tiles):
    """120 x 160 divides into 8 x 8 tiles; 97 x 131 leaves remainder rows
    and columns out of the histograms but still maps them; one tile takes
    the branch without interpolation."""
    img = _image(*shape, seed=shape[0])
    want = np.asarray(jpre.clahe(jnp.asarray(img), tiles=tiles))
    got = tpre.clahe(torch.from_numpy(img), tiles=tiles)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CLAHE_ATOL)
    assert want.std() > 10.0


def test_tile_histograms_match_jax():
    """Integer counts: exact, remainder rows and columns left out."""
    img = _image(97, 131, seed=1)
    want = np.asarray(jpre._tile_histograms(jnp.asarray(img), 12, 16))
    got = tpre._tile_histograms(torch.from_numpy(img), 12, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == 96 * 128


@pytest.mark.parametrize("case", ["same_scene", "glitch", "identical"])
def test_histogram_correlation_matches_jax(case):
    """float32 sums over 256 bins in another order: 1e-6."""
    img0 = _image(120, 160, seed=2)
    img1 = {"same_scene": np.roll(img0, 3, 1) + 2.0, "glitch": img0 * 0.25,
            "identical": img0}[case]
    want = float(jpre.histogram_correlation(jnp.asarray(img0), jnp.asarray(img1)))
    got = tpre.histogram_correlation(torch.from_numpy(img0), torch.from_numpy(img1))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-6
    assert (want < 0.7) == (case == "glitch")
