"""The port's eval_transform (fixed window, short-side antialiased cubic
resize, centre crop, normalisation) against the JAX package's on the same
uint16 canvases: a square 512^2 canvas to 224 and a non-square one, each
under the soft-tissue and the lung window, max abs <= 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch.ops.augment import eval_transform
from dinox_tpu.ops.augment import eval_transform as jax_eval_transform

WINDOWS = [(40.0, 400.0), (-30.0, 120.0)]


@pytest.mark.parametrize("level,width", WINDOWS)
@pytest.mark.parametrize("shape", [(2, 512, 512, 3), (2, 300, 420, 3)])
def test_eval_transform_matches_jax(shape, level, width):
    rng = np.random.default_rng(shape[1] + int(width))
    pixels = rng.integers(30500, 35500, size=shape).astype(np.uint16)
    want = np.asarray(jax_eval_transform(jnp.asarray(pixels), img_size=224, level=level, width=width))
    got = eval_transform(torch.from_numpy(pixels), img_size=224, level=level, width=width).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_eval_transform_default_window_and_tall_canvas():
    pixels = np.random.default_rng(3).integers(31000, 35000, size=(1, 97, 64, 3)).astype(np.uint16)
    want = np.asarray(jax_eval_transform(jnp.asarray(pixels), img_size=56))
    got = eval_transform(torch.from_numpy(pixels), img_size=56).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
