"""The port's two-view augmentation (dinox_torch.ops.augment) against the
JAX package's (dinox_tpu.ops.augment): the HU window and normalisation, the
cubic antialiased crop-resize at given boxes, the crop sampler by its
statistics (jax.random's streams cannot be reproduced in torch), and
augment_views' shape and determinism. Float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch.ops import augment
from dinox_tpu.ops import augment as jax_augment


def test_decode_window_and_normalize_match_jax():
    rng = np.random.default_rng(0)
    px = rng.integers(20000, 45000, (3, 16, 16, 3)).astype(np.uint16)
    level = rng.uniform(-400, 400, (3, 1, 1, 1)).astype(np.float32)
    width = rng.uniform(800, 2000, (3, 1, 1, 1)).astype(np.float32)
    want = np.asarray(jax_augment.decode_window(jnp.asarray(px), jnp.asarray(level), jnp.asarray(width)))
    got = augment.decode_window(torch.from_numpy(px), torch.from_numpy(level), torch.from_numpy(width))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(augment.normalize_imagenet(got).numpy(),
                               np.asarray(jax_augment.normalize_imagenet(jnp.asarray(want))),
                               rtol=0, atol=1e-6)


# (H, W, top, left, ch, cw, out): down-scaling, up-scaling, a box past the
# image edge, mixed.
BOXES = [(96, 80, 3.7, 10.2, 70.5, 61.3, 24), (40, 48, 5.25, 7.5, 12.8, 15.1, 32),
         (64, 64, 30.0, 40.0, 40.0, 30.0, 20), (56, 72, 0.0, 0.0, 56.0, 20.5, 28)]


@pytest.mark.parametrize("h,w,top,left,ch,cw,out", BOXES)
def test_crop_resize_matches_jax(h, w, top, left, ch, cw, out):
    img = np.random.default_rng(1).uniform(0, 1, (h, w, 3)).astype(np.float32)
    f32 = lambda v: jnp.float32(v)  # noqa: E731
    want = np.asarray(jax_augment._crop_resize(jnp.asarray(img), f32(top), f32(left), f32(ch),
                                               f32(cw), out, "cubic"))
    t = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    got = augment._crop_resize(torch.from_numpy(img)[None], t(top), t(left), t(ch), t(cw), out)[0]
    assert got.shape == (out, out, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h,w", [(512, 512), (64, 256)])
def test_crop_box_statistics_match_jax(h, w):
    cfg = augment.AugConfig()
    n = 2000
    keys = jax.random.split(jax.random.key(0), n)
    jt, jl, jch, jcw = (np.asarray(a) for a in jax.vmap(
        lambda k: jax_augment._sample_crop_box(k, h, w, jax_augment.AugConfig()))(keys))
    u = torch.rand((n, 2 * augment._CROP_ATTEMPTS + 2), generator=torch.Generator().manual_seed(0))
    a = augment._CROP_ATTEMPTS
    tt, tl, tch, tcw = (x.numpy() for x in augment._sample_crop_box(
        u[:, :a], u[:, a:2 * a], u[:, -2], u[:, -1], h, w, cfg))
    for top, left, ch, cw in ((jt, jl, jch, jcw), (tt, tl, tch, tcw)):
        assert (top >= 0).all() and (left >= 0).all()
        assert (top + ch <= h + 1e-3).all() and (left + cw <= w + 1e-3).all()
    assert abs(np.mean(tch * tcw / (h * w)) - np.mean(jch * jcw / (h * w))) < 0.02
    assert abs(np.mean(np.log(tcw / tch)) - np.mean(np.log(jcw / jch))) < 0.02


def test_fallback_is_the_clamped_centre_crop():
    cfg = augment.AugConfig()
    ones = torch.ones((1, augment._CROP_ATTEMPTS))  # area h*w, aspect 4/3: never fits a 40x400 canvas
    top, left, ch, cw = (x.item() for x in augment._sample_crop_box(
        ones, ones, torch.tensor([0.9]), torch.tensor([0.1]), 40, 400, cfg))
    assert (ch, cw) == pytest.approx((40.0, 40 * cfg.aspect_max))
    assert (top, left) == pytest.approx((0.0, (400 - cw) / 2))


def test_augment_views_is_deterministic_per_seed():
    px = torch.from_numpy(np.random.default_rng(2).integers(25000, 41000, (3, 64, 64, 3)).astype(np.uint16))
    cfg = augment.AugConfig(img_size=32)
    a = augment.augment_views(px, torch.Generator().manual_seed(5), cfg)
    b = augment.augment_views(px, torch.Generator().manual_seed(5), cfg)
    c = augment.augment_views(px, torch.Generator().manual_seed(6), cfg)
    assert a.shape == (2, 3, 32, 32, 3) and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])  # the two views differ
