"""The port's synthetic data (dinox_torch.data.synthetic and the CLI's
SyntheticBatches) against the JAX package's.

The numpy generators and SyntheticBatches are bit-equal. The batched
generator on the device draws from torch.Generator, which cannot give
jax.random's bits, so it is held to make_jax_batch_fn's contract (shapes,
dtypes, ranges, determinism, chunking) and to its statistics: each
profile's mean and standard deviation after the eval window, over the same
number of samples, within 0.015 (on [0, 1]; about five standard errors of
the difference at this sample count)."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dinox_torch import pretrain
from dinox_torch.data import synthetic as t_syn
from dinox_tpu.data import synthetic as j_syn

ROOT = Path(__file__).resolve().parent.parent
STATS_TOL = 0.015


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs several workers on a few cores,
    and a thread pool per worker oversubscribes them many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cli():
    spec = importlib.util.spec_from_file_location("pretrain_cli", ROOT / "scripts" / "pretrain.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("profile", range(len(j_syn.PROFILES_V2)))
def test_synth_series_np_is_bit_equal(profile):
    for strength in (1.0, 0.4):
        jp, tp = j_syn.scaled_profiles_v2(strength)[profile], t_syn.scaled_profiles_v2(strength)[profile]
        assert tp.__dict__ == jp.__dict__
        got = t_syn.synth_series_np(tp, np.random.default_rng(profile), n_slices=3, size=64)
        want = j_syn.synth_series_np(jp, np.random.default_rng(profile), n_slices=3, size=64)
        np.testing.assert_array_equal(got, want)
        assert t_syn.draw_spacing(tp, np.random.default_rng(9)) == j_syn.draw_spacing(jp, np.random.default_rng(9))


@pytest.mark.parametrize("organ", ["organa", "organb"])
def test_two_organ_series_np_is_bit_equal(organ):
    got_hu, got_sp = t_syn.synth_two_organ_series_np(organ, np.random.default_rng(3), 4, 64)
    want_hu, want_sp = j_syn.synth_two_organ_series_np(organ, np.random.default_rng(3), 4, 64)
    np.testing.assert_array_equal(got_hu, want_hu)
    assert got_sp == want_sp
    field = np.random.default_rng(0).normal(size=(3, 5, 7))
    np.testing.assert_array_equal(t_syn._resize3d(field, (6, 11, 9)), j_syn._resize3d(field, (6, 11, 9)))
    with pytest.raises(ValueError):
        t_syn.synth_two_organ_series_np("organc", np.random.default_rng(0), 2, 32)


@pytest.mark.parametrize("n", [8, 16, 40])
def test_make_batch_fn_contract(n):
    """Shapes, dtypes, HU and spacing ranges, one chunk and several (40 is
    two whole chunks and a part), the twin of tests/test_synthetic.py's
    contract and chunking tests."""
    make = t_syn.make_batch_fn(64, n, device="cpu")
    px, sp, ds = make(torch.Generator().manual_seed(1))
    assert px.shape == (n, 64, 64, 3) and px.dtype == torch.uint16
    assert sp.shape == (n, 3) and sp.dtype == torch.float32
    assert ds.shape == (n,) and int(ds.min()) >= 0 and int(ds.max()) < 5
    hu = px.to(torch.float32) - 32768.0
    assert float(hu.min()) >= -1000.0 and float(hu.max()) <= 4000.0
    assert float(hu.min()) == -1000.0  # air outside the body
    for i in range(n):
        p = t_syn.PROFILES_V2[int(ds[i])]
        assert (sp[i].numpy() >= np.asarray(p.sp_min) - 1e-6).all()
        assert (sp[i].numpy() <= np.asarray(p.sp_max) + 1e-6).all()
        assert sp[i, 0] == sp[i, 1]  # square xy pixels
    again = make(torch.Generator().manual_seed(1))
    assert torch.equal(px, again[0]) and torch.equal(sp, again[1]) and torch.equal(ds, again[2])
    other = make(torch.Generator().manual_seed(2))
    assert not torch.equal(px, other[0])


def _windowed_stats(batches):
    """{profile: (per-sample mean, per-sample std)} of the centre channel
    after the eval window (L 40, W 400 HU) on [0, 1]."""
    out = {}
    for px, ds in batches:
        hu = (px[..., 1].astype(np.float32) - 32768.0) * 0.1
        w = np.clip((hu + 160.0) / 400.0, 0.0, 1.0)
        for j in range(len(ds)):
            out.setdefault(int(ds[j]), []).append((w[j].mean(), w[j].std()))
    return {k: np.asarray(v) for k, v in out.items()}


def test_make_batch_fn_statistics_match_jax():
    n, rounds = 64, 4
    jmake = jax.jit(j_syn.make_jax_batch_fn(64, n))
    want = _windowed_stats([(np.asarray(p), np.asarray(d))
                            for p, _, d in (jmake(jax.random.key(i)) for i in range(rounds))])
    tmake = t_syn.make_batch_fn(64, n, device="cpu")
    got = _windowed_stats([(p.numpy(), d.numpy())
                           for p, _, d in (tmake(torch.Generator().manual_seed(i)) for i in range(rounds))])
    assert sorted(got) == sorted(want) == list(range(5))
    for k in range(5):
        for stat, name in ((0, "mean"), (1, "std")):
            g, w = got[k][:, stat].mean(), want[k][:, stat].mean()
            print(f"profile {k} ({t_syn.PROFILE_NAMES_V2[k]}) windowed {name}: port {g:.4f} "
                  f"({len(got[k])} samples), JAX {w:.4f} ({len(want[k])})")
            assert abs(g - w) <= STATS_TOL, (k, name, g, w)


def test_signature_strength_scales_the_device_batches():
    flat = t_syn.make_batch_fn(32, 16, signature_strength=0.0, device="cpu")
    px, _, _ = flat(torch.Generator().manual_seed(0))
    default = t_syn.make_batch_fn(32, 16, device="cpu")(torch.Generator().manual_seed(0))[0]
    assert px.shape == default.shape and not torch.equal(px, default)
    assert t_syn.scaled_profiles_v2(1.0) is t_syn.PROFILES_V2


@pytest.mark.parametrize("accum,seek", [(1, 0), (2, 0), (1, 5)])
def test_synthetic_batches_are_bit_equal_to_the_jax_cli(accum, seek):
    jb = _jax_cli().SyntheticBatches(4, accum, 16, seed=3)
    tb = pretrain.SyntheticBatches(4, accum, 16, seed=3)
    jb.seek(seek)
    tb.seek(seek)
    for got, want in zip(iter(tb), [b for b, _ in zip(jb, range(3))]):
        np.testing.assert_array_equal(got.pixels, want.pixels)
        np.testing.assert_array_equal(got.spacing, want.spacing)
        np.testing.assert_array_equal(got.indices, want.indices)


@pytest.mark.parametrize("n_datasets", [2, 5])
def test_device_synthetic_batches_on_the_cpu(n_datasets):
    gen = pretrain.DeviceSyntheticBatches(3, 8, 2, 32, seed=3, n_datasets=n_datasets, device="cpu")
    it = iter(gen)
    first = [next(it) for _ in range(4)]
    assert first[0].pixels.shape == (2, 8, 32, 32, 3) and first[0].pixels.dtype == torch.uint16
    assert first[0].spacing.shape == (2, 8, 3) and first[0].spacing.dtype == torch.float32
    assert first[3].pixels is first[0].pixels  # cycled
    hu_means = first[0].pixels.float().mean(dim=(2, 3, 4)) - 32768.0
    if n_datasets == 2:  # two organ modes: lung-like (~-600) and abdomen (~+40)
        assert ((hu_means < -300) | (hu_means > -150)).all()
    gen.seek(4)
    assert next(iter(gen)).pixels is first[1].pixels
    again = pretrain.DeviceSyntheticBatches(3, 8, 2, 32, seed=3, n_datasets=n_datasets, device="cpu")
    assert torch.equal(next(iter(again)).pixels, first[0].pixels)
    with pytest.raises(ValueError):
        pretrain.DeviceSyntheticBatches(1, 8, 1, 32, n_datasets=3, device="cpu")
