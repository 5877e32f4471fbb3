"""The port's CIFAR control (dinox_torch.ops.augment_rgb, data.cifar and
the baseline_cifar10_* CLIs) against the JAX package's: the colour jitter
and the view pipeline fed the uniforms that JAX's keys give (f32 within
1e-5), the sampler's coin rates and crop statistics, the eval transform's
golden, the data bit for bit, the batch orders, three training steps of a
tiny CIFAR config from one state on the same views (losses within 1e-4
relative, parameters within 1e-5), kernel 1's and the dq/dkv pair's plain
versions at N = 69, hd 32 against the Pallas kernels in interpret mode, the
probe's estimator against scikit-learn's on the same embeddings, and the
three CLIs end to end on the CPU."""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dinox_torch import baseline_cifar10_linear_probe as t_probe
from dinox_torch import baseline_cifar10_pretrain as t_pretrain
from dinox_torch import baseline_cifar10_view_retrieval_eval as t_retrieval
from dinox_torch.data import cifar as t_cifar
from dinox_torch.evaluation.linear import LogisticRegression
from dinox_torch.models.config import ModelConfig
from dinox_torch.ops import augment_rgb as t_rgb
from dinox_torch.ops.flash_attention import packed_attention_backward_reference, packed_attention_reference
from dinox_torch.train.state import TrainConfig, state_from_jax
from dinox_torch.train.step import METRICS, build_train_step
from dinox_tpu.data import cifar as j_cifar
from dinox_tpu.models import config as j_config
from dinox_tpu.ops import augment_rgb as j_rgb
from dinox_tpu.ops.flash_attention import _packed_bwd
from dinox_tpu.ops.flash_attention import flash_attention_packed as jax_flash_attention_packed
from dinox_tpu.train import state as j_state
from dinox_tpu.train import step as j_step
from tests.test_torch_train_step import _as_tree, _assert_params_close, _jax_start

TOL = 1e-5  # f32: the same arithmetic, the products with 3-vectors in another order


def _jax_draws(key):
    """The uniforms in [0, 1) that augment_rgb's _one_view draws from *key*,
    in the port's DRAWS layout."""
    k_crop, k_flip, k_japply, k_jit, k_gray = jax.random.split(key, 5)
    k_area, k_aspect, k_top, k_left = jax.random.split(k_crop, 4)
    u = jax.random.uniform
    return np.concatenate([
        u(k_area, (10,)), u(k_aspect, (10,)), [u(k_top, ())], [u(k_left, ())], [u(k_flip, ())],
        [u(k_japply, ())], [u(k, ()) for k in jax.random.split(k_jit, 4)], [u(k_gray, ())],
    ]).astype(np.float32)


def test_color_jitter_matches_jax():
    cfg = j_rgb.RgbAugConfig()
    x = np.random.default_rng(0).uniform(size=(6, 8, 8, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.key(1), len(x))
    want = np.stack([np.asarray(j_rgb._color_jitter(jnp.asarray(xi), k, cfg)) for xi, k in zip(x, keys)])
    u = np.stack([[jax.random.uniform(k, ()) for k in jax.random.split(key, 4)] for key in keys])
    got = t_rgb._color_jitter(torch.from_numpy(x), torch.from_numpy(u.astype(np.float32)),
                              t_rgb.RgbAugConfig()).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_view_pipeline_matches_jax(dtype):
    """Each (view, image) of augment_rgb_views' keys through JAX's _one_view
    op by op. (XLA's compiled augment_rgb_views reassociates the colour
    arithmetic: it differs from the same _one_view by up to ~2e-5 after the
    normalisation, which is why the reference here is the uncompiled one.)"""
    rng = np.random.default_rng(2)
    px = (rng.integers(0, 256, (5, 32, 32, 3)).astype(np.uint8) if dtype == "uint8"
          else rng.uniform(0, 1, (5, 40, 36, 3)).astype(np.float32))
    cfg = j_rgb.RgbAugConfig()
    key = jax.random.key(3)
    keys = [jax.random.fold_in(jax.random.fold_in(key, v), i)
            for v in range(cfg.n_views) for i in range(len(px))]
    want = np.stack([np.asarray(j_rgb._one_view(jnp.asarray(px[n % len(px)]), k, cfg))
                     for n, k in enumerate(keys)])
    u = np.stack([_jax_draws(k) for k in keys])
    images = torch.from_numpy(np.concatenate([px] * cfg.n_views))
    got = t_rgb.views_from_draws(images, torch.from_numpy(u), t_rgb.RgbAugConfig()).numpy()
    assert got.shape == (10, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_sampler_rates_and_crops_match_jax():
    """The coins' rates (flip 0.5, jitter 0.8, gray 0.2) and the crop boxes'
    area and aspect statistics over 2000 draws from each package."""
    n = 2000
    ju = np.stack([_jax_draws(k) for k in jax.random.split(jax.random.key(4), n)])
    tu = torch.rand((n, t_rgb.DRAWS), generator=torch.Generator().manual_seed(0)).numpy()
    cfg = t_rgb.RgbAugConfig()
    for at, p in ((t_rgb.FLIP, cfg.hflip_prob), (t_rgb.JITTER_APPLY, cfg.jitter_prob),
                  (t_rgb.GRAY, cfg.grayscale_prob)):
        assert abs(np.mean(tu[:, at] < p) - np.mean(ju[:, at] < p)) < 0.04
        assert abs(np.mean(tu[:, at] < p) - p) < 0.03
    boxes = []
    for u in (ju, tu):
        u = torch.from_numpy(u)
        boxes.append([b.numpy() for b in t_rgb._sample_crop_box(
            u[:, :10], u[:, 10:20], u[:, t_rgb.TOP], u[:, t_rgb.LEFT], 32, 32, cfg.crop_cfg)])
    # the same draws give JAX's own boxes
    jt, jl, jch, jcw = (np.asarray(a) for a in jax.vmap(lambda k: j_rgb._sample_crop_box(
        jax.random.split(k, 5)[0], 32, 32, j_rgb.RgbAugConfig().crop_cfg))(
        jax.random.split(jax.random.key(4), n)))
    np.testing.assert_allclose(boxes[0][2], jch, atol=1e-4)
    np.testing.assert_allclose(boxes[0][3], jcw, atol=1e-4)
    (_, _, ach, acw), (_, _, bch, bcw) = boxes
    assert abs(np.mean(ach * acw) - np.mean(bch * bcw)) / 1024 < 0.02
    assert abs(np.mean(np.log(acw / ach)) - np.mean(np.log(bcw / bch))) < 0.02


def test_augment_rgb_views_shapes_and_determinism():
    x = torch.from_numpy(t_cifar.synthetic_cifar(8, 1)[0])
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    a, b, c = (t_rgb.augment_rgb_views(x, gen(s)) for s in (0, 0, 1))
    assert a.shape == (2, 8, 32, 32, 3) and a.dtype == torch.float32 and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a[0], a[1])


def test_eval_transform_golden():
    x = np.full((1, 32, 32, 3), 128, np.uint8)
    want = np.asarray(j_rgb.cifar_eval_transform(jnp.asarray(x)))
    got = t_rgb.cifar_eval_transform(x).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    golden = (128 / 255.0 - np.asarray(t_rgb.CIFAR_MEAN)) / np.asarray(t_rgb.CIFAR_STD)
    np.testing.assert_allclose(got[0, 0, 0], golden, atol=1e-5)


def test_data_bit_equal(tmp_path):
    for a, b in zip(t_cifar.synthetic_cifar(120, 30, seed=3), j_cifar.synthetic_cifar(120, 30, seed=3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(5)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": rng.integers(0, 256, (4, 3072)).astype(np.uint8),
             b"labels": rng.integers(0, 10, 4).tolist()}
        (tmp_path / name).write_bytes(pickle.dumps(d))
    got, want = t_cifar.load_cifar10(tmp_path), j_cifar.load_cifar10(tmp_path)
    assert got[-1] is want[-1] is True
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert t_cifar.load_cifar10(tmp_path / "none", (50, 10))[-1] is False


def test_batch_orders_bit_equal():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "scripts" / "baseline_cifar10_pretrain.py"
    spec = importlib.util.spec_from_file_location("j_cifar_pretrain", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    images = t_cifar.synthetic_cifar(50, 1)[0]
    got, want = iter(t_pretrain.CifarBatches(images, 8, 2, 3)), iter(script.CifarBatches(images, 8, 2, 3))
    for _ in range(7):  # past an epoch's end (3 steps of 16 an epoch)
        a, b = next(got), next(want)
        for f in ("pixels", "spacing", "indices"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# A tiny CIFAR config (N = 69 at img 32, patch 4, 4 registers), f32, plain attention.
MODEL = dict(name="cifar-vit", img_size=32, patch=4, dim=32, depth=2, heads=2, out_dim=64,
             num_registers=4, dtype="float32", attn_impl="xla")
TRAIN = dict(img_size=32, batch_size=8, lr=1e-3, warmup_steps=2, max_steps=50, koleo_weight=0.1,
             gram_weight=1.0, train_seed=0)


def _jax_views(px, key, aug_cfg):
    v = j_rgb.cifar_eval_transform(px)
    return jnp.stack([v, v[:, :, ::-1] * 0.9])


def _torch_views(px, generator, aug_cfg):
    v = t_rgb.cifar_eval_transform(px)
    return torch.stack([v, v.flip(2) * 0.9])


def test_three_cifar_steps_match_jax():
    jcfg = j_state.TrainConfig(model=j_config.ModelConfig(**MODEL), **TRAIN)
    tcfg = TrainConfig(model=ModelConfig(**MODEL), **TRAIN)
    jstate = _jax_start(jcfg)
    tstate = state_from_jax(tcfg, _as_tree(jstate), device="cpu")
    jfn = j_step.build_train_step(jcfg, donate=False, augment_fn=_jax_views)
    tfn = build_train_step(tcfg, device="cpu", augment_fn=_torch_views)
    images = t_cifar.synthetic_cifar(24, 1, seed=1)[0]
    for i in range(3):
        px = images[8 * i: 8 * i + 8][None]
        sp = np.ones((1, 8, 3), np.float32)
        jstate, jm = jfn(jstate, jnp.asarray(px), jnp.asarray(sp))
        tstate, tm = tfn(tstate, px, sp)
        for k in ("loss", "loss_dino", "loss_gram", "loss_koleo"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
        assert set(tm) == set(METRICS)
        _assert_params_close(tstate.student, jstate.student, tcfg.lr)
        _assert_params_close(tstate.teacher, jstate.teacher, tcfg.lr)


# Kernel 1's and the pair's plain versions at the CIFAR N (69: one 64-row
# tile and a 5-key tail) and head dim 32; f32 and the JAX bf16 tolerances of
# tests/test_torch_attention.py.
SHAPE = (2, 69, 3 * 64, 2)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_packed_attention_at_n69_hd32_matches_pallas(dtype, tol):
    x = np.random.default_rng(6).normal(size=SHAPE[:3]).astype(np.float32)
    want = np.asarray(jax_flash_attention_packed(jnp.asarray(x, dtype), SHAPE[3]), np.float32)
    got = packed_attention_reference(torch.from_numpy(x).to(getattr(torch, dtype)), SHAPE[3])
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1.6e-2)])
def test_packed_backward_at_n69_hd32_matches_pallas(dtype, tol):
    rng = np.random.default_rng(7)
    x = rng.normal(size=SHAPE[:3]).astype(np.float32)
    g = rng.normal(size=SHAPE[:2] + (SHAPE[2] // 3,)).astype(np.float32)
    want = np.asarray(_packed_bwd(jnp.asarray(x, dtype), jnp.asarray(g, dtype), SHAPE[3]), np.float32)
    tdt = getattr(torch, dtype)
    got = packed_attention_backward_reference(torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt),
                                              SHAPE[3])
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_probe_estimator_matches_sklearn():
    """The probe's multinomial C = 10 regression against scikit-learn's
    LogisticRegression(max_iter=2000, C=10.0) on the same L2-normalised
    embeddings: top-1 within 0.02."""
    from sklearn.linear_model import LogisticRegression as SkLogisticRegression

    rng = np.random.default_rng(8)
    centres = rng.normal(size=(10, 24))
    y_tr, y_te = rng.integers(0, 10, 600), rng.integers(0, 10, 300)
    e_tr, e_te = (centres[y] + 2.5 * rng.normal(size=(len(y), 24)) for y in (y_tr, y_te))
    e_tr, e_te = (e / np.linalg.norm(e, axis=1, keepdims=True) for e in (e_tr, e_te))
    ours = LogisticRegression(C=10.0, max_iter=t_probe.PROBE_MAX_ITER).fit(e_tr, y_tr)
    theirs = SkLogisticRegression(max_iter=2000, C=10.0).fit(e_tr, y_tr)
    a, b = (float((m.predict(e_te) == y_te).mean()) for m in (ours, theirs))
    assert 0.3 < b < 1.0 and abs(a - b) <= 0.02, (a, b)


def test_cifar_clis_on_the_cpu(tmp_path, capsys):
    run = tmp_path / "run"
    assert t_pretrain.main(["--run-dir", str(run), "--dim", "32", "--depth", "2", "--heads", "2",
                            "--out-dim", "64", "--batch-size", "16", "--max-steps", "3",
                            "--warmup-steps", "1", "--ckpt-every", "3", "--log-json",
                            "--device", "cpu"]) == 0
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["model"]["name"] == "cifar-vit" and cfg["model"]["dtype"] == "float32"
    lines = [json.loads(s) for s in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3] and all(np.isfinite(r["loss"]) for r in lines)
    out = tmp_path / "probe.json"
    rc = t_probe.main(["--checkpoint", str(run), "--max-train", "300", "--out", str(out),
                       "--device", "cpu"])
    res = json.loads(out.read_text())
    assert rc == (0 if res["passed"] else 2) and res["n_train"] == 300 and res["n_test"] == 1000
    assert res["real_cifar"] is False and 0.0 <= res["top1"] <= 1.0
    assert ("PASS" if res["passed"] else "FAIL") + ": top1=" in capsys.readouterr().out
    out = tmp_path / "retrieval.json"
    rc = t_retrieval.main(["--checkpoint", str(run), "--n", "64", "--out", str(out), "--device", "cpu"])
    res = json.loads(out.read_text())
    assert rc == (0 if res["passed"] else 2) and res["n"] == 64 and res["real_cifar"] is False


def test_clis_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pretrain.main(["--run-dir", str(tmp_path / "run")])
