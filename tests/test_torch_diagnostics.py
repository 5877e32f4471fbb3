"""The port's diagnostics (``diagnose_scale_pathway``, ``round5_data_probe``,
``round5_patch_probe``) and ``PatchViT.patch_tokens`` against the JAX
package and its scripts, loaded by path with importlib.

The CLIs read a hub dir, whose config carries no dtype, so both packages
load it in bfloat16: the zero-init case (exact zeros) and the probe keys
go through the CLIs. The numeric legs are held at float32 on the same
weights through each package's functions."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dinox_torch import diagnose_scale_pathway as diag
from dinox_torch import round5_data_probe, round5_patch_probe
from dinox_torch.data.hu import decode_hu16, encode_hu16, window
from dinox_torch.data.index import IndexRow, make_split_manifest, write_index_rows
from dinox_torch.data.pipeline import _read_png_u16
from dinox_torch.data.png16 import write_png16
from dinox_torch.data.synthetic import PROFILES_V2, synth_series_np
from dinox_torch.evaluation.embedder import _l2n
from dinox_torch.models import config as t_config
from dinox_torch.zoo.hub import LoadedModel
from dinox_torch.zoo.interop import jax_to_torch_backbone
from dinox_tpu.data import index as j_index
from dinox_tpu.evaluation import embedder as j_embedder
from dinox_tpu.models import config as j_config
from dinox_tpu.models.vit import PatchViT as JPatchViT
from dinox_tpu.models.vit import init_backbone
from dinox_tpu.ops.augment import eval_transform as j_eval_transform
from dinox_tpu.zoo.hub import LoadedModel as JLoadedModel
from dinox_tpu.zoo.hub import export_hub_checkpoint

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
# The JAX diagnostic test's TINY config (tests/test_scale_diagnostic.py).
TINY = dict(name="tiny-diag", img_size=32, patch=16, dim=64, depth=2, heads=2, out_dim=128,
            num_registers=4, scale_aware=True, attn_impl="xla", dtype="float32")
RTOL, ATOL = 1e-5, 1e-6


def _load(name):
    if str(SCRIPTS) not in sys.path:  # round5_patch_probe imports evaluate_panorgan from there
        sys.path.insert(0, str(SCRIPTS))
    spec = importlib.util.spec_from_file_location(f"{name}_cli", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jdiag():
    return _load("diagnose_scale_pathway")


def _twins(params):
    """The JAX model and the port's float32 model on *params*."""
    model = LoadedModel(t_config.ModelConfig(**TINY), "cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in jax_to_torch_backbone(params).items()})
    return model, JLoadedModel(j_config.ModelConfig(**TINY), params)


def test_zero_init_is_a_noop_in_both_clis(jdiag, tmp_path):
    hub = tmp_path / "hub"
    jcfg = j_config.ModelConfig(**TINY)
    export_hub_checkpoint(JLoadedModel(jcfg, init_backbone(jcfg, jax.random.key(0))), hub)
    reps = []
    for main, extra in ((diag.main, ["--device", "cpu"]), (jdiag.main, [])):
        out = tmp_path / f"{len(reps)}.json"
        assert main(["--checkpoint", str(hub), "--n", "8", "--canvas", "64", "--out", str(out),
                     *extra]) == 0
        reps.append(json.loads(out.read_text()))
    for rep in reps:
        st = rep["scale_token"]
        assert st["post_ln_norm_mean"] == 0.0
        assert st["scale_vec_cosdist_2x"] is None and st["scale_vec_cosdist_0.5x"] is None
        assert rep["input_mix"]["scale_to_token_ratio"] == 0.0
        for v in rep["counterfactual"]["cosdist_vs_multiplier"].values():
            assert abs(v) < 1e-5
    port, jax_rep = reps
    assert port.keys() == jax_rep.keys() and port["n"] == jax_rep["n"] == 8
    assert port["scale_token"].keys() == jax_rep["scale_token"].keys()


def _scalars(rep, prefix=""):
    for k, v in rep.items():
        if isinstance(v, dict):
            yield from _scalars(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("case", ["live", "ln_pin"])
def test_every_leg_matches_the_jax_script_at_float32(jdiag, case):
    params = init_backbone(j_config.ModelConfig(**TINY), jax.random.key(1))
    se = params["scale_embed"]
    shape = se["fc2"]["kernel"].shape
    if case == "ln_pin":  # fc2 just off zero: the LayerNorm pins the norm (the JAX test's case)
        se["fc2"]["kernel"] = jax.random.normal(jax.random.key(2), shape) * 1e-2
    else:  # a trained-looking pathway: fc2 and the LN gamma moved
        rng = np.random.default_rng(3)
        se["fc2"]["kernel"] = rng.normal(0, 0.3, shape).astype(np.float32)
        se["norm"]["scale"] = (1 + 0.2 * rng.normal(size=se["norm"]["scale"].shape)).astype(np.float32)
    model, jmodel = _twins(params)

    x, sp = diag.make_batch(8, 64, 32, 42)
    jx, jsp = jdiag.make_batch(8, 64, 32, 42)
    np.testing.assert_array_equal(sp, jsp)
    np.testing.assert_allclose(x.numpy(), jx, atol=1e-5, rtol=0)
    with jax.default_matmul_precision("highest"):
        want = {"scale_token": jdiag.scale_token_stats(jmodel, jsp),
                "counterfactual": jdiag.counterfactual_curve(jmodel, jx, jsp)}
        want["input_mix"] = jdiag.input_mix_ratio(jmodel, jx, want["scale_token"]["post_ln_norm_mean"])
    got = {"scale_token": diag.scale_token_stats(model, sp),
           "counterfactual": diag.counterfactual_curve(model, x, sp)}
    got["input_mix"] = diag.input_mix_ratio(model, x, got["scale_token"]["post_ln_norm_mean"])
    got, want = dict(_scalars(got)), dict(_scalars(want))
    assert got.keys() == want.keys() and len(got) == 13
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=RTOL, abs=ATOL), k
    st = got
    assert st["scale_token.scale_vec_cosdist_2x"] > 1e-4
    if case == "ln_pin":
        assert st["scale_token.pre_ln_norm_mean"] < 0.2 * st["scale_token.ln_pin_norm"]
        assert st["scale_token.post_ln_norm_mean"] == pytest.approx(st["scale_token.ln_pin_norm"], rel=0.1)


def test_patch_tokens_match_jax():
    params = init_backbone(j_config.ModelConfig(**TINY), jax.random.key(4))
    model, _ = _twins(params)
    x = np.random.default_rng(5).normal(size=(3, 32, 32, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = JPatchViT(j_config.ModelConfig(**TINY)).apply({"params": params}, x,
                                                              method="patch_tokens")
    got = model.patch_tokens(torch.from_numpy(x))
    assert tuple(got.shape) == (3, 4, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two v2 profiles, 10 series of 4 64^2 slices each, written with
    write_png16, every series in the val split (make_split_manifest)."""
    root = tmp_path_factory.mktemp("probe_tree")
    rows = []
    for s in range(10):
        prof = PROFILES_V2[s % 2]
        vol = synth_series_np(prof, np.random.default_rng([7, s]), 4, 64)
        (root / f"s{s}").mkdir()
        for z in range(4):
            path = root / f"s{s}" / f"{z}.png"
            write_png16(path, encode_hu16(vol[z]), filters=z % 5)
            rows.append(IndexRow(png_path=str(path), series_dir=f"s{s}", slice_index=z, spacing_x=0.7,
                                 spacing_y=0.7, spacing_z=1.0 + 0.5 * (s % 2), dataset=prof.name))
    write_index_rows(rows, root / "index.csv")
    manifest = make_split_manifest(rows, val_fraction=1.0)
    (root / "split_manifest.json").write_text(json.dumps(manifest))
    return root, rows


def test_data_probe_features_and_accuracy_match_the_jax_script(tree, tmp_path):
    root, rows = tree
    jprobe = _load("round5_data_probe")
    for r in rows[::7]:
        img = window(decode_hu16(_read_png_u16(r.png_path)), 40.0, 400.0)
        np.testing.assert_allclose(round5_data_probe.features(img), jprobe.features(img), rtol=1e-5, atol=0)
    outs = [tmp_path / "port.json", tmp_path / "jax.json"]
    assert round5_data_probe.main(["--trees", str(root), "--out", str(outs[0])]) == 0
    assert jprobe.main(["--trees", str(root), "--out", str(outs[1])]) == 0
    port, jax_rep = (json.loads(p.read_text()) for p in outs)
    assert port == jax_rep
    (res,) = port["results"]
    assert res["n_slices"] == 40 and res["n_test_series"] == 2 and res["chance"] == 0.5


def test_patch_probe_matches_the_jax_script(tree, tmp_path):
    root, rows = tree
    params = init_backbone(j_config.ModelConfig(**TINY), jax.random.key(6))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * np.random.default_rng(8).normal(size=a.shape).astype(np.float32), params)
    model, jmodel = _twins(params)
    cls, patch = round5_patch_probe.cls_and_mean_patch(model, rows, canvas=64, batch_size=16)
    # The JAX script's loop (scripts/round5_patch_probe.py:72-80) on the same rows.
    jrows = [j_index.IndexRow(**vars(r)) for r in rows]
    jcls, jpatch = [], []
    with jax.default_matmul_precision("highest"):
        for pixels, spacing in j_embedder._load_batches(jrows, np.arange(len(jrows)), 64, 16):
            feats = jmodel(j_eval_transform(jax.numpy.asarray(pixels), img_size=32),
                           jax.numpy.asarray(spacing))
            jcls.append(np.asarray(feats[:, 0], np.float32))
            jpatch.append(np.asarray(feats[:, 1:1 + 4].mean(axis=1), np.float32))
    for got, want in ((cls, jcls), (patch, jpatch)):
        cos = np.sum(_l2n(got) * _l2n(np.concatenate(want)), axis=1)
        assert got.shape == (40, 64) and (1.0 - cos).max() < 1e-4

    # Both CLIs on a hub dir of these weights: the same rows, the probe keys.
    hub = tmp_path / "hub"
    export_hub_checkpoint(jmodel, hub)
    argv = ["--checkpoint", str(hub), "--index-csv", str(root / "index.csv"), "--split-manifest",
            str(root / "split_manifest.json"), "--batch-size", "16", "--canvas", "64"]
    reps = []
    for main, extra in ((round5_patch_probe.main, ["--device", "cpu"]),
                        (_load("round5_patch_probe").main, [])):
        out = tmp_path / f"{len(reps)}.json"
        assert main(argv + ["--out", str(out), *extra]) == 0
        reps.append(json.loads(out.read_text()))
    for rep in reps:
        assert rep["n_slices"] == 40
        for pool in ("cls", "mean_patch"):
            assert set(rep[pool]) == {"accuracy", "auc", "knn_accuracy"}
