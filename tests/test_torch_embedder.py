"""The port's evaluation embedder against the JAX package's, on a tiny
float32 ViT with the same weights over a small tree of write_png16 slices:
embed_rows (the deterministic path, with its spacing scale) within 1e-4,
and embed_two_views under an AugConfig whose ranges are all pinned and
whose flip probability is 0 (so both packages' views are the same
function of the pixels) within 1e-4. With random ranges the views cannot
be equal: jax.random's streams are not reproduced."""

import jax
import numpy as np
import pytest
import torch

from dinox_torch.data import index as t_index
from dinox_torch.data.png16 import write_png16
from dinox_torch.evaluation import embedder
from dinox_torch.models import config as t_config
from dinox_torch.ops.augment import AugConfig
from dinox_torch.zoo.hub import LoadedModel
from dinox_torch.zoo.interop import jax_to_torch_backbone
from dinox_tpu.data import index as j_index
from dinox_tpu.evaluation import embedder as j_embedder
from dinox_tpu.models import config as j_config
from dinox_tpu.models.vit import init_backbone
from dinox_tpu.ops.augment import AugConfig as JAugConfig
from dinox_tpu.zoo.hub import LoadedModel as JLoadedModel

CFG = dict(name="tiny", img_size=28, patch=14, dim=32, depth=2, heads=2, out_dim=16,
           scale_aware=True, dtype="float32")
CANVAS = 32


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    rows = []
    for s in range(3):
        (root / f"s{s}").mkdir()
        for z in range(5):
            path = root / f"s{s}" / f"{z}.png"
            size = 40 if s else 32
            write_png16(path, rng.integers(31000, 34500, (size, size)).astype(np.uint16), filters=z % 5)
            rows.append(dict(png_path=str(path), series_dir=f"s{s}", slice_index=z,
                             spacing_x=0.6 + 0.2 * s, spacing_y=0.7, spacing_z=1.5 + s, dataset=f"ds{s % 2}"))
    return [t_index.IndexRow(**r) for r in rows], [j_index.IndexRow(**r) for r in rows]


@pytest.fixture(scope="module")
def models():
    jcfg = j_config.ModelConfig(**CFG)
    params = init_backbone(jcfg, jax.random.key(0))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    model = LoadedModel(t_config.ModelConfig(**CFG), "cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_to_torch_backbone(params).items()})
    return model, JLoadedModel(jcfg, params)


@pytest.mark.parametrize("spacing_scale", [1.0, 2.0])
def test_embed_rows_matches_jax(tree, models, spacing_scale):
    (rows, jrows), (model, jmodel) = tree, models
    with jax.default_matmul_precision("highest"):
        want, want_sp = j_embedder.embed_rows(jmodel, jrows, batch_size=4, canvas=CANVAS,
                                              spacing_scale=spacing_scale)
    got, got_sp = embedder.embed_rows(model, rows, batch_size=4, canvas=CANVAS,
                                      spacing_scale=spacing_scale)
    assert got.dtype == np.float32 and got.shape == want.shape == (15, 32)
    np.testing.assert_array_equal(got_sp, want_sp)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_embed_two_views_with_pinned_ranges_matches_jax(tree, models):
    (rows, jrows), (model, jmodel) = tree, models
    pinned = dict(img_size=28, level_min=40.0, level_max=40.0, width_min=400.0, width_max=400.0,
                  crop_scale_min=1.0, crop_scale_max=1.0, aspect_min=1.0, aspect_max=1.0,
                  hflip_prob=0.0)
    idxs = np.asarray([4, 0, 9, 13, 7, 2])
    with jax.default_matmul_precision("highest"):
        wq, wk = j_embedder.embed_two_views(jmodel, jrows, idxs, seed=3, batch_size=4, canvas=CANVAS,
                                            aug=JAugConfig(**pinned))
    q, k = embedder.embed_two_views(model, rows, idxs, seed=3, batch_size=4, canvas=CANVAS,
                                    aug=AugConfig(**pinned))
    np.testing.assert_allclose(q, wq, atol=1e-4, rtol=0)
    np.testing.assert_allclose(k, wk, atol=1e-4, rtol=0)
    # The deterministic path sees the same pinned window and whole-image box
    # (over all rows: the 2.5D stacks take their neighbours from the rows given).
    det, _ = embedder.embed_rows(model, rows, batch_size=4, canvas=CANVAS)
    np.testing.assert_allclose(q, det[idxs], atol=1e-5, rtol=0)


def test_two_views_draw_from_the_seed(tree, models):
    (rows, _), (model, _) = tree, models
    idxs = np.arange(6)
    q1, k1 = embedder.embed_two_views(model, rows, idxs, seed=5, batch_size=4, canvas=CANVAS)
    q2, k2 = embedder.embed_two_views(model, rows, idxs, seed=5, batch_size=4, canvas=CANVAS)
    q3, _ = embedder.embed_two_views(model, rows, idxs, seed=6, batch_size=4, canvas=CANVAS)
    np.testing.assert_array_equal(q1, q2)
    np.testing.assert_array_equal(k1, k2)
    assert not np.array_equal(q1, k1) and not np.array_equal(q1, q3)
