"""The port's data layer (dinox_torch.data) against the JAX package's on the
same inputs: the index and its manifests, the epoch orders, the PNG
decoders, the canvas resize, the TrainLoader's batches and the decoded-slice
cache, plus the device prefetcher on the CPU.

Trees are written from fixed seeds with the port's encoder; every
comparison is bit for bit except the canvas resize, held within one uint16
step."""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from dinox_torch.data import index as t_index
from dinox_torch.data import pipeline as t_pipeline
from dinox_torch.data import png16
from dinox_torch.data import sampler as t_sampler
from dinox_torch.data import slice_cache as t_cache
from dinox_torch.data.prefetch import DevicePrefetcher
from dinox_tpu.data import index as j_index
from dinox_tpu.data import pipeline as j_pipeline
from dinox_tpu.data import sampler as j_sampler
from dinox_tpu.data import slice_cache as j_cache

# A small tree: 4 series of 6 slices, two at the canvas size (32), one
# larger (to shrink) and one smaller (to enlarge), each PNG with its own
# filter type.
CANVAS = 32
SERIES = [("s0", 32, 1.0), ("s1", 45, 2.5), ("s2", 24, 0.7), ("s3", 32, 1.25)]
N_SLICES = 6


def _rows(n_series=5, n_slices=7, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(n_series):
        for z in rng.permutation(n_slices):
            rows.append(dict(png_path=f"/d/s{s}/{z:03d}.png", series_dir=f"/d/s{s}",
                             slice_index=int(z), encoding="hu16", spacing_x=0.5 + s,
                             spacing_y=0.5 + s, spacing_z=1.0 + 0.5 * z, dataset=f"ds{s % 2}"))
    return rows


def _both(rows):
    return [j_index.IndexRow(**r) for r in rows], [t_index.IndexRow(**r) for r in rows]


def _astuples(rows):
    return [dataclasses.astuple(r) for r in rows]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(1234)
    rows = []
    for i, (name, size, sp) in enumerate(SERIES):
        (root / name).mkdir()
        base = rng.normal(0, 300, (size, size)).cumsum(axis=1)
        for z in range(N_SLICES):
            hu = base + rng.normal(0, 40, (size, size)) + 30 * z
            arr = np.clip(hu + 32768, 0, 65535).astype(np.uint16)
            path = root / name / f"{z:03d}.png"
            png16.write_png16(path, arr, filters=(i + z) % 5)
            rows.append(t_index.IndexRow(png_path=str(path), series_dir=str(root / name),
                                         slice_index=z, spacing_x=sp, spacing_y=sp,
                                         spacing_z=2 * sp))
    t_index.write_index_rows(rows, root / "index.csv")
    return root


# -- index, manifests, orders ---------------------------------------------------

INDEX_CASES = {
    "z_stride_1": lambda m, rows: m.z_stride_subsample(rows, 1),
    "z_stride_2": lambda m, rows: m.z_stride_subsample(rows, 2),
    "z_stride_3": lambda m, rows: m.z_stride_subsample(rows, 3),
    "shard_0_of_3": lambda m, rows: m.shard_rows(rows, 0, 3),
    "shard_2_of_3": lambda m, rows: m.shard_rows(rows, 2, 3),
    "exclude_val": lambda m, rows: m.exclude_val_series(rows, m.make_split_manifest(rows, 0.3, 5)),
    "select_val": lambda m, rows: m.select_val_series(rows, m.make_split_manifest(rows, 0.3, 5)),
    "neighbours": lambda m, rows: [n for r in rows for n in m.SeriesMap.build(rows[::2]).neighbors(r)],
}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_index_functions_match_jax(case):
    j_rows, t_rows = _both(_rows())
    got = INDEX_CASES[case](t_index, t_rows)
    want = INDEX_CASES[case](j_index, j_rows)
    assert got and _astuples(got) == _astuples(want)


def test_index_csv_and_manifest_round_trip(tmp_path):
    j_rows, t_rows = _both(_rows())
    t_index.write_index_rows(t_rows, tmp_path / "t.csv")
    j_index.write_index_rows(j_rows, tmp_path / "j.csv")
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    got = t_index.load_index_rows(tmp_path / "j.csv", require_spacing=True)
    assert _astuples(got) == _astuples(j_index.load_index_rows(tmp_path / "t.csv"))
    (tmp_path / "bare.csv").write_text("png_path,series_dir,slice_index\na.png,s,3\n")
    with pytest.warns(UserWarning, match="no spacing columns"):
        bare = t_index.load_index_rows(tmp_path / "bare.csv", require_spacing=True)
    assert _astuples(bare) == _astuples(j_index.load_index_rows(tmp_path / "bare.csv"))
    for frac, seed in ((0.1, 0), (0.5, 3)):
        assert t_index.make_split_manifest(t_rows, frac, seed) == j_index.make_split_manifest(j_rows, frac, seed)
    with pytest.raises(ValueError):
        t_index.shard_rows(t_rows, 3, 3)


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (7, 3)])
def test_orders_match_jax(seed, epoch):
    j_rows, t_rows = _both(_rows(n_series=6, n_slices=5, seed=seed))
    np.testing.assert_array_equal(t_sampler.shuffled_order(len(t_rows), seed, epoch),
                                  j_sampler.shuffled_order(len(j_rows), seed, epoch))
    order = t_sampler.diverse_order(t_rows, seed, epoch)
    np.testing.assert_array_equal(order, j_sampler.diverse_order(j_rows, seed, epoch))
    for bs, drop in ((4, True), (4, False), (7, False)):
        got, want = t_sampler.batched(order, bs, drop), j_sampler.batched(order, bs, drop)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# -- PNG decoding -------------------------------------------------------------


def _image(dtype, shape=(37, 29), seed=0):
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    smooth = (np.sin(xx / 6.0) + np.cos(yy / 4.0) + 2) / 4 * hi * 0.9
    return np.clip(smooth + rng.integers(0, hi // 16, shape), 0, hi).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_decoders_read_pil_pngs_as_the_jax_reader(tmp_path, dtype):
    arr = _image(dtype)
    path = tmp_path / "pil.png"
    Image.fromarray(arr).save(path)
    want = j_pipeline._read_png_u16(str(path))
    np.testing.assert_array_equal(want, arr.astype(np.uint16))
    data = path.read_bytes()
    assert png16.decode_native(data) is not None, "the native decoder should build here"
    np.testing.assert_array_equal(png16.decode_native(data), want)
    np.testing.assert_array_equal(png16.decode_stdlib(data), want)
    np.testing.assert_array_equal(t_pipeline._read_png_u16(str(path)), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
def test_write_png16_reads_back_in_both_packages(tmp_path, dtype, filters):
    arr = _image(dtype, seed=1)
    kinds = np.arange(arr.shape[0]) % 5 if filters == "mixed" else filters
    path = tmp_path / "w.png"
    png16.write_png16(path, arr, filters=kinds)
    want = arr.astype(np.uint16)
    np.testing.assert_array_equal(j_pipeline._read_png_u16(str(path)), want)
    with Image.open(path) as img:
        np.testing.assert_array_equal(np.asarray(img).astype(np.uint16), want)
    np.testing.assert_array_equal(png16.decode_native(path.read_bytes()), want)
    np.testing.assert_array_equal(png16.decode_stdlib(path.read_bytes()), want)


def test_stdlib_decoder_refuses_what_it_does_not_read(tmp_path):
    rgb = tmp_path / "rgb.png"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(rgb)
    with pytest.raises(ValueError, match="color type 2"):
        png16.decode_stdlib(rgb.read_bytes())
    with pytest.raises(ValueError):
        png16.decode_stdlib(b"not a png")
    png16.write_png16(tmp_path / "t.png", _image(np.uint16))
    with pytest.raises(ValueError):
        png16.decode_stdlib((tmp_path / "t.png").read_bytes()[:60])
    with pytest.raises(ValueError):
        png16.write_png16(tmp_path / "x.png", np.zeros((3, 3), np.float32))
    assert png16.decoder_in_use().startswith("native")


def test_native_library_builds_once_under_a_lock(tmp_path, monkeypatch):
    """Threads racing the first build see one library, built once."""
    monkeypatch.setattr(png16, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(png16, "_lib", None)
    monkeypatch.setattr(png16, "_lib_failed", False)
    calls = []
    build = png16._build
    monkeypatch.setattr(png16, "_build", lambda target: (calls.append(target), build(target)))
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(png16.get_lib())) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(libs) == 6 and all(lib is libs[0] for lib in libs)
    assert [p.name for p in (tmp_path / "native").iterdir() if p.suffix == ".so"] == [calls[0].name]


# -- the canvas resize ------------------------------------------------------------


@pytest.mark.parametrize("shape,size", [((64, 64), 96), ((96, 96), 64), ((45, 30), 32),
                                        ((512, 512), 224), ((23, 70), 40)])
def test_to_canvas_matches_pil(shape, size):
    rng = np.random.default_rng(sum(shape) + size)
    arr = np.clip(rng.normal(0, 400, shape).cumsum(axis=0) + 32768, 0, 65535).astype(np.uint16)
    got = t_pipeline._to_canvas(arr, size)
    want = j_pipeline._to_canvas(arr, size)
    assert got.shape == want.shape == (size, size) and got.dtype == np.uint16
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    print(f"{shape} -> {size}: {100 * np.mean(diff == 0):.3f}% of pixels bit-equal to PIL's")
    assert diff.max() <= 1
    assert t_pipeline._to_canvas(want, size) is want


# -- the loader ---------------------------------------------------------------


def _load_batches(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)], loader.position
    finally:
        loader.close()


LOADER_CASES = {"default": dict(), "diverse": dict(diverse=True),
                "host_0_of_2": dict(host_id=0, num_hosts=2), "host_1_of_2": dict(host_id=1, num_hosts=2),
                "resumed": dict(start_epoch=1, start_batch=2)}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_train_loader_matches_jax(tree, case):
    kw = dict(batch_size=4, seed=3, canvas=CANVAS, num_workers=3, **LOADER_CASES[case])
    rows = t_index.load_index_rows(tree / "index.csv")
    per_epoch = len(rows) // (4 * kw.get("num_hosts", 1))
    n = 2 * per_epoch
    got, got_pos = _load_batches(t_pipeline.TrainLoader(rows, **kw), n)
    want, want_pos = _load_batches(j_pipeline.TrainLoader(j_index.load_index_rows(tree / "index.csv"), **kw), n)
    assert got_pos == want_pos
    for g, w in zip(got, want):
        assert g.pixels.dtype == np.uint16 and g.pixels.shape == (4, CANVAS, CANVAS, 3)
        np.testing.assert_array_equal(g.pixels, w.pixels)
        np.testing.assert_array_equal(g.spacing, w.spacing)
        np.testing.assert_array_equal(g.indices, w.indices)


def test_train_loader_retries_a_corrupt_file_as_jax_does(tree, tmp_path):
    rows = t_index.load_index_rows(tree / "index.csv")
    bad = tmp_path / "bad.png"
    bad.write_bytes(png16.PNG_MAGIC + b"\x00" * 40)
    rows[5] = dataclasses.replace(rows[5], png_path=str(bad))
    j_rows = [j_index.IndexRow(**dataclasses.asdict(r)) for r in rows]
    kw = dict(batch_size=6, seed=1, canvas=CANVAS, num_workers=2)
    got, _ = _load_batches(t_pipeline.TrainLoader(rows, **kw), 4)
    want, _ = _load_batches(j_pipeline.TrainLoader(j_rows, **kw), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.pixels, w.pixels)
        np.testing.assert_array_equal(g.indices, w.indices)
    drawn = np.concatenate([g.indices for g in got]).tolist()
    assert 4 not in drawn and 5 not in drawn  # both read the bad file: substituted
    source = t_pipeline.SliceStackSource(rows, CANVAS)
    j_source = j_pipeline.SliceStackSource(j_rows, CANVAS)
    for idx in (4, 5):  # slice 4 reads the bad slice 5 as its z+1
        px, sp, actual = source.get(idx, np.random.default_rng(idx))
        jpx, jsp, jactual = j_source.get(idx, np.random.default_rng(idx))
        assert actual == jactual and actual not in (4, 5)
        np.testing.assert_array_equal(px, jpx)


@pytest.mark.parametrize("cache", ["memory", "small", "disk"])
def test_png_decodes_count_what_no_cache_held(tree, tmp_path, cache):
    """Two passes over every stack decode each slice once when the memory
    cache holds the tree, again in the second pass when it is smaller, and
    never when the decoded-slice cache holds it."""
    rows = t_index.load_index_rows(tree / "index.csv")
    disk = None
    if cache == "disk":
        t_cache.build_slice_cache(rows, CANVAS, tmp_path, workers=1)
        disk = t_cache.open_slice_cache(tmp_path, CANVAS)
    source = t_pipeline.SliceStackSource(rows, CANVAS, cache_slices=2 if cache == "small" else len(rows),
                                         decoded_cache=disk)
    for _ in range(2):
        for idx in range(len(rows)):
            source.get(idx)
    want = {"memory": len(rows), "disk": 0}.get(cache)
    if want is None:
        assert source.png_decodes > len(rows)
    else:
        assert source.png_decodes == want


# -- the decoded-slice cache ------------------------------------------------------


@pytest.mark.parametrize("made_by", ["jax", "port"])
def test_slice_cache_opens_in_the_other_package(tree, tmp_path, made_by):
    rows = t_index.load_index_rows(tree / "index.csv")
    out = tmp_path / made_by
    out.mkdir()
    build, opener = ((j_cache.build_slice_cache, t_cache.open_slice_cache) if made_by == "jax"
                     else (t_cache.build_slice_cache, j_cache.open_slice_cache))
    build_rows = rows if made_by == "port" else [j_index.IndexRow(**dataclasses.asdict(r)) for r in rows]
    build(build_rows, CANVAS, out, workers=2)
    cache = opener(out, CANVAS)
    assert cache is not None and len(cache) == len(rows)
    for r in rows:
        want = t_pipeline._to_canvas(t_pipeline._read_png_u16(r.png_path), CANVAS)
        np.testing.assert_array_equal(cache.get(r.png_path), want)
    assert t_cache.open_slice_cache(out, CANVAS + 1) is None
    t_stack = t_pipeline.SliceStackSource(rows, CANVAS, decoded_cache=t_cache.open_slice_cache(out, CANVAS))
    j_stack = j_pipeline.SliceStackSource(rows, CANVAS, decoded_cache=j_cache.open_slice_cache(out, CANVAS))
    for idx in (0, 7, len(rows) - 1):
        np.testing.assert_array_equal(t_stack.get(idx)[0], j_stack.get(idx)[0])


# -- the device prefetcher on the CPU -------------------------------------------


def test_device_prefetcher_on_the_cpu():
    rng = np.random.default_rng(0)
    batches = [t_pipeline.Batch(pixels=rng.integers(0, 65535, (2, 8, 8, 3)).astype(np.uint16),
                                spacing=rng.uniform(0.5, 2, (2, 3)).astype(np.float32),
                                indices=np.arange(2) + i) for i in range(5)]
    got = list(DevicePrefetcher(batches, device="cpu", depth=2))
    assert len(got) == 5
    for g, b in zip(got, batches):
        assert isinstance(g.pixels, torch.Tensor) and g.pixels.shape == (1, 2, 8, 8, 3)
        np.testing.assert_array_equal(g.pixels[0].numpy(), b.pixels)
        np.testing.assert_array_equal(g.spacing[0].numpy(), b.spacing)
        np.testing.assert_array_equal(g.indices, b.indices)

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    it = iter(DevicePrefetcher(broken(), device="cpu"))
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    with pytest.raises(ValueError):
        DevicePrefetcher(batches, device="cpu", depth=0)


def test_device_prefetcher_wants_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DevicePrefetcher([])
