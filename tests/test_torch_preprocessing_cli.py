"""The port's preprocessing CLIs (python -m dinox_torch.preprocessing.*)
against the JAX package's scripts, both run in-process through ``main(argv)``
on the same inputs (the scripts loaded by path): index CSVs and manifests
equal once each run's output root is named alike, every PNG decoded to
equal pixels (the scripts' PIL files against the port's write_png16 files,
each read by PIL and by the port's decoder), the 8-bit previews' pixels and
the QA report equal, the slice caches byte-equal, the LIDC CSVs and crops
equal."""

import csv
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from dinox_torch.data.dicom import write_dicom
from dinox_torch.data.hu import HU_CLIP, encode_hu16
from dinox_torch.data.index import load_index_rows
from dinox_torch.data.nifti import write_nifti
from dinox_torch.data.png16 import read_png16
from dinox_torch.preprocessing import (
    build_slice_cache,
    combine_indices,
    extract_dicom_spacing,
    extract_lidc_malignancy,
    make_split_manifest,
    make_synthetic_data,
    preprocess_dicom,
    preprocess_nifti,
    validate_samples,
)

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts" / "preprocessing"


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(tmp_path, name, port, argv):
    """Runs the script and the port's CLI with *argv*, where "{out}" is each
    run's own output root. Returns the two roots."""
    roots = []
    for who, main in (("jax", _script(name).main), ("port", port.main)):
        root = tmp_path / who
        root.mkdir(exist_ok=True)
        assert main([a.replace("{out}", str(root)) for a in argv]) == 0, who
        roots.append(root)
    return roots


def _text(path, root):
    return Path(path).read_text().replace(str(root), "<out>")


def _pixels_equal(a, b):
    """A PNG of each run: the same depth and pixels through PIL, the same
    pixels through the port's decoder."""
    want = np.asarray(Image.open(a))
    got = np.asarray(Image.open(b))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for got in (read_png16(b), read_png16(a)):  # uint16 for either depth
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _trees_equal(jroot, troot):
    jfiles = sorted(p.relative_to(jroot) for p in jroot.rglob("*.png"))
    assert jfiles and jfiles == sorted(p.relative_to(troot) for p in troot.rglob("*.png"))
    for rel in jfiles:
        _pixels_equal(jroot / rel, troot / rel)
    return jfiles


@pytest.mark.parametrize("extra", [[], ["--five-datasets", "--signature-strength", "1.5"],
                                   ["--datasets", "organa", "lidc_like", "dsx"]])
def test_make_synthetic_data(tmp_path, extra):
    jr, tr = _both(tmp_path, "make_synthetic_data", make_synthetic_data,
                   ["--out", "{out}", "--series-per-dataset", "2", "--slices-per-series", "3",
                    "--size", "32", *extra])
    assert _text(jr / "index.csv", jr) == _text(tr / "index.csv", tr)
    assert _text(jr / "split_manifest.json", jr) == _text(tr / "split_manifest.json", tr)
    _trees_equal(jr, tr)


@pytest.fixture
def dicom_tree(tmp_path):
    """Two series of four slices, written out of z order, with a bogus
    SliceThickness (the median z step must win) and a non-unit slope."""
    src = tmp_path / "raw"
    rng = np.random.default_rng(0)
    for s in range(2):
        d = src / f"series{s}"
        d.mkdir(parents=True)
        for k, z in enumerate((3, 0, 2, 1)):
            write_dicom(d / f"{k}.dcm", rng.integers(-200, 3000, (20, 16)).astype(np.int16),
                        series_uid=f"1.2.{s}", patient_id=f"P{s}", position_z=2.5 * z + s,
                        slice_thickness=99.0, pixel_spacing=(0.6 + 0.1 * s, 0.8),
                        rescale_slope=1.0 + s, rescale_intercept=-1024.0)
    return src


def test_preprocess_dicom(tmp_path, dicom_tree):
    jr, tr = _both(tmp_path, "preprocess_dicom", preprocess_dicom,
                   ["--src", str(dicom_tree), "--out", "{out}", "--dataset", "testds"])
    assert _text(jr / "_index/index.csv", jr) == _text(tr / "_index/index.csv", tr)
    assert len(_trees_equal(jr, tr)) == 8
    rows = load_index_rows(tr / "_index/index.csv")
    assert rows[0].spacing_z == 2.5 and {r.series_dir for r in rows} == {"testds/1_2_0", "testds/1_2_1"}
    # skip-if-exists: a second run leaves the PNGs as they are
    first = Path(rows[0].png_path).stat().st_mtime_ns
    assert preprocess_dicom.main(["--src", str(dicom_tree), "--out", str(tr), "--dataset", "testds"]) == 0
    assert Path(rows[0].png_path).stat().st_mtime_ns == first


def test_preprocess_dicom_dry_run_and_missing_src(tmp_path):
    jr, tr = _both(tmp_path, "preprocess_dicom", preprocess_dicom,
                   ["--out", "{out}", "--dataset", "d", "--dry-run"])
    assert _text(jr / "_index/index.csv", jr) == _text(tr / "_index/index.csv", tr)
    assert len(_trees_equal(jr, tr)) == 8
    assert preprocess_dicom.main(["--out", str(tmp_path / "x"), "--dataset", "d"]) == 2


def test_preprocess_nifti(tmp_path):
    src = tmp_path / "vols"
    src.mkdir()
    rng = np.random.default_rng(1)
    vol = rng.normal(0, 900, (12, 10, 3)).astype(np.float32)
    write_nifti(src / "colon_001.nii.gz", vol, spacing=(0.9, 0.8, 5.0))
    write_nifti(src / "colon_002.nii", rng.normal(-300, 2000, (8, 8, 2)).astype(np.float32),
                spacing=(0.7, 0.7, 2.0))
    (src / "._colon_003.nii").write_bytes(b"resource fork")
    jr, tr = _both(tmp_path, "preprocess_nifti", preprocess_nifti,
                   ["--src", str(src), "--out", "{out}", "--dataset", "msd"])
    assert _text(jr / "_index/index.csv", jr) == _text(tr / "_index/index.csv", tr)
    assert len(_trees_equal(jr, tr)) == 5
    rows = load_index_rows(tr / "_index/index.csv")
    assert (rows[0].spacing_x, rows[0].spacing_z) == pytest.approx((0.9, 5.0))
    np.testing.assert_array_equal(read_png16(rows[0].png_path),
                                  encode_hu16(np.clip(vol[:, :, 0].T, -1000, 4000)))


@pytest.mark.parametrize("name", ["preprocess_dicom", "preprocess_nifti"])
def test_hu_clip_is_the_scripts(name):
    """data/hu.HU_CLIP, which both writers clip true HU to, is each script's own."""
    assert _script(name).HU_CLIP == HU_CLIP == (-1000.0, 4000.0)


def test_extract_dicom_spacing(tmp_path, dicom_tree):
    index = tmp_path / "index.csv"
    with open(index, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["png_path", "series_dir", "slice_index"])
        for s in ("series0", "series1", "absent"):
            for z in range(2):
                w.writerow([f"/x/{s}/{z}.png", s, z])
    jr, tr = _both(tmp_path, "extract_dicom_spacing", extract_dicom_spacing,
                   ["--index", str(index), "--dicom-root", str(dicom_tree), "--out", "{out}/sp.csv"])
    assert (jr / "sp.csv").read_text() == (tr / "sp.csv").read_text()
    rows = load_index_rows(tr / "sp.csv")
    assert (rows[0].spacing_x, rows[0].spacing_y, rows[0].spacing_z) == pytest.approx((0.6, 0.8, 99.0))
    assert (rows[-1].spacing_x, rows[-1].spacing_z) == (1.0, 1.0)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth")
    assert make_synthetic_data.main(["--out", str(out), "--series-per-dataset", "3",
                                     "--slices-per-series", "4", "--size", "40"]) == 0
    return out


@pytest.mark.parametrize("extra", [[], ["--max-series-per-dataset", "2", "--seed", "3"]])
def test_combine_indices(tmp_path, synth, extra):
    jr, tr = _both(tmp_path, "combine_indices", combine_indices,
                   [f"a={synth / 'index.csv'}", f"b={synth / 'index.csv'}", "--out", "{out}/c.csv", *extra])
    assert (jr / "c.csv").read_text() == (tr / "c.csv").read_text()
    assert combine_indices.main(["nosep", "--out", str(tmp_path / "x.csv")]) == 2


@pytest.mark.parametrize("fraction,seed", [(0.1, 0), (0.34, 5)])
def test_make_split_manifest(tmp_path, synth, fraction, seed):
    jr, tr = _both(tmp_path, "make_split_manifest", make_split_manifest,
                   ["--index", str(synth / "index.csv"), "--out", "{out}/m.json",
                    "--val-fraction", str(fraction), "--seed", str(seed)])
    assert json.loads((jr / "m.json").read_text()) == json.loads((tr / "m.json").read_text())


def test_build_slice_cache(tmp_path, synth):
    for who in ("jax", "port"):
        (tmp_path / who).mkdir()
        (tmp_path / who / "index.csv").write_bytes((synth / "index.csv").read_bytes())
    assert _script("build_slice_cache").main(["--index-csv", str(tmp_path / "jax/index.csv"),
                                              "--canvas", "48", "--workers", "2"]) == 0
    assert build_slice_cache.main(["--index-csv", str(tmp_path / "port/index.csv"), "--canvas", "48",
                                   "--workers", "2"]) == 0
    names = ("decoded_cache_c48.bin", "decoded_cache_c48.json")
    assert (tmp_path / "jax" / names[0]).read_bytes() == (tmp_path / "port" / names[0]).read_bytes()
    jm, tm = (json.loads((tmp_path / who / names[1]).read_text()) for who in ("jax", "port"))
    assert jm["paths"] == tm["paths"] and jm["source"] == tm["source"] and tm["n"] == 24


def test_validate_samples(tmp_path, synth):
    bad = tmp_path / "bad.csv"
    rows = (synth / "index.csv").read_text().splitlines()
    bad.write_text("\n".join(rows + [rows[1].replace(rows[1].split(",")[0], "/nope.png")]) + "\n")
    for index, n, code in ((synth / "index.csv", "6", 0), (bad, "25", 1)):
        roots = []
        for who, main in (("jax", _script("validate_samples").main), ("port", validate_samples.main)):
            root = tmp_path / f"{who}_{code}"
            assert main(["--index", str(index), "--out", str(root), "--n", n, "--seed", "2"]) == code
            roots.append(root)
        jr, tr = roots
        want, got = (json.loads((r / "qa_report.json").read_text()) for r in roots)
        assert [{k: v for k, v in r.items() if k != "error"} for r in got] == \
            [{k: v for k, v in r.items() if k != "error"} for r in want]
        previews = _trees_equal(jr, tr)
        assert np.asarray(Image.open(tr / previews[0])).dtype == np.uint8


def _marks_csv(path, rows, raw):
    rng = np.random.default_rng(0)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        if raw:
            w.writerow(["series_dir", "patient_id", "annotator", "slice_index", "center_x", "center_y",
                        "malignancy", "width", "height"])
            for si, r in enumerate(rows[::2]):
                for rater, mal in (("r1", 5), ("r2", 4), ("r3", 4 if si % 2 else 1)):
                    w.writerow([r.series_dir, f"pat{si % 3}", rater, r.slice_index,
                                20 + int(rng.integers(0, 3)), 18, mal, 10, 12])
            w.writerow(["nowhere", "pat9", "r1", 0, 5, 5, 5, 8, 8])
            w.writerow(["nowhere", "pat9", "r2", 0, 5, 6, 5, 8, 8])
        else:
            w.writerow(["series_dir", "slice_index", "center_x", "center_y", "malignancy", "patient_id"])
            for i, r in enumerate(rows[:16]):
                w.writerow([r.series_dir, r.slice_index, 20, 24, int(rng.choice([1, 2, 3, 4, 5])),
                            f"pat{i % 4}"])


@pytest.mark.parametrize("fmt,extra", [("raw", ["--crop", "24"]), ("consensus", ["--crop", "32"]),
                                       ("raw", ["--whole-slice", "--seed", "3"])])
def test_extract_lidc_malignancy(tmp_path, synth, fmt, extra):
    annos = tmp_path / "marks.csv"
    _marks_csv(annos, load_index_rows(synth / "index.csv"), fmt == "raw")
    jr, tr = _both(tmp_path, "extract_lidc_malignancy", extract_lidc_malignancy,
                   ["--index", str(synth / "index.csv"), "--annotations", str(annos),
                    "--annotations-format", fmt, "--out", "{out}", *extra])
    for split in ("train", "val", "test", "all"):
        assert _text(jr / f"{split}.csv", jr) == _text(tr / f"{split}.csv", tr), split
    assert list(csv.DictReader(open(tr / "all.csv")))
    if "--whole-slice" not in extra:
        crops = _trees_equal(jr, tr)
        assert read_png16(tr / crops[0]).dtype == np.uint16


def test_extract_lidc_malignancy_refuses_pylidc(tmp_path, synth):
    with pytest.raises(NotImplementedError, match="raw CSV"):
        extract_lidc_malignancy.main(["--index", str(synth / "index.csv"), "--annotations-format",
                                      "pylidc", "--out", str(tmp_path)])
