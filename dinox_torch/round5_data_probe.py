"""Model-free dataset probe on raw windowed pixels, per eval tree: the twin
of ``scripts/round5_data_probe.py``, with the same flags and JSON keys.
Host work only: no model, no card.

The control arm of the signature-strength experiment: before reading the
embedding probe at strength s, establish whether the dataset signal is in
the data at s, with a series-split logistic probe on handcrafted
window-invariant structural features (the family the synthetic generator's
separability tests use). A high data-side probe with a low embedding probe
means the embedding lost signal the data carries; a low data-side probe
means the generator, not the training, limits the embedding probe.

The probe is the port's ``evaluation.linear.LogisticRegression`` (L2, C 1,
at most 3000 L-BFGS-B iterations), solved to its optimum where scikit-learn
(the JAX script's) stops at ``tol=1e-4``: on features near a class boundary
a prediction, and so the accuracy, can differ.

    python -m dinox_torch.round5_data_probe \\
        --trees data/synth_v2_eval_sig033 data/synth_v2_eval_big \\
        --out docs/data_probe.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from dinox_torch.data.hu import decode_hu16, window
from dinox_torch.data.index import load_index_rows
from dinox_torch.data.pipeline import _read_png_u16
from dinox_torch.evaluation.linear import LogisticRegression


def features(img01: np.ndarray) -> np.ndarray:
    """Window-invariant structural features: gradient energy, high-frequency
    stdev, speckle spread, the FFT band peak and the ring contrast."""
    x = (img01 - img01.mean()) / (img01.std() + 1e-6)
    gx = np.diff(x, axis=0)
    gy = np.diff(x, axis=1)
    grad = float(np.mean(np.abs(gx)) + np.mean(np.abs(gy)))
    hf = float(np.std(gx))
    speck = float(np.percentile(x, 99.7) - np.percentile(x, 75.0))
    F = np.abs(np.fft.fftshift(np.fft.fft2(x)))
    h, w = F.shape
    ky, kx = np.meshgrid(np.arange(h) - h // 2, np.arange(w) - w // 2,
                         indexing="ij")
    kr = np.hypot(ky, kx)
    band = (kr >= 13 * h / 128) & (kr <= 23 * h / 128)
    band_peak = float(F[band].max() / (F[band].mean() + 1e-6))
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    r = np.hypot(yy, xx)
    ann = (r > 0.78) & (r < 0.95)
    inner = (r > 0.4) & (r < 0.65)
    ring = float(x[ann].mean() - x[inner].mean())
    return np.asarray([grad, hf, speck, band_peak, ring], np.float32)


def probe_tree(tree: Path, max_per_series: int = 6) -> dict:
    """The probe's accuracy on the val series of *tree* (its ``index.csv``
    and ``split_manifest.json``), at most *max_per_series* slices each."""
    rows = load_index_rows(tree / "index.csv")
    manifest = json.loads((tree / "split_manifest.json").read_text())
    val_series = set(manifest["val"]["series_dir"])
    by_series: dict[str, list] = {}
    for r in rows:
        if r.series_dir in val_series:
            by_series.setdefault(r.series_dir, []).append(r)

    feats, labels, groups = [], [], []
    names = sorted({r.dataset for r in rows})
    for sd, srows in sorted(by_series.items()):
        for r in srows[:max_per_series]:
            hu = decode_hu16(_read_png_u16(r.png_path))
            feats.append(features(window(hu, 40.0, 400.0)))
            labels.append(names.index(r.dataset))
            groups.append(sd)
    feats = np.stack(feats)
    labels = np.asarray(labels)
    groups = np.asarray(groups)

    # series split 80/20 (the embedding probe's discipline)
    uniq = np.unique(groups)
    rng = np.random.default_rng(0)
    rng.shuffle(uniq)
    test_groups = set(uniq[: max(1, len(uniq) // 5)].tolist())
    te = np.isin(groups, list(test_groups))
    mu, sd_ = feats[~te].mean(0), feats[~te].std(0) + 1e-6
    clf = LogisticRegression(max_iter=3000)
    clf.fit((feats[~te] - mu) / sd_, labels[~te])
    acc = float(np.mean(clf.predict((feats[te] - mu) / sd_) == labels[te]))
    return {"tree": str(tree), "n_slices": int(len(labels)),
            "n_test_series": len(test_groups), "data_probe_accuracy": round(acc, 4),
            "chance": round(1.0 / len(names), 4)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--trees", nargs="+", type=Path, required=True)
    p.add_argument("--max-per-series", type=int, default=6)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    payload = {"results": [probe_tree(t, args.max_per_series) for t in args.trees]}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(payload, indent=2))
    print(json.dumps(payload, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
