"""The 6-metric pan-organ evaluation protocol — pure functions on embeddings.

Metric semantics mirror reference scripts/evaluate_panorgan.py:228-697:

1. view_retrieval          — top-1/top-k cross-view NN match vs 1/N chance
2. dataset_discrimination  — series-split logistic probe, acc/AUC + bootstrap CI
3. spacing_counterfactual  — cosine distance under x2 / x0.5 spacing (computed
                             by the caller, which owns the model; helper here)
4. domain_clustering       — kNN same-dataset rate vs prevalence
5. spacing_prediction      — Ridge -> log(spacing_x), series-split R^2
6. embedding_stats         — per-dataset std/centroid cosines/PCA1-spacing corr

All functions take numpy arrays + lightweight row records (anything with
``.series_dir`` and ``.dataset``) so they are unit-testable on synthetic
embeddings.

The port's copy of ``dinox_tpu.evaluation.metrics``: the same functions and
result keys, with the scikit-learn calls replaced by the port's own
estimators (:mod:`dinox_torch.evaluation.linear`).
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Sequence

import numpy as np

from dinox_torch.evaluation.linear import (
    LogisticRegression,
    Ridge,
    accuracy_score,
    r2_score,
    roc_auc_score,
)


# -- shared helpers ---------------------------------------------------------


def series_level_split(
    rows: Sequence, seed: int = 42, train_frac: float = 0.8
) -> tuple[list[int], list[int]]:
    """Deterministic stratified-by-dataset series-level 80/20 index split —
    slices from one series never straddle the split (no leakage)."""
    series_of: dict[str, list[int]] = defaultdict(list)
    dataset_of: dict[str, str] = {}
    for i, r in enumerate(rows):
        series_of[r.series_dir].append(i)
        dataset_of[r.series_dir] = getattr(r, "dataset", "") or "unknown"
    by_dataset: dict[str, list[str]] = defaultdict(list)
    for s, d in dataset_of.items():
        by_dataset[d].append(s)

    rng = random.Random(seed)
    train_series: list[str] = []
    test_series: list[str] = []
    for d in sorted(by_dataset):
        series = sorted(by_dataset[d])
        rng.shuffle(series)
        n_train = max(1, int(train_frac * len(series)))
        if n_train == len(series):
            n_train = max(1, len(series) - 1)
        train_series += series[:n_train]
        test_series += series[n_train:]
    train_idx = [i for s in train_series for i in series_of[s]]
    test_idx = [i for s in test_series for i in series_of[s]]
    return train_idx, test_idx


def _labels(rows: Sequence) -> tuple[np.ndarray, list[str]]:
    names = [getattr(r, "dataset", "") or "unknown" for r in rows]
    uniq = sorted(set(names))
    lut = {d: i for i, d in enumerate(uniq)}
    return np.asarray([lut[n] for n in names]), uniq


# -- metric 1: view retrieval ----------------------------------------------


def view_retrieval(q: np.ndarray, k_emb: np.ndarray, topk: int = 5) -> dict:
    """Cross-view retrieval: row i of q must retrieve row i of k_emb.

    q, k_emb: (N, D) L2-normalized embeddings of the two augmented views.
    """
    n = q.shape[0]
    sim = q @ k_emb.T
    top1_hit = np.argmax(sim, axis=1) == np.arange(n)
    kk = min(topk, n)
    part = np.argpartition(-sim, kth=kk - 1, axis=1)[:, :kk]
    topk_hit = (part == np.arange(n)[:, None]).any(axis=1)
    chance = 1.0 / n
    top1 = float(top1_hit.mean())
    return {
        "n": n,
        "top1": top1,
        f"top{topk}": float(topk_hit.mean()),
        "random_baseline": chance,
        "ratio_vs_random": top1 / chance,
    }


# -- metric 2: dataset discrimination probe ---------------------------------


def dataset_discrimination_probe(
    embeddings: np.ndarray, rows: Sequence, seed: int = 42, n_bootstrap: int = 200
) -> dict:
    labels, uniq = _labels(rows)
    train_idx, test_idx = series_level_split(rows, seed=seed)
    if not train_idx or not test_idx:
        return {"error": "insufficient series for train/test split"}
    y_tr, y_te = labels[train_idx], labels[test_idx]
    if len(set(y_tr.tolist())) < 2 or len(set(y_te.tolist())) < 2:
        return {"error": "need at least 2 datasets in both splits"}

    clf = LogisticRegression(C=1.0, max_iter=1000)
    clf.fit(embeddings[train_idx], y_tr)
    prob = clf.predict_proba(embeddings[test_idx])
    pred = prob.argmax(axis=1)
    acc = float(accuracy_score(y_te, pred))

    # Nonlinear counterpart on the SAME series split (beyond the reference's
    # linear-only probe, scripts/evaluate_panorgan.py:313-416): cosine-kNN
    # majority vote. Disambiguates two failure stories the linear number
    # can't: kNN holding while linear falls = info present but not linearly
    # separable; both falling = dataset information genuinely fading across
    # series (what the v2 50K run showed — unsupervised clustering purity was
    # carried by same-series neighbors, docs/ROUND4_RESULTS.md).
    kk = min(10, len(train_idx))
    sim = embeddings[test_idx] @ embeddings[train_idx].T
    nn_idx = np.argpartition(-sim, kth=kk - 1, axis=1)[:, :kk]
    votes = y_tr[nn_idx]
    knn_pred = np.asarray(
        [np.bincount(v, minlength=len(uniq)).argmax() for v in votes]
    )
    knn_acc = float(accuracy_score(y_te, knn_pred))
    if len(uniq) == 2:
        auc = float(roc_auc_score(y_te, prob[:, 1]))
    else:
        auc = float(roc_auc_score(y_te, prob))  # one-vs-rest, macro

    # series-level bootstrap over the test split
    series_of: dict[str, list[int]] = defaultdict(list)
    for i in test_idx:
        series_of[rows[i].series_dir].append(i)
    series_list = sorted(series_of)
    rng = np.random.default_rng(seed + 1)
    boot = []
    for _ in range(n_bootstrap):
        draw = rng.integers(0, len(series_list), len(series_list))
        idx = [i for j in draw for i in series_of[series_list[j]]]
        if idx:
            boot.append(float(accuracy_score(labels[idx], clf.predict(embeddings[idx]))))
    ci = (
        [float(np.percentile(boot, 2.5)), float(np.percentile(boot, 97.5))]
        if boot
        else [acc, acc]
    )
    return {
        "labels": uniq,
        "train_slices": len(train_idx),
        "test_slices": len(test_idx),
        "accuracy": acc,
        "accuracy_ci95": ci,
        "auc": auc,
        "knn_accuracy": knn_acc,
        "knn_k": kk,
        "note": "dataset discrimination (not organ — confounded by scanner/protocol)",
    }


# -- metric 3: spacing counterfactual (distance summary) --------------------


def cosine_distance_summary(a: np.ndarray, b: np.ndarray) -> dict:
    """Summary of 1 - cos(a_i, b_i) for row-aligned normalized embeddings."""
    d = 1.0 - np.sum(a * b, axis=-1)
    return {"mean": float(d.mean()), "std": float(d.std()), "median": float(np.median(d))}


def spacing_counterfactual_from_embeddings(
    e_real: np.ndarray, e_2x: np.ndarray, e_half: np.ndarray
) -> dict:
    return {
        "n": int(e_real.shape[0]),
        "cosine_distance_real_vs_2x": cosine_distance_summary(e_real, e_2x),
        "cosine_distance_real_vs_half": cosine_distance_summary(e_real, e_half),
        "cosine_distance_half_vs_2x": cosine_distance_summary(e_half, e_2x),
        "interpretation": (
            "Baseline: distances ~0 (model ignores spacing metadata). "
            "Scale-aware: distances > 0 (model encodes physical scale)."
        ),
    }


# -- metric 4: domain clustering -------------------------------------------


def domain_clustering(embeddings: np.ndarray, rows: Sequence, k: int = 10) -> dict:
    labels, uniq = _labels(rows)
    n = len(rows)
    sim = embeddings @ embeddings.T
    np.fill_diagonal(sim, -np.inf)
    nn = np.argpartition(-sim, kth=k, axis=1)[:, :k]
    same = (labels[nn] == labels[:, None]).mean(axis=1)

    prevalence = {d: float(np.mean(labels == i)) for i, d in enumerate(uniq)}
    per_ds = {}
    for i, d in enumerate(uniq):
        mask = labels == i
        observed = float(same[mask].mean())
        exp = prevalence[d]
        per_ds[d] = {
            "same_dataset_rate": observed,
            "expected_random": exp,
            "enrichment": observed / exp if exp > 0 else float("inf"),
            "n": int(mask.sum()),
        }
    overall = float(same.mean())
    expected = float(sum(p * p for p in prevalence.values()))
    return {
        "k": k,
        "overall_same_dataset_rate": overall,
        "expected_random_rate": expected,
        "enrichment_vs_random": overall / expected if expected > 0 else float("inf"),
        "per_dataset": per_ds,
        "note": "High enrichment = strong domain clustering. Not necessarily good or bad.",
    }


# -- metric 5: spacing prediction ------------------------------------------


def spacing_prediction(
    embeddings: np.ndarray, spacings: np.ndarray, rows: Sequence, seed: int = 42
) -> dict:
    train_idx, test_idx = series_level_split(rows, seed=seed)
    if not train_idx or not test_idx:
        return {"error": "insufficient series for split"}
    y = np.log(spacings[:, 0] + 1e-6)
    reg = Ridge(alpha=1.0)
    reg.fit(embeddings[train_idx], y[train_idx])
    pred = reg.predict(embeddings[test_idx])
    return {
        "target": "log(spacing_x)",
        "train_slices": len(train_idx),
        "test_slices": len(test_idx),
        "r2": float(r2_score(y[test_idx], pred)),
        "mae_log_spacing": float(np.mean(np.abs(y[test_idx] - pred))),
        "note": "Partly circular for scale-aware models. Use as plumbing check.",
    }


# -- metric 6: embedding statistics ----------------------------------------


def embedding_stats(embeddings: np.ndarray, spacings: np.ndarray, rows: Sequence) -> dict:
    labels, uniq = _labels(rows)
    per_ds = {}
    centroids = {}
    for i, d in enumerate(uniq):
        mask = labels == i
        e = embeddings[mask]
        sp = spacings[mask]
        c = e.mean(axis=0)
        c = c / (np.linalg.norm(c) + 1e-8)
        centroids[d] = c
        if e.shape[0] > 2:
            centered = e - e.mean(axis=0)
            _, _, vt = np.linalg.svd(centered, full_matrices=False)
            pc1 = centered @ vt[0]
            corr = float(np.corrcoef(pc1, sp[:, 0])[0, 1])
        else:
            corr = float("nan")
        per_ds[d] = {
            "n": int(mask.sum()),
            "embedding_std": float(e.std(axis=0).mean()),
            "intra_cosine_to_centroid": float((e @ c).mean()),
            "pca1_spacing_correlation": corr,
        }
    cross = {}
    names = sorted(centroids)
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            cross[f"{names[i]}_vs_{names[j]}"] = float(centroids[names[i]] @ centroids[names[j]])
    return {"per_dataset": per_ds, "cross_dataset_centroid_cosine": cross}
