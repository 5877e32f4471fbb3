"""The port's evaluation metrics against the JAX package's on the same seeded
embeddings and rows (probe and kNN accuracy equal, AUC within 1e-3, the
rest within 1e-6), and the port's own estimators (dinox_torch.evaluation
.linear) against scikit-learn, which only this test imports: binary and
4-class logistic regression (probabilities within 1e-5 of scikit-learn's
solution of the same objective solved tightly), ridge coefficients,
binary and one-vs-rest AUROC, accuracy and r2."""

from dataclasses import dataclass

import numpy as np
import pytest
from sklearn.linear_model import LogisticRegression as SkLogisticRegression
from sklearn.linear_model import Ridge as SkRidge
from sklearn.metrics import accuracy_score as sk_accuracy
from sklearn.metrics import r2_score as sk_r2
from sklearn.metrics import roc_auc_score as sk_auc

from dinox_torch.evaluation import linear
from dinox_torch.evaluation import metrics as M
from dinox_tpu.evaluation import metrics as J


@dataclass
class Row:
    series_dir: str
    dataset: str


def _data(n_datasets: int, seed: int = 0, per_series: int = 6, series: int = 6, dim: int = 32):
    rng = np.random.default_rng(seed)
    rows, emb, sp = [], [], []
    centres = rng.normal(size=(n_datasets, dim))
    for d in range(n_datasets):
        for s in range(series):
            shift = rng.normal(size=dim) * 0.5
            for _ in range(per_series):
                rows.append(Row(series_dir=f"d{d}/s{s}", dataset=f"ds{d}"))
                emb.append(centres[d] * 0.6 + shift + rng.normal(size=dim))
                sp.append([0.5 + 0.3 * d + 0.05 * rng.normal(), 0.7, 2.0])
    emb = np.asarray(emb, np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return rows, emb, np.asarray(sp, np.float32)


def _close(a, b, tol=1e-6):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], tol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
    elif isinstance(a, float) and isinstance(b, float):
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= tol, (a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("n_datasets", [2, 4])
def test_metrics_match_jax(n_datasets):
    rows, emb, sp = _data(n_datasets)
    assert M.series_level_split(rows, seed=3) == J.series_level_split(rows, seed=3)

    got, want = M.dataset_discrimination_probe(emb, rows), J.dataset_discrimination_probe(emb, rows)
    assert got["accuracy"] == want["accuracy"] and got["knn_accuracy"] == want["knn_accuracy"]
    assert abs(got["auc"] - want["auc"]) <= 1e-3
    _close({k: v for k, v in got.items() if k != "auc"}, {k: v for k, v in want.items() if k != "auc"})

    _close(M.domain_clustering(emb, rows), J.domain_clustering(emb, rows))
    _close(M.spacing_prediction(emb, sp, rows), J.spacing_prediction(emb, sp, rows))
    _close(M.embedding_stats(emb, sp, rows), J.embedding_stats(emb, sp, rows))
    q, k = emb[: len(emb) // 2], emb[len(emb) // 2:]
    _close(M.view_retrieval(q, k), J.view_retrieval(q, k))
    _close(M.spacing_counterfactual_from_embeddings(emb, emb[::-1], q.repeat(2, 0)),
           J.spacing_counterfactual_from_embeddings(emb, emb[::-1], q.repeat(2, 0)))


def test_probe_reports_the_jax_errors():
    rows, emb, _ = _data(1)
    assert M.dataset_discrimination_probe(emb, rows) == J.dataset_discrimination_probe(emb, rows)


def _classes(k: int, n: int = 240, d: int = 24, seed: int = 1):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    x = rng.normal(size=(n, d))
    x[np.arange(n), y] += 1.0
    return x / np.linalg.norm(x, axis=1, keepdims=True), y


@pytest.mark.parametrize("k", [2, 4])
def test_logistic_regression_matches_sklearn(k):
    x, y = _classes(k)
    got = linear.LogisticRegression(C=1.0, max_iter=1000).fit(x, y)
    # The same L2-penalised objective (binomial for two classes, multinomial
    # for more), solved to a tight tolerance: the minimiser is unique.
    want = SkLogisticRegression(C=1.0, solver="newton-cg", tol=1e-12, max_iter=10000).fit(x, y)
    np.testing.assert_allclose(got.predict_proba(x), want.predict_proba(x), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.predict(x), want.predict(x))
    default = SkLogisticRegression(max_iter=1000, solver="lbfgs").fit(x, y)
    assert (got.predict(x) == default.predict(x)).mean() >= 0.99


def test_ridge_auc_accuracy_r2_match_sklearn():
    x, y = _classes(4, seed=2)
    target = x @ np.linspace(-1, 1, x.shape[1]) + 0.1 * np.random.default_rng(2).normal(size=len(x))
    got = linear.Ridge(alpha=1.0).fit(x, target)
    want = SkRidge(alpha=1.0).fit(x, target)
    np.testing.assert_allclose(got.coef_, want.coef_, atol=1e-10, rtol=0)
    assert abs(got.intercept_ - want.intercept_) <= 1e-10
    pred = got.predict(x)
    assert abs(linear.r2_score(target, pred) - sk_r2(target, pred)) <= 1e-12
    assert linear.r2_score(np.ones(4), np.ones(4)) == sk_r2(np.ones(4), np.ones(4))

    rng = np.random.default_rng(3)
    prob = rng.dirichlet(np.ones(4), size=len(y))
    prob[:10] = prob[10:20]  # ties
    assert abs(linear.roc_auc_score(y, prob) - sk_auc(y, prob, multi_class="ovr", average="macro")) <= 1e-12
    yb = (y > 1).astype(int)
    scores = np.round(prob[:, 0], 2)  # ties
    assert abs(linear.roc_auc_score(yb, scores) - sk_auc(yb, scores)) <= 1e-12
    assert linear.accuracy_score(y, prob.argmax(1)) == sk_accuracy(y, prob.argmax(1))
    with pytest.raises(ValueError):
        linear.roc_auc_score(y[y < 3], prob[y < 3])
