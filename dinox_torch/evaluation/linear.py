"""The linear estimators and scores the evaluation protocol needs, in numpy
and scipy: the port's stand-ins for the scikit-learn calls of the JAX
package's ``evaluation.metrics`` (the GPU machine has no scikit-learn).

* :class:`LogisticRegression`: ``sklearn.linear_model.LogisticRegression(
  solver="lbfgs", C=1)``'s model: L2-penalised, ``0.5 ||W||^2 + C * sum of
  the log losses``, the intercept unpenalised; binomial for two classes,
  multinomial (one weight row per class) for more. The objective is
  strictly convex in W, so its minimiser (and the probabilities) is
  unique: it is solved with L-BFGS-B to a tight tolerance, where
  scikit-learn stops at its default ``tol=1e-4``.
* :class:`Ridge`: ``Ridge(alpha=1)`` in closed form on centred X and y,
  the intercept from the means.
* :func:`rank_auroc` (tie-aware, average ranks), :func:`roc_auc_score`
  (binary, or one-vs-rest macro over probability columns),
  :func:`accuracy_score` and :func:`r2_score`.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import minimize
from scipy.special import expit, log_softmax, softmax
from scipy.stats import rankdata


class LogisticRegression:
    """L2-penalised logistic regression (binomial or multinomial)."""

    def __init__(self, C: float = 1.0, max_iter: int = 1000, tol: float = 1e-10):
        self.C = C
        self.max_iter = max_iter
        self.tol = tol

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LogisticRegression":
        X = np.asarray(X, np.float64)
        self.classes_ = np.unique(y)
        k = len(self.classes_)
        if k < 2:
            raise ValueError("logistic regression needs at least two classes")
        n, d = X.shape
        idx = np.searchsorted(self.classes_, y)
        rows = 1 if k == 2 else k
        onehot = (idx == 1).astype(np.float64)[:, None] if k == 2 else np.eye(k)[idx]
        reg = 1.0 / (self.C * n)  # the objective divided by C * n

        def objective(flat: np.ndarray) -> tuple[float, np.ndarray]:
            w, b = flat[:rows * d].reshape(rows, d), flat[rows * d:]
            z = X @ w.T + b
            if k == 2:
                loss = np.logaddexp(0.0, z) - onehot * z
                resid = expit(z) - onehot
            else:
                logp = log_softmax(z, axis=1)
                loss = -(onehot * logp)
                resid = np.exp(logp) - onehot
            f = loss.sum() / n + 0.5 * reg * np.sum(w * w)
            gw = resid.T @ X / n + reg * w
            return f, np.concatenate([gw.ravel(), resid.sum(axis=0) / n])

        res = minimize(objective, np.zeros(rows * (d + 1)), jac=True, method="L-BFGS-B",
                       options={"maxiter": self.max_iter, "gtol": self.tol,
                                "ftol": 0.0})
        self.coef_ = res.x[:rows * d].reshape(rows, d)
        self.intercept_ = res.x[rows * d:]
        self.n_iter_ = res.nit
        return self

    def decision_function(self, X: np.ndarray) -> np.ndarray:
        z = np.asarray(X, np.float64) @ self.coef_.T + self.intercept_
        return z[:, 0] if len(self.classes_) == 2 else z

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        z = self.decision_function(X)
        if len(self.classes_) == 2:
            p = expit(z)
            return np.stack([1.0 - p, p], axis=1)
        return softmax(z, axis=1)

    def predict(self, X: np.ndarray) -> np.ndarray:
        z = self.decision_function(X)
        pick = (z > 0).astype(np.int64) if len(self.classes_) == 2 else z.argmax(axis=1)
        return self.classes_[pick]


class Ridge:
    """Least squares with an L2 penalty *alpha* on the coefficients and an
    unpenalised intercept, solved in closed form in float64."""

    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha

    def fit(self, X: np.ndarray, y: np.ndarray) -> "Ridge":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        x_mean, y_mean = X.mean(axis=0), y.mean(axis=0)
        xc, yc = X - x_mean, y - y_mean
        a = xc.T @ xc
        a.flat[::a.shape[0] + 1] += self.alpha
        self.coef_ = np.linalg.solve(a, xc.T @ yc)
        self.intercept_ = y_mean - x_mean @ self.coef_
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.asarray(X, np.float64) @ self.coef_ + self.intercept_


def rank_auroc(scores: np.ndarray, targets: np.ndarray) -> float:
    """Tie-aware rank AUROC (average ranks on ties); 0.5 when a class is absent."""
    pos = targets == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    ranks = rankdata(scores)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary AUROC of scores (N,) against the larger label, or the
    one-vs-rest macro average over (N, K) probability columns, one per
    sorted label of *y_true*."""
    classes = np.unique(y_true)
    if len(classes) < 2:
        raise ValueError("only one class present in y_true: AUROC is undefined")
    if y_score.ndim == 1:
        if len(classes) != 2:
            raise ValueError("binary scores need exactly two classes in y_true")
        return rank_auroc(y_score, (y_true == classes[1]).astype(np.int64))
    if y_score.shape[1] != len(classes):
        raise ValueError(f"number of classes in y_true ({len(classes)}) is not the number of "
                         f"columns in y_score ({y_score.shape[1]})")
    return float(np.mean([rank_auroc(y_score[:, i], (y_true == c).astype(np.int64))
                          for i, c in enumerate(classes)]))


def accuracy_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """1 - SS_res / SS_tot; 1 for a perfect fit of a constant target, else 0 there."""
    y_true = np.asarray(y_true, np.float64)
    ss_res = float(np.sum((y_true - np.asarray(y_pred, np.float64)) ** 2))
    ss_tot = float(np.sum((y_true - y_true.mean()) ** 2))
    if ss_tot == 0.0:
        return 1.0 if ss_res == 0.0 else 0.0
    return 1.0 - ss_res / ss_tot
