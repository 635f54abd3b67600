"""Coordinate-ascent listwise learning-to-rank (RankLib ranker 4 replacement).

The port's own copy of ``openmatch_tpu/letor/coor_ascent.py``.

It replaces the Java RankLib-2.1 jar that OpenMatch v1's
``coor_ascent.sh`` drives. Re-implemented natively: a linear model
over feature vectors whose weights are optimized coordinate-by-coordinate
with a multiplicative/additive line search on a listwise metric (NDCG@k by
default), with random restarts — the same algorithm family as RankLib's
CoorAscent (Metzler & Croft, "Linear feature-based models for information
retrieval").
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional

import numpy as np

from .features import FeatureSet


def ndcg_at_k_grouped(labels: np.ndarray, scores: np.ndarray, k: int) -> float:
    order = np.argsort(-scores, kind="stable")
    gains = (2.0 ** labels[order][:k] - 1.0)
    discounts = 1.0 / np.log2(np.arange(2, len(gains) + 2))
    dcg = float((gains * discounts).sum())
    ideal = np.sort(labels)[::-1][:k]
    idcg = float(((2.0 ** ideal - 1.0) / np.log2(np.arange(2, len(ideal) + 2))).sum())
    return dcg / idcg if idcg > 0 else 0.0


def err_at_k_grouped(labels: np.ndarray, scores: np.ndarray, k: int) -> float:
    g_max = max(labels.max(), 1.0)
    order = np.argsort(-scores, kind="stable")
    err, p_not = 0.0, 1.0
    for i, idx in enumerate(order[:k]):
        r = (2.0 ** labels[idx] - 1.0) / (2.0 ** g_max)
        err += p_not * r / (i + 1)
        p_not *= 1 - r
    return err


METRICS = {"ndcg": ndcg_at_k_grouped, "err": err_at_k_grouped}


class CoorAscent:
    def __init__(
        self,
        metric: str = "ndcg",
        metric_k: int = 10,
        n_restarts: int = 3,
        n_max_iters: int = 25,
        step_base: float = 0.05,
        step_scale: float = 2.0,
        n_steps: int = 10,
        tolerance: float = 1e-4,
        seed: int = 0,
    ):
        self.metric_name = metric
        self.metric_k = metric_k
        self.n_restarts = n_restarts
        self.n_max_iters = n_max_iters
        self.step_base = step_base
        self.step_scale = step_scale
        self.n_steps = n_steps
        self.tolerance = tolerance
        self.seed = seed
        self.weights: Optional[np.ndarray] = None

    # -- scoring --------------------------------------------------------

    def _mean_metric(self, fs: FeatureSet, groups, scores: np.ndarray) -> float:
        fn = METRICS[self.metric_name]
        total = 0.0
        for q, ix in groups.items():
            total += fn(fs.labels[ix], scores[ix], self.metric_k)
        return total / len(groups)

    def evaluate(self, fs: FeatureSet, weights: Optional[np.ndarray] = None) -> float:
        w = self.weights if weights is None else weights
        return self._mean_metric(fs, fs.query_groups(), fs.features @ w)

    # -- training -------------------------------------------------------

    def fit(self, fs: FeatureSet) -> "CoorAscent":
        rng = np.random.RandomState(self.seed)
        groups = fs.query_groups()
        d = fs.num_features
        best_w, best_m = None, -math.inf

        for restart in range(self.n_restarts):
            if restart == 0:
                w = np.ones(d) / d
            else:
                w = rng.rand(d)
                w /= np.abs(w).sum()
            current = self._mean_metric(fs, groups, fs.features @ w)

            for _ in range(self.n_max_iters):
                improved = False
                for j in rng.permutation(d):
                    base = fs.features @ w
                    col = fs.features[:, j]
                    w_j = w[j]
                    best_delta, best_local = 0.0, current
                    # symmetric geometric step schedule around w_j
                    step = self.step_base * (abs(w_j) if w_j != 0 else 1.0)
                    for _ in range(self.n_steps):
                        for delta in (step, -step):
                            m = self._mean_metric(fs, groups, base + delta * col)
                            if m > best_local + 1e-12:
                                best_local, best_delta = m, delta
                        step *= self.step_scale
                    if best_delta != 0.0:
                        w[j] = w_j + best_delta
                        norm = np.abs(w).sum()
                        if norm > 0:
                            w /= norm
                        current = self._mean_metric(fs, groups, fs.features @ w)
                        improved = True
                if not improved:
                    break
            if current > best_m:
                best_m, best_w = current, w.copy()

        self.weights = best_w
        self.train_metric = best_m
        return self

    def predict(self, fs: FeatureSet) -> np.ndarray:
        assert self.weights is not None, "fit() first"
        return fs.features @ self.weights

    # -- persistence ----------------------------------------------------

    def save(self, path: str):
        if not path.endswith(".npz"):
            path += ".npz"  # np.savez appends it anyway; keep load(path) working
        np.savez(path, weights=self.weights,
                 meta=np.array([self.metric_k], np.int32),
                 metric=np.array(self.metric_name))

    @classmethod
    def load(cls, path: str) -> "CoorAscent":
        if not path.endswith(".npz") and not os.path.exists(path):
            path += ".npz"
        with np.load(path) as z:
            model = cls(metric_k=int(z["meta"][0]),
                        metric=str(z["metric"]) if "metric" in z else "ndcg")
            model.weights = z["weights"]
        return model
