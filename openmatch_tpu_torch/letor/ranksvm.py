"""Pairwise linear RankSVM (RankLib/svmrank replacement).

The port's own copy of ``openmatch_tpu/letor/ranksvm.py``.

Linear scoring with pairwise hinge loss over within-query preference pairs,
optimized by subgradient descent with L2 regularization — the classic
Joachims ranking SVM objective, solved natively in numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .features import FeatureSet


class RankSVM:
    def __init__(self, c: float = 0.01, lr: float = 0.1, epochs: int = 100, seed: int = 0):
        self.c = c
        self.lr = lr
        self.epochs = epochs
        self.seed = seed
        self.weights: Optional[np.ndarray] = None

    def _pairs(self, fs: FeatureSet):
        """Within-query (better, worse) index pairs."""
        pairs = []
        for q, ix in fs.query_groups().items():
            labels = fs.labels[ix]
            for a in range(len(ix)):
                for b in range(len(ix)):
                    if labels[a] > labels[b]:
                        pairs.append((ix[a], ix[b]))
        return np.asarray(pairs, np.int64)

    def fit(self, fs: FeatureSet) -> "RankSVM":
        pairs = self._pairs(fs)
        if len(pairs) == 0:
            self.weights = np.zeros(fs.num_features)
            return self
        # feature standardization for stable steps
        mu = fs.features.mean(axis=0)
        sd = fs.features.std(axis=0)
        sd[sd == 0] = 1.0
        X = (fs.features - mu) / sd
        w = np.zeros(fs.num_features)
        n = len(pairs)
        # the update is FULL-batch (sum over all violated pairs), so the
        # pair-difference matrix is invariant across epochs — hoist it
        # (and drop the no-op per-epoch shuffle): identical weights,
        # ~epochs x cheaper
        diffs = X[pairs[:, 0]] - X[pairs[:, 1]]
        for epoch in range(self.epochs):
            lr = self.lr / (1 + epoch * 0.1)
            margins = diffs @ w
            viol = margins < 1.0
            grad = self.c * w - diffs[viol].sum(axis=0) / n
            w -= lr * grad
        # fold standardization back into the weights
        self.weights = w / sd
        self.bias = -float((w / sd) @ mu)
        return self

    def predict(self, fs: FeatureSet) -> np.ndarray:
        assert self.weights is not None, "fit() first"
        return fs.features @ self.weights + getattr(self, "bias", 0.0)

    def save(self, path: str):
        if not path.endswith(".npz"):
            path += ".npz"  # np.savez appends it anyway; keep load(path) working
        np.savez(path, weights=self.weights, bias=np.array([getattr(self, "bias", 0.0)]))

    @classmethod
    def load(cls, path: str) -> "RankSVM":
        import os

        if not path.endswith(".npz") and not os.path.exists(path):
            path += ".npz"
        with np.load(path) as z:
            model = cls()
            model.weights = z["weights"]
            model.bias = float(z["bias"][0])
        return model
