"""RankLib-format feature file I/O, k-fold splitting, and TREC conversion.

The port's own copy of ``openmatch_tpu/letor/features.py``.

Replaces the RankLib FeatureManager + gen_trec glue
(OpenMatch v1's ``coor_ascent.sh`` and ``LeToR/gen_trec.py``).
Feature lines: ``<label> id:<qid> 1:<v> 2:<v> ... [# <docid>]`` (the format
v1/gen_feature.py:35-42 emits, with an optional docid comment we add so the
TREC conversion needs no sidecar dev file).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class FeatureSet:
    """Grouped-by-query feature matrix."""

    def __init__(self, qids: List[str], docids: List[str],
                 labels: np.ndarray, features: np.ndarray):
        self.qids = qids
        self.docids = docids
        self.labels = np.asarray(labels, np.float64)
        self.features = np.asarray(features, np.float64)

    def __len__(self):
        return len(self.qids)

    @property
    def num_features(self) -> int:
        return self.features.shape[1]

    def query_groups(self) -> Dict[str, np.ndarray]:
        groups: Dict[str, List[int]] = {}
        for i, q in enumerate(self.qids):
            groups.setdefault(q, []).append(i)
        return {q: np.asarray(ix) for q, ix in groups.items()}

    def subset(self, indices: np.ndarray) -> "FeatureSet":
        return FeatureSet(
            [self.qids[i] for i in indices],
            [self.docids[i] for i in indices],
            self.labels[indices],
            self.features[indices],
        )


def parse_feature_line(line: str) -> Tuple[float, str, List[float], Optional[str]]:
    docid = None
    if "#" in line:
        line, comment = line.split("#", 1)
        docid = comment.strip()
    parts = line.split()
    label = float(parts[0])
    qid = None
    values: Dict[int, float] = {}
    for tok in parts[1:]:
        key, value = tok.split(":", 1)
        if key in ("id", "qid"):
            qid = value
        else:
            values[int(key)] = float(value)
    n = max(values) if values else 0
    vec = [values.get(i + 1, 0.0) for i in range(n)]
    return label, qid, vec, docid


def load_feature_file(path: str) -> FeatureSet:
    qids, docids, labels, rows = [], [], [], []
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            label, qid, vec, docid = parse_feature_line(line)
            qids.append(qid)
            docids.append(docid if docid is not None else str(i))
            labels.append(label)
            rows.append(vec)
    if not rows:
        raise ValueError(f"No feature lines found in {path}")
    width = max(len(r) for r in rows)
    mat = np.zeros((len(rows), width))
    for i, r in enumerate(rows):
        mat[i, : len(r)] = r
    return FeatureSet(qids, docids, np.asarray(labels), mat)


def save_feature_file(fs: FeatureSet, path: str):
    with open(path, "w") as f:
        for i in range(len(fs)):
            feats = " ".join(f"{j + 1}:{v}" for j, v in enumerate(fs.features[i]))
            f.write(f"{int(fs.labels[i])} id:{fs.qids[i]} {feats} # {fs.docids[i]}\n")


def kfold_split(fs: FeatureSet, k: int, seed: int = 0) -> List[Tuple[FeatureSet, FeatureSet]]:
    """Split by QUERY into k (train, test) folds (RankLib -kcv semantics)."""
    rng = np.random.RandomState(seed)
    qids = sorted(set(fs.qids))
    if k < 2:
        raise ValueError(f"k-fold needs k >= 2 (got k={k}: the train "
                         "split of a 1-fold would be empty)")
    if k > len(qids):
        raise ValueError(
            f"k={k} folds but only {len(qids)} unique queries — every "
            "fold needs at least one test query")
    rng.shuffle(qids)
    folds = [qids[i::k] for i in range(k)]
    groups = fs.query_groups()
    out = []
    for i in range(k):
        test_q = set(folds[i])
        test_ix = np.concatenate([groups[q] for q in qids if q in test_q])
        train_ix = np.concatenate([groups[q] for q in qids if q not in test_q])
        out.append((fs.subset(np.sort(train_ix)), fs.subset(np.sort(test_ix))))
    return out


def scores_to_trec(fs: FeatureSet, scores: np.ndarray) -> Dict[str, Dict[str, float]]:
    result: Dict[str, Dict[str, float]] = {}
    for qid, docid, s in zip(fs.qids, fs.docids, scores):
        result.setdefault(qid, {})[docid] = float(s)
    return result
