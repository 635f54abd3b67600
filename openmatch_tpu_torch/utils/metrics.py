"""Native TREC retrieval metrics (replacement for pytrec_eval).

The port's own copy of ``openmatch_tpu/utils/metrics.py`` (stdlib only),
held to it by ``tests/test_torch_evaluate.py``. OpenMatch depends on the
C++ pytrec_eval extension (``scripts/evaluate.py``,
``v1/OpenMatch/metrics/metric.py``) plus a hand-rolled MRR
(``scripts/evaluate.py:5-28``). We implement the measures its docs actually quote — MRR@k, NDCG@k (trec_eval
``ndcg_cut`` semantics: linear gains), Recall@k, MAP, P@k, ERR@k — in pure
Python/NumPy with trec_eval's exact tie-breaking (sort by score desc, then
doc id desc).

Qrel/run file parsing mirrors ``pytrec_eval.parse_qrel`` / ``parse_run``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

Qrels = Dict[str, Dict[str, int]]
Run = Dict[str, Dict[str, float]]


def parse_qrel(lines: Iterable[str]) -> Qrels:
    """Parse TREC qrels: ``<qid> <iter> <docid> <rel>``."""
    qrels: Qrels = {}
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        qid, _, did, rel = parts[0], parts[1], parts[2], parts[3]
        qrels.setdefault(qid, {})[did] = int(rel)
    return qrels


def parse_run(lines: Iterable[str]) -> Run:
    """Parse a TREC run: 6-column or bare 3-column format."""
    run: Run = {}
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        if len(parts) == 6:
            qid, _, did, _, score, _ = parts
        elif len(parts) == 3:
            qid, did, score = parts
        else:
            raise ValueError(f"Invalid run line: {line!r}")
        run.setdefault(qid, {})[did] = float(score)
    return run


def load_qrels(path: str) -> Qrels:
    with open(path) as f:
        return parse_qrel(f)


def load_run(path: str) -> Run:
    with open(path) as f:
        return parse_run(f)


def _ranked_docids(doc_scores: Dict[str, float]) -> List[str]:
    """trec_eval ordering: score descending, ties broken by docid descending."""
    return [d for d, _ in sorted(doc_scores.items(), key=lambda kv: (kv[1], kv[0]), reverse=True)]


def reciprocal_rank(qrel: Dict[str, int], ranked: List[str], cutoff: Optional[int] = None) -> float:
    for i, did in enumerate(ranked):
        if cutoff is not None and i >= cutoff:
            break
        if qrel.get(did, 0) > 0:
            return 1.0 / (i + 1)
    return 0.0


def ndcg_at_k(qrel: Dict[str, int], ranked: List[str], k: int) -> float:
    """trec_eval ``ndcg_cut.k``: DCG = sum rel_i / log2(i + 2), linear gains."""
    dcg = 0.0
    for i, did in enumerate(ranked[:k]):
        rel = qrel.get(did, 0)
        if rel > 0:
            dcg += rel / math.log2(i + 2)
    ideal = sorted((r for r in qrel.values() if r > 0), reverse=True)[:k]
    idcg = sum(r / math.log2(i + 2) for i, r in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def recall_at_k(qrel: Dict[str, int], ranked: List[str], k: int) -> float:
    num_rel = sum(1 for r in qrel.values() if r > 0)
    if num_rel == 0:
        return 0.0
    hit = sum(1 for did in ranked[:k] if qrel.get(did, 0) > 0)
    return hit / num_rel


def precision_at_k(qrel: Dict[str, int], ranked: List[str], k: int) -> float:
    hit = sum(1 for did in ranked[:k] if qrel.get(did, 0) > 0)
    return hit / k


def average_precision(qrel: Dict[str, int], ranked: List[str]) -> float:
    num_rel = sum(1 for r in qrel.values() if r > 0)
    if num_rel == 0:
        return 0.0
    hits = 0
    ap = 0.0
    for i, did in enumerate(ranked):
        if qrel.get(did, 0) > 0:
            hits += 1
            ap += hits / (i + 1)
    return ap / num_rel


def err_at_k(qrel: Dict[str, int], ranked: List[str], k: int, max_grade: Optional[int] = None) -> float:
    """Expected reciprocal rank (gdeval semantics): R_i = (2^rel - 1) / 2^g_max."""
    if max_grade is None:
        max_grade = max((r for r in qrel.values()), default=1)
        max_grade = max(max_grade, 1)
    err = 0.0
    p_not_stopped = 1.0
    for i, did in enumerate(ranked[:k]):
        rel = max(qrel.get(did, 0), 0)
        r = (2**rel - 1) / (2**max_grade)
        err += p_not_stopped * r / (i + 1)
        p_not_stopped *= 1.0 - r
    return err


def eval_mrr(qrels: Qrels, run: Run, cutoff: Optional[int] = None) -> Dict[str, float]:
    """Per-query RR + mean, matching OpenMatch's scripts/evaluate.py:5-28:
    averaged over qrel queries that appear in the run."""
    results: Dict[str, float] = {}
    total, n = 0.0, 0
    for qid in qrels:
        if qid not in run:
            continue
        n += 1
        ranked = _ranked_docids(run[qid])
        rr = reciprocal_rank(qrels[qid], ranked, cutoff)
        results[qid] = rr
        total += rr
    results["all"] = total / n if n else 0.0
    return results


_MEASURES = {
    "mrr": lambda qrel, ranked, k: reciprocal_rank(qrel, ranked, k),
    # pytrec_eval's canonical name for MRR — reference recipes pass it
    "recip_rank": lambda qrel, ranked, k: reciprocal_rank(qrel, ranked, k),
    "ndcg": ndcg_at_k,
    "recall": recall_at_k,
    "p": precision_at_k,
    "precision": precision_at_k,
    "err": err_at_k,
    "map": lambda qrel, ranked, k: average_precision(qrel, ranked),
}


def _parse_measure(measure: str) -> Tuple[str, Optional[int]]:
    """``ndcg_cut_10`` / ``ndcg_cut.10`` / ``recall_100`` / ``map`` → (name, k)."""
    m = measure.lower().replace("ndcg_cut", "ndcg").replace("mrr_cut", "mrr")
    m = m.replace(".", "_")
    parts = m.rsplit("_", 1)
    if len(parts) == 2 and parts[1].isdigit():
        return parts[0], int(parts[1])
    return m, None


def evaluate_run(
    qrels: Qrels,
    run: Run,
    measures: Iterable[str] = ("ndcg_cut_10",),
    skip_missing: bool = False,
) -> Dict[str, float]:
    """Aggregate measures over a run.

    pytrec_eval evaluates every run query that has qrels and averages over
    those; queries in the run without qrels are ignored; qrel queries missing
    from the run count as 0 unless ``skip_missing``.
    """
    out: Dict[str, float] = {}
    qids = [q for q in qrels if (q in run or not skip_missing)]
    if not qids:
        return {m: 0.0 for m in measures}
    ranked_cache = {q: _ranked_docids(run.get(q, {})) for q in qids}
    for measure in measures:
        name, k = _parse_measure(measure)
        fn = _MEASURES.get(name)
        if fn is None:
            raise ValueError(f"Unsupported measure: {measure}")
        total = 0.0
        for q in qids:
            total += fn(qrels[q], ranked_cache[q], k)
        out[measure] = total / len(qids)
    return out


class Metric:
    """File-level API matching v1's Metric
    (OpenMatch's v1/OpenMatch/metrics/metric.py:5-49)."""

    def get_metric(self, qrels: str, trec: str, metric: str = "ndcg_cut_10") -> float:
        q = load_qrels(qrels)
        r = load_run(trec)
        # skip_missing=True: pytrec_eval (and therefore the reference
        # Metric) aggregates over run∩qrel queries only — averaging a 0
        # for every qrel query absent from the run silently deflates
        # metrics on partial runs (rerank-a-subset, truncated runs) and
        # skews ReInfoSelect/ANCE rewards computed from them
        return evaluate_run(q, r, [metric], skip_missing=True)[metric]

    def get_mrr(self, qrels: str, trec: str, metric: str = "mrr_cut_10") -> float:
        k = int(metric.split("_")[-1])
        q = load_qrels(qrels)
        # v1 semantics: rank by file order, average over *run* queries.
        run_order: Dict[str, List[str]] = {}
        with open(trec) as f:
            for line in f:
                qid, _, did, _, _, _ = line.split()
                run_order.setdefault(qid, []).append(did)
        mrr = 0.0
        for qid, docs in run_order.items():
            rr = 0.0
            for i, did in enumerate(docs[:k]):
                if qid in q and q[qid].get(did, 0) > 0:
                    rr = 1.0 / (i + 1)
                    break
            mrr += rr
        return mrr / len(run_order) if run_order else 0.0
