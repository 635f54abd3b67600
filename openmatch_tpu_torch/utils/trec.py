"""TREC run file I/O and cross-partition merging.

The port's own copy of ``openmatch_tpu/utils/trec.py``; both packages
write and read the same files byte for byte.

- ``save_as_trec`` sorts each query's documents by descending score and
  writes ``<qid> Q0 <docid> <rank> <score> <run_id>``.
- ``load_from_trec`` accepts both the 6-column TREC format and a bare
  3-column ``<qid> <docid> <score>`` format, optionally truncating to the
  first ``max_len_per_q`` entries per query *in file order*.
- ``merge_retrieval_results_by_score`` merges per-partition results with
  first-partition-wins dedup, then keeps the global top-k by score.
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union


def save_as_trec(
    rank_result: Dict[str, Dict[str, float]],
    output_path: str,
    run_id: str = "OpenMatchTPU",
) -> None:
    with open(output_path, "w") as f:
        for qid in rank_result:
            ranked = sorted(rank_result[qid].items(), key=lambda x: x[1], reverse=True)
            for i, (doc_id, score) in enumerate(ranked):
                f.write(f"{qid} Q0 {doc_id} {i + 1} {score} {run_id}\n")


def load_from_trec(
    input_path: str,
    as_list: bool = False,
    max_len_per_q: int = None,
) -> Union[Dict[str, Dict[str, float]], Dict[str, List[Tuple[str, float]]]]:
    rank_result: Dict = {}
    cnt = 0
    with open(input_path) as f:
        for line in f:
            content = line.split()
            if len(content) == 6:
                qid, _, doc_id, _, score, _ = content
            elif len(content) == 3:
                qid, doc_id, score = content
            else:
                raise ValueError(f"Invalid run format: {line!r}")
            if qid not in rank_result:
                rank_result[qid] = [] if as_list else {}
                cnt = 0
            if max_len_per_q is None or cnt < max_len_per_q:
                if as_list:
                    rank_result[qid].append((doc_id, float(score)))
                else:
                    rank_result[qid][doc_id] = float(score)
            cnt += 1
    return rank_result


def merge_retrieval_results_by_score(
    results: List[Dict[str, Dict[str, float]]],
    topk: int = 100,
) -> Dict[str, Dict[str, float]]:
    """Merge partitioned retrieval results, keep top-k per query.

    A doc id appearing in multiple partitions keeps its *first* partition's
    score (partitions hold disjoint docs in practice, so this only matters
    for malformed inputs, but the reference's tie handling is kept).
    """
    merged: Dict[str, Dict[str, float]] = {}
    for result in results:
        for qid, docs in result.items():
            bucket = merged.setdefault(qid, {})
            for doc_id, score in docs.items():
                if doc_id not in bucket:
                    bucket[doc_id] = score
    for qid in merged:
        merged[qid] = dict(
            sorted(merged[qid].items(), key=lambda x: x[1], reverse=True)[:topk]
        )
    return merged
