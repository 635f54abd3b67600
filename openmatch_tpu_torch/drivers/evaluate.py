"""Evaluate a TREC run against qrels (reference scripts/evaluate.py): the
port's own copy of the JAX driver, whose output lines it prints byte for
byte. It loads no model and no tokenizer.

    python -m openmatch_tpu_torch.drivers.evaluate [-m measure] qrels run
    measures: mrr / mrr_cut.10 / ndcg_cut.10 / recall.100 / map / p.20 / err.20
"""

from __future__ import annotations

import argparse

from ..utils.metrics import eval_mrr, evaluate_run, load_qrels, load_run


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-q", "--query_eval_wanted", action="store_true")
    parser.add_argument("-m", "--measure", type=str, default=None)
    parser.add_argument("qrel")
    parser.add_argument("run")
    args = parser.parse_args(argv)

    qrels = load_qrels(args.qrel)
    run = load_run(args.run)

    if args.measure is not None and "mrr" in args.measure:
        cutoff = int(args.measure.split(".")[-1]) if "mrr_cut" in args.measure else None
        result = eval_mrr(qrels, run, cutoff)
        if args.query_eval_wanted:
            for qid, value in result.items():
                print(f"{'MRR':25s}{qid:8s}{value:.4f}")
        print("MRR: ", result["all"])
        return result["all"]

    measures = [args.measure] if args.measure else ["map", "ndcg_cut_10", "recall_100", "p_10"]
    results = evaluate_run(qrels, run, measures)
    for name, value in results.items():
        print(f"{name:25s}{'all':8s}{value:.4f}")
    return results


if __name__ == "__main__":
    main()
