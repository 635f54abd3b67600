"""k-fold coordinate-ascent (or RankSVM) LeToR over a RankLib-format
feature file (port of the JAX ``coor_ascent`` driver; numpy on the host).

    python -m openmatch_tpu_torch.drivers.coor_ascent \
        --features features.txt --k 2 --metric ndcg --metric_k 20 \
        --output_trec out.trec [--ranker coor_ascent|ranksvm]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..letor.coor_ascent import CoorAscent
from ..letor.features import kfold_split, load_feature_file, scores_to_trec
from ..letor.ranksvm import RankSVM
from ..utils.trec import save_as_trec


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--features", required=True)
    parser.add_argument("--k", type=int, default=2, help="cross-validation folds")
    parser.add_argument("--ranker", choices=["coor_ascent", "ranksvm"], default="coor_ascent")
    parser.add_argument("--metric", default="ndcg")
    parser.add_argument("--metric_k", type=int, default=20)
    parser.add_argument("--restarts", type=int, default=3)
    parser.add_argument("--output_trec", required=True)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    fs = load_feature_file(args.features)
    merged = {}
    fold_metrics = []
    for fold, (train, test) in enumerate(kfold_split(fs, args.k, args.seed)):
        if args.ranker == "coor_ascent":
            model = CoorAscent(metric=args.metric, metric_k=args.metric_k,
                               n_restarts=args.restarts, seed=args.seed + fold)
        else:
            model = RankSVM(seed=args.seed + fold)
        model.fit(train)
        scores = model.predict(test)
        merged.update(scores_to_trec(test, scores))
        if args.ranker == "coor_ascent":
            fold_metrics.append(model.evaluate(test))
        else:
            ca = CoorAscent(metric=args.metric, metric_k=args.metric_k)
            fold_metrics.append(ca._mean_metric(test, test.query_groups(), scores))

    save_as_trec(merged, args.output_trec)
    print(f"{args.metric}@{args.metric_k} per fold: "
          + " ".join(f"{m:.4f}" for m in fold_metrics)
          + f" | mean {np.mean(fold_metrics):.4f}")
    print(f"wrote {len(merged)} queries -> {args.output_trec}")
    return fold_metrics


if __name__ == "__main__":
    main()
