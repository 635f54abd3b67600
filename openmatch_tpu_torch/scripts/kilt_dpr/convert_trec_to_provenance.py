"""TREC run -> KILT provenance json (twin of
``scripts/kilt-dpr/convert_trec_to_provenance.py``).

    python -m openmatch_tpu_torch.scripts.kilt_dpr.convert_trec_to_provenance \
        --trec_file run.trec --passage_collection psgs.tsv \
        --output_provenance_file prov.json [--kilt_queries_file q.jsonl]

The passage collection is DPR's tsv (a header, then id, text, title and
Wikipedia id, the ids 0, 1, 2, ... in order). A run's query ids are the
KILT queries' 1-based line numbers when ``--kilt_queries_file`` is given,
else used as they are.
"""

import argparse
import csv
import json


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--trec_file", type=str, required=True)
    parser.add_argument("--kilt_queries_file", type=str, default=None)
    parser.add_argument("--passage_collection", type=str, required=True)
    parser.add_argument("--output_provenance_file", type=str, required=True)
    args = parser.parse_args(argv)

    queries = []
    if args.kilt_queries_file is not None:
        with open(args.kilt_queries_file) as f:
            queries = [json.loads(line) for line in f]

    pid2content = []
    with open(args.passage_collection) as f:
        reader = csv.reader(f, delimiter="\t")
        next(reader)  # header
        for i, row in enumerate(reader):
            pid, text, wikipedia_title, wikipedia_id = row[0], row[1], row[2], row[3]
            if int(pid) != i:
                raise ValueError(f"non-contiguous pid {pid} at line {i}")
            pid2content.append({
                "text": text,
                "wikipedia_title": wikipedia_title,
                "wikipedia_id": wikipedia_id,
            })

    provenance = {}
    last_qid = None
    with open(args.trec_file) as f:
        for line in f:
            qid, _, pid, rank, score, _ = line.split()
            real_qid = queries[int(qid) - 1]["id"] if queries else str(qid)
            if qid != last_qid:
                provenance[real_qid] = []
                last_qid = qid
            entry = dict(pid2content[int(pid)])
            entry["score"] = score
            provenance[real_qid].append(entry)

    with open(args.output_provenance_file, "w") as f:
        json.dump(provenance, f, indent=4)
    print(f"wrote provenance for {len(provenance)} queries")


if __name__ == "__main__":
    main()
