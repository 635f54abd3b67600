"""KILT provenance json -> KILT evaluation file (twin of
``scripts/kilt-dpr/convert_to_evaluation.py``).

    python -m openmatch_tpu_torch.scripts.kilt_dpr.convert_to_evaluation \
        --kilt_queries_file queries.jsonl --provenance_file prov.json \
        --output_evaluation_file eval.jsonl

Each query of the provenance file becomes its KILT line with the
provenance as its first output, then the answers the query had.
"""

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kilt_queries_file", type=str, required=True)
    parser.add_argument("--provenance_file", type=str, required=True)
    parser.add_argument("--output_evaluation_file", type=str, required=True)
    args = parser.parse_args(argv)

    with open(args.kilt_queries_file) as f:
        raw_data = [json.loads(line) for line in f]
    with open(args.provenance_file) as f:
        provenance = json.load(f)

    validated = {}
    for element in raw_data:
        if element["id"] in validated:
            raise ValueError("ids are not unique in input data!")
        validated[element["id"]] = element

    if len(provenance) != len(raw_data):
        print("WARNING: provenance and query data are not the same length!")

    with open(args.output_evaluation_file, "w") as out:
        for query_id, prov in provenance.items():
            element = validated[query_id]
            new_output = [{"provenance": prov}]
            for o in element.get("output", []):
                if "answer" in o:
                    new_output.append({"answer": o["answer"]})
            element["output"] = new_output
            out.write(json.dumps(element) + "\n")
    print(f"wrote {len(provenance)} predictions")


if __name__ == "__main__":
    main()
