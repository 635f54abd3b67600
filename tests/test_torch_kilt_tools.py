"""The port's KILT-DPR tool twins (``openmatch_tpu_torch/scripts/kilt_dpr``)
against the JAX package's scripts (``scripts/kilt-dpr``), on the same small
seeded KILT queries, DPR passage collection and TREC run:

- ``convert_trec_to_provenance`` (with and without the KILT queries file,
  whose 1-based line numbers name the run's queries) and
  ``convert_to_evaluation`` (answers kept, other outputs dropped, a
  provenance shorter than the queries warned about), each run in its own
  process by both packages: byte-equal outputs and the same messages;
- the twins through ``main(argv)`` in this process: the same bytes; a
  collection whose passage ids skip raises, as do duplicate query ids.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from openmatch_tpu_torch.scripts.kilt_dpr import (convert_to_evaluation,
                                                  convert_trec_to_provenance)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta"]


@pytest.fixture(scope="module")
def kilt(tmp_path_factory):
    """queries.jsonl (KILT, 6 queries), psgs.tsv (DPR, 40 passages), two
    TREC runs (numbered queries, and the KILT ids), seeded."""
    rng = np.random.RandomState(0)
    d = tmp_path_factory.mktemp("kilt")

    def words(n):
        return " ".join(rng.choice(WORDS, n))

    with open(d / "psgs.tsv", "w") as f:
        f.write("id\ttext\ttitle\twikipedia_id\n")
        for i in range(40):
            f.write(f"{i}\t{words(rng.randint(3, 12))}\t{words(2)}\t"
                    f"{1000 + i // 3}\n")
    queries = []
    for j in range(6):
        out = [{"answer": words(2)}] if j % 3 else []
        out.append({"provenance": [{"wikipedia_id": str(1000 + j)}]})
        if j == 4:
            out.append({"answer": words(1), "meta": {"score": 1}})
        queries.append({"id": f"kilt-{j:03d}", "input": words(5),
                        "output": out})
    with open(d / "queries.jsonl", "w") as f:
        for q in queries:
            f.write(json.dumps(q) + "\n")
    for name, qid in (("run_numbered.trec", lambda j: str(j + 1)),
                      ("run_ids.trec", lambda j: f"kilt-{j:03d}")):
        with open(d / name, "w") as f:
            for j in range(5):  # the last query has no run
                pids = rng.permutation(40)[:4]
                for r, pid in enumerate(pids):
                    f.write(f"{qid(j)} Q0 {pid} {r + 1} "
                            f"{10.0 - r + rng.rand():.6f} dense\n")
    return d


def run(script, args):
    proc = subprocess.run([sys.executable, script] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def run_port(module, args):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", f"openmatch_tpu_torch.scripts.kilt_dpr."
                               f"{module}"] + args,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def provenance_args(kilt, out, numbered: bool):
    args = ["--passage_collection", str(kilt / "psgs.tsv"),
            "--output_provenance_file", str(out)]
    if numbered:
        return args + ["--trec_file", str(kilt / "run_numbered.trec"),
                       "--kilt_queries_file", str(kilt / "queries.jsonl")]
    return args + ["--trec_file", str(kilt / "run_ids.trec")]


@pytest.mark.parametrize("numbered", [True, False])
def test_the_chain_is_byte_equal_in_processes(kilt, tmp_path, numbered):
    outs = {}
    for name in ("port", "jax"):
        prov, ev = tmp_path / f"{name}.json", tmp_path / f"{name}.jsonl"
        p_args = provenance_args(kilt, prov, numbered)
        e_args = ["--kilt_queries_file", str(kilt / "queries.jsonl"),
                  "--provenance_file", str(prov),
                  "--output_evaluation_file", str(ev)]
        if name == "port":
            said = (run_port("convert_trec_to_provenance", p_args),
                    run_port("convert_to_evaluation", e_args))
        else:
            said = (run("scripts/kilt-dpr/convert_trec_to_provenance.py",
                        p_args),
                    run("scripts/kilt-dpr/convert_to_evaluation.py", e_args))
        outs[name] = (prov.read_bytes(), ev.read_bytes(), said)
    assert outs["port"] == outs["jax"]
    prov = json.loads(outs["port"][0])
    assert len(prov) == 5 and all(len(v) == 4 for v in prov.values())
    assert "not the same length" in outs["port"][2][1]
    lines = [json.loads(line) for line in outs["port"][1].splitlines()]
    assert [x["id"] for x in lines] == [f"kilt-{j:03d}" for j in range(5)]
    assert [len(x["output"]) for x in lines] == [1, 2, 2, 1, 3]


def test_main_in_process_matches_the_scripts(kilt, tmp_path, capsys):
    run("scripts/kilt-dpr/convert_trec_to_provenance.py",
        provenance_args(kilt, tmp_path / "jax.json", True))
    convert_trec_to_provenance.main(
        provenance_args(kilt, tmp_path / "port.json", True))
    assert (tmp_path / "port.json").read_bytes() \
        == (tmp_path / "jax.json").read_bytes()
    e_args = ["--kilt_queries_file", str(kilt / "queries.jsonl"),
              "--provenance_file", str(tmp_path / "jax.json")]
    run("scripts/kilt-dpr/convert_to_evaluation.py",
        e_args + ["--output_evaluation_file", str(tmp_path / "jax.jsonl")])
    convert_to_evaluation.main(
        e_args + ["--output_evaluation_file", str(tmp_path / "port.jsonl")])
    assert (tmp_path / "port.jsonl").read_bytes() \
        == (tmp_path / "jax.jsonl").read_bytes()
    assert "wrote 5 predictions" in capsys.readouterr().out


def test_bad_inputs_raise(kilt, tmp_path):
    bad = tmp_path / "psgs.tsv"
    bad.write_text("id\ttext\ttitle\twikipedia_id\n0\ta\tb\t1\n2\tc\td\t2\n")
    with pytest.raises(ValueError, match="non-contiguous pid 2"):
        convert_trec_to_provenance.main([
            "--trec_file", str(kilt / "run_ids.trec"),
            "--passage_collection", str(bad),
            "--output_provenance_file", str(tmp_path / "p.json")])
    dup = tmp_path / "dup.jsonl"
    dup.write_text('{"id": "a"}\n{"id": "a"}\n')
    (tmp_path / "p.json").write_text("{}")
    with pytest.raises(ValueError, match="not unique"):
        convert_to_evaluation.main([
            "--kilt_queries_file", str(dup),
            "--provenance_file", str(tmp_path / "p.json"),
            "--output_evaluation_file", str(tmp_path / "e.jsonl")])
