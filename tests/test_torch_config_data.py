"""The port's own copies of the JAX package's jax-free modules (``config``,
``templates``, ``data.collators``, ``data.loader``, ``data.tokenization``,
``data.inference_dataset``, ``utils.trec``) against their originals, on the
same inputs: the same parsed dataclasses, the same arrays, the same
sequences and items, the same bytes on disk. Exact equality throughout:
nothing here computes in floating point."""

import dataclasses
import json
import os

import numpy as np
import pytest

import openmatch_tpu.config as jconfig
import openmatch_tpu.templates as jtemplates
from openmatch_tpu.data import collators as jcollators
from openmatch_tpu.data import inference_dataset as jinference
from openmatch_tpu.data import loader as jloader
from openmatch_tpu.utils import trec as jtrec
from openmatch_tpu_torch import config, templates
from openmatch_tpu_torch.data import collators, inference_dataset, loader
from openmatch_tpu_torch.utils import trec

CLASSES = ("ModelArguments", "DataArguments", "TrainingArguments",
           "InferenceArguments")


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("tok")
    words = ["hello", "world", "dense", "retrieval", "passage", "query", "doc"]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    (d / "vocab.txt").write_text("\n".join(vocab))
    return BertTokenizerFast(vocab_file=str(d / "vocab.txt"))


def _parse(module, argv):
    """(dataclasses as dicts) or the exception type and message."""
    parser = module.ArgumentParser(tuple(getattr(module, c) for c in CLASSES))
    try:
        return [dataclasses.asdict(x) for x in parser.parse(argv)]
    except ValueError as e:
        return ("ValueError", str(e))


ARGVS = {
    "empty": [],
    "values": ["--model_name_or_path", "ckpt", "--q_max_len", "16",
               "--learning_rate", "1e-5", "--retrieve_depth=50"],
    "bare_bools": ["--untie_encoder", "--normalize", "--encode_is_qry",
                   "--grad_cache"],
    "bool_words": ["--normalize", "false", "--do_train", "yes"],
    "lists": ["--encode_in_path", "a.jsonl,b.jsonl", "--search_n_segs", "6"],
    "optional_int": ["--eval_steps", "7", "--reranking_depth", "100"],
    "bad_flag": ["--no_such_flag", "1"],
    "bare_non_bool": ["--max_steps", "--do_train"],
    "not_a_flag": ["ckpt"],
}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_argument_parser_matches_jax(case):
    assert _parse(config, ARGVS[case]) == _parse(jconfig, ARGVS[case])


def test_dataclass_fields_and_defaults_match_jax():
    for name in CLASSES:
        mine, theirs = getattr(config, name), getattr(jconfig, name)
        assert [(f.name, str(f.type)) for f in dataclasses.fields(mine)] \
            == [(f.name, str(f.type)) for f in dataclasses.fields(theirs)]
        assert dataclasses.asdict(mine()) == dataclasses.asdict(theirs())
    assert config.DRTrainingArguments is config.TrainingArguments


def test_json_config_and_save_config_match_jax(tmp_path):
    data = {"model_name_or_path": "ckpt", "p_max_len": 64, "normalize": True,
            "encode_in_path": "x.jsonl,y.jsonl", "seed": 3}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(data))
    assert _parse(config, [str(path)]) == _parse(jconfig, [str(path)])
    (path_bad := tmp_path / "bad.json").write_text(json.dumps({"nope": 1}))
    assert _parse(config, [str(path_bad)]) == _parse(jconfig, [str(path_bad)])
    args = config.InferenceArguments(retrieve_depth=9)
    config.save_config(args, str(tmp_path / "a" / "mine.json"))
    jconfig.save_config(jconfig.InferenceArguments(retrieve_depth=9),
                        str(tmp_path / "b" / "theirs.json"))
    assert (tmp_path / "a" / "mine.json").read_bytes() \
        == (tmp_path / "b" / "theirs.json").read_bytes()
    assert config.ArgumentParser(config.ModelArguments).format_help() \
        == jconfig.ArgumentParser(jconfig.ModelArguments).format_help()


@pytest.mark.parametrize("template,data", [
    ("Title: <title> Text: <text>", {"title": "t", "text": "x"}),
    ("<meta.title> | <text>", {"meta": {"title": "deep"}, "text": 5}),
    ("<a> and <b", {"a": 1}),
])
def test_templates_match_jax(template, data):
    assert templates.find_all_markers(template) \
        == jtemplates.find_all_markers(template)
    assert templates.fill_template(template, data) \
        == jtemplates.fill_template(template, data)


def test_template_missing_marker_matches_jax():
    with pytest.raises(ValueError, match="missing") as mine:
        templates.fill_template("<missing>", {})
    with pytest.raises(ValueError) as theirs:
        jtemplates.fill_template("<missing>", {})
    assert str(mine.value) == str(theirs.value)
    with pytest.warns(RuntimeWarning):
        assert templates.fill_template("<x> y", {}, allow_not_found=True) \
            == jtemplates.fill_template("<x> y", {}, allow_not_found=True)


@pytest.mark.parametrize("max_len,pad_id", [(8, 0), (3, 7)])
def test_collators_match_jax(max_len, pad_id):
    rng = np.random.RandomState(0)
    batch = [list(rng.randint(1, 100, size=n)) for n in (0, 2, 5, 9)]
    want = jcollators.pad_ids(batch, max_len, pad_id)
    got = collators.pad_ids(batch, max_len, pad_id)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    feats = [{"id": f"d{i}", "input_ids": ids} for i, ids in enumerate(batch)]
    ids_g, arr_g = collators.InferenceCollator(pad_id, max_len)(feats)
    ids_w, arr_w = jcollators.InferenceCollator(pad_id, max_len)(feats)
    assert ids_g == ids_w
    for key in arr_w:
        np.testing.assert_array_equal(arr_g[key], arr_w[key])


@pytest.mark.parametrize("n,size,drop_last,pad_to_full", [
    (7, 3, False, False), (7, 3, True, False), (7, 3, False, True),
    (6, 3, False, True), (0, 4, False, True)])
def test_batched_matches_jax(n, size, drop_last, pad_to_full):
    def run(mod):
        return list(mod.batched(range(n), size, list, drop_last=drop_last,
                                pad_to_full=pad_to_full))

    assert run(loader) == run(jloader)


def test_prefetch_matches_jax_and_forwards_errors():
    assert list(loader.prefetch(iter(range(50)), depth=3)) \
        == list(jloader.prefetch(iter(range(50)), depth=3))

    def broken():
        yield 1
        raise KeyError("upstream")

    with pytest.raises(KeyError, match="upstream"):
        list(loader.prefetch(broken()))
    # an abandoned consumer releases the worker
    it = loader.prefetch(iter(range(1000)), depth=1)
    assert next(it) == 0
    it.close()


CORPUS = [
    {"id": "d0", "title": "hello", "text": "world dense"},
    {"id": "d1", "title": "query", "text": "retrieval passage doc"},
    {"_id": "d2", "title": "doc", "text": "hello hello world"},
    {"text_id": "d3", "text": "world"},
    {"id": "d4", "text": [5, 6, 7, 8, 9, 10, 11]},  # pre-tokenized
]


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_inference_dataset_jsonl_matches_jax(tokenizer, tmp_path, shard):
    path = tmp_path / "corpus.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in CORPUS))
    kw = dict(data_files=str(path), is_query=False, shard_index=shard[0],
              num_shards=shard[1])
    args = dict(corpus_path=str(path), doc_template="<title> | <text>",
                p_max_len=6)
    mine = inference_dataset.InferenceDataset.load(
        tokenizer, config.DataArguments(**args), **kw)
    theirs = jinference.InferenceDataset.load(
        tokenizer, jconfig.DataArguments(**args), **kw)
    with pytest.warns(RuntimeWarning):  # d3 and d4 have no title
        items = list(mine)
    with pytest.warns(RuntimeWarning):
        assert items == list(theirs)
    assert items and all(len(x["input_ids"]) <= 6 for x in items)
    assert mine.to_dict() == theirs.to_dict()


def test_inference_dataset_tsv_matches_jax(tokenizer, tmp_path):
    path = tmp_path / "queries.tsv"
    path.write_text("q1\thello world\nq2\tdense retrieval query\nq3\tdoc\n")
    args = dict(query_path=str(path), query_template="query: <text>",
                query_column_names="id,text", q_max_len=5)
    mine = inference_dataset.InferenceDataset.load(
        tokenizer, config.DataArguments(**args), is_query=True)
    theirs = jinference.InferenceDataset.load(
        tokenizer, jconfig.DataArguments(**args), is_query=True)
    assert list(mine) == list(theirs)
    assert [x["id"] for x in mine] == ["q1", "q2", "q3"]
    with pytest.raises(ValueError, match="extension"):
        inference_dataset.InferenceDataset(tokenizer, ["x.parquet"])


RUN = {"q1": {"d1": 1.5, "d2": 3.25, "d3": -0.5},
       "q2": {"d9": 0.125, "d1": 0.125},
       "q3": {}}


def test_trec_files_match_jax(tmp_path):
    mine, theirs = tmp_path / "mine.trec", tmp_path / "theirs.trec"
    trec.save_as_trec(RUN, str(mine), run_id="r")
    jtrec.save_as_trec(RUN, str(theirs), run_id="r")
    assert mine.read_bytes() == theirs.read_bytes()
    for kw in ({}, {"as_list": True}, {"max_len_per_q": 1}):
        assert trec.load_from_trec(str(mine), **kw) \
            == jtrec.load_from_trec(str(theirs), **kw)
    three = tmp_path / "three.txt"
    three.write_text("q1 d1 0.5\nq1 d2 0.25\n")
    assert trec.load_from_trec(str(three)) == jtrec.load_from_trec(str(three))
    bad = tmp_path / "bad.txt"
    bad.write_text("q1 d1\n")
    with pytest.raises(ValueError, match="Invalid run format"):
        trec.load_from_trec(str(bad))
    parts = [RUN, {"q1": {"d1": 9.0, "d7": 2.0}, "q4": {"x": 1.0}}]
    assert trec.merge_retrieval_results_by_score(parts, topk=2) \
        == jtrec.merge_retrieval_results_by_score(parts, topk=2)
    assert os.path.getsize(mine) > 0
