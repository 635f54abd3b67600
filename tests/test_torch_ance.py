"""The port's ANCE loop (``openmatch_tpu_torch/ance``) and its cycle twin
(``perf/ance_cycle.py``) against the JAX package (CPU, fp32, tiny BERT):

- the loop functions on the same inputs: ``generate_hard_negatives`` equal
  lists, ``build_ann_lines`` equal lines, ``write_ann_data`` byte-equal
  files, ``latest_ann_data`` the same (path, generation, metrics): exact;
- a miniature alternating run (after ``tests/test_ance.py``'s): the port's
  ``DRTrainer`` against JAX's on a one-device mesh from the same weights
  (``jax_convert``), dropout off, three generations of three steps, each
  refresh scoring the toy corpus with the trainer's current weights: the
  per-step losses within 1e-4 relative, the refreshed ann files
  byte-equal. The toy's scores are asserted to be separated by more than
  ten times the two packages' largest score difference, so the mined order
  cannot hang on a tie;
- the refresh encodes the trainer's live module: ``Retriever`` holds
  ``trainer.model`` itself, uncast, the reps equal a fresh eval copy's
  bit for bit mid-training (dropout on), and the module trains on;
- ``run_ance_generator(max_generations=1)`` on a port checkpoint: the
  generation number resumes after the highest in ``ann_dir``, the metrics
  file equals JAX's ``evaluate_run`` of the run it searched plus the
  checkpoint path, and the published file is byte-equal to JAX's
  ``generate_hard_negatives`` + ``build_ann_lines`` on that run;
- ``perf.ance_cycle --tiny --device cpu`` runs one cycle, and without
  ``--device`` it asks for the card;
- ``chip_smoke.py``'s ``ance`` and ``beir`` phases run their flow and
  audits on the CPU at a tiny size.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmatch_tpu.ance import loop as jloop
from openmatch_tpu.config import DataArguments as JaxDataArguments
from openmatch_tpu.config import TrainingArguments as JaxTrainingArguments
from openmatch_tpu.data.collators import QPCollator as JaxQPCollator
from openmatch_tpu.data.loader import batched as jax_batched
from openmatch_tpu.data.train_dataset import \
    DRTrainDataset as JaxDRTrainDataset
from openmatch_tpu.models.bert import BertConfig as JaxBertConfig
from openmatch_tpu.models.dr_model import DRModel as JaxDRModel
from openmatch_tpu.parallel.mesh import make_mesh
from openmatch_tpu.train.dr_trainer import DRTrainer as JaxDRTrainer
from openmatch_tpu.utils.metrics import evaluate_run as jax_evaluate_run
from openmatch_tpu_torch.ance import loop
from openmatch_tpu_torch.config import (DataArguments, InferenceArguments,
                                        TrainingArguments)
from openmatch_tpu_torch.data.collators import QPCollator, pad_ids
from openmatch_tpu_torch.data.loader import batched
from openmatch_tpu_torch.data.train_dataset import DRTrainDataset
from openmatch_tpu_torch.models.bert import BertConfig
from openmatch_tpu_torch.models.dr_model import DRModel
from openmatch_tpu_torch.models.jax_convert import params_from_jax
from openmatch_tpu_torch.perf import ance_cycle
from openmatch_tpu_torch.retriever.encoder import encode_dataset
from openmatch_tpu_torch.retriever.retriever import Retriever
from openmatch_tpu_torch.train.dr_trainer import DRTrainer

torch.set_num_threads(2)
LOSS_REL = 1e-4
TOPICS = 8
TINY = dict(vocab_size=32, hidden_size=16, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=32,
            max_position_embeddings=16, add_pooler=False)


# ---- the loop functions -----------------------------------------------------


def retrieved_and_qrels(seed=0, n_q=6, n_d=40):
    rng = np.random.RandomState(seed)
    retrieved = {f"q{i}": {f"d{j}": float(s) for j, s in zip(
        rng.permutation(n_d)[:25], rng.randn(25))} for i in range(n_q)}
    qrels = {f"q{i}": [f"d{j}" for j in rng.randint(0, n_d, 1 + i % 3)]
             for i in range(n_q - 1)}  # the last query has no positives
    return retrieved, qrels


@pytest.mark.parametrize("generation", [0, 3])
@pytest.mark.parametrize("topk,n_neg,seed", [(200, 20, 0), (10, 4, 7),
                                             (3, 5, 1)])
def test_generate_hard_negatives_matches_jax(generation, topk, n_neg, seed):
    retrieved, qrels = retrieved_and_qrels(seed)
    kw = dict(topk_training=topk, negative_sample=n_neg, seed=seed)
    got = loop.generate_hard_negatives(retrieved, qrels,
                                       loop.AnceConfig(**kw), generation)
    want = jloop.generate_hard_negatives(retrieved, qrels,
                                         jloop.AnceConfig(**kw), generation)
    assert got == want
    assert list(got) == list(retrieved)
    for qid, negs in got.items():
        assert not set(negs) & set(qrels.get(qid, ()))


def test_ann_files_match_jax(tmp_path):
    retrieved, qrels = retrieved_and_qrels(1)
    negatives = loop.generate_hard_negatives(retrieved, qrels,
                                             loop.AnceConfig(), 0)
    rng = np.random.RandomState(2)
    tq = {q: rng.randint(5, 99, 4).tolist() for q in list(retrieved)[1:]}
    tc = {f"d{j}": rng.randint(5, 99, 6).tolist() for j in range(0, 40, 3)}
    got = list(loop.build_ann_lines(negatives, qrels, tq, tc))
    want = list(jloop.build_ann_lines(negatives, qrels, tq, tc))
    assert got == want and got  # some queries kept, some skipped
    assert len(got) < len(negatives)
    assert loop.latest_ann_data(str(tmp_path / "none")) \
        == jloop.latest_ann_data(str(tmp_path / "none")) == (None, -1, None)
    for lib, name in ((loop, "port"), (jloop, "jax")):
        d = str(tmp_path / name)
        lib.write_ann_data(d, 0, got, {"ndcg_cut_10": 0.25})
        lib.write_ann_data(d, 2, got[:1])
    for name in ("ann_training_data_0", "ann_ndcg_0", "ann_training_data_2"):
        assert (tmp_path / "port" / name).read_bytes() \
            == (tmp_path / "jax" / name).read_bytes()
    assert sorted(os.listdir(tmp_path / "port")) \
        == sorted(os.listdir(tmp_path / "jax"))  # no .tmp left behind
    path, gen, metrics = loop.latest_ann_data(str(tmp_path / "port"))
    jpath, jgen, jmetrics = jloop.latest_ann_data(str(tmp_path / "jax"))
    assert (os.path.basename(path), gen, metrics) \
        == (os.path.basename(jpath), jgen, jmetrics) \
        == ("ann_training_data_2", 2, None)


# ---- the alternating miniature ----------------------------------------------


@pytest.fixture(scope="module")
def topic_tokenizer(tmp_path_factory):
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("tok")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "about",
             "document", "query"] + [f"topic{i}" for i in range(TOPICS)]
    (d / "vocab.txt").write_text("\n".join(vocab))
    return BertTokenizerFast(vocab_file=str(d / "vocab.txt"))


def toy_texts(tok):
    def enc(text):
        return tok.encode_plus(text, truncation="only_first", max_length=8,
                               padding=False, return_attention_mask=False,
                               return_token_type_ids=False)["input_ids"]

    corpus = {f"d{i}": enc(f"document about topic{i}") for i in range(TOPICS)}
    queries = {f"q{i}": enc(f"query about topic{i}") for i in range(TOPICS)}
    qrels = {f"q{i}": [f"d{i}"] for i in range(TOPICS)}
    return corpus, queries, qrels


def write_init(path):
    rows = [{"query": f"query about topic{i}",
             "positives": [f"document about topic{i}"],
             "negatives": [f"document about topic{(i + 4) % TOPICS}"]}
            for i in range(TOPICS)]
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")


def alternating_kw():
    # adam_epsilon 1e-4, as in test_torch_train's step parity: a gradient
    # that is 0 but for float noise would otherwise take a full step
    return dict(learning_rate=3e-3, warmup_ratio=0.0, warmup_steps=0,
                adam_epsilon=1e-4, weight_decay=0.0, logging_steps=1000,
                save_steps=0, seed=0)


def test_alternating_miniature_matches_jax(tmp_path, topic_tokenizer):
    tok = topic_tokenizer
    init = tmp_path / "gen_init.jsonl"
    write_init(init)
    corpus, queries, qrels = toy_texts(tok)
    jm = JaxDRModel(encoder_config=JaxBertConfig(**TINY), normalize=True,
                    dtype=jnp.float32)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jm.init_params(jax.random.PRNGKey(0)))
    pm = DRModel(BertConfig(**TINY), normalize=True)
    pm.load_state_dict(params_from_jax(params), strict=True)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    jt = JaxDRTrainer(jm, params, JaxTrainingArguments(**alternating_kw()),
                      total_steps=10_000, mesh=mesh)
    pt = DRTrainer(pm, TrainingArguments(**alternating_kw()),
                   total_steps=10_000, device="cpu")
    c_batch = pad_ids(list(corpus.values()), 8, 0)
    q_batch = pad_ids(list(queries.values()), 8, 0)

    def jax_scores(tr):
        p = jax.device_get(tr.state.params)
        c = jm.encode_passage(p, jnp.asarray(c_batch["input_ids"]),
                              jnp.asarray(c_batch["attention_mask"]))
        q = jm.encode_query(p, jnp.asarray(q_batch["input_ids"]),
                            jnp.asarray(q_batch["attention_mask"]))
        return np.asarray(q) @ np.asarray(c).T

    def port_scores(tr):
        with torch.no_grad():
            c = tr.model.encode_passage(
                torch.from_numpy(c_batch["input_ids"]).long(),
                torch.from_numpy(c_batch["attention_mask"]).long())
            q = tr.model.encode_query(
                torch.from_numpy(q_batch["input_ids"]).long(),
                torch.from_numpy(q_batch["attention_mask"]).long())
        return (q @ c.T).numpy()

    losses = {"jax": [], "port": []}
    scores = {"jax": [], "port": []}

    class Recording:
        def __init__(self, tr, name):
            self.tr, self.name = tr, name

        def train_step(self, batch):
            loss = self.tr.train_step(batch)
            losses[self.name].append(float(loss))
            return loss

    def make_iter(name):
        lib = {"jax": (JaxDataArguments, JaxDRTrainDataset, JaxQPCollator,
                       jax_batched),
               "port": (DataArguments, DRTrainDataset, QPCollator, batched)}
        Args, Dataset, Collator, batch_fn = lib[name]

        def make_data_iter(path):
            ds = Dataset(tok, Args(train_path=path, train_n_passages=2,
                                   q_max_len=8, p_max_len=8))
            return batch_fn(ds.epoch_iterator(0, None), 8,
                            Collator(pad_token_id=0, q_max_len=8, p_max_len=8),
                            drop_last=True)

        return make_data_iter

    def make_refresh(name, lib, score_fn):
        def refresh_fn(tr, generation):
            s = score_fn(tr.tr)
            scores[name].append(s)
            retrieved = {f"q{i}": {f"d{j}": float(s[i, j])
                                   for j in range(TOPICS)}
                         for i in range(TOPICS)}
            cfg = lib.AnceConfig(ann_dir=str(tmp_path / name / "ann"),
                                 topk_training=8, negative_sample=1, seed=0)
            negs = lib.generate_hard_negatives(retrieved, qrels, cfg,
                                               generation)
            return lib.write_ann_data(
                cfg.ann_dir, generation,
                lib.build_ann_lines(negs, qrels, queries, corpus))

        return refresh_fn

    used = {}
    for name, lib, tr, score_fn in (("jax", jloop, jt, jax_scores),
                                    ("port", loop, pt, port_scores)):
        used[name] = lib.run_ance_alternating(
            Recording(tr, name), make_iter(name),
            make_refresh(name, lib, score_fn), str(init),
            steps_per_generation=3, num_generations=3)
    assert [os.path.basename(p) for p in used["port"]] \
        == [os.path.basename(p) for p in used["jax"]] \
        == ["gen_init.jsonl", "ann_training_data_0", "ann_training_data_1"]
    assert len(losses["port"]) == len(losses["jax"]) == 9
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=LOSS_REL)
    assert pt.step == int(jt.state.step) == 9
    for got, want in zip(scores["port"], scores["jax"]):
        diff = np.abs(got - want).max()
        gaps = np.diff(np.sort(got, axis=1), axis=1)
        assert gaps.min() > 10 * diff  # the mined order is not a tie's
    for got, want in zip(used["port"][1:], used["jax"][1:]):
        assert open(got, "rb").read() == open(want, "rb").read()


def test_refresh_encodes_the_live_module(topic_tokenizer):
    """Mid-training (dropout 0.1 on), a Retriever over ``trainer.model``
    holds the module itself, uncast, and encodes as a fresh eval copy of
    the same weights does, bit for bit; the module then trains on."""
    cfg = BertConfig(**dict(TINY, hidden_dropout_prob=0.1,
                            attention_probs_dropout_prob=0.1))
    torch.manual_seed(0)
    trainer = DRTrainer(DRModel(cfg), TrainingArguments(**alternating_kw()),
                        total_steps=100, device="cpu")
    corpus, queries, _ = toy_texts(topic_tokenizer)
    batch = QPCollator(0, 8, 8)([
        {"query": queries[f"q{i}"],
         "passages": [corpus[f"d{i}"], corpus[f"d{(i + 1) % TOPICS}"]]}
        for i in range(4)])
    for _ in range(2):
        trainer.train_step(batch)
    stream = [{"id": k, "input_ids": v} for k, v in corpus.items()]
    retriever = Retriever(trainer.model, DataArguments(p_max_len=8),
                          InferenceArguments(per_device_eval_batch_size=4), 0)
    assert retriever.model is trainer.model and trainer.model.training
    got, ids = retriever.encode_corpus(stream)
    fresh = DRModel(cfg)
    fresh.load_state_dict(trainer.model.state_dict())
    want, want_ids = encode_dataset(fresh.eval(), stream, 4, 8, 0)
    assert ids == want_ids and np.array_equal(got, want)
    assert trainer.model.training
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    trainer.model.eval()  # a caller that left it in eval mode
    trainer.train_step(batch)
    assert trainer.model.training and trainer.step == 3


# ---- the generator ----------------------------------------------------------


def test_generator_resumes_numbering_and_matches_jax(tmp_path,
                                                     topic_tokenizer):
    tok = topic_tokenizer
    corpus, queries, qrels = toy_texts(tok)
    torch.manual_seed(1)
    model = DRModel(BertConfig(**TINY), normalize=True)
    trainer = DRTrainer(model, TrainingArguments(output_dir=str(
        tmp_path / "out"), **alternating_kw()), total_steps=10, device="cpu")
    ckpt = trainer.save_checkpoint(str(tmp_path / "ckpts" / "checkpoint-7"))
    ann_dir = str(tmp_path / "ann")
    loop.write_ann_data(ann_dir, 2, ['{"older": 1}'])
    dev_qrels = {q: {d[0]: 1} for q, d in qrels.items()}
    data_args = DataArguments(q_max_len=8, p_max_len=8)
    inf_args = InferenceArguments(per_device_eval_batch_size=4)
    seen = {}

    class Recording(Retriever):
        def search(self, q_embeddings, qids, topk=100,
                   search_dtype=torch.bfloat16):
            seen["topk"] = topk
            seen["run"] = super().search(q_embeddings, qids, topk,
                                         search_dtype)
            return seen["run"]

    built = []

    def build_retriever(path):
        built.append(path)
        return Recording(DRModel.load(path, device="cpu"), data_args,
                         inf_args, 0)

    cfg = loop.AnceConfig(ann_dir=ann_dir, topk_training=6,
                          negative_sample=2, eval_topk=5, seed=3)
    loop.run_ance_generator(
        build_retriever,
        lambda: ({"id": k, "input_ids": v} for k, v in corpus.items()),
        lambda: ({"id": k, "input_ids": v} for k, v in queries.items()),
        queries, corpus, qrels, dev_qrels, str(tmp_path / "ckpts"), cfg,
        max_generations=1)
    assert built == [ckpt] and seen["topk"] == 6
    path, gen, metrics = loop.latest_ann_data(ann_dir)
    assert gen == 3 and os.path.basename(path) == "ann_training_data_3"
    assert metrics == {**jax_evaluate_run(dev_qrels, seen["run"],
                                          ["ndcg_cut_10"]),
                       "checkpoint": ckpt}
    jcfg = jloop.AnceConfig(ann_dir=str(tmp_path / "jax"), topk_training=6,
                            negative_sample=2, eval_topk=5, seed=3)
    negs = jloop.generate_hard_negatives(seen["run"], qrels, jcfg, 3)
    want = jloop.write_ann_data(
        jcfg.ann_dir, 3, jloop.build_ann_lines(negs, qrels, queries, corpus))
    assert open(path, "rb").read() == open(want, "rb").read()


# ---- the cycle twin ---------------------------------------------------------


def test_ance_cycle_tiny_runs(tmp_path, capsys):
    out = ance_cycle.main(["400", "16", "3", "--tiny", "--device", "cpu",
                           "--workdir", str(tmp_path)])
    printed = capsys.readouterr().out
    for key in ("train_gen_s", "encode_corpus_s", "encode_queries_s",
                "search_s", "mine_and_publish_s", "cycle_total"):
        assert key in printed
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()
    refresh = out["refresh"]
    assert refresh["doc_emb"].shape == (400, 16)
    assert refresh["q_emb"].shape == (16, 16)
    assert os.path.basename(refresh["path"]) == "ann_training_data_0"
    with open(refresh["path"]) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 16
    for qid, negs in refresh["negatives"].items():
        assert len(negs) == ance_cycle.NEGATIVE_SAMPLE
        assert not set(negs) & set(out["qrels"][qid])
    assert out["trainer"].step == 6


def test_ance_cycle_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ance_cycle.main(["400", "16", "3", "--tiny"])


# ---- chip_smoke's ance and beir phases, rehearsed at a tiny size ------------


@pytest.mark.parametrize("phase", ["ance", "beir"])
def test_chip_smoke_phases_rehearse(phase, monkeypatch, capsys):
    """The card's phases on the CPU at a tiny size: the same flow, entry
    points and audits; the launch checks need a card and are skipped by
    the phases themselves there."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    for name, value in dict(ANCE_DOCS=600, ANCE_QUERIES=16, ANCE_STEPS=3,
                            TRAIN_PASSAGES=500, TRAIN_QUERIES=16,
                            DEV_QUERIES=16, BEIR_DOCS=400, BEIR_QUERIES=60,
                            BEIR_TEST_QUERIES=12, BEIR_QRELS=30).items():
        monkeypatch.setattr(cs, name, value)
    cfg = BertConfig(vocab_size=2000, hidden_size=32, num_hidden_layers=1,
                     num_attention_heads=2, intermediate_size=64)
    launches = getattr(cs, f"phase_{phase}")(torch.device("cpu"), cfg)
    assert launches == {"plain_gmax": 0, "gather_rescore": 0}
    out = capsys.readouterr().out
    assert "fp32 audit" in out
