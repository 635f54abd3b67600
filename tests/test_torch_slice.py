"""The serving slice end to end, the JAX package against the port (CPU, fp32):

- a checkpoint written by the JAX ``DRModel.save`` loads in the port's
  ``DRModel.load`` and encodes the same (max abs diff <= 2e-4);
- embedding shards written by the JAX ``build_index`` driver, searched by
  the port's ``retrieve`` driver, give the JAX ``retrieve`` run's TREC ids
  (scores within 1e-4);
- the same npz gives a bit-identical bf16 index in both packages;
- the port's ``/search`` over HTTP returns the JAX ``RetrievalService``'s
  results for the same checkpoint and shards.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmatch_tpu.config import DataArguments, InferenceArguments, ModelArguments
from openmatch_tpu.models.bert import BertConfig as JaxBertConfig
from openmatch_tpu.models.dr_model import DRModel as JaxDRModel
from openmatch_tpu.utils.trec import load_from_trec
from openmatch_tpu_torch.models.dr_model import DRModel

torch.set_num_threads(2)
WORDS = [f"w{i}" for i in range(27)]
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
CFG = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=40)


def texts(seed, n, lo, hi):
    rng = np.random.RandomState(seed)
    return [" ".join(rng.choice(WORDS, rng.randint(lo, hi))) for _ in range(n)]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A JAX checkpoint (with its tokenizer), a corpus and queries."""
    from transformers import BertTokenizerFast

    root = tmp_path_factory.mktemp("slice")
    (root / "vocab.txt").write_text("\n".join(VOCAB))
    tok = BertTokenizerFast(vocab_file=str(root / "vocab.txt"))
    ckpt = root / "ckpt"
    model = JaxDRModel(encoder_config=JaxBertConfig(**CFG), normalize=True,
                       dtype=jnp.float32)
    params = model.init_params(jax.random.PRNGKey(0))
    model.save(params, str(ckpt))
    tok.save_pretrained(str(ckpt))
    docs = texts(1, 40, 3, 9)
    with open(root / "corpus.jsonl", "w") as f:
        for i, t in enumerate(docs):
            f.write(json.dumps({"id": f"d{i}", "title": "", "text": t}) + "\n")
    queries = texts(2, 6, 2, 5)
    with open(root / "queries.jsonl", "w") as f:
        for i, t in enumerate(queries):
            f.write(json.dumps({"id": f"q{i}", "text": t}) + "\n")
    return root, tok, queries


def flags(root, emb_dir, **extra):
    args = {
        "model_name_or_path": str(root / "ckpt"), "dtype": "float32",
        "corpus_path": str(root / "corpus.jsonl"),
        "query_path": str(root / "queries.jsonl"),
        "doc_template": "<text>", "q_max_len": "8", "p_max_len": "12",
        "encoded_save_path": str(emb_dir), "per_device_eval_batch_size": "16",
        "retrieve_depth": "10",
    }
    args.update(extra)
    return [x for k, v in args.items() for x in (f"--{k}", v)]


@pytest.fixture(scope="module")
def jax_index(workspace):
    """Shards from the JAX build_index driver and the JAX retrieve run."""
    from openmatch_tpu.drivers import build_index, retrieve

    root, _, _ = workspace
    emb = root / "emb"
    mp = pytest.MonkeyPatch()
    mp.setenv("OPENMATCH_FORCE_CPU", "1")  # no compilation-cache dir
    try:
        build_index.main(flags(root, emb, encode_num_shard="2",
                               encode_shard_index="0"))
        build_index.main(flags(root, emb, encode_num_shard="2",
                               encode_shard_index="1"))
        retrieve.main(flags(root, emb, trec_save_path=str(root / "jax.trec")))
    finally:
        mp.undo()
    return emb, load_from_trec(str(root / "jax.trec"))


def test_checkpoint_from_jax_encodes_the_same(tmp_path):
    cfg = JaxBertConfig(**CFG)
    jm = JaxDRModel(encoder_config=cfg, tied=False, pooling="mean",
                    has_head=True, head_in_dim=32, head_out_dim=16,
                    dtype=jnp.float32)
    params = jm.init_params(jax.random.PRNGKey(4))
    jm.save(params, str(tmp_path))
    pm = DRModel.load(str(tmp_path), dtype="float32", device="cpu")
    rng = np.random.RandomState(5)
    ids = rng.randint(5, len(VOCAB), size=(4, 9)).astype(np.int32)
    mask = (np.arange(9)[None] < np.array([[9], [5], [2], [7]])).astype(np.int32)
    for is_query in (True, False):
        want = np.asarray(jm.encode(params, jnp.asarray(ids),
                                    jnp.asarray(mask), is_query=is_query))
        with torch.inference_mode():
            got = pm.encode(torch.from_numpy(ids), torch.from_numpy(mask),
                            is_query=is_query).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("entry", ["load", "build"])
def test_dr_model_defaults_to_the_card(tmp_path, monkeypatch, entry):
    """``DRModel.load`` and ``DRModel.build`` with no device ask for the
    card: on a host without one they raise, and only a caller that names
    the CPU gets a CPU model."""
    from openmatch_tpu_torch.config import ModelArguments as PortModelArguments

    jm = JaxDRModel(encoder_config=JaxBertConfig(**CFG), dtype=jnp.float32)
    jm.save(jm.init_params(jax.random.PRNGKey(6)), str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = PortModelArguments(model_name_or_path=str(tmp_path),
                              dtype="float32")

    def call(**kw):
        if entry == "load":
            return DRModel.load(str(tmp_path), dtype="float32", **kw)
        return DRModel.build(args, **kw)

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(device="cuda")
    model = call(device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_port_retrieve_driver_reproduces_jax_run(workspace, jax_index):
    from openmatch_tpu_torch.drivers import retrieve

    root, _, _ = workspace
    emb, want = jax_index
    trec = root / "port.trec"
    retrieve.main(flags(root, emb, trec_save_path=str(trec)) + ["--device", "cpu"])
    got = load_from_trec(str(trec))
    assert set(got) == set(want) and len(want) == 6
    for qid in want:
        w = sorted(want[qid].items(), key=lambda kv: -kv[1])
        g = sorted(got[qid].items(), key=lambda kv: -kv[1])
        assert [d for d, _ in g] == [d for d, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=1e-4)


def test_same_npz_gives_bit_identical_bf16_index(workspace, jax_index):
    import ml_dtypes

    from openmatch_tpu_torch.retriever.retriever import Retriever

    root, _, _ = workspace
    emb, _ = jax_index
    infer = InferenceArguments(encoded_save_path=str(emb))
    pm = DRModel.load(str(root / "ckpt"), dtype="float32", device="cpu")
    r = Retriever.from_embeddings(pm, DataArguments(), infer, 0, "cpu")
    assert r.doc_embeddings.dtype == np.float16 and len(r.doc_ids) == 40
    want = r.doc_embeddings.astype(ml_dtypes.bfloat16).view(np.int16)
    got = r.index_tensor().view(torch.int16).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_http_search_matches_jax_service(workspace, jax_index):
    import ml_dtypes

    from openmatch_tpu.drivers.serve import RetrievalService as JaxService
    from openmatch_tpu.ops.mips import Searcher as JaxSearcher
    from openmatch_tpu.retriever.encoder import list_shards, load_embeddings
    from openmatch_tpu_torch.drivers.serve import (ServingHTTPServer,
                                                   build_service, make_handler)

    root, tok, queries = workspace
    emb, _ = jax_index
    model_args = ModelArguments(model_name_or_path=str(root / "ckpt"),
                                dtype="float32")
    data_args = DataArguments(q_max_len=8)
    infer = InferenceArguments(encoded_save_path=str(emb), retrieve_depth=10)

    jm, jparams = JaxDRModel.load(str(root / "ckpt"))
    parts = [load_embeddings(p) for p in list_shards(str(emb), "corpus")]
    host = np.concatenate([e for e, _ in parts]).astype(ml_dtypes.bfloat16)
    doc_ids = [i for _, ids in parts for i in ids]
    jax_service = JaxService(jm, jparams, tok, JaxSearcher(host, k=10),
                             doc_ids, q_max_len=8, max_batch=4)
    want = jax_service.search(queries, k=7)

    service = build_service(model_args, data_args, infer, max_batch=4,
                            device=torch.device("cpu"))
    server = ServingHTTPServer(("127.0.0.1", 0), make_handler(service, 10))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=30) as resp:
            health = json.loads(resp.read())
        assert health == {"status": "ok", "endpoints": ["/search"],
                          "num_docs": 40}
        req = urllib.request.Request(
            base + "/search", data=json.dumps({"queries": queries, "k": 7}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())["results"]
        rerank = urllib.request.Request(base + "/rerank", data=b"{}")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(rerank, timeout=30)
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert len(got) == len(want) == len(queries)
    for g, w in zip(got, want):
        assert [x["id"] for x in g] == [x["id"] for x in w]
        np.testing.assert_allclose([x["score"] for x in g],
                                   [x["score"] for x in w], atol=1e-4)


def test_build_service_takes_search_n_segs(workspace, jax_index):
    """--search_n_segs reaches the served Searcher: a segmented index with
    the kernel path answers as the single buffer does; "auto" on the CPU
    (the plain path) refuses it, as the JAX package does."""
    from openmatch_tpu_torch.drivers.serve import build_service

    root, _, queries = workspace
    emb, _ = jax_index
    model_args = ModelArguments(model_name_or_path=str(root / "ckpt"),
                                dtype="float32")
    data_args = DataArguments(q_max_len=8)
    cpu = torch.device("cpu")
    answers = []
    for n_segs in (1, 2):
        infer = InferenceArguments(encoded_save_path=str(emb),
                                   retrieve_depth=10, search_method="pallas",
                                   search_n_segs=n_segs)
        service = build_service(model_args, data_args, infer, max_batch=4,
                                device=cpu)
        assert isinstance(service.searcher._prep.plain, tuple) == (n_segs > 1)
        answers.append(service.search(queries, k=7))
    assert answers[0] == answers[1]
    with pytest.raises(ValueError, match="n_segs"):
        build_service(model_args, data_args,
                      InferenceArguments(encoded_save_path=str(emb),
                                         search_n_segs=2),
                      max_batch=4, device=cpu)


def test_build_service_takes_approx(workspace, jax_index):
    """--search_method approx serves from the plain path (full scores,
    exact top-k) and answers as the default service does."""
    from openmatch_tpu_torch.drivers.serve import build_service

    root, _, queries = workspace
    emb, _ = jax_index
    model_args = ModelArguments(model_name_or_path=str(root / "ckpt"),
                                dtype="float32")
    answers = []
    for method in ("auto", "approx"):
        infer = InferenceArguments(encoded_save_path=str(emb),
                                   retrieve_depth=10, search_method=method)
        service = build_service(model_args, DataArguments(q_max_len=8), infer,
                                max_batch=4, device=torch.device("cpu"))
        assert service.searcher.method == "plain"
        answers.append(service.search(queries, k=7))
    assert answers[0] == answers[1]


def test_encoded_queries_search_the_alternative_layouts_as_jax(workspace):
    """The JAX DRModel and the port's, on the same checkpoint, encode the
    same queries; each package's hier2_rescore and dma-rescored block path
    then searches one seeded corpus (2 whole 1024-row tiles plus a ragged
    one, N % 8 = 5) with its own query reps: the same ids above the tie
    band, scores within 1e-4."""
    from openmatch_tpu.ops import pallas_mips as pm
    from openmatch_tpu_torch.ops import cuda_mips as cm

    root, tok, queries = workspace
    jm, jparams = JaxDRModel.load(str(root / "ckpt"))
    pmodel = DRModel.load(str(root / "ckpt"), dtype="float32", device="cpu")
    enc = tok(queries, padding="max_length", max_length=8, truncation=True,
              return_tensors="np")
    ids = enc["input_ids"].astype(np.int32)
    mask = enc["attention_mask"].astype(np.int32)
    q_j = jm.encode(jparams, jnp.asarray(ids), jnp.asarray(mask),
                    is_query=True)
    with torch.inference_mode():
        q = pmodel.encode(torch.from_numpy(ids), torch.from_numpy(mask),
                          is_query=True)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), atol=2e-4, rtol=0)

    corpus = np.random.RandomState(6).randn(2 * 1024 + 77, 32).astype(
        np.float32)
    c, c_j = torch.from_numpy(corpus), jnp.asarray(corpus)
    k = 10
    runs = {
        "hier2_rescore": (
            pm.pallas_hier2_rescore(q_j, c_j, k=k, tile=1024),
            cm.hier2_rescore(q, c, k, tile=1024)),
        "block_topk_prepared(rescore='dma')": (
            pm.pallas_block_topk_prepared(
                q_j, pm.prepare_block_corpus(c_j, tile_g=128), k=k,
                tile_g=128, tile_q=8, rescore="dma"),
            cm.block_topk_prepared(q, cm.prepare_block_corpus(c), k,
                                   rescore="dma")),
    }
    for name, ((s_want, i_want), (s_got, i_got)) in runs.items():
        s_want, i_want = np.asarray(s_want), np.asarray(i_want)
        s_got, i_got = s_got.numpy(), i_got.numpy()
        np.testing.assert_allclose(s_got, s_want, atol=1e-4, rtol=0,
                                   err_msg=name)
        for r in range(len(queries)):
            band = s_want[r, -1] + 1e-4
            assert set(i_got[r][s_got[r] > band].tolist()) \
                == set(i_want[r][s_want[r] > band].tolist()), name
