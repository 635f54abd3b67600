"""The port's twins of the JAX package's remaining perf scripts
(``perf/{corpus_scale,qbatch_sweep,rescore_compare,selection_micro,
train_bench,rerank_bench,pipeline_e2e}.py`` and ``perf/build_corpus.py``),
each through its ``main(argv)`` at a tiny size with ``--device cpu``,
against the JAX package on the same inputs:

- ``corpus_scale`` and ``rescore_compare`` at N = 20,000, Q = 8, K = 100:
  their answers equal JAX's ``pallas_plain_topk_prepared`` /
  ``pallas_block_topk_prepared`` (interpret mode, the conftest's small
  rescore tile, 128-block tiles) on the same seeded rows above the k-th
  score's tie band; ``corpus_scale``'s audit passes, and a corrupted answer
  fails it; ``build_corpus`` is the padded plain layout and its rows do not
  depend on the segment count;
- ``qbatch_sweep``: one line per Q over one corpus;
- ``selection_micro``: ``topk``, ``gather`` and ``idfix`` equal to
  ``lax.top_k``, JAX's ``gather_row_slices`` and ``take_along_axis`` on the
  twin's operands;
- ``rerank_bench --tiny`` (fp32): BERT and monoT5 scores within 1e-5 of
  JAX's ``RRModel.score`` -> ``relevance_logprob`` with the weights carried
  across;
- ``train_bench --tiny`` (fp32): DR, ``--grad-cache``, ``--t5``, ``--rr``
  and ``--rr --t5``: the first step's loss equals JAX's trainer's (rel
  1e-5) on the same batch and weights;
- ``pipeline_e2e`` at 512 docs on the BERT-base shape, each stage its own
  process: MRR@10 = 1.0 (the JAX script's own CPU check);
- each twin asks for the card by default and raises without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openmatch_tpu.ops.pallas_mips as pm
from openmatch_tpu_torch.models.jax_convert import params_to_jax
from openmatch_tpu_torch.perf import (agree_above_band, corpus_scale,
                                      pipeline_e2e, qbatch_sweep,
                                      rerank_bench, rescore_compare,
                                      selection_micro, train_bench)
from openmatch_tpu_torch.perf.build_corpus import build_corpus, corpus_rows

torch.set_num_threads(2)
CPU = ["--device", "cpu"]
N, Q, K = "20000", "8", "100"
TILE_G, TILE_Q = 128, 8  # the JAX kernels' test tiles


@pytest.fixture(scope="module")
def rows_and_queries():
    """The twins' corpus rows and queries, as JAX arrays."""
    from openmatch_tpu_torch.perf import normal

    rows = corpus_rows(build_corpus(int(N), torch.device("cpu")))
    q = normal((int(Q), 768), 1, torch.device("cpu"))
    return jnp.asarray(rows.float().numpy()), jnp.asarray(q.float().numpy())


@pytest.fixture(scope="module")
def jax_plain(rows_and_queries):
    c_j, q_j = rows_and_queries
    s, i = pm.pallas_plain_topk_prepared(
        q_j, pm.prepare_plain_corpus(c_j, tile_g=TILE_G), k=int(K),
        tile_g=TILE_G, tile_q=TILE_Q)
    return torch.from_numpy(np.array(s)), torch.from_numpy(
        np.array(i)).long()


def test_build_corpus_is_the_padded_plain_layout():
    prep = build_corpus(20_005, torch.device("cpu"))
    assert prep.plain.shape == (2560 * 8, 768) and prep.tail.shape == (5, 768)
    assert prep.plain.dtype == torch.bfloat16
    assert not prep.plain[2500 * 8:].any()  # the pad rows stay 0
    assert prep.plain[:2500 * 8].abs().amax(1).min() > 0
    segs = build_corpus(20_005, torch.device("cpu"), n_segs=3)
    assert [s.shape[0] for s in segs.plain] == [4 * 2048, 3 * 2048, 3 * 2048]
    assert torch.equal(corpus_rows(prep), corpus_rows(segs))


def test_corpus_scale_matches_jax_and_audits(rows_and_queries, jax_plain):
    out = corpus_scale.main([N, Q, K] + CPU)
    assert out["recalls"] == [1.0] * corpus_scale.AUDIT_Q
    assert torch.equal(out["queries"].float(),
                       torch.from_numpy(np.array(rows_and_queries[1])))
    agree_above_band("corpus_scale vs JAX", out["scores"], out["ids"],
                     *jax_plain)
    assert out["ms"] > 0 and out["qps"] > 0


def test_corpus_scale_audit_catches_a_wrong_answer():
    prep = build_corpus(int(N), torch.device("cpu"))
    q = torch.randn(2, 768, generator=torch.Generator().manual_seed(5)) \
        .to(torch.bfloat16)
    ref_s, ref_i = corpus_scale.audit_topk(q, prep, int(K))
    assert corpus_scale.audit(ref_s, ref_i, ref_s, ref_i) == [1.0, 1.0]
    wrong = ref_i.clone()
    wrong[1, :5] = ref_i[0, :5]  # five of row 1's top docs replaced
    with pytest.raises(AssertionError, match="recall"):
        corpus_scale.audit(ref_s, wrong, ref_s, ref_i)
    with pytest.raises(AssertionError):
        corpus_scale.audit(ref_s + 1e-2, ref_i, ref_s, ref_i)


def test_rescore_compare_matches_jax(rows_and_queries, jax_plain):
    c_j, q_j = rows_and_queries
    out = rescore_compare.main([N, Q, K] + CPU)
    assert list(out["paths"]) == ["xla", "dma", "plain", "pipelined"]
    s, i = pm.pallas_block_topk_prepared(
        q_j, pm.prepare_block_corpus(c_j, tile_g=TILE_G), k=int(K),
        tile_g=TILE_G, tile_q=TILE_Q, rescore="dma")
    jax_block = (torch.from_numpy(np.array(s)),
                 torch.from_numpy(np.array(i)).long())
    for name, path in out["paths"].items():
        want = jax_block if name in ("xla", "dma") else jax_plain
        agree_above_band(f"rescore_compare {name} vs JAX", path["scores"],
                         path["ids"], *want)
        assert path["ms"] > 0
    one = rescore_compare.main([N, Q, K, "--paths", "dma"] + CPU)
    assert list(one["paths"]) == ["dma"]
    assert torch.equal(one["paths"]["dma"]["ids"], out["paths"]["dma"]["ids"])


def test_qbatch_sweep_one_line_per_q(capsys):
    out = qbatch_sweep.main(["12000", "4", "8", "--segs", "2"] + CPU)
    assert [r["Q"] for r in out["rows"]] == [4, 8]
    assert all(r["ms"] > 0 and r["qps"] > 0 for r in out["rows"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in lines] == ["Q=4", "Q=8"]


@pytest.mark.parametrize("prim", ["topk", "gather", "idfix"])
def test_selection_micro_matches_jax(prim):
    from openmatch_tpu.ops.mips import gather_row_slices

    out = selection_micro.main([prim, "1003", "4", "10"] + CPU)
    assert out["W"] == 1008 and out["ms"] > 0
    x, idx = jnp.asarray(out["x"].numpy()), jnp.asarray(out["idx"].numpy())
    if prim == "topk":
        want = jax.lax.top_k(x, 10)[0]
    elif prim == "gather":
        want = gather_row_slices(x, idx * 8, 8)
    else:
        want = jnp.take_along_axis(x[:, :10], idx % 10, axis=1)
    np.testing.assert_array_equal(out["out"].numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["bert", "monot5"])
def test_rerank_bench_scores_match_jax(kind):
    from openmatch_tpu.models.bert import BertConfig
    from openmatch_tpu.models.rr_model import RRModel
    from openmatch_tpu.models.t5 import T5Config

    argv = [kind, "6", "20", "--tiny", "--dtype", "float32"] + CPU
    out = rerank_bench.main(argv)
    model, (ids, mask, segs) = rerank_bench.build(rerank_bench.parse(argv))
    if kind == "bert":
        jm = RRModel(encoder_config=BertConfig(
            vocab_size=64, hidden_size=16, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=32, add_pooler=False),
            head_in_dim=16, dtype=jnp.float32)
    else:
        jm = RRModel(encoder_config=T5Config(
            d_model=16, d_kv=8, d_ff=32, num_layers=1, num_decoder_layers=1,
            num_heads=2, vocab_size=64), backbone_type="t5", pos_token_id=3,
            neg_token_id=4, dtype=jnp.float32)
    params = params_to_jax(model.state_dict(), 2)
    want = jm.relevance_logprob(jm.score(params, jnp.asarray(ids),
                                         jnp.asarray(mask),
                                         jnp.asarray(segs)))
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert out["pairs_s"] > 0


@pytest.mark.parametrize("flags", [[], ["--grad-cache"], ["--t5"], ["--rr"],
                                   ["--rr", "--t5"]])
def test_train_bench_first_loss_matches_jax(flags):
    from openmatch_tpu.config import TrainingArguments
    from openmatch_tpu.models.bert import BertConfig
    from openmatch_tpu.models.dr_model import DRModel
    from openmatch_tpu.models.rr_model import RRModel
    from openmatch_tpu.models.t5 import T5Config
    from openmatch_tpu.parallel.mesh import make_mesh
    from openmatch_tpu.train.dr_trainer import DRTrainer
    from openmatch_tpu.train.rr_trainer import RRTrainer

    argv = ["4", "3", "--tiny", "--dtype", "float32"] + flags + CPU
    out = train_bench.main(argv)
    model, _, _, batch, _ = train_bench.build(train_bench.parse(argv))
    t5, rr = "--t5" in flags, "--rr" in flags
    cfg = (T5Config(d_model=16, d_kv=8, d_ff=32, num_layers=1,
                    num_decoder_layers=1, num_heads=2, vocab_size=64) if t5
           else BertConfig(vocab_size=64, hidden_size=16, num_hidden_layers=1,
                           num_attention_heads=2, intermediate_size=32,
                           add_pooler=False))
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    params = params_to_jax(model.state_dict(), 2)
    if rr:
        jm = RRModel(encoder_config=cfg, backbone_type="t5" if t5 else "bert",
                     pos_token_id=3, neg_token_id=4, head_in_dim=16,
                     loss_fn_str="ce" if t5 else "bce", dtype=jnp.float32)
        jt = RRTrainer(jm, params, TrainingArguments(
            per_device_train_batch_size=4, max_steps=1000),
            total_steps=1000, mesh=mesh)
    else:
        jm = DRModel(encoder_config=cfg,
                     backbone_type="t5_encdec" if t5 else "bert",
                     dtype=jnp.float32)
        jt = DRTrainer(jm, params, TrainingArguments(
            negatives_x_device=True, grad_cache="--grad-cache" in flags,
            per_device_train_batch_size=4, max_steps=1000),
            total_steps=1000, mesh=mesh)
    want = float(jt.train_step(jax.tree.map(
        lambda a: np.asarray(a, np.int32), batch)))
    assert out["first_loss"] == pytest.approx(want, rel=1e-5)
    assert out["steps"] == 1 + train_bench.ITERS and out["ms"] > 0


def test_pipeline_e2e_finds_each_query_s_doc(tmp_path):
    out = pipeline_e2e.main(["--n-docs", "512", "--n-queries", "64",
                             "--workdir", str(tmp_path)] + CPU)
    assert out["mrr_cut_10"] == 1.0 and out["functional_pass"]
    assert set(out["stage_s"]) == {"build_index", "retrieve", "evaluate"}
    # the CPU searches with the plain versions: no kernel launches
    assert out["retrieve_launches"] == {}


def test_pipeline_e2e_data_are_the_jax_script_s(tmp_path):
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "jax_pipeline_e2e", os.path.join(pipeline_e2e.REPO, "scripts",
                                         "perf", "pipeline_e2e.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    for name, lib in (("port", pipeline_e2e), ("jax", jax_script)):
        (tmp_path / name).mkdir()
        lib.gen_data(str(tmp_path / name), 300, 40)
    for f in ("corpus.jsonl", "queries.tsv", "qrels.txt"):
        assert (tmp_path / "port" / f).read_bytes() \
            == (tmp_path / "jax" / f).read_bytes()


@pytest.mark.parametrize("twin,argv", [
    (corpus_scale, ["2000", "4", "10"]),
    (qbatch_sweep, ["2000", "4"]),
    (rescore_compare, ["2000", "4", "10"]),
    (selection_micro, ["topk", "64"]),
    (train_bench, ["2", "2", "--tiny"]),
    (rerank_bench, ["bert", "2", "8", "--tiny"]),
    (pipeline_e2e, ["--n-docs", "16", "--n-queries", "4", "--tiny"]),
])
def test_twins_default_to_the_card(twin, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        twin.main(argv)
