"""The plain references held to the program's modules on the CPU at tiny
sizes, in float32: the BERT and T5 forward passes, the exact top-k, and
the contrastive loss with AdamW steps. The test imports the program; the
references do not."""

import numpy as np
import pytest
import torch

from benchmark import traffic
from benchmark.drivers import train as train_drv
from benchmark.program import dr_model
from benchmark.reference import bert as ref_bert
from benchmark.reference import search as ref_search
from benchmark.reference import t5 as ref_t5
from benchmark.reference.quant import exact_fp32, fp8_round
from benchmark.reference.train import Recipe, contrastive_loss, train
from benchmark.tests.tiny import tiny
from benchmark.weights import hf_state


def fp32(cell):
    cfg = dict(cell.config)
    cfg["dr"] = dict(cfg["dr"], dtype="float32")
    return cfg


def ragged_batch(lens, lo, hi, seed):
    r = np.random.default_rng(seed)
    width = max(lens)
    ids = np.zeros((len(lens), width), np.int64)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        ids[i, :n] = r.integers(lo, hi, n)
        mask[i, :n] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


def test_bert_reference_matches_the_program():
    cfg = fp32(tiny("bert-base.search-batch"))
    w = hf_state(cfg, 3, "cpu")
    model = dr_model(cfg, w, "cpu").eval()
    ids, mask = ragged_batch([5, 12, 3, 12], 1000, 2048, 0)
    with torch.no_grad(), exact_fp32():
        got = model.encode_query(ids, mask)
        want = ref_bert.reps(w, cfg, ids, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_t5_reference_matches_the_program():
    cfg = fp32(tiny("t5-base.encode"))
    w = hf_state(cfg, 4, "cpu")
    model = dr_model(cfg, w, "cpu").eval()
    ids, mask = ragged_batch([7, 32, 16, 1], 3, 500, 1)
    with torch.no_grad(), exact_fp32():
        got = model.encode_passage(ids, mask)
        want = ref_t5.reps(w, cfg, ids, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rel,bidirectional", [(np.arange(-200, 201), True),
                                               (np.arange(-200, 1), False)])
def test_t5_buckets_match_the_program(rel, bidirectional):
    from openmatch_tpu_torch.models.t5 import relative_position_bucket

    want = relative_position_bucket(rel, bidirectional, 32, 128)
    got = ref_t5.bucket(torch.from_numpy(rel), bidirectional, 32, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_exact_topk_in_blocks_matches_a_full_sort():
    g = torch.Generator().manual_seed(0)
    index = torch.randn(1000, 16, generator=g).to(torch.bfloat16)
    q = torch.randn(3, 16, generator=g)
    s, i = ref_search.topk(q, index, 10, block_rows=97)
    full = q @ index.float().T
    ws, wi = torch.topk(full, 10, dim=1)
    torch.testing.assert_close(s, ws)
    assert torch.equal(i, wi)
    torch.testing.assert_close(ref_search.scores_of(q, index, i), s)


def test_exact_topk_matches_the_program_search():
    from openmatch_tpu_torch.ops.mips import Searcher

    g = torch.Generator().manual_seed(1)
    index = torch.randn(4099, 32, generator=g).to(torch.bfloat16)
    q = torch.randn(8, 32, generator=g).to(torch.bfloat16)
    s, i = Searcher(index, k=20).search(q)
    rs, ri = ref_search.topk(q.float(), index, 20, block_rows=1000)
    torch.testing.assert_close(s.float(), rs, rtol=1e-5, atol=1e-5)
    assert torch.equal(i.long(), ri)


def test_fp8_round_is_coarser_and_passes_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = fp8_round(x)
    err = (y - x).abs().max().item()
    assert 0 < err < 0.2
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))


def test_training_steps_match_the_program():
    """Three steps of the program's ``DRTrainer`` (one process, float32)
    against the reference's loss and AdamW on the same weights and rows,
    with the model's dropout off as the check steps take them: losses, and
    every leaf after the steps."""
    cell = tiny("bert-base.train")
    cell.config = dict(fp32(cell), initializer_range=0.02)
    cell.traffic.update(queries=4, learning_rate=1e-3, total_steps=10)
    cfg, tr = cell.config, cell.traffic
    trainer, batches = train_drv.build(torch.device("cpu"), cell, 9)
    with exact_fp32(), train_drv.dropout_off(trainer.model):
        prog = train_drv.first_steps(trainer, batches, 3, cfg)
    batches.close()
    ref = train_drv.reference_readings(cell, 9, "cpu")
    np.testing.assert_allclose(prog["losses"], ref["losses"], rtol=1e-5)
    gaps = train_drv.compare(prog, ref)
    assert gaps["grad_gap"] < 1e-4 and gaps["change_gap"] < 1e-3, gaps

    # and the whole update, leaf by leaf
    from benchmark.program import encoder_config_and_state

    w0 = hf_state(cfg, train_drv.derived_seed(9, train_drv.TAG_WEIGHTS),
                  "cpu")
    feats = train_drv.global_batches(tr, cfg, 9, tr["pool_steps"])[:3]
    rows = [{"query": traffic.pad_rows([f["query"] for f in b], 8, 0),
             "passage": traffic.pad_rows(
                 [p for f in b for p in f["passages"]], 16, 0)} for b in feats]
    rows = [{k: {n: torch.from_numpy(a) for n, a in v.items()}
             for k, v in r.items()} for r in rows]
    recipe = Recipe(learning_rate=1e-3, total_steps=10,
                    max_grad_norm=tr["max_grad_norm"])
    with exact_fp32():
        _, w_end = train(w0, lambda w, i, m, p: ref_bert.reps(w, cfg, i, m),
                         rows, recipe, contrastive_loss)
    want = encoder_config_and_state(cfg, w_end)[2]
    start = encoder_config_and_state(cfg, w0)[2]
    for name, p in trainer.model.named_parameters():
        key = name.split("encoder_q.", 1)[1]
        # elements whose gradient is rounding alone take Adam's full step
        # either way, so leaves are compared by the norm of their change
        moved = torch.linalg.vector_norm(want[key] - start[key])
        off = torch.linalg.vector_norm(p.detach() - want[key])
        assert off <= 0.02 * moved + 1e-7, (key, float(off), float(moved))
