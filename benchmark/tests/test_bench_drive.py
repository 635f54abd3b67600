"""Whole runs of each cell's driver on the CPU at tiny sizes, past the
look for a card: a sound run comes out correct, and with the timed path
broken underneath (each fault the cell can have) it comes out not
correct. Then the control, the plain reference in fp8 in the program's
place, judged against each cell's real limits, which it must fail.

The tiny runs compute in float32 with limits of their own: at these
sizes bf16 on the CPU says nothing about bf16 on the card."""

import time

import pytest
import torch

from benchmark.common import find_cell, judge
from benchmark.drivers import encode, search, train
from benchmark.tests import faults
from benchmark.tests.tiny import tiny

SEARCH_LIMITS = {"rank_gap": 1e-3, "score_err": 1e-2, "lost": 0.0}
ENCODE_LIMITS = {"rep_err": 1e-3, "order": 0.0}  # reps come back fp16
TRAIN_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-2}


def fp32_cell(name, limits):
    cell = tiny(name, limits)
    cell.config["dr"] = dict(cell.config["dr"], dtype="float32")
    return cell


def search_run(seed=5):
    cell = fp32_cell("bert-base.search-batch", SEARCH_LIMITS)
    return search.run(cell, seed, 0.5, False, time.time(), "cpu")


def encode_run(seed=5):
    cell = fp32_cell("t5-base.encode", ENCODE_LIMITS)
    return encode.run(cell, seed, 0.3, False, time.time(), "cpu")


def train_run(seed=5):
    cell = fp32_cell("bert-base.train", TRAIN_LIMITS)
    return train.run(cell, seed, 0.3, False, time.time(), "cpu")


def test_search_sound_run_is_correct():
    out = search_run()
    assert out.correct, out.checks
    assert 0 < out.attempted <= 100 and out.failed == 0
    assert out.metrics["search_queries_per_s"] > 0


@pytest.mark.parametrize("fault", ["first_hit_replaced", "stale"])
def test_search_fault_is_caught(monkeypatch, fault):
    from openmatch_tpu_torch.ops.mips import Searcher

    monkeypatch.setattr(Searcher, "search",
                        getattr(faults, fault)(Searcher.search))
    out = search_run()
    assert not out.correct, out.checks


def test_search_half_batch_left_out_is_caught(monkeypatch):
    from openmatch_tpu_torch.models.dr_model import DRModel

    monkeypatch.setattr(DRModel, "encode_query",
                        faults.every_other_row_zeroed(DRModel.encode_query))
    out = search_run()
    assert not out.correct, out.checks


def test_encode_sound_run_is_correct():
    out = encode_run()
    assert out.correct, out.checks
    assert out.attempted > 0


@pytest.mark.parametrize("fault", ["every_other_row_zeroed", "rows_rolled"])
def test_encode_fault_is_caught(monkeypatch, fault):
    from openmatch_tpu_torch.models.dr_model import DRModel

    monkeypatch.setattr(DRModel, "encode",
                        getattr(faults, fault)(DRModel.encode))
    out = encode_run()
    assert not out.correct, out.checks


def test_train_sound_run_is_correct(monkeypatch):
    """Correct, with the configuration's dropout drawn in the window and
    none in the checked first steps."""
    from openmatch_tpu_torch.models import bert

    drawn = []
    full = bert.dropout

    def counted(x, rate, generator):
        drawn.append(rate if generator is not None else 0.0)
        return full(x, rate, generator)

    monkeypatch.setattr(bert, "dropout", counted)
    out = train_run()
    assert out.correct, out.checks
    assert out.chips == 1 and out.attempted > 0
    per_step = len(drawn) // (out.attempted + 3 + 1)  # check + warm steps
    assert drawn[:3 * per_step] == [0.0] * (3 * per_step)
    assert set(drawn[3 * per_step:]) == {0.1}


def test_dropout_off_puts_the_rates_back():
    from benchmark.program import dr_model
    from benchmark.weights import hf_state

    cfg = fp32_cell("bert-base.train", TRAIN_LIMITS).config
    model = dr_model(cfg, hf_state(cfg, 3, "cpu"), "cpu")
    layer = model.encoder_q.layers[0]
    with train.dropout_off(model):
        assert layer.hidden_rate == layer.attention.probs_rate == 0.0
        assert model.encoder_config.hidden_dropout_prob == 0.0
        assert model.encoder_q.config.hidden_dropout_prob == 0.0
    assert layer.hidden_rate == layer.attention.probs_rate == 0.1
    assert model.encoder_config.hidden_dropout_prob == 0.1
    assert model.encoder_q.config is model.encoder_config


def test_dropout_off_refuses_rates_it_cannot_reach():
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class Config:
        hidden_dropout_prob: float = 0.1

    class Model(torch.nn.Module):
        encoder_config = Config()

    with pytest.raises(RuntimeError, match="cannot turn it off"):
        with train.dropout_off(Model()):
            pass


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch"])
def test_train_fault_is_caught(monkeypatch, fault):
    getattr(faults, fault)(monkeypatch)
    out = train_run()
    assert not out.correct, out.checks


# ---- the controls, against the real limits ---------------------------------


def test_search_control_fails_the_real_limits():
    cell = tiny("bert-base.search-batch", find_cell(
        "bert-base.search-batch").limits)
    state = search.setup(cell, 7, torch.device("cpu"))
    search.release_program(state)
    texts = search.query_texts(cell.traffic, 32, 7)
    numbers = search.control_numbers(state, texts)
    assert not judge({k: (v, cell.limits[k]) for k, v in numbers.items()})


def test_encode_control_fails_the_real_limits():
    from benchmark.readings import encode_control

    cell = tiny("t5-base.encode", find_cell("t5-base.encode").limits)
    numbers = encode_control(cell, 7, "cpu")
    assert not judge({k: (v, cell.limits[k]) for k, v in numbers.items()})


def test_train_control_fails_the_real_limits():
    cell = tiny("bert-base.train", find_cell("bert-base.train").limits)
    ref = train.reference_readings(cell, 7, "cpu")
    ctrl = train.reference_readings(cell, 7, "cpu", "fp8")
    numbers = train.compare(ctrl, ref)
    assert not judge({k: (v, cell.limits[k]) for k, v in numbers.items()})
