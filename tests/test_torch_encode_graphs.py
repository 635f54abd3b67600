"""The inference encode replayed as CUDA graphs (``models/graphs``).

On the CPU: the engagement rule over each of its conditions, ``encode``
giving the eager bits and counting only eager calls, and the cache's
bookkeeping (its size limit, a storage swap or a replaced parameter
forcing a fresh capture, an in-place update keeping the graph) with a
stand-in that replays the eager encode; T5's tied-head scale as a host
scalar with the bits of the old on-device one. On the card (``cuda``
marker): graph against eager bit for bit at the serving shapes of
BERT-base and T5-base, an in-place update followed by the replay, a
``p.data`` swap recaptured, two threads at once, and calls under
``inference_mode`` and ``no_grad``."""

import contextlib
import threading

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from openmatch_tpu_torch.models import dr_model, graphs
from openmatch_tpu_torch.models.bert import BertConfig
from openmatch_tpu_torch.models.dr_model import DRModel
from openmatch_tpu_torch.models.pooling import pool_hidden
from openmatch_tpu_torch.models.t5 import T5Config, T5EncoderDecoderStep

TINY_BERT = dict(vocab_size=64, hidden_size=16, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=32,
                 max_position_embeddings=32)
TINY_T5 = dict(vocab_size=64, d_model=16, d_kv=8, d_ff=32, num_layers=2,
               num_decoder_layers=2, num_heads=2,
               relative_attention_num_buckets=8,
               relative_attention_max_distance=20)


def tiny(backbone="bert", dtype=torch.bfloat16, **kw):
    torch.manual_seed(0)
    cfg = (BertConfig(**TINY_BERT) if backbone == "bert"
           else T5Config(**TINY_T5))
    return DRModel(cfg, backbone, dtype=dtype, head_in_dim=16,
                   head_out_dim=8, **kw).eval()


def batch(rows=3, cols=7, seed=1, device="cpu", vocab=64):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, vocab, (rows, cols), generator=g)
    mask = torch.ones_like(ids)
    mask[0, cols // 2:] = 0
    ids[0, cols // 2:] = 0
    return ids.to(device), mask.to(device)


class Input:
    """An input that says where it lives, and nothing else."""

    def __init__(self, is_cuda: bool):
        self.is_cuda = is_cuda


RULE = {
    "card, inference mode": ({}, True),
    "card, no_grad": ({"mode": "no_grad"}, True),
    "cpu": ({"cuda": False}, False),
    "grad on": ({"mode": "grad"}, False),
    "training": ({"training": True}, False),
    "generator": ({"generator": True}, False),
    "tensor parallel": ({"tp": True}, False),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_engagement_rule(case):
    change, want = RULE[case]
    model = tiny()
    model.train(change.get("training", False))
    if change.get("tp"):
        model.encoder_q.layers[1].attention.tp = object()
    generator = torch.Generator() if change.get("generator") else None
    mode = {"inference": torch.inference_mode(), "no_grad": torch.no_grad(),
            "grad": torch.enable_grad()}[change.get("mode", "inference")]
    with mode:
        got = graphs.engages(model, Input(change.get("cuda", True)),
                             generator)
    assert got is want


def plain_reps(model, ids, mask):
    """The encode as it was written before the graphs: the tied tower's
    encoder, pooling, head and normalisation, one op at a time."""
    out = model.encoder_q(ids, mask)
    reps = (out["decoder_hidden"][:, 0, :]
            if model.backbone_type == "t5_encdec"
            else pool_hidden(out[model.feature], mask, model.pooling))
    if model.head_q is not None:
        reps = model.head_q(reps)
    if model.normalize:
        reps = reps / torch.linalg.vector_norm(
            reps, dim=-1, keepdim=True).clamp_min(1e-12)
    return reps


@pytest.mark.parametrize("backbone,pooling,head,normalize", [
    ("bert", "first", False, False), ("bert", "mean", True, True),
    ("t5", "mean", False, True), ("t5_encdec", "first", True, False)])
def test_cpu_encode_is_eager_with_the_same_bits(backbone, pooling, head,
                                                normalize):
    model = tiny(backbone, pooling=pooling, has_head=head,
                 normalize=normalize)
    ids, mask = batch()
    with torch.inference_mode():
        got = model.encode(ids, mask, is_query=True)
        want = plain_reps(model, ids, mask)
    with torch.no_grad():
        model.encode_passage(ids, mask)
    assert torch.equal(got, want)
    assert model.graph_stats == {"captures": 0, "replays": 0, "eager": 2}


class EagerReplay:
    """A CUDA graph's stand-in on the CPU: a replay runs the eager encode
    from the static inputs into the static output."""

    def __init__(self, model, is_query, ids, mask, reps):
        self.args = model, is_query, ids, mask
        self.reps = reps

    def replay(self):
        model, is_query, ids, mask = self.args
        self.reps.copy_(model.encode_eager(ids, mask, is_query))


def eager_capture(self, model, is_query, input_ids, attention_mask):
    ids, mask = input_ids.clone(), attention_mask.clone()
    reps = model.encode_eager(ids, mask, is_query)
    return graphs._Graph(EagerReplay(model, is_query, ids, mask, reps),
                         ids, mask, reps, [])


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The cache on the CPU: every call engages, captures are stand-ins."""
    monkeypatch.setattr(dr_model, "engages", lambda model, ids, gen: True)
    monkeypatch.setattr(graphs.EncodeGraphs, "_capture", eager_capture)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())


def test_cache_holds_at_most_max_graphs(cpu_graphs):
    model = tiny()
    shapes = [(3, 5 + i) for i in range(graphs.MAX_GRAPHS + 1)]
    with torch.inference_mode():
        for rows, cols in shapes + shapes[:1]:
            ids, mask = batch(rows, cols)
            assert torch.equal(model.encode(ids, mask),
                               model.encode_eager(ids, mask))
    assert model.graph_stats == {"captures": graphs.MAX_GRAPHS,
                                 "replays": graphs.MAX_GRAPHS + 1,
                                 "eager": 1}
    assert len(model._graphs._graphs) == graphs.MAX_GRAPHS


@pytest.mark.parametrize("change,captures", [
    ("in place", 1), ("data swap", 2), ("new parameter", 2)])
def test_parameter_changes_and_the_graphs(cpu_graphs, change, captures):
    """An in-place update keeps the graph; a swapped storage or a replaced
    parameter drops every graph and captures afresh."""
    model = tiny()
    ids, mask = batch()
    with torch.inference_mode():
        before = model.encode(ids, mask)
    layer = model.encoder_q.layers[0].output
    with torch.no_grad():
        if change == "in place":
            torch._foreach_add_(list(model.parameters()), 0.01)
        elif change == "data swap":
            layer.weight.data = layer.weight.data * 2
        else:
            layer.weight = nn.Parameter(layer.weight.detach() * 2)
    with torch.inference_mode():
        after = model.encode(ids, mask)
        assert torch.equal(after, model.encode_eager(ids, mask))
    assert not torch.equal(after, before)
    assert model.graph_stats["captures"] == captures
    assert len(model._graphs._graphs) == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_t5_tied_head_scale_is_the_old_device_scalar(dtype):
    """The tied head's scale, a host float, has the bits of the scalar the
    head once made on the device every call, and scales to the same
    logits."""
    cfg = T5Config(**TINY_T5)
    torch.manual_seed(0)
    step = T5EncoderDecoderStep(cfg, dtype)
    old = torch.tensor(cfg.d_model ** -0.5, dtype=dtype)
    assert torch.equal(torch.tensor(step.lm_scale, dtype=dtype), old)
    assert float(old) == step.lm_scale
    hidden = torch.randn(3, 1, cfg.d_model).to(dtype)
    want = F.linear(hidden * old, step.shared.weight.to(dtype))
    assert torch.equal(step._lm_logits(hidden), want)


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


def seeded(model: DRModel) -> DRModel:
    """Matrices N(0, 0.02) from a seeded generator, the rest as built."""
    g = torch.Generator(device=next(model.parameters()).device)
    g.manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() == 2:
                p.normal_(0.0, 0.02, generator=g)
    return model


def base_model(backbone: str, device) -> DRModel:
    cfg = BertConfig() if backbone == "bert" else T5Config()
    with torch.device(device):
        model = DRModel(cfg, backbone, dtype=torch.bfloat16)
    return seeded(model).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("backbone,rows,cols,is_query", [
    ("bert", 64, 32, True), ("t5_encdec", 128, 128, False)])
def test_cuda_graph_equals_eager(cuda_device, backbone, rows, cols,
                                 is_query):
    model = base_model(backbone, cuda_device)
    vocab = model.encoder_config.vocab_size
    with torch.inference_mode():
        for seed in range(3):
            ids, mask = batch(rows, cols, seed, cuda_device, vocab)
            got = model.encode(ids, mask, is_query=is_query)
            want = model.encode_eager(ids, mask, is_query=is_query)
            assert torch.equal(got, want), (got - want).abs().max()
    assert model.graph_stats == {"captures": 1, "replays": 3, "eager": 0}


@pytest.mark.cuda
def test_cuda_replay_follows_in_place_updates_and_recaptures_swaps(
        cuda_device):
    model = base_model("bert", cuda_device)
    ids, mask = batch(64, 32, 0, cuda_device, 30522)
    with torch.inference_mode():
        before = model.encode(ids, mask)
    with torch.no_grad():
        torch._foreach_add_(list(model.parameters()), 1e-3)
    with torch.inference_mode():
        updated = model.encode(ids, mask)
        assert torch.equal(updated, model.encode_eager(ids, mask))
    assert not torch.equal(updated, before)
    assert model.graph_stats["captures"] == 1
    out = model.encoder_q.layers[3].output
    out.weight.data = out.weight.data.clone() * 2
    torch.cuda.empty_cache()  # the old storage back to the card
    with torch.inference_mode():
        swapped = model.encode(ids, mask)
        assert torch.equal(swapped, model.encode_eager(ids, mask))
    assert not torch.equal(swapped, updated)
    assert model.graph_stats["captures"] == 2


@pytest.mark.cuda
def test_cuda_two_threads_at_once(cuda_device):
    model = base_model("bert", cuda_device)
    inputs = [batch(64, 32, seed, cuda_device, 30522) for seed in range(2)]
    with torch.inference_mode():
        want = [model.encode_eager(ids, mask) for ids, mask in inputs]
    bad = []

    def caller(i):
        with torch.inference_mode():
            for _ in range(20):
                if not torch.equal(model.encode(*inputs[i]), want[i]):
                    bad.append(i)

    threads = [threading.Thread(target=caller, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad
    assert model.graph_stats["captures"] == 1
    assert model.graph_stats["replays"] == 40


@pytest.mark.cuda
def test_cuda_inference_mode_and_no_grad(cuda_device):
    model = base_model("bert", cuda_device)
    ids, mask = batch(64, 32, 0, cuda_device, 30522)
    with torch.no_grad():
        want = model.encode_eager(ids, mask)
    for mode in (torch.inference_mode, torch.no_grad, torch.inference_mode,
                 torch.no_grad):
        with mode():
            assert torch.equal(model.encode(ids, mask), want)
    assert model.graph_stats == {"captures": 2, "replays": 4, "eager": 0}
    with torch.enable_grad():
        model.encode(ids, mask)
    assert model.graph_stats["eager"] == 1
