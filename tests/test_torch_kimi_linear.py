"""The ``kimi_linear`` backbone (``models/kimi_linear.py``), K13
(``ops/kda.py``) and the held-experts share of ``deepseek_v3.MoE`` on the
CPU at a tiny size: against the benchmark's plain float32 reference
(``benchmark/reference/kimi_linear``), K13's plain version against the
token-by-token recurrence and against ``transformers``' ``qwen3_next``
recurrence, the share against the uncut layer, the counters, the spans,
the HuggingFace conversion and the config reader. The card's cases skip
without one.

Tiny configuration: hidden 64; four layers (KDA + dense, KDA + MoE,
NoPE MLA + MoE, KDA + MoE), 2 KDA heads of 16, 4 MLA heads of 16 + 8
query/key dims and 16 value dims, latent 16; the router over 8 experts
(top 2, one shared). Weights are the benchmark's seeded draws
(``benchmark/kimi_weights``), by HF name."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.kimi_weights import KimiDrawn
from benchmark.reference import kimi_linear as ref
from benchmark.reference.quant import exact_fp32
from openmatch_tpu_torch.models import deepseek_v3 as ds
from openmatch_tpu_torch.models import kimi_linear as kl
from openmatch_tpu_torch.models.dr_model import (DRModel, config_from_dict,
                                                 hidden_size, make_encoder,
                                                 num_heads)
from openmatch_tpu_torch.ops import _build, kda
from openmatch_tpu_torch.utils import profiling

HF = {"model_type": "kimi_linear", "vocab_size": 97, "hidden_size": 64,
      "intermediate_size": 96, "moe_intermediate_size": 32,
      "num_hidden_layers": 4, "num_attention_heads": 4,
      "num_key_value_heads": 4, "num_experts": 8, "num_shared_experts": 1,
      "num_experts_per_token": 2, "first_k_dense_replace": 1,
      "kv_lora_rank": 16, "q_lora_rank": None, "qk_nope_head_dim": 16,
      "qk_rope_head_dim": 8, "v_head_dim": 16, "rms_norm_eps": 1e-5,
      "rope_theta": 10000.0, "rope_scaling": None,
      "routed_scaling_factor": 2.446, "moe_renormalize": True,
      "moe_router_activation_func": "sigmoid", "num_expert_group": 1,
      "topk_group": 1, "use_grouped_topk": True, "moe_layer_freq": 1,
      "hidden_act": "silu", "mla_use_nope": True,
      "num_nextn_predict_layers": 0,
      "linear_attn_config": {"kda_layers": [1, 2, 4],
                             "full_attn_layers": [3], "num_heads": 2,
                             "head_dim": 16, "short_conv_kernel_size": 4},
      "pad_token_id": 0, "initializer_range": 0.1,
      "e_score_correction_bias_std": 0.05, "dr": {"normalize": True}}
CFG = kl.kimi_linear_config_from_hf(HF)
TOL = dict(rtol=1e-5, atol=1e-5)


def bench_cfg(held=(0, 8)):
    """The benchmark's form of the configuration: ``num_experts`` held,
    the router's width beside it."""
    return dict(HF, num_experts=held[1], published_num_experts=8,
                held_experts=list(held))


def weights(seed=3, held=(0, 8)):
    drawn = KimiDrawn(bench_cfg(held), seed, "cpu", torch.float32)
    return {n: drawn[n] for n in drawn}


def batch(lens, width=None, seed=0, vocab=97):
    g = np.random.default_rng(seed)
    width = width or max(lens)
    ids = np.zeros((len(lens), width), np.int64)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lens):
        ids[i, :n] = g.integers(1, vocab, n)
        mask[i, :n] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


def program(w, held=None, dtype=torch.float32, device="cpu"):
    cfg = kl.KimiLinearConfig(**dict(CFG.to_dict(), held_experts=held))
    with torch.device(device):
        model = DRModel(cfg, backbone_type="kimi_linear", pooling="last",
                        normalize=True, dtype=dtype)
    dest = model.encoder_q.state_dict()
    for name, t in w.items():
        kl.load_hf_tensor(dest, name, t, cfg)
    return model.eval()


# ---- the port against the plain reference ----------------------------------


@pytest.mark.parametrize("lens", [[7, 40, 1, 23], [16, 33, 17], [3]])
def test_port_matches_the_reference(lens):
    w = weights()
    ids, mask = batch(lens, width=41)
    model = program(w)
    with torch.no_grad(), exact_fp32():
        got = model.encode_passage(ids, mask)
        want = ref.reps(w, bench_cfg(), ids, mask)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("held", [(0, 4), (4, 4), (2, 3)])
def test_a_share_of_the_experts_matches_the_reference(held):
    w = weights(5, held)
    ids, mask = batch([9, 30, 12], width=32, seed=2)
    model = program(w, held)
    with torch.no_grad(), exact_fp32():
        got = model.encoder_q(ids, mask)["last_hidden_state"]
        want = ref.hidden_states(w, bench_cfg(held), ids, mask)
    real = mask.bool()
    torch.testing.assert_close(got[real], want[real], **TOL)


def test_the_share_adds_up_to_the_uncut_layer():
    """The routed parts of experts 0 .. E/2 and E/2 .. E, with the shared
    expert counted once, add up to the uncut MoE layer."""
    ds_cfg = CFG.deepseek_view()
    torch.manual_seed(0)
    whole = ds.MoE(ds_cfg, torch.float32)
    with torch.no_grad():
        for p in whole.parameters():
            p.normal_(0, 0.3)
        whole.gate.e_score_correction_bias.normal_(0, 0.05)
    halves = []
    for first in (0, 4):
        part = ds.MoE(ds_cfg, torch.float32, held=(first, 4))
        state = dict(whole.state_dict())
        for key in ("experts.gate_up_proj", "experts.down_proj"):
            state[key] = state[key][first:first + 4]
        part.load_state_dict(state)
        halves.append(part)
    real = torch.ones(4, 6, dtype=torch.bool)
    real[1, 3:] = False
    pack = ds.Packing.of(real, ds.packed_slots(4, 6))
    x = torch.randn(pack.real.numel(), 64)
    with torch.no_grad():
        full = whole(x, pack, torch.zeros(8, dtype=torch.int64))
        parts = [h(x, pack, torch.zeros(8, dtype=torch.int64))
                 for h in halves]
        shared = whole.shared_experts(x)
    torch.testing.assert_close(parts[0] + parts[1] - shared, full, **TOL)


def test_reference_share_adds_up_to_the_uncut_layer():
    w = weights(4)
    x = torch.randn(2, 5, 64)
    real = torch.ones(2, 5, dtype=torch.bool)
    p = "layers.1.mlp"
    with torch.no_grad():
        full = ref._moe(w, p, x, real, bench_cfg(), None)
        a = ref._moe(w, p, x, real, bench_cfg((0, 4)), None)
        b = ref._moe(w, p, x, real, bench_cfg((4, 4)), None)
        shared = ref._swiglu(w, f"{p}.shared_experts.gate_proj.weight",
                             f"{p}.shared_experts.up_proj.weight",
                             f"{p}.shared_experts.down_proj.weight", x, None)
    torch.testing.assert_close(a + b - shared, full, **TOL)


# ---- K13's plain version ----------------------------------------------------


def k13_inputs(lens, T, H=2, D=16, K=4, seed=0, decay=1.0):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(T, 3 * H * D, generator=g)
    conv = torch.rand(3 * H * D, K, generator=g) - 0.5
    log_decay = -decay * torch.rand(T, H * D, generator=g)
    beta = torch.rand(T, H, generator=g)
    cu = torch.tensor([0] + list(np.cumsum(lens)))
    return qkv, conv, log_decay, beta, cu


@pytest.mark.parametrize("lens", [[5, 37, 0, 16, 1, 20], [40], [17, 15]])
def test_k13_plain_matches_the_token_recurrence(lens):
    T = sum(lens) + 3  # slots past the last document hold no token
    H, D = 2, 16
    qkv, conv, g, beta, cu = k13_inputs(lens, T, decay=3.0)
    got = kda.kda_chunk_plain(qkv, conv, g, beta, cu, H)
    x = kda.causal_conv_silu(qkv, conv, cu)
    for lo, hi in zip(cu[:-1].tolist(), cu[1:].tolist()):
        if hi == lo:
            continue
        q, k, v = x[lo:hi].view(1, hi - lo, 3, H, D).unbind(2)
        # each document alone, its history zero
        alone = ref._conv_silu(qkv[None, lo:hi], conv[:, None, :])
        torch.testing.assert_close(alone[0], x[lo:hi], **TOL)
        want = ref.kda_recurrence(
            ref.l2_normalize(q) * D ** -0.5, ref.l2_normalize(k), v,
            g[lo:hi].view(1, -1, H, D), beta[None, lo:hi])[0]
        torch.testing.assert_close(got[lo:hi], want, **TOL)


def test_k13_plain_matches_qwen3_next_with_a_decay_a_head(monkeypatch):
    """An independent check of the recurrence: ``transformers``'
    ``qwen3_next`` gated delta rule (one decay a head), token by token."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    qwen = pytest.importorskip(
        "transformers.models.qwen3_next.modeling_qwen3_next")
    H, D, L = 2, 16, 37
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, L, H, D, generator=g) for _ in range(3))
    head_decay = -torch.rand(1, L, H, generator=g)
    beta = torch.rand(1, L, H, generator=g)
    want, _ = qwen.torch_recurrent_gated_delta_rule(
        q, k, v, head_decay, beta, None, False,
        use_qk_l2norm_in_kernel=True)
    got = kda.gated_delta_chunks(
        kda.l2_normalize(q[0]) * D ** -0.5, kda.l2_normalize(k[0]), v[0],
        head_decay[0, :, :, None].expand(L, H, D), beta[0],
        torch.tensor([0, L]))
    torch.testing.assert_close(got, want[0], **TOL)


def test_k13_shapes_are_checked():
    qkv, conv, g, beta, cu = k13_inputs([4], 4)
    with pytest.raises(ValueError, match="must be"):
        kda.kda_chunk(qkv, conv, g[:, :8], beta, cu, 2)


# ---- packing, counters, spans ---------------------------------------------


def test_a_documents_rep_does_not_depend_on_its_neighbours():
    """Packed next to short or long neighbours, or in either half of a
    batch that overflows the stream, a document's rep is the same up to
    rounding on the CPU (the card holds it to the bit: see below)."""
    model = program(weights())
    B, S, L = 4, 24, 17
    g = np.random.default_rng(3)
    doc = torch.from_numpy(g.integers(1, 97, L))
    slots = ds.packed_slots(B, S)
    reps = []
    for row, others in ((1, [3, 2, 4]), (0, [S // 2, S // 2, 1]),
                        (3, [20, 20, 20]), (0, [20, 20, 20])):
        lens = others[:row] + [L] + others[row:]
        ids, mask = batch(lens, width=S, seed=row)
        ids[row, :L] = doc
        with torch.no_grad():
            reps.append(model.encode_passage(ids, mask)[row])
        assert (int(mask.sum()) > slots) == (others == [20, 20, 20])
    for rep in reps[1:]:
        torch.testing.assert_close(rep, reps[0], rtol=1e-6, atol=1e-6)


def test_the_counters_add_up():
    model = program(weights(), held=(0, 4))
    lens = [7, 40, 1, 23]
    ids, mask = batch(lens, width=40)
    enc = model.encoder_q
    with enc.recording_routes() as log, torch.no_grad():
        model.encode_passage(ids, mask)
    real = mask.bool().reshape(-1)
    routed = torch.stack([t[real] for t in log])  # [MoE layers, T, k]
    stats = model.graph_stats
    assert stats["routed_slots"] == routed.numel() == 3 * 71 * 2
    assert stats["held_slots"] == int((routed < 4).sum())
    assert torch.equal(enc.held_slots, (routed < 4).sum((1, 2)))
    chunks = sum(-(-n // kda.CHUNK) for n in lens)
    assert stats["kda_chunks"] == chunks * 2 * 3  # heads x KDA layers
    enc.reset_expert_slots()
    assert model.graph_stats["held_slots"] == 0
    assert model.graph_stats["kda_chunks"] == 0


def test_spans_fire_on_eager_calls():
    model = program(weights())
    ids, mask = batch([4, 6, 1])
    profiling.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        model.encode_passage(ids, mask)
    names = [r.name for r in profiling.recorded()]
    assert names.count("kda.attention") == names.count("kda.chunk") == 3
    assert names.count("mla.attention") == 1
    assert names.count("moe.route") == names.count("moe.experts") == 3


# ---- conversion, construction, the config reader ----------------------------


def test_hf_conversion_stacks_and_keeps_the_held_experts():
    w = weights(held=(0, 8))
    sd = {f"model.{k}": v for k, v in w.items()}
    sd["lm_head.weight"] = torch.zeros(97, 64)
    cfg = kl.KimiLinearConfig(**dict(CFG.to_dict(), held_experts=(4, 4)))
    state = kl.state_from_hf(sd, cfg, torch.float32)
    I = CFG.moe_intermediate_size
    gu = state["layers.2.mlp.experts.gate_up_proj"]
    assert gu.shape == (4, 2 * I, 64)
    assert torch.equal(gu[1, :I], w["layers.2.mlp.experts.5.w1.weight"])
    assert torch.equal(gu[1, I:], w["layers.2.mlp.experts.5.w3.weight"])
    assert torch.equal(state["layers.1.mlp.experts.down_proj"][3],
                       w["layers.1.mlp.experts.7.w2.weight"])
    qkv = state["layers.0.self_attn.qkv_proj.weight"]
    assert torch.equal(qkv[32:64], w["layers.0.self_attn.k_proj.weight"])
    conv = state["layers.3.self_attn.conv_weight"]
    assert torch.equal(conv[64:], w["layers.3.self_attn.v_conv1d.weight"]
                       .squeeze(1))
    low = state["layers.1.self_attn.low_proj.weight"]
    assert torch.equal(low[32:], w["layers.1.self_attn.b_proj.weight"])
    assert torch.equal(state["layers.2.self_attn.q_proj.weight"],
                       w["layers.2.self_attn.q_proj.weight"])  # MLA
    assert "lm_head.weight" not in state
    del sd["model.layers.1.self_attn.v_conv1d.weight"]
    with pytest.raises(KeyError, match="conv_weight"):
        kl.state_from_hf(sd, cfg, torch.float32)


def test_build_save_and_load_round_trip(tmp_path):
    from openmatch_tpu_torch.config import ModelArguments

    w = weights(6)
    src = tmp_path / "hf"
    src.mkdir()
    (src / "config.json").write_text(json.dumps(
        {k: v for k, v in HF.items() if k != "dr"}))
    torch.save({f"model.{k}": v for k, v in w.items()},
               src / "pytorch_model.bin")
    args = ModelArguments(model_name_or_path=str(src), pooling="last",
                          normalize=True, dtype="float32")
    model = DRModel.build(args, device="cpu")
    assert model.backbone_type == "kimi_linear"
    ids, mask = batch([5, 19, 2], seed=7)
    with torch.no_grad(), exact_fp32():
        reps = model.encode_passage(ids, mask)
        torch.testing.assert_close(reps, ref.reps(w, bench_cfg(), ids, mask),
                                   **TOL)
    model.save(str(tmp_path / "ckpt"))
    back = DRModel.load(str(tmp_path / "ckpt"), device="cpu")
    assert back.encoder_config == CFG
    with torch.no_grad():
        assert torch.equal(back.encode_passage(ids, mask), reps)


def test_the_backbone_table():
    enc = make_encoder("kimi_linear", CFG, torch.float32)
    assert isinstance(enc, kl.KimiLinearEncoder)
    assert [layer.kda for layer in enc.layers] == [True, True, False, True]
    assert isinstance(enc.layers[2].self_attn, ds.MLAttention)
    assert not enc.layers[2].self_attn.rope
    assert config_from_dict("kimi_linear", json.loads(json.dumps(
        CFG.to_dict()))) == CFG
    assert (hidden_size(CFG), num_heads(CFG)) == (64, 4)
    published = kl.KimiLinearConfig()
    assert published.kda_layers == kl.KDA_LAYERS and published.held == (0, 256)


@pytest.mark.parametrize("key,value", [
    ("q_lora_rank", 1536), ("rope_scaling", {"type": "yarn"}),
    ("num_expert_group", 8), ("hidden_act", "gelu"),
    ("num_nextn_predict_layers", 1), ("mla_use_nope", False),
    ("moe_router_activation_func", "softmax")])
def test_unimplemented_settings_are_refused(key, value):
    with pytest.raises(ValueError, match=key):
        kl.kimi_linear_config_from_hf(dict(HF, **{key: value}))


def test_layer_lists_and_the_share_are_checked():
    with pytest.raises(ValueError, match="once each"):
        kl.kimi_linear_config_from_hf(dict(HF, linear_attn_config=dict(
            HF["linear_attn_config"], full_attn_layers=[3, 4])))
    with pytest.raises(ValueError, match="held_experts"):
        kl.KimiLinearConfig(**dict(CFG.to_dict(), held_experts=(6, 4)))


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: K13 is a CUDA kernel and CUDA "
                    "graphs have no CPU mode")
    return torch.device("cuda", 0)


# case -> (documents' lengths, slots, head width, decay scale): documents
# start off chunk boundaries; an empty one; slots past the last document
K13_CASES = {"ragged": ([5, 37, 0, 16, 1, 70], 160, 128, 1.0),
             "fast_decay": ([33, 50], 90, 128, 8.0),
             "long": ([1024, 300], 1400, 128, 1.0),
             "narrow_heads": ([9, 40, 3], 60, 16, 1.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K13_CASES))
def test_cuda_k13_matches_its_plain_version(cuda_device, case):
    lens, T, D, decay = K13_CASES[case]
    H = 4
    qkv, conv, g, beta, cu = k13_inputs(lens, T, H, D, decay=decay)
    qkv, conv = qkv.bfloat16().to(cuda_device), conv.bfloat16().to(
        cuda_device)
    g, beta, cu = g.to(cuda_device), beta.to(cuda_device), cu.to(cuda_device)
    before = _build.launches["kda_chunk"]
    got = kda.kda_chunk(qkv, conv, g, beta, cu, H)
    again = kda.kda_chunk(qkv, conv, g, beta, cu, H)
    assert _build.launches["kda_chunk"] == before + 2
    n = int(cu[-1])
    assert torch.equal(got[:n], again[:n])
    assert bool(torch.isfinite(got[:n]).all())
    want = kda.kda_chunk_plain(qkv.cpu(), conv.cpu(), g.cpu(), beta.cpu(),
                               cu.cpu(), H)[:n]
    # bf16 outputs of fp32 sums taken in another order
    torch.testing.assert_close(got[:n].float().cpu(), want.float(),
                               rtol=2e-2, atol=2e-3)


@pytest.mark.cuda
def test_cuda_graph_equals_eager(cuda_device):
    model = program({k: v.to(cuda_device) for k, v in weights().items()},
                    held=(0, 4), dtype=torch.bfloat16, device=cuda_device)
    with torch.inference_mode():
        for seed in range(3):
            ids, mask = batch([12, 3, 9, 1], width=16, seed=seed)
            ids, mask = ids.to(cuda_device), mask.to(cuda_device)
            got = model.encode(ids, mask)
            want = model.encode_eager(ids, mask)
            assert torch.equal(got, want), (got - want).abs().max()
    stats = model.graph_stats
    assert (stats["captures"], stats["replays"], stats["eager"]) == (1, 3, 0)
    # 3 MoE layers x 2 slots x 25 tokens a forward: the capture's warm
    # run, 3 replays and 3 eager calls
    assert stats["routed_slots"] == 7 * 3 * 2 * 25


@pytest.mark.cuda
def test_cuda_a_document_is_bit_equal_in_any_batch(cuda_device):
    """A document's rep and expert choices are the same bits beside short
    or long neighbours, in either half of an overflowing batch, by a
    graph replay or eagerly."""
    model = program({k: v.to(cuda_device) for k, v in weights().items()},
                    held=(0, 4), dtype=torch.bfloat16, device=cuda_device)
    B, S, L = 8, 48, 37
    g = np.random.default_rng(11)
    doc = torch.from_numpy(g.integers(1, 97, L))
    slots = ds.packed_slots(B, S)
    layouts = {"short_neighbours": (1, [3] * (B - 1)),
               "long_neighbours": (5, [(slots - L) // (B - 1)] * (B - 1)),
               "overflow_second_half": (6, [S * 3 // 4] * (B - 1)),
               "overflow_first_half": (0, [S * 3 // 4] * (B - 1))}
    seen = {}
    with torch.inference_mode():
        for name, (row, others) in layouts.items():
            lens = others[:row] + [L] + others[row:]
            ids, mask = batch(lens, width=S, seed=row)
            ids[row, :L] = doc
            ids, mask = ids.to(cuda_device), mask.to(cuda_device)
            assert (int(mask.sum()) > slots) == name.startswith("overflow")
            rep = model.encode(ids, mask)[row]
            with model.encoder_q.recording_routes() as log:
                eager = model.encode_eager(ids, mask)[row]
            routes = torch.stack([t.view(B, S, -1)[row, :L] for t in log])
            seen[name] = (rep, eager, routes)
    rep0, _, routes0 = seen["short_neighbours"]
    for name, (rep, eager, routes) in seen.items():
        assert torch.equal(rep, rep0), (name, (rep - rep0).abs().max())
        assert torch.equal(eager, rep0), (name, "eager")
        assert torch.equal(routes, routes0), name


def parent_moe_forward(self, x, pack, slots):
    """``deepseek_v3.MoE.forward`` before the held-experts share, kept
    word for word to hold Moonlight's path to its bits."""
    cfg = self.cfg
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    real = pack.real
    ids, weights = self.gate(x, real)
    if self.routes is not None:
        self.routes.append(torch.cat((ids, ids.new_full(
            (1, k), E))).index_select(0, pack.slot.reshape(-1)))
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(E + 1, dtype=torch.int64,
                         device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    slots.add_(counts[:E])
    offsets = F.pad(torch.cumsum(counts[:E], 0), (1, 0)).to(torch.int32)
    rows = x.index_select(0, order // k)
    gate, up = ds.grouped_gemm(rows, self.experts.gate_up_proj,
                               offsets).chunk(2, -1)
    out = ds.grouped_gemm(F.silu(gate) * up, self.experts.down_proj,
                          offsets)
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=x.device))
    out = out.index_select(0, inverse).view(x.shape[0], k, -1)
    routed = torch.bmm(weights[:, None, :], out.float()).squeeze(1)
    routed = routed.masked_fill(~real[:, None], 0.0).to(x.dtype)
    return routed + self.shared_experts(x)


@pytest.mark.cuda
def test_cuda_moonlight_keeps_its_bits(cuda_device, monkeypatch):
    """At Moonlight's widths on 3 layers, every expert held: the reps and
    routes are the bits of the MoE layer before the share."""
    from benchmark.lm_weights import Drawn

    path = os.path.join(os.path.dirname(__file__), os.pardir, "benchmark",
                        "configs", "moonlight-16b-a3b.json")
    with open(path) as f:
        hf = dict(json.load(f), num_hidden_layers=3)
    with torch.device(cuda_device):
        model = DRModel(ds.deepseek_v3_config_from_hf(hf),
                        backbone_type="deepseek_v3", pooling="last",
                        normalize=True, dtype=torch.bfloat16)
    dest = model.encoder_q.state_dict()
    drawn = Drawn(hf, 7, cuda_device, torch.bfloat16)
    for name in drawn:
        ds.load_hf_tensor(dest, name, drawn[name])
    model.eval()
    B, S = 64, 512
    g = np.random.default_rng(5)
    lens = g.integers(32, 400, B)
    ids = torch.full((B, S), 163839, dtype=torch.long)
    mask = torch.zeros_like(ids)
    for i, n in enumerate(lens):
        ids[i, :n] = torch.from_numpy(g.integers(0, 163584, n))
        mask[i, :n] = 1
    ids, mask = ids.to(cuda_device), mask.to(cuda_device)
    out = {}
    for name in ("share", "parent"):
        if name == "parent":
            monkeypatch.setattr(ds.MoE, "forward", parent_moe_forward)
        with torch.inference_mode(), \
                model.encoder_q.recording_routes() as log:
            out[name] = (model.encode_eager(ids, mask), torch.stack(log))
    assert torch.equal(out["share"][0], out["parent"][0])
    assert torch.equal(out["share"][1], out["parent"][1])
