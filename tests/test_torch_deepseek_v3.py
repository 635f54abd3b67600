"""The ``deepseek_v3`` backbone (``models/deepseek_v3.py``) and its grouped
expert GEMM (``ops/grouped_gemm.py``) on the CPU at a tiny size: against
the benchmark's plain float32 reference (``benchmark/reference``), the
reference against ``transformers``' ``DeepseekV3Model``, the routing and
its counter, ``last`` pooling, the HuggingFace conversion and the
checkpoint round trip. The card's cases skip without one.

Tiny configuration: hidden 64, one dense and two MoE layers of 8 experts
(top 2, one shared), latent 16, 4 heads of 16 + 8 query/key dims and 16
value dims. Weights are the benchmark's seeded draws, by HF name."""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.lm_weights import Drawn
from benchmark.reference import deepseek_v3 as ref
from benchmark.reference.quant import exact_fp32
from openmatch_tpu_torch.models import deepseek_v3 as ds
from openmatch_tpu_torch.models import pooling
from openmatch_tpu_torch.models.bert import BertConfig
from openmatch_tpu_torch.models.dr_model import (DRModel, config_from_dict,
                                                 hidden_size, make_encoder,
                                                 num_heads)
from openmatch_tpu_torch.models.t5 import T5Config
from openmatch_tpu_torch.ops.grouped_gemm import (grouped_gemm,
                                                  grouped_gemm_plain)
from openmatch_tpu_torch.utils import profiling

HF = {"model_type": "deepseek_v3", "vocab_size": 97, "hidden_size": 64,
      "intermediate_size": 96, "moe_intermediate_size": 32,
      "num_hidden_layers": 3, "num_attention_heads": 4,
      "num_key_value_heads": 4, "n_routed_experts": 8, "n_shared_experts": 1,
      "num_experts_per_tok": 2, "first_k_dense_replace": 1,
      "kv_lora_rank": 16, "q_lora_rank": None, "qk_nope_head_dim": 16,
      "qk_rope_head_dim": 8, "v_head_dim": 16, "rms_norm_eps": 1e-5,
      "rope_theta": 50000.0, "routed_scaling_factor": 2.446,
      "norm_topk_prob": True, "n_group": 1, "topk_group": 1,
      "scoring_func": "sigmoid", "topk_method": "noaux_tc",
      "hidden_act": "silu", "attention_bias": False, "moe_layer_freq": 1,
      "max_position_embeddings": 64, "pad_token_id": 0,
      "initializer_range": 0.1, "e_score_correction_bias_std": 0.05,
      "dr": {"normalize": True}}
CFG = ds.deepseek_v3_config_from_hf(HF)
# fp32 on both sides; the sums run in other orders (slot order against
# expert order, complex against real RoPE), so they differ by rounding
TOL = dict(rtol=1e-5, atol=1e-5)


def weights(seed=3):
    drawn = Drawn(HF, seed, "cpu", torch.float32)
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


def program(w, dtype=torch.float32, device="cpu", **kw):
    with torch.device(device):
        model = DRModel(CFG, backbone_type="deepseek_v3", pooling="last",
                        normalize=True, dtype=dtype, **kw)
    dest = model.encoder_q.state_dict()
    for name, t in w.items():
        ds.load_hf_tensor(dest, name, t)
    return model.eval()


# ---- the port against the plain reference ----------------------------------


@pytest.mark.parametrize("lens", [[7, 12, 1, 12], [5, 3, 9]])
def test_port_matches_the_reference(lens):
    w = weights()
    ids, mask = batch(lens, width=14)
    model = program(w)
    with torch.no_grad(), exact_fp32():
        got = model.encode_passage(ids, mask)
        want = ref.reps(w, HF, ids, mask)
    torch.testing.assert_close(got, want, **TOL)


def test_port_hidden_states_match_at_real_positions():
    w = weights(4)
    ids, mask = batch([9, 4, 6], width=10, seed=1)
    model = program(w)
    with torch.no_grad():
        got = model.encoder_q(ids, mask)["last_hidden_state"]
        want = ref.hidden_states(w, HF, ids, mask)
    real = mask.bool()
    torch.testing.assert_close(got[real], want[real], **TOL)


def test_reference_matches_transformers(monkeypatch):
    """The reference against ``transformers.DeepseekV3Model`` (eager
    attention, interleaved RoPE) on the same HF-named weights, at the real
    positions: the pad rule changes only pad positions."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    if not hasattr(transformers, "DeepseekV3Model"):
        pytest.skip("transformers has no DeepseekV3Model")
    keys = {k: v for k, v in HF.items()
            if k not in ("model_type", "dr", "e_score_correction_bias_std",
                         "initializer_range")}
    cfg = transformers.DeepseekV3Config(rope_interleave=True, **keys)
    cfg._attn_implementation = "eager"
    model = transformers.DeepseekV3Model(cfg).eval()
    w = weights(5)
    missing, unexpected = model.load_state_dict(w, strict=False)
    assert not unexpected and all("rotary" in k for k in missing)
    ids, mask = batch([11, 6, 2, 9], width=11, seed=2)
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask).last_hidden_state
        got = ref.hidden_states(w, HF, ids, mask)
    real = mask.bool()
    torch.testing.assert_close(got[real], want[real], rtol=1e-4, atol=1e-5)


def test_the_fp8_control_is_coarser_than_rounding():
    w = weights()
    ids, mask = batch([12, 8, 10], seed=3)
    with torch.no_grad():
        want = ref.reps(w, HF, ids, mask)
        ctrl = ref.reps(w, HF, ids, mask, precision="fp8")
    gap = float((ctrl - want).norm(dim=1).max())
    assert 1e-3 < gap < 0.5


# ---- the grouped GEMM's plain version ------------------------------------


@pytest.mark.parametrize("counts", [[3, 0, 5, 1], [0, 0, 9, 0], [2, 2, 2, 2]])
def test_grouped_gemm_plain_matches_per_expert_linear(counts):
    g = torch.Generator().manual_seed(sum(counts))
    E, K, N = len(counts), 16, 24
    M = sum(counts) + 3  # three unrouted rows after the experts'
    x = torch.randn(M, K, generator=g)
    w = torch.randn(E, N, K, generator=g)
    offsets = torch.tensor([0] + list(np.cumsum(counts)), dtype=torch.int32)
    got = grouped_gemm(x, w, offsets)
    assert grouped_gemm.launches == 0  # the CPU takes the plain version
    for e in range(E):
        lo, hi = int(offsets[e]), int(offsets[e + 1])
        torch.testing.assert_close(got[lo:hi], F.linear(x[lo:hi], w[e]))
    torch.testing.assert_close(grouped_gemm_plain(x, w, offsets)[:M - 3],
                               got[:M - 3])


def test_grouped_gemm_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="must be"):
        grouped_gemm(torch.zeros(4, 8), torch.zeros(2, 8, 6),
                     torch.zeros(3, dtype=torch.int32))


# ---- routing and its counter ---------------------------------------------


def test_the_bias_selects_and_does_not_weight():
    router = ds.Router(CFG)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        router.weight.normal_(0, 0.3, generator=g)
        router.e_score_correction_bias.zero_()
        router.e_score_correction_bias[5] = 10.0  # always chosen
    x = torch.randn(6, 64, generator=g)
    real = torch.tensor([True, True, False, True, True, True])
    ids, wts = router(x, real)
    scores = torch.sigmoid(x @ router.weight.T)
    assert (ids[real] == 5).any(dim=1).all()
    assert (ids[~real] == CFG.n_routed_experts).all()  # the sentinel
    for t in real.nonzero().flatten().tolist():
        s = scores[t, ids[t]]
        torch.testing.assert_close(wts[t], s / (s.sum() + 1e-20) * 2.446)
        torch.testing.assert_close(wts[t].sum(), torch.tensor(2.446))
    want_ids, want_w = ref.route(x, router.weight, router.e_score_correction_bias,
                                 HF)
    assert torch.equal(ids[real], want_ids[real])
    torch.testing.assert_close(wts[real], want_w[real])


def test_pads_are_not_routed_and_the_counter_is_exact():
    w = weights()
    ids, mask = batch([7, 3, 10, 0], width=10, seed=4)
    model = program(w)
    enc = model.encoder_q
    seen = []
    for layer in enc.layers[1:]:
        layer.mlp.gate.register_forward_hook(
            lambda mod, inp, out: seen.append(out[0]))
    with torch.no_grad():
        model.encode_passage(ids, mask)
        model.encode_passage(ids, mask)
    real = mask.bool().reshape(-1)
    for j, routed in enumerate(seen[:2]):
        assert (routed[~real] == CFG.n_routed_experts).all()
        want = torch.bincount(routed[real].reshape(-1),
                              minlength=CFG.n_routed_experts)
        assert torch.equal(enc.expert_slots[j], 2 * want)
    assert int(enc.expert_slots.sum()) == 2 * 2 * 2 * int(mask.sum())
    enc.reset_expert_slots()
    assert int(enc.expert_slots.sum()) == 0


def test_recorded_routes_are_the_routers_and_the_reference_takes_them():
    """``recording_routes`` yields each MoE layer's ids, pads at the
    sentinel; the reference routed along the real positions' ids gives
    its own reps, with no shortfall, and a wrong choice shows as one."""
    w = weights()
    ids, mask = batch([7, 3, 10], width=10, seed=6)
    model = program(w)
    enc = model.encoder_q
    seen = []
    for layer in enc.layers[1:]:
        layer.mlp.gate.register_forward_hook(
            lambda mod, inp, out: seen.append(out[0]))
    with torch.no_grad(), enc.recording_routes() as log:
        model.encode_eager(ids, mask)
    assert len(log) == 2 and all(torch.equal(a, b)
                                 for a, b in zip(log, seen))
    assert all(layer.mlp.routes is None for layer in enc.layers[1:])
    real = mask.bool().reshape(-1)
    assert (log[0][~real] == CFG.n_routed_experts).all()
    with torch.no_grad(), exact_fp32():
        along = ref.Routes([t[real] for t in log])
        torch.testing.assert_close(ref.reps(w, HF, ids, mask, routes=along),
                                   ref.reps(w, HF, ids, mask), **TOL)
        assert along.shortfall == 0.0
        wrong = [t[real].clone() for t in log]
        wrong[1][0] = wrong[1][0].flip(0)  # the same experts: no shortfall
        wrong[0][1, 1] = wrong[0][1, 0]  # an expert named twice
        bad = ref.Routes(wrong)
        ref.reps(w, HF, ids, mask, routes=bad)
        assert bad.shortfall == float("inf")


def test_pad_positions_do_not_move_the_reps():
    w = weights()
    ids, mask = batch([6, 9], width=9, seed=5)
    wide = torch.cat([ids, torch.full((2, 7), 3)], 1)
    wide_mask = torch.cat([mask, torch.zeros(2, 7, dtype=mask.dtype)], 1)
    model = program(w)
    with torch.no_grad():
        torch.testing.assert_close(model.encode_passage(wide, wide_mask),
                                   model.encode_passage(ids, mask), **TOL)


def test_spans_fire_on_eager_calls():
    model = program(weights())
    ids, mask = batch([4, 6])
    profiling.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        model.encode_passage(ids, mask)
    names = [r.name for r in profiling.recorded()]
    assert names.count("mla.attention") == 3
    assert names.count("moe.route") == names.count("moe.experts") == 2


# ---- last pooling ---------------------------------------------------------


def test_last_pooling_takes_each_rows_last_real_position():
    hidden = torch.arange(4 * 5 * 2, dtype=torch.float32).view(4, 5, 2)
    mask = torch.tensor([[1, 1, 1, 0, 0], [1, 0, 0, 0, 0],
                         [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]])
    got = pooling.pool_hidden(hidden, mask, "last")
    assert torch.equal(got, hidden[[0, 1, 2, 3], [2, 0, 4, 0]])


# ---- conversion, construction, checkpoints --------------------------------


def test_hf_conversion_stacks_experts_and_drops_the_lm_head():
    w = weights()
    sd = {f"model.{k}": v for k, v in w.items()}
    sd["lm_head.weight"] = torch.zeros(97, 64)
    state = ds.state_from_hf(sd, CFG, torch.float32)
    I = CFG.moe_intermediate_size
    gu = state["layers.2.mlp.experts.gate_up_proj"]
    assert gu.shape == (8, 2 * I, 64)
    assert torch.equal(gu[3, :I], w["layers.2.mlp.experts.3.gate_proj.weight"])
    assert torch.equal(gu[3, I:], w["layers.2.mlp.experts.3.up_proj.weight"])
    assert torch.equal(state["layers.2.mlp.experts.down_proj"][7],
                       w["layers.2.mlp.experts.7.down_proj.weight"])
    dense = state["layers.0.mlp.gate_up_proj.weight"]
    assert torch.equal(dense[96:], w["layers.0.mlp.up_proj.weight"])
    assert "lm_head.weight" not in state
    del sd["model.layers.1.mlp.experts.4.up_proj.weight"]
    with pytest.raises(KeyError, match="experts.gate_up_proj"):
        ds.state_from_hf(sd, CFG, torch.float32)


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
    assert model.backbone_type == "deepseek_v3"
    ids, mask = batch([5, 8, 2], seed=7)
    with torch.no_grad():
        reps = model.encode_passage(ids, mask)
        torch.testing.assert_close(reps, ref.reps(w, HF, ids, mask), **TOL)
    model.save(str(tmp_path / "ckpt"))
    assert os.path.exists(tmp_path / "ckpt" / "model.pt")
    assert not os.path.exists(tmp_path / "ckpt" / "params.msgpack")
    back = DRModel.load(str(tmp_path / "ckpt"), device="cpu")
    assert back.encoder_config == CFG and back.pooling == "last"
    with torch.no_grad():
        assert torch.equal(back.encode_passage(ids, mask), reps)


def write_safetensors(path, tensors):
    """A ``.safetensors`` file of fp32 ``tensors``: an 8-byte header length,
    the JSON header, then the bytes."""
    header, blobs, at = {}, [], 0
    for name, t in tensors.items():
        raw = t.contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [at, at + len(raw)]}
        blobs.append(raw)
        at += len(raw)
    text = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little") + text + b"".join(blobs))


def test_a_sharded_safetensors_directory_loads(tmp_path):
    w = {f"model.{k}": v for k, v in weights(8).items()}
    names = sorted(w)
    shards = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    for file, part in shards.items():
        write_safetensors(tmp_path / file, {n: w[n] for n in part})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {n: f for f, part in shards.items() for n in part}}))
    (tmp_path / "config.json").write_text(json.dumps(
        {k: v for k, v in HF.items() if k != "dr"}))
    assert ds.is_deepseek_v3(str(tmp_path))
    cfg, state = ds.load_deepseek_v3(str(tmp_path), torch.float32)
    want = ds.state_from_hf(w, CFG, torch.float32)
    assert cfg == CFG and state.keys() == want.keys()
    assert all(torch.equal(state[k], want[k]) for k in want)


def test_weights_are_held_in_the_compute_dtype():
    model = program(weights(), dtype=torch.bfloat16)
    enc = model.encoder_q
    assert enc.layers[1].mlp.experts.gate_up_proj.dtype == torch.bfloat16
    assert enc.embed_tokens.weight.dtype == torch.bfloat16
    assert enc.layers[1].mlp.gate.weight.dtype == torch.float32
    ids, mask = batch([4, 7])
    with torch.no_grad():
        assert model.encode_passage(ids, mask).dtype == torch.bfloat16


def test_the_backbone_table():
    assert isinstance(make_encoder("deepseek_v3", CFG, torch.float32),
                      ds.DeepseekV3Encoder)
    with pytest.raises(TypeError, match="DeepseekV3Config"):
        make_encoder("deepseek_v3", BertConfig(), torch.float32)
    with pytest.raises(TypeError, match="T5Config"):
        make_encoder("t5", CFG, torch.float32)
    assert config_from_dict("deepseek_v3", CFG.to_dict()) == CFG
    assert (hidden_size(CFG), num_heads(CFG)) == (64, 4)
    assert (hidden_size(T5Config()), num_heads(BertConfig())) == (768, 12)
    with pytest.raises(ValueError, match="Unknown backbone"):
        make_encoder("llama", CFG, torch.float32)


def test_unimplemented_settings_are_refused():
    with pytest.raises(ValueError, match="q_lora_rank"):
        ds.deepseek_v3_config_from_hf(dict(HF, q_lora_rank=1536))
    with pytest.raises(ValueError, match="n_group"):
        ds.deepseek_v3_config_from_hf(dict(HF, n_group=8, topk_group=4))


def test_the_trainer_refuses_the_backbone():
    from openmatch_tpu_torch.config import TrainingArguments
    from openmatch_tpu_torch.train.dr_trainer import DRTrainer

    with pytest.raises(ValueError, match="does not train"):
        DRTrainer(program(weights()), TrainingArguments(), total_steps=1,
                  device="cpu")


# ---- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the grouped GEMM is a CUDA kernel "
                    "and CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


# case -> (rows per expert, unrouted rows after them, N, K, whether the
# unrouted rows are NaN). The kernel's tile is 128 rows by 256 columns where
# N % 256 == 0, else by 64; its depth chunk is 64.
KERNEL_CASES = {
    # N = 384 takes the narrow tile; empty experts between full ones
    "ragged": ([0, 300, 1, 0, 129, 64, 0, 700], 50, 384, 256, False),
    # the wide tile; empty experts first and last, one of 129 rows
    "wide": ([0, 129, 300, 1, 0], 7, 512, 256, False),
    # N and K that no tile or chunk divides
    "ragged_n_and_k": ([5, 0, 250, 129, 0], 3, 200, 200, False),
    # one expert owns every row: 71 x 4 work tiles, several a block
    "one_expert": ([0, 0, 9000, 0], 0, 1024, 128, False),
    # the last tile reads unrouted NaN rows and must not store them
    "nan_unrouted": ([0, 200, 129, 0, 64, 0], 100, 512, 192, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_cuda_kernel_matches_its_plain_version(cuda_device, case):
    counts, unrouted, N, K, nan = KERNEL_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    E, real = len(counts), sum(counts)
    x = torch.randn(real + unrouted, K, generator=g,
                    device=cuda_device).bfloat16()
    if nan:
        x[real:] = float("nan")
    w = torch.randn(E, N, K, generator=g, device=cuda_device).bfloat16()
    offsets = torch.tensor([0] + list(np.cumsum(counts)), dtype=torch.int32,
                           device=cuda_device)
    before = grouped_gemm.launches
    got = grouped_gemm(x, w, offsets)[:real]
    again = grouped_gemm(x, w, offsets)[:real]
    assert grouped_gemm.launches == before + 2
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)  # each element summed in a fixed order
    want = grouped_gemm_plain(x.cpu(), w.cpu(), offsets.cpu())[:real]
    # one bf16 rounding of fp32 sums taken in another order
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=1e-2,
                               atol=1e-2)


@pytest.mark.cuda
def test_cuda_graph_equals_eager(cuda_device):
    model = program({k: v.to(cuda_device) for k, v in weights().items()},
                    dtype=torch.bfloat16, device=cuda_device)
    with torch.inference_mode():
        for seed in range(3):
            ids, mask = batch([12, 3, 9, 1], width=16, seed=seed)
            ids, mask = ids.to(cuda_device), mask.to(cuda_device)
            got = model.encode(ids, mask)
            want = model.encode_eager(ids, mask)
            assert torch.equal(got, want), (got - want).abs().max()
    assert model.graph_stats == {"captures": 1, "replays": 3, "eager": 0}
