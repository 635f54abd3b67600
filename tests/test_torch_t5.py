"""The port's T5 stack against the JAX package's on the same weights.

Weights are numpy-seeded Flax trees carried into the port with
``jax_convert``, or a tiny HF ``T5ForConditionalGeneration`` saved here
(the tiny configs of ``tests/test_t5_parity.py``). Both feed-forward kinds
are covered: ``relu`` with a tied lm_head and ``gated-gelu`` with an
untied one. Tolerances: fp32 within 1e-5 x max|JAX|, bf16 within 2e-2 x
max|JAX bf16|; the relative position buckets exactly.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmatch_tpu.config import ModelArguments as JaxModelArguments
from openmatch_tpu.models import t5 as jt5
from openmatch_tpu.models.dr_model import DRModel as JaxDRModel
from openmatch_tpu_torch.config import ModelArguments
from openmatch_tpu_torch.models import t5
from openmatch_tpu_torch.models.dr_model import DRModel
from openmatch_tpu_torch.models.jax_convert import (params_from_jax,
                                                    params_to_jax)

torch.set_num_threads(2)

TINY = dict(vocab_size=120, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_decoder_layers=2, num_heads=4,
            relative_attention_num_buckets=8,
            relative_attention_max_distance=20)
KINDS = {"relu_tied": dict(feed_forward_proj="relu",
                           tie_word_embeddings=True),
         "gated_untied": dict(feed_forward_proj="gated-gelu",
                              tie_word_embeddings=False)}
FP32_REL, BF16_REL = 1e-5, 2e-2


def configs(kind):
    return (jt5.T5Config(**TINY, **KINDS[kind]),
            t5.T5Config(**TINY, **KINDS[kind]))


def seeded_tree(tree, seed):
    """Every leaf of a Flax tree replaced by a seeded draw of its shape:
    norms near 1, tables and embeddings N(0, 1), kernels N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        x = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("['weight']"):
            x = 1.0 + 0.2 * x
        elif "kernel" in name:
            x = x / np.sqrt(shape[0])
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def inputs(seed=0, b=3, s=11):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 120, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 7:] = 0
    mask[2, 4:] = 0
    return ids * mask, mask


def jax_and_port(kind, module, dtype="float32", seed=1):
    jcfg, pcfg = configs(kind)
    jmod = getattr(jt5, module)(jcfg, dtype=getattr(jnp, dtype))
    ids, mask = inputs()
    tree = seeded_tree(jax.tree.map(np.asarray, jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))["params"]),
        seed)
    port = getattr(t5, module)(pcfg, dtype=getattr(torch, dtype))
    port.load_state_dict(params_from_jax(tree), strict=True)
    return jmod, tree, port.eval()


def run_both(jmod, tree, port, ids, mask):
    want = jmod.apply({"params": tree}, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    return ({k: np.asarray(v, np.float32) for k, v in want.items()},
            {k: v.float().numpy() for k, v in got.items()})


def assert_close(got, want, rel, what, valid=None):
    if valid is not None:  # rows of a padded sequence: only real tokens
        got, want = got[valid], want[valid]
    tol = rel * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max|diff| {err} > {tol}"


# ---- buckets ---------------------------------------------------------------

SETTINGS = {"t5-base": (32, 128), "tiny": (8, 20)}


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_bucket_tables_equal_jax(setting, bidirectional):
    nb, md = SETTINGS[setting]
    pos = np.arange(512)
    rel = pos[None, :] - pos[:, None]
    want = np.asarray(jt5.relative_position_bucket(
        jnp.asarray(rel), bidirectional, nb, md))
    for S in range(1, 513):
        got = t5._bucket_table(S, S, bidirectional, nb, md,
                               torch.device("cpu")).numpy()
        np.testing.assert_array_equal(got, want[:S, :S], err_msg=f"S={S}")
    for S in (1, 2, 7, 128, 129, 511):  # JAX's own table at that length
        r = pos[None, :S] - pos[:S, None]
        np.testing.assert_array_equal(
            t5._bucket_table(S, S, bidirectional, nb, md,
                             torch.device("cpu")).numpy(),
            np.asarray(jt5.relative_position_bucket(jnp.asarray(r),
                                                    bidirectional, nb, md)))


# ---- modules, fp32 and bf16 ------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_encoder_matches_jax(kind):
    jmod, tree, port = jax_and_port(kind, "T5Encoder")
    ids, mask = inputs()
    want, got = run_both(jmod, tree, port, ids, mask)
    assert_close(got["last_hidden_state"], want["last_hidden_state"],
                 FP32_REL, "last_hidden_state", mask > 0)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_encoder_decoder_step_matches_jax(kind):
    jmod, tree, port = jax_and_port(kind, "T5EncoderDecoderStep")
    ids, mask = inputs()
    want, got = run_both(jmod, tree, port, ids, mask)
    assert got["logits"].shape == (3, 1, 120)
    for key in ("decoder_hidden", "logits"):
        assert_close(got[key], want[key], FP32_REL, key)
    assert_close(got["last_hidden_state"], want["last_hidden_state"],
                 FP32_REL, "last_hidden_state", mask > 0)


@pytest.mark.parametrize("module", ["T5Encoder", "T5EncoderDecoderStep"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bf16_matches_jax_bf16(kind, module):
    jmod, tree, port = jax_and_port(kind, module, dtype="bfloat16")
    ids, mask = inputs(3)
    want, got = run_both(jmod, tree, port, ids, mask)
    for key in want:
        valid = mask > 0 if key == "last_hidden_state" else None
        assert_close(got[key], want[key], BF16_REL, key, valid)
    with torch.no_grad():
        out = port(torch.from_numpy(ids), torch.from_numpy(mask))
    assert all(v.dtype == torch.bfloat16 for v in out.values())


@pytest.mark.parametrize("module", ["T5Encoder", "T5EncoderDecoderStep"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bf16_error_is_the_reference_semantics(kind, module):
    """The port's bf16 misses its fp32 by no more than 1.5x what JAX's bf16
    misses JAX's fp32 by, on the same weights: bf16 T5 loses a few
    percent of max|output| in the reference's own semantics (a bf16
    residual stream, bf16 logits), so a bf16-vs-fp32 tolerance must allow
    that much."""
    key = "logits" if module == "T5EncoderDecoderStep" else \
        "last_hidden_state"
    ids, mask = inputs(11)
    valid = mask > 0 if key == "last_hidden_state" else slice(None)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jmod, tree, port = jax_and_port(kind, module, dtype=dtype)
        want, got = run_both(jmod, tree, port, ids, mask)
        out[dtype] = (want[key][valid], got[key][valid])
    scale = np.abs(out["float32"][0]).max()
    jax_err = np.abs(out["bfloat16"][0] - out["float32"][0]).max() / scale
    port_err = np.abs(out["bfloat16"][1] - out["float32"][1]).max() / scale
    assert 0 < port_err <= 1.5 * jax_err, (port_err, jax_err)


def test_rmsnorm_casts_before_the_weight():
    """bf16: normalise in fp32, cast, then multiply by the bf16 weight."""
    norm = t5.RMSNorm(16)
    with torch.no_grad():
        norm.weight.copy_(torch.linspace(0.5, 1.7, 16))
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(0)) * 3
    jnorm = jt5.RMSNorm(1e-6, dtype=jnp.bfloat16)
    want = jnorm.apply({"params": {"weight": jnp.asarray(norm.weight.detach().numpy())}},
                       jnp.asarray(x.numpy(), jnp.bfloat16))
    with torch.no_grad():
        got = norm(x.to(torch.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_dropout_draws_from_the_generator():
    port = t5.T5EncoderDecoderStep(
        t5.T5Config(**TINY, dropout_rate=0.3)).train()
    ids, mask = (torch.from_numpy(a) for a in inputs())

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return port(ids, mask, generator=g)["decoder_hidden"]

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    eval_out = port.eval()(ids, mask, generator=torch.Generator())
    assert torch.equal(eval_out["decoder_hidden"],
                       port(ids, mask)["decoder_hidden"])


# ---- HF checkpoints --------------------------------------------------------


def hf_t5(kind, path, fmt="safetensors"):
    from transformers import T5Config as HFT5Config
    from transformers import T5ForConditionalGeneration

    torch.manual_seed(0)
    cfg = HFT5Config(**TINY, decoder_start_token_id=0, **KINDS[kind])
    model = T5ForConditionalGeneration(cfg).eval()
    model.save_pretrained(str(path), safe_serialization=fmt == "safetensors")
    return cfg, model


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_hf_loader_matches_jax_convert(tmp_path, monkeypatch, kind, fmt):
    hf_cfg, hf = hf_t5(kind, tmp_path / "t5", fmt)
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    jcfg = jt5.T5Config.from_hf_config(hf_cfg)
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    pcfg, enc_state = t5.load_t5_encoder(str(tmp_path / "t5"))
    _, encdec_state = t5.load_t5_encdec(str(tmp_path / "t5"))
    assert pcfg.to_dict() == jcfg.to_dict()
    for got, want in (
            (enc_state, params_from_jax(
                jt5.convert_t5_encoder_state_dict(sd, jcfg))),
            (encdec_state, params_from_jax(
                jt5.convert_t5_encdec_state_dict(sd, jcfg)))):
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    # and the loaded step computes HF's decoder state and logits
    ids, mask = inputs()
    port = t5.T5EncoderDecoderStep(pcfg)
    port.load_state_dict(encdec_state, strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
        ref = hf(input_ids=torch.from_numpy(ids).long(),
                 attention_mask=torch.from_numpy(mask).long(),
                 decoder_input_ids=torch.zeros(3, 1, dtype=torch.long),
                 output_hidden_states=True)
    torch.testing.assert_close(out["logits"], ref.logits, rtol=0, atol=2e-4)


def test_shared_falls_back_to_the_encoder_copy():
    hf = {"encoder.embed_tokens.weight": torch.ones(120, 32)}
    assert torch.equal(t5._shared(hf), hf["encoder.embed_tokens.weight"])
    hf["shared.weight"] = torch.zeros(120, 32)
    assert torch.equal(t5._shared(hf), hf["shared.weight"])


# ---- DRModel ---------------------------------------------------------------

DR = {"encdec": dict(backbone_type="t5_encdec"),
      "encoder_first": dict(backbone_type="t5"),
      "encoder_mean_norm_untied": dict(backbone_type="t5", pooling="mean",
                                       normalize=True, tied=False),
      "encdec_head": dict(backbone_type="t5_encdec", has_head=True,
                          head_in_dim=32, head_out_dim=16)}


def jax_dr(name, kind="relu_tied", seed=2):
    jcfg, pcfg = configs(kind)
    jm = JaxDRModel(encoder_config=jcfg, **DR[name])
    params = seeded_tree(jax.tree.map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0))), seed)
    port = DRModel(pcfg, **DR[name])
    port.load_state_dict(params_from_jax(params), strict=True)
    return jm, params, port.eval()


def port_encode(model, ids, mask, is_query):
    with torch.no_grad():
        return model.encode(torch.from_numpy(ids), torch.from_numpy(mask),
                            is_query=is_query).float().numpy()


@pytest.mark.parametrize("name", sorted(DR))
def test_dr_model_reps_match_jax(name):
    jm, params, port = jax_dr(name)
    ids, mask = inputs(4)
    for is_query in (True, False):
        want = np.asarray(jm.encode(params, jnp.asarray(ids),
                                    jnp.asarray(mask), is_query=is_query))
        assert_close(port_encode(port, ids, mask, is_query), want, FP32_REL,
                     f"{name} reps")
    assert port.out_dim == want.shape[1]


@pytest.mark.parametrize("name", ["encdec", "encoder_mean_norm_untied"])
def test_t5_dr_checkpoints_cross_both_ways(tmp_path, monkeypatch, name):
    jm, params, port = jax_dr(name, kind="gated_untied")
    monkeypatch.setitem(sys.modules, "msgpack", None)
    port.save(str(tmp_path / "port"))
    reloaded = DRModel.load(str(tmp_path / "port"), device="cpu")
    monkeypatch.delitem(sys.modules, "msgpack")
    jm.save(params, str(tmp_path / "jax"))
    assert (tmp_path / "port" / "params.msgpack").read_bytes() \
        == (tmp_path / "jax" / "params.msgpack").read_bytes()
    assert json.loads((tmp_path / "port" / "openmatch_config.json")
                      .read_text()) == json.loads(
        (tmp_path / "jax" / "openmatch_config.json").read_text())
    jl, jparams = JaxDRModel.load(str(tmp_path / "port"))
    from_jax = DRModel.load(str(tmp_path / "jax"), device="cpu")
    ids, mask = inputs(5)
    for is_query in (True, False):
        want = np.asarray(jl.encode(jparams, jnp.asarray(ids),
                                    jnp.asarray(mask), is_query=is_query))
        assert_close(port_encode(reloaded, ids, mask, is_query), want,
                     FP32_REL, "port save -> JAX load")
        np.testing.assert_array_equal(
            port_encode(from_jax, ids, mask, is_query),
            port_encode(port, ids, mask, is_query))


@pytest.mark.parametrize("encoder_only", [False, True])
def test_dr_build_from_hf_t5_as_jax(tmp_path, encoder_only):
    hf_t5("gated_untied", tmp_path / "gtr-tiny")
    flags = dict(model_name_or_path=str(tmp_path / "gtr-tiny"),
                 dtype="float32", encoder_only=encoder_only, pooling="mean")
    jm, jparams = JaxDRModel.build(JaxModelArguments(**flags))
    pm = DRModel.build(ModelArguments(**flags), device="cpu")
    assert pm.backbone_type == jm.backbone_type == (
        "t5" if encoder_only else "t5_encdec")
    assert pm.encoder_config.to_dict() == jm.encoder_config.to_dict()
    ids, mask = inputs(6)
    want = np.asarray(jm.encode(jparams, jnp.asarray(ids), jnp.asarray(mask)))
    assert_close(port_encode(pm, ids, mask, False), want, FP32_REL,
                 "built reps")


def test_t5_trees_round_trip():
    _, params, port = jax_dr("encdec_head", kind="gated_untied")
    back = params_to_jax(port.state_dict(), TINY["num_heads"])
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    flat_want = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, params))
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (path, got), (_, want) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(got, want,
                                      err_msg=jax.tree_util.keystr(path))
