"""Checkpoints between the packages, with the port's own flax-msgpack codec
(``models/flax_msgpack.py``) and HuggingFace reader (``models/hf_convert.py``):

- the codec's bytes equal ``flax.serialization.to_bytes``'s for trees of
  fp32, bf16, int and scalar leaves (also chunked leaves), flax reads them,
  and the codec reads flax's: exact;
- the port's ``DRModel.save`` loads in the JAX ``DRModel.load`` and encodes
  the same (max abs diff <= 2e-4, the parity standard of
  ``test_torch_bert.py``), and writes the bytes JAX writes for the same
  weights; save and load need no ``msgpack`` package;
- a tiny HF BERT, RoBERTa and ELECTRA, saved as ``pytorch_model.bin`` and
  as ``model.safetensors``, build in the port as in JAX (same encodings,
  2e-4), the safetensors case with no ``safetensors`` package.
"""

import json
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from openmatch_tpu.config import ModelArguments as JaxModelArguments
from openmatch_tpu.models.bert import BertConfig as JaxBertConfig
from openmatch_tpu.models.dr_model import DRModel as JaxDRModel
from openmatch_tpu_torch.config import ModelArguments
from openmatch_tpu_torch.models import flax_msgpack
from openmatch_tpu_torch.models.bert import BertConfig
from openmatch_tpu_torch.models.dr_model import DRModel
from openmatch_tpu_torch.models.jax_convert import params_from_jax

torch.set_num_threads(2)
ATOL = 2e-4
SMALL = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=40)


def leaf_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layer": {"kernel": rng.standard_normal((5, 3), dtype=np.float32),
                  "bias": rng.standard_normal(3, dtype=np.float32)},
        "bf16": rng.standard_normal((4, 2)).astype(ml_dtypes.bfloat16),
        "ids": rng.integers(-5, 2**40, size=6, dtype=np.int64),
        "small": np.arange(3, dtype=np.int32),
        "scalar": np.float32(2.5),
        "step": 300, "neg": -70000, "lr": 1e-3, "flag": True, "none": None,
        "name": "x" * 40,
        "long": rng.standard_normal(200, dtype=np.float32),
        "wide": {str(i): i for i in range(20)},
    }


def assert_tree_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert_tree_equal(got[k], v)
        elif isinstance(v, (np.ndarray, np.generic)):
            np.testing.assert_array_equal(np.asarray(got[k], np.float64),
                                          np.asarray(v, np.float64))
            assert np.shape(got[k]) == np.shape(v)
        else:
            assert got[k] == v and type(got[k]) is type(v)


@pytest.mark.parametrize("chunk", [None, 64])
def test_codec_matches_flax(monkeypatch, chunk):
    if chunk is not None:  # split every leaf over 64 bytes into chunks
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    tree = leaf_tree()
    flax_bytes = serialization.to_bytes(tree)
    if chunk is not None:
        assert b"__msgpack_chunked_array__" in flax_bytes
    mine = flax_msgpack.to_bytes(tree)
    assert mine == flax_bytes
    assert_tree_equal(serialization.msgpack_restore(mine), tree)
    got = flax_msgpack.msgpack_restore(flax_bytes)
    assert got["bf16"].dtype == np.float32  # bf16 widened exactly
    assert_tree_equal(got, tree)


def test_codec_rejects_trailing_and_unknown_bytes():
    with pytest.raises(ValueError, match="extra data"):
        flax_msgpack.unpackb(flax_msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="0xc1"):
        flax_msgpack.unpackb(b"\xc1")
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(b"\xa5ab")


def jax_model_and_params(seed, **kw):
    jm = JaxDRModel(encoder_config=JaxBertConfig(**SMALL), dtype=jnp.float32,
                    **kw)
    params = jm.init_params(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32)
                          + 0.05 * rng.randn(*x.shape).astype(np.float32),
                          params)
    return jm, params


def batch(seed=5, B=4, S=9, vocab=128):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, vocab, size=(B, S)).astype(np.int32)
    mask = (np.arange(S)[None] < np.array([[S], [5], [2], [7]][:B])
            ).astype(np.int32)
    return ids, mask


def port_encode(model, ids, mask, is_query):
    with torch.inference_mode():
        return model.encode(torch.from_numpy(ids), torch.from_numpy(mask),
                            is_query=is_query).float().numpy()


MODELS = {
    "tied": dict(),
    "untied_head_mean": dict(tied=False, has_head=True, head_in_dim=64,
                             head_out_dim=16, pooling="mean"),
    "normalize": dict(normalize=True),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_save_loads_in_jax(tmp_path, monkeypatch, name):
    jm, params = jax_model_and_params(3, **MODELS[name])
    port = DRModel(BertConfig(**SMALL), **{k: v for k, v in
                                           MODELS[name].items()})
    port.load_state_dict(params_from_jax(params), strict=True)
    monkeypatch.setitem(sys.modules, "msgpack", None)  # no package import
    port.save(str(tmp_path / "port"))
    reloaded = DRModel.load(str(tmp_path / "port"), device="cpu")
    monkeypatch.delitem(sys.modules, "msgpack")
    jm.save(params, str(tmp_path / "jax"))
    # the same weights give the same file in both packages
    assert (tmp_path / "port" / "params.msgpack").read_bytes() \
        == (tmp_path / "jax" / "params.msgpack").read_bytes()
    assert json.loads((tmp_path / "port" / "openmatch_config.json")
                      .read_text()) == json.loads(
        (tmp_path / "jax" / "openmatch_config.json").read_text())
    jl, jparams = JaxDRModel.load(str(tmp_path / "port"))
    ids, mask = batch()
    for is_query in (True, False):
        want = np.asarray(jl.encode(jparams, jnp.asarray(ids),
                                    jnp.asarray(mask), is_query=is_query))
        np.testing.assert_allclose(port_encode(port, ids, mask, is_query),
                                   want, atol=ATOL, rtol=0)
        np.testing.assert_array_equal(
            port_encode(reloaded, ids, mask, is_query),
            port_encode(port, ids, mask, is_query))


def hf_model(kind):
    import transformers as tf

    common = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128,
                  max_position_embeddings=40)
    torch.manual_seed(11)
    if kind == "bert":
        return tf.BertModel(tf.BertConfig(**common))
    if kind == "roberta":
        return tf.RobertaModel(tf.RobertaConfig(pad_token_id=1, **common),
                               add_pooling_layer=False)
    return tf.ElectraModel(tf.ElectraConfig(embedding_size=32, **common))


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
@pytest.mark.parametrize("kind", ["bert", "roberta", "electra"])
def test_hf_checkpoint_builds_as_in_jax(tmp_path, monkeypatch, kind, fmt):
    hf_dir = tmp_path / kind
    hf_model(kind).save_pretrained(str(hf_dir),
                                   safe_serialization=fmt == "safetensors")
    assert (hf_dir / ("model.safetensors" if fmt == "safetensors"
                      else "pytorch_model.bin")).exists()
    flags = dict(model_name_or_path=str(hf_dir), dtype="float32",
                 untie_encoder=kind == "roberta",
                 pooling="mean" if kind == "electra" else "first",
                 normalize=kind == "bert")
    jm, jparams = JaxDRModel.build(JaxModelArguments(**flags))
    monkeypatch.setitem(sys.modules, "safetensors", None)
    pm = DRModel.build(ModelArguments(**flags), device="cpu")
    assert pm.encoder_config.to_dict() == jm.encoder_config.to_dict()
    assert pm.tied == jm.tied and pm.pooling == jm.pooling
    ids, mask = batch(7)
    if kind == "roberta":  # RoBERTa pads with 1
        ids = np.where(mask > 0, ids, 1).astype(np.int32)
    for is_query in (True, False):
        want = np.asarray(jm.encode(jparams, jnp.asarray(ids),
                                    jnp.asarray(mask), is_query=is_query))
        np.testing.assert_allclose(port_encode(pm, ids, mask, is_query),
                                   want, atol=ATOL, rtol=0)


def test_hf_build_head_is_seeded_and_shared(tmp_path):
    hf_model("bert").save_pretrained(str(tmp_path), safe_serialization=False)
    args = ModelArguments(model_name_or_path=str(tmp_path), dtype="float32",
                          add_linear_head=True, untie_encoder=True,
                          projection_in_dim=64, projection_out_dim=32)
    a = DRModel.build(args, device="cpu")
    b = DRModel.build(args, device="cpu")
    wa = a.head_q.linear.weight
    assert wa.shape == (32, 64)
    assert torch.equal(wa, b.head_q.linear.weight)
    assert torch.equal(wa, a.head_p.linear.weight)
    # flax's lecun_normal: truncated at 2 std, std sqrt(1 / fan_in)
    assert wa.abs().max() <= 2 * (1 / 64) ** 0.5 / 0.87962566103423978
    assert torch.equal(a.encoder_q.word_embeddings.weight,
                       a.encoder_p.word_embeddings.weight)


def test_t5_checkpoint_still_refused(tmp_path):
    """A T5 / GTR directory is no longer refused: it builds the full-T5
    model (``tests/test_torch_t5.py`` holds its reps to JAX's), and one
    without weights fails on the missing files."""
    import transformers as tf

    d = tmp_path / "gtr-base"
    d.mkdir()
    with pytest.raises(FileNotFoundError):
        DRModel.build(ModelArguments(model_name_or_path=str(d)), device="cpu")
    tf.T5ForConditionalGeneration(tf.T5Config(
        vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=1,
        num_heads=4)).save_pretrained(str(d))
    model = DRModel.build(ModelArguments(model_name_or_path=str(d)),
                          device="cpu")
    assert model.backbone_type == "t5_encdec" and model.out_dim == 32
