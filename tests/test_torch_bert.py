"""Port parity: the PyTorch BERT encoder and DRModel against the JAX package
on identical weights and inputs (fp32, CPU). Tolerance: max abs diff
<= 2e-4, the repo's parity standard (sums taken in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmatch_tpu.models.bert import BertConfig as JaxBertConfig
from openmatch_tpu.models.bert import BertEncoder as JaxBertEncoder
from openmatch_tpu.models.dr_model import DRModel as JaxDRModel
from openmatch_tpu_torch.models.bert import BertConfig, BertEncoder
from openmatch_tpu_torch.models.dr_model import DRModel
from openmatch_tpu_torch.models.jax_convert import params_from_jax

torch.set_num_threads(2)
ATOL = 2e-4

SMALL = dict(vocab_size=50, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=40)
CONFIGS = {
    "bert": dict(SMALL, add_pooler=True),
    "roberta": dict(SMALL, pad_token_id=1, position_offset=2),
    "electra": dict(SMALL, embedding_size=16),
}


def np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def inputs(seed=0, B=3, S=11, vocab=50, pad_id=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, vocab, size=(B, S)).astype(np.int32)
    lengths = np.array([S, 7, 3][:B])
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask > 0, ids, pad_id).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_matches_jax(name):
    kw = CONFIGS[name]
    jcfg = JaxBertConfig(**kw)
    enc = JaxBertEncoder(jcfg, dtype=jnp.float32)
    ids, mask = inputs(1, pad_id=kw.get("pad_token_id", 0))
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                      jnp.asarray(mask))["params"]
    # random LayerNorm affine and biases so every parameter matters
    rng = np.random.RandomState(2)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(np.float32),
        np_tree(params))
    want = enc.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask))

    port = BertEncoder(BertConfig(**kw), dtype=torch.float32)
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=0)
    assert set(got) == set(want)


@pytest.mark.parametrize("tied,pooling,head,normalize", [
    (True, "first", False, False),
    (True, "mean", True, True),
    (False, "first", True, False),
    (False, "mean", False, True),
])
def test_dr_model_encode_matches_jax(tied, pooling, head, normalize):
    jcfg = JaxBertConfig(**SMALL)
    jm = JaxDRModel(encoder_config=jcfg, tied=tied, pooling=pooling,
                    normalize=normalize, has_head=head, head_in_dim=32,
                    head_out_dim=24, dtype=jnp.float32)
    params = np_tree(jm.init_params(jax.random.PRNGKey(3)))
    pm = DRModel.from_config_dict(jm.config_dict(), torch.float32)
    pm.load_state_dict(params_from_jax(params), strict=True)
    ids, mask = inputs(4)
    for is_query in (True, False):
        want = np.asarray(jm.encode(params, jnp.asarray(ids),
                                    jnp.asarray(mask), is_query=is_query))
        with torch.inference_mode():
            got = pm.encode(torch.from_numpy(ids), torch.from_numpy(mask),
                            is_query=is_query).numpy()
        assert got.shape == want.shape == (3, 24 if head else 32)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_bf16_compute_keeps_fp32_params_and_finite_output():
    cfg = BertConfig(**SMALL)
    m = DRModel(cfg, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in m.parameters())
    ids, mask = inputs(5)
    with torch.inference_mode():
        reps = m.encode_query(torch.from_numpy(ids), torch.from_numpy(mask))
    assert reps.dtype == torch.bfloat16 and torch.isfinite(reps.float()).all()


def test_t5_backbone_not_ported_yet():
    """The T5 backbones are ported (tests/test_torch_t5.py); each needs a
    T5Config, and an unknown backbone is refused."""
    from openmatch_tpu_torch.models.t5 import T5Config

    for backbone in ("t5", "t5_encdec"):
        with pytest.raises(TypeError, match="T5Config"):
            DRModel(BertConfig(**SMALL), backbone_type=backbone)
        m = DRModel(T5Config(vocab_size=64, d_model=32, d_kv=8, d_ff=64,
                             num_layers=1, num_decoder_layers=1, num_heads=4),
                    backbone_type=backbone)
        assert m.out_dim == 32
    with pytest.raises(ValueError, match="Unknown backbone"):
        DRModel(BertConfig(**SMALL), backbone_type="gpt")
