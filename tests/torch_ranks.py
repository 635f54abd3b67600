"""Rank bodies of the port's multi-rank CPU tests (``test_torch_mesh.py``,
``test_torch_tp.py``, ``test_torch_sharded_search.py``) and the inputs both
sides share.

``parallel.mesh.spawn_ranks`` starts each rank as a fresh process that
imports this module by name, so it imports torch, numpy and the port only:
a rank starts in seconds and never loads JAX. Every input is made from a
seed with numpy, here for the ranks and in the test's own process for the
JAX package, and the weights come from the test's process as state dicts
(``jax_convert.params_from_jax`` of a seeded Flax tree). A rank body takes
its device (the CPU: the ranks talk over gloo) and returns plain data;
``spawn_ranks`` hands back every rank's return value.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from openmatch_tpu_torch.config import (DataArguments, InferenceArguments,
                                        TrainingArguments)
from openmatch_tpu_torch.drivers import common
from openmatch_tpu_torch.models.dr_model import DRModel, config_from_dict
from openmatch_tpu_torch.models.rr_model import RRModel
from openmatch_tpu_torch.ops.mips import (TILE_ROWS, Searcher,
                                          query_sharded_search,
                                          shard_corpus, shard_rows_for,
                                          sharded_search)
from openmatch_tpu_torch.parallel.mesh import (all_gather_rows, make_mesh,
                                               shard_batch)
from openmatch_tpu_torch.retriever.reranker import Reranker
from openmatch_tpu_torch.retriever.retriever import Retriever
from openmatch_tpu_torch.train.dr_trainer import DRTrainer
from openmatch_tpu_torch.train.rr_trainer import RRTrainer

BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40)
T5 = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=64, num_layers=2,
          num_decoder_layers=2, num_heads=4,
          relative_attention_num_buckets=8,
          relative_attention_max_distance=20)
STEP_SEEDS = (7, 8)  # the first update has lr 0 (optax's count), the
# second moves the parameters
GC = dict(grad_cache=True, gc_q_chunk_size=1, gc_p_chunk_size=2)


def train_kw(**extra) -> dict:
    """TrainingArguments fields for both packages. adam_epsilon 1e-4: a
    gradient that is 0 but for float noise (the key bias's) would
    otherwise become a full +-lr step of random sign."""
    return dict(dict(learning_rate=1e-3, weight_decay=0.01, warmup_steps=0,
                     warmup_ratio=0.0, adam_epsilon=1e-4, seed=0,
                     per_device_train_batch_size=2, logging_steps=1,
                     save_steps=0), **extra)


def qp_batch(seed: int, n_q: int = 4, n_psg: int = 2, sq: int = 8,
             sp: int = 12) -> dict:
    """A global QPCollator batch: n_q queries, n_q * n_psg passages (each
    query's positive first), ragged lengths."""
    rng = np.random.RandomState(seed)

    def part(n, s):
        ids = rng.randint(5, 64, size=(n, s)).astype(np.int32)
        lengths = rng.randint(3, s + 1, size=n)
        mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
        return {"input_ids": ids * mask, "attention_mask": mask}

    return {"query": part(n_q, sq), "passage": part(n_q * n_psg, sp)}


def pair_batch(seed: int, n: int = 4, s: int = 12) -> dict:
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 64, size=(n, s)).astype(np.int32)
    lengths = rng.randint(4, s + 1, size=n)
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    segs = ((np.arange(s)[None] >= lengths[:, None] // 2) * mask).astype(
        np.int32)
    return {"input_ids": ids * mask, "attention_mask": mask,
            "token_type_ids": segs}


def rr_batch(seed: int) -> dict:
    return {"pos_pairs": pair_batch(seed), "neg_pairs": pair_batch(seed + 50)}


class IdTokenizer:
    """The tokenizer surface of pair encoding for texts given as id lists
    ([CLS]=2 a [SEP]=3 b [SEP]=3), picklable and the same in both
    packages."""

    pad_token_id = 0

    def num_special_tokens_to_add(self, pair=False):
        return 3 if pair else 2

    def build_inputs_with_special_tokens(self, a, b=None):
        return [2] + list(a) + [3] + ([] if b is None else list(b) + [3])

    def create_token_type_ids_from_sequences(self, a, b=None):
        return [0] * (len(a) + 2) + ([] if b is None else [1] * (len(b) + 1))


def rerank_inputs(n_q: int = 5, n_d: int = 7):
    """(queries, corpus, run) with id-list texts: 35 pairs, so batches of 8
    leave a padded remainder."""
    rng = np.random.RandomState(3)
    queries = {f"q{i}": {"text": rng.randint(5, 64, rng.randint(2, 6)).tolist()}
               for i in range(n_q)}
    corpus = {f"d{i}": {"text": rng.randint(5, 64, rng.randint(3, 12)).tolist()}
              for i in range(n_d)}
    run = {q: {d: float(rng.rand()) for d in corpus} for q in queries}
    return queries, corpus, run


RERANK_ARGS = dict(q_max_len=6, p_max_len=12, query_template="",
                   doc_template="")  # the texts are id lists


def seeded(jax, tree, seed: int):
    """Every leaf of a Flax tree drawn from a seed (the test's process
    passes its ``jax``): kernels ~ 1/sqrt(fan in), LayerNorm and RMSNorm
    scales near 1, biases, embeddings and position tables nonzero."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        x = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("['scale']") or name.endswith("['weight']"):
            return 1.0 + 0.1 * x
        if "kernel" in name:
            return x / np.sqrt(shape[0])
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, tree)


def _cpu(state: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in state.items()}


def port_dr(spec, state) -> DRModel:
    """spec: (backbone, encoder config dict, DRModel keywords)."""
    backbone, cfg, model_kw = spec
    model = DRModel(config_from_dict(backbone, cfg), backbone_type=backbone,
                    **model_kw)
    model.load_state_dict(state, strict=True)
    return model


def dr_steps(device, mesh, spec, state, args_kw, **extra):
    """``STEP_SEEDS`` steps of a DRTrainer over ``mesh``, each rank fed its
    rows of the global batch; (trainer, {"losses", "state"}) with the full
    parameters after the steps."""
    args = TrainingArguments(**train_kw(**args_kw, **extra))
    trainer = DRTrainer(port_dr(spec, state), args, total_steps=10,
                        device=device, mesh=mesh)
    losses = [float(trainer.train_step(shard_batch(qp_batch(s), mesh)))
              for s in STEP_SEEDS]
    return trainer, {"losses": losses, "state": _cpu(trainer.full_state())}


# ---- tests/test_torch_mesh.py: dp = 2 ----------------------------------------

DP_MODES = {
    "local": {},
    "x_device": dict(negatives_x_device=True),
    "x_device_dual": dict(negatives_x_device=True, dual_learning=True,
                          dual_weight=0.5),
    "gc_local": GC,
    "gc_x_device": dict(GC, negatives_x_device=True),
}


def dp2_world(device, inputs: dict) -> dict:
    """Everything test_torch_mesh.py holds to the JAX package, on 2 ranks:
    the mesh rules, shard_batch, all_gather_rows' gradient, DRTrainer in
    every mode, RRTrainer, Reranker(mesh=) and maybe_init_distributed (the
    initialised group, then torchrun's env:// rendezvous)."""
    torch.set_num_threads(1)
    out = {}
    mesh = make_mesh(2, 1, device)
    out["mesh"] = dict(shape=mesh.shape, rank=mesh.rank,
                       data_index=mesh.data_index, stage=mesh.stage)
    rows = np.arange(16, dtype=np.int32).reshape(16, 1)
    out["shard_rows"] = shard_batch({"x": rows}, mesh)["x"]
    x = torch.arange(6.0).reshape(3, 2).add(10 * mesh.rank).requires_grad_()
    y = all_gather_rows(x, mesh)
    weights = torch.arange(12.0).reshape(6, 2)
    (y * weights).sum().backward()
    out["gather"] = (y.detach().numpy(), x.grad.numpy())

    spec, state = inputs["dr"]
    out["dr"] = {name: dr_steps(device, mesh, spec, state, kw)[1]
                 for name, kw in DP_MODES.items()}

    rr_cfg, rr_state = inputs["rr"]
    rr = RRModel(config_from_dict("bert", rr_cfg), backbone_type="bert",
                 head_in_dim=rr_cfg["hidden_size"])
    rr.load_state_dict(rr_state, strict=True)
    trainer = RRTrainer(rr, TrainingArguments(**train_kw()), total_steps=10,
                        device=device, mesh=mesh)
    losses = [float(trainer.train_step(shard_batch(rr_batch(s), mesh)))
              for s in STEP_SEEDS]
    out["rr"] = {"losses": losses, "state": _cpu(trainer.full_state())}

    rr.load_state_dict(rr_state, strict=True)
    reranker = Reranker(rr.eval(), IdTokenizer(),
                        DataArguments(**RERANK_ARGS),
                        InferenceArguments(per_device_eval_batch_size=4),
                        mesh=mesh)
    out["rerank"] = (reranker.batch_size,
                     reranker.rerank(*rerank_inputs()))

    out["init"] = common.maybe_init_distributed(device)
    # then as torchrun starts a rank: its agent serves the env:// store on
    # MASTER_PORT and every rank joins it as a client. Rank 0 plays the
    # agent; its store binds a free port and holds it, so no other process
    # can take the port before the ranks connect.
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False) if mesh.rank == 0 else None
    port = [store.port if store is not None else None]
    dist.broadcast_object_list(port, src=0)
    dist.destroy_process_group()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port[0]),
                      TORCHELASTIC_USE_AGENT_STORE="True")
    out["env_init"] = (common.maybe_init_distributed(device),
                       dist.get_backend())
    dist.barrier()  # both ranks joined before rank 0's store goes
    dist.destroy_process_group()
    return out


# ---- tests/test_torch_tp.py: tp = 2, and dp = 2 x tp = 2 ---------------------

TP_MODES = {"x_device": dict(negatives_x_device=True),
            "gc_x_device": dict(GC, negatives_x_device=True)}


def tp_world(device, inputs: dict) -> dict:
    """The tensor-parallel trainers of test_torch_tp.py over every rank as
    dp = world / 2 x tp = 2: BERT and T5 in both modes, each rank's slice
    shapes, and (tp = 2 alone) a checkpoint that JAX loads plus a resume
    that continues bit for bit."""
    torch.set_num_threads(1)
    world = dist.get_world_size()
    mesh = make_mesh(world // 2, 2, device)
    out = {"rank": mesh.rank}
    for backbone, (spec, state) in inputs["models"].items():
        for name, kw in TP_MODES.items():
            trainer, res = dr_steps(device, mesh, spec, state, kw)
            res["local_shapes"] = {k: tuple(v.shape) for k, v in
                                   trainer.model.state_dict().items()}
            out[f"{backbone}/{name}"] = res
    if world == 2:
        spec, state = inputs["models"]["bert"]
        root = inputs["root"]
        kw = dict(negatives_x_device=True, output_dir=root)
        trainer, _ = dr_steps(device, mesh, spec, state, kw)
        trainer.save_checkpoint()
        trainer.save_model(os.path.join(root, "model"))
        resumed = DRTrainer(port_dr(spec, state),
                            TrainingArguments(**train_kw(**kw)),
                            total_steps=10, device=device, mesh=mesh)
        resumed.maybe_resume()
        same = all(torch.equal(a, b) for a, b in zip(
            trainer.full_state().values(), resumed.full_state().values()))
        batch = shard_batch(qp_batch(9), mesh)
        trainer.train_step(batch)
        resumed.train_step(batch)
        out["resume"] = (same, resumed.step, all(
            torch.equal(a, b) for a, b in zip(
                trainer.full_state().values(),
                resumed.full_state().values())))
    return out


def dryrun_world(device, inputs: dict) -> dict:
    """The JAX package's ``dryrun_multichip(4)`` over 4 gloo ranks: a
    global-negatives step and a GradCache step on dp = 4, a tensor-parallel
    step on dp = 2 x tp = 2, the mesh Searcher's kernel path in both
    partitions and segmented (exact under all-negative scores and zero
    padding), and data-parallel reranking."""
    torch.set_num_threads(1)
    out = {}
    spec, state = inputs["dr"]
    mesh = make_mesh(4, 1, device)
    _, res = dr_steps(device, mesh, spec, state,
                      dict(negatives_x_device=True, learning_rate=1e-4))
    out["train_loss"] = res["losses"][0]
    _, res = dr_steps(device, mesh, spec, state, dict(GC,
                                                      learning_rate=1e-4))
    out["gc_loss"] = res["losses"][0]
    mesh_tp = make_mesh(2, 2, device)
    trainer, res = dr_steps(device, mesh_tp, spec, state,
                            dict(negatives_x_device=True,
                                 learning_rate=1e-4))
    out["tp_loss"] = res["losses"][0]
    out["tp_shape"] = tuple(
        trainer.model.encoder_q.layers[0].intermediate.weight.shape)

    rng = np.random.RandomState(0)
    k, n = 9, 2048 * 4 + 5
    corpus = torch.from_numpy(np.abs(rng.randn(n, 128)).astype(np.float32))
    queries = torch.from_numpy(-np.abs(rng.randn(8, 128)).astype(np.float32))
    searches = {}
    for part, segs in (("queries", 1), ("docs", 1), ("queries", 2)):
        s = Searcher(corpus, k=k, mesh=mesh, method="kernel",
                     partition=part, n_segs=segs)
        scores, ids = s.search(queries)
        searches[s.last_dispatch] = ids.numpy()
    out["search"] = searches

    rr_cfg, rr_state = inputs["rr"]
    rr = RRModel(config_from_dict("bert", rr_cfg), backbone_type="bert",
                 head_in_dim=rr_cfg["hidden_size"])
    rr.load_state_dict(rr_state, strict=True)
    reranker = Reranker(rr.eval(), IdTokenizer(),
                        DataArguments(**RERANK_ARGS),
                        InferenceArguments(per_device_eval_batch_size=2),
                        mesh=mesh)
    out["rerank"] = (reranker.batch_size,
                     reranker.rerank(*rerank_inputs()))
    return out


# ---- tests/test_torch_sharded_search.py: 2 ranks -----------------------------


def search_cases():
    """{name: (queries, corpus, k)}: numpy inputs of the mesh searches."""
    rng = np.random.RandomState(0)
    cases = {"basic": (rng.randn(7, 16), rng.randn(1000, 16), 10),
             # 2 shards of 20 rows, k above a shard's rows
             "k_above_shard": (rng.randn(3, 8), rng.randn(40, 8), 30),
             "padded": (rng.randn(3, 8), rng.randn(1001, 8), 7)}
    # every true score negative: zero pad rows would score 0
    cases["negative"] = (-np.abs(rng.randn(3, 8)),
                         np.abs(rng.randn(1001, 8)), 7)
    # kernel shapes: a ragged tail, shards of 4096 rows (2 tiles of 2048;
    # the second holds 5 valid rows), all scores negative
    cases["kernel_negative"] = (-np.abs(rng.randn(16, 128)),
                                np.abs(rng.randn(4101, 128)), 9)
    seg = rng.randn(4100, 64)
    seg[4098] += 9.0  # the top doc in the ragged tail
    cases["segmented"] = (rng.randn(7, 64), seg, 10)
    # well separated, so bf16 rounding cannot reorder the winners
    sep = 0.01 * rng.randn(2048, 64)
    sep[100:103] += 8.0
    cases["bf16"] = (np.abs(rng.randn(8, 64)), sep, 3)
    return {name: (q.astype(np.float32), c.astype(np.float32), k)
            for name, (q, c, k) in cases.items()}


def search_world(device, inputs: dict) -> dict:
    """Every mesh search path of test_torch_sharded_search.py on 2 ranks:
    (scores, ids, last_dispatch) by case, method and partition."""
    torch.set_num_threads(1)
    mesh = make_mesh(2, 1, device)
    out = {}
    cases = search_cases()

    def run(name, s, q):
        scores, ids = s.search(torch.from_numpy(q))
        out[name] = (scores.float().numpy(), ids.numpy(), s.last_dispatch)

    for case in ("basic", "k_above_shard", "padded", "negative"):
        q, c, k = cases[case]
        for part in ("docs", "queries"):
            run(f"{case}/plain/{part}",
                Searcher(c, k=k, mesh=mesh, method="plain", partition=part),
                q)
    q, c, k = cases["k_above_shard"]
    run("k_above_shard/kernel/docs",
        Searcher(c, k=k, mesh=mesh, method="kernel"), q)
    q, c, k = cases["kernel_negative"]
    for part in ("docs", "queries"):
        run(f"kernel_negative/kernel/{part}",
            Searcher(c, k=k, mesh=mesh, method="kernel", partition=part), q)
    # the docs partition reads only this rank's rows of a host index: the
    # other rank's rows are NaN here, and the answer stays exact
    rows = shard_rows_for(c.shape[0], 2, TILE_ROWS)
    lo = mesh.data_index * rows
    own = np.full_like(c, np.nan)
    own[lo:lo + rows] = c[lo:lo + rows]
    run("kernel_negative/sharded_corpus",
        Searcher(own, k=k, mesh=mesh, method="kernel"), q)
    q, c, k = cases["segmented"]
    seg = Searcher(c, k=k, mesh=mesh, method="kernel", partition="queries",
                   n_segs=2)
    out["segmented/n_segs"] = len(seg._prep.plain)
    run("segmented/kernel/queries", seg, q)
    q, c, k = cases["bf16"]
    host = torch.from_numpy(c).to(torch.bfloat16)
    for method in ("plain", "kernel"):
        for part in ("docs", "queries"):
            run(f"bf16/{method}/{part}",
                Searcher(host, k=k, mesh=mesh, method=method,
                         partition=part), q)
    q, c, k = cases["basic"]
    shard = shard_corpus(c, mesh)
    s, i = sharded_search(torch.from_numpy(q), shard, k, mesh, n_valid=1000)
    out["basic/sharded_search"] = (s.numpy(), i.numpy(), None)
    q8 = np.concatenate([q, q[:1]])
    s, i = query_sharded_search(torch.from_numpy(q8), torch.from_numpy(c),
                                k, mesh)
    out["basic/query_sharded_search"] = (s.numpy(), i.numpy(), None)

    # the Retriever hands its index to a mesh Searcher from the host
    spec, state = inputs["dr"]
    emb = cases["segmented"][1]
    for part in ("docs", "queries"):
        retriever = Retriever(port_dr(spec, state), DataArguments(),
                              InferenceArguments(search_partition=part),
                              pad_token_id=0, device=device, mesh=mesh)
        retriever.doc_embeddings = emb
        retriever.doc_ids = [f"d{i}" for i in range(len(emb))]
        out[f"retriever/{part}"] = retriever.search(
            cases["segmented"][0], [f"q{i}" for i in range(7)], topk=10)
    return out


def world4(device, inputs: dict) -> dict:
    """test_torch_tp.py's 4-rank world: dp = 2 x tp = 2, then the dryrun."""
    return {"tp": tp_world(device, inputs),
            "dryrun": dryrun_world(device, inputs)}


def maybe_init_rank(device):
    """``maybe_init_distributed`` inside a 2-rank gloo group."""
    return common.maybe_init_distributed(device)


def failing_rank(device):
    """Rank 1 raises while rank 0 waits in a collective for it."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def hanging_rank(device):
    """Rank 0 sleeps past the caller's deadline."""
    import time

    if dist.get_rank() == 0:
        time.sleep(60)


# ---- tests/test_torch_serve_mesh.py: serving over 2 ranks --------------------

SERVE_VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "about",
                "document", "query"] + [f"topic{i}" for i in range(8)])
SERVE_BERT = dict(vocab_size=32, hidden_size=16, num_hidden_layers=1,
                  num_attention_heads=2, intermediate_size=32,
                  max_position_embeddings=16)
# name -> (partition, method, n_segs, corpus): "topics" is JAX's
# test_serve.py construction (8 docs), "wide" the topics plus 4,092 seeded
# unit rows, enough for the kernel path's tiles and 2 segments
SERVE_CASES = {
    "queries/plain": ("queries", "plain", 1, "topics"),
    "docs/plain": ("docs", "plain", 1, "topics"),
    "docs/kernel": ("docs", "kernel", 1, "wide"),
    "queries/kernel_segs": ("queries", "kernel", 2, "wide"),
}
SERVE_QUERIES = ([f"document about topic{i}" for i in (1, 5)],
                 [f"document about topic{i}" for i in range(7)]
                 + ["query about topic2 topic6"])


class VocabTokenizer:
    """``BertTokenizerFast.encode_plus`` for texts of whole vocabulary
    words ([CLS] words [SEP], truncated to ``max_length``), picklable and
    the same in both packages' services."""

    pad_token_id = 0

    def __init__(self, vocab=SERVE_VOCAB):
        self.ids = {w: i for i, w in enumerate(vocab)}

    def encode_plus(self, text, max_length=None, **_):
        ids = [self.ids.get(w, 1) for w in text.split()]
        if max_length is not None:
            ids = ids[:max_length - 2]
        return {"input_ids": [2] + ids + [3]}


def serve_model(state):
    return port_dr(("bert", SERVE_BERT, dict(normalize=True)), state).eval()


def serve_world(device, inputs: dict) -> dict:
    """Every SERVE_CASES case over 2 ranks, as serve.main runs them: rank
    0 a RetrievalService over the mesh Searcher (warmup, the two query
    sets, close), rank 1 ``follow``; rank 0's answers, rank 1's search
    count."""
    from openmatch_tpu_torch.drivers.serve import RetrievalService, follow
    from openmatch_tpu_torch.parallel.mesh import ControlChannel

    torch.set_num_threads(1)
    mesh = make_mesh(2, 1, device)
    model = serve_model(inputs["state"])
    out = {}
    for name, (part, method, n_segs, corpus) in SERVE_CASES.items():
        reps, ids = inputs[corpus]
        searcher = Searcher(torch.from_numpy(reps), k=4, mesh=mesh,
                            method=method, partition=part, n_segs=n_segs)
        channel = ControlChannel(mesh, searcher.dim, searcher.dtype)
        if mesh.rank:
            out[name] = follow(searcher, channel)
            continue
        service = RetrievalService(model, VocabTokenizer(), searcher, ids,
                                   q_max_len=8, max_batch=4, channel=channel)
        service.warmup()
        out[name] = [service.search(q, k=3) for q in SERVE_QUERIES]
        service.close()
    return out


def serve_process(rank: int, world: int, tmp: str, argv: list,
                  timeout_s: float = 600.0, keepalive_s: float = 60.0,
                  die_on_search: int = 0):
    """One rank of ``serve.main`` started as torchrun starts one (its own
    process), joined through a ``file://`` rendezvous in ``tmp``, with the
    groups' timeout and rank 0's keep-alive shortened to ``timeout_s`` and
    ``keepalive_s``. ``die_on_search`` > 0: a rank other than 0 exits at
    its search of that number (the first is rank 0's warmup)."""
    from openmatch_tpu_torch.drivers import serve
    from openmatch_tpu_torch.parallel import mesh as mesh_mod

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    mesh_mod.TIMEOUT_S, mesh_mod.KEEPALIVE_S = timeout_s, keepalive_s
    mesh_mod.init_distributed(torch.device("cpu"),
                              "file://" + os.path.join(tmp, "rendezvous"),
                              timeout_s)
    if die_on_search and rank:
        real, calls = Searcher.search, [0]

        def search(self, queries):
            calls[0] += 1
            if calls[0] == die_on_search:
                os._exit(3)
            return real(self, queries)

        Searcher.search = search
    serve.main(argv, tokenizer=VocabTokenizer())
    dist.destroy_process_group()


# ---- tests/test_torch_v1_mesh.py: the v1 family at dp = 2 ---------------------

V1_V, V1_E, V1_KD = 40, 16, 8  # KNRM / Conv-KNRM vocabulary and widths


# the policy's Adam has optax's epsilon 1e-8, so an entry whose gradient is
# rounding noise moves by up to the lr: a small lr keeps that below 1e-5
RIS_KW = dict(learning_rate=1e-3)


def v1_kw(**extra) -> dict:
    """TrainingArguments fields of the v1-family audits, both packages."""
    return train_kw(**dict(dict(learning_rate=5e-2, logging_steps=100),
                           **extra))


def v1_models(task: str = "ranking", policy: bool = False):
    from openmatch_tpu_torch.v1.models import KNRM, ConvKNRM

    if policy:
        return ConvKNRM(V1_V, V1_E, kernel_dim=V1_KD, task="classification")
    return KNRM(V1_V, V1_E, task=task)


def v1_world(device, inputs: dict) -> dict:
    """Everything test_torch_v1_mesh.py holds to the JAX package, on 2
    ranks: V1Trainer (KNRM ranking and classification), MetaLTRTrainer and
    ReInfoSelectTrainer steps on global batches (each rank trains on its
    rows), then the train_v1 and meta_train drivers."""
    from openmatch_tpu_torch.drivers import meta_train, train_v1
    from openmatch_tpu_torch.train.meta_trainer import MetaLTRTrainer
    from openmatch_tpu_torch.train.reinfoselect_trainer import \
        ReInfoSelectTrainer
    from openmatch_tpu_torch.train.v1_trainer import V1Trainer

    torch.set_num_threads(1)
    mesh = make_mesh(2, 1, device)
    out = {}
    for task in ("ranking", "classification"):
        state, batches = inputs["v1"][task]
        model = v1_models(task)
        model.load_state_dict(state)
        trainer = V1Trainer(model, TrainingArguments(**v1_kw()), 10,
                            task=task, device=device, mesh=mesh)
        out[f"v1/{task}"] = {
            "losses": [float(trainer.train_step(b)) for b in batches],
            "state": _cpu(model.state_dict())}

    state, pairs, kw = inputs["meta"]
    model = v1_models()
    model.load_state_dict(state)
    trainer = MetaLTRTrainer(model, TrainingArguments(**kw), 6,
                             device=device, mesh=mesh)
    steps = [trainer.train_step(b, t) for b, t in pairs]
    out["meta"] = {"losses": [float(x) for x, _ in steps],
                   "weights": [w.numpy() for _, w in steps],
                   "state": _cpu(model.state_dict())}

    state, policy_state, steps, rewards = inputs["reinfoselect"]
    model, policy = v1_models(), v1_models(policy=True)
    model.load_state_dict(state)
    policy.load_state_dict(policy_state)
    trainer = ReInfoSelectTrainer(model, policy,
                                  TrainingArguments(**v1_kw(**RIS_KW)), 10,
                                  device=device, mesh=mesh)
    res = {"losses": [], "actions": []}
    for (batch, noise, action_noise), reward in zip(steps, rewards):
        loss, actions = trainer.train_step(batch, noise=noise,
                                           action_noise=action_noise)
        res["losses"].append(float(loss))
        res["actions"].append(actions.numpy())
        if reward is not None:
            trainer.refresh_policy(reward)
    res["state"] = _cpu(model.state_dict())
    res["policy"] = _cpu(policy.state_dict())
    res["counts"] = (trainer.step,
                     trainer.optimizer.param_groups[0]["count"])
    out["reinfoselect"] = res

    for name, argv in inputs["drivers"].items():
        main = meta_train.main if name == "meta_train" else train_v1.main
        result = main(argv)
        out[f"driver/{name}"] = {k: v for k, v in result.items()
                                 if k != "weights"}
    return out
