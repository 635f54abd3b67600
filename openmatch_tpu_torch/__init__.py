"""OpenMatch-TPU in PyTorch: dense-retrieval training and serving on CUDA.

A second package beside ``openmatch_tpu`` (the JAX reference), with the
same layout: ``openmatch_tpu/X/y.py`` has its counterpart at
``openmatch_tpu_torch/X/y.py``. It imports ``torch`` and never JAX.

- ``models``: BERT-family encoders and the bi-encoder ``DRModel``, the
  flax-msgpack checkpoint codec and the HuggingFace checkpoint reader.
- ``losses``, ``train``, ``parallel.grad_cache``: DR training on one
  device (optax's AdamW / LAMB chain, GradCache, checkpoints and resume).
- ``ops.mips`` / ``ops.cuda_mips``: exact MIPS, with hand-written CUDA
  kernels (``ops/csrc``) for the block-max pass and the gather-rescore.
- ``retriever``: encode to embedding shards, load them, search (resident
  or one shard at a time).
- ``drivers``: ``train_dr``, ``build_index``, ``retrieve``,
  ``successive_retrieve``, ``evaluate``, ``retrieve_beir``, the HTTP
  ``serve``, the v1 pipeline's ``bm25_retrieve``, ``train_v1``,
  ``inference_v1``, ``gen_feature`` and ``coor_ascent``, and the research
  drivers ``qg_synthesis``, ``train_mlm`` and ``meta_train``.
- ``ance``: the hard-negative refresh, alternating and generator.
- ``v1``: the v1 rerankers (KNRM, Conv-KNRM, TK, EDRM, BertRanker,
  BertMaxP) and their kernel matcher; ``train.v1_trainer`` trains them.
- ``bm25`` and ``letor``: the BM25 first stage over the native C++ index
  (``native/bm25``) and the Coor-Ascent / RankSVM ensembles.
- ``research``: T5 query generation and ContrastQG (``qg``, on
  ``models.t5.T5Seq2Seq``), MLM pretraining (``mlm``), Meta-LTR
  (``meta_ltr``) and ReInfoSelect (``reinfoselect``); their trainers are
  ``train.meta_trainer`` and ``train.reinfoselect_trainer``, their drivers
  ``qg_synthesis``, ``train_mlm``, ``meta_train`` and ``train_v1
  -reinfoselect``.
- ``perf``: twins of the JAX package's perf scripts
  (``scripts/perf/score_path_phases.py``, ``scripts/perf/micro.py``,
  ``scripts/perf/ance_cycle.py``).
- ``scripts``: twins of the tools under ``scripts/`` (MS MARCO and NQ
  train shards, hard-negative shards, embedding splits, the GTR converter
  and the T5 weight scaler).

``config``, ``templates``, ``data``, ``ance.loop``, ``utils.trec``,
``utils.metrics``, ``v1.tokenizer``, ``v1.dataset``, ``v1.long_doc``,
``bm25`` and ``letor`` are the port's own copies of the JAX package's
jax-free modules: the port imports nothing of ``openmatch_tpu``.
"""

__version__ = "0.1.0"

from .device import resolve_device, resolve_dtype  # noqa: F401,E402
