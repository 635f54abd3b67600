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
  ``successive_retrieve``, ``evaluate``, ``retrieve_beir`` and the HTTP
  ``serve``.
- ``ance``: the hard-negative refresh, alternating and generator.
- ``perf``: twins of the JAX package's perf scripts
  (``scripts/perf/score_path_phases.py``, ``scripts/perf/micro.py``,
  ``scripts/perf/ance_cycle.py``).
- ``scripts``: twins of the data tools under ``scripts/`` (MS MARCO and
  NQ train shards, hard-negative shards, embedding splits).

``config``, ``templates``, ``data``, ``ance.loop``, ``utils.trec`` and
``utils.metrics`` are the port's own copies of the JAX package's jax-free
modules: the port imports nothing of ``openmatch_tpu``.
"""

__version__ = "0.1.0"

from .device import resolve_device, resolve_dtype  # noqa: F401,E402
