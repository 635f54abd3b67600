"""The PyTorch port imports no JAX and nothing of the JAX package: in a fresh
interpreter where importing jax, flax, optax, ml_dtypes, msgpack,
transformers, safetensors or openmatch_tpu fails, every module of
openmatch_tpu_torch still imports (the port reads and writes flax-msgpack
checkpoints with its own codec and HF weights with its own reader)."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "msgpack",
           "transformers", "safetensors", "openmatch_tpu")
for name in BLOCKED:
    sys.modules[name] = None  # any import of these raises ImportError
import openmatch_tpu_torch
names = [m.name for m in pkgutil.walk_packages(openmatch_tpu_torch.__path__,
                                                "openmatch_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in BLOCKED
                and sys.modules[m] is not None)
assert not leaked, leaked
print(" ".join(names))
print(len(names))
"""

# the slices' modules the walk must reach, named so that a package left
# without its __init__ cannot drop them from the count unseen
MUST_IMPORT = (
    "data.beir", "data.preprocessor", "ance", "ance.loop",
    "drivers.retrieve_beir", "perf.ance_cycle",
    "scripts.msmarco.build_train", "scripts.msmarco.build_hn",
    "scripts.nq_dpr.build_train", "scripts.split_embeddings",
    "v1.models", "v1.kernel_matcher", "train.v1_trainer", "drivers.train_v1",
    "drivers.inference_v1", "drivers.gen_feature", "bm25.engine",
    "drivers.bm25_retrieve", "letor.coor_ascent", "drivers.coor_ascent",
    "research.qg", "research.mlm", "research.meta_ltr",
    "research.reinfoselect", "train.meta_trainer",
    "train.reinfoselect_trainer", "drivers.qg_synthesis",
    "drivers.train_mlm", "drivers.meta_train",
    "scripts.gtr.convert_gtr_ckpt", "scripts.scale_t5_weights",
    "parallel.mesh", "parallel.tp", "parallel.grad_cache",
    "train.dr_trainer", "train.rr_trainer", "retriever.retriever",
    "retriever.reranker", "drivers.train_dr", "drivers.train_rr",
    "drivers.serve", "perf.sharded_merge", "perf.mesh_parity",
    "perf.serve_load",
)


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    # every module of the slices is covered, not just the package root
    *_, names, count = proc.stdout.strip().splitlines()
    assert int(count) >= 104
    assert {f"openmatch_tpu_torch.{m}" for m in MUST_IMPORT} \
        <= set(names.split())
