"""Serving over ranks (``drivers/serve.py`` with ``parallel.mesh``'s
``ControlChannel``) against the JAX package's mesh service, on the CPU:

- ``RetrievalService`` over a 2-rank mesh ``Searcher`` (rank 0 serves,
  rank 1 runs ``follow``; ``spawn_ranks``, the bodies in
  ``tests/torch_ranks.py``) equals JAX's ``tests/test_serve.py``
  ``test_mesh_searcher_service_identity`` construction on the conftest's
  8-device mesh, and the port's one-process service, in both partitions
  and on the plain and kernel paths (the queries partition with 2
  segments): ids equal above the tie band, scores within rtol 1e-5 (atol
  1e-6: unit-norm reps, so the scores are cosines);
- ``serve.main`` over 2 ranks through its real flags, each rank its own
  process as ``torchrun`` starts them: ``/search`` over HTTP through rank
  0 with a follower, an idle period 2x longer than the groups' (shortened)
  collective timeout survived through keep-alives, and SIGTERM to rank 0
  ends both ranks with exit code 0;
- a follower that dies fails the search in flight (HTTP 500) and the
  server, which exits non-zero: rank 0 never searches alone.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import torch_ranks as tr
from openmatch_tpu_torch.data.collators import pad_ids
from openmatch_tpu_torch.drivers.serve import RetrievalService
from openmatch_tpu_torch.models.jax_convert import params_from_jax
from openmatch_tpu_torch.ops.mips import Searcher
from openmatch_tpu_torch.parallel.mesh import spawn_ranks
from openmatch_tpu_torch.retriever.encoder import save_embeddings, shard_path

torch.set_num_threads(2)
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
RTOL, ATOL = 1e-5, 1e-6
IDS = [f"d{i}" for i in range(8)]


@pytest.fixture(scope="module")
def jax_side():
    """JAX's test_serve.py construction: the seeded model, its doc reps
    and its services (one device, and the 8-device mesh per partition)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from openmatch_tpu.drivers.serve import RetrievalService as JaxService
    from openmatch_tpu.models.bert import BertConfig
    from openmatch_tpu.models.dr_model import DRModel
    from openmatch_tpu.ops.mips import Searcher as JaxSearcher

    model = DRModel(encoder_config=BertConfig(**tr.SERVE_BERT,
                                              add_pooler=False),
                    normalize=True, dtype=jnp.float32)
    params = model.init_params(jax.random.PRNGKey(0))
    tok = tr.VocabTokenizer()
    enc = [tok.encode_plus(f"document about topic{i}", max_length=8)
           ["input_ids"] for i in range(8)]
    batch = pad_ids(enc, 8, 0)
    reps = np.asarray(model.encode_passage(
        params, jnp.asarray(batch["input_ids"]),
        jnp.asarray(batch["attention_mask"])))
    mesh8 = Mesh(np.array(jax.devices()).reshape(8), axis_names=("data",))
    answers = {}
    services = {"one": JaxSearcher(jnp.asarray(reps), k=4, method="hier2")}
    for part in ("queries", "docs"):
        services[part] = JaxSearcher(reps.astype(np.float32), k=4,
                                     mesh=mesh8, method="hier2",
                                     partition=part)
    with mesh8:
        for name, searcher in services.items():
            service = JaxService(model, params, tok, searcher, IDS,
                                 q_max_len=8, max_batch=4)
            answers[name] = [service.search(q, k=3)
                             for q in tr.SERVE_QUERIES]
    return params_from_jax(params), reps, answers


def wide(reps: np.ndarray) -> tuple:
    """The topic reps plus 4,092 seeded unit rows."""
    rng = np.random.RandomState(5)
    extra = rng.randn(4092, reps.shape[1]).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    return (np.concatenate([reps, extra]),
            IDS + [f"x{i}" for i in range(len(extra))])


@pytest.fixture(scope="module")
def ranks(jax_side):
    state, reps, _ = jax_side
    inputs = {"state": state, "topics": (reps, IDS), "wide": wide(reps)}
    return spawn_ranks(tr.serve_world, 2, args=(inputs,), device="cpu",
                       timeout_s=300)


def one_process(state, corpus, method, n_segs, dtype=torch.float32):
    reps, ids = corpus
    service = RetrievalService(
        tr.serve_model(state), tr.VocabTokenizer(),
        Searcher(torch.from_numpy(reps).to(dtype), k=4, method=method,
                 n_segs=n_segs), ids, q_max_len=8, max_batch=4)
    try:
        return [service.search(q, k=3) for q in tr.SERVE_QUERIES]
    finally:
        service.close()


def assert_same_answers(got, want, what):
    """Per query: scores within RTOL / ATOL position by position, and the
    ids above the tie band (the last score + 1e-5 x max|score|) equal."""
    assert len(got) == len(want), what
    for g_set, w_set in zip(got, want):
        assert len(g_set) == len(w_set), what
        for g, w in zip(g_set, w_set):
            gs = np.array([d["score"] for d in g])
            ws = np.array([d["score"] for d in w])
            assert gs.shape == ws.shape, what
            np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL,
                                       err_msg=what)
            band = ws[-1] + 1e-5 * np.abs(ws).max()
            assert ({d["id"] for d in g if d["score"] > band}
                    == {d["id"] for d in w if d["score"] > band}), what


@pytest.mark.parametrize("case", sorted(tr.SERVE_CASES))
def test_mesh_service_matches_jax_and_one_process(ranks, jax_side, case):
    state, reps, jax_answers = jax_side
    part, method, n_segs, corpus = tr.SERVE_CASES[case]
    got = ranks[0][case]
    # rank 1 ran every search rank 0 ran: the warmup and 3 chunks
    assert ranks[1][case] == 4
    corpus = {"topics": (reps, IDS), "wide": wide(reps)}[corpus]
    assert_same_answers(got, one_process(state, corpus, method, n_segs),
                        f"{case} vs the port on one process")
    if corpus[0].shape[0] == 8:  # JAX's own construction
        assert_same_answers(got, jax_answers[part], f"{case} vs JAX mesh")
        assert_same_answers(got, jax_answers["one"], f"{case} vs JAX")
    # the identity ranking of JAX's test: each topic's document first
    assert [r[0]["id"] for r in got[1][:7]] == IDS[:7]


# ---- serve.main over 2 ranks, each its own process ---------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_inputs(root, state) -> tuple:
    """A DR checkpoint and the "wide" encoded index under ``root``."""
    model = tr.serve_model(state)
    ckpt = os.path.join(root, "ckpt")
    model.save(ckpt)
    reps, ids = wide(encode_topics(model))
    emb = os.path.join(root, "emb")
    save_embeddings(reps, ids, shard_path(emb, "corpus", 0))
    return ckpt, emb


def encode_topics(model) -> np.ndarray:
    tok = tr.VocabTokenizer()
    enc = [tok.encode_plus(f"document about topic{i}", max_length=8)
           ["input_ids"] for i in range(8)]
    batch = pad_ids(enc, 8, 0)
    with torch.no_grad():
        return model.encode_passage(
            torch.from_numpy(batch["input_ids"]),
            torch.from_numpy(batch["attention_mask"])).numpy()


def launch(root, argv, **kw) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, TESTS, os.environ.get("PYTHONPATH", "")]))
    procs = []
    for rank in range(2):
        code = ("import torch_ranks; torch_ranks.serve_process("
                f"{rank}, 2, {root!r}, {argv!r}, **{kw!r})")
        log = open(os.path.join(root, f"rank{rank}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      cwd=root, stdout=log,
                                      stderr=subprocess.STDOUT))
    return procs


def logs(root) -> str:
    return "\n".join(open(os.path.join(root, f"rank{r}.log")).read()
                     for r in range(2))


def post(port, queries, k=3):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/search",
        data=json.dumps({"queries": queries, "k": k}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def wait_ready(port, procs, root, deadline_s=180.0):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        if any(p.poll() is not None for p in procs):
            break
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                        timeout=5) as r:
                if r.status == 200:
                    return json.loads(r.read())
        except OSError:
            time.sleep(0.2)
    raise AssertionError("the server did not come up:\n" + logs(root))


def stop_all(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def main_argv(ckpt, emb, port, part, n_segs) -> list:
    return ["--model_name_or_path", ckpt, "--encoded_save_path", emb,
            "--port", str(port), "--max_batch", "4", "--q_max_len", "8",
            "--retrieve_depth", "4", "--search_partition", part,
            "--search_method", "kernel", "--search_n_segs", str(n_segs),
            "--dtype", "float32", "--device", "cpu"]


def test_main_over_two_ranks_serves_idles_and_stops(tmp_path, jax_side):
    """/search through rank 0 equals the port's one-process service over
    the same bf16 index (``serve.main`` casts it on the host); an idle
    spell of twice the 4 s collective timeout is bridged by keep-alives
    (0.5 s); SIGTERM to rank 0 ends both ranks with exit code 0."""
    state = jax_side[0]
    root = str(tmp_path)
    ckpt, emb = write_inputs(root, state)
    port = free_port()
    procs = launch(root, main_argv(ckpt, emb, port, "queries", 2),
                   timeout_s=4.0, keepalive_s=0.5)
    try:
        health = wait_ready(port, procs, root)
        assert health["num_docs"] == 4100
        want = one_process(state, wide(encode_topics(tr.serve_model(state))),
                           "kernel", 2, torch.bfloat16)
        for i, queries in enumerate(tr.SERVE_QUERIES):
            status, body = post(port, queries)
            assert status == 200, body
            assert_same_answers([body["results"]], [want[i]], "http")
        time.sleep(8.0)  # twice the groups' timeout
        status, body = post(port, tr.SERVE_QUERIES[0])
        assert status == 200, (body, logs(root))
        assert_same_answers([body["results"]], [want[0]], "after idling")
        procs[0].send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=60) for p in procs]
    finally:
        stop_all(procs)
    assert codes == [0, 0], logs(root)
    assert "stopped after" in logs(root)


def test_dead_follower_fails_the_search_and_the_server(tmp_path, jax_side):
    """Rank 1 dies in the search of the first request: rank 0 answers 500,
    then exits non-zero; it does not search alone."""
    root = str(tmp_path)
    ckpt, emb = write_inputs(root, jax_side[0])
    port = free_port()
    procs = launch(root, main_argv(ckpt, emb, port, "docs", 1),
                   die_on_search=2)  # the first search is rank 0's warmup
    try:
        wait_ready(port, procs, root)
        status, body = post(port, tr.SERVE_QUERIES[0])
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        stop_all(procs)
    assert status == 500, body
    assert codes[1] == 3, logs(root)
    assert codes[0] not in (0, None), logs(root)
    assert "serving over ranks failed" in logs(root)
