"""The port's kernel modules against the JAX Pallas kernels (interpret mode
on the CPU, as tests/test_pallas_mips.py runs them).

On the CPU the port's wrappers run their plain PyTorch versions; the same
inputs (made with numpy from a seed, bf16-representable) go through the
JAX kernels. Tolerance: atol 1e-4 (fp32 sums in another order) and entries
masked to finfo(float32).min bit-equal. The CUDA kernels themselves are
compared with the plain versions in the ``cuda``-marked tests, which skip
without a card. The card's machine has no JAX: there they run alone with
``python -m pytest --noconftest tests/test_torch_mips_kernels.py -m cuda``."""

import collections
import ctypes
import re

import numpy as np
import pytest
import torch

from openmatch_tpu_torch.ops import _build
from openmatch_tpu_torch.ops import cuda_mips as cm
from openmatch_tpu_torch.ops.grouped_gemm import (grouped_gemm,
                                                  grouped_gemm_plain)

try:
    import jax.numpy as jnp

    from openmatch_tpu.ops import pallas_mips as pm
except ImportError:  # only the cuda-marked tests run without JAX
    jnp = pm = None

torch.set_num_threads(2)
ATOL = 1e-4
NEG = np.finfo(np.float32).min
TILE_G, TILE_Q = 128, 8  # the JAX kernels' test tiles


def bf16_data(seed, *shape):
    """A bf16 tensor for the port and the same values as fp32 for JAX."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(
        np.float32)).to(torch.bfloat16)
    return x, jnp.asarray(x.float().numpy())


def assert_match(got: torch.Tensor, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got == NEG, want == NEG)
    live = want != NEG
    np.testing.assert_allclose(got[live], want[live], atol=ATOL, rtol=0)


@pytest.mark.parametrize("emit_l1,nb_valid,tile_lo,n_tiles", [
    (0, None, 0, None),   # K2: gmax only
    (8, None, 0, None),   # K1: gmax + level 1
    (8, 300, 0, None),    # K1 with pad blocks masked (mid-tile boundary)
    (8, 300, 1, 2),       # K1 over a window of corpus tiles
    (0, None, 2, 1),      # K2 over the last tile only
])
def test_plain_gmax_matches_jax(emit_l1, nb_valid, tile_lo, n_tiles):
    N, D, Q = 3 * TILE_G * 8, 64, 8  # three corpus tiles
    plain, plain_j = bf16_data(0, N, D)
    q, q_j = bf16_data(1, Q, D)
    if nb_valid is not None:  # pads would win every block if unmasked
        plain[nb_valid * 8:] = 4.0
        plain_j = jnp.asarray(plain.float().numpy())
    want = pm.fused_plain_gmax(q_j, plain_j, tile_g=TILE_G, tile_q=TILE_Q,
                               tile_lo=tile_lo, n_tiles=n_tiles,
                               emit_l1=emit_l1, nb_valid=nb_valid)
    blk_lo = tile_lo * TILE_G
    n_blk = None if n_tiles is None else n_tiles * TILE_G
    got = cm.fused_plain_gmax(q, plain, blk_lo=blk_lo, n_blk=n_blk,
                              emit_l1=emit_l1, nb_valid=nb_valid)
    if emit_l1:
        assert_match(got[0], want[0])
        assert_match(got[1], want[1])
    else:
        assert_match(got, want)


def test_plain_gmax_ragged_window_l1():
    """A window whose length is not a multiple of 8 or 16 blocks: l1's
    last entry is the max over the blocks that exist."""
    plain, _ = bf16_data(2, 8 * 203, 32)
    q, _ = bf16_data(3, 5, 32)
    g, l1 = cm.fused_plain_gmax(q, plain, blk_lo=7, n_blk=189, emit_l1=8)
    full = (q.float() @ plain.float().T).view(5, 203, 8).amax(-1)
    np.testing.assert_allclose(g.numpy(), full[:, 7:196].numpy(), atol=ATOL)
    assert l1.shape == (5, 24)
    np.testing.assert_array_equal(l1[:, -1].numpy(),
                                  g[:, 184:].amax(-1).numpy())


def test_gather_rescore_matches_jax():
    Q, NB, k, D = 9, 40, 12, 64  # Q and k both off the JAX kernel's tiles
    plain, plain_j = bf16_data(4, NB * 8, D)
    q, q_j = bf16_data(5, Q, D)
    bids = np.random.RandomState(6).randint(0, NB, size=(Q, k)).astype(np.int32)
    bids[:, 0] = NB - 1  # the last block
    bids[:, 1] = bids[:, 2]  # a repeated id
    want, _ = pm.pallas_gather_rescore(q_j, plain_j, jnp.asarray(bids))
    got = cm.gather_rescore(q, plain, torch.from_numpy(bids))
    assert_match(got, np.asarray(want)[:, :k * 8])


DEDUP_NB, DEDUP_D = 600, 32  # three segments at the 256-block tile cut


def dedup_case(name):
    """(Q, bids [Q, 12] int32) of a selection case of the rescore kernels'
    three-stage form (claim the distinct blocks, score each once, scatter)."""
    rng = np.random.RandomState(sum(map(ord, name)))
    Q, k = {"q65": 65, "q130": 130}.get(name, 9), 12
    if name in ("overlap", "q65", "q130"):  # a few blocks shared by all
        bids = rng.choice(rng.permutation(DEDUP_NB)[:20], (Q, k))
    elif name == "same":
        bids = np.full((Q, k), 7)
    elif name == "distinct":
        bids = rng.permutation(DEDUP_NB)[:Q * k].reshape(Q, k)
    elif name == "repeats":  # ids repeated within each query's row
        bids = np.repeat(rng.randint(0, DEDUP_NB, (Q, 4)), 3, axis=1)
    elif name == "out_of_range":
        bids = rng.randint(0, DEDUP_NB, (Q, k))
        bids[:, :4] = [-5, -1, DEDUP_NB, DEDUP_NB + 100]
    else:  # "segments": the first and last block of each segment
        bids = rng.randint(0, DEDUP_NB, (Q, k))
        bids[:, :6] = [0, 255, 256, 511, 512, DEDUP_NB - 1]
    return Q, bids.astype(np.int32)


@pytest.mark.parametrize("name", ["overlap", "same", "distinct", "repeats",
                                  "out_of_range", "segments", "q65", "q130"])
def test_gather_rescore_dedup_reference_matches_jax(name):
    """The plain three-stage form equals the plain version and JAX's
    kernel within 1e-5 x max|score| (fp32 sums in another order); over
    segments cut at 256-block tiles it equals itself over one buffer
    bit for bit. JAX takes the ids clamped, as the port's contract does."""
    Q, bids = dedup_case(name)
    corpus, _ = bf16_data(9, DEDUP_NB * 8, DEDUP_D)
    q, q_j = bf16_data(10, Q, DEDUP_D)
    body = cm.prepare_plain_corpus(corpus, n_segs=3).plain \
        if name == "segments" else corpus
    if name == "segments":
        assert [s.shape[0] // 8 for s in body] == [256, 256, 88]
    b = torch.from_numpy(bids)
    got = cm.gather_rescore_dedup_reference(q, body, b)
    want = cm.gather_rescore_reference(q, body, b)
    tol = 1e-5 * want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol, rtol=0)
    plain_j = tuple(jnp.asarray(s.float().numpy()) for s in body) \
        if isinstance(body, tuple) else jnp.asarray(corpus.float().numpy())
    jax_out, _ = pm.pallas_gather_rescore(
        q_j, plain_j, jnp.asarray(np.clip(bids, 0, DEDUP_NB - 1)))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_out)[:, :bids.shape[1] * 8],
                               atol=tol, rtol=0)
    if name == "segments":
        np.testing.assert_array_equal(
            got.numpy(),
            cm.gather_rescore_dedup_reference(q, corpus, b).numpy())


def test_wrappers_reject_bad_windows_and_shapes():
    plain, _ = bf16_data(7, 64, 16)
    q, _ = bf16_data(8, 2, 16)
    with pytest.raises(ValueError, match="window"):
        cm.fused_plain_gmax(q, plain, blk_lo=4, n_blk=5)
    with pytest.raises(ValueError, match="rows"):
        cm.fused_plain_gmax(q, plain[:60])
    with pytest.raises(ValueError, match="emit_l1"):
        cm.fused_plain_gmax(q, plain, emit_l1=3)
    with pytest.raises(ValueError, match="shapes"):
        cm.gather_rescore(q, plain, torch.zeros(3, 4, dtype=torch.int32))


def rescore_operands(D=16, Q=2, **kw):
    """CPU stand-ins for the rescore kernel's operands, one of them made
    wrong by ``kw``."""
    ops = dict(q=torch.zeros(Q, D, dtype=torch.bfloat16),
               body=torch.zeros(8 * 4, D, dtype=torch.bfloat16),
               bids=torch.zeros(Q, 3, dtype=torch.int32))
    ops.update(kw)
    return ops["q"], (ops["body"],), ops["bids"]


@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("case,match", [
    (dict(q=torch.zeros(2, 16)), "bf16"),
    (dict(body=torch.zeros(32, 16)), "bf16"),
    (dict(bids=torch.zeros(2, 3, dtype=torch.int64)), "int32"),
    (dict(D=12, q=torch.zeros(2, 12, dtype=torch.bfloat16)), "D % 8"),
    (dict(bids=torch.zeros(3, 2, dtype=torch.int32).T), "contiguous"),
])
def test_rescore_kernels_refuse_what_they_do_not_take(case, match, pipeline):
    """What a CUDA tensor must be for K3/K5 and for K6 (the checks run
    before either launch; on the CPU the wrapper takes the plain path)."""
    case = dict(case)
    D = case.pop("D", 16)
    q, segs, bids = rescore_operands(D, **case)
    with pytest.raises(ValueError, match=match):
        cm._check_rescore_operands(q, segs, bids, pipeline)


def test_pipelined_rescore_depth_limit():
    """K6 takes D up to MAX_PIPELINED_D; K3 any D % 8 == 0."""
    for D in (cm.MAX_PIPELINED_D, cm.MAX_PIPELINED_D + 8):
        q, segs, bids = rescore_operands(D)
        cm._check_rescore_operands(q, segs, bids, False)
        if D > cm.MAX_PIPELINED_D:
            with pytest.raises(ValueError, match="pipeline=True"):
                cm._check_rescore_operands(q, segs, bids, True)
        else:
            cm._check_rescore_operands(q, segs, bids, True)


@pytest.mark.parametrize("Q,nb,k,slots", [
    (512, 1_105_227, 1000, 64_000),  # eight rounds share one round's slots
    (1, 1_105_227, 1000, 1000),  # one query names at most k blocks
    (65, 100, 1000, 100),  # a small corpus: its blocks bound the slots
])
def test_rescore_scratch_holds_one_round(Q, nb, k, slots):
    """Both rescore kernels get mask + count, slot, ulist and scores sized
    for one round of min(Q, 64) queries, each part 256-byte aligned (the
    kernels move scores as float4)."""
    buf, ptrs = cm._rescore_scratch(Q, nb, k, torch.device("cpu"))
    sizes = (8 * (nb + 1), 4 * nb, 4 * slots, 4 * slots * 64 * 8)
    ends = np.cumsum([-(-s // 256) * 256 for s in sizes])
    assert buf.numel() == ends[-1]
    assert [p - buf.data_ptr() for p in ptrs] == [0, *ends[:-1]]


def _c_kind(param: str):
    """The ctypes type an ``extern "C"`` parameter needs."""
    if "*" in param:
        return ctypes.c_void_p
    if "long long" in param:
        return ctypes.c_longlong
    if re.match(r"(const\s+)?float\s+\w+$", param.strip()):
        return ctypes.c_float
    assert re.match(r"(const\s+)?int\s+\w+$", param.strip()), param
    return ctypes.c_int


def test_c_entry_points_match_signatures():
    """Every ``extern "C"`` entry point of ops/csrc/*.cu has the number and
    kinds of parameters (pointer / int / long long / float) that
    ``_build`` hands ctypes: a drift shows on the card only as a truncated
    pointer."""
    found = {}
    for src in sorted(_build.SRC_DIR.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            assert name not in found, f"{name} defined twice"
            found[name] = tuple(_c_kind(p) for p in params.split(","))
    assert found == dict(_build.SIGNATURES)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6helperv' for 'sm_90a'
ptxas info    : Function properties for _Z6helperv
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 352 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119grouped_gemm_kernelILi256EEEvv' for 'sm_90a'
ptxas info    : Function properties for _Z7calleev
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _ZN12_GLOBAL__N_119grouped_gemm_kernelILi256EEEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1064 bytes cmem[0]
"""


def test_ptxas_usage_reads_each_matching_entry_function():
    """Registers, stack frame and spills of the kernels named, each from
    its own entry's lines: another function's properties do not count."""
    assert _build.ptxas_usage(PTXAS_LOG, "grouped_gemm_kernel") == {
        "_ZN12_GLOBAL__N_119grouped_gemm_kernelILi256EEEvv": {
            "registers": 168, "stack_frame": 0, "spill_stores": 0,
            "spill_loads": 0}}
    assert _build.ptxas_usage(PTXAS_LOG, "helper")["_Z6helperv"] == {
        "registers": 40, "stack_frame": 16, "spill_stores": 8,
        "spill_loads": 8}
    assert _build.ptxas_usage("(cached)", "grouped_gemm_kernel") == {}


def wrapper_and_plain(name: str):
    """(the wrapper's call, its plain version's call) of the kernel counted
    as ``name``, on CPU tensors at a tiny size."""
    plain, _ = bf16_data(30, 256 * 8, 64)  # 256 blocks: two segments of 128
    q, _ = bf16_data(31, 4, 64)
    segs = (plain[:128 * 8], plain[128 * 8:])
    bids = torch.from_numpy(np.random.RandomState(32).randint(
        0, 256, size=(4, 5)).astype(np.int32))
    cb = plain.view(256, 8 * 64)
    x, _ = bf16_data(33, 9, 16)  # every row routed: none left unset
    w, _ = bf16_data(34, 3, 24, 16)
    offsets = torch.tensor([0, 4, 4, 9], dtype=torch.int32)
    return {
        "plain_gmax": (lambda: cm.fused_plain_gmax(q, plain, emit_l1=8),
                       lambda: cm.plain_gmax_reference(q, plain, emit_l1=8)),
        "plain_gmax_segs": (
            lambda: cm.fused_plain_gmax_segs(q, segs, emit_l1=8),
            lambda: cm.plain_gmax_segs_reference(q, segs, emit_l1=8)),
        "gather_rescore": (
            lambda: cm.gather_rescore(q, plain, bids),
            lambda: cm.gather_rescore_reference(q, plain, bids)),
        "gather_rescore_seg": (
            lambda: cm.gather_rescore(q, segs, bids),
            lambda: cm.gather_rescore_reference(q, segs, bids)),
        "gather_rescore_pipelined": (
            lambda: cm.gather_rescore(q, plain, bids, pipeline=True),
            lambda: cm.gather_rescore_reference(q, plain, bids)),
        "block_gmax": (lambda: cm.fused_block_gmax(q, cb),
                       lambda: cm.block_gmax_reference(q, cb)),
        "scores": (lambda: cm.fused_scores(q, plain),
                   lambda: cm.scores_reference(q, plain)),
        "score_gmax": (lambda: cm.fused_score_gmax(q, plain, tile=1024),
                       lambda: cm.score_gmax_reference(q, plain, tile=1024)),
        "gmax_only": (lambda: cm.fused_gmax_only(q, plain, tile=1024),
                      lambda: cm.gmax_only_reference(q, plain, tile=1024)),
        "gmax_phase": (
            lambda: cm.fused_gmax_phase(q, plain, "a3base"),
            lambda: cm.gmax_phase_reference(q, plain, "a3base")),
        "grouped_gemm": (lambda: grouped_gemm(x, w, offsets),
                         lambda: grouped_gemm_plain(x, w, offsets)),
    }[name]


@pytest.mark.parametrize("name", [
    "plain_gmax", "plain_gmax_segs", "gather_rescore", "gather_rescore_seg",
    "gather_rescore_pipelined", "block_gmax", "scores", "score_gmax",
    "gmax_only", "gmax_phase", "grouped_gemm"])
def test_cpu_wrapper_takes_its_plain_version_and_counts_no_launch(name):
    """Each wrapper counted in ``_build.launches`` runs its plain version
    on CPU tensors, and no launch is counted."""
    call, plain_call = wrapper_and_plain(name)
    before = _build.launches.copy()
    got, want = call(), plain_call()
    assert _build.launches == before
    for a, b in zip(*(o if isinstance(o, tuple) else (o,)
                      for o in (got, want))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rc,counted", [
    (0, 1), (700, 0), (_build.ENCODE_FAILED + 1, 0)])
def test_check_counts_a_launch_only_when_it_succeeds(monkeypatch, rc,
                                                     counted):
    """``check`` counts a launch that returned 0 under the kernel's name;
    a CUDA error or a failed tensor-map encode raises naming the kernel and
    counts nothing."""
    monkeypatch.setattr(_build, "launches", collections.Counter())
    if counted:
        _build.check(rc, "scores")
    else:
        with pytest.raises(RuntimeError,
                           match=f"^scores: .* {rc % _build.ENCODE_FAILED}$"):
            _build.check(rc, "scores")
    assert _build.launches == ({"scores": counted} if counted else {})


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


REL = 1e-3  # bf16 inputs, fp32 sums in another order


def assert_kernel_close(got: torch.Tensor, want: torch.Tensor):
    """Masked entries bit-equal, the rest within REL * max|want|."""
    assert got.shape == want.shape
    assert torch.equal(got == cm.NEG, want == cm.NEG)
    live = want != cm.NEG
    err = (got[live] - want[live]).abs().max().item()
    assert err <= REL * want[live].abs().max().item()


def card_data(device, seed, *shape):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=device).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("emit_l1,nb_valid", [(0, None), (8, 4000)])
def test_cuda_plain_gmax_matches_plain(cuda_device, emit_l1, nb_valid):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    plain = torch.randn(8 * 4099, 768, generator=g, device=cuda_device
                        ).to(torch.bfloat16)
    q = torch.randn(70, 768, generator=g, device=cuda_device).to(torch.bfloat16)
    before = _build.launches["plain_gmax"]
    got = cm.fused_plain_gmax(q, plain, blk_lo=3, emit_l1=emit_l1,
                              nb_valid=nb_valid)
    want = cm.plain_gmax_reference(q, plain, blk_lo=3, emit_l1=emit_l1,
                                   nb_valid=nb_valid)
    assert _build.launches["plain_gmax"] == before + 1
    for a, b in zip(got if emit_l1 else (got,), want if emit_l1 else (want,)):
        assert_kernel_close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("emit_l1", [0, 8])
def test_cuda_plain_gmax_segs_matches_plain(cuda_device, emit_l1):
    """K4: segments of 256, 512 and 301 blocks, pads masked in the last;
    bit-equal to K1 over the concatenated buffer."""
    segs = tuple(card_data(cuda_device, 10 + i, 8 * nb, 768)
                 for i, nb in enumerate((256, 512, 301)))
    q = card_data(cuda_device, 13, 70, 768)
    nb_valid = 256 + 512 + 301 - 29
    before = _build.launches["plain_gmax_segs"]
    got = cm.fused_plain_gmax_segs(q, segs, emit_l1=emit_l1,
                                   nb_valid=nb_valid)
    want = cm.plain_gmax_segs_reference(q, segs, emit_l1=emit_l1,
                                        nb_valid=nb_valid)
    one = cm.fused_plain_gmax(q, torch.cat(segs), emit_l1=emit_l1,
                              nb_valid=nb_valid)
    assert _build.launches["plain_gmax_segs"] == before + 1
    for a, b, c in zip(*((x,) if not emit_l1 else x
                         for x in (got, want, one))):
        assert_kernel_close(a, b)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True])
def test_cuda_gather_rescore_segments_and_pipeline(cuda_device, pipeline):
    """K5 over segments of 300, 517 and 100 blocks (ids at every cut) and
    K6 over one buffer, each against the plain version; K5 bit-equal to K3
    over the concatenated buffer."""
    segs = tuple(card_data(cuda_device, 20 + i, 8 * nb, 768)
                 for i, nb in enumerate((300, 517, 100)))
    full = torch.cat(segs)
    q = card_data(cuda_device, 23, 33, 768)
    g = torch.Generator(device=cuda_device).manual_seed(24)
    bids = torch.randint(0, 917, (33, 1000), generator=g, device=cuda_device,
                         dtype=torch.int32)
    bids[:, :6] = torch.tensor([0, 299, 300, 816, 817, 916],
                               dtype=torch.int32, device=cuda_device)
    if pipeline:
        before = _build.launches["gather_rescore_pipelined"]
        got = cm.gather_rescore(q, full, bids, pipeline=True)
        assert _build.launches["gather_rescore_pipelined"] == before + 1
    else:
        before = _build.launches["gather_rescore_seg"]
        got = cm.gather_rescore(q, segs, bids)
        assert _build.launches["gather_rescore_seg"] == before + 1
        assert torch.equal(got, cm.gather_rescore(q, full, bids))
    assert_kernel_close(got, cm.gather_rescore_reference(q, segs, bids))


def card_selection(device, selection: str, Q: int, k: int, NB: int):
    """[Q, k] int32 block ids: every (query, slot) pair its own block
    ("distinct"), every pair the same block ("same"), or random ids with a
    repeat in each row and ids out of range ("random")."""
    g = torch.Generator(device=device).manual_seed(72)
    if selection == "distinct":
        bids = torch.randperm(NB, generator=g, device=device)[:Q * k]
        return bids.view(Q, k).to(torch.int32)
    if selection == "same":
        return torch.full((Q, k), NB // 2, dtype=torch.int32, device=device)
    bids = torch.randint(0, NB, (Q, k), generator=g, device=device,
                         dtype=torch.int32)
    bids[:, 0], bids[:, 1], bids[:, 2] = -3, NB + 7, bids[:, 3]
    return bids


@pytest.mark.cuda
@pytest.mark.parametrize("D", [768, 776, 4096])
@pytest.mark.parametrize("Q", [1, 64, 65, 512])
@pytest.mark.parametrize("selection", ["distinct", "same", "random"])
def test_cuda_gather_rescore_selections(cuda_device, selection, Q, D):
    """K3 and K5 (3 segments) against the plain version: every (query,
    slot) pair its own block, every pair the same block, and random ids
    with repeats in a row and ids out of range; Q across the 64-query
    chunks; D = 776 ends mid 32-deep step, D = 4096 takes three staged
    query pieces. K5 bit-equal to K3."""
    NB, k = 40_000, 64
    corpus = card_data(cuda_device, 70, 8 * NB, D)
    segs = cm.prepare_plain_corpus(corpus, n_segs=3).plain
    q = card_data(cuda_device, 71, Q, D)
    bids = card_selection(cuda_device, selection, Q, k, NB)
    before = _build.launches.copy()
    got = cm.gather_rescore(q, corpus, bids)
    got5 = cm.gather_rescore(q, segs, bids)
    assert _build.launches - before == {"gather_rescore": 1,
                                        "gather_rescore_seg": 1}
    assert_kernel_close(got, cm.gather_rescore_reference(q, corpus, bids))
    assert torch.equal(got5, got)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [768, 776, 4096, 6144])
@pytest.mark.parametrize("Q", [1, 64, 65, 512])
@pytest.mark.parametrize("selection", ["distinct", "same", "random"])
def test_cuda_gather_rescore_pipelined_selections(cuda_device, selection, Q,
                                                  D):
    """K6 (one cooperative launch) against the plain version at the same
    selections as K3: Q across the 64-query rounds; D = 776 leaves a
    second 768-deep piece of 8, D = 4096 and 6144 walk the blocks in 6 and
    8 pieces. Two calls give the same bits (the quarters' sums meet in a
    fixed order, whatever slot the claim gives a block)."""
    NB, k = 40_000, 64
    corpus = card_data(cuda_device, 70, 8 * NB, D)
    q = card_data(cuda_device, 71, Q, D)
    bids = card_selection(cuda_device, selection, Q, k, NB)
    before = _build.launches["gather_rescore_pipelined"]
    got = cm.gather_rescore(q, corpus, bids, pipeline=True)
    again = cm.gather_rescore(q, corpus, bids, pipeline=True)
    assert _build.launches["gather_rescore_pipelined"] == before + 2
    assert_kernel_close(got, cm.gather_rescore_reference(q, corpus, bids))
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_cuda_gather_rescore_matches_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    NB = 5003
    plain = torch.randn(8 * NB, 768, generator=g, device=cuda_device
                        ).to(torch.bfloat16)
    q = torch.randn(33, 768, generator=g, device=cuda_device).to(torch.bfloat16)
    bids = torch.randint(0, NB, (33, 1000), generator=g, device=cuda_device,
                         dtype=torch.int32)
    bids[:, -1] = NB - 1
    got = cm.gather_rescore(q, plain, bids)
    want = cm.gather_rescore_reference(q, plain, bids)
    assert (got - want).abs().max().item() <= REL * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 70, 128, 512])
def test_cuda_block_gmax_matches_plain(cuda_device, Q):
    """K7 over a cb view of 4099 blocks (not a multiple of 16) against its
    slab-wise plain version, and bit-equal to K2 over the same bytes."""
    body = card_data(cuda_device, 30, 8 * 4099, 768)
    prep = cm.prepare_block_corpus(body)
    q = card_data(cuda_device, 31, Q, 768)
    before = _build.launches["block_gmax"]
    got = cm.fused_block_gmax(q, prep.cb)
    assert _build.launches["block_gmax"] == before + 1
    assert_kernel_close(got, cm.block_gmax_reference(q, prep.cb))
    assert torch.equal(got, cm.fused_plain_gmax(q, prep.plain))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8 * 4099, 8 * 4099 + 5])
def test_cuda_scores_matches_plain(cuda_device, N):
    """K8: rows past the last 128-row tile; N % 4 != 0 takes the scalar
    stores."""
    c = card_data(cuda_device, 32, N, 768)
    q = card_data(cuda_device, 33, 70, 768)
    before = _build.launches["scores"]
    got = cm.fused_scores(q, c)
    assert _build.launches["scores"] == before + 1
    assert_kernel_close(got, cm.scores_reference(q, c))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1024, 2048])
@pytest.mark.parametrize("N", [16 * 2048, 16 * 2048 + 1029])
def test_cuda_score_gmax_and_gmax_only_match_plain(cuda_device, tile, N):
    """K9 and K10 with a whole and a ragged last tile: the scores and the
    strided maxima against the plain version (masked entries bit-equal),
    and K10's maxima bit-equal to K9's."""
    c = card_data(cuda_device, 34, N, 768)
    q = card_data(cuda_device, 35, 70, 768)
    before = _build.launches.copy()
    s, g = cm.fused_score_gmax(q, c, tile=tile)
    g10 = cm.fused_gmax_only(q, c, tile=tile)
    assert _build.launches - before == {"score_gmax": 1, "gmax_only": 1}
    rs, rg = cm.score_gmax_reference(q, c, tile=tile)
    assert_kernel_close(s, rs)
    assert_kernel_close(g, rg)
    assert torch.equal(g10, g)


# The Hopper mainloop (csrc/score_tile_sm90.cuh): Q takes the resident
# 64-query tile (1, 64), the streamed 256-query tile (70, 256) and two of
# them (257, 512); D = 776 leaves the last 64-deep chunk partly past D.
CARD_Q = [1, 64, 70, 256, 257, 512]
CARD_D = [64, 768, 776]


@pytest.mark.cuda
@pytest.mark.parametrize("D", CARD_D)
@pytest.mark.parametrize("Q", CARD_Q)
def test_cuda_plain_gmax_query_and_depth_shapes(cuda_device, Q, D):
    """K1 over 2051 blocks (the last tile holds 3) with l1 and pad blocks
    masked, against the plain version; K2 and K7 over the same rows
    bit-equal to each other."""
    body = card_data(cuda_device, 40, 8 * 2051, D)
    q = card_data(cuda_device, 41, Q, D)
    g, l1 = cm.fused_plain_gmax(q, body, emit_l1=8, nb_valid=2040)
    want, want_l1 = cm.plain_gmax_reference(q, body, emit_l1=8,
                                            nb_valid=2040)
    assert_kernel_close(g, want)
    assert_kernel_close(l1, want_l1)
    g2 = cm.fused_plain_gmax(q, body)
    assert_kernel_close(g2, cm.plain_gmax_reference(q, body))
    assert torch.equal(g2[:, :2040], g[:, :2040])
    assert torch.equal(g2, cm.fused_block_gmax(
        q, cm.prepare_block_corpus(body).cb))


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [64, 257])
@pytest.mark.parametrize("f", [1, 2, 4, 8, 16])
def test_cuda_plain_gmax_window_mid_tile(cuda_device, Q, f):
    """A window [1001, 3054) that starts and ends mid-tile, with l1 and
    nb_valid inside it. Every row outside the window scores far above the
    rest: one read into a stored maximum or an l1 max shows."""
    body = card_data(cuda_device, 42, 8 * 4099, 768)
    q = card_data(cuda_device, 43, Q, 768).abs()
    lo, n = 1001, 2053
    body[:lo * 8] = 1.0
    body[(lo + n) * 8:] = 1.0
    g, l1 = cm.fused_plain_gmax(q, body, blk_lo=lo, n_blk=n, emit_l1=f,
                                nb_valid=lo + n - 11)
    want, want_l1 = cm.plain_gmax_reference(q, body, blk_lo=lo, n_blk=n,
                                            emit_l1=f, nb_valid=lo + n - 11)
    assert_kernel_close(g, want)
    assert_kernel_close(l1, want_l1)
    assert g.max().item() < q.float().sum(1).min().item()


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [70, 512])
@pytest.mark.parametrize("n_segs", [3, 64])
def test_cuda_plain_gmax_segs_counts(cuda_device, Q, n_segs):
    """K4 over 3 and MAX_SEGS = 64 segments of 16-256 blocks (the last
    ragged, pads masked), against the plain version and bit-equal to K1
    over the concatenated buffer."""
    rng = np.random.RandomState(n_segs)
    sizes = [16 * int(x) for x in rng.randint(1, 17, n_segs - 1)] + [37]
    segs = tuple(card_data(cuda_device, 50 + i, 8 * nb, 768)
                 for i, nb in enumerate(sizes))
    q = card_data(cuda_device, 49, Q, 768)
    nb_valid = sum(sizes) - 5
    got = cm.fused_plain_gmax_segs(q, segs, emit_l1=8, nb_valid=nb_valid)
    want = cm.plain_gmax_segs_reference(q, segs, emit_l1=8,
                                        nb_valid=nb_valid)
    one = cm.fused_plain_gmax(q, torch.cat(segs), emit_l1=8,
                              nb_valid=nb_valid)
    for a, b, c in zip(got, want, one):
        assert_kernel_close(a, b)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [64, 70])
def test_cuda_plain_gmax_all_negative(cuda_device, Q):
    """Every real score below 0 and zero pad rows (score 0) masked: the
    masked blocks are finfo.min in gmax and win no l1 maximum."""
    body = card_data(cuda_device, 44, 8 * 1003, 768).abs().neg()
    q = card_data(cuda_device, 45, Q, 768).abs()
    body[8 * 990:] = 0
    g, l1 = cm.fused_plain_gmax(q, body, emit_l1=8, nb_valid=990)
    want, want_l1 = cm.plain_gmax_reference(q, body, emit_l1=8,
                                            nb_valid=990)
    assert_kernel_close(g, want)
    assert_kernel_close(l1, want_l1)
    assert (g[:, 990:] == cm.NEG).all() and (g[:, :990] < 0).all()
    live = l1[:, :124]  # groups 124, 125 hold masked blocks only
    assert ((live > cm.NEG) & (live < 0)).all()
    assert (l1[:, 124:] == cm.NEG).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 776])
@pytest.mark.parametrize("N", [8 * 2051, 8 * 2051 + 2, 8 * 2051 + 7])
@pytest.mark.parametrize("Q", [1, 64, 257])
def test_cuda_scores_shapes(cuda_device, Q, N, D):
    """K8 with a ragged last tile, N % 4 in {0, 2, 3} (the 16-byte and the
    4-byte stores), the resident and the streamed query tile, and D past
    the last whole chunk."""
    c = card_data(cuda_device, 46, N, D)
    q = card_data(cuda_device, 47, Q, D)
    assert_kernel_close(cm.fused_scores(q, c), cm.scores_reference(q, c))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 32, 2048])
@pytest.mark.parametrize("Q", [64, 257])
def test_cuda_depth_extremes(cuda_device, Q, D):
    """D = 8 and 32: the 64-deep chunk lies mostly past D (zero-filled).
    D = 2048: a 64-query tile of 256 KB does not fit shared memory, so the
    query chunks stream with the corpus chunks. K1 and K8 against their
    plain versions."""
    body = card_data(cuda_device, 60, 8 * 611, D)
    q = card_data(cuda_device, 61, Q, D)
    g, l1 = cm.fused_plain_gmax(q, body, emit_l1=8, nb_valid=600)
    want, want_l1 = cm.plain_gmax_reference(q, body, emit_l1=8,
                                            nb_valid=600)
    assert_kernel_close(g, want)
    assert_kernel_close(l1, want_l1)
    assert_kernel_close(cm.fused_scores(q, body),
                        cm.scores_reference(q, body))


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [2048 * 3, 2048 * 3 - 5, 13, 0])
def test_cuda_mesh_shard_search(cuda_device, valid):
    """A docs-partition rank's search (``plain_topk_valid``) over a shard
    of 3 tiles with ``valid`` real rows: K1 with the shard's nb_valid and
    K3 at the selection its maxima give against their plain versions, and
    the answer equal to an fp32 top-k over the valid rows above the k-th
    score's tie band."""
    shard = torch.zeros(2048 * 3, 768, dtype=torch.bfloat16,
                        device=cuda_device)
    shard[:valid] = card_data(cuda_device, 70, 2048 * 3, 768)[:valid]
    q = card_data(cuda_device, 71, 64, 768)
    k, nb_full = 50, valid // 8
    g1, l1 = cm.fused_plain_gmax(q, shard, emit_l1=8, nb_valid=nb_full)
    want, want_l1 = cm.plain_gmax_reference(q, shard, emit_l1=8,
                                            nb_valid=nb_full)
    if nb_full:
        assert_kernel_close(g1, want)
        assert_kernel_close(l1, want_l1)
    else:  # every block masked
        assert (g1 == cm.NEG).all() and (l1 == cm.NEG).all()
    bid = cm._select_groups(g1, k, l1=l1).to(torch.int32)
    got = cm.gather_rescore(q, shard, bid)
    ref = cm.gather_rescore_reference(q, shard, bid)
    assert (got - ref).abs().max() <= REL * ref.abs().max()
    s, i = cm.plain_topk_valid(q, shard, valid, k)
    rs, ri = cm.plain_topk_valid_reference(q, shard, valid, k)
    n = min(valid, k)
    assert torch.isneginf(s[:, n:]).all() and (i[:, :n] < valid).all()
    if n:
        tol = REL * rs[:, :n].abs().max()
        assert (s[:, :n] - rs[:, :n]).abs().max() <= tol
        above = rs[:, :n] > rs[:, n - 1:n] + tol
        for row in range(q.shape[0]):
            assert set(ri[row, :n][above[row]].tolist()) \
                <= set(i[row, :n].tolist())


@pytest.mark.cuda
def test_cuda_mesh_segmented_replica(cuda_device):
    """A queries-partition rank's segmented index (``_replicated_prep``,
    2 segments copied from the host): K4 and K5 against their plain
    versions, the answer equal to the single-buffer kernel path's."""
    from openmatch_tpu_torch.ops.mips import _replicated_prep
    from openmatch_tpu_torch.parallel.mesh import Mesh

    host = card_data(cuda_device, 72, 8 * 600 + 5, 768).cpu()
    prep = _replicated_prep(host, Mesh(dp=1, tp=1, device=cuda_device), 2)
    segs = prep.plain
    assert isinstance(segs, tuple) and len(segs) == 2
    q = card_data(cuda_device, 73, 64, 768)
    g4, l4 = cm.fused_plain_gmax_segs(q, segs, emit_l1=8)
    want, want_l1 = cm.plain_gmax_segs_reference(q, segs, emit_l1=8)
    assert_kernel_close(g4, want)
    assert_kernel_close(l4, want_l1)
    bid = cm._select_groups(g4, 50, l1=l4).to(torch.int32)
    got = cm.gather_rescore(q, segs, bid)
    ref = cm.gather_rescore_reference(q, segs, bid)
    assert (got - ref).abs().max() <= REL * ref.abs().max()
    s, i = cm.plain_topk_prepared(q, prep, 50)
    s1, i1 = cm.plain_topk_prepared(
        q, cm.prepare_plain_corpus(host.to(cuda_device)), 50)
    assert torch.equal(s, s1) and torch.equal(i, i1)
