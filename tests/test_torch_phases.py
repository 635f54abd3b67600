"""The perf-script path of the port: the phase-ablation kernel K11
(``fused_gmax_phase`` and its plain version ``gmax_phase_reference``)
against the JAX script's ``pl.pallas_call`` run in interpret mode, the
torch twins of ``score_path_phases.py`` and ``micro.py`` run end to end on
the CPU, and ``utils.profiling``.

Tolerance: ATOL = 1e-4, as in tests/test_torch_mips_kernels.py: both sides
sum the same bf16-representable products in fp32, in another order. The
CUDA kernel itself is compared with its plain version in the ``cuda``-marked
test, which skips without a card."""

import json

import numpy as np
import pytest
import torch

from openmatch_tpu_torch.ops import _build
from openmatch_tpu_torch.ops import cuda_mips as cm
from openmatch_tpu_torch.perf import micro
from openmatch_tpu_torch.perf import score_path_phases as spp
from openmatch_tpu_torch.utils import profiling

try:
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from openmatch_tpu.ops import pallas_mips as pm
except ImportError:  # only the cuda-marked test runs without JAX
    jax = jnp = pl = pltpu = pm = None

torch.set_num_threads(2)
ATOL = 1e-4
GROUP = 8
Q, NBP, D = 128, 512, 64  # one 128-query tile, two 256-block tiles


def jax_k11(queries, plain, phase):
    """The JAX script's K11 (``scripts/perf/score_path_phases.py:124-179``,
    a closure inside its ``main``), copied with D taken from the inputs and
    run in interpret mode."""
    tile_g, tile_q = 256, 128
    Qn, Dn = queries.shape
    NBp = plain.shape[0] // GROUP

    def kernel(q_ref, c_ref, g_ref, s_scratch):
        st = jax.lax.dot_general(
            c_ref[:], q_ref[:],
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # [tile_g*8, tq] f32, docs on sublanes
        s_scratch[:] = st
        if phase == "a3nomax":
            g = s_scratch[0::GROUP, :]
        else:
            g = s_scratch[0::GROUP, :]
            for m in range(1, GROUP):
                g = jnp.maximum(g, s_scratch[m::GROUP, :])
        if phase == "a3notr":
            g_ref[:] = g  # doc-major store, no transpose
        elif phase == "a3mxutr":
            eye = (jax.lax.broadcasted_iota(jnp.int32, (tile_g, tile_g), 0)
                   == jax.lax.broadcasted_iota(jnp.int32, (tile_g, tile_g), 1))
            g_ref[:] = jax.lax.dot_general(
                g, eye.astype(jnp.float32),
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        else:
            g_ref[:] = jnp.swapaxes(g, 0, 1)

    doc_major = phase == "a3notr"
    out_shape = (NBp, Qn) if doc_major else (Qn, NBp)
    out_spec = (pl.BlockSpec((tile_g, tile_q), lambda qb, t: (t, qb),
                             memory_space=pltpu.VMEM) if doc_major else
                pl.BlockSpec((tile_q, tile_g), lambda qb, t: (qb, t),
                             memory_space=pltpu.VMEM))
    return pl.pallas_call(
        kernel,
        grid=(Qn // tile_q, NBp // tile_g),
        in_specs=[
            pl.BlockSpec((tile_q, Dn), lambda qb, t: (qb, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((tile_g * GROUP, Dn), lambda qb, t: (t, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=out_spec,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        scratch_shapes=[pltpu.VMEM((tile_g * GROUP, tile_q), jnp.float32)],
        compiler_params=pltpu.CompilerParams(
            dimension_semantics=("arbitrary", "arbitrary")),
        interpret=True,
    )(queries, plain)


def bf16_pair(seed, *shape):
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(
        np.float32)).to(torch.bfloat16)
    return x, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def k11_inputs():
    plain, plain_j = bf16_pair(0, NBP * GROUP, D)
    q, q_j = bf16_pair(1, Q, D)
    return q, plain, q_j, plain_j


@pytest.mark.parametrize("phase", sorted(cm.GMAX_PHASES))
def test_gmax_phase_matches_jax_k11(k11_inputs, phase):
    q, plain, q_j, plain_j = k11_inputs
    want = np.asarray(jax_k11(q_j, plain_j, phase))
    got = cm.fused_gmax_phase(q, plain, phase)
    ref = cm.gmax_phase_reference(q, plain, phase)
    assert torch.equal(got, ref)
    assert got.shape == want.shape == ((NBP, Q) if phase == "a3notr"
                                       else (Q, NBP))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_k11_copy_agrees_with_jax_k2(k11_inputs):
    """The copied K11's a3base is the JAX package's K2, so the copy has not
    drifted from the kernel it ablates."""
    _, _, q_j, plain_j = k11_inputs
    np.testing.assert_allclose(
        np.asarray(jax_k11(q_j, plain_j, "a3base")),
        np.asarray(pm.fused_plain_gmax(q_j, plain_j)), atol=ATOL, rtol=0)


def test_gmax_phase_layouts_and_refusals():
    plain, _ = bf16_pair(2, 8 * 37, 16)
    q, _ = bf16_pair(3, 5, 16)
    base = cm.fused_gmax_phase(q, plain, "a3base")
    assert torch.equal(cm.fused_gmax_phase(q, plain, "a3notr"), base.T)
    assert torch.equal(cm.fused_gmax_phase(q, plain, "a3mxutr"), base)
    assert torch.equal(base, cm.fused_plain_gmax(q, plain))
    scores = q.float() @ plain.float().T
    assert torch.equal(cm.fused_gmax_phase(q, plain, "a3nomax"),
                       scores[:, ::8])
    with pytest.raises(ValueError, match="phase"):
        cm.fused_gmax_phase(q, plain, "a3")
    with pytest.raises(ValueError, match="rows"):
        cm.fused_gmax_phase(q, plain[:20], "a3base")


# ---- the perf twins ----------------------------------------------------------


SPP_ARGS = ["4096", "8", "16"]  # N, Q, K: 512 blocks, two 256-block tiles


@pytest.mark.parametrize("phase", spp.PHASES)
def test_score_path_phases_runs_every_phase(phase, capsys):
    out = spp.main([phase, *SPP_ARGS, "--device", "cpu"])
    assert out["ms"] > 0 and out["line"].startswith(phase)
    assert out["line"] in capsys.readouterr().out


@pytest.mark.parametrize("phase,arg5", [("sel", "8,8"), ("sell1", "8"),
                                        ("plain", "2"), ("rescseg", "1")])
def test_score_path_phases_arg5(phase, arg5, capsys):
    out = spp.main([phase, *SPP_ARGS, arg5, "--device", "cpu"])
    assert out["line"] in capsys.readouterr().out


@pytest.mark.parametrize("phase", sorted(spp.TPU_TILING_ARG5))
def test_score_path_phases_refuses_tpu_tilings(phase):
    with pytest.raises(SystemExit, match="refused"):
        spp.main([phase, *SPP_ARGS, "128", "--device", "cpu"])


MODES = ["matmul_f32", "matmul_bf16", "gmax_xla", "gmax_pallas",
         "gmax_pallas_t1024", "gp_1024_128", "sgp_2048_256",
         "pallas_full_1024_128", "rescore_full", "rescore_full_1024_128",
         "score_gmax_pallas", "topk_4096", "sortval_4096", "sortpair_4096",
         "topkgather_4096", "approxk_4096", "gather_minor_4096",
         "slab_gather_4096", "gather_rows", "select_groups", "block_full",
         "block_full_256_512", "block_gmax", "block_gmax_256_512",
         "scores_kernel", "score_full", "block_prep_full", "cand_slices",
         "hier2_full", "xla_full_pyramid"]


@pytest.mark.parametrize("mode", MODES)
def test_micro_runs_every_mode(mode, capsys):
    out = micro.main([mode, "8", "8192", "16", "--device", "cpu"])
    assert out["ms"] > 0 and out["first_call_s"] >= 0
    line = capsys.readouterr().out
    assert line.startswith(f"{mode}: Q=8 N=8192 K=16: ")
    assert "ms/iter" in line and "QPS" in line and "first call" in line


def test_micro_states_the_tiling_it_ran(capsys):
    micro.main(["gp_1024_128", "8", "8192", "16", "--device", "cpu"])
    assert "tile_q=128 not used" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="unknown mode"):
        micro.main(["no_such_mode", "8", "8192", "16", "--device", "cpu"])


def test_twins_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        spp.main(["a3base", *SPP_ARGS])
    with pytest.raises(RuntimeError, match="CUDA"):
        micro.main(["matmul_bf16", "8", "8192"])


# ---- utils.profiling ---------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    plain, _ = bf16_pair(4, 8 * 64, 32)
    q, _ = bf16_pair(5, 4, 32)
    with profiling.trace(str(tmp_path / "tr")) as prof:
        cm.fused_gmax_phase(q, plain, "a3base")
    path = tmp_path / "tr" / profiling.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert events and prof.key_averages()


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("Qc,NB", [(70, 4099), (128, 512), (64, 4099),
                                   (512, 1001), (1, 37)])
def test_cuda_gmax_phase_matches_plain(cuda_device, Qc, NB):
    """K11's four variants against the plain version (REL 1e-3 of the
    largest score: bf16 inputs, fp32 sums in another order); on the wgmma
    mainloop K2 and K8 run, a3base is bit-equal to K2 and a3nomax to K8's
    every 8th score, a3notr bit-equal to a3base's transpose and a3mxutr
    within 2^-22 of a3base. Q = 64 keeps the query tile resident, the rest
    stream 256-query tiles; NB % 4 != 0 takes the scalar stores."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    plain = torch.randn(8 * NB, 768, generator=g, device=cuda_device
                        ).to(torch.bfloat16)
    q = torch.randn(Qc, 768, generator=g, device=cuda_device
                    ).to(torch.bfloat16)
    before = _build.launches["gmax_phase"]
    got = {p: cm.fused_gmax_phase(q, plain, p) for p in cm.GMAX_PHASES}
    assert _build.launches["gmax_phase"] == before + 4
    def close(x, want):
        err = (x - want).abs().max().item()
        assert err <= 1e-3 * want.abs().max().item()

    for p, x in got.items():
        close(x, cm.gmax_phase_reference(q, plain, p))
    assert torch.equal(got["a3base"], cm.fused_plain_gmax(q, plain))
    assert torch.equal(got["a3notr"], got["a3base"].T)
    assert torch.equal(got["a3nomax"], cm.fused_scores(q, plain)[:, ::8])
    assert ((got["a3mxutr"] - got["a3base"]).abs()
            <= 2.0**-22 * got["a3base"].abs()).all()
