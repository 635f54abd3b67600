"""K13, the chunked forward of Kimi Delta Attention (KDA) over a packed
stream of documents, with each document's short convolution.

KDA is a gated delta-rule linear attention with a decay per key channel
(Kimi-Linear, ``models/kimi_linear``). Per token t and head h, with q, k
and v each ``SiLU(causal_conv(W x))`` (a depthwise convolution of width
``K`` with zero history at the document's first token), q and k
L2-normalised (eps 1e-6) and q scaled by D^-1/2:

    S_t = (I - beta_t k_t k_t^T) Diag(exp(g_t)) S_{t-1} + beta_t k_t v_t^T
    o_t = S_t^T q_t

with ``S`` [D, D] fp32 and zero at each document's start, ``g`` (<= 0) the
log decay of each key channel and ``beta`` one number a head.

``kda_chunk(qkv, conv_w, g, beta, cu, heads)``: ``qkv`` [T, 3 x H x D]
bf16 (rows may be strided) holds the projections before the convolution,
q's channels, then k's, then v's (head-major); ``conv_w`` [3 x H x D, K]
the convolution's taps (tap K - 1 reads the token itself); ``g`` [T, H x
D] fp32; ``beta`` [T, H] fp32; ``cu`` [B + 1] int64 the documents' first
slots and the end of the last, made on the device (slots at or past
``cu[B]`` hold no token and their output is zero: the attention core reads
such slots at its pad positions, where a NaN would survive the mask).
Returns ``o`` [T, H, D] in ``qkv``'s dtype.

The chunked form. A document runs in chunks of ``CHUNK`` tokens counted
from its own first token, so documents start anywhere in the stream. With
G_t the sum of g over the chunk up to t (per channel) and S_0 the state
before the chunk, the chunk's updates U [C, D] solve

    (I + Diag(beta) A) U = Diag(beta) (V - (k e^G) S_0),
    A[t, s] = sum_c k_t[c] k_s[c] e^(G_t[c] - G_s[c])   (s < t),

then ``o = (q e^G) S_0 + P U`` with ``P[t, s]`` A's sum over q_t (s <= t),
and ``S_C = e^(G_C) S_0 + (k e^(G_C - G))^T U``. Every exponent in the
products with S is <= 0; the intra-chunk sums take e^(G_t - G_s) channel
by channel, so no factor can overflow however fast a channel decays.

A CUDA tensor launches ``csrc/kda_chunk.cu`` (bf16 ``qkv`` and
``conv_w``, a convolution of width 4, a head width of 128, Kimi-Linear's,
or 16, the tests' tiny model's),
two kernels counted once in ``_build.launches`` under ``kda_chunk``: a
parallel pass, one block a chunk and head, computes everything of a chunk
that does not depend on the state (the convolution, the norms, A, P,
(I + beta A)^-1 and the products it hands on, in fp32 scratch of the
stream's shape); then a serial pass, one block a document, head and block
of value columns, carries the state in registers through the document's
chunks, three products with the state a chunk, all in fp32 on the CUDA
cores. The documents' first chunks are a cumsum on the device, so the
launches can be captured in a CUDA graph; the kernel's source says what
bounds it. A CPU tensor takes ``kda_chunk_plain``, the same chunked
arithmetic in torch with the bounds read on the host. Nothing falls back
from one to the other. The kernel replaces no TPU kernel: the JAX package
has no linear attention.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check, load_library

CHUNK = 16  # tokens a chunk (csrc/kda_chunk.cu's C)
TAPS = 4  # the card's convolution width: short_conv_kernel_size
L2_EPS = 1e-6


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x [..., D] fp32 over the square root of its sum of squares + eps."""
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + L2_EPS)


def positions(cu: torch.Tensor, n: int) -> torch.Tensor:
    """Each of ``n`` slots' position in its document (slots past the
    last document count on from its end)."""
    slots = torch.arange(n, device=cu.device)
    doc = torch.searchsorted(cu, slots, right=True) - 1
    return slots - cu[doc.clamp(0, cu.numel() - 1)]


def causal_conv_silu(x: torch.Tensor, w: torch.Tensor,
                     cu: torch.Tensor) -> torch.Tensor:
    """``SiLU`` of the depthwise causal convolution of ``x`` [T, C] with
    taps ``w`` [C, K] in fp32, each document's history zero (``cu``)."""
    T, K = x.shape[0], w.shape[1]
    pos = positions(cu, T)
    x, w = x.float(), w.float()
    y = x * w[:, K - 1]
    for i in range(1, K):
        shifted = F.pad(x[:T - i], (0, 0, i, 0))
        y = y + shifted * w[:, K - 1 - i] * (pos >= i)[:, None]
    return F.silu(y)


def gated_delta_chunks(q, k, v, g, beta, cu,
                       chunk: int = CHUNK) -> torch.Tensor:
    """The chunked recurrence (see the module docstring) in fp32: q, k
    and g [T, H, D], v [T, H, Dv], beta [T, H], documents ``cu`` ->
    o [T, H, Dv] (zero past ``cu[-1]``)."""
    T, H, D = k.shape
    o = q.new_zeros(T, H, v.shape[-1])
    bounds = cu.tolist()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        S = q.new_zeros(H, D, v.shape[-1])
        for c0 in range(lo, hi, chunk):
            part = slice(c0, min(c0 + chunk, hi))
            qc, kc, vc, gc = (t[part].transpose(0, 1) for t in (q, k, v, g))
            bc = beta[part].transpose(0, 1)[..., None]  # [H, C, 1]
            C = qc.shape[1]
            G = gc.cumsum(1)  # [H, C, D]
            keep = torch.ones(C, C, dtype=torch.bool,
                              device=q.device).tril()
            decay = (G[:, :, None] - G[:, None]).masked_fill(
                ~keep[..., None], float("-inf")).exp()  # [H, t, s, D]
            A = torch.einsum("htd,hsd,htsd->hts", kc, kc, decay).tril(-1)
            P = torch.einsum("htd,hsd,htsd->hts", qc, kc, decay)
            eye = torch.eye(C, device=q.device)
            W = bc * (vc - (kc * G.exp()) @ S)
            U = torch.linalg.solve_triangular(eye + bc * A, W, upper=False)
            o[part] = ((qc * G.exp()) @ S + P @ U).transpose(0, 1)
            last = G[:, -1]  # [H, D]
            S = S * last.exp()[..., None] \
                + (kc * (last[:, None] - G).exp()).transpose(1, 2) @ U
    return o


def kda_chunk_plain(qkv: torch.Tensor, conv_w: torch.Tensor,
                    g: torch.Tensor, beta: torch.Tensor, cu: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """``kda_chunk`` in torch (the documents' bounds read on the host):
    the plain version the CPU takes and the card's kernel is compared
    with."""
    T = qkv.shape[0]
    x = causal_conv_silu(qkv, conv_w, cu)
    q, k, v = x.view(T, 3, heads, -1).unbind(1)
    D = q.shape[-1]
    q = l2_normalize(q) * D ** -0.5
    k = l2_normalize(k)
    o = gated_delta_chunks(q, k, v, g.float().view(T, heads, D),
                           beta.float(), cu)
    return o.to(qkv.dtype)


def _check(qkv, conv_w, g, beta, cu, heads):
    T, width = qkv.shape
    if width % (3 * heads) or conv_w.shape[0] != width \
            or g.shape != (T, width // 3) or beta.shape != (T, heads) \
            or cu.dim() != 1:
        raise ValueError(
            f"kda_chunk: qkv {tuple(qkv.shape)}, conv_w "
            f"{tuple(conv_w.shape)}, g {tuple(g.shape)}, beta "
            f"{tuple(beta.shape)}, cu {tuple(cu.shape)} for {heads} heads "
            "must be [T, 3HD], [3HD, K], [T, HD], [T, H] and [B + 1]")
    if qkv.device.type == "cpu":
        return
    D = width // (3 * heads)
    if D not in (16, 128) or conv_w.shape[1] != TAPS:
        raise ValueError(f"kda_chunk takes a head width of 16 or 128 and a "
                         f"convolution of width {TAPS}, got {D} and "
                         f"{conv_w.shape[1]}")
    if qkv.stride(1) != 1 or not (conv_w.is_contiguous()
                                  and g.is_contiguous()
                                  and beta.is_contiguous()):
        raise ValueError("kda_chunk: operands must be contiguous (qkv's "
                         "rows may be strided)")
    if qkv.dtype != torch.bfloat16 or conv_w.dtype != torch.bfloat16 \
            or g.dtype != torch.float32 or beta.dtype != torch.float32:
        raise ValueError(f"kda_chunk takes bf16 qkv and conv_w and fp32 g "
                         f"and beta, got {qkv.dtype}, {conv_w.dtype}, "
                         f"{g.dtype}, {beta.dtype}")
    for t in (conv_w, g, beta, cu):
        if t.device != qkv.device:
            raise ValueError(f"kda_chunk: tensors on {t.device} and "
                             f"{qkv.device}")


def kda_chunk(qkv: torch.Tensor, conv_w: torch.Tensor, g: torch.Tensor,
              beta: torch.Tensor, cu: torch.Tensor,
              heads: int) -> torch.Tensor:
    _check(qkv, conv_w, g, beta, cu, heads)
    if qkv.device.type == "cpu":
        return kda_chunk_plain(qkv, conv_w, g, beta, cu, heads)
    T = qkv.shape[0]
    D = qkv.shape[1] // (3 * heads)
    B = cu.numel() - 1
    out = torch.zeros(T, heads, D, dtype=qkv.dtype, device=qkv.device)
    if T == 0 or B == 0:
        return out
    cu = cu.to(torch.int64)
    # the documents' first chunks, on the device
    cc = F.pad(torch.cumsum((cu.diff() + CHUNK - 1) // CHUNK, 0), (1, 0))
    n_chunks = T // CHUNK + B  # at most one partial chunk a document
    f32 = dict(dtype=torch.float32, device=qkv.device)
    qg, kd, wk, u0 = (torch.empty(T, heads, D, **f32) for _ in range(4))
    pm = torch.empty(T, heads, CHUNK, **f32)
    decay = torch.empty(n_chunks, heads, D, **f32)
    check(load_library().kda_chunk_launch(
        qkv.data_ptr(), qkv.stride(0), conv_w.data_ptr(), g.data_ptr(),
        beta.data_ptr(), cu.data_ptr(), cc.data_ptr(), B, n_chunks, heads, D,
        TAPS, D ** -0.5, L2_EPS, qg.data_ptr(), kd.data_ptr(), wk.data_ptr(),
        u0.data_ptr(), pm.data_ptr(), decay.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(qkv.device).cuda_stream), "kda_chunk")
    return out
