"""Faults planted in the program's ``kimi_linear`` backbone through
pytest's ``monkeypatch`` (or any object with its ``setattr``), for the
tests and readings that see ``encode_kimi``'s check catch them.

The three faults inside K13 (state or convolution across documents, the
L2 norm skipped) run K13's plain version, which reads the documents'
bounds on the host: they also turn the CUDA graphs off, so on a card the
encode runs eagerly. The others are operations of the layer and run
under the graphs."""

from __future__ import annotations

import torch


def _plain_k13(monkeypatch):
    from openmatch_tpu_torch.models import dr_model
    from openmatch_tpu_torch.models import kimi_linear as kl
    from openmatch_tpu_torch.ops import kda

    monkeypatch.setattr(kl, "kda_chunk", kda.kda_chunk_plain)
    monkeypatch.setattr(dr_model, "engages", lambda *args: False)
    return kda


def _one_document(cu):
    return torch.stack((cu[0], cu[-1]))


def state_carried_across_documents(monkeypatch):
    """K13's state runs on from one document into the next."""
    kda = _plain_k13(monkeypatch)
    full = kda.gated_delta_chunks
    monkeypatch.setattr(kda, "gated_delta_chunks",
                        lambda q, k, v, g, beta, cu: full(
                            q, k, v, g, beta, _one_document(cu)))


def conv_leaks_across_documents(monkeypatch):
    """The short convolution reads the previous document's last tokens."""
    kda = _plain_k13(monkeypatch)
    full = kda.causal_conv_silu
    monkeypatch.setattr(kda, "causal_conv_silu",
                        lambda x, w, cu: full(x, w, _one_document(cu)))


def qk_l2_norm_skipped(monkeypatch):
    """q and k enter the recurrence without their L2 norm."""
    kda = _plain_k13(monkeypatch)
    monkeypatch.setattr(kda, "l2_normalize", lambda x: x)


def decay_one_value_a_head(monkeypatch):
    """Each head's decay the mean of its channels' (one value a head)."""
    from openmatch_tpu_torch.models import kimi_linear as kl

    full = kl.kda_decay

    def collapsed(f, A_log, dt_bias, heads):
        g = full(f, A_log, dt_bias, heads)
        T = g.shape[0]
        return g.view(T, heads, -1).mean(-1, keepdim=True).expand(
            T, heads, g.shape[1] // heads).reshape(T, -1)

    monkeypatch.setattr(kl, "kda_decay", collapsed)


def beta_dropped(monkeypatch):
    """The delta rule's step beta left at one."""
    from openmatch_tpu_torch.models import kimi_linear as kl

    full = kl.kda_chunk
    monkeypatch.setattr(kl, "kda_chunk",
                        lambda qkv, w, g, beta, cu, heads: full(
                            qkv, w, g, torch.ones_like(beta), cu, heads))


def output_gate_dropped(monkeypatch):
    """The per-head norm's output not gated by sigmoid(g_b(g_a(x)))."""
    from openmatch_tpu_torch.models import kimi_linear as kl

    full = kl.output_gate
    monkeypatch.setattr(kl, "output_gate",
                        lambda o, weight, gate, eps: full(
                            o, weight, torch.full_like(gate, 30.0), eps))


def rope_applied_in_mla(monkeypatch):
    """The latent attention rotates its 64-wide parts (RoPE at the
    positions in each document), as DeepSeek-V3 does."""
    from openmatch_tpu_torch.models import deepseek_v3 as ds
    from openmatch_tpu_torch.models import kimi_linear as kl

    class Rotated(ds.MLAttention):
        def forward(self, h, bias, cos, sin, pack):
            S = pack.slot.shape[1]
            cos, sin = ds.rope_tables(self.cfg, S, h.device)
            column = pack.source % S
            self.rope = True
            return super().forward(h, bias, cos.index_select(0, column),
                                   sin.index_select(0, column), pack)

    monkeypatch.setattr(kl, "MLAttention", Rotated)


def non_held_experts_computed(monkeypatch):
    """Slots routed to experts the card does not hold are computed, each
    by a held expert (its id taken modulo the share), as if the card held
    every expert."""
    from openmatch_tpu_torch.models import deepseek_v3 as ds

    full = ds.Router.forward

    def folded(self, x, real):
        ids, weights = full(self, x, real)
        E = self.cfg.n_routed_experts
        held = next(m.held for m in _moes if m.gate is self)
        local = (ids - held[0]) % held[1] + held[0]
        return torch.where(ids < E, local, ids), weights

    _moes = []
    init = ds.MoE.__init__

    def remembered(self, *args, **kwargs):
        init(self, *args, **kwargs)
        _moes.append(self)

    monkeypatch.setattr(ds.MoE, "__init__", remembered)
    monkeypatch.setattr(ds.Router, "forward", folded)


def shared_expert_counted_twice(monkeypatch):
    """The shared expert's output added twice."""
    from openmatch_tpu_torch.models import deepseek_v3 as ds

    full = ds.MoE.forward
    monkeypatch.setattr(ds.MoE, "forward",
                        lambda self, x, pack, slots, held_slots=None: full(
                            self, x, pack, slots, held_slots)
                        + self.shared_experts(x))


FAULTS = ("state_carried_across_documents", "conv_leaks_across_documents",
          "decay_one_value_a_head", "beta_dropped", "qk_l2_norm_skipped",
          "output_gate_dropped", "rope_applied_in_mla",
          "non_held_experts_computed", "shared_expert_counted_twice")
