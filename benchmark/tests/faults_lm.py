"""Faults planted in the program's ``deepseek_v3`` backbone through
pytest's ``monkeypatch``, for the tests that see ``encode_lm``'s check
catch them."""

from __future__ import annotations

import torch


def causal_mask_dropped(monkeypatch):
    """Every position reads every real position, later ones included."""
    from openmatch_tpu_torch.models import deepseek_v3 as ds

    def padding_only(real):
        S = real.shape[1]
        return torch.zeros(real.shape[0], 1, S, S,
                           device=real.device).masked_fill_(
            ~real[:, None, None, :], torch.finfo(torch.float32).min)

    monkeypatch.setattr(ds, "attention_bias", padding_only)


def bias_as_weight(monkeypatch):
    """The correction bias weights the chosen experts' outputs too."""
    from openmatch_tpu_torch.models import deepseek_v3 as ds

    full = ds.Router.forward

    def biased(self, x, real):
        ids, _ = full(self, x, real)
        scores = torch.sigmoid(x.float() @ self.weight.T) \
            + self.e_score_correction_bias
        w = scores.gather(1, ids.clamp_max(self.cfg.n_routed_experts - 1))
        return ids, w / w.sum(-1, keepdim=True) \
            * self.cfg.routed_scaling_factor

    monkeypatch.setattr(ds.Router, "forward", biased)


def rope_not_interleaved(monkeypatch):
    """RoPE over the halves (i, i + r / 2) instead of the pairs (2i, 2i +
    1)."""
    from openmatch_tpu_torch.models import deepseek_v3 as ds

    def halves(x, cos, sin):
        a, b = x.float().chunk(2, -1)
        c, s = cos[:, None, :], sin[:, None, :]
        return torch.cat((a * c - b * s, a * s + b * c), -1).to(x.dtype)

    monkeypatch.setattr(ds, "rotary", halves)


def pooled_at_padded_end(monkeypatch):
    """The rep read at the last position of the padded row."""
    from openmatch_tpu_torch.models import pooling

    monkeypatch.setattr(pooling, "last_pooling", lambda h, mask: h[:, -1])


def one_expert_dropped(monkeypatch):
    """Expert 0's rows of every grouped product left at zero."""
    from openmatch_tpu_torch.models import deepseek_v3 as ds

    full = ds.grouped_gemm

    def dropped(x, w, offsets):  # no host read, so it runs in a graph
        out = full(x, w, offsets)
        first = torch.arange(out.shape[0], device=out.device) < offsets[1]
        return out.masked_fill(first[:, None], 0)

    monkeypatch.setattr(ds, "grouped_gemm", dropped)


def bias_left_out_of_selection(monkeypatch):
    """The experts chosen by score alone, the correction bias unread."""
    from openmatch_tpu_torch.models import deepseek_v3 as ds

    full = ds.Router.forward

    def unbiased(self, x, real):
        bias = self.e_score_correction_bias.clone()
        self.e_score_correction_bias.zero_()
        try:
            return full(self, x, real)
        finally:
            self.e_score_correction_bias.copy_(bias)

    monkeypatch.setattr(ds.Router, "forward", unbiased)
