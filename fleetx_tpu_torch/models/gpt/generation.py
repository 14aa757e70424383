"""Sampling transforms (port of ``fleetx_tpu/models/gpt/generation.py:134-162``).

The chain ``serving/decode.py:_sample`` runs when ``do_sample`` is on:
temperature → top-k → top-p → categorical. One-shot ``generate`` and beam
search are not ported yet (ROADMAP.md, port queue item 6).
"""

from __future__ import annotations

import torch

NEG_INF = torch.finfo(torch.float32).min


def apply_temperature(logits: torch.Tensor, temperature: float
                      ) -> torch.Tensor:
    """Scale logits by 1/temperature (no-op at 1.0)."""
    if temperature in (None, 1.0):
        return logits
    return logits / max(float(temperature), 1e-6)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit."""
    if not k or k <= 0:
        return logits
    k = min(int(k), logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of the sorted
    distribution with cumulative probability >= p."""
    if not p or p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < p  # always keeps the top token
    kth = torch.where(keep_sorted, sorted_logits,
                      torch.full_like(sorted_logits, float("inf")))
    kth = kth.min(dim=-1, keepdim=True).values
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
