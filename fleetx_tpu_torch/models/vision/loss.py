"""Classification losses and metrics (port of
``fleetx_tpu/models/vision/loss.py:14-47``): the f32 cross entropy with
label smoothing, the ViT variant's default smoothing and top-k
accuracy."""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross entropy over the batch, in f32; ``labels`` are class ids
    ``[b]`` or one-hot / soft targets ``[b, C]``. Smoothing mixes the
    targets with the uniform distribution: ``(1 - e)·t + e / C``."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    if labels.ndim == logits.ndim - 1:
        targets = torch.nn.functional.one_hot(
            labels.long(), num_classes).float()
    else:
        targets = labels.float()
    if label_smoothing > 0.0:
        targets = (1.0 - label_smoothing) * targets + \
            label_smoothing / num_classes
    logp = torch.log_softmax(logits, dim=-1)
    return -(targets * logp).sum(dim=-1).mean()


def vit_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                      label_smoothing: float = 0.0001) -> torch.Tensor:
    """The ViT loss: ``cross_entropy`` with a small default smoothing."""
    return cross_entropy(logits, labels, label_smoothing)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  topk=(1, 5)) -> dict:
    """``{"top<k>": share of rows whose label is among the k largest
    logits}`` (f32 0-d tensors); soft labels are reduced to their argmax.
    Rows with tied logits may rank them in another order than JAX's
    ``lax.top_k``."""
    if labels.ndim > 1:
        labels = torch.argmax(labels, dim=-1)
    out = {}
    max_k = min(max(topk), logits.shape[-1])
    pred = torch.topk(logits, max_k, dim=-1).indices
    hit = pred == labels.long()[:, None]
    for k in topk:
        k_eff = min(k, logits.shape[-1])
        out[f"top{k}"] = hit[:, :k_eff].any(dim=1).float().mean()
    return out
