"""Learning-rate schedules as pure step → lr functions (port of
``fleetx_tpu/optims/lr_scheduler.py:20-107``).

- ``cosine_annealing_with_warmup``: linear warmup to ``max_lr``, cosine
  decay to ``min_lr`` over ``decay_steps``, constant ``min_lr`` after;
- ``vit_lr``: linear warmup to ``learning_rate``, then cosine or linear
  decay to ``min_lr`` at ``total_steps``;
- ``constant_lr``.
"""

from __future__ import annotations

import math


def cosine_annealing_with_warmup(max_lr: float, min_lr: float = 0.0,
                                 warmup_steps: int = 0,
                                 decay_steps: int = 1):
    """Megatron cosine schedule."""
    warmup_steps = int(warmup_steps)
    decay_steps = max(int(decay_steps), 1)

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return max_lr * step / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(decay_steps - warmup_steps, 1)
        progress = min(max(progress, 0.0), 1.0)
        return min_lr + 0.5 * (max_lr - min_lr) * (
            1.0 + math.cos(math.pi * progress))

    return schedule


def vit_lr(learning_rate: float, total_steps: int, warmup_steps: int = 0,
           decay_type: str = "cosine", min_lr: float = 0.0):
    """ViT warmup + cosine / linear decay (the reference
    ``ViTLRScheduler``)."""
    total_steps = max(int(total_steps), 1)
    warmup_steps = int(warmup_steps)
    if decay_type not in ("cosine", "linear"):
        raise ValueError(f"unknown decay_type {decay_type!r}")

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return learning_rate * step / max(warmup_steps, 1)
        progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        progress = min(max(progress, 0.0), 1.0)
        if decay_type == "cosine":
            return min_lr + 0.5 * (learning_rate - min_lr) * (
                1.0 + math.cos(math.pi * progress))
        return learning_rate + (min_lr - learning_rate) * progress

    return schedule


def constant_lr(learning_rate: float):
    """Fixed learning rate schedule."""

    def schedule(step) -> float:
        del step
        return float(learning_rate)

    return schedule


SCHEDULERS = {
    "CosineAnnealingWithWarmupDecay": "cosine",
    "cosine": "cosine",
    "ViTLRScheduler": "vit",
    "vit": "vit",
    "constant": "constant",
}


def build_lr_scheduler(cfg: dict):
    """Config-driven scheduler factory (the reference YAML keys: ``name``,
    ``max_lr``/``learning_rate``, ``min_lr``, ``warmup_rate`` or
    ``warmup_steps``, ``decay_steps``; the ViT schedule's
    ``learning_rate``, ``total_steps``, ``warmup_steps``, ``decay_type``
    and ``min_lr``)."""
    cfg = dict(cfg or {})
    name = SCHEDULERS.get(cfg.get("name", "cosine"))
    if name is None:
        raise ValueError(f"unknown lr scheduler {cfg.get('name')!r}")
    if name == "vit":
        return vit_lr(
            learning_rate=float(cfg.get("learning_rate", 1e-3)),
            total_steps=int(cfg.get("total_steps",
                                    cfg.get("decay_steps", 10000))),
            warmup_steps=int(cfg.get("warmup_steps", 0)),
            decay_type=cfg.get("decay_type", "cosine"),
            min_lr=float(cfg.get("min_lr", 0.0)))
    if name == "constant":
        return constant_lr(float(cfg.get("learning_rate",
                                         cfg.get("max_lr", 1e-4))))
    max_lr = float(cfg.get("max_lr", cfg.get("learning_rate", 1e-4)))
    min_lr = float(cfg.get("min_lr", 0.0))
    decay_steps = int(cfg.get("decay_steps", 10000))
    if "warmup_steps" in cfg:
        warmup_steps = int(cfg["warmup_steps"])
    else:
        warmup_steps = int(float(cfg.get("warmup_rate", 0.0)) * decay_steps)
    return cosine_annealing_with_warmup(max_lr=max_lr, min_lr=min_lr,
                                        warmup_steps=warmup_steps,
                                        decay_steps=decay_steps)
