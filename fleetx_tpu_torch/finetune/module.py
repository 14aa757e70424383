"""LoRA fine-tuning task module (port of ``fleetx_tpu/finetune/module.py``).

``LoRAGPTModule`` is the ``GPTModule`` recipe with two changes:

- ``init_params`` injects the ``_lora_a`` / ``_lora_b`` leaves next to the
  target kernels (``finetune/lora.py``), so the engine's state carries
  base + adapters as one tree (the base values are then overwritten by
  the pretrain restore, ``finetune/recipe.py``);
- every loss and the forward fold the adapters into the base kernels
  first (``merge_adapters``), so the model code runs unmodified while
  the gradients reach the adapter leaves through the fold. The base stays
  bitwise frozen because the optimizer is masked
  (``lora.lora_optimizer``), not because the math hides it.

Config surface (the ``FineTune:`` YAML section)::

    FineTune:
      base_ckpt: ./output/pretrain      # pretrain checkpoint dir (step_N)
      adapter_dir: ./output/adapters    # where adapter artifacts land
      lora:
        rank: 8
        alpha: 16.0

``spec_family`` is the JAX module's: ``gpt_lora``, the partition-rule
family of the adapted tree.
"""

from __future__ import annotations

from typing import Any

import torch

from fleetx_tpu_torch.core.module import GPTModule
from fleetx_tpu_torch.finetune import lora
from fleetx_tpu_torch.utils.log import logger

#: folded into the init seed for the adapters' generator (the JAX module
#: folds the same constant into its init key)
_ADAPTER_SEED_SALT = 0x10A


class LoRAGPTModule(GPTModule):
    """GPT fine-tuning task: frozen base + trainable low-rank adapters."""

    @property
    def spec_family(self) -> str:
        """The adapted tree's partition-rule family."""
        return "gpt_lora"

    def __init__(self, cfg: Any):
        ft = dict(cfg.get("FineTune") or {}) if isinstance(cfg, dict) else {}
        lora_cfg = dict(ft.get("lora") or {})
        self.lora_rank = int(lora_cfg.get("rank") or 8)
        self.lora_alpha = float(lora_cfg.get("alpha")
                                or 2.0 * self.lora_rank)
        self.base_ckpt = ft.get("base_ckpt")
        self.adapter_dir = ft.get("adapter_dir")
        model = dict(cfg.get("Model") or {}) if isinstance(cfg, dict) else {}
        if int(model.get("moe_num_experts") or 0) > 0:
            raise ValueError("LoRA targets the dense GPT stack — fine-tune "
                             "the dense model (Model.moe_num_experts: 0)")
        super().__init__(cfg)
        logger.info("LoRA adapters: rank=%d alpha=%.1f targets=%s",
                    self.lora_rank, self.lora_alpha,
                    sorted(lora.LORA_TARGETS))

    def init_params(self, seed: int, device) -> dict:
        """Seeded base + injected adapters (A normal, B zeros: the
        starting model is the base model)."""
        params = super().init_params(seed, device)
        return lora.inject_adapters(params, rank=self.lora_rank,
                                    seed=int(seed) ^ _ADAPTER_SEED_SALT)

    def merged(self, params: dict) -> dict:
        """The effective (base ⊕ adapters) tree the model consumes."""
        return lora.merge_adapters(params, alpha=self.lora_alpha)

    def training_loss(self, params: dict, batch: dict, seed: int,
                      step: int):
        """The base loss over the merged kernels."""
        return super().training_loss(self.merged(params), batch, seed, step)

    def validation_loss(self, params: dict, batch: dict):
        """Validation loss over the merged kernels."""
        return super().validation_loss(self.merged(params), batch)

    @torch.no_grad()
    def predict_step(self, params: dict, batch: dict) -> torch.Tensor:
        """Forward logits over the merged kernels."""
        return super().predict_step(self.merged(params), batch)
