"""ERNIE pretraining task module (port of
``fleetx_tpu/models/ernie/module.py:17-60``): the MLM loss plus, with
``Model.binary_head`` (default True), the NSP loss; the log lines are
``BasicModule``'s."""

from __future__ import annotations

from typing import Any

from fleetx_tpu_torch.core.module import BasicModule
from fleetx_tpu_torch.models.ernie import model as E
from fleetx_tpu_torch.models.gpt.model import dropout_rng
from fleetx_tpu_torch.utils.log import logger


class ErnieModule(BasicModule):
    """ERNIE pretraining: ``training_loss`` (dropout on) and
    ``validation_loss`` (off) return ``(loss, {loss, mlm_loss,
    nsp_loss})``."""

    #: the partition-rule family (``parallel/rules.py``)
    spec_family = "ernie"

    def __init__(self, cfg: Any):
        model_cfg = dict(cfg.get("Model", cfg)) if isinstance(cfg, dict) \
            else dict(cfg)
        self.model_cfg = E.config_from_dict(model_cfg)
        self.binary_head = bool(model_cfg.get("binary_head", True))
        super().__init__(cfg)
        c = self.model_cfg
        logger.info("ERNIE model: layers=%d hidden=%d heads=%d vocab=%d",
                    c.num_layers, c.hidden_size, c.num_attention_heads,
                    c.vocab_size)

    def init_params(self, seed: int, device) -> dict:
        """Seeded parameters in the JAX layout on ``device``."""
        return E.init_params(self.model_cfg, seed=seed, device=device)

    def check_params(self, params: dict) -> None:
        """Raise unless ``params`` has the tree of this config."""
        from fleetx_tpu_torch.convert import check_ernie_tree

        check_ernie_tree(params, self.model_cfg)

    def _forward_loss(self, params: dict, batch: dict, *,
                      deterministic: bool, rng=None):
        mlm_logits, nsp_logits = E.ernie_for_pretraining(
            params, self.model_cfg, batch["input_ids"],
            batch.get("token_type_ids"), batch.get("position_ids"),
            batch.get("attention_mask"), deterministic=deterministic,
            rng=rng)
        nsp_labels = batch.get("next_sentence_labels") \
            if self.binary_head else None
        loss, mlm, nsp = E.pretraining_criterion(
            mlm_logits, nsp_logits, batch["mlm_labels"], nsp_labels,
            self.shard)
        return loss, {"loss": loss, "mlm_loss": mlm, "nsp_loss": nsp}

    def training_loss(self, params: dict, batch: dict, seed: int,
                      step: int):
        """``(loss, metrics)`` with dropout on, its randomness from
        ``seed`` with ``step`` folded in."""
        rng = dropout_rng(seed, step, self.model_cfg.num_layers,
                          batch["input_ids"].device, self.shard)
        return self._forward_loss(params, batch, deterministic=False,
                                  rng=rng)

    def validation_loss(self, params: dict, batch: dict):
        """``(loss, metrics)`` with dropout off."""
        return self._forward_loss(params, batch, deterministic=True)
